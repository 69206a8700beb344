"""kernel.gather_bwd_ms: device time per action of PyTorch's index backward
(indexing_backward_kernel), the scatter-add behind the row gathers of the
blends, ms."""

from benchmark.harness.trace import kernel_us

NAMES = ("indexing_backward_kernel",)


def read(ctx):
    us = kernel_us(ctx.stretch, NAMES)
    return us / ctx.actions * 1e-3 if us > 0 else None
