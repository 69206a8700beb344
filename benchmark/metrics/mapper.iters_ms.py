"""mapper.iters_ms: inclusive time of the mapper/mapping_iters ranges per
action, ms (the mapping events: render, loss, backward, Adam)."""

from benchmark.harness.trace import inclusive_us


def read(ctx):
    us = inclusive_us(ctx.stretch, "mapper/mapping_iters")
    return us / ctx.actions * 1e-3 if us > 0 else None
