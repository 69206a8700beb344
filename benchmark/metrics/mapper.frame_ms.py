"""mapper.frame_ms: inclusive time of the mapper/frame ranges per action, ms."""

from benchmark.harness.trace import inclusive_us


def read(ctx):
    return inclusive_us(ctx.stretch, "mapper/frame") / ctx.actions * 1e-3
