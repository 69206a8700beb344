"""mapper.densify_ms: inclusive time of the mapper/densify ranges per action,
ms. The stretch holds three densifying frames (map_every 5, 15 actions)."""

from benchmark.harness.trace import inclusive_us


def read(ctx):
    us = inclusive_us(ctx.stretch, "mapper/densify")
    return us / ctx.actions * 1e-3 if us > 0 else None
