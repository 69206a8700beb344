"""queries.ms: inclusive time of the outermost queries/* ranges per action,
ms (the top-down maps and the panoramas the planner reads)."""

from benchmark.harness.trace import inclusive_us


def read(ctx):
    return inclusive_us(ctx.stretch, "queries/*") / ctx.actions * 1e-3
