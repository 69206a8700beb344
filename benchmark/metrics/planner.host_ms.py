"""planner.host_ms: self time of the program's planner/* ranges per action,
ms: each range less the child ranges it covers (the simulator, the mapper's
frames and the queries that a planner tick drives)."""

from benchmark.harness.trace import self_us


def read(ctx):
    return self_us(ctx.stretch, "planner/*") / ctx.actions * 1e-3
