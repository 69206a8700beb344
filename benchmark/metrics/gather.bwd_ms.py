"""gather.bwd_ms: device time per action of the row gathers' backward (the
render/gather_bwd spans of the program's span log, each timed between two
CUDA events at its ends: the zero fill, the sort and the scatter-add,
whatever kernels implement them), ms."""


def read(ctx):
    from activesplat_tpu_torch.utils import tracing

    span_log = getattr(tracing, "span_log", None)
    if span_log is None:  # a program without the span log
        return None
    s = ctx.stretch
    spans = [r for r in span_log(s.ranges)
             if r["name"] == "render/gather_bwd" and s.start <= r["start"] < s.end]
    if not spans or any("device_us" not in r["counters"] for r in spans):
        return None
    return sum(r["counters"]["device_us"] for r in spans) / ctx.actions * 1e-3
