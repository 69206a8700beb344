"""gather.bwd_rows: rows scattered per action by the row gathers' backward
(the `rows` counter of the render/gather_bwd spans: every gathered row,
the padding rows included)."""


def read(ctx):
    from activesplat_tpu_torch.utils import tracing

    span_log = getattr(tracing, "span_log", None)
    if span_log is None:  # a program without the span log
        return None
    s = ctx.stretch
    spans = [r for r in span_log(s.ranges)
             if r["name"] == "render/gather_bwd" and s.start <= r["start"] < s.end]
    if not spans:
        return None
    return sum(r["counters"]["rows"] for r in spans) / ctx.actions
