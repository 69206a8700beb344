"""mapper.aabb_rows: pixels back-projected in numpy per action for the
change log's box (the `rows` counters of the mapper/change_log spans: the
pixels the bound pass left, or every valid pixel of a frame that holds a
non-finite one)."""


def read(ctx):
    from activesplat_tpu_torch.utils import tracing

    span_log = getattr(tracing, "span_log", None)
    if span_log is None:  # a program without the span log
        return None
    s = ctx.stretch
    values = [r["counters"].get("rows") for r in span_log(s.ranges)
              if r["name"] == "mapper/change_log" and s.start <= r["start"] < s.end]
    values = [v for v in values if v is not None]
    if not values:  # no change in the stretch, or a program without the counter
        return None
    return sum(values) / ctx.actions
