"""queries.pano_views: panorama views rendered per action (the `views`
counters of the queries/panorama_local and queries/panorama_global spans:
three views a local query, three a node re-scored by a global one)."""

SPANS = ("queries/panorama_local", "queries/panorama_global")


def read(ctx):
    from activesplat_tpu_torch.utils import tracing

    span_log = getattr(tracing, "span_log", None)
    if span_log is None:  # a program without the span log
        return None
    s = ctx.stretch
    values = [r["counters"]["views"] for r in span_log(s.ranges)
              if r["name"] in SPANS and s.start <= r["start"] < s.end
              and "views" in r["counters"]]
    if not values:  # no panorama in the stretch, or a program without the counter
        return None
    return sum(values) / ctx.actions
