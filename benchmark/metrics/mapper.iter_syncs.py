"""mapper.iter_syncs: host syncs per action made inside the mapping events
(the `syncs` counters of the mapper/mapping_iters spans and of every span
nested in one on its thread: the visible count, the harmful tiles, the
CSR layout's totals, the event's metrics read)."""

EVENT = "mapper/mapping_iters"


def read(ctx):
    from activesplat_tpu_torch.utils import tracing

    span_log = getattr(tracing, "span_log", None)
    if span_log is None:  # a program without the span log
        return None
    s = ctx.stretch
    log = span_log(s.ranges)
    by_id = {r["id"]: r for r in log}

    def in_event(r):
        while r is not None:
            if r["name"] == EVENT:
                return True
            r = by_id.get(r["parent"])
        return False

    spans = [r for r in log if s.start <= r["start"] < s.end and in_event(r)]
    if not spans:
        return None
    return sum(r["counters"].get("syncs", 0) for r in spans) / ctx.actions
