"""gather.pad_share: the share of the rows the row gathers' backward
scatters that are the padding row N (the `pad_rows` over the `rows`
counters of the render/gather_bwd spans): lists shorter than the cap and
CSR runs padded to a segment multiple."""


def read(ctx):
    from activesplat_tpu_torch.utils import tracing

    span_log = getattr(tracing, "span_log", None)
    if span_log is None:  # a program without the span log
        return None
    s = ctx.stretch
    spans = [r["counters"] for r in span_log(s.ranges)
             if r["name"] == "render/gather_bwd" and s.start <= r["start"] < s.end]
    rows = sum(c["rows"] for c in spans)
    if rows <= 0:
        return None
    return sum(c["pad_rows"] for c in spans) / rows
