"""gather.bwd_share: the row gathers' backward's share of its roofline on
one H100: the least time its work needs over its device time (the
render/gather_bwd spans, as gather.bwd_ms reads them). Least time, each
call: the larger of its bytes over 3.35 TB/s (the incoming gradient,
rows x width float32; the ids, rows int64; the table written once,
table_rows x width float32) and its adds over 67 TFLOP/s (rows x width)."""

HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12


def least_s(c) -> float:
    rows, width, table = c["rows"], c["width"], c["table_rows"]
    moved = rows * width * 4 + rows * 8 + table * width * 4
    return max(moved / HBM_BYTES_PER_S, rows * width / FP32_PER_S)


def read(ctx):
    from activesplat_tpu_torch.utils import tracing

    span_log = getattr(tracing, "span_log", None)
    if span_log is None:  # a program without the span log
        return None
    s = ctx.stretch
    spans = [r["counters"] for r in span_log(s.ranges)
             if r["name"] == "render/gather_bwd" and s.start <= r["start"] < s.end]
    if not spans or any("device_us" not in c for c in spans):
        return None
    device_s = sum(c["device_us"] for c in spans) * 1e-6
    return sum(least_s(c) for c in spans) / device_s if device_s > 0 else None
