"""Whole-graph simulation (``torchgm/matcher.py`` ``TorchGM._simulate``:
the double simulation on ``bitmm`` and the FB sizes read back): device
milliseconds a served batch, the kernels, copies and sets launched inside
the harness's ``sim`` span over its ``step`` spans, from the device
trace."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.span_counts.get("step") or "sim" not in t.by_span:
        return None
    return t.by_span["sim"] / t.span_counts["step"] * 1e3
