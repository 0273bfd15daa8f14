"""Sharded simulation (``torchgm/distributed.py`` ``gm_serve_step``):
device milliseconds a step, the kernels, copies and sets launched inside
the harness's ``step`` span, from the device trace."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.span_counts.get("step") or "step" not in t.by_span:
        return None
    return t.by_span["step"] / t.span_counts["step"] * 1e3
