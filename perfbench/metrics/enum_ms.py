"""Enumeration (``torchgm/matcher.py`` ``TorchGM._enumerate``: the JO
order and the paged MJoin on ``gather_expand``): device milliseconds a
request enumerated on the card, the operations launched inside the
harness's ``enum`` spans over their number, from the device trace."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.span_counts.get("enum") or "enum" not in t.by_span:
        return None
    return t.by_span["enum"] / t.span_counts["enum"] * 1e3
