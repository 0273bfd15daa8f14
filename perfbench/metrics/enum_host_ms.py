"""Enumeration (``torchgm/matcher.py`` ``TorchGM._enumerate``): host
milliseconds a request enumerated on the card, the harness's ``enum``
spans over their number.  The enumerator's host work and its waits for
each page's count, which the device time (``enum_ms``) leaves out; read
in a traced run, so the profiler's host cost is inside it."""


def read(ctx):
    spans = ctx.rec.spans.get("enum")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
