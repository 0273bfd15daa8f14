"""Query encoding (``core/query.py`` ``transitive_reduction``,
``torchgm/encoding.py`` ``encode_batch``): host milliseconds a step spends
reducing and encoding its batch, from the harness's ``encode`` spans."""


def read(ctx):
    spans = ctx.rec.spans.get("encode")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
