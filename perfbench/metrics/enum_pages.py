"""Enumeration (``torchgm/enumerate.py`` ``mjoin_count``): the pages a
query's enumeration ran (each a ``gather_expand`` call of one level), from
the program's counters ``enum_pages`` over ``enum_queries`` in its
process-wide registry, over the traced window.  Nothing when the program
keeps no such counters."""


def read(ctx):
    c = ctx.values.get("counters", {})
    if not c.get("enum_queries"):
        return None
    return c.get("enum_pages", 0) / c["enum_queries"]
