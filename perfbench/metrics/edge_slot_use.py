"""Sharded simulation (``torchgm/distributed.py`` ``gm_serve_step``):
percent of the (batch member, edge slot) pairs that the steps' edge masks
and edge sums process whose slot holds one of that member's edges, from
the program's counters ``serve_edge_slots_real`` over ``serve_edge_slots``
in its process-wide registry.  The counters run from the process's start,
so the set-up's warm-up steps (3 of about 530 in a traced 40 s run) are in
them.  Nothing when the program keeps no such counters."""


def read(ctx):
    from repro_torch.obs.metrics import get_registry
    counts = get_registry().snapshot(prefix="serve_edge_slots")
    slots = counts.get("serve_edge_slots")
    if not slots:
        return None
    return 100.0 * counts.get("serve_edge_slots_real", 0) / slots
