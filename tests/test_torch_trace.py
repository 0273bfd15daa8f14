"""The filter step's profiler ranges and edge-slot counters
(``repro_torch.obs.trace.profiled``, ``torchgm.distributed.gm_serve_step``).

With no profiler recording, ``profiled`` hands out one shared object and
adds no tensor operation and no allocation.  Under ``torch.profiler`` the
step's phases appear as ``repro_torch.*`` ranges, nested by time, and the
step runs the same operations in the same order with bit-equal outputs.
The counters are held to a count made by hand.  Everything runs on the CPU,
the sharded step on a 1 x 1 gloo mesh.
"""

import tracemalloc

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.core.query import (CHILD, DESC, PatternQuery,  # noqa: E402
                                    QueryEdge)
from repro_torch.obs.metrics import get_registry  # noqa: E402
from repro_torch.obs.trace import _NULL_SPAN, profiled  # noqa: E402

MAX_Q, MAX_E, TOP_K = 8, 16, 64


class Ops(TorchDispatchMode):
    """Every tensor operation dispatched inside, by name, in order (the
    profiler's own bookkeeping left out)."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not name.startswith("profiler."):
            self.names.append(name)
        return func(*args, **(kwargs or {}))


def _queries():
    """Three queries of 1, 2 and 4 edges after reduction (the third's
    descendant edge 0 -> 2 is implied by 0 / 1 / 2 and goes)."""
    e = QueryEdge
    return [PatternQuery(labels=[0, 1], edges=[e(0, 1, DESC)]),
            PatternQuery(labels=[0, 1, 2], edges=[e(0, 1, CHILD),
                                                  e(1, 2, DESC)]),
            PatternQuery(labels=[1, 0, 2, 1],
                         edges=[e(0, 1, CHILD), e(1, 2, CHILD),
                                e(0, 2, DESC), e(2, 3, DESC),
                                e(3, 0, CHILD)])]


@pytest.fixture
def step(monkeypatch):
    """(run, n_queries): ``run(n_passes)`` reduces and encodes the three
    queries and runs ``gm_serve_step`` over a 256-node graph on a 1 x 1
    gloo mesh."""
    from repro_torch.data.graphs import random_labeled_graph
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.torchgm import frontier
    from repro_torch.torchgm.device_graph import from_host
    from repro_torch.torchgm.distributed import (gm_serve_step,
                                                 shard_graph_arrays)
    from repro_torch.torchgm.encoding import encode_batch

    monkeypatch.setattr(frontier, "DEFAULT_DEVICE", "cpu")
    assert not dist.is_initialized()
    mesh = make_local_mesh(1, 1)
    dg = from_host(random_labeled_graph(200, avg_degree=3.0, n_labels=3,
                                        seed=5), block=128, device="cpu")
    mats, labels = shard_graph_arrays(dg, mesh)

    def run(n_passes):
        qts = encode_batch([q.transitive_reduction() for q in _queries()],
                           MAX_Q, MAX_E)
        return gm_serve_step(mats, labels, qts, mesh, n_passes=n_passes,
                             top_k=TOP_K)

    yield run, len(_queries())
    dist.destroy_process_group()


def test_profiled_is_free_without_a_profiler():
    assert profiled("serve.step") is profiled("query.reduce") is _NULL_SPAN
    with Ops() as ops:
        with profiled("simulation.masks"):
            pass
    assert ops.names == []
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiled("query.encode"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename.endswith("obs/trace.py")]
    assert not any(d.size_diff > 0 for d in grown)


def _ranges(prof):
    """(name, start us, end us) of the ``repro_torch.*`` ranges."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name().startswith("repro_torch."):
            t0 = e.start_ns() * 1e-3
            out.append((e.name()[len("repro_torch."):], t0,
                        t0 + e.duration_ns() * 1e-3))
    return sorted(out, key=lambda r: r[1])


@pytest.mark.parametrize("n_passes", [1, 4])
def test_step_ranges_nest_and_change_nothing(step, n_passes):
    run, n_queries = step
    with Ops() as ops:
        plain = run(n_passes)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with Ops() as ops_traced:
            traced = run(n_passes)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ops_traced.names == ops.names and ops.names

    ranges = _ranges(prof)
    names = [r[0] for r in ranges]
    assert names.count("query.reduce") == n_queries
    assert names.count("query.encode") == 1
    assert names.count("serve.step") == 1
    assert names.count("simulation.masks") == n_passes + 1
    (_, s0, s1), = [r for r in ranges if r[0] == "serve.step"]
    for name, t0, t1 in ranges:
        if name != "serve.step":
            inside = s0 <= t0 and t1 <= s1
            assert inside == (name == "simulation.masks"), name


@pytest.mark.parametrize("n_passes", [1, 4])
def test_edge_slot_counters_count_by_hand(step, n_passes):
    from repro_torch.torchgm.distributed import _count_edge_slots
    from repro_torch.torchgm.encoding import encode_batch
    run, n_queries = step
    reg = get_registry()

    def counts():
        return (reg.counter("serve_edge_slots").value,
                reg.counter("serve_edge_slots_real").value)

    # edges after reduction: 1, 2 and 4; every member runs the batch's 4
    # slots in each pass and all 16 in the edge sums
    want = (n_queries * (4 * n_passes + MAX_E), (1 + 2 + 4) * (n_passes + 1))
    qts = encode_batch([q.transitive_reduction() for q in _queries()],
                       MAX_Q, MAX_E)
    before = counts()
    with Ops() as ops:
        _count_edge_slots(qts, n_passes)
    assert ops.names == []
    mid = counts()
    run(n_passes)
    after = counts()
    for a, b in ((before, mid), (mid, after)):
        assert (b[0] - a[0], b[1] - a[1]) == want


def test_edge_slot_counters_read_no_meta_values():
    from repro_torch.torchgm.distributed import _count_edge_slots
    from repro_torch.torchgm.encoding import QueryTensor
    reg = get_registry()
    before = reg.snapshot(prefix="serve_edge_slots")
    meta = torch.empty((32, MAX_E), dtype=torch.int32, device="meta")
    qts = QueryTensor(labels=meta[:, :MAX_Q], edge_src=meta, edge_dst=meta,
                      edge_kind=meta, n_nodes=meta[:, 0], n_edges=meta[:, 0])
    _count_edge_slots(qts, 4)
    assert reg.snapshot(prefix="serve_edge_slots") == before
