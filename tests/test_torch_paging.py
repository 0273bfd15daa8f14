"""The paging enumerator (``TorchGM(page_on_device=True)``,
``EngineOptions.page_on_device``) against the plain count reference and
the JAX package.

On seeded graphs and C/H/D queries, at capacities that cut some level
into three or more pages, the paged count equals the plain reference's
``min(count, limit)`` (``perfbench.reference.counts``, plain PyTorch that
works reachability out again from the edge list) and the JAX package's
exact ``match(limit=None)`` count; a limit below the count gives exactly
the limit, reported as truncated.  The engine and the server with the
switch answer every request on the device, none re-run on the host.  The
counters equal a hand count of the enumerator's ``gather_expand`` calls,
and under ``torch.profiler`` the ranges nest (server step > engine batch >
simulation, pages) with the answers bit-equal.  Everything runs on the
CPU pin.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from perfbench.reference.counts import Counter  # noqa: E402
from perfbench.reference.graph import Reach  # noqa: E402
from repro.core import match as j_match  # noqa: E402
from repro.data.graphs import random_labeled_graph  # noqa: E402
from repro.data.queries import random_query_from_graph  # noqa: E402
from repro_torch.convert import graph_from_arrays, query_from_spec  # noqa: E402
from repro_torch.engine import Engine, EngineOptions  # noqa: E402
from repro_torch.launch.serve import QueryServer  # noqa: E402
from repro_torch.obs.metrics import get_registry  # noqa: E402
from repro_torch.torchgm import enumerate as penum  # noqa: E402
from repro_torch.torchgm import frontier as pfrontier  # noqa: E402
from repro_torch.torchgm.matcher import TorchGM  # noqa: E402

BLOCK = 64


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pfrontier, "DEFAULT_DEVICE", "cpu")
        yield


def _case(n, degree, n_labels, seed, queries):
    jg = random_labeled_graph(n, avg_degree=degree, n_labels=n_labels,
                              seed=seed)
    pg = graph_from_arrays(jg.n, jg.labels, jg.num_labels, jg.edges)
    jqs = [random_query_from_graph(jg, k, qtype=t, seed=s)
           for k, t, s in queries]
    pqs = [query_from_spec(q.labels, [(e.src, e.dst, e.kind)
                                      for e in q.edges]) for q in jqs]
    ref = Counter(Reach(jg.n, np.asarray(jg.edges), "cpu"),
                  torch.as_tensor(np.asarray(jg.labels)), block=256)
    return jg, pg, jqs, pqs, ref


# (nodes, edges a node, labels, seed) and queries (nodes, class, seed)
# of 21 to 54,892 matches
CASES = {
    "300": dict(n=300, degree=2.0, n_labels=4, seed=4,
                queries=[(3, "C", 10), (4, "H", 11), (5, "D", 12),
                         (6, "C", 13), (5, "D", 58), (5, "D", 66),
                         (5, "H", 66)]),
    "1000": dict(n=1000, degree=2.0, n_labels=4, seed=7,
                 queries=[(3, "C", 40), (4, "H", 41), (6, "C", 43),
                          (4, "H", 44), (5, "D", 54), (5, "D", 62),
                          (5, "C", 74), (5, "H", 74)]),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _case(**CASES[request.param])


def _ref(ref, q, limit=None):
    return ref.count(q.labels, [(e.src, e.dst, e.kind) for e in q.edges],
                     limit=limit)


class Levels:
    """Records the enumerator's ``gather_expand`` calls: pages a level
    (calls grouped by their candidate row)."""

    def __init__(self, monkeypatch):
        self.calls = []
        level = penum.gather_expand

        def recording(mats, fb_row, idx, n_alive, **kw):
            self.calls.append(fb_row.data_ptr())
            return level(mats, fb_row, idx, n_alive, **kw)
        monkeypatch.setattr(penum, "gather_expand", recording)

    def most_pages(self) -> int:
        _, n = np.unique(self.calls, return_counts=True)
        return int(n.max()) if len(n) else 0


def test_paged_counts_equal_reference_and_jax(case, monkeypatch):
    jg, pg, jqs, pqs, ref = case
    gm = TorchGM(pg, block=BLOCK, capacity=pg.n + BLOCK - pg.n % BLOCK,
                 exact_sim=True, page_on_device=True)
    assert gm.capacity == gm.dg.n_pad
    paged = 0
    products = []               # queries whose last levels are a product
    for jq, pq in zip(jqs, pqs):
        levels = Levels(monkeypatch)
        tail = penum._tail
        monkeypatch.setattr(penum, "_tail", lambda plan: products.append(
            tail(plan) < len(plan) - 1) or tail(plan))
        got = gm.match(pq)
        monkeypatch.undo()
        want = j_match(jg, jq, limit=None).count
        assert got.count == want == _ref(ref, pq)
        assert not got.overflowed and not got.truncated
        paged += levels.most_pages() >= 3
    assert paged >= 2          # some level of some queries took 3+ pages
    assert any(products) and not all(products)


def test_limit_stops_at_exactly_limit(case):
    _, pg, _, pqs, ref = case
    cap = pg.n + BLOCK - pg.n % BLOCK
    full = TorchGM(pg, block=BLOCK, capacity=cap, exact_sim=True,
                   page_on_device=True)
    counts = [full.match(q).count for q in pqs]
    q = pqs[int(np.argmax(counts))]
    total = max(counts)
    assert total > 2 * cap
    reg = get_registry()
    for limit in (1, total // 3, total - 1, total, total + 1):
        gm = TorchGM(pg, block=BLOCK, capacity=cap, exact_sim=True,
                     page_on_device=True, limit=limit)
        hits = reg.counter("enum_limit_hits").value
        got = gm.match(q)
        assert got.count == min(total, limit) == _ref(ref, q, limit=limit)
        assert got.truncated == (limit <= total)
        assert not got.overflowed
        assert reg.counter("enum_limit_hits").value - hits == \
            int(limit <= total)


def test_paging_needs_capacity_for_one_row():
    jg = random_labeled_graph(100, avg_degree=2.0, n_labels=2, seed=1)
    pg = graph_from_arrays(jg.n, jg.labels, jg.num_labels, jg.edges)
    q = query_from_spec([0, 1], [(0, 1, 0)])
    gm = TorchGM(pg, block=BLOCK, capacity=BLOCK, page_on_device=True)
    with pytest.raises(ValueError, match="capacity >= n_pad"):
        gm.match(q)
    gm = TorchGM(pg, block=BLOCK, capacity=256, page_on_device=True)
    with pytest.raises(ValueError, match="counts only"):
        gm.match(q, materialize=True)


def _paged_options(cap, **kw):
    return EngineOptions(device_min_nodes=0, materialize=False,
                         force_backend="device", capacity=cap,
                         exact_sim=True, page_on_device=True, **kw)


def test_engine_and_server_answer_on_the_device(case):
    _, pg, _, pqs, ref = case
    cap = max(512, pg.n + 511 - (pg.n - 1) % 512)   # the engine's n_pad
    want = [_ref(ref, q) for q in pqs]
    eng = Engine(pg, options=_paged_options(cap, limit=None))
    for res in (eng.execute_many(pqs), [eng.execute(q) for q in pqs]):
        assert [r.count for r in res] == want
        assert all(r.stats.backend == "device" and
                   not r.stats.overflow_fallback and not r.stats.truncated
                   for r in res)
    assert eng.counters["overflow_fallbacks"] == 0
    limit = sorted(want)[len(want) // 2]
    server = QueryServer(pg, batch_size=4, engine=Engine(
        pg, options=_paged_options(cap, limit=limit)))
    for i, q in enumerate(pqs):
        assert server.submit(i, q)
    server.drain()
    reqs = [server.journal[i] for i in range(len(pqs))]
    assert [r.count for r in reqs] == [min(w, limit) for w in want]
    assert all(r.status == "done" and r.backend == "device"
               and not r.overflowed for r in reqs)
    assert [r.truncated for r in reqs] == [w >= limit for w in want]
    assert server.stats["host_fallback"] == 0
    assert server.stats["served"] == len(pqs)


def test_counters_equal_a_hand_count(case, monkeypatch):
    _, pg, _, pqs, _ = case
    gm = TorchGM(pg, block=BLOCK, capacity=pg.n + BLOCK - pg.n % BLOCK,
                 exact_sim=True, page_on_device=True, limit=5_000)
    reg = get_registry()
    names = ("enum_queries", "enum_pages", "enum_limit_hits")
    before = [reg.counter(n).value for n in names]
    levels = Levels(monkeypatch)
    hits = sum(gm.match(q).truncated for q in pqs)
    after = [reg.counter(n).value for n in names]
    assert [a - b for a, b in zip(after, before)] == \
        [len(pqs), len(levels.calls), hits]
    assert hits and len(levels.calls) > len(pqs)


def _ranges(prof):
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name().startswith("repro_torch."):
            t0 = e.start_ns()
            out.append((e.name()[len("repro_torch."):], t0,
                        t0 + e.duration_ns()))
    return sorted(out, key=lambda r: r[1])


def test_ranges_nest_and_change_nothing(case):
    _, pg, _, pqs, _ = case
    cap = max(512, pg.n + 511 - (pg.n - 1) % 512)

    def serve():
        server = QueryServer(pg, batch_size=len(pqs), engine=Engine(
            pg, options=_paged_options(cap, limit=None)))
        for i, q in enumerate(pqs):
            server.submit(i, q)
        server.step()
        return [server.journal[i].count for i in range(len(pqs))]

    plain = serve()
    reg = get_registry()
    pages = reg.counter("enum_pages").value
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = serve()
    pages = reg.counter("enum_pages").value - pages
    assert traced == plain
    rs = _ranges(prof)
    names = [r[0] for r in rs]
    assert names.count("server.step") == 1
    assert names.count("engine.execute_many") == 1
    assert names.count("matcher.simulate") == 1     # one batched simulation
    assert names.count("enumerate.page") == pages > len(pqs)
    (_, s0, s1), = [r for r in rs if r[0] == "server.step"]
    (_, e0, e1), = [r for r in rs if r[0] == "engine.execute_many"]
    assert s0 <= e0 and e1 <= s1
    for name, t0, t1 in rs:
        if name in ("matcher.simulate", "enumerate.page"):
            assert e0 <= t0 and t1 <= e1
