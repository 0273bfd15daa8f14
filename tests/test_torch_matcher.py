"""The port's slice as a whole: ``repro_torch`` GM against ``repro`` GM.

The same seeded graphs and queries go through both packages' entry points
(``GM.match``, ``GM.match_stream``, ``GM.match_batch_frontier``); counts,
truncation and tuples must be byte-identical for every enumeration
method.  The port runs its executors in torch mode on the CPU; the JAX
package runs its own defaults there (plain XLA).
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import GM as JGM  # noqa: E402
from repro.core import GMOptions as JOptions  # noqa: E402
from repro.core.mjoin import mjoin as j_mjoin  # noqa: E402
from repro.core.ordering import get_order as j_get_order  # noqa: E402
from repro.core.rig import build_rig as j_build_rig  # noqa: E402
from repro.data.graphs import random_labeled_graph  # noqa: E402
from repro.data.queries import random_query_from_graph  # noqa: E402
from repro.jaxgm import frontier as jfrontier  # noqa: E402
from repro_torch.convert import graph_from_arrays, query_from_spec  # noqa: E402
from repro_torch.core import GM, ENUM_METHODS, GMOptions  # noqa: E402
from repro_torch.core.mjoin import mjoin as p_mjoin  # noqa: E402
from repro_torch.core.ordering import get_order as p_get_order  # noqa: E402
from repro_torch.core.rig import build_rig as p_build_rig  # noqa: E402
from repro_torch.robust import Budget  # noqa: E402
from repro_torch.torchgm import frontier as pfrontier  # noqa: E402

RESIDENT = "frontier-device-resident"
DEVICE_METHODS = ("frontier-device", RESIDENT)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pfrontier, "DEFAULT_DEVICE", "cpu")


def _port(jg, jq):
    pg = graph_from_arrays(jg.n, jg.labels, jg.num_labels, jg.edges)
    pq = query_from_spec(jq.labels, [(e.src, e.dst, e.kind)
                                     for e in jq.edges], name=jq.name)
    return pg, pq


def _case(n, deg, labels, gseed, qn, qtype, qseed):
    jg = random_labeled_graph(n, avg_degree=deg, n_labels=labels, seed=gseed)
    jq = random_query_from_graph(jg, n_nodes=qn, qtype=qtype, seed=qseed)
    return (jg, jq), _port(jg, jq)


def _same(got, want):
    assert got.count == want.count
    assert got.truncated == want.truncated
    if want.tuples is None:
        assert got.tuples is None
    else:
        assert got.tuples.dtype == want.tuples.dtype
        assert got.tuples.shape == want.tuples.shape
        assert got.tuples.tobytes() == want.tuples.tobytes()


# ------------------------------------------------------------ GM.match
@pytest.mark.parametrize("method", ENUM_METHODS)
@pytest.mark.parametrize("qtype", ["C", "H", "D"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_equals_reference(seed, qtype, method):
    (jg, jq), (pg, pq) = _case(55, 2.4, 4, seed, 4, qtype, seed + 20)
    want = JGM(jg).match(jq, JOptions(enum_method=method, limit=None))
    got = GM(pg).match(pq, GMOptions(enum_method=method, limit=None))
    _same(got, want)
    assert got.enum_method == want.enum_method == method
    assert got.degradations == want.degradations == []
    assert (got.rig_nodes, got.rig_edges) == (want.rig_nodes,
                                              want.rig_edges)
    assert got.order == want.order
    if method == RESIDENT:
        assert got.resident_bytes == want.resident_bytes
        assert got.resident_dispatches == want.resident_dispatches


@pytest.mark.parametrize("method", DEVICE_METHODS)
def test_count_mode_equals_reference(method):
    (jg, jq), (pg, pq) = _case(60, 2.5, 3, 7, 4, "H", 8)
    want = JGM(jg).match(jq, JOptions(enum_method=method, limit=None,
                                      materialize=False))
    got = GM(pg).match(pq, GMOptions(enum_method=method, limit=None,
                                     materialize=False))
    _same(got, want)
    assert (got.h2d_bytes, got.d2h_bytes) == (want.h2d_bytes,
                                              want.d2h_bytes)


# ------------------------------------------------------ GM.match_stream
@pytest.mark.parametrize("method", DEVICE_METHODS + ("frontier",))
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_match_stream_chunks_equal_reference(method, chunk):
    (jg, jq), (pg, pq) = _case(80, 3.0, 2, 3, 3, "D", 4)
    want = list(JGM(jg).match_stream(jq, JOptions(enum_method=method,
                                                  limit=None),
                                     chunk_size=chunk))
    stream = GM(pg).match_stream(pq, GMOptions(enum_method=method,
                                               limit=None),
                                 chunk_size=chunk)
    got = list(stream)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes() and g.shape == w.shape
    assert stream.enum_method == method and stream.count == sum(map(len,
                                                                    want))


# ------------------------------------------------------- limits, paging
def test_resident_limit_cut_mid_page():
    (jg, jq), (pg, pq) = _case(80, 3.0, 2, 3, 3, "D", 4)
    full = JGM(jg).match(jq, JOptions(limit=None))
    assert full.count > 10
    for lim in (1, 3, full.count // 2, full.count, full.count + 1):
        want = JGM(jg).match(jq, JOptions(enum_method="backtrack",
                                          limit=lim))
        got = GM(pg).match(pq, GMOptions(enum_method=RESIDENT, limit=lim))
        _same(got, want)


def test_max_frontier_paging_and_overflow_fallback():
    (jg, jq), (pg, pq) = _case(80, 3.0, 2, 3, 3, "D", 4)
    jrig = j_build_rig(jg, jq.transitive_reduction())
    prig = p_build_rig(pg, pq.transitive_reduction())
    order = j_get_order(jrig, "jo")
    assert p_get_order(prig, "jo") == order
    ref = j_mjoin(jrig, order, limit=None)
    paged = p_mjoin(prig, order, limit=None, method=RESIDENT, max_frontier=2)
    assert paged.stats.method == RESIDENT
    assert "backtrack" not in paged.stats.degradations
    assert paged.tuples.tobytes() == ref.tuples.tobytes()
    j_host = j_mjoin(jrig, order, limit=None, method="frontier",
                     max_frontier=2)
    p_host = p_mjoin(prig, order, limit=None, method="frontier",
                     max_frontier=2)
    assert p_host.stats.method == j_host.stats.method == "backtrack"
    assert p_host.tuples.tobytes() == j_host.tuples.tobytes()
    prig.release_resident()


def test_resident_deadline_partial_prefix():
    (jg, jq), (pg, pq) = _case(80, 3.0, 2, 3, 3, "D", 4)
    full = JGM(jg).match(jq, JOptions(enum_method="backtrack", limit=None))
    t = [0.0]

    def clock():
        t[0] += 0.02
        return t[0]

    prig = p_build_rig(pg, pq.transitive_reduction())
    order = p_get_order(prig, "jo")
    budget = Budget(deadline_s=0.05).start(clock=clock)
    got = p_mjoin(prig, order, limit=None, method=RESIDENT, max_frontier=2,
                  budget=budget)
    assert got.stats.deadline_exceeded and got.stats.truncated
    assert 0 < got.count < full.count
    assert got.tuples.tobytes() == full.tuples[:got.count].tobytes()
    prig.release_resident()


# ------------------------------------------------- match_batch_frontier
@pytest.mark.parametrize("device", [False, True])
def test_match_batch_frontier_equals_reference(device):
    jg = random_labeled_graph(70, avg_degree=2.6, n_labels=3, seed=5)
    jqs = [random_query_from_graph(jg, n_nodes=n, qtype=qt, seed=s)
           for n, qt, s in ((3, "D", 1), (4, "H", 2), (4, "C", 3),
                            (3, "H", 4))]
    pg = graph_from_arrays(jg.n, jg.labels, jg.num_labels, jg.edges)
    pqs = [_port(jg, q)[1] for q in jqs]
    jx = jfrontier.DeviceIntersector(mode="xla") if device else None
    px = pfrontier.DeviceIntersector(device="cpu") if device else None
    want, want_d = JGM(jg, JOptions(limit=None)).match_batch_frontier(
        jqs, intersector=jx)
    got, got_d = GM(pg, GMOptions(limit=None)).match_batch_frontier(
        pqs, intersector=px)
    assert got_d == want_d
    for g, w in zip(got, want):
        _same(g, w)
        assert g.enum_method == w.enum_method
        assert g.degradations == w.degradations
    if device:
        assert px.calls == jx.calls > 0
        assert (px.h2d_bytes, px.d2h_bytes) == (jx.h2d_bytes, jx.d2h_bytes)
    singles = [GM(pg).match(q, GMOptions(limit=None, materialize=False))
               for q in pqs]
    assert [r.count for r in got] == [r.count for r in singles]


def test_enum_methods_match_reference():
    from repro.core import ENUM_METHODS as J_METHODS
    assert ENUM_METHODS == J_METHODS
    (_, _), (pg, pq) = _case(20, 2.0, 2, 0, 3, "C", 1)
    with pytest.raises(ValueError):
        GM(pg).match(pq, GMOptions(enum_method="nope"))
