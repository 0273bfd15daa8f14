"""The port's whole-graph matcher (``repro_torch.torchgm``) against the JAX
package's (``repro.jaxgm``).

The same seeded graph and queries go through both packages: the packed
device graph byte for byte (and its ledger charge), the query encoding and
JO order, the double simulation (exact and truncated, single and
batched), the RIG statistics, the frontier MJoin (count, overflow flag,
alive frontier rows, decoded tuples) and ``TorchGM`` against ``JaxGM``.
Every quantity is integer or bitset work, so equality is exact.  The port
runs on the CPU pin (the ``bitmm`` wrapper's plain version); the JAX side
runs its ``reference`` kernels, as its own tests do on the CPU.  Simulation
and enumeration are also held apart from the repack: the port's stages run
on a device graph carried across from the JAX one.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.graph import DataGraph as JDataGraph  # noqa: E402
from repro.core.query import PatternQuery, QueryEdge  # noqa: E402
from repro.data.graphs import random_labeled_graph  # noqa: E402
from repro.data.queries import random_query_from_graph  # noqa: E402
from repro.jaxgm import JaxGM  # noqa: E402
from repro.jaxgm import device_graph as jdgm  # noqa: E402
from repro.jaxgm import encoding as jenc  # noqa: E402
from repro.jaxgm import enumerate as jenum  # noqa: E402
from repro.jaxgm import simulation as jsim  # noqa: E402
from repro.obs.ledger import LEDGER as J_LEDGER  # noqa: E402
from repro_torch.convert import (device_graph_from_packed,  # noqa: E402
                                 graph_from_arrays, query_from_spec)
from repro_torch.core import bitset  # noqa: E402
from repro_torch.obs.ledger import LEDGER as P_LEDGER  # noqa: E402
from repro_torch.torchgm import TorchGM  # noqa: E402
from repro_torch.torchgm import device_graph as pdgm  # noqa: E402
from repro_torch.torchgm import encoding as penc  # noqa: E402
from repro_torch.torchgm import enumerate as penum  # noqa: E402
from repro_torch.torchgm import frontier as pfrontier  # noqa: E402
from repro_torch.torchgm import simulation as psim  # noqa: E402

BLOCK, MAX_Q, MAX_E, CAPACITY = 128, 8, 16, 1024
# (n_nodes, qtype, seed): connected random queries of 3-5 nodes
QUERIES = ((3, "C", 0), (4, "H", 1), (5, "D", 2), (4, "C", 3), (3, "H", 4))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pfrontier, "DEFAULT_DEVICE", "cpu")


def _port_graph(jg):
    return graph_from_arrays(jg.n, jg.labels, jg.num_labels, jg.edges)


def _port_query(jq):
    return query_from_spec(jq.labels, [(e.src, e.dst, e.kind)
                                       for e in jq.edges], name=jq.name)


@pytest.fixture(scope="module")
def case():
    """One 300-node graph, its device graphs in both packages (the port's
    carried across from the JAX one), and reduced queries in both."""
    jg = random_labeled_graph(300, avg_degree=3.0, n_labels=4, seed=3)
    jdg = jdgm.from_host(jg, block=BLOCK)
    pdg = device_graph_from_packed(
        jdg.n, jdg.n_pad, np.asarray(jdg.labels), np.asarray(jdg.adj),
        np.asarray(jdg.adj_t), np.asarray(jdg.reach), np.asarray(jdg.reach_t),
        device="cpu")
    jqs = [random_query_from_graph(jg, n, qtype=t, seed=s)
           .transitive_reduction() for n, t, s in QUERIES]
    return jg, jdg, pdg, jqs, [_port_query(q) for q in jqs]


@pytest.fixture(scope="module")
def jgm(case):
    jg = case[0]
    return JaxGM(jg, block=BLOCK, capacity=CAPACITY, exact_sim=True,
                 impl="reference")


def _qts(jq, pq):
    return (jenc.encode_query(jq, MAX_Q, MAX_E),
            penc.encode_query(pq, MAX_Q, MAX_E))


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------ device graph
@pytest.mark.parametrize("n,block", [(300, 128), (77, 512), (129, 32)])
def test_from_host_byte_equal_with_same_ledger_charge(n, block):
    jg = random_labeled_graph(n, avg_degree=2.5, n_labels=3, seed=n)
    pg = _port_graph(jg)
    for led in (J_LEDGER, P_LEDGER):
        led.reset()
        led.arm()
    jdg = jdgm.from_host(jg, block=block)
    pdg = pdgm.from_host(pg, block=block)
    assert (pdg.n, pdg.n_pad) == (jdg.n, jdg.n_pad)
    assert np.array_equal(_np(pdg.labels), np.asarray(jdg.labels))
    for name in ("adj", "reach", "adj_t", "reach_t"):
        got = _np(getattr(pdg, name))
        want = np.asarray(getattr(jdg, name)).view(np.int32)
        assert got.dtype == np.int32 and got.tobytes() == want.tobytes(), name
    assert np.array_equal(_np(pdgm.stacked_matrices(pdg)),
                          np.asarray(jdgm.stacked_matrices(jdg)).view(
                              np.int32))
    assert (P_LEDGER.transfers.h2d_bytes(site="label_build")
            == J_LEDGER.transfers.h2d_bytes(site="label_build")
            == pdg.nbytes > 0)
    for led in (J_LEDGER, P_LEDGER):
        led.reset()


def test_matrices_are_views_of_one_stack(case):
    pdg = pdgm.from_host(_port_graph(case[0]), block=BLOCK)
    stack = pdgm.stacked_matrices(pdg)
    assert stack.shape == (4, pdg.n_pad, pdg.n_words)
    for i, name in enumerate(("adj", "reach", "adj_t", "reach_t")):
        assert getattr(pdg, name).data_ptr() == stack[i].data_ptr()


def test_closure_on_device_is_not_silently_replaced(case):
    """``closure_on_device`` squares the closure out of the adjacency
    (``tests/test_torch_closure.py`` holds it to the JAX package): the host
    reachability index is never built, and the result equals it."""
    pg = _port_graph(case[0])

    def boom():
        raise AssertionError("the host reachability index was built")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pg, "reachability", boom)
        pdg = pdgm.from_host(pg, block=BLOCK, closure_on_device=True)
    assert torch.equal(pdg.stack, case[2].stack)


# ---------------------------------------------------------------- encoding
def test_encode_query_and_batch_equal(case):
    _, _, _, jqs, pqs = case
    for jq, pq in zip(jqs, pqs):
        jqt, pqt = _qts(jq, pq)
        for f in ("labels", "edge_src", "edge_dst", "edge_kind", "n_nodes",
                  "n_edges"):
            assert np.array_equal(_np(getattr(pqt, f)),
                                  np.asarray(getattr(jqt, f))), f
    jb = jenc.encode_batch(jqs, MAX_Q, MAX_E)
    pb = penc.encode_batch(pqs, MAX_Q, MAX_E)
    assert np.array_equal(_np(pb.edge_kind), np.asarray(jb.edge_kind))
    assert np.array_equal(_np(penc.query_adjacency(pb)),
                          np.asarray(jax.vmap(jenc.query_adjacency)(jb)))


def test_jo_order_equal_with_ties_and_disconnected(case):
    _, _, _, jqs, pqs = case
    disconnected = query_from_spec([0, 1, 2, 1, 0],
                                   [(0, 1, 0), (3, 4, 1)])
    jdis = PatternQuery(labels=[0, 1, 2, 1, 0],
                        edges=[QueryEdge(0, 1, 0), QueryEdge(3, 4, 1)])
    pairs = list(zip(jqs, pqs))[1:4] + [(jdis, disconnected)]
    size_sets = ([5, 1, 7, 3, 2, 0, 0, 0], [9, 9, 1, 1, 9, 4, 4, 4],
                 [2 ** 31 - 1] * 8)
    for jq, pq in pairs:
        jqt, pqt = _qts(jq, pq)
        for sizes in size_sets:
            want = np.asarray(jenc.jo_order(jqt, jnp.asarray(sizes,
                                                             jnp.int32)))
            got = penc.jo_order(pqt, torch.tensor(sizes, dtype=torch.int32))
            assert np.array_equal(_np(got), want), (pq, sizes)


# -------------------------------------------------------------- simulation
def test_initial_fb_equal(case):
    _, jdg, pdg, jqs, pqs = case
    for jq, pq in zip(jqs, pqs):
        jqt, pqt = _qts(jq, pq)
        assert np.array_equal(_np(psim.initial_fb(pdg, pqt)),
                              np.asarray(jsim.initial_fb(jdg, jqt)))


@pytest.mark.parametrize("mode", ["exact", 1, 2, 3, 4])
def test_double_simulation_equal(case, mode):
    _, jdg, pdg, jqs, pqs = case
    exact = mode == "exact"
    n_passes = 4 if exact else mode
    for jq, pq in list(zip(jqs, pqs))[:3]:
        jqt, pqt = _qts(jq, pq)
        want = np.asarray(jsim.double_simulation(
            jdg, jqt, n_passes=n_passes, exact=exact, impl="reference"))
        got = psim.double_simulation(pdg, pqt, n_passes=n_passes, exact=exact)
        assert np.array_equal(_np(got), want)


def test_batched_simulation_equals_each_single_run(case):
    _, jdg, pdg, jqs, pqs = case
    batch = psim.double_simulation(pdg, penc.encode_batch(pqs, MAX_Q, MAX_E),
                                   exact=True)
    assert batch.shape == (len(pqs), MAX_Q, pdg.n_pad)
    for i, (jq, pq) in enumerate(zip(jqs, pqs)):
        jqt, pqt = _qts(jq, pq)
        single = psim.double_simulation(pdg, pqt, exact=True)
        assert torch.equal(batch[i], single)
    # the JAX package's batch is the same function under vmap
    want = jax.vmap(lambda qt: jsim.double_simulation(
        jdg, qt, exact=True, impl="reference"))(
            jenc.encode_batch(jqs[:2], MAX_Q, MAX_E))
    assert np.array_equal(_np(batch[:2]), np.asarray(want))


def test_fb_sizes_and_rig_edge_counts_equal(case):
    _, jdg, pdg, jqs, pqs = case
    for jq, pq in zip(jqs, pqs):
        jqt, pqt = _qts(jq, pq)
        jfb = jsim.double_simulation(jdg, jqt, exact=True, impl="reference")
        pfb = psim.double_simulation(pdg, pqt, exact=True)
        assert np.array_equal(_np(psim.fb_sizes(pfb)),
                              np.asarray(jsim.fb_sizes(jfb)))
        got = psim.rig_edge_counts(pdg, pqt, pfb)
        want = jsim.rig_edge_counts(jdg, jqt, jfb, impl="reference")
        assert got.dtype == torch.float32
        assert np.array_equal(_np(got), np.asarray(want))


# -------------------------------------------------------------- enumeration
# materialize=True also checks the count: one JAX compile per case
@pytest.mark.parametrize("capacity,materialize", [(CAPACITY, True),
                                                  (8, False)])
def test_mjoin_count_equal(case, capacity, materialize):
    _, jdg, pdg, jqs, pqs = case
    overflowed = 0
    for jq, pq in zip(jqs, pqs):
        jqt, pqt = _qts(jq, pq)
        jfb = jsim.double_simulation(jdg, jqt, exact=True, impl="reference")
        order = jenc.jo_order(jqt, jsim.fb_sizes(jfb))
        want = jenum.mjoin_count(jdg, jqt, jfb, order, capacity=capacity,
                                 materialize=materialize)
        got = penum.mjoin_count(
            pdg, pqt, torch.from_numpy(np.array(jfb)),
            torch.from_numpy(np.array(order)), capacity=capacity,
            materialize=materialize)
        assert int(got.count) == int(want.count)
        assert bool(got.overflowed) == bool(want.overflowed)
        overflowed += bool(want.overflowed)
        alive = _np(got.alive)
        assert np.array_equal(alive, np.asarray(want.alive))
        assert np.array_equal(_np(got.frontier)[alive],
                              np.asarray(want.frontier)[alive])
        if materialize:
            assert np.array_equal(
                penum.decode_tuples(got, _np(order), pq.n),
                jenum.decode_tuples(want, order, jq.n))
    if capacity == 8:
        assert overflowed        # the tiny capacity exercises the flag


def test_alive_is_the_prefix_gather_expand_is_given(case, monkeypatch):
    """``n_alive`` rests on the live frontier rows being a prefix: after
    every level of the JAX reference the alive rows are the first
    min(level total, capacity) slots, and the port hands ``gather_expand``
    exactly that number (1 at the first level)."""
    _, jdg, pdg, jqs, pqs = case
    capacity = 8                 # small, so that levels are cut
    seen = []
    level = penum.gather_expand

    def recording(mats, fb_row, idx, n_alive, **kw):
        seen.append(int(n_alive))
        return level(mats, fb_row, idx, n_alive, **kw)
    monkeypatch.setattr(penum, "gather_expand", recording)
    cut = 0
    for jq, pq in zip(jqs, pqs):
        jqt, pqt = _qts(jq, pq)
        jfb = jsim.double_simulation(jdg, jqt, exact=True, impl="reference")
        order = jenc.jo_order(jqt, jsim.fb_sizes(jfb))
        seen.clear()
        penum.mjoin_count(pdg, pqt, torch.from_numpy(np.array(jfb)),
                          torch.from_numpy(np.array(order)),
                          capacity=capacity, materialize=True)
        assert len(seen) == pq.n and seen[0] == 1
        for n_levels in range(1, pq.n):
            # the reference run through its first n_levels levels only
            want = jenum.mjoin_count(
                jdg, dataclasses.replace(jqt, n_nodes=jnp.int32(n_levels)),
                jfb, order, capacity=capacity, materialize=True)
            alive = np.asarray(want.alive)
            n = int(alive.sum())
            assert np.array_equal(alive, np.arange(capacity) < n)
            assert seen[n_levels] == n
            cut += n == capacity
    assert cut                   # some level filled the frontier


def test_torchgm_counts_every_pair_of_a_cycle():
    """Every node of a directed cycle reaches every node (itself too): the
    2-node ``//`` query counts n^2, the host reachability index's row
    sizes summed, as JaxGM does at a size where its int32 count holds."""
    n = 300
    nodes = np.arange(n)
    jg = JDataGraph(n=n, labels=np.zeros(n, dtype=np.int32), num_labels=1,
                    edges=np.stack([nodes, (nodes + 1) % n], axis=1))
    jq = PatternQuery(labels=[0, 0], edges=[QueryEdge(0, 1, 1)])
    pg = _port_graph(jg)
    want = int(bitset.count_rows(pg.reachability().reach_bits).sum())
    tgm = TorchGM(pg, block=BLOCK, capacity=CAPACITY, exact_sim=True)
    got = tgm.match(_port_query(jq))
    jwant = JaxGM(jg, block=BLOCK, capacity=CAPACITY, exact_sim=True,
                  impl="reference").match(jq)
    assert want == n * n
    assert (got.count, got.overflowed) == (want, False)
    assert (int(jwant.count), bool(jwant.overflowed)) == (want, False)


# ------------------------------------------------------------------ TorchGM
def test_torchgm_equals_jaxgm(case, jgm):
    jg, _, _, jqs, pqs = case
    tgm = TorchGM(_port_graph(jg), block=BLOCK, capacity=CAPACITY,
                  exact_sim=True)
    singles = []
    for jq, pq in zip(jqs, pqs):
        want = jgm.match(jq, materialize=True)
        got = tgm.match(pq, materialize=True)
        singles.append(want)
        assert (got.count, got.overflowed) == (want.count, want.overflowed)
        assert np.array_equal(got.fb_sizes, want.fb_sizes)
        if not want.overflowed:
            assert np.array_equal(got.tuples, want.tuples)
        assert got.sim_passes >= 1
        jsizes, jedges = jgm.rig_stats(jq)
        psizes, pedges = tgm.rig_stats(pq)
        assert np.array_equal(psizes, jsizes)
        assert np.array_equal(pedges, np.asarray(jedges))
    # JaxGM.match_batch equals its singles (tests/jaxgm/test_jaxgm.py), so
    # the port's batch is held to the JAX singles, without a vmap compile
    got = tgm.match_batch(pqs)
    assert [(r.count, r.overflowed) for r in got] == \
        [(r.count, r.overflowed) for r in singles]
    assert all(np.array_equal(g.fb_sizes, w.fb_sizes)
               for g, w in zip(got, singles))


def test_torchgm_raises_without_cuda_and_without_pin(case, monkeypatch):
    monkeypatch.setattr(pfrontier, "DEFAULT_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchGM(_port_graph(case[0]), block=BLOCK)
