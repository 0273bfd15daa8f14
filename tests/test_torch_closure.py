"""The port's on-device closure (``closure_step``, ``transitive_closure``,
``from_host(closure_on_device=True)``, ``TorchGM(closure_on_device=True)``)
against the JAX package's.

Every input is made from a seed with numpy and handed to both packages.
The port runs on the CPU pin, where the ``closure_step`` wrapper runs its
plain PyTorch version; the JAX side runs its ``reference`` kernels and the
Pallas kernel in interpret mode, as its own tests do on the CPU.  Every
quantity is a packed bit or an integer count, so equality is exact.  The
CUDA kernel is held to the plain version on the card by
``tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import match as j_match  # noqa: E402
from repro.core.reachability import ReachabilityIndex  # noqa: E402
from repro.data.graphs import random_labeled_graph  # noqa: E402
from repro.data.queries import random_query_from_graph  # noqa: E402
from repro.jaxgm import JaxGM  # noqa: E402
from repro.jaxgm import device_graph as jdgm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import packed as jpacked  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.closure import closure_step_pallas  # noqa: E402
from repro.obs.ledger import LEDGER as J_LEDGER  # noqa: E402
from repro_torch.convert import graph_from_arrays, query_from_spec  # noqa: E402
from repro_torch.kernels import launch_counts, ops, packed  # noqa: E402
from repro_torch.kernels import reset_launch_counts  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.kernels.closure import (LIST_CAP, closure_step,  # noqa: E402
                                        row_lists, transpose)
from repro_torch.obs.ledger import LEDGER as P_LEDGER  # noqa: E402
from repro_torch.torchgm import TorchGM  # noqa: E402
from repro_torch.torchgm import device_graph as pdgm  # noqa: E402
from repro_torch.torchgm import frontier as pfrontier  # noqa: E402

MATRICES = ("adj", "reach", "adj_t", "reach_t")
# the whole-graph matcher cases of tests/test_torch_gm.py
BLOCK, CAPACITY = 128, 1024
QUERIES = ((3, "C", 0), (4, "H", 1), (5, "D", 2), (4, "C", 3), (3, "H", 4))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pfrontier, "DEFAULT_DEVICE", "cpu")


def lanes(a) -> torch.Tensor:
    """uint32 words (numpy or JAX) -> the port's int32 lanes (a view)."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def words(t) -> np.ndarray:
    """Port lanes or a JAX uint32 array -> uint32 numpy words."""
    if isinstance(t, torch.Tensor):
        return np.ascontiguousarray(t.cpu().numpy()).view(np.uint32)
    return np.asarray(t).astype(np.uint32)


def _rand_packed(rng, n, density):
    """A seeded 0/1 (n, n) matrix as JAX packed words (the inputs of
    ``tests/kernels/test_kernels.py``)."""
    return jpacked.pack(jnp.asarray(rng.random((n, n)) < density))


def _port_graph(jg):
    return graph_from_arrays(jg.n, jg.labels, jg.num_labels, jg.edges)


def _chain(n):
    dense = np.zeros((n, n), dtype=bool)
    dense[np.arange(n - 1), np.arange(1, n)] = True
    return dense


# -------------------------------------------------------------- closure_step
@pytest.mark.parametrize("n", [128, 256, 512])
def test_closure_step_matches_jax_ref_and_pallas(n):
    jwords = _rand_packed(np.random.default_rng(n), n, density=0.02)
    want = words(jref.closure_step_ref(jwords))
    pallas = words(closure_step_pallas(jwords, bm=128, bn=128, bk=128,
                                       interpret=True))
    assert np.array_equal(pallas, want)
    r = lanes(jwords)
    got = closure_step(r)
    assert got.dtype == torch.int32 and got.shape == r.shape
    assert np.array_equal(words(got), want)
    assert np.array_equal(words(pref.closure_step_ref(r)), want)
    assert np.array_equal(words(r), words(jwords))       # input untouched


@pytest.mark.parametrize("case", ["zeros", "ones", "n32", "chain"])
def test_closure_step_edge_cases_match_jax(case):
    n = 32 if case == "n32" else 256
    if case == "zeros":
        dense = np.zeros((n, n), dtype=bool)
    elif case == "ones":
        dense = np.ones((n, n), dtype=bool)
    elif case == "chain":
        dense = _chain(n)
    else:
        dense = np.random.default_rng(5).random((n, n)) < 0.1
    jr = jpacked.pack(jnp.asarray(dense))
    r = lanes(jr)
    for _ in range(3):          # the chain changes at every step
        jr2, r2 = jref.closure_step_ref(jr), closure_step(r)
        assert np.array_equal(words(r2), words(jr2))
        jr, r = jr2, r2


def test_closure_step_into_out_and_rejects_bad_arguments():
    rng = np.random.default_rng(9)
    r = lanes(_rand_packed(rng, 64, density=0.05))
    out = torch.full_like(r, -1)
    assert closure_step(r, out=out) is out
    assert torch.equal(out, pref.closure_step_ref(r))
    with pytest.raises(ValueError, match="overlaps"):
        closure_step(r, out=r)
    with pytest.raises(ValueError, match="square"):
        closure_step(r[:32])
    with pytest.raises(ValueError, match="shape"):
        closure_step(r, out=torch.zeros((32, 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        closure_step(r.to(torch.int64))


# --------------------------------------------------------- transitive_closure
def test_transitive_closure_matches_jax_and_host_reachability():
    graph = random_labeled_graph(100, avg_degree=2.5, n_labels=3, seed=3)
    n_pad = 128
    dense = np.zeros((n_pad, n_pad), dtype=bool)
    dense[:graph.n, :graph.n] = graph.adjacency_matrix()
    jw = jpacked.pack(jnp.asarray(dense))
    want = words(jops.transitive_closure(jw, impl="reference"))
    adj = lanes(jw)
    got = ops.transitive_closure(adj)
    assert np.array_equal(words(got), want)
    assert np.array_equal(words(adj), words(jw))         # adj untouched
    host = ReachabilityIndex.build(graph).dense()
    assert np.array_equal(packed.unpack(got, n_pad).numpy()[:graph.n,
                                                             :graph.n], host)


@pytest.mark.parametrize("n_steps", [0, 1, 2, 3, None])
def test_transitive_closure_step_count_and_ping_pong(n_steps, monkeypatch):
    """As many steps as the JAX package runs (⌈log₂ N⌉ by default, no
    early exit), with the result in ``out`` and at most one temporary."""
    n = 96
    jw = jpacked.pack(jnp.asarray(_chain(n)))
    want = words(jops.transitive_closure(jw, impl="reference",
                                         n_steps=n_steps))
    calls = []

    def counted(r, out=None):
        calls.append((r.data_ptr(), out.data_ptr()))
        return closure_step(r, out=out)

    monkeypatch.setattr(ops, "closure_step", counted)
    adj = lanes(jw)
    out = torch.empty_like(adj)
    assert ops.transitive_closure(adj, n_steps=n_steps, out=out) is out
    assert np.array_equal(words(out), want)
    steps = math.ceil(math.log2(n)) if n_steps is None else n_steps
    assert len(calls) == steps
    if steps:
        assert calls[0][0] == adj.data_ptr()
        assert calls[-1][1] == out.data_ptr()
        assert len({dst for _, dst in calls}) == min(steps, 2)


# ------------------------------------------------------------------ transpose
@pytest.mark.parametrize("n,chunk", [(32, 2048), (96, 32), (320, 64)])
def test_transpose_matches_dense(n, chunk, monkeypatch):
    monkeypatch.setattr(packed, "_TRANSPOSE_CHUNK_ROWS", chunk)
    dense = np.random.default_rng(n).random((n, n)) < 0.1
    got = packed.transpose(packed.pack(torch.from_numpy(dense)))
    assert np.array_equal(packed.unpack(got, n).numpy(), dense.T)
    assert np.array_equal(words(got), words(jpacked.pack(jnp.asarray(
        dense.T))))
    with pytest.raises(ValueError, match="square"):
        packed.transpose(got[:n // 2])


@pytest.mark.parametrize("n", [32, 96, 320])
def test_transpose_wrapper_cpu_route_matches_jax_dense_t(n):
    """The wrapper on a CPU tensor runs the plain version and equals the
    JAX package's packing of ``dense.T`` (its ``from_host`` transposes
    on the host); no kernel launch is counted."""
    dense = np.random.default_rng(n + 1).random((n, n)) < 0.2
    want = words(jpacked.pack(jnp.asarray(np.ascontiguousarray(dense.T))))
    src = packed.pack(torch.from_numpy(dense))
    reset_launch_counts()
    got = transpose(src)
    assert np.array_equal(words(got), want)
    out = torch.full_like(src, -1)
    assert transpose(src, out=out) is out
    assert np.array_equal(words(out), want)
    assert ops.transpose is transpose
    assert launch_counts() == {}


def test_transpose_wrapper_rejects_bad_arguments():
    src = packed.pack(torch.from_numpy(
        np.random.default_rng(2).random((64, 64)) < 0.3))
    with pytest.raises(ValueError, match="overlaps"):
        transpose(src, out=src)
    flat = torch.zeros(64 * 2 + 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="overlaps"):
        transpose(flat[:128].view(64, 2), out=flat[2:].view(64, 2))
    with pytest.raises(ValueError, match="square"):
        transpose(src[:32])
    with pytest.raises(ValueError, match="shape"):
        transpose(src, out=torch.zeros((32, 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        transpose(src.to(torch.int64))
    with pytest.raises(TypeError):
        transpose(src, out=torch.zeros((64, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="rank"):
        transpose(src.reshape(-1))
    with pytest.raises(ValueError, match="contiguous"):
        transpose(torch.zeros((64, 4), dtype=torch.int32)[:, ::2])


@pytest.mark.parametrize("n,density", [(96, 0.05), (96, 0.5), (320, 0.08)])
def test_row_lists_cpu_route_matches_numpy(n, density):
    """``closure_step``'s first pass on the CPU: each row's exact count,
    and the ascending set columns of each row with at most LIST_CAP of
    them (-1 past the count and in every row with more)."""
    dense = np.random.default_rng(n).random((n, n)) < density
    dense[0] = False
    dense[1, :LIST_CAP] = True
    dense[1, LIST_CAP:] = False
    dense[2, :LIST_CAP + 1] = True
    cnt, lists = row_lists(packed.pack(torch.from_numpy(dense)))
    assert cnt.dtype == lists.dtype == torch.int32
    assert lists.shape == (n, LIST_CAP)
    assert np.array_equal(cnt.numpy(), dense.sum(axis=1))
    for i in range(n):
        cols = np.flatnonzero(dense[i])
        want = np.full(LIST_CAP, -1)
        if cols.size <= LIST_CAP:
            want[:cols.size] = cols
        assert np.array_equal(lists[i].numpy(), want), i
    with pytest.raises(ValueError, match="square"):
        row_lists(packed.pack(torch.from_numpy(dense))[:32])


# ------------------------------------------------------ from_host, the graph
@pytest.mark.parametrize("n,block", [(70, 128), (300, 128), (129, 32)])
def test_from_host_closure_on_device_matches_jax_and_host_index(n, block):
    jg = random_labeled_graph(n, avg_degree=2.5, n_labels=3, seed=n)
    pg = _port_graph(jg)
    jdg = jdgm.from_host(jg, block=block, closure_on_device=True,
                         impl="reference")
    pdg = pdgm.from_host(pg, block=block, closure_on_device=True)
    assert (pdg.n, pdg.n_pad) == (jdg.n, jdg.n_pad)
    assert np.array_equal(pdg.labels.numpy(), np.asarray(jdg.labels))
    for name in MATRICES:
        assert np.array_equal(words(getattr(pdg, name)),
                              words(getattr(jdg, name))), name
    host = pdgm.from_host(pg, block=block)
    assert torch.equal(pdg.stack, host.stack)
    assert torch.equal(pdg.labels, host.labels)
    assert pdg.closure_s >= 0 and host.closure_s == 0


def test_from_host_closure_on_device_transposes_through_the_wrapper(
        monkeypatch):
    pg = _port_graph(random_labeled_graph(100, avg_degree=2.5, n_labels=3,
                                          seed=8))
    calls = []

    def counted(words_, out=None):
        calls.append(out.data_ptr())
        return transpose(words_, out=out)

    monkeypatch.setattr(ops, "transpose", counted)
    pdg = pdgm.from_host(pg, block=BLOCK, closure_on_device=True)
    assert calls == [pdg.reach_t.data_ptr()]
    assert torch.equal(pdg.stack, pdgm.from_host(pg, block=BLOCK).stack)


def test_from_host_closure_on_device_never_builds_host_index():
    pg = _port_graph(random_labeled_graph(200, avg_degree=3.0, n_labels=3,
                                          seed=4))

    def boom():
        raise AssertionError("the host reachability index was built")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pg, "reachability", boom)
        pdg = pdgm.from_host(pg, block=BLOCK, closure_on_device=True)
        tgm = TorchGM(pg, block=BLOCK, closure_on_device=True,
                      exact_sim=True)
        q = query_from_spec([0, 1], [(0, 1, 1)])
        assert tgm.match(q).count > 0
    assert torch.equal(pdg.stack, pdgm.from_host(pg, block=BLOCK).stack)


@pytest.mark.parametrize("n,block", [(300, 128), (77, 512)])
def test_closure_path_label_build_charge(n, block):
    """The closure path ships and charges labels, ``adj`` and ``adj_t``;
    the JAX package's charges the closure's two matrices as well, since it
    uploads them from the host: the difference is 2 * n_pad * W * 4."""
    jg = random_labeled_graph(n, avg_degree=2.5, n_labels=3, seed=n)
    pg = _port_graph(jg)
    charges = {}
    for closure in (False, True):
        for led in (J_LEDGER, P_LEDGER):
            led.reset()
            led.arm()
        jdgm.from_host(jg, block=block, closure_on_device=closure,
                       impl="reference")
        pdg = pdgm.from_host(pg, block=block, closure_on_device=closure)
        charges[closure] = (
            J_LEDGER.transfers.h2d_bytes(site="label_build"),
            P_LEDGER.transfers.h2d_bytes(site="label_build"), pdg)
    for led in (J_LEDGER, P_LEDGER):
        led.reset()
    j_host, p_host, host = charges[False]
    j_dev, p_dev, dev = charges[True]
    mat = host.n_pad * host.n_words * 4
    assert p_host == j_host == host.nbytes == 4 * host.n_pad + 4 * mat
    assert p_dev == dev.nbytes == 4 * dev.n_pad + 2 * mat
    assert j_dev - p_dev == 2 * mat


def test_closure_path_raises_without_cuda_and_without_pin(monkeypatch):
    monkeypatch.setattr(pfrontier, "DEFAULT_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pg = _port_graph(random_labeled_graph(50, avg_degree=2.0, n_labels=2,
                                          seed=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdgm.from_host(pg, closure_on_device=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchGM(pg, closure_on_device=True)


# ------------------------------------------------------------------- TorchGM
def test_torchgm_closure_on_device_equals_jaxgm_and_host_gm():
    jg = random_labeled_graph(300, avg_degree=3.0, n_labels=4, seed=3)
    jqs = [random_query_from_graph(jg, n, qtype=t, seed=s)
           .transitive_reduction() for n, t, s in QUERIES]
    pqs = [query_from_spec(q.labels, [(e.src, e.dst, e.kind)
                                      for e in q.edges]) for q in jqs]
    jgm = JaxGM(jg, block=BLOCK, capacity=CAPACITY, exact_sim=True,
                impl="reference", closure_on_device=True)
    tgm = TorchGM(_port_graph(jg), block=BLOCK, capacity=CAPACITY,
                  exact_sim=True, closure_on_device=True)
    assert tgm.closure_s >= 0 and tgm.upload_bytes == tgm.dg.nbytes
    want = [jgm.match(q) for q in jqs]
    got = [tgm.match(q) for q in pqs]
    batch = tgm.match_batch(pqs)
    for jq, w, g, b in zip(jqs, want, got, batch):
        assert (g.count, g.overflowed) == (w.count, w.overflowed)
        assert (b.count, b.overflowed) == (w.count, w.overflowed)
        assert np.array_equal(g.fb_sizes, w.fb_sizes)
        if not w.overflowed:
            assert g.count == j_match(jg, jq, limit=None,
                                      materialize=False).count
    assert sum(not w.overflowed for w in want) >= 3


# ---------------------------------------------------------------- from_pairs
@pytest.mark.parametrize("shape,n_pairs", [((96, 96), 400), ((70, 45), 90),
                                           ((64, 1000), 3000), ((33, 33), 0)])
def test_from_pairs_equals_jax_pack_of_dense(shape, n_pairs):
    """Repeated pairs, a column count off the 32-bit lanes, a wide row
    holding most of the pairs, no pair at all."""
    rng = np.random.default_rng(n_pairs)
    rows = rng.integers(0, shape[0], n_pairs)
    rows[: n_pairs // 2] = shape[0] - 1
    cols = rng.integers(0, shape[1], n_pairs)
    dense = np.zeros(shape, dtype=bool)
    dense[rows, cols] = True
    got = packed.from_pairs(rows, cols, shape, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(words(got), words(jpacked.pack(jnp.asarray(dense))))


def test_from_pairs_rejects_pairs_outside_the_matrix():
    with pytest.raises(ValueError, match="outside"):
        packed.from_pairs([0, 5], [1, 2], (5, 5), device="cpu")
    with pytest.raises(ValueError, match="outside"):
        packed.from_pairs([0], [-1], (5, 5), device="cpu")
    with pytest.raises(ValueError, match="2 rows and 1 columns"):
        packed.from_pairs([0, 1], [1], (5, 5), device="cpu")
