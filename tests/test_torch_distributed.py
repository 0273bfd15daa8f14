"""The port's sharded double simulation and serve step
(``repro_torch.torchgm.distributed`` over ``repro_torch.launch.mesh``)
against the JAX package's single-device answer.

The graphs and queries are those of ``tests/jaxgm/test_distributed.py``.
The JAX package computes the single-device FB, ``fb_sizes`` and
``rig_edge_counts`` (``impl="reference"``); its packed graph and the
queries are carried across with ``repro_torch.convert``.  The port runs
in-process on a 1 x 1 mesh, and in 8 spawned gloo ranks on meshes
``(2, 4)`` ``("data", "model")`` and ``(2, 2, 2)`` ``("pod", "data",
"model")``, each with ``pack_y`` off and on.  The ranks import neither JAX
nor the reference package (they re-import this module, which imports JAX
only inside fixtures), write their outputs with numpy, and the test
gathers the FB blocks over ``model`` and compares.  Every quantity is a
bit or an integer, so equality is exact; ``candidates`` is held as a
whole array to the plain rule (ascending ids of FB, then -1).
"""

import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

MAX_Q, MAX_E, N_PASSES = 8, 16, 4
BLOCK = 256
# (graph seed, queries (n_nodes, qtype, seed)) of the reference's two tests
CASES = {"g0": (0, ((4, "H", 1), (3, "C", 2))),
         "g3": (3, ((4, "H", 7), (4, "D", 8)))}
# below, at and (with 256 = n_pad) past the reference test's top_k
TOP_KS = (16, 64, 256)
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# n_pad 288: 9 words, which no model degree above 1 divides
MISFIT_BLOCK = 96
RANK_TIMEOUT_S = 300


# ------------------------------------------------------------ one rank
def _run_cases(mesh, case_file):
    """Every case on ``mesh`` on this rank: {key: numpy array}."""
    from repro_torch.convert import (device_graph_from_packed,
                                     graph_from_arrays, query_from_spec)
    from repro_torch.torchgm import distributed, encode_batch, from_host

    data = np.load(case_file)
    out = {"coords": np.array([mesh.get_local_rank(a) if a in
                               mesh.mesh_dim_names else 0
                               for a in ("pod", "data", "model")])}
    for name, (_, specs) in CASES.items():
        dg = device_graph_from_packed(
            *(int(data[f"{name}/{k}"]) for k in ("n", "n_pad")),
            *(data[f"{name}/{k}"] for k in ("labels", "adj", "adj_t",
                                            "reach", "reach_t")),
            device="cpu")
        qts = encode_batch([query_from_spec(data[f"{name}/q{i}/labels"],
                                            data[f"{name}/q{i}/edges"])
                            for i in range(len(specs))], MAX_Q, MAX_E)
        mats, labels = distributed.shard_graph_arrays(dg, mesh)
        for pack_y in (False, True):
            key = f"{name}/{int(pack_y)}"
            out[f"{key}/fb"] = distributed.sharded_double_simulation(
                mats, labels, qts, mesh, n_passes=N_PASSES,
                pack_y=pack_y).numpy()
            for top_k in TOP_KS:
                r = distributed.gm_serve_step(mats, labels, qts, mesh,
                                              n_passes=N_PASSES, top_k=top_k,
                                              pack_y=pack_y)
                for field, value in r._asdict().items():
                    out[f"{key}/{top_k}/{field}"] = value.numpy()
        out[f"{name}/top_k_error"] = _error(
            lambda: distributed.gm_serve_step(mats, labels, qts, mesh,
                                              top_k=dg.n_pad + 1))
        g = graph_from_arrays(int(data[f"{name}/n"]),
                              data[f"{name}/graph_labels"],
                              int(data[f"{name}/num_labels"]),
                              data[f"{name}/edges"])
        misfit = from_host(g, block=MISFIT_BLOCK, device="cpu")
        out[f"{name}/misfit_error"] = _error(
            lambda: distributed.shard_graph_arrays(misfit, mesh))
    return out


def _error(fn):
    """The message of the ValueError that ``fn`` raises, else ''."""
    try:
        fn()
    except ValueError as e:
        return np.array(str(e))
    return np.array("")


def _rank(rank, world, shape, names, case_file, out_dir, store_file):
    """One spawned rank: a gloo group on a FileStore, the mesh, the cases."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.torchgm import frontier

    torch.set_num_threads(1)
    frontier.DEFAULT_DEVICE = "cpu"
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        mesh = (make_local_mesh(*shape) if names == ("data", "model")
                else init_device_mesh("cpu", shape, mesh_dim_names=names))
        np.savez(Path(out_dir) / f"rank{rank}.npz",
                 **_run_cases(mesh, case_file))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the parent
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX single-device answers, and the case file the ranks read."""
    pytest.importorskip("jax")
    from repro.data.graphs import random_labeled_graph
    from repro.data.queries import random_query_from_graph
    from repro.jaxgm import double_simulation, encode_query, from_host
    from repro.jaxgm.simulation import fb_sizes, rig_edge_counts

    arrays, want = {}, {}
    for name, (seed, specs) in CASES.items():
        g = random_labeled_graph(200, avg_degree=2.5, n_labels=4, seed=seed)
        dg = from_host(g, block=BLOCK)
        arrays.update({f"{name}/n": g.n, f"{name}/n_pad": dg.n_pad,
                       f"{name}/graph_labels": g.labels,
                       f"{name}/num_labels": g.num_labels,
                       f"{name}/edges": g.edges})
        for k in ("labels", "adj", "adj_t", "reach", "reach_t"):
            arrays[f"{name}/{k}"] = np.asarray(getattr(dg, k))
        fbs, sizes, edges = [], [], []
        for i, (k, t, s) in enumerate(specs):
            q = random_query_from_graph(g, k, qtype=t, seed=s)
            arrays[f"{name}/q{i}/labels"] = np.asarray(q.labels)
            arrays[f"{name}/q{i}/edges"] = np.array(
                [(e.src, e.dst, e.kind) for e in q.edges]).reshape(-1, 3)
            qt = encode_query(q, MAX_Q, MAX_E)
            fb = double_simulation(dg, qt, n_passes=N_PASSES,
                                   impl="reference")
            fbs.append(np.asarray(fb))
            sizes.append(np.asarray(fb_sizes(fb)))
            edges.append(np.asarray(rig_edge_counts(dg, qt, fb,
                                                    impl="reference")))
        want[name] = {"fb": np.stack(fbs), "fb_sizes": np.stack(sizes),
                      "edge_counts": np.stack(edges), "n_pad": dg.n_pad}
    case_file = tmp_path_factory.mktemp("cases") / "cases.npz"
    np.savez(case_file, **arrays)
    return case_file, want


def _in_process(case_file):
    """The 1 x 1 mesh in this process, on the one-process group that
    ``make_local_mesh`` starts."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.torchgm import frontier

    assert not dist.is_initialized()
    pin, frontier.DEFAULT_DEVICE = frontier.DEFAULT_DEVICE, "cpu"
    try:
        return [_run_cases(make_local_mesh(1, 1), case_file)]
    finally:
        frontier.DEFAULT_DEVICE = pin
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawned(shape, names, case_file, tmp):
    world = int(np.prod(shape))
    ctx = mp.start_processes(
        _rank, args=(world, shape, names, str(case_file), str(tmp),
                     str(tmp / "store")),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks on {shape} did not finish in "
                        f"{RANK_TIMEOUT_S} s")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """Each mesh's per-rank outputs, computed once."""
    case_file, _ = reference
    cache = {}

    def get(mesh):
        if mesh not in cache:
            shape, names = MESHES[mesh]
            cache[mesh] = (_in_process(case_file) if mesh == "1x1" else
                           _spawned(shape, names, case_file,
                                    tmp_path_factory.mktemp(mesh)))
        return cache[mesh]
    return get


def _gathered_fb(ranks, key):
    """The global FB: the ranks' blocks in model order (every rank of a
    model coordinate must hold the same block)."""
    blocks = {}
    for r in ranks:
        model = int(r["coords"][2])
        if model in blocks:
            np.testing.assert_array_equal(r[key], blocks[model])
        blocks[model] = r[key]
    return np.concatenate([blocks[m] for m in sorted(blocks)], axis=2)


def _plain_candidates(fb, top_k):
    """Ascending ids of each FB row's set bits, the first ``top_k``, then
    -1."""
    n_pad = fb.shape[-1]
    ids = np.where(fb, np.arange(n_pad, dtype=np.int32), n_pad)
    ids = np.sort(ids, axis=-1)[..., :top_k]
    return np.where(ids == n_pad, -1, ids).astype(np.int32)


@pytest.mark.parametrize("pack_y", [False, True])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_sim_matches_single_device(runs, reference, mesh, case,
                                           pack_y):
    want = reference[1][case]
    fb = _gathered_fb(runs(mesh), f"{case}/{int(pack_y)}/fb")
    assert fb.dtype == np.bool_
    np.testing.assert_array_equal(fb, want["fb"])


@pytest.mark.parametrize("pack_y", [False, True])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_serve_step_matches_single_device(runs, reference, mesh, case,
                                          pack_y):
    """fb_sizes, edge_counts and candidates equal on every rank (they are
    replicated) and equal to the single-device answer."""
    want = reference[1][case]
    ranks = runs(mesh)
    for top_k in TOP_KS:
        key = f"{case}/{int(pack_y)}/{top_k}"
        for r in ranks:
            assert r[f"{key}/fb_sizes"].dtype == np.int32
            assert r[f"{key}/edge_counts"].dtype == np.float32
            np.testing.assert_array_equal(r[f"{key}/fb_sizes"],
                                          want["fb_sizes"])
            np.testing.assert_array_equal(r[f"{key}/edge_counts"],
                                          want["edge_counts"])
            np.testing.assert_array_equal(
                r[f"{key}/candidates"], _plain_candidates(want["fb"], top_k))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_top_k_past_the_nodes_raises(runs, mesh):
    for r in runs(mesh):
        for case in CASES:
            assert "top_k=257" in str(r[f"{case}/top_k_error"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_model_degree_must_divide_the_words(runs, mesh):
    """n_pad 288 is 9 words: model degrees 2 and 4 raise, 1 cuts nothing."""
    for r in runs(mesh):
        for case in CASES:
            msg = str(r[f"{case}/misfit_error"])
            if mesh == "1x1":
                assert msg == ""
            else:
                assert msg.startswith("dimension 2 of (4, ")  # the words
                assert msg.endswith(", 9) does not divide over "
                                    f"{MESHES[mesh][0][-1]} shards of model")


@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
def test_rank_layout_is_row_major(runs, mesh):
    shape, names = MESHES[mesh]
    ranks = runs(mesh)
    full = (1,) * (3 - len(shape)) + shape
    for rank, r in enumerate(ranks):
        assert tuple(r["coords"]) == np.unravel_index(rank, full)


@pytest.fixture
def cpu_pin(monkeypatch):
    from repro_torch.torchgm import frontier
    monkeypatch.setattr(frontier, "DEFAULT_DEVICE", "cpu")
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_local_mesh_starts_a_one_process_group(cpu_pin):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.torchgm.distributed import graph_specs

    mesh = make_local_mesh()
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert mesh.device_type == "cpu"
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    specs = graph_specs(256, mesh)
    assert specs.mats == ((4, 256, 8), torch.int32, (None, ("data",),
                                                     "model"))
    assert specs.labels == ((256,), torch.int32, ("model",))


def test_mesh_shape_must_match_the_group(cpu_pin):
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        make_local_mesh(2, 2)            # no group, and more than one rank
    make_local_mesh(1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_local_mesh(2, 1)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)


def test_mesh_without_cuda_or_pin_raises(monkeypatch):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.torchgm import frontier

    monkeypatch.setattr(frontier, "DEFAULT_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh()
    assert not dist.is_initialized()


@pytest.mark.parametrize("local_rank,pin,world,want", [
    ("3", None, 8, 3),       # torchrun's LOCAL_RANK
    (None, None, 8, 1),      # else the rank (5) modulo the 4 cards
    ("3", "cpu", 8, None),   # a pinned device is left alone
    (None, None, 1, None),   # one rank keeps the current card
])
def test_mesh_takes_the_rank_card(monkeypatch, local_rank, pin, world,
                                  want):
    """On several ranks on the card, a rank takes its own card before the
    port's device is read (``init_device_mesh`` would not, once the
    current card has been read)."""
    from repro_torch.launch import mesh
    from repro_torch.torchgm import frontier

    picked = []
    monkeypatch.setattr(frontier, "DEFAULT_DEVICE", pin)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: picked[-1] if picked else 0)
    dev = mesh._device()
    assert picked == ([] if want is None else [want])
    assert dev == (torch.device("cpu") if pin
                   else torch.device("cuda", want or 0))
