"""The port's sharded GNN training step (``repro_torch.models.gnn_dist``)
against the JAX package, on the CPU, for gin and sage at smoke width.

A whole-graph batch of 64 nodes (one padding node, ``node_mask`` 0, at the
end of each block of 8, touched by no edge) is partitioned by destination
with a numpy helper: each rank takes its rows and the edges into them,
``edge_dst`` local and ``edge_src`` global, padded to a common count with
self-loops on its padding node.  The port runs in-process on a 1 x 1 mesh
and in 8 spawned gloo ranks on ``(2, 4)`` ``("data", "model")`` and
``(2, 2, 2)`` ``("pod", "data", "model")`` meshes; the ranks import
neither JAX nor the reference package (they re-import this module, which
imports JAX only inside fixtures) and write their results with numpy.

Held, float32, at the GNN path's tolerances: at each of two AdamW steps
the loss (2e-5) and every gradient leaf (1e-5 of the leaf's largest
entry) against the JAX single-device ``gnn.loss_fn`` on the whole graph
without padding edges; the parameters, m and v after each step against
the JAX ``apply_updates`` fed the port's gradients (1e-6 of each leaf's
largest entry); gradients and parameters bit-identical across ranks; and
on 1 x 1 the loss and the parameters after two steps against the JAX
``sharded_train_step`` on a 1 x 1 ``jax.sharding.Mesh``.
"""

import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

ARCHS = ("gin-tu", "graphsage-reddit")
N_NODES, N_EDGES, BLOCK = 64, 160, 8     # one padding node a block of 8
STEPS = 2
LR = dict(lr=1e-2, warmup_steps=1, total_steps=10)
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
RANK_TIMEOUT_S = 300


# ------------------------------------------------------------- the graph
def whole_graph(cfg, seed=0):
    """A node-classification batch whose last node of every block of
    ``BLOCK`` is padding: ``node_mask`` 0 and no edge in or out."""
    rng = np.random.default_rng(seed)
    real = np.flatnonzero(np.arange(N_NODES) % BLOCK != BLOCK - 1)
    return {
        "node_feat": rng.standard_normal((N_NODES, cfg.d_feat)).astype(
            np.float32),
        "edge_src": rng.choice(real, N_EDGES).astype(np.int32),
        "edge_dst": rng.choice(real, N_EDGES).astype(np.int32),
        "labels": rng.integers(0, cfg.n_classes, N_NODES).astype(np.int32),
        "node_mask": np.arange(N_NODES) % BLOCK != BLOCK - 1,
        "train_mask": rng.random(N_NODES) < 0.7,
    }


def partition_by_destination(batch, world):
    """Each rank's batch: its ``N / world`` rows of the node leaves and the
    edges into them (in the order of ``edge_dst``, stably), ``edge_dst``
    local and ``edge_src`` global, padded to the largest rank's edge count
    with self-loops on the rank's last padding node."""
    n = len(batch["node_mask"])
    assert n % world == 0
    n_l = n // world
    order = np.argsort(batch["edge_dst"], kind="stable")
    src, dst = batch["edge_src"][order], batch["edge_dst"][order]
    bounds = np.searchsorted(dst, np.arange(world + 1) * n_l)
    e_max = int(np.diff(bounds).max())
    out = []
    for r in range(world):
        rows = slice(r * n_l, (r + 1) * n_l)
        pad = np.flatnonzero(~batch["node_mask"][rows])[-1]  # local id
        e = slice(bounds[r], bounds[r + 1])
        fill = e_max - (e.stop - e.start)
        part = {k: batch[k][rows] for k in ("node_feat", "labels",
                                            "node_mask", "train_mask")}
        part["edge_src"] = np.concatenate(
            [src[e], np.full(fill, r * n_l + pad)]).astype(np.int32)
        part["edge_dst"] = np.concatenate(
            [dst[e] - r * n_l, np.full(fill, pad)]).astype(np.int32)
        out.append(part)
    return out


def test_partition_keeps_every_edge_and_pads_inertly():
    from repro_torch.configs import get_config

    batch = whole_graph(get_config("gin-tu").smoke_config())
    parts = partition_by_destination(batch, 8)
    n_l = N_NODES // 8
    assert len({len(p["edge_src"]) for p in parts}) == 1
    got = []
    for r, p in enumerate(parts):
        assert p["edge_dst"].min() >= 0 and p["edge_dst"].max() < n_l
        real = p["node_mask"][p["edge_dst"]]
        assert not p["node_mask"][p["edge_src"][~real] - r * n_l].any()
        got += list(zip(p["edge_src"][real], p["edge_dst"][real] + r * n_l))
    assert sorted(got) == sorted(zip(batch["edge_src"], batch["edge_dst"]))


# ------------------------------------------------------------- one rank
def _tree(flat):
    """A nested dict from ``{"a/b": leaf}``."""
    out = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _run_steps(mesh, rank, world, case_file):
    """Both archs on ``mesh`` from this rank's batch: per step the loss
    and gradients of ``sharded_loss_and_grads``, then the step's loss,
    parameters, m and v.  {key: numpy array}."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import gnn, gnn_dist
    from repro_torch.train import AdamWConfig, init_state
    from repro_torch.train import tree as tr

    data = np.load(case_file)
    out = {}
    for arch_id in ARCHS:
        cfg = get_config(arch_id).smoke_config()
        np_params = _tree({k[len(arch_id) + 8:]: data[k] for k in data.files
                           if k.startswith(f"{arch_id}/params/")})
        params = gnn.GNN(cfg, params_from_numpy(np_params, cfg,
                                                "cpu")).params
        state = init_state(params)
        batch = {k: torch.from_numpy(data[f"{arch_id}/{world}/{rank}/{k}"])
                 for k in gnn_dist.SHARDED_LEAVES}
        step, spec = gnn_dist.sharded_train_step(cfg, mesh,
                                                 AdamWConfig(**LR))
        loss_and_grads = gnn_dist.sharded_loss_and_grads(cfg, mesh)
        axes = tuple(a for a in ("pod", "data", "model")
                     if a in mesh.mesh_dim_names)
        assert spec == {**{k: (axes,) for k in gnn_dist.SHARDED_LEAVES},
                        "node_feat": (axes, None)}
        for s in range(STEPS):
            key = f"{arch_id}/{s}"
            loss, grads = loss_and_grads(params, batch)
            out[f"{key}/loss"] = loss.numpy()
            for k, g in tr.to_dict(grads).items():
                out[f"{key}/grads/{k}"] = g.numpy()
            params, state, loss = step(params, state, batch)
            out[f"{key}/step_loss"] = loss.numpy()
            for name, tree in (("params", params), ("m", state["m"]),
                               ("v", state["v"])):
                for k, v in tr.to_dict(tree).items():
                    out[f"{key}/{name}/{k}"] = v.detach().numpy().copy()
    return out


def _rank(rank, world, shape, names, case_file, out_dir, store_file):
    """One spawned rank: a gloo group on a FileStore, the mesh, the steps."""
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
                 **_run_steps(mesh, rank, world, case_file))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the parent
def _np_params(rcfg, seed=0):
    """The reference's init, perturbed with numpy (biases and eps not
    zero), as numpy arrays."""
    import jax

    from repro.models import gnn as rgnn

    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        rgnn.init_params(rcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The case file the ranks read, and per arch the reference config,
    numpy parameters and whole-graph batch."""
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config
    from repro_torch.train import tree as tr

    arrays, cases = {}, {}
    for arch_id in ARCHS:
        rcfg = ref_get_config(arch_id).smoke_config()
        np_params = _np_params(rcfg)
        batch = whole_graph(rcfg)
        cases[arch_id] = (rcfg, np_params, batch)
        for k, v in tr.to_dict(np_params).items():
            arrays[f"{arch_id}/params/{k}"] = v
        for world in (1, 8):
            for r, part in enumerate(partition_by_destination(batch, world)):
                for k, v in part.items():
                    arrays[f"{arch_id}/{world}/{r}/{k}"] = v
    case_file = tmp_path_factory.mktemp("cases") / "cases.npz"
    np.savez(case_file, **arrays)
    return case_file, cases


def _in_process(case_file):
    """The 1 x 1 mesh in this process, on the one-process group that
    ``make_local_mesh`` starts."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.torchgm import frontier

    assert not dist.is_initialized()
    pin, frontier.DEFAULT_DEVICE = frontier.DEFAULT_DEVICE, "cpu"
    try:
        return [_run_steps(make_local_mesh(1, 1), 0, 1, case_file)]
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
    """Each mesh's per-rank results, computed once."""
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


def _close_rel(got, want, rel):
    """Equal within ``rel`` of the reference leaf's largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _leaves(r, prefix):
    return {k[len(prefix):]: v for k, v in r.items() if k.startswith(prefix)}


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_matches_single_device(runs, reference, mesh, arch_id):
    """Loss and gradients against ``jax.value_and_grad(gnn.loss_fn)`` on the
    whole graph; the update against ``apply_updates`` fed the same
    gradients; every rank's gradients and parameters the same bits."""
    import jax
    import jax.numpy as jnp

    from repro.models import gnn as rgnn
    from repro.train import optimizer as ropt
    from repro_torch.train import tree as tr

    rcfg, np_params, batch = reference[1][arch_id]
    ranks = runs(mesh)
    jp = jax.tree.map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = ropt.init_state(jp)
    for s in range(STEPS):
        key = f"{arch_id}/{s}"
        first = ranks[0]
        for r in ranks[1:]:
            for part in ("grads", "params", "m", "v"):
                for k, v in _leaves(first, f"{key}/{part}/").items():
                    assert np.array_equal(r[f"{key}/{part}/{k}"], v), k
        jloss, jgrads = jax.value_and_grad(rgnn.loss_fn)(jp, jb, rcfg)
        for r in ranks:
            np.testing.assert_allclose(r[f"{key}/loss"], float(jloss),
                                       rtol=2e-5, atol=2e-5)
            assert r[f"{key}/step_loss"] == r[f"{key}/loss"]
        jflat = tr.to_dict(jax.tree.map(np.asarray, jgrads))
        grads = _leaves(first, f"{key}/grads/")
        assert sorted(grads) == sorted(jflat)
        for k, g in jflat.items():
            assert np.abs(g).max() > 0, k      # every leaf is reached
            _close_rel(grads[k], g, 1e-5)
        jp, jstate, _ = ropt.apply_updates(
            jp, jax.tree.map(jnp.asarray, _tree(grads)), jstate,
            ropt.AdamWConfig(**LR))
        for name, tree in (("params", jp), ("m", jstate["m"]),
                           ("v", jstate["v"])):
            got = _leaves(first, f"{key}/{name}/")
            for k, v in tr.to_dict(jax.tree.map(np.asarray, tree)).items():
                _close_rel(got[k], v, 1e-6)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_one_by_one_matches_reference_sharded_step(runs, reference, arch_id):
    """The JAX ``sharded_train_step`` on a 1 x 1 mesh, two steps from the
    same parameters and rank batch, each package from its own gradients:
    the loss (2e-5); after each step the parameters (1e-6 of each leaf's
    largest entry), m, linear in the gradients (their 1e-5), and v,
    quadratic in them (2e-5)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.models.gnn_dist import sharded_train_step
    from repro.train import optimizer as ropt
    from repro_torch.train import tree as tr

    rcfg, np_params, batch = reference[1][arch_id]
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    step, _ = sharded_train_step(rcfg, mesh, ropt.AdamWConfig(**LR))
    step = jax.jit(step)
    (part,) = partition_by_destination(batch, 1)
    jb = {k: jnp.asarray(v) for k, v in part.items()}
    jp = jax.tree.map(jnp.asarray, np_params)
    jstate = ropt.init_state(jp)
    (port,) = runs("1x1")
    for s in range(STEPS):
        key = f"{arch_id}/{s}"
        jp, jstate, jloss = step(jp, jstate, jb)
        np.testing.assert_allclose(port[f"{key}/step_loss"], float(jloss),
                                   rtol=2e-5, atol=2e-5)
        for name, tree, rel in (("params", jp, 1e-6),
                                ("m", jstate["m"], 1e-5),
                                ("v", jstate["v"], 2e-5)):
            got = _leaves(port, f"{key}/{name}/")
            for k, v in tr.to_dict(jax.tree.map(np.asarray, tree)).items():
                _close_rel(got[k], v, rel)


def test_ranks_hold_their_own_rows(reference):
    """The rank batches of the meshes of 8 are the whole graph's rows in rank
    order: rank ``r``'s node leaves are global rows ``8 r .. 8 r + 8``."""
    case_file, cases = reference
    data = np.load(case_file)
    batch = cases["gin-tu"][2]
    for k in ("node_feat", "labels", "node_mask", "train_mask"):
        np.testing.assert_array_equal(
            np.concatenate([data[f"gin-tu/8/{r}/{k}"] for r in range(8)]),
            batch[k])


def test_sharded_step_rejects_other_archs_and_axes(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import gnn_dist
    from repro_torch.torchgm import frontier
    from repro_torch.train import AdamWConfig

    monkeypatch.setattr(frontier, "DEFAULT_DEVICE", "cpu")
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh(1, 1)
        with pytest.raises(ValueError, match="gin and sage, not 'schnet'"):
            gnn_dist.sharded_train_step(
                get_config("schnet").smoke_config(), mesh, AdamWConfig())

        class Other:
            mesh_dim_names = ("data", "tensor")
        with pytest.raises(ValueError, match="only"):
            gnn_dist._all_axes(Other())
    finally:
        dist.destroy_process_group()
