"""The port's GNN path (``repro_torch.models.gnn``, ``data.gnn_data``,
``data.sampler``, the four GNN configs, ``launch.train``'s ``build_gnn``)
against the JAX package's, on the CPU.

Weights cross over as numpy arrays: the reference's ``init_params`` drawn
from a seed and perturbed with numpy (so biases and ``eps`` are not zero;
the sampled case keeps the reference's init, whose padding rows are
exactly zero), handed to both packages (``convert.params_from_numpy`` on
the port's side).  Tolerances, float32: outputs and losses to 2e-5
absolute / 2e-5 relative, gradients to 1e-5 of each leaf's largest entry
(XLA and torch sum in other orders), an AdamW step fed the reference's
gradients to 1e-6 of each leaf's largest entry.  Data builders, the
sampler, ``model_flops`` and the RBF centres exactly.
"""

import contextlib
import dataclasses
import io
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import gnn_data as rgd  # noqa: E402
from repro.data import sampler as rsm  # noqa: E402
from repro.models import gnn as rgnn  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.data import gnn_data as pgd  # noqa: E402
from repro_torch.data import sampler as psm  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.torchgm import frontier  # noqa: E402
from repro_torch.train import Checkpointer  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import tree as tr  # noqa: E402

GNN_ARCHS = ("gin-tu", "graphsage-reddit", "schnet", "graphcast")
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
F32 = dict(rtol=2e-5, atol=2e-5)


def _np(t):
    return t.detach().float().numpy()


def _close_rel(got, want, rel=1e-5):
    """Equal within ``rel`` of the reference leaf's largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _configs(arch_id):
    return (ref_get_config(arch_id).smoke_config(),
            get_config(arch_id).smoke_config())


def _np_params(rcfg, seed=0, perturb=True):
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        rgnn.init_params(rcfg, jax.random.key(seed)))
    if not perturb:
        return tree
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


def _both(np_tree, pcfg, np_batch):
    jp = jax.tree.map(jnp.asarray, np_tree)
    pp = gnn.GNN(pcfg, params_from_numpy(np_tree, pcfg, "cpu")).params
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    pb = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    return jp, pp, jb, pb


def _batch(arch, case, cfg, seed=1):
    """The numpy batch of one (arch, case): the smoke builders' shapes,
    with masked nodes where the case reads ``node_mask``."""
    rng = np.random.default_rng(seed)
    if arch == "graphcast":
        b = rgd.graphcast_batch(24, 8, cfg.n_vars, 32, 24, 24, seed=seed)
        b["node_mask"][[3, 17]] = False
        return b
    if arch == "schnet":
        b = rgd.schnet_batch(10, 24, cfg.d_feat, batch=3, seed=seed)
        b["node_mask"][[4, 15, 29]] = False
        if case == "node":
            del b["graph_ids"], b["graph_targets"]
        return b
    if case == "sampled":
        g = rsm.random_csr_graph(200, avg_deg=5, d_feat=cfg.d_feat,
                                 n_classes=cfg.n_classes, seed=seed)
        return rsm.sampled_batch(g, 16, (4, 3), step=2, seed=seed)
    b = rgd.full_graph_batch(24, 60, cfg.d_feat, cfg.n_classes, seed=seed)
    if case == "graph":
        del b["labels"], b["train_mask"]
        b["node_mask"][[2, 9, 23]] = False
        b["graph_ids"] = np.repeat(np.arange(3), 8).astype(np.int32)
        b["graph_labels"] = rng.integers(0, cfg.n_classes, 3).astype(
            np.int32)
    return b


CASES = [("gin-tu", "node"), ("gin-tu", "graph"),
         ("graphsage-reddit", "node"), ("graphsage-reddit", "graph"),
         ("graphsage-reddit", "sampled"), ("gin-tu", "sampled"),
         ("schnet", "graph"), ("schnet", "node"), ("graphcast", "node")]


# -------------------------------------------------------- model vs reference
@pytest.mark.parametrize("arch_id,case", CASES,
                         ids=[f"{a}-{c}" for a, c in CASES])
def test_forward_loss_grads_match_reference(arch_id, case):
    """forward, loss_fn and every gradient leaf in float32 against the JAX
    package: node-level (with ``train_mask``), graph-level (``graph_ids``
    with ``graph_labels``), sampled batches with zero padding rows at the
    reference's init, schnet with and without ``graph_targets``."""
    rcfg, pcfg = _configs(arch_id)
    np_tree = _np_params(rcfg, perturb=case != "sampled")
    jp, pp, jb, pb = _both(np_tree, pcfg, _batch(rcfg.arch, case, rcfg))

    np.testing.assert_allclose(_np(gnn.forward(pp, pb, pcfg)),
                               np.asarray(rgnn.forward(jp, jb, rcfg)), **F32)
    jloss, jgrads = jax.value_and_grad(rgnn.loss_fn)(jp, jb, rcfg)
    ploss = gnn.loss_fn(pp, pb, pcfg)
    np.testing.assert_allclose(ploss.item(), float(jloss), **F32)
    pgrads = dict(zip(tr.to_dict(pp), torch.autograd.grad(
        ploss, tr.leaves(pp), materialize_grads=True)))
    jflat = tr.to_dict(jax.tree.map(np.asarray, jgrads))
    assert sorted(pgrads) == sorted(jflat)
    for k in jflat:
        assert np.isfinite(jflat[k]).all(), k
        _close_rel(_np(pgrads[k]), jflat[k])


@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_aggregate_matches_segment_sum(kind):
    """Repeated and empty destinations and the sink's self-loops (padded
    edges ``sink -> sink``)."""
    rng = np.random.default_rng(0)
    n, sink = 9, 8
    dst = np.array([0, 0, 0, 3, 5, 5, 0, sink, sink, sink], np.int32)
    msg = rng.standard_normal((len(dst), 6)).astype(np.float32)
    want = np.asarray(rgnn.aggregate(jnp.asarray(msg), jnp.asarray(dst), n,
                                     kind))
    got = _np(gnn.aggregate(torch.from_numpy(msg), torch.from_numpy(dst), n,
                            kind))
    np.testing.assert_allclose(got, want, **F32)
    assert not got[[1, 2, 4, 6, 7]].any()            # no edge arrives there


@pytest.mark.parametrize("n_rbf,cutoff", [(300, 10.0), (16, 10.0),
                                          (64, 5.0), (1000, 7.3), (2, 1.0),
                                          (1, 3.0)])
def test_rbf_centres_equal_jnp_linspace(n_rbf, cutoff):
    """``jnp.linspace``'s centres to the bit (``torch.linspace`` rounds a
    third of them another way), and the filter input within float32."""
    got = gnn._centres(cutoff, n_rbf, torch.float32, "cpu").numpy()
    want = np.asarray(jnp.linspace(0.0, cutoff, n_rbf))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    rcfg = dataclasses.replace(ref_get_config("schnet").cfg, n_rbf=n_rbf,
                               cutoff=cutoff)
    pcfg = dataclasses.replace(get_config("schnet").cfg, n_rbf=n_rbf,
                               cutoff=cutoff)
    dist = (np.random.default_rng(0).random(50) * cutoff).astype(np.float32)
    np.testing.assert_allclose(
        _np(gnn._rbf(torch.from_numpy(dist), pcfg)),
        np.asarray(rgnn._rbf(jnp.asarray(dist), rcfg)), **F32)


def test_adamw_two_steps_match_reference_on_gin():
    """Two ``apply_updates`` steps fed the reference's gradients: the
    parameters, m and v to 1e-6 of each leaf's largest entry."""
    rcfg, pcfg = _configs("gin-tu")
    np_tree = _np_params(rcfg)
    jp, pp, jb, pb = _both(np_tree, pcfg, _batch("gin", "node", rcfg))
    ocfg = ropt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    pocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jstate = ropt.init_state(jp)
    pstate = adamw_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    for _ in range(2):
        jgrads = jax.grad(rgnn.loss_fn)(jp, jb, rcfg)
        jp, jstate, jm = ropt.apply_updates(jp, jgrads, jstate, ocfg)
        pp, pstate, pm = opt.apply_updates(
            pp, params_from_numpy(jax.tree.map(np.asarray, jgrads), pcfg,
                                  "cpu"), pstate, pocfg)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(pstate["step"]) == int(jstate["step"]) == 2
    for tree_p, tree_j in ((pp, jp), (pstate["m"], jstate["m"]),
                           (pstate["v"], jstate["v"])):
        jf = tr.to_dict(jax.tree.map(np.asarray, tree_j))
        pf = tr.to_dict(tree_p)
        assert sorted(pf) == sorted(jf)
        for k, v in pf.items():
            _close_rel(_np(v), jf[k], 1e-6)


@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_named_parameters_map_to_reference_keys(arch_id):
    rcfg, pcfg = _configs(arch_id)
    model = gnn.GNN(pcfg, generator=torch.Generator().manual_seed(0))
    names = {n.replace(".", "/") for n, _ in model.named_parameters()}
    ref = tr.to_dict(jax.tree.map(
        np.asarray, rgnn.init_params(rcfg, jax.random.key(0))))
    assert names == set(ref)
    for k, p in tr.to_dict(model.params).items():
        assert tuple(p.shape) == ref[k].shape and p.requires_grad, k
        p = p.detach()
        assert p.dtype == torch.float32
        if p.ndim == 1:                          # biases and eps{i}
            assert not p.any(), k
        else:
            assert 0.5 < float(p.std() * math.sqrt(p.shape[0])) < 1.5, k


# ------------------------------------------------------------------ data
def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [0, 3])
def test_gnn_data_builders_equal_reference(seed):
    _equal(pgd.full_graph_batch(50, 120, 7, 5, seed=seed),
           rgd.full_graph_batch(50, 120, 7, 5, seed=seed))
    _equal(pgd.full_graph_batch(30, 40, 3, seed=seed, with_labels=False),
           rgd.full_graph_batch(30, 40, 3, seed=seed, with_labels=False))
    _equal(pgd.schnet_batch(10, 24, 16, batch=4, cutoff=5.0, seed=seed),
           rgd.schnet_batch(10, 24, 16, batch=4, cutoff=5.0, seed=seed))
    _equal(pgd.graphcast_batch(40, 12, 9, 50, 30, 35, seed=seed),
           rgd.graphcast_batch(40, 12, 9, 50, 30, 35, seed=seed))


def test_sampler_equals_reference():
    """``random_csr_graph``'s fields, ``sample_blocks`` and
    ``sampled_batch`` over several steps (default and given padding)."""
    pg = psm.random_csr_graph(500, avg_deg=7.5, d_feat=6, n_classes=4,
                              seed=2)
    rg = rsm.random_csr_graph(500, avg_deg=7.5, d_feat=6, n_classes=4,
                              seed=2)
    assert pg.n == rg.n == 500
    for f in ("indptr", "indices", "feats", "labels"):
        a, b = getattr(pg, f), getattr(rg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    seeds = np.array([0, 7, 499, 31])
    got = psm.sample_blocks(pg, seeds, (5, 3), np.random.default_rng(1))
    want = rsm.sample_blocks(rg, seeds, (5, 3), np.random.default_rng(1))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for step in range(4):
        _equal(psm.sampled_batch(pg, 32, (5, 3), step, seed=1),
               rsm.sampled_batch(rg, 32, (5, 3), step, seed=1))
    _equal(psm.sampled_batch(pg, 8, (4, 2), 5, pad_nodes=200, pad_edges=300),
           rsm.sampled_batch(rg, 8, (4, 2), 5, pad_nodes=200, pad_edges=300))


def test_sampled_batch_pads_to_a_masked_sink():
    g = psm.random_csr_graph(300, avg_deg=6, d_feat=4, n_classes=3, seed=0)
    b = psm.sampled_batch(g, 16, (4, 3), 0)
    n = len(b["node_mask"])
    assert n == 16 * (1 + 4) * (1 + 3) and len(b["edge_src"]) == n
    sink = n - 1
    assert not b["node_mask"][sink] and b["train_mask"][:16].all()
    pad = b["edge_src"] == sink
    assert (b["edge_dst"][pad] == sink).all() and pad.any()
    assert not b["node_feat"][~b["node_mask"]].any()


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_model_flops_and_abstract_batch_match_reference(arch_id, shape):
    ref, port = ref_get_config(arch_id), get_config(arch_id)
    assert port.model_flops(shape) == ref.model_flops(shape)
    assert port.model_flops(dict(port.shapes[shape])) \
        == ref.model_flops(shape)
    pb, pcfg = port._abstract_batch(shape)
    rb, rcfg = ref._abstract_batch(shape)
    assert sorted(pb) == sorted(rb)
    for k, v in rb.items():
        assert pb[k].device.type == "meta", k
        assert tuple(pb[k].shape) == tuple(v.shape), k
        assert str(pb[k].dtype).split(".")[-1] == str(v.dtype), k
    assert pcfg.d_feat == rcfg.d_feat


@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_config_fields_match_reference(arch_id):
    ref, port = ref_get_config(arch_id), get_config(arch_id)
    assert port.family == ref.family == "gnn"
    assert port.shapes == ref.shapes
    for f in dataclasses.fields(ref.cfg):
        if f.name != "dtype":
            assert getattr(port.cfg, f.name) == getattr(ref.cfg, f.name), \
                f.name
    assert port.cfg.dtype == torch.float32 and ref.cfg.dtype == jnp.float32
    smoke = {f.name: getattr(ref.smoke_config(), f.name)
             for f in dataclasses.fields(ref.cfg) if f.name != "dtype"}
    assert {k: getattr(port.smoke_config(), k) for k in smoke} == smoke


@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_arch_smoke_runs_on_cpu(arch_id):
    out = get_config(arch_id).smoke(seed=0, device="cpu")
    ref = ref_get_config(arch_id).smoke(seed=0)
    assert out["finite"] and out["out_shape"] == ref["out_shape"]
    assert math.isfinite(out["loss"])


# -------------------------------------------------------------- training
def test_gnn_sampled_batch_trains():
    """25 AdamW steps on sampled batches lower graphsage's loss on the
    first batch (the reference's ``test_gnn_sampled_batch_trains``)."""
    cfg = get_config("graphsage-reddit").smoke_config()
    g = psm.random_csr_graph(400, avg_deg=6, d_feat=cfg.d_feat,
                             n_classes=cfg.n_classes, seed=0)
    params = gnn.GNN(cfg, generator=torch.Generator().manual_seed(0)).params
    state = opt.init_state(params)
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=40,
                           weight_decay=0.0)
    step = opt.make_train_step(lambda p, b: gnn.loss_fn(p, b, cfg), ocfg)

    def batch(i):
        return {k: torch.from_numpy(v)
                for k, v in psm.sampled_batch(g, 32, (5, 3), i).items()}

    with torch.no_grad():
        first = float(gnn.loss_fn(params, batch(0), cfg))
    for i in range(25):
        params, state, _ = step(params, state, batch(i))
    with torch.no_grad():
        last = float(gnn.loss_fn(params, batch(0), cfg))
    assert np.isfinite(last) and last < first, (first, last)


# ------------------------------------------------------------- launcher
def _main(argv, monkeypatch):
    monkeypatch.setattr(frontier, "DEFAULT_DEVICE", None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch.main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("arch_id", ["gin-tu", "graphsage-reddit"])
def test_launch_train_gnn_on_cpu(tmp_path, monkeypatch, arch_id):
    argv = ["--arch", arch_id, "--device", "cpu", "--steps", "3",
            "--ckpt-dir", str(tmp_path)]
    out = _main(argv, monkeypatch)
    assert "family=gnn device=cpu" in out and "done: step=3" in out, out
    assert Checkpointer(str(tmp_path)).latest_step() == 3
    out = _main(argv, monkeypatch)
    assert "resumed=True from step 3" in out and "no step left" in out


@pytest.mark.parametrize("arch_id,field", [("schnet", "edge_feat"),
                                           ("graphcast", "mesh_feat")])
def test_launch_train_fails_as_reference_without_geometry(
        tmp_path, monkeypatch, arch_id, field):
    """The reference's launcher feeds every GNN arch sampled batches;
    schnet and graphcast read fields those lack."""
    with pytest.raises(KeyError, match=field):
        _main(["--arch", arch_id, "--device", "cpu", "--steps", "1",
               "--ckpt-dir", str(tmp_path)], monkeypatch)
    cfg = ref_get_config(arch_id).smoke_config()
    g = rsm.random_csr_graph(2048, avg_deg=8, d_feat=cfg.d_feat,
                             n_classes=cfg.n_classes, seed=0)
    b = {k: jnp.asarray(v) for k, v in
         rsm.sampled_batch(g, 64, (8, 4), 0).items()}
    with pytest.raises(KeyError, match=field):
        rgnn.loss_fn(rgnn.init_params(cfg, jax.random.key(0)), b, cfg)


def test_launch_train_gnn_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(["--arch", "gin-tu", "--steps", "1", "--ckpt-dir",
               str(tmp_path)], monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_config("schnet").smoke(seed=0)
