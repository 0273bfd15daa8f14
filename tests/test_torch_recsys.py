"""The port's DIN path (``repro_torch.models.recsys``, ``data.recsys_data``,
the ``din`` config, ``launch.train``'s ``build_din``) against the JAX
package's, on the CPU.

Weights cross over as numpy arrays: the reference's ``init_params`` drawn
from a seed and perturbed with numpy (biases not zero), handed to both
packages (``convert.params_from_numpy``).  Tolerances, float32: outputs,
scores and losses to 2e-5 absolute / 2e-5 relative, gradients to 1e-5 of
each leaf's largest entry (the attention MLP's: see ``ATTN_REL``), an
AdamW step fed the reference's gradients to 1e-6 of each leaf's largest
entry.  Data builders and ``model_flops`` exactly.
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

from repro.configs import all_arch_ids as ref_arch_ids  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import recsys_data as rrd  # noqa: E402
from repro.models import recsys as rdin  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch.configs import (ASSIGNED, all_arch_ids,  # noqa: E402
                                 get_config)
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.data import recsys_data as prd  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import recsys as din  # noqa: E402
from repro_torch.torchgm import frontier  # noqa: E402
from repro_torch.train import Checkpointer  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
DIN_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


def _np(t):
    return t.detach().float().numpy()


def _close_rel(got, want, rel=1e-5):
    """Equal within ``rel`` of the reference leaf's largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _setup(seed=0):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg = ref_get_config("din").smoke_config()
    pcfg = get_config("din").smoke_config()
    rng = np.random.default_rng(seed)
    tree = {k: (np.asarray(v, np.float32)
                + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in rdin.init_params(rcfg, jax.random.key(seed)).items()}
    return (rcfg, pcfg, {k: jnp.asarray(v) for k, v in tree.items()},
            din.DIN(pcfg, params_from_numpy(tree, pcfg, "cpu")).params)


def _batches(np_batch):
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def _din_batch(cfg, b=8, step=0, seed=1):
    return rrd.din_batch(b, cfg.seq_len, cfg.n_items, cfg.n_cates,
                         cfg.n_user_feats, cfg.user_feat_vocab, step=step,
                         seed=seed)


# -------------------------------------------------------- model vs reference
@pytest.mark.parametrize("combine", ["none", "sum", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_embedding_bag_matches_reference(combine, masked):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((30, 5)).astype(np.float32)
    ids = rng.integers(0, 30, (4, 6)).astype(np.int32)
    ids[1] = 7                                        # one id repeated
    mask = (rng.random((4, 6)) < 0.6).astype(np.float32)
    mask[2] = 0                                       # an empty bag
    m = mask if masked else None
    want = rdin.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              None if m is None else jnp.asarray(m), combine)
    got = din.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            None if m is None else torch.from_numpy(m),
                            combine)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("hist_len", [1, 3])
def test_target_attention_matches_reference(hist_len):
    """A one-position history (softmax over one score) and a masked one:
    the ``-1e30`` fill and the zero after the softmax."""
    rcfg, pcfg, jp, pp = _setup()
    rng = np.random.default_rng(2)
    pair = 2 * rcfg.embed_dim
    hist = rng.standard_normal((4, hist_len, pair)).astype(np.float32)
    tgt = rng.standard_normal((4, pair)).astype(np.float32)
    mask = np.ones((4, hist_len), np.float32)
    if hist_len > 1:
        mask[1, 1:] = 0
        mask[3, 0] = 0
    want = rdin.target_attention(jp, jnp.asarray(hist), jnp.asarray(tgt),
                                 jnp.asarray(mask))
    got = din.target_attention(pp, torch.from_numpy(hist),
                               torch.from_numpy(tgt), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


# DIN's attention MLP: the gradient of its scores sums to zero over each
# history (the softmax is shift-invariant), so its leaves' gradients are
# sums whose terms cancel (attn_b2's exactly: its gradient is zero), and
# each package's float32 rounding of the scores' gradient shows there at
# about 1e-5 of a leaf's largest entry (probed against a float64 run).
# Each attn_* leaf is held within 1e-6 (16 float32 ulps) of the largest
# entry of its gradient with the scores' gradient taken in absolute value
# (the cancelling terms' magnitudes), or within 1e-5 of its own, whichever
# is larger; that scale comes from the reference.
ATTN_REL = 1e-6


def _ref_attention_scales(jp, jb, rcfg):
    """{attn_* leaf: the largest entry of the reference loss's gradient
    with respect to it, taken with the scores' gradient in absolute
    value}.  The scores' gradient is the loss's gradient with respect to a
    last attention bias that has one entry per score."""
    n = rdin._n_layers(jp, "attn")
    last = f"attn_b{n - 1}"
    bias = jnp.broadcast_to(jp[last], jb["hist_mask"].shape + (1,))
    d_scores = jax.grad(
        lambda b: rdin.loss_fn({**jp, last: b}, jb, rcfg))(bias)[..., 0]

    def pair(items, cates):
        return jnp.concatenate([rdin.embedding_bag(jp["item_table"], items),
                                rdin.embedding_bag(jp["cate_table"], cates)],
                               axis=-1)

    hist = pair(jb["hist_items"], jb["hist_cates"])
    t = jnp.broadcast_to(pair(jb["item_id"], jb["cate_id"])[:, None, :],
                         hist.shape)
    feats = jnp.concatenate([hist, t, hist * t, hist - t], axis=-1)
    attn = {k: v for k, v in jp.items() if k.startswith("attn_")}
    _, vjp = jax.vjp(lambda a: rdin._mlp(a, "attn", feats, n)[..., 0], attn)
    (grads,) = vjp(jnp.abs(d_scores))
    return {k: float(jnp.abs(g).max()) for k, g in grads.items()}


def test_forward_loss_grads_match_reference():
    """forward, loss_fn and every gradient leaf (the attention MLP's as
    above); the tables' gradients are dense (``jnp.take``'s are) and
    equal, zero on rows no id touched."""
    rcfg, pcfg, jp, pp = _setup()
    nb = _din_batch(rcfg)
    jb, pb = _batches(nb)
    np.testing.assert_allclose(_np(din.forward(pp, pb, pcfg)),
                               np.asarray(rdin.forward(jp, jb, rcfg)), **F32)
    jloss, jgrads = jax.value_and_grad(rdin.loss_fn)(jp, jb, rcfg)
    ploss = din.loss_fn(pp, pb, pcfg)
    np.testing.assert_allclose(ploss.item(), float(jloss), **F32)
    keys = sorted(pp)
    pgrads = dict(zip(keys, torch.autograd.grad(
        ploss, [pp[k] for k in keys])))
    assert sorted(jgrads) == keys
    scales = _ref_attention_scales(jp, jb, rcfg)
    assert sorted(scales) == [k for k in keys if k.startswith("attn_")]
    for k in keys:
        assert pgrads[k].layout == torch.strided, k
        want = np.asarray(jgrads[k])
        assert tuple(pgrads[k].shape) == want.shape, k
        atol = max(1e-5 * max(float(np.abs(want).max()), 1e-30),
                   ATTN_REL * scales.get(k, 0.0))
        np.testing.assert_allclose(_np(pgrads[k]), want, rtol=0, atol=atol,
                                   err_msg=k)
    used = np.unique(np.concatenate([nb["item_id"].ravel(),
                                     nb["hist_items"].ravel()]))
    unused = np.setdiff1d(np.arange(rcfg.n_items), used)
    assert not pgrads["item_table"][torch.from_numpy(unused)].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_attention_grad_scales_match_reference(seed):
    """The port's ``attention_grad_scales`` (the yardstick of its card
    checks) against the reference's, to 2e-5 relative."""
    rcfg, pcfg, jp, pp = _setup(seed)
    jb, pb = _batches(_din_batch(rcfg, seed=seed + 1))
    want = _ref_attention_scales(jp, jb, rcfg)
    got = din.attention_grad_scales(pp, pb, pcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, err_msg=k)


def test_retrieval_scores_match_reference_and_forward():
    """``retrieval_scores`` against the reference, and against ``forward``
    on the same candidates with the user's history repeated."""
    rcfg, pcfg, jp, pp = _setup()
    rb = rrd.retrieval_batch(rcfg.seq_len, rcfg.n_items, rcfg.n_cates,
                             rcfg.n_user_feats, rcfg.user_feat_vocab,
                             n_candidates=64, seed=3)
    jrb, prb = _batches(rb)
    got = din.retrieval_scores(pp, prb, pcfg)
    np.testing.assert_allclose(
        _np(got), np.asarray(rdin.retrieval_scores(jp, jrb, rcfg)), **F32)
    c = len(rb["cand_items"])
    as_batch = {"item_id": prb["cand_items"], "cate_id": prb["cand_cates"],
                **{k: prb[k].expand(c, -1) for k in
                   ("hist_items", "hist_cates", "hist_mask", "user_feats")}}
    np.testing.assert_allclose(_np(got), _np(din.forward(pp, as_batch, pcfg)),
                               **F32)


def test_adamw_two_steps_match_reference_on_din():
    """Two ``apply_updates`` steps fed the reference's gradients: every
    row of the tables moves (dense gradients, decay on 2-D leaves);
    parameters, m and v to 1e-6 of each leaf's largest entry."""
    rcfg, pcfg, jp, pp = _setup()
    jb, pb = _batches(_din_batch(rcfg))
    ocfg = ropt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    pocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    before = pp["item_table"].detach().clone()
    jstate = ropt.init_state(jp)
    pstate = adamw_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    for _ in range(2):
        jgrads = jax.grad(rdin.loss_fn)(jp, jb, rcfg)
        jp, jstate, jm = ropt.apply_updates(jp, jgrads, jstate, ocfg)
        pp, pstate, pm = opt.apply_updates(
            pp, params_from_numpy(jax.tree.map(np.asarray, jgrads), pcfg,
                                  "cpu"), pstate, pocfg)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert bool((pp["item_table"].detach() != before).all(-1).all())
    for tree_p, tree_j in ((pp, jp), (pstate["m"], jstate["m"]),
                           (pstate["v"], jstate["v"])):
        assert sorted(tree_p) == sorted(tree_j)
        for k in tree_j:
            _close_rel(_np(tree_p[k]), np.asarray(tree_j[k]), 1e-6)


def test_named_parameters_and_init_scales():
    """The module's names are the reference's keys; the init rule: 1-D
    leaves zero, 0.01 above 10,000 rows, else 1 / sqrt(rows)."""
    cfg = get_config("din").cfg
    model = din.DIN(dataclasses.replace(cfg, n_items=20_000),
                    generator=torch.Generator().manual_seed(0))
    ref = rdin.param_shapes(ref_get_config("din").cfg)
    assert {n for n, _ in model.named_parameters()} == set(ref)
    p = {k: v.detach() for k, v in model.params.items()}
    for k, v in p.items():
        if v.ndim == 1:
            assert not v.any(), k
    assert abs(float(p["item_table"].std()) - 0.01) < 5e-4
    assert abs(float(p["cate_table"].std()) - 0.01) < 5e-4   # 10,000 rows
    assert abs(float(p["user_table"].std()) - 1 / 32) < 2e-3
    assert abs(float(p["mlp_w0"].std()) - 1 / math.sqrt(
        p["mlp_w0"].shape[0])) < 0.01


# ------------------------------------------------------------------ data
def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("step", [0, 1, 7])
def test_recsys_data_equals_reference(step):
    args = (16, 12, 1000, 50, 8, 40)
    _equal(prd.din_batch(*args, step=step, seed=2),
           rrd.din_batch(*args, step=step, seed=2))
    _equal(prd.retrieval_batch(12, 1000, 50, 8, 40, n_candidates=100,
                               seed=step),
           rrd.retrieval_batch(12, 1000, 50, 8, 40, n_candidates=100,
                               seed=step))


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("shape", DIN_SHAPES)
def test_model_flops_and_abstract_batch_match_reference(shape):
    ref, port = ref_get_config("din"), get_config("din")
    assert port.model_flops(shape) == ref.model_flops(shape)
    assert port.model_flops(dict(port.shapes[shape])) \
        == ref.model_flops(shape)
    pb, rb = port._abstract_batch(shape), ref._abstract_batch(shape)
    assert sorted(pb) == sorted(rb)
    for k, v in rb.items():
        assert pb[k].device.type == "meta", k
        assert tuple(pb[k].shape) == tuple(v.shape), k
        assert str(pb[k].dtype).split(".")[-1] == str(v.dtype), k


def test_config_matches_reference():
    ref, port = ref_get_config("din"), get_config("din")
    assert port.family == ref.family == "recsys"
    assert port.shapes == ref.shapes
    for cfg_p, cfg_r in ((port.cfg, ref.cfg),
                         (port.smoke_config(), ref.smoke_config())):
        for f in dataclasses.fields(cfg_r):
            if f.name != "dtype":
                assert getattr(cfg_p, f.name) == getattr(cfg_r, f.name), \
                    f.name
    assert port.cfg.dtype == torch.float32


def test_arch_smoke_runs_on_cpu():
    out = get_config("din").smoke(seed=0, device="cpu")
    ref = ref_get_config("din").smoke(seed=0)
    assert out["finite"] and out["scores_shape"] == ref["scores_shape"]
    assert 0.3 < out["loss"] < 1.5


def test_registry_resolves_the_ten_archs():
    ids = all_arch_ids(include_pattern=False)
    assert ids == ref_arch_ids(include_pattern=False) == ASSIGNED
    assert all_arch_ids() == ids + ["rig_gm"]
    for arch_id in ids:
        assert get_config(arch_id).arch_id == arch_id
        assert get_config(arch_id).family == ref_get_config(arch_id).family


# -------------------------------------------------------------- training
def test_din_loss_decreases():
    """40 AdamW steps lower the loss on a held-out batch (the reference's
    ``test_din_loss_decreases``)."""
    cfg = get_config("din").smoke_config()
    params = din.DIN(cfg, generator=torch.Generator().manual_seed(0)).params
    state = opt.init_state(params)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=60,
                           weight_decay=0.0)
    step = opt.make_train_step(lambda p, b: din.loss_fn(p, b, cfg), ocfg)

    def make(i):
        return {k: torch.from_numpy(v) for k, v in prd.din_batch(
            64, cfg.seq_len, cfg.n_items, cfg.n_cates, cfg.n_user_feats,
            cfg.user_feat_vocab, step=i).items()}

    with torch.no_grad():
        first = float(din.loss_fn(params, make(1000), cfg))
    for i in range(40):
        params, state, _ = step(params, state, make(i))
    with torch.no_grad():
        last = float(din.loss_fn(params, make(1000), cfg))
    assert last < first, (first, last)


# ------------------------------------------------------------- launcher
def _main(argv, monkeypatch):
    monkeypatch.setattr(frontier, "DEFAULT_DEVICE", None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch.main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("extra", [[], ["--compress-grads"]],
                         ids=["plain", "compress"])
def test_launch_train_din_on_cpu(tmp_path, monkeypatch, extra):
    argv = ["--arch", "din", "--device", "cpu", "--steps", "3",
            "--ckpt-dir", str(tmp_path)] + extra
    out = _main(argv, monkeypatch)
    assert "family=recsys device=cpu" in out and "done: step=3" in out, out
    assert Checkpointer(str(tmp_path)).latest_step() == 3
    out = _main(argv, monkeypatch)
    assert "resumed=True from step 3" in out and "no step left" in out


def test_din_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(["--arch", "din", "--steps", "1", "--ckpt-dir",
               str(tmp_path)], monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_config("din").smoke(seed=0)
