"""The port's LM (``repro_torch.models.transformer``) against the JAX
package's (``repro.models.transformer``), on the CPU.

Weights cross over as numpy arrays: the reference's ``init_params`` drawn
from a seed and perturbed with numpy (so norms are not one and biases not
zero), then handed to both packages (``convert.params_from_numpy`` on
the port's side).  Tolerances, float32: logits and losses to 2e-5
absolute / 2e-5 relative, gradients to 1e-5 relative of each leaf's
largest entry (summation order differs between XLA and torch); the bf16
forward to 0.1 absolute on logits of unit scale (bf16 carries 8 bits).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_arch_ids as ref_arch_ids  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import tree as tr  # noqa: E402

LM_ARCHS = ("yi-34b", "qwen1.5-4b", "qwen2-7b", "grok-1-314b",
            "deepseek-moe-16b")
F32 = dict(rtol=2e-5, atol=2e-5)
B, T = 2, 16


def _configs(arch_id, **over):
    """(reference cfg, port cfg) of an arch's smoke config."""
    rcfg = ref_get_config(arch_id).smoke_config()
    pcfg = get_config(arch_id).smoke_config()
    rdt = over.pop("dtype", None)
    if rdt is not None:
        rcfg = dataclasses.replace(rcfg, dtype=jnp.bfloat16)
        pcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16)
    return (dataclasses.replace(rcfg, **over),
            dataclasses.replace(pcfg, **over))


def _np_params(rcfg, seed=0):
    """The reference's init, perturbed so norms and biases are generic."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        rtf.init_params(rcfg, jax.random.key(seed)))
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


def _both(rcfg, pcfg, np_tree):
    jp = jax.tree.map(lambda a: jnp.asarray(a, rcfg.dtype), np_tree)
    pp = tf.TransformerLM(pcfg, params_from_numpy(np_tree, pcfg,
                                                  "cpu")).params
    return jp, pp


def _batch(vocab, seed=1, t=T, mask=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, vocab, (B, t)).astype(np.int32),
         "labels": rng.integers(0, vocab, (B, t)).astype(np.int32)}
    if mask:
        b["mask"] = (rng.random((B, t)) < 0.7).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _np(t):
    return t.detach().float().numpy()


def _close_rel(got, want, rel=1e-5):
    """Equal within ``rel`` of the reference leaf's largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# -------------------------------------------------------- whole smoke step
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_smoke_step_matches_reference(arch_id):
    """forward logits, loss_fn, every gradient leaf and one apply_updates
    step, in float32, against the JAX package (the mask path on)."""
    rcfg, pcfg = _configs(arch_id)
    np_tree = _np_params(rcfg)
    jp, pp = _both(rcfg, pcfg, np_tree)
    jb, pb = _batch(rcfg.vocab, mask=True)

    np.testing.assert_allclose(
        _np(tf.forward(pp, pb["tokens"], pcfg)),
        np.asarray(rtf.forward(jp, jb["tokens"], rcfg)), **F32)

    jloss, jgrads = jax.value_and_grad(rtf.loss_fn)(jp, jb, rcfg)
    ploss = tf.loss_fn(pp, pb, pcfg)
    np.testing.assert_allclose(ploss.item(), float(jloss), **F32)
    pgrads = dict(zip(tr.to_dict(pp), torch.autograd.grad(
        ploss, tr.leaves(pp))))
    jflat = tr.to_dict(jax.tree.map(np.asarray, jgrads))
    assert sorted(pgrads) == sorted(jflat)
    for k in jflat:
        _close_rel(_np(pgrads[k]), jflat[k])

    # the optimizer step from the same gradients (the reference's): where
    # |g| is near eps the step is lr * g / (|g| + eps), so gradients that
    # differ by their summation order would differ there by up to lr
    ocfg = ropt.AdamWConfig(lr=1e-2, warmup_steps=0, schedule="constant")
    pocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=0, schedule="constant")
    jstate = ropt.init_state(jp)
    pstate = adamw_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jnew, jst, jm = ropt.apply_updates(jp, jgrads, jstate, ocfg)
    pnew, pst, pm = opt.apply_updates(
        pp, params_from_numpy(jax.tree.map(np.asarray, jgrads), pcfg,
                              "cpu"), pstate, pocfg)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert float(jm["grad_norm"]) > ocfg.grad_clip        # clipping binds
    assert int(pst["step"]) == int(jst["step"]) == 1
    for tree_p, tree_j in ((pnew, jnew), (pst["m"], jst["m"]),
                           (pst["v"], jst["v"])):
        jf = tr.to_dict(jax.tree.map(np.asarray, tree_j))
        for k, v in tr.to_dict(tree_p).items():
            _close_rel(_np(v), jf[k], 1e-6)


def test_named_parameters_map_to_reference_keys():
    rcfg, pcfg = _configs("qwen2-7b")
    model = tf.TransformerLM(pcfg, params_from_numpy(_np_params(rcfg),
                                                     pcfg, "cpu"))
    names = {n.replace(".", "/") for n, _ in model.named_parameters()}
    ref = set(tr.to_dict(rtf.init_params(rcfg, jax.random.key(0))))
    assert names == ref
    for n, p in model.named_parameters():
        assert p.shape == tr.to_dict(model.params)[n.replace(".", "/")].shape
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, pcfg.vocab, (B, T)).astype(np.int32))
    with torch.no_grad():
        assert torch.equal(model(tokens),
                           tf.forward(model.params, tokens, pcfg))


# -------------------------------------------------------- the other paths
def test_flash_attention_matches_reference():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    want = rtf._flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), kv_chunk=16)
    got = tf._flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), kv_chunk=16)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    dense = tf._attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(_np(got), _np(dense), **F32)


@pytest.mark.parametrize("variant", [
    dict(flash_attention=True, kv_chunk=4),
    dict(chunked_loss=True, loss_chunk=4),
    dict(flash_attention=True, kv_chunk=8, chunked_loss=True, loss_chunk=8),
], ids=["flash", "chunked_ce", "both"])
def test_flash_and_chunked_loss_match_reference(variant):
    """The chunked variants' loss and gradients (each chunk recomputed in
    the backward inside the recomputed layer) against the reference's."""
    rcfg, pcfg = _configs("qwen2-7b", **variant)
    jp, pp = _both(rcfg, pcfg, _np_params(rcfg, 3))
    jb, pb = _batch(rcfg.vocab, seed=4, mask=True)
    jloss, jgrads = jax.value_and_grad(rtf.loss_fn)(jp, jb, rcfg)
    ploss = tf.loss_fn(pp, pb, pcfg)
    np.testing.assert_allclose(ploss.item(), float(jloss), **F32)
    jflat = tr.to_dict(jax.tree.map(np.asarray, jgrads))
    for k, g in zip(tr.to_dict(pp), torch.autograd.grad(
            ploss, tr.leaves(pp))):
        _close_rel(_np(g), jflat[k])
    # and the dense loss of the same weights
    dense = dataclasses.replace(pcfg, flash_attention=False,
                                chunked_loss=False)
    with torch.no_grad():
        np.testing.assert_allclose(float(tf.loss_fn(pp, pb, dense)),
                                   float(ploss), **F32)


def test_decode_step_matches_reference():
    """Logits, caches and length of decode steps (a 3-token prefill into
    the cache, then single tokens) against the reference's decode_step,
    and against forward's logits at the same positions."""
    rcfg, pcfg = _configs("qwen2-7b")
    jp, pp = _both(rcfg, pcfg, _np_params(rcfg, 5))
    jb, pb = _batch(rcfg.vocab, seed=6, t=8)
    jcache = rtf.init_cache(rcfg, B, 12)
    pcache = tf.init_cache(pcfg, B, 12, "cpu")
    outs = []
    with torch.no_grad():
        for a, b in ((0, 3), (3, 4), (4, 5), (5, 8)):
            jl, jcache = rtf.decode_step(jp, jcache, jb["tokens"][:, a:b],
                                         rcfg)
            pl, pcache = tf.decode_step(pp, pcache, pb["tokens"][:, a:b],
                                        pcfg)
            np.testing.assert_allclose(_np(pl), np.asarray(jl), **F32)
            for key in ("k", "v"):
                np.testing.assert_allclose(_np(pcache[key]),
                                           np.asarray(jcache[key]), **F32)
            assert int(pcache["length"]) == int(jcache["length"]) == b
            outs.append(pl)
        full = tf.forward(pp, pb["tokens"], pcfg)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch_id", ["deepseek-moe-16b", "grok-1-314b"])
def test_moe_ffn_drops_tokens_as_reference(arch_id):
    """Smoke MoE: T = 16, k = 2, e = 4, so cap = 10 and routing skew
    drops choices; the port drops the same ones (same output)."""
    rcfg, pcfg = _configs(arch_id)
    np_tree = _np_params(rcfg, 7)
    # a skewed router: with x of mean 0.5, expert 0 is every token's choice
    np_tree["layers"]["router"][..., 0] += 0.5
    jp, pp = _both(rcfg, pcfg, np_tree)
    x = (np.random.default_rng(8).standard_normal((B, T, rcfg.d_model))
         + 0.5).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    pl = tf.split_layers(pp["layers"])[0]
    want = rtf.moe_ffn(jnp.asarray(x), jl, rcfg)
    with torch.no_grad():
        got = tf.moe_ffn(torch.from_numpy(x), pl, pcfg)
        logits = (torch.from_numpy(x) @ pl["router"]).float()
        sel = torch.topk(logits, pcfg.top_k, dim=-1).indices
        cap = math.ceil(T * pcfg.top_k / pcfg.n_experts
                        * pcfg.capacity_factor)
        _, _, keep, _ = tf.moe_dispatch(sel, pcfg.n_experts, cap)
    assert cap == 10
    # the drops are each expert's choices past its first cap (stable order)
    per_expert = np.stack([np.bincount(s, minlength=pcfg.n_experts)
                           for s in sel.reshape(B, -1).numpy()])
    assert int((~keep).sum()) == int(np.maximum(per_expert - cap, 0).sum()) > 0
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_bf16_forward_close_to_reference():
    rcfg, pcfg = _configs("qwen1.5-4b", dtype="bf16")
    jp, pp = _both(rcfg, pcfg, _np_params(rcfg, 9))
    jb, pb = _batch(rcfg.vocab, seed=10)
    with torch.no_grad():
        got = _np(tf.forward(pp, pb["tokens"], pcfg))
    want = np.asarray(rtf.forward(jp, jb["tokens"], rcfg))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=0.1)


# ------------------------------------------------------------ the configs
def test_init_params_shapes_dtypes_and_inert_entries():
    """The RNG differs by design; shapes, dtypes, ones in the norms, zero
    biases and zero padded heads are the reference's."""
    rcfg, pcfg = _configs("qwen2-7b")
    rcfg, pcfg = rcfg.pad_for_mesh(3), pcfg.pad_for_mesh(3)
    assert (pcfg.hq, pcfg.hkv) == (rcfg.hq, rcfg.hkv) == (6, 3)
    ref = tr.to_dict(jax.tree.map(np.asarray,
                                  rtf.init_params(rcfg, jax.random.key(0))))
    got = tr.to_dict(tf.init_params(pcfg, torch.Generator().manual_seed(0)))
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert tuple(v.shape) == ref[k].shape and v.dtype == torch.float32
        inert = ref[k] == 0
        np.testing.assert_array_equal(v.numpy() == 0, inert)
        if k.endswith(("ln1", "ln2", "final_ln")):
            assert torch.all(v == 1)
    hd = pcfg.head_dim
    assert torch.all(tr.to_dict(got)["layers/wq"][..., 4 * hd:] == 0)
    assert torch.all(tr.to_dict(got)["layers/wk"][..., 2 * hd:] == 0)
    for name in ("bq", "bk", "bv"):
        assert torch.all(got[f"layers/{name}"] == 0)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_config_counts_match_reference(arch_id):
    ref, port = ref_get_config(arch_id), get_config(arch_id)
    assert port.cfg.dtype == torch.bfloat16
    for field in ("n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
                  "head_dim", "qkv_bias", "n_experts", "top_k", "n_shared",
                  "d_ff_expert", "capacity_factor", "remat"):
        assert getattr(port.cfg, field) == getattr(ref.cfg, field), field
    assert port.cfg.n_params() == ref.cfg.n_params()
    assert port.cfg.n_active_params() == ref.cfg.n_active_params()
    for tp in (1, 4, 16):
        assert (port.cfg.pad_for_mesh(tp).hq, port.cfg.pad_for_mesh(tp).hkv) \
            == (ref.cfg.pad_for_mesh(tp).hq, ref.cfg.pad_for_mesh(tp).hkv)
    for shape in port.shapes:
        assert port.model_flops(shape) == ref.model_flops(shape)
    assert port.model_flops(dict(kind="train", seq_len=1024,
                                 global_batch=2)) \
        == 6.0 * port.cfg.n_active_params() * 2048


def test_registry_resolves_every_arch_and_its_units():
    """Every arch of the reference resolves, and builds its dry-run unit
    (``closure_256k``'s on a 1 x 1 mesh over a fake group)."""
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_local_mesh

    assert all_arch_ids()[:5] == list(LM_ARCHS)
    assert all_arch_ids() == ref_arch_ids()
    assert get_config("rig_gm").family == ref_get_config("rig_gm").family
    with fake_group(1):
        unit = get_config("rig_gm").build_dryrun("closure_256k",
                                                 make_local_mesh(1, 1))
    assert unit.name == "rig_gm:closure_256k"
    assert tuple(unit.args[0].shape) == (1 << 18, 1 << 13)
    with pytest.raises(KeyError, match="unknown"):
        get_config("nope")


def test_arch_smoke_runs_on_cpu():
    out = get_config("deepseek-moe-16b").smoke(seed=0, device="cpu")
    assert out["finite"] and out["logits_shape"] == (2, 16, 256)
    assert out["decode_shape"] == (2, 1, 256)
    assert math.log(256) - 1 < out["loss"] < math.log(256) + 2
