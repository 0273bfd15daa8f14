"""The port's training runtime (``repro_torch.train``, ``data.tokens``,
``launch.train``) against the JAX package's, on the CPU.

JAX is imported inside the ``ref`` fixture only: the compression group
test spawns gloo ranks, and spawn re-imports this file in each.
Tolerances: the optimizer to 1e-6 of each leaf's largest entry (float32,
same inputs; the port fuses nothing but rounds ``m`` and ``v`` in place),
bfloat16 leaves to one bf16 step (2^-7 relative); int8 payloads, scales,
dequantized gradients, checkpoints and the trainer's resume exactly.
"""

import contextlib
import io
import json
import os
import time
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import (TokenPipeline,  # noqa: E402
                                     TokenPipelineConfig)
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.torchgm import frontier  # noqa: E402
from repro_torch.train import (AdamWConfig, Checkpointer,  # noqa: E402
                               ElasticConfig, ElasticTrainer,
                               SimulatedFailure, compression_ratio,
                               make_int8_compressor)
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import tree as tr  # noqa: E402

RANK_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.data import tokens
    from repro.train import checkpoint, compression, optimizer
    return SimpleNamespace(jax=jax, jnp=jnp, opt=optimizer, comp=compression,
                           Checkpointer=checkpoint.Checkpointer,
                           tokens=tokens)


def _close_rel(got, want, rel=1e-6):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * scale)


def _np_tree(seed=0):
    """Stacked-layer shapes: norms (L, d), biases (L, h), a matrix leaf,
    a vector leaf and a bfloat16 leaf (stored as float32 here)."""
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((20, 8)).astype(np.float32),
            "final_ln": (1 + 0.1 * rng.standard_normal(8)).astype(np.float32),
            "layers": {"ln1": (1 + 0.1 * rng.standard_normal((3, 8))
                               ).astype(np.float32),
                       "bq": rng.standard_normal((3, 12)).astype(np.float32),
                       "wq": rng.standard_normal((3, 8, 12)
                                                 ).astype(np.float32)},
            "wb": rng.standard_normal((3, 4, 4)).astype(np.float32)}


BF16 = ("wb",)


def _to_ref(ref, tree):
    return {k: (_to_ref(ref, v) if isinstance(v, dict) else
                ref.jnp.asarray(v, ref.jnp.bfloat16 if k in BF16
                                else ref.jnp.float32))
            for k, v in tree.items()}


def _to_port(tree):
    return {k: (_to_port(v) if isinstance(v, dict) else
                torch.from_numpy(v.copy()).to(torch.bfloat16 if k in BF16
                                              else torch.float32))
            for k, v in tree.items()}


def _flat_np(ref, tree):
    if isinstance(next(iter(tr.leaves(tree))), torch.Tensor):
        return {k: v.detach().float().numpy()
                for k, v in tr.to_dict(tree).items()}
    return {k: np.asarray(v, np.float32) for k, v in
            tr.to_dict(ref.jax.tree.map(np.asarray, tree)).items()}


def _assert_trees(ref, got, want, rel=1e-6):
    g, w = _flat_np(ref, got), _flat_np(ref, want)
    assert sorted(g) == sorted(w)
    for k in w:
        _close_rel(g[k], w[k], 2 ** -7 if k.split("/")[-1] in BF16 else rel)


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("cfg", [dict(vocab=256, batch=4, seq_len=32, seed=3),
                                 dict(vocab=151936, batch=2, seq_len=64,
                                      seed=0, motif_prob=1.0)],
                         ids=["smoke", "qwen1.5-vocab"])
def test_token_pipeline_byte_equal(ref, cfg):
    want = ref.tokens.TokenPipeline(ref.tokens.TokenPipelineConfig(**cfg))
    got = TokenPipeline(TokenPipelineConfig(**cfg))
    for step in (0, 1, 7):
        a, b = got.batch_at(step), want.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_three_steps_with_clipping_match_reference(ref, schedule):
    kw = dict(lr=0.05, warmup_steps=2, total_steps=6, weight_decay=0.1,
              grad_clip=1.0, schedule=schedule)
    rcfg, pcfg = ref.opt.AdamWConfig(**kw), AdamWConfig(**kw)
    tree = _np_tree()
    jp, pp = _to_ref(ref, tree), _to_port(tree)
    jst, pst = ref.opt.init_state(jp), opt.init_state(pp)
    rng = np.random.default_rng(1)
    for step in range(1, 4):
        grads = ref.jax.tree.map(
            lambda a: (3 * rng.standard_normal(a.shape)).astype(np.float32),
            tree)
        jp, jst, jm = ref.opt.apply_updates(jp, _to_ref(ref, grads), jst,
                                            rcfg)
        pp, pst, pm = opt.apply_updates(pp, _to_port(grads), pst, pcfg)
        assert float(jm["grad_norm"]) > 1.0               # clipping binds
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(pst["step"]) == int(jst["step"]) == step
        assert pst["step"].dtype == torch.int32
        _assert_trees(ref, pp, jp)
        _assert_trees(ref, pst["m"], jst["m"])
        _assert_trees(ref, pst["v"], jst["v"])
    assert pp["wb"].dtype == torch.bfloat16


def test_decay_mask_covers_stacked_norms_and_biases(ref):
    """Rank >= 2 of the whole leaf: the stacked norms (L, d) and biases
    (L, h) decay, the final norm (d,) does not — the reference's rule.  A
    rule on the per-layer rank would leave ln1 and bq alone."""
    cfg = dict(lr=0.1, warmup_steps=0, weight_decay=0.5, grad_clip=0.0,
               schedule="constant")
    tree = _np_tree(2)
    zeros = ref.jax.tree.map(np.zeros_like, tree)
    jp, _, _ = ref.opt.apply_updates(_to_ref(ref, tree), _to_ref(ref, zeros),
                                     ref.opt.init_state(_to_ref(ref, tree)),
                                     ref.opt.AdamWConfig(**cfg))
    pp = _to_port(tree)
    pp, _, _ = opt.apply_updates(pp, _to_port(zeros), opt.init_state(pp),
                                 AdamWConfig(**cfg))
    _assert_trees(ref, pp, jp)
    got = _flat_np(ref, pp)
    for k in ("layers/ln1", "layers/bq", "layers/wq", "embed"):
        np.testing.assert_allclose(got[k], tr.to_dict(tree)[k] * (1 - 0.05),
                                   rtol=1e-6)
    np.testing.assert_array_equal(got["final_ln"], tree["final_ln"])


def test_in_place_slices_equal_one_slice(monkeypatch):
    cfg = AdamWConfig(lr=0.05, warmup_steps=0)
    grads = _to_port(_np_tree(4))
    outs = []
    for elems in (1 << 24, 5):
        monkeypatch.setattr(opt, "SLICE_ELEMS", elems)
        pp = _to_port(_np_tree(3))
        st = opt.init_state(pp)
        for _ in range(2):
            pp, st, _ = opt.apply_updates(pp, grads, st, cfg)
        outs.append((pp, st))
    for a, b in zip(tr.leaves(outs[0]), tr.leaves(outs[1])):
        assert torch.equal(a, b)


def test_schedule_lr_matches_reference(ref):
    for schedule in ("cosine", "linear", "constant"):
        kw = dict(lr=0.3, warmup_steps=4, total_steps=12, schedule=schedule)
        for step in range(0, 15):
            np.testing.assert_allclose(
                float(opt.schedule_lr(AdamWConfig(**kw),
                                      torch.tensor(step, dtype=torch.int32))),
                float(ref.opt.schedule_lr(ref.opt.AdamWConfig(**kw),
                                          ref.jnp.asarray(step))),
                rtol=1e-6)


# ---------------------------------------------------------- compression
def _grads(seed, shapes=((300,), (7, 50), (2, 256), (3,))):
    rng = np.random.default_rng(seed)
    out = {f"g{i}": (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 3)
                     ).astype(np.float32) for i, s in enumerate(shapes)}
    out["g1"][2] = 0.0                                  # a zero row
    out["g2"][0, :] = 0.0                               # an all-zero block
    out["g0"][5] = 1e4                                  # an outlier
    return out


def test_int8_payload_and_scales_exact(ref):
    for name, g in _grads(0).items():
        rq, rs = ref.comp._quantize(ref.jnp.asarray(g))
        pq, ps = comp._quantize(torch.from_numpy(g))
        assert pq.dtype == torch.int8
        np.testing.assert_array_equal(pq.numpy(), np.asarray(rq), name)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs), name)
    # round half to even: 0.5 and 2.5 go down, 1.5 up (blocks scaled to 127)
    x = np.zeros(256, np.float32)
    x[:4] = [127.0, 0.5, 1.5, 2.5]
    np.testing.assert_array_equal(
        comp._quantize(torch.from_numpy(x))[0][0, :4].numpy(), [127, 0, 2, 2])


def test_error_feedback_matches_reference(ref):
    rc, pc = ref.comp.make_int8_compressor(), make_int8_compressor()
    jerr, perr = None, None
    for step in range(4):
        g = _grads(10 + step)
        jout, jerr = rc({k: ref.jnp.asarray(v) for k, v in g.items()}, jerr)
        pout, perr = pc({k: torch.from_numpy(v) for k, v in g.items()}, perr)
        for k in g:
            np.testing.assert_array_equal(pout[k].numpy(),
                                          np.asarray(jout[k]))
            np.testing.assert_array_equal(perr[k].numpy(),
                                          np.asarray(jerr[k]))
    assert compression_ratio(_to_port(_np_tree())) == \
        ref.comp.compression_ratio(_to_ref(ref, _np_tree()))


def _compress_rank(rank, world, store_file, out_dir):
    """One spawned rank: its own gradients through the compressor on the
    world group (gloo), with an error state carried over two steps."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        compress = make_int8_compressor(group=dist.group.WORLD)
        err, outs = None, {}
        for step in range(2):
            g = {k: torch.from_numpy(v)
                 for k, v in _grads(100 * step + rank).items()}
            out, err = compress(g, err)
            outs |= {f"{step}/out/{k}": v.numpy() for k, v in out.items()}
            outs |= {f"{step}/err/{k}": v.numpy() for k, v in err.items()}
        np.savez(Path(out_dir) / f"rank{rank}.npz", **outs)
    finally:
        dist.destroy_process_group()


def _np_quantize(x, block=256):
    """The reference's block quantizer, in numpy."""
    flat = x.reshape(-1).astype(np.float32)
    flat = np.pad(flat, (0, (-flat.size) % block)).reshape(-1, block)
    scale = np.abs(flat).max(1, keepdims=True) / np.float32(127.0)
    q = np.clip(np.round(flat / np.maximum(scale, np.float32(1e-12))),
                -127, 127)
    return q.astype(np.int8), scale.astype(np.float32)


def test_group_compression_on_two_gloo_ranks(tmp_path):
    """Each rank dequantizes the summed payload with its own scales
    (``compression.py:60-66`` of the reference), held to that formula in
    numpy over two steps of error feedback."""
    world = 2
    ctx = mp.start_processes(_compress_rank, args=(
        world, str(tmp_path / "store"), str(tmp_path)), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("gloo ranks did not finish")
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    err = [{k: np.zeros_like(v) for k, v in _grads(0).items()}
           for _ in range(world)]
    for step in range(2):
        targets = [{k: v + err[r][k] for k, v in _grads(100 * step + r).items()}
                   for r in range(world)]
        for k in targets[0]:
            qs = [_np_quantize(t[k]) for t in targets]
            total = sum(q.astype(np.int32) for q, _ in qs)
            for r in range(world):
                n = targets[r][k].size
                deq = ((total.astype(np.float32) / np.float32(world))
                       * qs[r][1]).reshape(-1)[:n].reshape(targets[r][k].shape)
                np.testing.assert_array_equal(got[r][f"{step}/out/{k}"], deq)
                want_err = targets[r][k] - deq
                np.testing.assert_array_equal(got[r][f"{step}/err/{k}"],
                                              want_err)
                err[r][k] = want_err


# ----------------------------------------------------------- checkpoints
def _ckpt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"layers": {"wq": rng.standard_normal((2, 4, 6))
                                  .astype(np.float32)},
                       "embed": rng.standard_normal((5, 4))
                       .astype(np.float32)},
            "opt": {"step": np.array(7, np.int32),
                    "m": {"w": rng.standard_normal(3).astype(np.float32)}}}


def _typed(tree, to):
    """bf16 for params/embed, int32 for the step, float32 elsewhere."""
    def leaf(path, a):
        kind = ("bf16" if path == "params/embed" else
                "i32" if path == "opt/step" else "f32")
        return to(a, kind)
    flat = [leaf(p, a) for p, a in tr.flatten_with_paths(tree)]
    return tr.unflatten_like(tree, flat)


def test_checkpoints_cross_packages(ref, tmp_path):
    """The reference restores what the port wrote and the port what the
    reference wrote: same keys, bf16 widened on disk and cast back."""
    jdt = {"bf16": ref.jnp.bfloat16, "i32": ref.jnp.int32,
           "f32": ref.jnp.float32}
    tdt = {"bf16": torch.bfloat16, "i32": torch.int32, "f32": torch.float32}
    tree = _ckpt_tree(0)
    jtree = _typed(tree, lambda a, k: ref.jnp.asarray(a, jdt[k]))
    ttree = _typed(tree, lambda a, k: torch.from_numpy(a).to(tdt[k]))
    ttree["params"]["embed"].requires_grad_(True)

    ref.Checkpointer(str(tmp_path / "j")).save(3, jtree, extra={"by": "jax"})
    Checkpointer(str(tmp_path / "t")).save(3, ttree, extra={"by": "torch"})
    metas = [json.loads((tmp_path / d / "step_0000000003" / "meta.json")
                        .read_text()) for d in ("j", "t")]
    assert metas[0]["keys"] == metas[1]["keys"] == sorted(
        ["params/embed", "params/layers/wq", "opt/step", "opt/m/w"])

    got, meta = Checkpointer(str(tmp_path / "j")).restore(ttree)
    assert meta["extra"] == {"by": "jax"}
    for (k, a), b in zip(tr.flatten_with_paths(got), tr.leaves(ttree)):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b.detach()), k
    assert got["params"]["embed"].requires_grad

    back, _ = ref.Checkpointer(str(tmp_path / "t")).restore(jtree)
    for a, b in zip(ref.jax.tree.leaves(back), ref.jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_checkpoint_retention_async_and_errors(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = _typed(_ckpt_tree(1), lambda a, k: torch.from_numpy(a))
    for s in (1, 2, 3):
        ck.save_async(s, t)
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    ck.save(3, t)                                       # same-step overwrite
    assert ck.all_steps() == [2, 3]
    bad = {"params": {"embed": torch.zeros(2, 2)}}
    with pytest.raises(KeyError, match="missing"):
        ck.restore({"nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(bad)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(t)


# -------------------------------------------------------------- trainer
def _trainer(ckpt_dir, arch="qwen2-7b"):
    """The launcher's trainer at smoke size (batch 2, T 16) on the CPU."""
    args = SimpleNamespace(scale="smoke", batch=2, seq_len=16, seed=0)
    cfg, init, loss, batch_fn = launch.build_lm(get_config(arch), args,
                                                torch.device("cpu"))
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=6)

    def init_state():
        p = init()
        return {"params": p, "opt": opt.init_state(p)}

    return ElasticTrainer(
        step_fn=launch.make_step(loss, ocfg), make_batch=batch_fn,
        init_state=init_state,
        cfg=ElasticConfig(checkpoint_dir=str(ckpt_dir), checkpoint_every=2),
        get_step=lambda s: int(s["opt"]["step"]))


def test_elastic_crash_and_resume_equals_uninterrupted(tmp_path):
    whole = _trainer(tmp_path / "whole")
    whole.start_or_resume()
    out = whole.run(6)
    assert out["final_step"] == 6 and len(out["metrics"]) == 6

    first = _trainer(tmp_path / "crash")
    first.start_or_resume()
    with pytest.raises(SimulatedFailure) as e:
        first.run(6, fail_at=3)
    assert e.value.step == 3
    second = _trainer(tmp_path / "crash")
    assert second.start_or_resume() == {"resumed": True, "step": 2}
    rest = second.run(6)
    assert rest["final_step"] == 6 and len(rest["metrics"]) == 4
    for a, b in zip(tr.leaves(second.state), tr.leaves(whole.state)):
        assert torch.equal(a, b)
    assert rest["metrics"][-1]["loss"] == out["metrics"][-1]["loss"]


# ----------------------------------------------------------- entry point
def _main(argv, monkeypatch):
    monkeypatch.setattr(frontier, "DEFAULT_DEVICE", None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch.main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("extra", [[], ["--compress-grads"]],
                         ids=["plain", "compress"])
def test_launch_train_runs_on_cpu(tmp_path, monkeypatch, extra):
    out = _main(["--arch", "qwen2-7b", "--device", "cpu", "--steps", "3",
                 "--batch", "2", "--seq-len", "16",
                 "--ckpt-dir", str(tmp_path)] + extra, monkeypatch)
    assert "device=cpu" in out and "done: step=3" in out, out
    assert Checkpointer(str(tmp_path)).latest_step() == 3
    # again: resumes at the last step and has nothing left to run
    out = _main(["--arch", "qwen2-7b", "--device", "cpu", "--steps", "3",
                 "--ckpt-dir", str(tmp_path)] + extra, monkeypatch)
    assert "resumed=True from step 3" in out and "no step left" in out


def test_launch_train_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(["--steps", "1", "--ckpt-dir", str(tmp_path)], monkeypatch)
    assert not os.listdir(tmp_path)
    with pytest.raises(KeyError, match="'pattern'"):
        _main(["--arch", "rig_gm", "--device", "cpu", "--ckpt-dir",
               str(tmp_path)], monkeypatch)
    assert not os.listdir(tmp_path)


def test_launch_train_rig_gm_fails_as_reference(ref, tmp_path, monkeypatch):
    """``rig_gm`` trains nothing: both launchers raise the same
    ``KeyError`` from their family dispatch, before any state exists."""
    from repro.launch import train as ref_launch

    argv = ["--arch", "rig_gm", "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr("sys.argv", ["train"] + argv)
    with pytest.raises(KeyError) as want:
        ref_launch.main()
    with pytest.raises(KeyError) as got:
        _main(argv + ["--device", "cpu"], monkeypatch)
    assert got.value.args == want.value.args == ("pattern",)
    assert not os.listdir(tmp_path)


def test_init_params_device_follows_generator():
    cfg = get_config("deepseek-moe-16b").smoke_config()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(p.device.type == "cpu" for p in tr.leaves(params))
    again = tf.init_params(cfg, torch.Generator().manual_seed(0))
    for a, b in zip(tr.leaves(params), tr.leaves(again)):
        assert torch.equal(a, b)
