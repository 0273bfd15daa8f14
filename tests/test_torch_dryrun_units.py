"""Each family's dry-run unit computes what the reference's computes.

The units' ``step_fn`` run for real, as the dry-run builds them: on 4
spawned gloo ranks on a ``(2, 2)`` ``("data", "model")`` mesh, their
arguments placed by ``launch.dryrun.place`` (each rank its block of the
same numpy arrays: ``DTensor``s, or the rank's tiles for the
explicit-collective units), at smoke width.  The reference's ``step_fn``
(from its own ``build_dryrun``, shapes patched in) runs jitted on one CPU
device from the same arrays:

* LM dense smoke train step (qwen2-7b's smoke config): the loss within
  2e-5 relative; each updated parameter, ``m`` and ``v`` within 1e-6 of
  its largest entry of the reference's ``apply_updates`` fed the
  gradients the unit's step updated with;
* MoE smoke train step (deepseek-moe-16b's smoke config: the routed
  experts run on each rank's batch rows and ``model`` slice of
  ``d_ff_expert``): the same tolerances;
* gin smoke train step: the same tolerances;
* the LM train step with one kv head (qwen2-7b's smoke config, ``n_kv``
  1, which does not divide the ``model`` degree 2: the kv projections
  replicated, each kv head repeated for its group's query heads) and the
  dense one under the ``wsc`` variant (activations' batch pinned to the
  batch axes at each layer boundary): the same tolerances;
* LM prefill and decode units, both kv head counts, the decode cache in
  both of its layouts (split by batch rows, or, for a batch of 1, by the
  sequence): the logits and the updated caches within 2e-5 of their
  largest entry, the cache length exact;
* DIN smoke ``serve``: the logits within 2e-5 of their largest entry;
* DIN retrieval over 65 candidates (uneven shards on the 2 ``data``
  ranks): the scores within 2e-5 of their largest entry;
* ``rig_gm`` serve at n_pad 512 (top-K 512, the reference's
  ``gm_serve_step`` on a 1 x 1 mesh): exact;
* ``rig_gm`` closure at n_pad 512: exact, R' reassembled from the ranks'
  tiles.

One spawn of 4 ranks computes every case; the ranks import neither JAX nor
the reference package.
"""

from __future__ import annotations

import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD, SHAPE = 4, (2, 2)
RANK_TIMEOUT_S = 300
LM_SHAPE = dict(kind="train", seq_len=16, global_batch=4)
GNN_SHAPE = dict(kind="train", n_nodes=512, n_edges=512, d_feat=8)
DIN_SHAPE = dict(kind="serve", batch=8)
SERVE_SHAPE = dict(kind="serve", n_pad=512, batch=2, passes=4, top_k=512)
CLOSURE_SHAPE = dict(kind="closure", n_pad=512)
RETRIEVAL_SHAPE = dict(kind="retrieval", batch=1, n_candidates=65)
# train cases: (the arch and arrays they use, variant)
TRAIN = {"lm": ("lm", "baseline"), "moe": ("moe", "baseline"),
         "gnn": ("gnn", "baseline"), "kv1": ("kv1", "baseline"),
         "wsc": ("lm", "wsc")}
INFER_SHAPES = {
    "prefill": dict(kind="prefill", seq_len=16, global_batch=4),
    "dec_batch": dict(kind="decode", seq_len=32, global_batch=4),
    "dec_seq": dict(kind="decode", seq_len=32, global_batch=1)}
INFER = [(fam, kind) for fam in ("lm", "kv1") for kind in INFER_SHAPES]
DECODE_LENGTH = 5
LOSS_REL, UPDATE_REL, DIN_REL, INFER_REL = 2e-5, 1e-6, 2e-5, 2e-5


def _port_archs():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import DINArch, GNNArch, LMArch
    lm = get_config("qwen2-7b").smoke_config()
    return {"lm": LMArch(lm),
            "kv1": LMArch(dataclasses.replace(lm, n_kv=1)),
            "moe": LMArch(get_config("deepseek-moe-16b").smoke_config()),
            "gnn": GNNArch(get_config("gin-tu").smoke_config()),
            "din": DINArch(get_config("din").smoke_config()),
            "pattern": get_config("rig_gm")}


def _tree_np(prefix, data):
    """The nested dict stored flat under ``prefix/`` in ``data``."""
    out = {}
    for key in data.files if hasattr(data, "files") else data:
        if not key.startswith(prefix + "/"):
            continue
        node, parts = out, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return out


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


# ------------------------------------------------------------ one rank
def _rank(rank, case_file, out_dir, store_file):
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.dryrun import call, place
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.torchgm import frontier
    from repro_torch.torchgm.encoding import QueryTensor
    from repro_torch.train import init_state
    from repro_torch.train import tree as tr

    torch.set_num_threads(1)
    frontier.DEFAULT_DEVICE = "cpu"
    dist.init_process_group("gloo", store=dist.FileStore(store_file, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    data = np.load(case_file)
    out = {}

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t
                ).detach().numpy()

    try:
        mesh = make_local_mesh(*SHAPE)
        archs = _port_archs()
        for case, (fam, variant) in TRAIN.items():
            arch = archs[fam]
            shape = GNN_SHAPE if fam == "gnn" else LM_SHAPE
            unit = arch.build_dryrun(shape, mesh) if variant == "baseline" \
                else arch.build_dryrun(shape, mesh, variant=variant)
            cfg = arch._shape_cfg(shape) if fam == "gnn" \
                else arch._mesh_cfg(mesh)
            params = params_from_numpy(_tree_np(f"{fam}/params", data), cfg,
                                       "cpu")
            batch = {k: torch.from_numpy(v) for k, v in
                     _tree_np(f"{fam}/batch", data).items()}
            p, o, b = place(unit, (params, init_state(params), batch))
            seen = {}
            update = opt_mod.apply_updates

            def recording(params, grads, *a, **kw):
                seen.update(tr.to_dict(grads))      # the step's gradients
                return update(params, grads, *a, **kw)

            opt_mod.apply_updates = recording
            try:
                p, o, loss = call(unit, (p, o, b))
            finally:
                opt_mod.apply_updates = update
            for path, g in seen.items():
                out[f"{case}/grads/{path}"] = full(g)
            out[f"{case}/loss"] = full(loss)
            for name, tree in (("params", p), ("m", o["m"]), ("v", o["v"])):
                for path, leaf in tr.to_dict(tree).items():
                    out[f"{case}/{name}/{path}"] = full(leaf)

        for fam, kind in INFER:
            arch, case = archs[fam], f"{fam}_{kind}"
            unit = arch.build_dryrun(INFER_SHAPES[kind], mesh)
            params = params_from_numpy(_tree_np(f"{fam}/params", data),
                                       arch._mesh_cfg(mesh), "cpu")
            tokens = {"tokens": torch.from_numpy(data[f"{case}/tokens"])}
            if kind == "prefill":
                out[f"{case}/logits"] = full(call(unit, place(
                    unit, (params, tokens))))
                continue
            cache = {k: torch.from_numpy(v) for k, v in
                     _tree_np(f"{case}/cache", data).items()}
            logits, cache = call(unit, place(unit, (params, cache, tokens)))
            out[f"{case}/logits"] = full(logits)
            for k, v in cache.items():
                out[f"{case}/{k}"] = full(v)

        arch = archs["din"]
        unit = arch.build_dryrun(DIN_SHAPE, mesh)
        params = params_from_numpy(_tree_np("din/params", data), arch.cfg,
                                   "cpu")
        batch = {k: torch.from_numpy(v)
                 for k, v in _tree_np("din/batch", data).items()}
        out["din/logits"] = full(call(unit, place(unit, (params, batch))))
        unit = arch.build_dryrun(RETRIEVAL_SHAPE, mesh)
        batch = {k: torch.from_numpy(v)
                 for k, v in _tree_np("retrieval/batch", data).items()}
        out["retrieval/scores"] = full(call(unit, place(unit,
                                                        (params, batch))))

        unit = archs["pattern"].build_dryrun(SERVE_SHAPE, mesh)
        qts = QueryTensor(**{k: torch.from_numpy(v) for k, v in
                             _tree_np("serve/qts", data).items()})
        res = call(unit, place(unit, (
            torch.from_numpy(data["serve/mats"]),
            torch.from_numpy(data["serve/labels"]), qts)))
        for field, value in res._asdict().items():
            out[f"serve/{field}"] = value.numpy()

        unit = archs["pattern"].build_dryrun(CLOSURE_SHAPE, mesh)
        (tile,) = place(unit, (torch.from_numpy(data["closure/r"]),))
        out["closure/tile"] = call(unit, (tile,)).numpy()
        out["coords"] = np.array([mesh.get_local_rank(a)
                                  for a in ("data", "model")])
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


# ------------------------------------------------------------- the parent
def _ref_unit(ref_arch, shape_dict, **kw):
    """The reference's unit for a shape dict, on a (2, 2) abstract mesh."""
    from jax.sharding import AbstractMesh
    ref_arch.shapes = dict(ref_arch.shapes, unit=shape_dict)
    return ref_arch.build_dryrun(
        "unit", AbstractMesh(SHAPE, ("data", "model")), **kw)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The numpy inputs, the ranks' outputs and the reference."""
    jax = pytest.importorskip("jax")
    import dataclasses

    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.configs.base import DINArch, GNNArch, LMArch
    from repro.data import recsys_data
    from repro.data.graphs import random_labeled_graph
    from repro.data.queries import random_query_from_graph
    from repro.jaxgm import encode_batch, from_host
    from repro.train import optimizer as ref_opt

    arrays, ref = {}, {}
    rng = np.random.default_rng(0)
    # --- LM and gin: the reference's params (float32) and a batch
    ref_lm = ref_config("qwen2-7b").smoke_config()
    ref_archs = {"lm": LMArch(ref_lm),
                 "kv1": LMArch(dataclasses.replace(ref_lm, n_kv=1)),
                 "moe": LMArch(ref_config("deepseek-moe-16b").smoke_config()),
                 "gnn": GNNArch(ref_config("gin-tu").smoke_config()),
                 "din": DINArch(ref_config("din").smoke_config())}
    mesh22 = type("M", (), {"shape": {"model": SHAPE[1]}})()
    lm_cfg = ref_archs["lm"]._mesh_cfg(mesh22)
    moe_cfg = ref_archs["moe"]._mesh_cfg(mesh22)
    kv1_cfg = ref_archs["kv1"]._mesh_cfg(mesh22)
    assert kv1_cfg.hkv == 1
    gnn_cfg = dataclasses.replace(ref_archs["gnn"].cfg, d_feat=8)
    from repro.models import gnn as ref_gnn
    from repro.models import recsys as ref_din
    from repro.models import transformer as ref_tf
    params = {
        "lm": ref_tf.init_params(lm_cfg, jax.random.key(1)),
        "moe": ref_tf.init_params(moe_cfg, jax.random.key(4)),
        "kv1": ref_tf.init_params(kv1_cfg, jax.random.key(5)),
        "gnn": ref_gnn.init_params(gnn_cfg, jax.random.key(2)),
        "din": ref_din.init_params(ref_archs["din"].cfg, jax.random.key(3))}
    t, b = LM_SHAPE["seq_len"], LM_SHAPE["global_batch"]
    batches = {
        "lm": {k: rng.integers(0, lm_cfg.vocab, (b, t)).astype(np.int32)
               for k in ("tokens", "labels")},
        "moe": {k: rng.integers(0, moe_cfg.vocab, (b, t)).astype(np.int32)
                for k in ("tokens", "labels")},
        "kv1": {k: rng.integers(0, kv1_cfg.vocab, (b, t)).astype(np.int32)
                for k in ("tokens", "labels")},
        "gnn": {"node_feat": rng.standard_normal((512, 8), np.float32),
                "edge_src": rng.integers(0, 512, 512).astype(np.int32),
                "edge_dst": rng.integers(0, 512, 512).astype(np.int32),
                "labels": rng.integers(0, 4, 512).astype(np.int32),
                "node_mask": np.arange(512) < 400,
                "train_mask": rng.random(512) < 0.5},
        "din": {k: v for k, v in recsys_data.din_batch(
            DIN_SHAPE["batch"], ref_archs["din"].cfg.seq_len,
            ref_archs["din"].cfg.n_items, ref_archs["din"].cfg.n_cates,
            ref_archs["din"].cfg.n_user_feats,
            ref_archs["din"].cfg.user_feat_vocab, seed=4).items()
            if k != "label"}}
    for fam in ("lm", "moe", "gnn", "kv1", "din"):
        _flat(f"{fam}/params", jax.tree.map(lambda a: np.asarray(
            a, np.float32), params[fam]), arrays)
        _flat(f"{fam}/batch", batches[fam], arrays)
        shape = {"gnn": GNN_SHAPE, "din": DIN_SHAPE}.get(fam, LM_SHAPE)
        unit = _ref_unit(ref_archs[fam], shape)
        jb = {k: jnp.asarray(v) for k, v in batches[fam].items()}
        if fam == "din":
            ref["din/logits"] = np.asarray(jax.jit(unit.step_fn)(
                params[fam], jb))
            continue
        opt = ref_opt.init_state(params[fam])
        _, _, loss = jax.jit(unit.step_fn)(params[fam], opt, jb)
        ref[f"{fam}/loss"] = np.asarray(loss)
        ref[f"{fam}/state"] = (params[fam], opt)

    # --- LM prefill and decode: tokens, a cache filled to DECODE_LENGTH
    for fam, kind in INFER:
        sp, case = INFER_SHAPES[kind], f"{fam}_{kind}"
        cfg = {"lm": lm_cfg, "kv1": kv1_cfg}[fam]
        b = sp["global_batch"]
        unit = jax.jit(_ref_unit(ref_archs[fam], sp).step_fn)
        tokens = rng.integers(0, cfg.vocab, (b, sp["seq_len"] if kind ==
                                             "prefill" else 1)
                              ).astype(np.int32)
        arrays[f"{case}/tokens"] = tokens
        if kind == "prefill":
            ref[f"{case}/logits"] = np.asarray(unit(
                params[fam], {"tokens": jnp.asarray(tokens)}))
            continue
        kv = (cfg.n_layers, b, sp["seq_len"], cfg.hkv, cfg.head_dim)
        cache = {"k": rng.standard_normal(kv, np.float32),
                 "v": rng.standard_normal(kv, np.float32),
                 "length": np.int32(DECODE_LENGTH)}
        _flat(f"{case}/cache", cache, arrays)
        logits, new = unit(params[fam],
                           {k: jnp.asarray(v) for k, v in cache.items()},
                           {"tokens": jnp.asarray(tokens)})
        ref[f"{case}/logits"] = np.asarray(logits)
        for k, v in new.items():
            ref[f"{case}/{k}"] = np.asarray(v)

    # --- DIN retrieval: one user, 65 candidates
    dc = ref_archs["din"].cfg
    rb = recsys_data.retrieval_batch(
        dc.seq_len, dc.n_items, dc.n_cates, dc.n_user_feats,
        dc.user_feat_vocab, n_candidates=RETRIEVAL_SHAPE["n_candidates"],
        seed=6)
    _flat("retrieval/batch", rb, arrays)
    ref["retrieval/scores"] = np.asarray(jax.jit(_ref_unit(
        ref_archs["din"], RETRIEVAL_SHAPE).step_fn)(
            params["din"], {k: jnp.asarray(v) for k, v in rb.items()}))

    # --- rig_gm: a graph of n_pad 512, two queries, the packed R
    g = random_labeled_graph(480, avg_degree=2.5, n_labels=4, seed=5)
    dg = from_host(g, block=512)
    mats = np.stack([np.asarray(m) for m in (dg.adj, dg.reach, dg.adj_t,
                                             dg.reach_t)])
    arrays["serve/mats"] = mats.view(np.int32)
    arrays["serve/labels"] = np.asarray(dg.labels, np.int32)
    from repro.configs.pattern import MAX_E, MAX_Q
    qs = [random_query_from_graph(g, 4, qtype=q, seed=s)
          for q, s in (("H", 6), ("D", 7))]
    qts = encode_batch(qs, MAX_Q, MAX_E)
    for f in ("labels", "edge_src", "edge_dst", "edge_kind", "n_nodes",
              "n_edges"):
        arrays[f"serve/qts/{f}"] = np.asarray(getattr(qts, f), np.int32)
    from jax.sharding import Mesh
    from repro.jaxgm import distributed as ref_dist
    mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    res = jax.jit(lambda m, lab, q: ref_dist.gm_serve_step(
        m, lab, q, mesh1, n_passes=SERVE_SHAPE["passes"],
        top_k=SERVE_SHAPE["top_k"]))(jnp.asarray(mats),
                                      jnp.asarray(dg.labels), qts)
    for field, value in res._asdict().items():
        ref[f"serve/{field}"] = np.asarray(value)
    arrays["closure/r"] = np.asarray(dg.adj).view(np.int32)
    unit = _ref_unit(ref_config("rig_gm"), CLOSURE_SHAPE)
    ref["closure/r"] = np.asarray(jax.jit(unit.step_fn)(
        jnp.asarray(dg.adj))).view(np.int32)

    tmp = tmp_path_factory.mktemp("units")
    case_file = tmp / "cases.npz"
    np.savez(case_file, **arrays)
    ctx = mp.start_processes(_rank, args=(str(case_file), str(tmp),
                                          str(tmp / "store")),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD} ranks did not finish in {RANK_TIMEOUT_S} s")
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, ref


def _close(got, want, rel, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("case", list(TRAIN))
def test_train_unit_matches_reference(cases, case):
    import jax
    import jax.numpy as jnp

    from repro.configs.base import OPT
    from repro.train import optimizer as ref_opt
    ranks, ref = cases
    # a variant computes what its arch's baseline does
    fam, got = TRAIN[case][0], {k.replace(f"{case}/", f"{TRAIN[case][0]}/",
                                          1): v
                                for k, v in ranks[0].items()
                                if k.startswith(f"{case}/")}
    _close(got[f"{fam}/loss"], ref[f"{fam}/loss"], LOSS_REL, "loss")
    params, opt = ref[f"{fam}/state"]
    grads = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(got[f"{fam}/grads/" + "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path)]),
        params)
    new, state, _ = ref_opt.apply_updates(params, grads, opt, OPT)
    for name, tree in (("params", new), ("m", state["m"]),
                       ("v", state["v"])):
        for path, want in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            _close(got[f"{fam}/{name}/{key}"], want, UPDATE_REL,
                   f"{fam} {name} {key}")
    for r in ranks[1:]:           # every rank holds the same whole values
        np.testing.assert_array_equal(r[f"{case}/loss"], got[f"{fam}/loss"])


@pytest.mark.parametrize("fam,kind", INFER)
def test_inference_unit_matches_reference(cases, fam, kind):
    ranks, ref = cases
    case = f"{fam}_{kind}"
    keys = ["logits"] if kind == "prefill" else ["logits", "k", "v"]
    for r in ranks:
        for key in keys:
            got, want = r[f"{case}/{key}"], ref[f"{case}/{key}"]
            assert got.shape == want.shape, (case, key)
            _close(got, want, INFER_REL, f"{case} {key}")
        if kind != "prefill":
            assert int(r[f"{case}/length"]) == int(ref[f"{case}/length"]) \
                == DECODE_LENGTH + 1


def test_din_serve_unit_matches_reference(cases):
    ranks, ref = cases
    assert ranks[0]["din/logits"].shape == ref["din/logits"].shape
    _close(ranks[0]["din/logits"], ref["din/logits"], DIN_REL, "logits")


def test_din_retrieval_unit_matches_reference(cases):
    ranks, ref = cases
    for r in ranks:
        assert r["retrieval/scores"].shape == ref["retrieval/scores"].shape
        _close(r["retrieval/scores"], ref["retrieval/scores"], DIN_REL,
               "scores")


def test_rig_gm_serve_unit_matches_reference(cases):
    ranks, ref = cases
    for r in ranks:
        for field in ("fb_sizes", "edge_counts", "candidates"):
            np.testing.assert_array_equal(r[f"serve/{field}"],
                                          ref[f"serve/{field}"])


def test_rig_gm_closure_unit_matches_reference(cases):
    ranks, ref = cases
    want = ref["closure/r"]
    rows, cols = want.shape[0] // SHAPE[0], want.shape[1] // SHAPE[1]
    got = np.zeros_like(want)
    for r in ranks:
        d, m = r["coords"]
        got[d * rows:(d + 1) * rows, m * cols:(m + 1) * cols] = \
            r["closure/tile"]
    np.testing.assert_array_equal(got, want)
