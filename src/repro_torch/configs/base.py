"""Architecture config framework: one object per assigned architecture
(the LM, GNN and recsys families).

Every arch exposes:

* ``shapes``         — the assigned (shape_name → params) cells;
* ``smoke_*``        — a REDUCED same-family config + one real forward/train
                       step (tests and ``launch.train --scale smoke``);
* ``model_flops``    — the analytic MODEL_FLOPS (6·N·D dense /
                       6·N_active·D MoE for training; per-family formulas
                       for GNN/recsys).

* ``build_dryrun``   — a :class:`DryRunUnit` for a (shape, mesh): the
                       step function, its arguments as ``meta`` tensors of
                       their global shapes and their placements on the
                       mesh; ``repro_torch.launch.dryrun`` traces it on
                       ``meta`` tensors over a fake process group.

GNN and recsys archs also give ``_abstract_batch(shape)``: the batch a
shape implies, as ``meta`` tensors (shapes and dtypes, no storage).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..dist import sharding as shd
from ..models import gnn as gnn_mod
from ..models import recsys as din_mod
from ..models import transformer as tf_mod
from ..torchgm.frontier import resolve
from ..train import optimizer as opt_mod
from ..train import tree as tr

OPT = opt_mod.AdamWConfig()
Shape = Union[str, Dict[str, Any]]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _shape(shapes, shape) -> Dict[str, Any]:
    return shapes[shape] if isinstance(shape, str) else shape


def _shape_name(shape) -> str:
    return shape if isinstance(shape, str) else "custom"


def _pad512(n: int) -> int:
    """Pad a node/edge count up to a multiple of 512 so the leading dim
    shards evenly on every production mesh (the real loaders pad batches
    the same way; masks neutralize the padding)."""
    return int(-(-n // 512) * 512)


def batch_to(batch: Dict[str, np.ndarray],
             device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``, dtypes kept."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _train_step_finite(loss_fn, params, batch) -> Dict[str, Any]:
    """One ``make_train_step`` step of ``OPT``: its loss, its gradient
    norm and whether both are finite."""
    step = opt_mod.make_train_step(loss_fn, OPT)
    _, _, m = step(params, opt_mod.init_state(params), batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "finite": bool(torch.isfinite(m["loss"]))
            and bool(torch.isfinite(m["grad_norm"]))}


@dataclass
class DryRunUnit:
    """One (arch, shape, mesh) cell of the dry-run.

    ``args`` are the step's arguments as trees (dicts, lists, tuples,
    ``QueryTensor``) of ``meta`` tensors of their **global** shapes and
    dtypes; ``placements`` mirrors them, one tuple of ``DTensor``
    placements on ``mesh`` per leaf.  A runner makes each leaf a tensor
    (``meta`` for a trace, or real) and calls ``step_fn(*args)`` as one
    rank: with ``local`` False each leaf is a ``DTensor`` of those
    placements (the step's collectives are DTensor's redistributions);
    with ``local`` True each leaf is the rank's own block of the global
    tensor, a plain tensor, and the step issues its collectives itself
    (the reference's ``shard_map`` bodies).  ``donate`` records the
    arguments the reference donates; the port's steps update those in
    place (its AdamW), which is what donation buys under XLA."""
    name: str
    step_fn: Callable
    args: Tuple[Any, ...]
    placements: Tuple[Any, ...]
    mesh: Any
    donate: Tuple[int, ...] = ()
    local: bool = False


def _f32_like(tree):
    return tr.map_tree(lambda p: _meta(p.shape, torch.float32), tree)


def _opt_args(params, pspecs, mesh):
    """AdamW state of ``params`` as ``meta`` tensors, and its placements."""
    state = {"step": _meta((), torch.int32), "m": _f32_like(params),
             "v": _f32_like(params)}
    specs = {"step": (), "m": pspecs, "v": pspecs}
    return state, shd.placements_tree(specs, mesh)


def _trainable(params):
    """``params`` with every leaf requiring grad (in place: the arguments
    of a dry-run unit are its own leaves)."""
    return tr.map_tree(lambda p: p if p.requires_grad
                       else p.requires_grad_(), params)


def _train_step(loss_fn):
    """The port's training step on one tree of parameters: one forward
    and backward, then the default AdamW, in place
    (``train.optimizer.make_train_step``) -> (params, state, loss)."""
    step = opt_mod.make_train_step(loss_fn, OPT)

    def train_step(params, opt_state, batch):
        params, opt_state, metrics = step(_trainable(params), opt_state,
                                          batch)
        return params, opt_state, metrics["loss"]

    return train_step


class ArchConfig:
    arch_id: str = ""
    family: str = ""
    shapes: Dict[str, Dict[str, Any]] = {}

    def build_dryrun(self, shape, mesh, **kw) -> DryRunUnit:
        raise NotImplementedError

    def smoke(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Run one reduced forward/train step; return metrics for asserts."""
        raise NotImplementedError

    def model_flops(self, shape) -> float:
        raise NotImplementedError


# ===================================================================== LM ===
LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


class LMArch(ArchConfig):
    family = "lm"
    shapes = LM_SHAPES

    def __init__(self, cfg: tf_mod.LMConfig):
        self.cfg = cfg
        self.arch_id = cfg.name

    # ------------------------------------------------------------ smoke
    def smoke_config(self) -> tf_mod.LMConfig:
        c = self.cfg
        return dataclasses.replace(
            c, n_layers=2, d_model=64, n_heads=4, n_kv=max(1, min(c.n_kv, 2)),
            d_ff=128, vocab=256, d_head=16,
            n_experts=min(c.n_experts, 4), top_k=min(c.top_k, 2),
            n_shared=min(c.n_shared, 1),
            d_ff_expert=64 if c.n_experts else 0,
            dtype=torch.float32, pad_heads_to=0, pad_kv_to=0)

    def smoke(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """One reduced train step and a decode step, on ``device`` (the
        card unless the CPU is asked for)."""
        device = resolve(device)
        cfg = self.smoke_config()
        gen = torch.Generator(device).manual_seed(seed)
        params = tf_mod.TransformerLM(cfg, generator=gen).params
        rng = np.random.default_rng(seed)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)),
                                    dtype=torch.int32, device=device)
                 for k in ("tokens", "labels")}
        with torch.no_grad():
            logits = tf_mod.forward(params, batch["tokens"], cfg)
            cache = tf_mod.init_cache(cfg, 2, 32, device)
            dec_logits, cache = tf_mod.decode_step(
                params, cache, batch["tokens"][:, :1], cfg)
        return {"logits_shape": tuple(logits.shape),
                "decode_shape": tuple(dec_logits.shape),
                **_train_step_finite(
                    lambda p, b: tf_mod.loss_fn(p, b, cfg), params, batch)}

    # ----------------------------------------------------------- dry-run
    def _mesh_cfg(self, mesh) -> tf_mod.LMConfig:
        """The config with its heads padded to a multiple of the mesh's
        ``model`` degree, the kv heads to a divisor of that count."""
        tp = shd.axis_size(mesh, "model")
        c = self.cfg
        hq = int(math.ceil(c.n_heads / tp) * tp)
        hkv = c.n_kv
        if hq % hkv:                     # keep GQA grouping integral
            hkv = next(d for d in range(hkv, hq + 1) if hq % d == 0)
        return dataclasses.replace(c, pad_heads_to=hq, pad_kv_to=hkv)

    def build_dryrun(self, shape: Shape, mesh, *,
                     layers_override: Optional[int] = None,
                     unroll: bool = False,
                     variant: str = "baseline") -> DryRunUnit:
        """``layers_override`` (with ``unroll``, which the port holds and
        ignores) is the reference's cost-calibration mode: units of 2 and
        4 layers, extrapolated to the full depth
        (``launch.dryrun.lm_calibrated_cost``).

        ``variant`` names options as the reference reads them: ``flash``
        (chunked online-softmax attention), ``chunkloss`` (streamed
        lm_head cross-entropy), ``wsc`` (activations' batch pinned to the
        batch axes at each layer boundary); ``ckptchunk`` is the port's
        own flash attention, whose chunks are always recomputed in the
        backward.
        """
        sp = _shape(self.shapes, shape)
        cfg = self._mesh_cfg(mesh)
        if variant.startswith("flash"):
            cfg = dataclasses.replace(cfg, flash_attention=True)
        if "chunkloss" in variant:
            cfg = dataclasses.replace(cfg, chunked_loss=True, loss_chunk=512)
        if "wsc" in variant:
            cfg = dataclasses.replace(
                cfg, shard_activations=shd.batch_axes(mesh))
        if layers_override is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers_override,
                                      unroll=unroll)
        pspecs = shd.lm_param_specs(cfg, mesh)
        # kv projections: shard out-dim only when the padded kv head count
        # divides the TP degree (else replicate — GQA kv is small)
        tp = shd.axis_size(mesh, "model")
        if cfg.hkv % tp:
            pspecs["layers"]["wk"] = (None, "data", None)
            pspecs["layers"]["wv"] = (None, "data", None)
            if cfg.qkv_bias:
                pspecs["layers"]["bk"] = (None, None)
                pspecs["layers"]["bv"] = (None, None)
        params = tf_mod.abstract_params(cfg)
        ppl = shd.placements_tree(pspecs, mesh)
        b = sp["global_batch"]
        name = f"{self.arch_id}:{_shape_name(shape)}"
        i32 = torch.int32

        if sp["kind"] == "train":
            opt, opl = _opt_args(params, pspecs, mesh)
            batch = {"tokens": _meta((b, sp["seq_len"]), i32),
                     "labels": _meta((b, sp["seq_len"]), i32)}
            bpl = shd.placements_tree(shd.lm_batch_specs(mesh), mesh)
            return DryRunUnit(
                name=name,
                step_fn=_train_step(lambda p, bt: tf_mod.loss_fn(p, bt, cfg)),
                args=(params, opt, batch), placements=(ppl, opl, bpl),
                mesh=mesh, donate=(0, 1))

        baxes = shd.batch_axes(mesh)
        if sp["kind"] == "prefill":
            batch = {"tokens": _meta((b, sp["seq_len"]), i32)}
            bpl = {"tokens": shd.placements((baxes, None), mesh)}

            @torch.no_grad()
            def prefill_step(params, batch):
                logits = tf_mod.forward(params, batch["tokens"], cfg)
                return logits[:, -1, :]        # serving returns last-token

            return DryRunUnit(name=name, step_fn=prefill_step,
                              args=(params, batch), placements=(ppl, bpl),
                              mesh=mesh)

        # decode: one new token against a seq_len KV cache
        kv = (cfg.n_layers, b, sp["seq_len"], cfg.hkv, cfg.head_dim)
        cache = {"k": _meta(kv, cfg.dtype), "v": _meta(kv, cfg.dtype),
                 "length": _meta((), i32)}
        n_data = int(np.prod([shd.axis_size(mesh, a) for a in baxes]))
        kv_heads_ax = "model" if cfg.hkv % tp == 0 else None
        by_batch = b % n_data == 0 and b >= n_data
        if by_batch:
            cspec = (None, baxes, None if kv_heads_ax else "model",
                     kv_heads_ax, None)
        else:
            # small-batch long-context: shard the KV sequence axis instead
            cspec = (None, None, baxes + (() if kv_heads_ax else ("model",)),
                     kv_heads_ax, None)
        cpl = {"k": shd.placements(cspec, mesh),
               "v": shd.placements(cspec, mesh),
               "length": shd.placements((), mesh)}
        tokens = {"tokens": _meta((b, 1), i32)}
        tpl = {"tokens": shd.placements((baxes if by_batch else None, None),
                                        mesh)}

        @torch.no_grad()
        def decode(params, cache, batch):
            return tf_mod.decode_step(params, cache, batch["tokens"], cfg)

        return DryRunUnit(name=name, step_fn=decode,
                          args=(params, cache, tokens),
                          placements=(ppl, cpl, tpl), mesh=mesh, donate=(1,))

    def model_flops(self, shape: Union[str, Dict[str, Any]]) -> float:
        """``shape``: a name of ``shapes`` or a dict of the same keys
        (``kind``, ``seq_len``, ``global_batch``)."""
        sp = self.shapes[shape] if isinstance(shape, str) else shape
        n_active = self.cfg.n_active_params()
        if sp["kind"] == "train":
            tokens = sp["seq_len"] * sp["global_batch"]
            return 6.0 * n_active * tokens
        if sp["kind"] == "prefill":
            tokens = sp["seq_len"] * sp["global_batch"]
            return 2.0 * n_active * tokens
        # decode: one token per sequence + attention over the cache
        c = self.cfg
        attn = (2 * 2 * c.n_layers * sp["seq_len"] * c.n_kv * c.head_dim
                * (c.n_heads // c.n_kv))
        return sp["global_batch"] * (2.0 * n_active + attn)


# ==================================================================== GNN ===
GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433),
    "minibatch_lg": dict(kind="train_sampled", n_nodes=232965,
                         n_edges=114615892, batch_nodes=1024,
                         fanout=(15, 10), d_feat=602),
    "ogb_products": dict(kind="train", n_nodes=2449029, n_edges=61859140,
                         d_feat=100),
    "molecule": dict(kind="train_batched", n_nodes=30, n_edges=64, batch=128,
                     d_feat=16),
}


class GNNArch(ArchConfig):
    family = "gnn"
    shapes = GNN_SHAPES

    def __init__(self, cfg: gnn_mod.GNNConfig):
        self.cfg = cfg
        self.arch_id = cfg.name

    def _shape_cfg(self, sp) -> gnn_mod.GNNConfig:
        return dataclasses.replace(self.cfg, d_feat=sp["d_feat"])

    def smoke_config(self) -> gnn_mod.GNNConfig:
        return dataclasses.replace(self.cfg, n_layers=2, d_hidden=16,
                                   d_feat=8, n_rbf=16, n_vars=6, n_classes=4)

    def smoke_batch(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """The reference smoke's numpy batch for this arch."""
        from ..data import gnn_data
        cfg = self.smoke_config()
        if cfg.arch == "schnet":
            return gnn_data.schnet_batch(10, 24, cfg.d_feat, batch=3,
                                         seed=seed)
        if cfg.arch == "graphcast":
            return gnn_data.graphcast_batch(24, 8, cfg.n_vars, 32, 24, 24,
                                            seed=seed)
        return gnn_data.full_graph_batch(24, 60, cfg.d_feat, cfg.n_classes,
                                         seed=seed)

    def smoke(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """One reduced AdamW step on ``device`` (the card unless the CPU
        is asked for)."""
        device = resolve(device)
        cfg = self.smoke_config()
        params = gnn_mod.GNN(cfg, generator=torch.Generator(
            device).manual_seed(seed)).params
        batch = batch_to(self.smoke_batch(seed), device)
        with torch.no_grad():
            out = gnn_mod.forward(params, batch, cfg)
        return {"out_shape": tuple(out.shape), **_train_step_finite(
            lambda p, b: gnn_mod.loss_fn(p, b, cfg), params, batch)}

    def _abstract_batch(self, shape: Shape):
        """(batch of ``meta`` tensors, cfg) that ``shape`` implies."""
        sp = self.shapes[shape] if isinstance(shape, str) else shape
        cfg = self._shape_cfg(sp)
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        if self.cfg.arch == "graphcast":
            ng = sp.get("n_nodes", 1024)
            if sp["kind"] == "train_batched":
                ng = sp["n_nodes"] * sp["batch"]
            ne = sp["n_edges"] * sp.get("batch", 1)
            if sp["kind"] == "train_sampled":
                ng, ne = 166_000, 166_000
            ng, ne = _pad512(ng), _pad512(ne)
            nm = _pad512(max(ng // 4, 512))
            return {
                "node_feat": _meta((ng, cfg.n_vars), f32),
                "mesh_feat": _meta((nm, 3), f32),
                "g2m_src": _meta((ne,), i32), "g2m_dst": _meta((ne,), i32),
                "g2m_feat": _meta((ne, 4), f32),
                "mesh_src": _meta((ne,), i32), "mesh_dst": _meta((ne,), i32),
                "mesh_efeat": _meta((ne, 4), f32),
                "m2g_src": _meta((ne,), i32), "m2g_dst": _meta((ne,), i32),
                "m2g_feat": _meta((ne, 4), f32),
                "node_mask": _meta((ng,), b8),
                "labels": _meta((ng, cfg.n_vars), f32),
            }, cfg
        if sp["kind"] == "train_batched":      # molecule
            n = _pad512(sp["n_nodes"] * sp["batch"])
            e = _pad512(sp["n_edges"] * sp["batch"])
            batch = {
                "node_feat": _meta((n, sp["d_feat"]), f32),
                "edge_src": _meta((e,), i32), "edge_dst": _meta((e,), i32),
                "node_mask": _meta((n,), b8),
                "graph_ids": _meta((n,), i32),
            }
            if self.cfg.arch == "schnet":
                batch["edge_feat"] = _meta((e, 1), f32)
                batch["graph_targets"] = _meta((sp["batch"],), f32)
            else:
                batch["graph_labels"] = _meta((sp["batch"],), i32)
            return batch, cfg
        if sp["kind"] == "train_sampled":
            pad_nodes = _pad512(sp["batch_nodes"]
                                * (1 + sp["fanout"][0]
                                   + sp["fanout"][0] * sp["fanout"][1]))
            n = e = pad_nodes
        else:                                  # full graph
            n, e = _pad512(sp["n_nodes"]), _pad512(sp["n_edges"])
        batch = {
            "node_feat": _meta((n, sp["d_feat"]), f32),
            "edge_src": _meta((e,), i32), "edge_dst": _meta((e,), i32),
            "labels": _meta((n,), i32),
            "node_mask": _meta((n,), b8),
            "train_mask": _meta((n,), b8),
        }
        if self.cfg.arch == "schnet":
            batch["edge_feat"] = _meta((e, 1), f32)
            batch.pop("labels")
        return batch, cfg

    def build_dryrun(self, shape: Shape, mesh, *,
                     variant: str = "baseline") -> DryRunUnit:
        """The training step on the whole batch, its nodes and edges split
        over the batch axes (``variant="shardmap"``: gin and sage through
        ``models.gnn_dist``'s explicit step instead)."""
        batch, cfg = self._abstract_batch(shape)
        if variant == "shardmap" and cfg.arch in ("gin", "sage"):
            return self._build_shardmap(shape, mesh, batch, cfg)
        params = gnn_mod.abstract_params(cfg)
        pspecs = shd.gnn_param_specs(cfg, mesh)
        opt, opl = _opt_args(params, pspecs, mesh)
        return DryRunUnit(
            name=f"{self.arch_id}:{_shape_name(shape)}",
            step_fn=_train_step(lambda p, b: gnn_mod.loss_fn(p, b, cfg)),
            args=(params, opt, batch),
            placements=(shd.placements_tree(pspecs, mesh), opl,
                        shd.placements_tree(
                            shd.gnn_batch_specs(mesh, batch), mesh)),
            mesh=mesh, donate=(0, 1))

    def _build_shardmap(self, shape: Shape, mesh, batch, cfg) -> DryRunUnit:
        """Explicit message passing with destination-partitioned edges
        (``models.gnn_dist.sharded_train_step``), run by each rank on its
        own block of nodes and edges."""
        from ..models import gnn_dist
        step, bspec = gnn_dist.sharded_train_step(cfg, mesh, OPT)
        batch = {k: v for k, v in batch.items() if k in bspec}
        params = gnn_mod.abstract_params(cfg)
        pspecs = shd.gnn_param_specs(cfg, mesh)
        opt, opl = _opt_args(params, pspecs, mesh)

        def shardmap_step(params, opt_state, batch):
            return step(_trainable(params), opt_state, batch)

        return DryRunUnit(
            name=f"{self.arch_id}:{_shape_name(shape)}:shardmap",
            step_fn=shardmap_step, args=(params, opt, batch),
            placements=(shd.placements_tree(pspecs, mesh), opl,
                        {k: shd.placements(bspec[k], mesh) for k in batch}),
            mesh=mesh, donate=(0, 1), local=True)

    def model_flops(self, shape: Shape) -> float:
        """``shape``: a name of ``shapes`` or a dict of the same keys."""
        batch, cfg = self._abstract_batch(shape)
        d = cfg.d_hidden
        if cfg.arch == "graphcast":
            ne = batch["mesh_src"].shape[0]
            ng = batch["node_feat"].shape[0]
            per_edge = 2 * (2 * d + 4) * d + 2 * d * d
            per_node = 2 * (2 * d) * d + 2 * d * d
            fwd = cfg.n_layers * (ne * per_edge
                                  + batch["mesh_feat"].shape[0] * per_node) \
                + ng * 2 * cfg.n_vars * d * 2
            return 3 * fwd
        n = batch["node_feat"].shape[0]
        e = batch["edge_src"].shape[0]
        per_layer = n * (2 * d * d * 2) + e * d * 2
        if cfg.arch == "schnet":
            per_layer += e * (2 * cfg.n_rbf * d + 2 * d * d)
        fwd = cfg.n_layers * per_layer \
            + n * 2 * batch["node_feat"].shape[1] * d
        return 3 * fwd                       # fwd + bwd ≈ 3x fwd


# ================================================================= recsys ===
DIN_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


class DINArch(ArchConfig):
    family = "recsys"
    shapes = DIN_SHAPES

    def __init__(self, cfg: din_mod.DINConfig):
        self.cfg = cfg
        self.arch_id = cfg.name

    def smoke_config(self) -> din_mod.DINConfig:
        return dataclasses.replace(self.cfg, n_items=1000, n_cates=50,
                                   seq_len=12, user_feat_vocab=40)

    def smoke(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """One reduced AdamW step and a retrieval over 64 candidates on
        ``device`` (the card unless the CPU is asked for)."""
        from ..data import recsys_data
        device = resolve(device)
        cfg = self.smoke_config()
        params = din_mod.DIN(cfg, generator=torch.Generator(
            device).manual_seed(seed)).params
        batch = batch_to(recsys_data.din_batch(
            8, cfg.seq_len, cfg.n_items, cfg.n_cates, cfg.n_user_feats,
            cfg.user_feat_vocab, step=0, seed=seed), device)
        rb = batch_to(recsys_data.retrieval_batch(
            cfg.seq_len, cfg.n_items, cfg.n_cates, cfg.n_user_feats,
            cfg.user_feat_vocab, n_candidates=64, seed=seed), device)
        with torch.no_grad():
            scores = din_mod.retrieval_scores(params, rb, cfg)
        out = _train_step_finite(lambda p, b: din_mod.loss_fn(p, b, cfg),
                                 params, batch)
        out["finite"] = out["finite"] and bool(torch.isfinite(scores).all())
        return {"scores_shape": tuple(scores.shape), **out}

    def _abstract_batch(self, shape: Shape):
        """The batch of ``meta`` tensors that ``shape`` implies."""
        sp = self.shapes[shape] if isinstance(shape, str) else shape
        cfg = self.cfg
        i32, f32 = torch.int32, torch.float32
        if sp["kind"] == "retrieval":
            c = sp["n_candidates"]
            return {
                "hist_items": _meta((1, cfg.seq_len), i32),
                "hist_cates": _meta((1, cfg.seq_len), i32),
                "hist_mask": _meta((1, cfg.seq_len), f32),
                "user_feats": _meta((1, cfg.n_user_feats), i32),
                "cand_items": _meta((c,), i32),
                "cand_cates": _meta((c,), i32),
            }
        b = sp["batch"]
        batch = {
            "item_id": _meta((b,), i32), "cate_id": _meta((b,), i32),
            "hist_items": _meta((b, cfg.seq_len), i32),
            "hist_cates": _meta((b, cfg.seq_len), i32),
            "hist_mask": _meta((b, cfg.seq_len), f32),
            "user_feats": _meta((b, cfg.n_user_feats), i32),
        }
        if sp["kind"] == "train":
            batch["label"] = _meta((b,), f32)
        return batch

    def build_dryrun(self, shape: Shape, mesh) -> DryRunUnit:
        """Training, serving (``forward``) or retrieval scoring; the
        tables row-split over ``model``, the batch over the batch axes
        (retrieval: its candidates, 10^6 of them, split evenly on both
        production meshes and in uneven blocks where a count does not
        divide, while the one user is replicated)."""
        sp = _shape(self.shapes, shape)
        cfg = self.cfg
        params = din_mod.abstract_params(cfg)
        pspecs = shd.din_param_specs(cfg, mesh)
        ppl = shd.placements_tree(pspecs, mesh)
        batch = self._abstract_batch(shape)
        bspecs = shd.din_batch_specs(mesh, batch)
        name = f"{self.arch_id}:{_shape_name(shape)}"
        if sp["kind"] == "retrieval":
            baxes = shd.batch_axes(mesh)
            bspecs = {k: ((baxes,) if k.startswith("cand_")
                          else (None,) * v.dim())
                      for k, v in batch.items()}

            @torch.no_grad()
            def retrieval(params, batch):
                return din_mod.retrieval_scores(params, batch, cfg)

            return DryRunUnit(name=name, step_fn=retrieval,
                              args=(params, batch),
                              placements=(ppl, shd.placements_tree(
                                  bspecs, mesh)), mesh=mesh)
        bpl = shd.placements_tree(bspecs, mesh)
        if sp["kind"] == "serve":
            @torch.no_grad()
            def serve(params, batch):
                return din_mod.forward(params, batch, cfg)

            return DryRunUnit(name=name, step_fn=serve, args=(params, batch),
                              placements=(ppl, bpl), mesh=mesh)
        opt, opl = _opt_args(params, pspecs, mesh)
        return DryRunUnit(
            name=name,
            step_fn=_train_step(lambda p, b: din_mod.loss_fn(p, b, cfg)),
            args=(params, opt, batch), placements=(ppl, opl, bpl),
            mesh=mesh, donate=(0, 1))

    def model_flops(self, shape: Shape) -> float:
        """``shape``: a name of ``shapes`` or a dict of the same keys."""
        sp = self.shapes[shape] if isinstance(shape, str) else shape
        cfg = self.cfg
        d = cfg.embed_dim
        pair = 2 * d
        attn_in = 4 * pair
        attn = attn_in * cfg.attn_mlp[0] + cfg.attn_mlp[0] * cfg.attn_mlp[1] \
            + cfg.attn_mlp[1]
        d_in = cfg.n_user_feats * d + 3 * pair
        mlp = d_in * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1] + cfg.mlp[1]
        per_ex = 2 * (cfg.seq_len * attn + mlp)
        if sp["kind"] == "retrieval":
            return sp["n_candidates"] * per_ex
        mult = 3 if sp["kind"] == "train" else 1
        return mult * sp["batch"] * per_ex
