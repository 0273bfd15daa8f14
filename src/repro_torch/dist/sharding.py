"""Sharding conventions for the production meshes.

Meshes come from :mod:`repro_torch.launch.mesh`: ``("data", "model")``
per pod, with a leading ``"pod"`` axis across pods.  A *spec* names, for
each dimension of a tensor, the mesh axes it is split over: ``None``, an
axis, or a tuple of axes (split in that order, the outer axis first), as
a ``PartitionSpec`` does; :func:`placements` turns a spec into the
``DTensor`` placements on a mesh.  The conventions:

* **batch axes** — activations/batches shard their leading dimension over
  every data-parallel axis present (``("pod", "data")`` ∩ mesh axes);
  parameters are replicated across pods.
* **LM params** — Megatron-style tensor parallelism over ``"model"``
  (column-parallel in-projections, row-parallel out-projections, vocab
  -sharded embedding/lm_head) combined with FSDP-style sharding of the
  other weight dimension over ``"data"``.  Per-layer weights are stacked
  with a leading ``n_layers`` dim, which is never sharded.
  ``configs.base`` overrides the kv projections when GQA head padding does
  not divide the TP degree.
* **GNN params** — small MLPs: replicated; batches shard nodes/edges.
* **DIN params** — the embedding tables are the big tensors: row-sharded
  over ``"model"``; the attention/output MLPs are tiny and replicated.

Below them, the ``DTensor`` helpers the models' sharded paths share
(``reduced_lookup``, ``summed``, ``pick``, ``partial_sums``): each puts a
sum or a gather where GSPMD puts it, with the gradient a sum's terms
need.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["axis_size", "batch_axes", "placements", "placements_tree",
           "reduced_lookup", "summed", "pick", "partial_sums",
           "lm_param_specs", "lm_batch_specs", "gnn_param_specs",
           "gnn_batch_specs", "din_param_specs", "din_batch_specs"]

Spec = Tuple[Any, ...]


def _names(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[_names(mesh).index(axis)]


def batch_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes, as one spec entry for the leading
    batch/node dimension: ("pod", "data") restricted to the mesh."""
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def _replicated(n: int) -> Spec:
    return (None,) * n


def placements(spec: Spec, mesh: DeviceMesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: mesh dimension
    ``j`` gets ``Shard(i)`` where tensor dimension ``i`` names its axis,
    else ``Replicate()``.  Several axes on one tensor dimension must come
    in the mesh's order: ``DTensor`` splits a dimension over its mesh
    dimensions in that order, and a spec splits it in its own."""
    names = _names(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: dimension {i} is split over "
                             f"{axes}, not in the mesh's order {names}")
        for j in pos:
            if out[j] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[j]!r} "
                                 f"splits two dimensions")
            out[j] = Shard(i)
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def placements_tree(specs, mesh: DeviceMesh):
    """:func:`placements` of every spec of a nested dict / list / tuple
    tree of specs (a tuple is a spec, not a node)."""
    if _is_spec(specs):
        return placements(specs, mesh)
    if isinstance(specs, dict):
        return {k: placements_tree(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [placements_tree(v, mesh) for v in specs]
    raise TypeError(f"not a spec tree: {type(specs)}")


# ------------------------------------------------------------------ LM (TP)
def lm_param_specs(cfg, mesh: DeviceMesh) -> Dict[str, Any]:
    """Specs mirroring ``models.transformer.param_shapes``.

    Column-parallel (out-dim over "model", in-dim over "data"): wq/wk/wv,
    w1/w3 and shared-expert in-projections; row-parallel (in-dim over
    "model", out-dim over "data"): wo, w2.  Vocab dims shard over "model".
    Norms and the router replicate; biases follow their projection's
    out-dim.  The leading stacked-layer dim stays unsharded.
    """
    from ..models import transformer as tf_mod

    col = (None, "data", "model")           # (layer, in, out): out-parallel
    row = (None, "model", "data")           # (layer, in, out): in-parallel
    layer_specs: Dict[str, Spec] = {
        "ln1": (None, None), "ln2": (None, None),
        "wq": col, "wk": col, "wv": col, "wo": row,
        "bq": (None, "model"), "bk": (None, "model"),
        "bv": (None, "model"),
        "w1": col, "w3": col, "w2": row,
        # MoE: experts replicate over the mesh (the dry-run measures the
        # dense shards; expert parallelism is an open item)
        "router": (None, None, None),
        "we1": (None, None, "data", "model"),
        "we3": (None, None, "data", "model"),
        "we2": (None, None, "model", "data"),
        "ws1": col, "ws3": col, "ws2": row,
    }
    shapes = tf_mod.param_shapes(cfg)
    layers = {k: layer_specs.get(k, _replicated(len(v)))
              for k, v in shapes["layers"].items()}
    return {
        "embed": ("model", None),           # vocab-sharded
        "final_ln": (None,),
        "lm_head": (None, "model"),         # vocab-sharded output
        "layers": layers,
    }


def lm_batch_specs(mesh: DeviceMesh) -> Dict[str, Spec]:
    baxes = batch_axes(mesh)
    return {"tokens": (baxes, None), "labels": (baxes, None)}


# ---------------------------------------------------------------------- GNN
def _map_shapes(fn, shapes):
    if _is_spec(shapes):
        return fn(shapes)
    return {k: _map_shapes(fn, v) for k, v in shapes.items()}


def gnn_param_specs(cfg, mesh: DeviceMesh):
    """GNN weights are small — replicate everything (structure mirrors
    ``models.gnn.param_shapes``)."""
    from ..models import gnn as gnn_mod

    return _map_shapes(lambda s: _replicated(len(s)),
                       gnn_mod.param_shapes(cfg))


def gnn_batch_specs(mesh: DeviceMesh, batch) -> Dict[str, Spec]:
    """Node/edge arrays shard their leading dimension over the batch axes
    (padded upstream to multiples of 512, see ``configs.base``)."""
    baxes = batch_axes(mesh)
    return {k: (baxes,) + _replicated(len(v.shape) - 1)
            for k, v in batch.items()}


# ---------------------------------------------------------------------- DIN
def din_param_specs(cfg, mesh: DeviceMesh):
    """Embedding tables row-shard over "model"; the MLPs replicate."""
    from ..models import recsys as din_mod

    def spec(name: str, shape) -> Spec:
        if name.endswith("_table"):
            return ("model",) + _replicated(len(shape) - 1)
        return _replicated(len(shape))

    shapes = din_mod.param_shapes(cfg)
    return {k: spec(k, v) for k, v in shapes.items()}


def din_batch_specs(mesh: DeviceMesh, batch) -> Dict[str, Spec]:
    baxes = batch_axes(mesh)
    return {k: (baxes,) + _replicated(len(v.shape) - 1)
            for k, v in batch.items()}


# ------------------------------------------------------ DTensor operators
def reduced_lookup(x):
    """Rows looked up in a DTensor table split by rows come as a masked
    partial sum, which DTensor reduces only once and cannot add to another
    table's: reduced here, onto replicas over those mesh axes (GSPMD
    reduces a partitioned gather there too).  Anything else is returned
    as it is."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        x = summed(x, [Replicate() if p.is_partial() else p
                       for p in x.placements])
    return x


def summed(x: DTensor, placements) -> DTensor:
    """``x`` redistributed to ``placements``, its partial sums added up,
    whose backward places the gradient as ``x`` was placed but with those
    sums replicated: the gradient of a sum is the same for each of its
    terms (Megatron's all-reduce, whose backward is the identity).
    DTensor's own backward would take the gradient back to the partial
    placements, which a masked lookup's backward cannot take, and which
    sends a row-parallel product's backward a gradient that makes it
    recompute the product whole on every rank of ``model``."""
    return _Summed.apply(x, tuple(placements))


class _Summed(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, placements):
        ctx.mesh = x.device_mesh
        ctx.placements = [Replicate() if p.is_partial() else p
                          for p in x.placements]
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None


def pick(values, index):
    """``values[..., index]`` along the last dimension (``index`` one entry
    per row).  On DTensors by a one-hot product, the other terms exact
    zeros: ``torch.gather``'s backward starts from a zero gradient of the
    values' global shape, whole on every rank, and its rule marks the
    result a masked partial sum where the values are split."""
    if not isinstance(values, DTensor):
        return torch.gather(values, -1, index[..., None].long())[..., 0]
    hot = index[..., None].long() == torch.arange(
        values.shape[-1], device=index.device)
    return torch.where(hot, values, 0.0).sum(-1)


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def partial_sums(local: torch.Tensor, mesh: DeviceMesh, placements,
                 shape) -> DTensor:
    """A DTensor of global ``shape`` from this rank's ``local`` block,
    partial sums over the mesh dimensions ``placements`` marks
    ``Partial``, whose backward hands each term the whole gradient (the
    gradient of a sum is the same for each of its terms;
    ``DTensor.from_local``'s own backward would split it among them)."""
    return _PartialSums.apply(local, mesh, tuple(placements),
                              tuple(shape))


class _PartialSums(torch.autograd.Function):

    @staticmethod
    def forward(ctx, local, mesh, placements, shape):
        ctx.mesh, ctx.placements = mesh, placements
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    @staticmethod
    def backward(ctx, grad):
        whole = [Replicate() if p.is_partial() else p
                 for p in ctx.placements]
        return (grad.redistribute(ctx.mesh, whole).to_local(), None, None,
                None)
