"""GNN substrate: GIN, GraphSAGE, SchNet, GraphCast (encoder-processor-decoder).

Message passing is an edge-index gather (``index_select``) and scatter
(``index_add``) over a uniform ``GraphBatch`` dict of tensors that feeds
all four architectures:

  node_feat (N, F) · edge_src (E,) · edge_dst (E,) · edge_feat (E, Fe)?
  node_mask (N,)   · graph_ids (N,)?  (batched small graphs)
  labels (N,) / graph_targets (G, ...)

GraphCast uses the extended fields (mesh_feat, g2m_src/dst, m2g_src/dst,
mesh_src/dst); the grid frontend is a stub: the batch supplies precomputed
per-node feature vectors.

All shapes are static; padded edges point at a sink node (index N-1 with
node_mask false) so sampled/ragged batches need no clamp.  Indices stay
int32.  On the card ``index_add`` (and the backward of ``index_select``)
adds with float atomics in no fixed order, so results there match the
CPU's within a tolerance, not bit for bit.

Parameters are a nested dict of tensors with the reference's keys
(``{"proj": {"w0", "b0"}, "eps0", "mlp0": {...}, "head": {...}}``);
:class:`GNN` holds that tree as an ``nn.Module`` whose
``named_parameters()`` are its ``.``-joined paths (``proj.w0``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist.sharding import contiguous_stride, pick

Params = Dict[str, Any]


@dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str                       # gin | sage | schnet | graphcast
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int = 16
    aggregator: str = "sum"         # sum | mean
    # gin
    learnable_eps: bool = True
    # schnet
    n_rbf: int = 300
    cutoff: float = 10.0
    # graphcast
    n_vars: int = 227
    mesh_refinement: int = 6
    dtype: torch.dtype = torch.float32


# --------------------------------------------------------------- primitives
def mlp_shapes(dims) -> Dict[str, Tuple[int, ...]]:
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = (a, b)
        out[f"b{i}"] = (b,)
    return out


def mlp_apply(p: Params, x: torch.Tensor, act=F.relu,
              final_act: bool = False) -> torch.Tensor:
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


class _SegmentSum(torch.autograd.Function):
    """``index_add`` into zeros whose backward gathers the gradient rows at
    ``ids`` and keeps only ``ids``: autograd's own ``index_add`` keeps its
    whole source, an (E, d) message tensor a layer (15.8 GB at
    ogb-products' 61.9 M edges and d 64)."""

    @staticmethod
    def forward(ctx, data, ids, n):
        ctx.save_for_backward(ids)
        if isinstance(data, DTensor):
            return _dtensor_segment_sum(data, ids, n)
        out = data.new_zeros((n,) + tuple(data.shape[1:]))
        return out.index_add_(0, ids, data)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return grad.index_select(0, ids), None, None


def _dtensor_segment_sum(data: DTensor, ids: DTensor, n: int) -> DTensor:
    """``index_add`` of a DTensor's rows, which has no DTensor rule, as
    GSPMD partitions a scatter-add: each rank adds its own rows into a
    whole ``(n, ...)`` block, partial over every mesh dimension that
    splits the rows (the next operation that needs the sums reduces
    them), with ``ids`` placed as the rows are."""
    mesh = data.device_mesh
    id_pl, out_pl = [], []
    for p in data.placements:
        rows = isinstance(p, Shard) and p.dim == 0
        id_pl.append(Shard(0) if rows else Replicate())
        out_pl.append(Partial() if rows else p)
    ids = ids.redistribute(mesh, id_pl).to_local()
    local = data.to_local()
    out = local.new_zeros((n,) + tuple(local.shape[1:])).index_add_(
        0, ids, local)
    shape = (n,) + tuple(data.shape[1:])
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` added into ``n`` rows at
    ``ids`` (int32, every id in range)."""
    return _SegmentSum.apply(data, ids, n)


def aggregate(messages: torch.Tensor, edge_dst: torch.Tensor, n_nodes: int,
              kind: str) -> torch.Tensor:
    s = segment_sum(messages, edge_dst, n_nodes)
    if kind == "mean":
        deg = segment_sum(torch.ones_like(edge_dst, dtype=messages.dtype),
                          edge_dst, n_nodes)
        s = s / torch.clamp(deg, min=1.0)[:, None]
    return s


# ------------------------------------------------------------------ shapes
def param_shapes(cfg: GNNConfig) -> Dict[str, Any]:
    d, f = cfg.d_hidden, cfg.d_feat
    if cfg.arch == "gin":
        s: Dict[str, Any] = {"proj": mlp_shapes([f, d])}
        for i in range(cfg.n_layers):
            s[f"mlp{i}"] = mlp_shapes([d, d, d])
            s[f"eps{i}"] = (1,)
        s["head"] = mlp_shapes([d, cfg.n_classes])
        return s
    if cfg.arch == "sage":
        s = {"proj": mlp_shapes([f, d])}
        for i in range(cfg.n_layers):
            s[f"self{i}"] = mlp_shapes([d, d])
            s[f"neigh{i}"] = mlp_shapes([d, d])
        s["head"] = mlp_shapes([d, cfg.n_classes])
        return s
    if cfg.arch == "schnet":
        s = {"embed": mlp_shapes([f, d])}
        for i in range(cfg.n_layers):
            s[f"filter{i}"] = mlp_shapes([cfg.n_rbf, d, d])
            s[f"in{i}"] = mlp_shapes([d, d])
            s[f"out{i}"] = mlp_shapes([d, d, d])
        s["head"] = mlp_shapes([d, d // 2, 1])
        return s
    if cfg.arch == "graphcast":
        d_edge = 4                       # stub edge geometry features
        d_mesh = 3                       # stub mesh-node geometry features
        s = {
            "grid_enc": mlp_shapes([cfg.n_vars, d, d]),
            "mesh_enc": mlp_shapes([d_mesh, d, d]),
            "g2m_edge": mlp_shapes([2 * d + d_edge, d, d]),
            "g2m_node": mlp_shapes([2 * d, d, d]),
            "m2g_edge": mlp_shapes([2 * d + d_edge, d, d]),
            "m2g_node": mlp_shapes([2 * d, d, d]),
            "decoder": mlp_shapes([d, d, cfg.n_vars]),
        }
        for i in range(cfg.n_layers):
            s[f"pe{i}"] = mlp_shapes([2 * d + d_edge, d, d])   # edge update
            s[f"pn{i}"] = mlp_shapes([2 * d, d, d])            # node update
        return s
    raise ValueError(cfg.arch)


def _shapes_as(fn, shapes):
    if isinstance(shapes, dict):
        return {k: _shapes_as(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def abstract_params(cfg: GNNConfig) -> Params:
    """The :func:`param_shapes` tree as ``meta`` tensors of ``cfg.dtype``
    (shapes and dtypes, no storage)."""
    return _shapes_as(lambda s: torch.empty(s, dtype=cfg.dtype,
                                            device="meta"),
                      param_shapes(cfg))


def init_params(cfg: GNNConfig, generator: torch.Generator) -> Params:
    """Random parameters on ``generator``'s device, drawn leaf by leaf in
    sorted key order.  The reference's scheme: matrices
    ``N(0, 1) / sqrt(fan_in)`` drawn in float32 and cast, 1-D leaves
    (biases and ``eps{i}``) at zero.  The draws differ from the
    reference's (another RNG)."""
    device = generator.device

    def one(s):
        if isinstance(s, dict):
            return {k: one(s[k]) for k in sorted(s)}
        if len(s) == 1:
            return torch.zeros(s, dtype=cfg.dtype, device=device)
        w = torch.randn(s, generator=generator, dtype=torch.float32,
                        device=device)
        return w.div_(math.sqrt(s[0])).to(cfg.dtype)

    return one(param_shapes(cfg))


# ----------------------------------------------------------------- forwards
def _readout(h, batch):
    """Graph-level mean pooling when the batch carries graph_ids."""
    n_graphs = (batch["graph_targets"].shape[0] if "graph_targets" in batch
                else batch["graph_labels"].shape[0])
    mask = batch["node_mask"]
    masked = torch.where(mask[:, None], h, 0.0)
    s = segment_sum(masked, batch["graph_ids"], n_graphs)
    cnt = segment_sum(mask.to(h.dtype), batch["graph_ids"], n_graphs)
    return s / torch.clamp(cnt, min=1.0)[:, None]


def _gin_forward(p, batch, cfg):
    n = batch["node_feat"].shape[0]
    h = mlp_apply(p["proj"], batch["node_feat"].to(cfg.dtype))
    for i in range(cfg.n_layers):
        msg = h.index_select(0, batch["edge_src"])
        agg = aggregate(msg, batch["edge_dst"], n, "sum")
        eps = p[f"eps{i}"][0]
        h = mlp_apply(p[f"mlp{i}"], (1.0 + eps) * h + agg, final_act=True)
    if "graph_ids" in batch:
        return mlp_apply(p["head"], _readout(h, batch))
    return mlp_apply(p["head"], h)


def _sage_forward(p, batch, cfg):
    n = batch["node_feat"].shape[0]
    h = mlp_apply(p["proj"], batch["node_feat"].to(cfg.dtype))
    for i in range(cfg.n_layers):
        msg = h.index_select(0, batch["edge_src"])
        agg = aggregate(msg, batch["edge_dst"], n, cfg.aggregator)
        # relu before the norm and max(norm, 1e-6), as the reference: its
        # padding rows are exactly zero at init, where the norm's gradient
        # is 0 here and dropped by relu's select there
        h = F.relu(mlp_apply(p[f"self{i}"], h)
                   + mlp_apply(p[f"neigh{i}"], agg))
        norm = torch.linalg.vector_norm(h, dim=-1, keepdim=True)
        h = h / torch.maximum(norm, norm.new_full((), 1e-6))
    if "graph_ids" in batch:
        return mlp_apply(p["head"], _readout(h, batch))
    return mlp_apply(p["head"], h)


def _centres(cutoff: float, n: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, cutoff, n)`` as the reference computes it, to the
    bit: XLA folds ``0 * (1 - t) + cutoff * t`` at ``t = i * (1 / (n - 1))``
    into ``i * (cutoff * (1 / (n - 1)))``, each product rounded to
    ``dtype``, then appends ``cutoff`` (``torch.linspace`` rounds a third
    of the 300 centres another way)."""
    if n < 2:
        return torch.zeros(n, dtype=dtype, device=device)
    recip = torch.tensor(1.0, dtype=dtype) / (n - 1)
    step = (torch.tensor(cutoff, dtype=dtype) * recip).item()
    return torch.cat([torch.arange(n - 1, dtype=dtype, device=device) * step,
                      torch.full((1,), cutoff, dtype=dtype, device=device)])


def _rbf(dist, cfg):
    centers = _centres(cfg.cutoff, cfg.n_rbf, dist.dtype, dist.device)
    gamma = cfg.n_rbf / cfg.cutoff
    return torch.exp(-gamma * torch.square(dist[:, None] - centers[None, :]))


def _schnet_forward(p, batch, cfg):
    n = batch["node_feat"].shape[0]
    h = mlp_apply(p["embed"], batch["node_feat"].to(cfg.dtype))
    rbf = _rbf(batch["edge_feat"][:, 0].to(cfg.dtype), cfg)   # distances
    for i in range(cfg.n_layers):
        w = mlp_apply(p[f"filter{i}"], rbf)                 # (E, d) cfconv
        src_h = mlp_apply(p[f"in{i}"], h).index_select(0, batch["edge_src"])
        agg = aggregate(src_h * w, batch["edge_dst"], n, "sum")
        h = h + mlp_apply(p[f"out{i}"], agg)
    atom_e = mlp_apply(p["head"], h)                        # (N, 1)
    atom_e = torch.where(batch["node_mask"][:, None], atom_e, 0.0)
    if "graph_ids" in batch:
        n_graphs = batch["graph_targets"].shape[0]
        return segment_sum(atom_e[:, 0], batch["graph_ids"], n_graphs)
    return atom_e[:, 0]


def _interaction(edge_p, node_p, h, src, dst, efeat, n, cfg):
    e_in = torch.cat([h.index_select(0, src), h.index_select(0, dst),
                      efeat], -1)
    m = mlp_apply(edge_p, e_in)
    agg = aggregate(m, dst, n, "sum")
    return h + mlp_apply(node_p, torch.cat([h, agg], -1))


def _graphcast_forward(p, batch, cfg):
    ng = batch["node_feat"].shape[0]                        # grid nodes
    nm = batch["mesh_feat"].shape[0]                        # mesh nodes
    hg = mlp_apply(p["grid_enc"], batch["node_feat"].to(cfg.dtype))
    hm = mlp_apply(p["mesh_enc"], batch["mesh_feat"].to(cfg.dtype))
    # encode: grid -> mesh
    e_in = torch.cat([hg.index_select(0, batch["g2m_src"]),
                      hm.index_select(0, batch["g2m_dst"]),
                      batch["g2m_feat"].to(cfg.dtype)], -1)
    m = mlp_apply(p["g2m_edge"], e_in)
    agg = aggregate(m, batch["g2m_dst"], nm, "sum")
    hm = hm + mlp_apply(p["g2m_node"], torch.cat([hm, agg], -1))
    # process: message passing on the (multi-)mesh
    efeat = batch["mesh_efeat"].to(cfg.dtype)
    for i in range(cfg.n_layers):
        hm = _interaction(p[f"pe{i}"], p[f"pn{i}"], hm, batch["mesh_src"],
                          batch["mesh_dst"], efeat, nm, cfg)
    # decode: mesh -> grid
    e_in = torch.cat([hm.index_select(0, batch["m2g_src"]),
                      hg.index_select(0, batch["m2g_dst"]),
                      batch["m2g_feat"].to(cfg.dtype)], -1)
    m = mlp_apply(p["m2g_edge"], e_in)
    agg = aggregate(m, batch["m2g_dst"], ng, "sum")
    hg = hg + agg
    return mlp_apply(p["decoder"], hg)                      # (Ng, n_vars)


FORWARDS = {"gin": _gin_forward, "sage": _sage_forward,
            "schnet": _schnet_forward, "graphcast": _graphcast_forward}


def forward(params, batch, cfg: GNNConfig):
    return FORWARDS[cfg.arch](params, batch, cfg)


def _nll(out, labels):
    logp = F.log_softmax(out.float(), -1)
    return -pick(logp, labels)


def loss_fn(params, batch, cfg: GNNConfig):
    out = forward(params, batch, cfg)
    if cfg.arch == "schnet":
        if "graph_targets" in batch:
            return torch.mean(torch.square(out - batch["graph_targets"]))
        mask = batch["node_mask"]
        return torch.sum(torch.square(out) * mask) \
            / torch.clamp(mask.sum(), min=1)
    if cfg.arch == "graphcast":
        err = torch.square(out - batch["labels"].to(out.dtype))
        mask = batch["node_mask"][:, None]
        return torch.sum(err * mask) \
            / torch.clamp(mask.sum() * out.shape[-1], min=1)
    if "graph_ids" in batch:
        # graph classification (molecule shape on gin/sage)
        return _nll(out, batch["graph_labels"]).mean()
    # node classification
    nll = _nll(out, batch["labels"])
    mask = batch["node_mask"].float()
    if "train_mask" in batch:
        mask = mask * batch["train_mask"].float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class GNN(nn.Module):
    """A GNN as a module over the functions above.

    ``GNN(cfg, params)`` wraps an existing tree (its tensors become the
    module's parameters, storage shared); ``GNN(cfg, generator=g)`` draws
    one with :func:`init_params` on ``g``'s device.  ``params`` gives the
    tree back, as ``nn.Parameter`` leaves that require grad, for the
    functional API and the optimizer."""

    def __init__(self, cfg: GNNConfig, params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if params is None:
            if generator is None:
                raise ValueError("GNN needs params or a generator")
            params = init_params(cfg, generator)
        self.cfg = cfg
        self._keys = sorted(params)
        for k in self._keys:
            v = params[k]
            if isinstance(v, dict):
                self.register_module(k, nn.ParameterDict(
                    {n: nn.Parameter(v[n]) for n in sorted(v)}))
            else:
                self.register_parameter(k, nn.Parameter(v))

    @property
    def params(self) -> Params:
        out = {}
        for k in self._keys:
            v = getattr(self, k)
            out[k] = dict(v.items()) if isinstance(v, nn.ParameterDict) \
                else v
        return out

    def forward(self, batch):
        return forward(self.params, batch, self.cfg)
