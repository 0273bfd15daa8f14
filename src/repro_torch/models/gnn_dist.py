"""Distributed GNN training step for gin and sage over a device mesh.

The layout, per rank of a ``("data", "model")`` or ``("pod", "data",
"model")`` mesh (:mod:`repro_torch.launch.mesh`):

* nodes row-partitioned over every mesh axis, in the mesh's row-major rank
  order (pod-major): rank ``r`` holds global nodes ``r * N_l .. (r + 1) *
  N_l``;
* edges partitioned by destination: each rank holds the edges into its
  own nodes, ``edge_dst`` local and ``edge_src`` global (ranks pad to a
  common edge count with edges from a padding node to a padding node of
  their own, whose ``node_mask`` is 0);
* per layer, one all-gather of the ``(N_l, d)`` features into ``(N, d)``
  in rank order, so that gathered row ``r`` is global node ``r``; then a
  local ``index_select`` and :func:`repro_torch.models.gnn.aggregate`
  (``_SegmentSum``, whose backward keeps only the ids), and the local MLP;
* the loss's numerator and denominator summed over ranks, the gradients
  summed over ranks, then the port's in-place ``apply_updates``.

Collective volume per layer is the feature matrix (N·d·4 B each way),
independent of the edge count.

**The gradient.**  The global loss is ``L = sum_r num_r / D`` with ``D =
sum_r den_r`` all-reduced and constant (a count of masked nodes: it takes
no gradient).  Each rank differentiates its own term ``L_r = num_r / D``.
The all-gather's backward is a reduce-scatter (sum), so the cotangent of
rank ``s``'s feature chunk is ``sum_r dL_r / dh_s = dL / dh_s``: by
induction over the layers every tensor of rank ``s`` receives its full
cotangent ``dL / dx``, and rank ``s``'s parameter gradient is ``dL / dθ``
restricted to the operations that run on ``s``.  Every operation of the
single-device computation runs on exactly one rank, so the **sum** of the
ranks' gradients is the single-device gradient.  The reference reaches the
same gradient another way (``psum`` of the loss under ``value_and_grad``,
whose transpose without replication checks is again a ``psum``, then
``pmean`` of the gradients); a mean in place of the sum here would be off
by the world size.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..torchgm.distributed import _all_gather
from ..train import optimizer as opt_mod
from ..train import tree as tr
from . import gnn as gnn_mod

AXES = ("pod", "data", "model")
#: batch leaves row-sharded over every mesh axis (the rest replicated)
SHARDED_LEAVES = ("node_feat", "edge_src", "edge_dst", "labels",
                  "node_mask", "train_mask")


def _all_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    names = tuple(mesh.mesh_dim_names or ())
    if set(names) - set(AXES):
        raise ValueError(f"mesh axes {names}: only {AXES} are known")
    return tuple(a for a in AXES if a in names)


def _group(mesh: DeviceMesh):
    """The process group of every rank of ``mesh``, whose rank order is
    the mesh's row-major order over ``_all_axes`` (that of
    ``launch.mesh``): the default group, checked to hold the mesh's ranks
    in that order."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"the mesh's ranks {ranks} are not the process "
                         f"group's in order")
    return dist.group.WORLD


class _GatherRows(torch.autograd.Function):
    """Every rank's rows concatenated in rank order; the backward sums the
    gathered rows' gradient over ranks and hands each rank its own rows
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, h, group):
        ctx.group = group
        return _all_gather(h, group, 0)

    @staticmethod
    def backward(ctx, grad):
        world = dist.get_world_size(ctx.group)
        mine = grad.new_empty((grad.shape[0] // world,) + grad.shape[1:])
        dist.reduce_scatter(mine, list(grad.contiguous().chunk(world)),
                            op=dist.ReduceOp.SUM, group=ctx.group)
        return mine, None


def _local_forward(params, batch, cfg: gnn_mod.GNNConfig, group):
    h = gnn_mod.mlp_apply(params["proj"], batch["node_feat"].to(cfg.dtype))
    n = h.shape[0]
    for i in range(cfg.n_layers):
        h_all = _GatherRows.apply(h, group)                   # (N, d)
        msg = h_all.index_select(0, batch["edge_src"])
        if cfg.arch == "gin":
            agg = gnn_mod.aggregate(msg, batch["edge_dst"], n, "sum")
            eps = params[f"eps{i}"][0]
            h = gnn_mod.mlp_apply(params[f"mlp{i}"], (1.0 + eps) * h + agg,
                                  final_act=True)
        else:
            # the mean is over the local in-degree: every edge into a node
            # lies on the node's rank
            agg = gnn_mod.aggregate(msg, batch["edge_dst"], n,
                                    cfg.aggregator)
            h = F.relu(gnn_mod.mlp_apply(params[f"self{i}"], h)
                       + gnn_mod.mlp_apply(params[f"neigh{i}"], agg))
            norm = torch.linalg.vector_norm(h, dim=-1, keepdim=True)
            h = h / torch.maximum(norm, norm.new_full((), 1e-6))
    return gnn_mod.mlp_apply(params["head"], h)


def sharded_loss_and_grads(cfg: gnn_mod.GNNConfig,
                           mesh: DeviceMesh) -> Callable:
    """(params, local batch) -> (loss, grads): the global loss, the same on
    every rank, and its gradient, summed over ranks (the single-device
    gradient; see the module's docstring), the same on every rank."""
    if cfg.arch not in ("gin", "sage"):
        raise ValueError(f"the sharded step runs gin and sage, not "
                         f"{cfg.arch!r}")
    _all_axes(mesh)
    group = _group(mesh)

    def loss_and_grads(params, batch):
        out = _local_forward(params, batch, cfg, group)
        nll = gnn_mod._nll(out, batch["labels"])
        mask = batch["node_mask"].float()
        if "train_mask" in batch:
            mask = mask * batch["train_mask"].float()
        num = (nll * mask).sum()
        sums = torch.stack([num.detach(), mask.sum()])
        dist.all_reduce(sums, group=group)
        den = torch.clamp(sums[1], min=1.0)
        leaves = tr.leaves(params)
        grads = torch.autograd.grad(num / den, leaves,
                                    materialize_grads=True)
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        grads = [f.view_as(g) for f, g in
                 zip(flat.split([g.numel() for g in grads]), grads)]
        return sums[0] / den, tr.unflatten_like(params, grads)

    return loss_and_grads


def sharded_train_step(cfg: gnn_mod.GNNConfig, mesh: DeviceMesh,
                       ocfg: opt_mod.AdamWConfig):
    """Returns (step, batch_spec) for gin and sage.

    ``step(params, opt_state, batch) -> (params, opt_state, loss)`` runs on
    every rank of ``mesh`` with that rank's batch (local shapes: the global
    batch is the ranks' batches in rank order); ``params`` and the state
    are replicated and updated in place.  ``batch_spec`` maps each batch
    leaf to its sharding per dimension: the mesh axes it is row-sharded
    over, or None."""
    axes = _all_axes(mesh)
    loss_and_grads = sharded_loss_and_grads(cfg, mesh)

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        params, opt_state, _ = opt_mod.apply_updates(params, grads,
                                                     opt_state, ocfg)
        return params, opt_state, loss

    batch_spec: Dict[str, tuple] = {k: (axes,) for k in SHARDED_LEAVES}
    batch_spec["node_feat"] = (axes, None)
    return step, batch_spec
