"""Distributed GM: SUMMA-style sharded double simulation + serving step.

Layout over the production mesh (``("data","model")`` per pod, plus a
leading ``"pod"`` axis across pods; :mod:`repro_torch.launch.mesh`):

* packed matrices (A, R, Aᵀ, Rᵀ; the graph's ``(4, n_pad, W)`` stack):
  rows sharded over ``("pod","data")``, packed word-columns sharded over
  ``"model"`` — 2-D block layout; a 2²⁰-node graph is 128 GB packed ⇒
  256 MB/chip on 512 chips.
* FB candidate matrix: node dimension sharded over ``"model"`` (aligned
  with the matrices' column blocks), replicated over ``("pod","data")``;
  labels sharded over ``"model"`` alike.
* one simulation pass =
    local sum-mode ``bitmm`` (the port's kernel) on the (row-block ×
    word-block) tile → ``all_reduce`` (sum) over ``model`` (contraction
    over node columns) → ``all_gather`` over ``data``, then ``pod``
    (rebuild full Y) → slice this shard's node range, apply edge masks.

Each rank holds its own tile (:func:`shard_graph_arrays`) and calls these
functions itself, as every rank of the process group must; there is no
global array.  Collectives are list ``all_gather`` + ``torch.cat`` and
``all_reduce``, each on its mesh axis' group, with bool tensors sent as
uint8; they run on NCCL on the card and on gloo on a pinned CPU.

The enumeration phase deliberately stays *pod-local*: after double
simulation the RIG is tiny (paper Fig. 9: ≈0.4% of the data graph), so
candidates are compacted (top-K per query node) and handed to the
single-pod frontier enumerator — the distributed phase is the filter, as
in the paper's architecture.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..kernels import ops, packed
from ..obs.metrics import get_registry
from ..obs.trace import profiled
from .device_graph import DeviceGraph
from .encoding import QueryTensor
from .simulation import _columns, _edges, apply_edge_masks, edge_sums

ROW_AXES = ("pod", "data")     # matrix rows (only axes present in the mesh)
COL_AXIS = "model"             # packed word columns / FB node dim


def _axes(mesh: DeviceMesh) -> Tuple[Tuple[str, ...], str]:
    names = mesh.mesh_dim_names or ()
    if COL_AXIS not in names:
        raise ValueError(f"the mesh has no {COL_AXIS!r} axis: {names}")
    return tuple(a for a in ROW_AXES if a in names), COL_AXIS


def _size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


class ShardSpec(NamedTuple):
    shape: Tuple[int, ...]     # the global shape
    dtype: torch.dtype
    axes: tuple                # per dimension: None or the mesh axes


class ShardedGraphSpecs(NamedTuple):
    """Global shapes, dtypes and shardings of the packed graph."""
    mats: ShardSpec            # (4, Np, Np/32) int32 lanes
    labels: ShardSpec          # (Np,) int32


def graph_specs(n_pad: int, mesh: DeviceMesh) -> ShardedGraphSpecs:
    row_axes, col = _axes(mesh)
    w = n_pad // 32
    return ShardedGraphSpecs(
        mats=ShardSpec((4, n_pad, w), torch.int32, (None, row_axes, col)),
        labels=ShardSpec((n_pad,), torch.int32, (col,)))


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated along ``dim`` in
    rank order.  Bool travels as uint8."""
    is_bool = t.dtype == torch.bool
    src = (t.view(torch.uint8) if is_bool else t).contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.view(torch.bool) if is_bool else out


def _gather_rows(y: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """All-gather dim 1 over ``data``, then ``pod``: global row block =
    pod * n_data + data."""
    for ax in reversed(_axes(mesh)[0]):
        y = _all_gather(y, mesh.get_group(ax), 1)
    return y


def _my_columns(y: torch.Tensor, mesh: DeviceMesh, np_l: int, b: int,
                max_q: int) -> torch.Tensor:
    """(k, Np, B*max_q) full rows -> (k, B, max_q, np_l): this shard's
    node range, one row of nodes per query node."""
    col_id = mesh.get_local_rank(COL_AXIS)
    mine = y[:, col_id * np_l:(col_id + 1) * np_l]
    return mine.reshape(y.shape[0], np_l, b, max_q).permute(0, 2, 3, 1)


def _tile_products(mats_blk: torch.Tensor, fb_blk: torch.Tensor,
                   n_mats: int, mesh: DeviceMesh) -> torch.Tensor:
    """Sum-mode ``bitmm`` of the first ``n_mats`` tiles by this shard's FB
    columns, summed over ``model``: (n_mats, rows_l, B*max_q) float32."""
    x = _columns(fb_blk)                     # (np_l, B*max_q), a view
    y = torch.stack([ops.bitmm(mats_blk[m], x, threshold=False)
                     for m in range(n_mats)])
    dist.all_reduce(y, group=mesh.get_group(COL_AXIS))
    return y


# --------------------------------------------------------------- sim pass
def _local_pass(mats_blk: torch.Tensor, fb_blk: torch.Tensor, n_e: int,
                edges: tuple, mesh: DeviceMesh, *,
                pack_y: bool = False) -> torch.Tensor:
    """One Jacobi double-simulation pass over a BATCH of queries on this
    rank.  mats_blk: (4, rows_l, w_l) int32 lanes; fb_blk: (B, max_q,
    np_l) bool.  Returns the pruned fb_blk.

    ``pack_y``: the all-gathered Y is pure bits; packing it into int32
    lanes before the gather cuts its payload 8× (bool travels as a byte)
    at the cost of one pack/unpack pair per pass.
    """
    b, max_q, np_l = fb_blk.shape
    y = _tile_products(mats_blk, fb_blk, 4, mesh) > 0   # (4, rows_l, BQ)
    if pack_y:
        y = packed.unpack(_gather_rows(packed.pack(y), mesh), b * max_q)
    else:
        y = _gather_rows(y, mesh)                       # (4, Np, BQ)
    # (4, B, max_q, np_l): [fwd-child, fwd-desc, bwd-child, bwd-desc]
    return apply_edge_masks(fb_blk, _my_columns(y, mesh, np_l, b, max_q),
                            n_e, edges)


def sharded_double_simulation(mats: torch.Tensor, labels: torch.Tensor,
                              qts: QueryTensor, mesh: DeviceMesh, *,
                              n_passes: int = 4,
                              pack_y: bool = False) -> torch.Tensor:
    """This rank's FB block for a batch of queries: (B, max_q, n_pad /
    n_model) bool, the node range of its ``model`` coordinate (the same on
    every rank of that coordinate).  ``mats`` / ``labels`` are this rank's
    tile and label block (:func:`shard_graph_arrays`); ``qts`` leaves carry
    a leading batch dim."""
    ql = qts.labels.to(labels.device)[:, :, None]
    fb = (ql == labels[None, None, :]) & (ql >= 0)      # (B, max_q, np_l)
    n_e, edges = _edges(qts, labels.device)
    for _ in range(n_passes):
        fb = _local_pass(mats, fb, n_e, edges, mesh, pack_y=pack_y)
    return fb


# -------------------------------------------------------------- serve step
def _count_edge_slots(qts: QueryTensor, n_passes: int) -> None:
    """Adds to the process-wide counters ``serve_edge_slots``, the (batch
    member, edge slot) pairs that one step's edge masks and edge sums
    process (every member runs to the batch's largest edge count in each
    pass, and the edge sums run every slot), and ``serve_edge_slots_real``,
    those among them whose slot holds one of the member's edges.  Counted
    from ``qts.n_edges`` where it is a CPU tensor with values; elsewhere (a
    card's, a ``meta`` trace's) nothing is read or counted."""
    n_edges = qts.n_edges
    if type(n_edges) is not torch.Tensor or n_edges.device.type != "cpu":
        return
    per_member = n_edges.tolist()
    n_e = max(per_member, default=0)
    reg = get_registry()
    reg.counter("serve_edge_slots").inc(
        len(per_member) * (n_e * n_passes + qts.max_e))
    reg.counter("serve_edge_slots_real").inc(
        sum(per_member) * (n_passes + 1))


class ServeStepOut(NamedTuple):
    fb_sizes: torch.Tensor     # (B, max_q) int32   |cos(q)|
    edge_counts: torch.Tensor  # (B, max_e) float32 RIG edge cardinalities
    candidates: torch.Tensor   # (B, max_q, top_k) int32 compacted handoff


def gm_serve_step(mats: torch.Tensor, labels: torch.Tensor,
                  qts: QueryTensor, mesh: DeviceMesh, *, n_passes: int = 4,
                  top_k: int = 4096, pack_y: bool = False) -> ServeStepOut:
    """The distributed query-serving step: double simulation (n_passes)
    → RIG statistics → candidate compaction (top-K node ids per query
    node, the pod-local enumeration handoff).  Every output is replicated
    on every rank.  Raises ``ValueError`` where the model shards hold
    fewer than ``top_k`` nodes in all."""
    with profiled("serve.step"):
        _, col = _axes(mesh)
        n_model = _size(mesh, col)
        np_l = labels.shape[0]
        if n_model * min(top_k, np_l) < top_k:
            raise ValueError(f"top_k={top_k} is more than the {n_model} "
                             f"model shards' {n_model * min(top_k, np_l)} "
                             f"candidates")
        _count_edge_slots(qts, n_passes)
        fb = sharded_double_simulation(mats, labels, qts, mesh,
                                       n_passes=n_passes, pack_y=pack_y)
        b, max_q, _ = fb.shape
        col_group = mesh.get_group(col)
        sizes = fb.sum(dim=2, dtype=torch.int32)         # (B, max_q)
        dist.all_reduce(sizes, group=col_group)

        # RIG edge counts: one more sum-semantics pass over the forward
        # matrices; each rank sums its node range in float64, the ranks'
        # sums are added in float64 and cast to float32 once
        cnt = _gather_rows(_tile_products(mats, fb, 2, mesh), mesh)
        partial = edge_sums(fb, _my_columns(cnt, mesh, np_l, b, max_q), qts)
        dist.all_reduce(partial, group=col_group)
        edge_counts = partial.to(torch.float32)

        # candidate compaction: every member of the global top-K is in its
        # own shard's local top-K, so take a local top-K per model shard,
        # all-gather the (small) (n_shards · K) id/flag lists, and merge
        # with one top-K.  Scores put set bits first, lower ids first.
        n_pad = n_model * np_l
        col_id = mesh.get_local_rank(col)
        ids = torch.arange(np_l, dtype=torch.int32, device=fb.device)
        scores = fb.to(torch.int32) * (np_l + 1) - ids
        _, idx_loc = torch.topk(scores, min(top_k, np_l), dim=2,
                                sorted=True)
        flag = torch.gather(fb, 2, idx_loc)
        gid = torch.where(flag, (idx_loc + col_id * np_l).to(torch.int32),
                          -1)
        gid_all = _all_gather(gid, col_group, 2)
        flag_all = _all_gather(flag, col_group, 2)
        merged = torch.where(flag_all, n_pad - gid_all, -1)
        _, take = torch.topk(merged, top_k, dim=2, sorted=True)
        candidates = torch.gather(gid_all, 2, take)
        return ServeStepOut(fb_sizes=sizes, edge_counts=edge_counts,
                            candidates=candidates)


# ------------------------------------------------------------ host helpers
def shard_graph_arrays(dg: DeviceGraph, mesh: DeviceMesh):
    """This rank's tile of the packed graph and its label block, on the
    graph's device: ``(4, n_pad / n_rows, W / n_model)`` int32 lanes
    (contiguous; the graph's own stack where the mesh is 1 x 1) and
    ``(n_pad / n_model,)`` int32.  Raises ``ValueError`` where the model
    degree does not divide ``n_pad / 32`` or the row degree ``n_pad``."""
    row_axes, col = _axes(mesh)
    n_rows, row = 1, 0
    for a in row_axes:                   # global row block: pod-major
        n_rows, row = (n_rows * _size(mesh, a),
                       row * _size(mesh, a) + mesh.get_local_rank(a))
    n_model, model = _size(mesh, col), mesh.get_local_rank(col)
    stack = dg.stack
    for dim, n, ax in ((1, n_rows, row_axes), (2, n_model, col)):
        if stack.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(stack.shape)} does "
                             f"not divide over {n} shards of {ax}")
    rows_l, w_l = stack.shape[1] // n_rows, stack.shape[2] // n_model
    mats = stack.narrow(1, row * rows_l, rows_l).narrow(2, model * w_l, w_l)
    labels = dg.labels.narrow(0, model * 32 * w_l, 32 * w_l)
    return mats.contiguous(), labels.contiguous()
