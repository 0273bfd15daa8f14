"""The paper's own workload as an architecture: ``rig_gm``.

Shapes (the paper-technique cells, beside the ten assigned archs):

* serve_1m     — ``gm_serve_step``: a batch of 32 hybrid queries against a
                 2^20-node packed graph (double simulation x 4 + RIG stats
                 + candidate compaction) on the full mesh;
* serve_4m     — the same with a 2^22-node graph;
* closure_256k — one boolean squaring round of the reachability index
                 build at 2^18 nodes (``closure_step`` on one card: R is
                 2^18 x 2^13 lanes, 8 GiB);
* sim_pass_1m  — a single simulation pass.

``build_dryrun`` gives each shape's unit on a mesh: the steps of
:mod:`repro_torch.torchgm.distributed` (and the closure round), each run
by every rank on its own tile with explicit collectives, as the
reference's ``shard_map`` bodies are.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..dist import sharding as shd
from .base import ArchConfig, DryRunUnit, _meta, _shape, _shape_name

MAX_Q, MAX_E = 8, 16


class PatternArch(ArchConfig):
    family = "pattern"
    arch_id = "rig_gm"
    shapes = {
        "serve_1m": dict(kind="serve", n_pad=1 << 20, batch=32, passes=4),
        "serve_4m": dict(kind="serve", n_pad=1 << 22, batch=32, passes=4),
        "closure_256k": dict(kind="closure", n_pad=1 << 18),
        "sim_pass_1m": dict(kind="sim", n_pad=1 << 20, batch=32),
    }

    def smoke(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """The whole pipeline on a tiny graph: ``TorchGM`` (the simulation
        on ``bitmm``, the enumeration on ``gather_expand``) on ``device``
        (the card unless the CPU is asked for) against the host ``match``.
        ``block=128`` pads the graph as the reference's smoke does; its
        ``impl="reference"`` has no counterpart, because the port has one
        implementation (each kernel on the card, its plain version on the
        CPU)."""
        from ..core import match
        from ..data.graphs import random_labeled_graph
        from ..data.queries import random_query_from_graph
        from ..torchgm import TorchGM
        g = random_labeled_graph(60, avg_degree=2.2, n_labels=4, seed=seed)
        q = random_query_from_graph(g, 4, qtype="H", seed=seed + 1)
        dev = TorchGM(g, block=128, capacity=4096, exact_sim=True,
                      device=device).match(q)
        host = match(g, q, limit=None)
        return {"count": dev.count, "host_count": host.count,
                "finite": dev.count == host.count and not dev.overflowed}

    def build_dryrun(self, shape, mesh, *, variant: str = "baseline",
                     unroll: bool = False) -> DryRunUnit:
        """The unit of ``shape`` (a name of ``shapes`` or a dict of the
        same keys) on ``mesh``.  Variants: ``packy`` packs Y before its
        all-gather (``pack_y``); ``b128`` takes a batch of 128 queries;
        ``best`` both.  ``bk1024`` and ``scan-artifact`` (and ``unroll``)
        set the chunking of the reference's XLA blocked product
        (``block_k``, a scan or an unrolled loop), which the port replaced
        with the ``bitmm`` kernel: the port has no such knob, so those
        units equal the baseline's.

        ``serve`` / ``sim``: ``gm_serve_step`` / one pass of
        ``sharded_double_simulation`` with top-K 4,096 (a shape dict may
        set ``top_k``); the packed
        matrices' rows split over the batch axes and their lanes over
        ``model``, the labels over ``model``, the queries replicated.

        ``closure``: one round ``R' = R | (R·R > 0)`` of the packed R,
        rows over the batch axes and lanes over ``model``, in its
        simplest exact form on the ``closure_step`` kernel: all-gather R
        (lanes over ``model``, then rows over ``data`` and ``pod``), one
        ``closure_step`` of the whole R, and this rank's tile of R'.  The
        reference squares the unpacked R with a bf16 matmul that XLA
        partitions; the kernel's row-OR form needs all of R on every rank
        (row i of R' ORs the rows that row i lists), so each rank does
        the whole round's operations, and the manifest counts them as
        they are."""
        from ..torchgm import distributed as tdist
        from ..torchgm.encoding import QueryTensor

        sp = dict(_shape(self.shapes, shape))
        if variant in ("b128", "best"):
            sp["batch"] = 128
        pack_y = variant in ("packy", "best")
        n_pad = sp["n_pad"]
        name = f"{self.arch_id}:{_shape_name(shape)}"
        row_axes = shd.batch_axes(mesh)

        if sp["kind"] == "closure":
            r = _meta((n_pad, n_pad // 32), torch.int32)

            def closure_round(r_tile):
                return _closure_round(r_tile, mesh)

            return DryRunUnit(
                name=name, step_fn=closure_round, args=(r,),
                placements=(shd.placements((row_axes, "model"), mesh),),
                mesh=mesh, local=True)

        specs = tdist.graph_specs(n_pad, mesh)
        i32, b = torch.int32, sp["batch"]
        qts = QueryTensor(
            labels=_meta((b, MAX_Q), i32), edge_src=_meta((b, MAX_E), i32),
            edge_dst=_meta((b, MAX_E), i32),
            edge_kind=_meta((b, MAX_E), i32), n_nodes=_meta((b,), i32),
            n_edges=_meta((b,), i32))
        rep = shd.placements((), mesh)
        qpl = QueryTensor(labels=rep, edge_src=rep, edge_dst=rep,
                          edge_kind=rep, n_nodes=rep, n_edges=rep)

        if sp["kind"] == "sim":
            def step(mats, labels, qts):
                return tdist.sharded_double_simulation(
                    mats, labels, qts, mesh, n_passes=1, pack_y=pack_y)
        else:
            def step(mats, labels, qts):
                return tdist.gm_serve_step(
                    mats, labels, qts, mesh, n_passes=sp["passes"],
                    top_k=sp.get("top_k", 4096), pack_y=pack_y)

        return DryRunUnit(
            name=name, step_fn=step,
            args=(_meta(specs.mats.shape, specs.mats.dtype),
                  _meta(specs.labels.shape, specs.labels.dtype), qts),
            placements=(shd.placements(specs.mats.axes, mesh),
                        shd.placements(specs.labels.axes, mesh), qpl),
            mesh=mesh, local=True)

    def model_flops(self, shape) -> float:
        sp = _shape(self.shapes, shape)
        n = sp["n_pad"]
        if sp["kind"] == "closure":
            return 2.0 * n * n * n
        passes = sp.get("passes", 1)
        b = sp["batch"]
        # 4 boolean matmuls (N x N x B·max_q) per pass (+1 stats pass)
        per_pass = 4 * 2.0 * n * n * (b * MAX_Q)
        extra = 2 * 2.0 * n * n * (b * MAX_Q) if sp["kind"] == "serve" else 0
        return passes * per_pass + extra


def _closure_round(r_tile: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's tile of ``R | (R·R > 0)`` from its tile of R (rows over
    the batch axes, lanes over ``model``): the whole R all-gathered, one
    ``closure_step``, the tile cut out."""
    from ..kernels import ops
    from ..torchgm.distributed import _all_gather

    rows_l, w_l = r_tile.shape
    r = _all_gather(r_tile, mesh.get_group("model"), 1)
    for ax in reversed(shd.batch_axes(mesh)):      # data, then pod
        r = _all_gather(r, mesh.get_group(ax), 0)
    row = 0
    for ax in shd.batch_axes(mesh):                # pod-major row block
        row = row * shd.axis_size(mesh, ax) + mesh.get_local_rank(ax)
    col = mesh.get_local_rank("model")
    out = ops.closure_step(r)
    return out[row * rows_l:(row + 1) * rows_l,
               col * w_l:(col + 1) * w_l].contiguous()
