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

``build_dryrun`` is not ported yet: it comes with the dry-run units of the
port (fake tensors, DTensor placements and a fake process group), designed
once for all four families.
"""

from __future__ import annotations

from typing import Any, Dict

from .base import ArchConfig

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

    def build_dryrun(self, shape: str, mesh, **_):
        raise NotImplementedError(
            f"{self.arch_id}:{shape}: the dry-run unit is not ported yet; it "
            f"comes with part 9.3 of the port (ROADMAP.md, Queue 1: the "
            f"dry-run units on fake tensors, DTensor placements and a fake "
            f"process group)")

    def model_flops(self, shape: str) -> float:
        sp = self.shapes[shape]
        n = sp["n_pad"]
        if sp["kind"] == "closure":
            return 2.0 * n * n * n
        passes = sp.get("passes", 1)
        b = sp["batch"]
        # 4 boolean matmuls (N x N x B·max_q) per pass (+1 stats pass)
        per_pass = 4 * 2.0 * n * n * (b * MAX_Q)
        extra = 2 * 2.0 * n * n * (b * MAX_Q) if sp["kind"] == "serve" else 0
        return passes * per_pass + extra
