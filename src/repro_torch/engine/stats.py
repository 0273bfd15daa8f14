"""Graph- and query-level statistics feeding the planner's cost model.

``GraphStats`` is collected once per resident graph (O(n + m), cached in
the :class:`~repro_torch.engine.cache.GraphContext`); ``RigStats`` is observed
per executed query and stored in the plan cache so repeat queries can be
re-planned against measured RIG sizes instead of estimates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.graph import DataGraph
from ..core.query import CHILD, PatternQuery

__all__ = ["GraphStats", "RigStats", "EstimateRecord", "Calibration",
           "ESTIMATE_QUANTITIES"]


@dataclass
class GraphStats:
    n: int
    n_edges: int
    num_labels: int
    avg_degree: float
    max_out_degree: int
    label_counts: Dict[int, int]

    @classmethod
    def collect(cls, graph: DataGraph) -> "GraphStats":
        odeg = graph.out_degree()
        return cls(
            n=graph.n,
            n_edges=graph.n_edges,
            num_labels=graph.num_labels,
            avg_degree=graph.avg_degree,
            max_out_degree=int(odeg.max()) if graph.n else 0,
            label_counts={l: len(ix) for l, ix in graph.inverted.items()},
        )

    # ------------------------------------------------------------ estimates
    def match_set_size(self, label: int) -> int:
        """|ms(q)| = |I_label| exactly (the inverted lists are exact)."""
        return self.label_counts.get(int(label), 0)

    def reach_set_size(self) -> float:
        """Crude estimate of the average ≺-set size: a branching process
        ``d + d² + d³`` capped at n.  Good enough to rank child vs
        descendant edge costs; refined by observed RigStats on repeats."""
        d = self.avg_degree
        return float(min(self.n, d + d * d + d * d * d))

    def edge_fanout(self, kind: int) -> float:
        return self.avg_degree if kind == CHILD else self.reach_set_size()

    def estimate_cost(self, q: PatternQuery) -> float:
        """Unitless cost of matching ``q``: simulation work (sum of match
        sets, once per edge per pass) plus an expansion/enumeration term
        (per-edge occurrence estimates)."""
        ms = [self.match_set_size(l) for l in q.labels]
        sim = float(sum(ms)) * max(q.m, 1)
        expand = 0.0
        for e in q.edges:
            sel = ms[e.dst] / max(self.n, 1)          # label selectivity
            expand += ms[e.src] * self.edge_fanout(e.kind) * sel
        return sim + expand

    def estimate_cardinality(self, q: PatternQuery) -> float:
        """Occurrence-count estimate under edge independence."""
        card = 1.0
        for l in q.labels:
            card *= max(self.match_set_size(l), 0)
        for e in q.edges:
            p = self.edge_fanout(e.kind) / max(self.n, 1)
            card *= min(p, 1.0)
        return card

    def estimate_rig_nodes(self, q: PatternQuery) -> float:
        """Pre-simulation RIG node bound: Σ|ms(q_i)| (double simulation can
        only shrink the candidate sets, so this is an upper estimate)."""
        return float(sum(self.match_set_size(l) for l in q.labels))

    def estimate_rig_edges(self, q: PatternQuery) -> float:
        """Per query edge: each src candidate contributes its expected
        label-selective fanout into cos(dst), capped by |ms(dst)|."""
        ms = [self.match_set_size(l) for l in q.labels]
        total = 0.0
        for e in q.edges:
            sel = ms[e.dst] / max(self.n, 1)
            total += ms[e.src] * min(self.edge_fanout(e.kind) * sel,
                                     float(ms[e.dst]))
        return total


@dataclass
class RigStats:
    """Observed runtime-index-graph statistics for one executed query."""

    rig_nodes: int = 0
    rig_edges: int = 0
    sim_passes: int = 0
    matching_s: float = 0.0
    enumerate_s: float = 0.0
    count: int = 0
    observations: int = 0

    def observe(self, *, rig_nodes: int, rig_edges: int, sim_passes: int,
                matching_s: float, enumerate_s: float, count: int) -> None:
        self.rig_nodes = rig_nodes
        self.rig_edges = rig_edges
        self.sim_passes = sim_passes
        self.matching_s = matching_s
        self.enumerate_s = enumerate_s
        self.count = count
        self.observations += 1


#: Quantities the planner commits estimates for and execution reconciles.
ESTIMATE_QUANTITIES = ("cardinality", "rig_nodes", "rig_edges",
                       "resident_bytes")


@dataclass
class EstimateRecord:
    """Planner estimate-vs-observed accountability for one cached plan.

    Created with the plan's committed estimates; every execution records
    the observed values and yields per-quantity misestimation ratios
    (observed / estimated) for the registry histograms and the per-graph
    :class:`Calibration`.  Last-value semantics on ``obs`` (mirroring
    :class:`RigStats`), cumulative ``observations``.
    """

    est: Dict[str, float] = field(default_factory=dict)
    obs: Dict[str, float] = field(default_factory=dict)
    observations: int = 0

    def record(self, **observed: float) -> Dict[str, float]:
        """Record observed values; returns ``{quantity: obs/est}`` for
        every quantity with a positive committed estimate (a ratio of 1.0
        means the planner was exactly right)."""
        ratios: Dict[str, float] = {}
        for quantity, value in observed.items():
            if value is None:
                continue
            self.obs[quantity] = float(value)
            est = self.est.get(quantity, 0.0)
            if est > 0:
                ratios[quantity] = float(value) / est
        self.observations += 1
        return ratios

    def ratio(self, quantity: str) -> Optional[float]:
        est = self.est.get(quantity, 0.0)
        if est <= 0 or quantity not in self.obs:
            return None
        return self.obs[quantity] / est

    def rows(self) -> List[Tuple[str, float, Optional[float],
                                 Optional[float]]]:
        """``(quantity, estimate, observed, ratio)`` for rendering."""
        out = []
        for quantity in ESTIMATE_QUANTITIES:
            if quantity not in self.est and quantity not in self.obs:
                continue
            out.append((quantity, self.est.get(quantity, 0.0),
                        self.obs.get(quantity), self.ratio(quantity)))
        return out


class Calibration:
    """Per-graph misestimation medians (bounded ratio windows).

    The planner multiplies fresh estimates by the median observed
    ``obs/est`` ratio of the same quantity on the same graph, so warm
    traffic self-corrects systematic bias (e.g. the independence
    assumption under- or over-counting on this graph's label structure)
    without per-query state.  Medians are clamped to ``[0.01, 100]`` so a
    single pathological ratio cannot poison future plans.
    """

    WINDOW = 64
    CLAMP = (0.01, 100.0)

    def __init__(self) -> None:
        self._ratios: Dict[str, List[float]] = {}

    def record(self, ratios: Dict[str, float]) -> None:
        for quantity, r in ratios.items():
            win = self._ratios.setdefault(quantity, [])
            win.append(float(r))
            if len(win) > self.WINDOW:
                del win[:len(win) - self.WINDOW]

    def median(self, quantity: str) -> Optional[float]:
        win = self._ratios.get(quantity)
        if not win:
            return None
        lo, hi = self.CLAMP
        return float(min(max(np.median(win), lo), hi))

    def observations(self, quantity: str) -> int:
        return len(self._ratios.get(quantity, ()))
