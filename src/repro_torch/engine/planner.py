"""Query planner: canonical form -> backend / algorithm / check-method.

The matcher core exposes several interchangeable execution choices that the
paper ablates (Figs. 8-11); the planner picks them per query from
:class:`~repro_torch.engine.stats.GraphStats` instead of hard-coding one variant:

* **backend** — host ``GM`` (``repro_torch.core``) vs device ``TorchGM``
  (``repro_torch.torchgm``).  The device pipeline pays a dispatch overhead
  and works on padded tensors, so it wins on large resident graphs and
  batch traffic; small graphs and over-wide queries stay on the host.
* **simulation algorithm** — ``bas`` for trivially small patterns (the
  Dag+Δ bookkeeping costs more than it saves), ``dagmap`` otherwise
  (Fig. 8(b): change-flag skipping is the best variant).
* **check method** — ``bitbat`` (batched bitset ops) unless the graph is so
  large and the match sets so sparse that per-candidate ``bititer`` touches
  fewer words.
* **ordering** — ``jo`` (the paper's default search ordering).
* **enum method** — ``backtrack`` (one tuple at a time, constant space) vs
  ``frontier`` (batched level-synchronous enumeration) vs
  ``frontier-device`` (frontier with the AND+popcount step on the
  ``intersect`` CUDA kernel) vs ``frontier-device-resident`` (the RIG
  adjacency uploaded once and both gather+AND and pair expansion on
  device, host ships only index vectors — picked when the estimated
  resident footprint fits ``DeviceCaps.resident_max_bytes``).  Frontier
  wins when the enumeration visits many partial assignments; tiny answer
  sets stay on backtracking.

Plans are cached by canonical query key; on repeat executions the observed
``RigStats`` re-plan the backend *and* the enum method (e.g. a query whose
RIG collapsed to a few nodes is cheaper on the host even on a big graph; a
query observed to enumerate many results moves to the frontier path).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

from ..core.matcher import GMOptions
from ..core.mjoin import DEFAULT_LIMIT
from ..core.query import PatternQuery
from ..core.slabgeom import round_up
from .stats import Calibration, EstimateRecord, GraphStats, RigStats

__all__ = ["DeviceCaps", "Plan", "Planner"]

HOST = "host"
DEVICE = "device"


@dataclass(frozen=True)
class DeviceCaps:
    """Static limits of the device matcher (query padding + frontier)."""

    max_q: int = 8
    max_e: int = 16
    capacity: int = 4096
    min_graph_nodes: int = 512    # below this, dispatch overhead dominates
    frontier_device: bool = False  # route frontier ANDs through the kernel
    # device-memory budget for a resident RIG upload; a frontier-device
    # query whose estimated packed adjacency fits stays fully on device
    # (frontier-device-resident), larger ones ship per-level slabs
    resident_max_bytes: int = 1 << 30


@dataclass
class Plan:
    backend: str                   # "host" | "device"
    sim_algo: str                  # bas | dag | dagmap | none
    check_method: str              # binsearch | bititer | bitbat
    ordering: str = "jo"
    enum_method: str = "backtrack"  # see repro_torch.core.mjoin.ENUM_METHODS
    sim_passes: Optional[int] = 4
    chunk_size: int = 1024         # streaming chunk rows (execute_stream)
    # device slabs below this row count are host-routed (padded dispatch
    # floor); set for device enum methods, 0 for host methods
    small_frontier_rows: int = 0
    est_cost: float = 0.0
    est_card: float = 0.0
    # committed size estimates: reconciled against observed values
    # by the engine's EstimateRecord, audited via Engine.explain_analyze
    est_rig_nodes: float = 0.0
    est_rig_edges: float = 0.0
    est_resident_bytes: int = 0
    reasons: Tuple[str, ...] = ()

    def estimates(self) -> dict:
        """The committed estimates, keyed like ESTIMATE_QUANTITIES."""
        return {"cardinality": self.est_card,
                "rig_nodes": self.est_rig_nodes,
                "rig_edges": self.est_rig_edges,
                "resident_bytes": float(self.est_resident_bytes)}

    def batch_group(self) -> str:
        """Execution lane for cross-request batching in ``execute_many``:
        requests in the same lane on the same resident graph share one
        dispatch (batched device matcher / fused frontier slabs).  The
        resident enumerator shares the frontier-device lane — batching is
        per-level either way, only the slab transport differs."""
        if self.backend == DEVICE:
            return "device"
        if self.enum_method in ("frontier-device", "frontier-device-resident"):
            return "frontier-device"
        return "host"

    def gm_options(self, *, limit: Optional[int] = DEFAULT_LIMIT,
                   materialize: bool = False,
                   max_tuples: int = 1_000_000,
                   budget=None, breaker=None) -> GMOptions:
        """Host-matcher options realizing this plan.  The engine hands the
        matcher an already-reduced query, so TR is off here; ``budget`` /
        ``breaker`` carry the engine's per-query governance down into the
        matcher (see :mod:`repro_torch.robust`)."""
        return GMOptions(use_transitive_reduction=False,
                         sim_algo=self.sim_algo, sim_passes=self.sim_passes,
                         check_method=self.check_method,
                         ordering=self.ordering,
                         enum_method=self.enum_method, limit=limit,
                         materialize=materialize, max_tuples=max_tuples,
                         small_frontier_rows=self.small_frontier_rows,
                         budget=budget, breaker=breaker)

    def explain(self) -> str:
        why = "; ".join(self.reasons) if self.reasons else "defaults"
        return (f"backend={self.backend} sim={self.sim_algo} "
                f"check={self.check_method} order={self.ordering} "
                f"enum={self.enum_method} "
                f"est_cost={self.est_cost:.3g} est_card={self.est_card:.3g} "
                f"[{why}]")


# The cost (in the unitless GraphStats scale) below which a repeat query's
# observed RIG makes host enumeration a sure win over a device dispatch.
TINY_RIG_NODES = 64
# Sparse-match-set threshold for preferring per-candidate iteration over
# whole-matrix batched bitset checks.
SPARSE_GRAPH_NODES = 1 << 16
SPARSE_MS_FRACTION = 1e-3
# Estimated-answer-set size above which the batched frontier enumerator
# beats one-tuple-at-a-time backtracking on the first execution ...
FRONTIER_EST_RESULTS = 4096
# ... and observed RIG/result sizes that re-pick it on repeat executions.
FRONTIER_RIG_NODES = 512
FRONTIER_MIN_RESULTS = 2048
# Streaming chunk-size bounds: small answer sets stream in small chunks
# (low first-chunk latency), large ones in big chunks (amortized rechunk
# and conversion overhead).
STREAM_CHUNK_MIN = 64
STREAM_CHUNK_MAX = 8192
STREAM_TARGET_CHUNKS = 16          # aim for ~this many chunks per result set
# Device slabs below this many rows lose to the host intersect: the device
# pads every dispatch to a >= 128-row tile (see repro_torch.core.slabgeom), so a
# handful of real rows pays the full floor (BENCH_mjoin small-slab rows).
SMALL_FRONTIER_HOST_ROWS = 128


class Planner:
    def __init__(self, stats: GraphStats, caps: Optional[DeviceCaps] = None,
                 force_backend: Optional[str] = None,
                 force_enum: Optional[str] = None):
        self.stats = stats
        self.caps = caps or DeviceCaps()
        self.force_backend = force_backend
        self.force_enum = force_enum
        # per-graph misestimation medians (the planner is per resident
        # graph): the engine records observed/estimated ratios here and
        # plan()/refine() scale fresh estimates by them, so warm traffic
        # self-corrects systematic estimator bias
        self.calibration = Calibration()

    # ------------------------------------------------------------- backend
    def _pick_backend(self, q: PatternQuery,
                      reasons: List[str]) -> str:
        if self.force_backend is not None:
            reasons.append(f"backend forced to {self.force_backend}")
            return self.force_backend
        if q.n > self.caps.max_q or q.m > self.caps.max_e:
            reasons.append(
                f"query ({q.n} nodes / {q.m} edges) exceeds device caps "
                f"({self.caps.max_q}/{self.caps.max_e})")
            return HOST
        if self.stats.n < self.caps.min_graph_nodes:
            reasons.append(
                f"graph ({self.stats.n} nodes) below device threshold "
                f"({self.caps.min_graph_nodes}): dispatch overhead dominates")
            return HOST
        reasons.append("query fits device caps and graph is large")
        return DEVICE

    # ------------------------------------------------------------ sim algo
    def _pick_sim(self, q: PatternQuery, reasons: List[str]) -> str:
        if q.m <= 2:
            reasons.append("tiny pattern: FBSimBas (no Dag+Δ bookkeeping)")
            return "bas"
        reasons.append("dagmap simulation (change-flag convergence)")
        return "dagmap"

    # -------------------------------------------------------- check method
    def _pick_check(self, q: PatternQuery, reasons: List[str]) -> str:
        ms = [self.stats.match_set_size(l) for l in q.labels]
        avg_ms = sum(ms) / max(len(ms), 1)
        if (self.stats.n > SPARSE_GRAPH_NODES
                and avg_ms < SPARSE_MS_FRACTION * self.stats.n):
            reasons.append("huge graph + sparse match sets: bititer")
            return "bititer"
        reasons.append("bitbat batch checking")
        return "bitbat"

    # --------------------------------------------------------- enum method
    def _est_resident_bytes(self, q: PatternQuery) -> int:
        """Upper estimate of the packed RIG adjacency a resident upload
        would pin on device: cos sizes bounded by the exact match-set
        sizes, lane width padded as :func:`pack_resident_rig` pads it."""
        ms = [self.stats.match_set_size(l) for l in q.labels]
        w_lanes = round_up(max((max(ms, default=0) + 31) // 32, 128), 128)
        rows = 1 + sum(ms[e.src] + ms[e.dst] for e in q.edges)
        return rows * w_lanes * 4

    def _calibrated(self, quantity: str, est: float,
                    reasons: Optional[List[str]] = None) -> float:
        """Scale a fresh estimate by the graph's observed misestimation
        median for the same quantity (identity while cold)."""
        r = self.calibration.median(quantity)
        if r is None or r == 1.0:
            return est
        if reasons is not None:
            reasons.append(
                f"{quantity} estimate calibrated x{r:.3g} (median of "
                f"{self.calibration.observations(quantity)} observed "
                f"ratios)")
        return est * r

    def _frontier_kind(self, q: PatternQuery,
                       reasons: Optional[List[str]] = None) -> str:
        if not self.caps.frontier_device:
            return "frontier"
        est = int(self._calibrated("resident_bytes",
                                   self._est_resident_bytes(q), reasons))
        if est <= self.caps.resident_max_bytes:
            if reasons is not None:
                reasons.append(
                    f"estimated resident RIG ({est} B) fits device budget "
                    f"({self.caps.resident_max_bytes} B): index stays "
                    f"on device")
            return "frontier-device-resident"
        if reasons is not None:
            reasons.append(
                f"estimated resident RIG ({est} B) exceeds device budget "
                f"({self.caps.resident_max_bytes} B): per-level slabs")
        return "frontier-device"

    def _pick_enum(self, q: PatternQuery, reasons: List[str],
                   est_card: Optional[float] = None) -> str:
        if self.force_enum is not None:
            reasons.append(f"enum method forced to {self.force_enum}")
            return self.force_enum
        if est_card is None:
            est_card = self.stats.estimate_cardinality(q)
        if est_card >= FRONTIER_EST_RESULTS:
            reasons.append(
                f"estimated answer set >= {FRONTIER_EST_RESULTS}: "
                f"batched frontier enumeration")
            return self._frontier_kind(q, reasons)
        reasons.append("small estimated answer set: backtracking enumeration")
        return "backtrack"

    # ----------------------------------------------------------- chunk size
    def pick_chunk_size(self, expected_results: float) -> int:
        """Streaming chunk rows for an (estimated or observed) result count:
        the power of two nearest ``expected / STREAM_TARGET_CHUNKS``,
        clamped to [STREAM_CHUNK_MIN, STREAM_CHUNK_MAX]."""
        target = max(expected_results, 1.0) / STREAM_TARGET_CHUNKS
        c = STREAM_CHUNK_MIN
        while c < target and c < STREAM_CHUNK_MAX:
            c *= 2
        return c

    # ----------------------------------------------------------------- API
    def plan(self, q: PatternQuery) -> Plan:
        """Plan an (already transitively-reduced) query."""
        reasons: List[str] = []
        backend = self._pick_backend(q, reasons)
        sim = self._pick_sim(q, reasons)
        check = self._pick_check(q, reasons)
        est_card = self._calibrated(
            "cardinality", self.stats.estimate_cardinality(q), reasons)
        enum = self._pick_enum(q, reasons, est_card)
        return Plan(backend=backend, sim_algo=sim, check_method=check,
                    enum_method=enum,
                    chunk_size=self.pick_chunk_size(est_card),
                    small_frontier_rows=(
                        SMALL_FRONTIER_HOST_ROWS
                        if enum in ("frontier-device",
                                    "frontier-device-resident") else 0),
                    est_cost=self.stats.estimate_cost(q),
                    est_card=est_card,
                    est_rig_nodes=self.stats.estimate_rig_nodes(q),
                    est_rig_edges=self.stats.estimate_rig_edges(q),
                    est_resident_bytes=self._est_resident_bytes(q),
                    reasons=tuple(reasons))

    def refine(self, plan: Plan, q: PatternQuery,
               rig: RigStats) -> Plan:
        """Re-plan from observed RIG statistics (repeat executions)."""
        if rig.observations:
            # observed result counts re-pick the streaming chunk size
            chunk = self.pick_chunk_size(rig.count)
            if chunk != plan.chunk_size:
                plan = replace(plan, chunk_size=chunk)
        if self.force_backend is not None:
            return plan
        if (plan.backend == DEVICE and rig.observations
                and rig.rig_nodes <= TINY_RIG_NODES):
            plan = replace(
                plan, backend=HOST,
                reasons=plan.reasons + (
                    f"observed RIG has {rig.rig_nodes} nodes "
                    f"(<= {TINY_RIG_NODES}): host enumeration wins",))
        if self.force_enum is not None:
            return plan
        if rig.observations and plan.enum_method == "backtrack" and (
                rig.rig_nodes >= FRONTIER_RIG_NODES
                or rig.count >= FRONTIER_MIN_RESULTS):
            kind = self._frontier_kind(q)
            plan = replace(
                plan, enum_method=kind,
                small_frontier_rows=(SMALL_FRONTIER_HOST_ROWS
                                     if kind != "frontier" else 0),
                reasons=plan.reasons + (
                    f"observed RIG has {rig.rig_nodes} nodes / "
                    f"{rig.count} results: frontier enumeration",))
        elif (rig.observations
              and plan.enum_method in ("frontier", "frontier-device",
                                       "frontier-device-resident")
              and rig.rig_nodes < TINY_RIG_NODES
              and rig.count < FRONTIER_MIN_RESULTS):
            plan = replace(
                plan, enum_method="backtrack", small_frontier_rows=0,
                reasons=plan.reasons + (
                    f"observed tiny RIG ({rig.rig_nodes} nodes, "
                    f"{rig.count} results): backtracking wins",))
        return plan

    def analyze(self, plan: Plan, q: PatternQuery,
                est: EstimateRecord) -> List[Tuple[str, str, str, bool]]:
        """Which planner decisions would flip under observed stats.

        Returns ``(decision, planned, under_observed, flips)`` rows for the
        backend, the enum method, and resident eligibility, re-evaluating
        each decision rule with the :class:`EstimateRecord`'s observed
        values in place of the estimates (the same rules ``refine`` applies
        on warm traffic).  Forced choices never flip.
        """
        obs = est.obs
        rig_nodes = obs.get("rig_nodes")
        count = obs.get("cardinality")
        rows: List[Tuple[str, str, str, bool]] = []

        backend = plan.backend
        if (self.force_backend is None and backend == DEVICE
                and rig_nodes is not None
                and rig_nodes <= TINY_RIG_NODES):
            backend = HOST
        rows.append(("backend", plan.backend, backend,
                     backend != plan.backend))

        enum = plan.enum_method
        if self.force_enum is None and rig_nodes is not None \
                and count is not None:
            if enum == "backtrack" and (rig_nodes >= FRONTIER_RIG_NODES
                                        or count >= FRONTIER_MIN_RESULTS):
                enum = self._frontier_kind(q)
            elif (enum != "backtrack" and rig_nodes < TINY_RIG_NODES
                  and count < FRONTIER_MIN_RESULTS):
                enum = "backtrack"
        rows.append(("enum_method", plan.enum_method, enum,
                     enum != plan.enum_method))

        if self.caps.frontier_device:
            cap = self.caps.resident_max_bytes
            planned_fit = plan.est_resident_bytes <= cap
            observed = obs.get("resident_bytes")
            obs_fit = (observed <= cap) if observed else planned_fit
            rows.append((
                "resident_eligibility",
                f"est {plan.est_resident_bytes} B "
                f"{'<=' if planned_fit else '>'} cap {cap} B",
                (f"observed {int(observed)} B "
                 f"{'<=' if obs_fit else '>'} cap {cap} B"
                 if observed else "no resident execution observed"),
                obs_fit != planned_fit))
        return rows
