"""TorchGM — the whole-graph GM pipeline on the card (single queries and
batches).

match(query) = encode → double simulation (four ``bitmm`` launches per
pass) → JO order → frontier MJoin.  A batch runs one simulation for all
of its members (each pass's ``bitmm`` calls take every member's FB rows at
once) and then enumerates each member; the packed graph matrices are
uploaded once, at construction, and shared.

Each result carries the phase times the serving path reports: simulation
seconds and passes (shared by a batch) and enumeration seconds, each
ending at the host read of its result (the FB sizes, the count), which
waits for the device.  The device-graph build, upload and on-device
closure are on the matcher (``build_s``, ``upload_s``, ``closure_s``,
``upload_bytes``).

With ``page_on_device`` the enumeration pages levels wider than
``capacity`` on the card instead of reporting an overflow, and stops at
``limit`` matches (``truncated``; see ``torchgm.enumerate``).  The
simulation is the ``torch.profiler`` range ``repro_torch.matcher.simulate``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..core.graph import DataGraph
from ..core.query import PatternQuery
from ..obs.trace import profiled
from . import device_graph
from .encoding import encode_batch, encode_query, jo_order
from .enumerate import decode_tuples, mjoin_count
from .frontier import resolve
from .simulation import fb_sizes, rig_edge_counts, simulate


@dataclass
class TorchMatchResult:
    count: int
    overflowed: bool
    fb_sizes: np.ndarray          # |cos(q)| per query node
    tuples: Optional[np.ndarray] = None
    sim_s: float = 0.0            # double simulation (a batch's, shared)
    sim_passes: int = 0
    enumerate_s: float = 0.0      # this query's MJoin
    truncated: bool = False       # paged: the count stopped at the limit


class TorchGM:
    """Whole-graph device matcher bound to one data graph, on ``device``
    (resolved as the executors resolve it: the card unless the CPU is
    pinned; without CUDA and without a pin, construction raises).  With
    ``closure_on_device`` the reachability matrices are squared out of the
    adjacency on the device (``closure_step``) instead of being built by
    the host reachability index.  ``limit`` and ``page_on_device`` go to
    the enumerator (:func:`~repro_torch.torchgm.enumerate.mjoin_count`);
    paging needs ``capacity`` >= the padded node count."""

    def __init__(self, graph: DataGraph, *, max_q: int = 8, max_e: int = 16,
                 block: int = 512, capacity: int = 4096, n_passes: int = 4,
                 exact_sim: bool = False, closure_on_device: bool = False,
                 use_transitive_reduction: bool = True, device=None,
                 limit: Optional[int] = None, page_on_device: bool = False):
        self.device = resolve(device)
        self.graph = graph
        self.max_q, self.max_e = max_q, max_e
        self.capacity, self.n_passes = capacity, n_passes
        self.limit, self.page_on_device = limit, page_on_device
        self.exact_sim = exact_sim
        self.use_tr = use_transitive_reduction
        self.dg = device_graph.from_host(graph, block=block,
                                         closure_on_device=closure_on_device,
                                         device=self.device)
        self.build_s = self.dg.build_s
        self.upload_s = self.dg.upload_s
        self.closure_s = self.dg.closure_s
        self.upload_bytes = self.dg.nbytes

    def _prep(self, q: PatternQuery):
        if self.use_tr:
            q = q.transitive_reduction()
        return q, encode_query(q, self.max_q, self.max_e)

    def _simulate(self, qt):
        t0 = time.perf_counter()
        with profiled("matcher.simulate"):
            fb, passes = simulate(self.dg, qt, n_passes=self.n_passes,
                                  exact=self.exact_sim)
            sizes = fb_sizes(fb).cpu()
        return fb, sizes, passes, time.perf_counter() - t0

    def _enumerate(self, qt, fb, sizes, materialize: bool):
        t0 = time.perf_counter()
        order = jo_order(qt, sizes)
        res = mjoin_count(self.dg, qt, fb, order, capacity=self.capacity,
                          materialize=materialize, limit=self.limit,
                          page_on_device=self.page_on_device)
        count, overflowed = int(res.count), bool(res.overflowed)
        return res, order, count, overflowed, time.perf_counter() - t0

    def match(self, q: PatternQuery,
              materialize: bool = False) -> TorchMatchResult:
        q, qt = self._prep(q)
        fb, sizes, passes, sim_s = self._simulate(qt)
        res, order, count, overflowed, enum_s = self._enumerate(
            qt, fb, sizes, materialize)
        tuples = decode_tuples(res, order, q.n) if materialize else None
        return TorchMatchResult(count=count, overflowed=overflowed,
                                fb_sizes=sizes.numpy()[:q.n], tuples=tuples,
                                sim_s=sim_s, sim_passes=passes,
                                enumerate_s=enum_s, truncated=res.truncated)

    def match_batch(self, queries: Sequence[PatternQuery]
                    ) -> List[TorchMatchResult]:
        prepped = [self._prep(q)[0] for q in queries]
        qts = encode_batch(prepped, self.max_q, self.max_e)
        fb, sizes, passes, sim_s = self._simulate(qts)
        out = []
        for i, q in enumerate(prepped):
            qt = encode_query(q, self.max_q, self.max_e)
            res, _, count, overflowed, enum_s = self._enumerate(
                qt, fb[i], sizes[i], materialize=False)
            out.append(TorchMatchResult(
                count=count, overflowed=overflowed,
                fb_sizes=sizes[i].numpy()[:q.n], sim_s=sim_s,
                sim_passes=passes, enumerate_s=enum_s,
                truncated=res.truncated))
        return out

    def rig_stats(self, q: PatternQuery):
        """(fb sizes, per-edge RIG edge counts) — Fig. 9 statistics."""
        q, qt = self._prep(q)
        fb, sizes, _, _ = self._simulate(qt)
        edges = rig_edge_counts(self.dg, qt, fb).cpu().numpy()
        return sizes.numpy()[:q.n], edges[:q.m]
