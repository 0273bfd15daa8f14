"""Pattern-query server — the paper-kind end-to-end application.

A batched query server over one resident data graph, driven through the
``repro_torch.engine`` subsystem: requests (textual queries or ``PatternQuery``
objects) arrive, are micro-batched, planned per query (device matcher for
fitting queries, host GM for over-wide ones) and answered with counts.
Production behaviours:

* **request journal** — every request is journaled before dispatch; a worker
  failure (the ``journal_dispatch`` fault site, or an engine-level
  transient) re-dispatches from the journal.  The RIG is runtime state (the
  paper's key property), so recovery is recompute, not state repair;
* **bounded retries** — a request is re-dispatched at most ``max_attempts``
  times; one that keeps failing goes terminal (``status="failed"``,
  ``server_failed`` counter) instead of looping forever;
* **straggler mitigation** — per-batch deadline (monotonic clock); batches
  that blow the deadline are split and retried;
* **admission control** — malformed query text is rejected at submit with
  the parser's error message; ``queue_limit`` bounds the journal backlog
  (excess submissions are rejected with an :class:`AdmissionError`
  message); over-wide queries are not rejected but planned onto the host;
* **resource governance** — an optional per-request
  :class:`~repro_torch.robust.Budget` template rides into the engine: deadline
  partials are served as terminal results (retrying the same budget would
  blow the same deadline), transient failures are re-dispatched;
* **cross-query caching** — the engine's per-graph label cache means the
  reachability index is built once at server start, and its plan cache
  means repeat query shapes skip planning;
* **observability** — ``profile=True`` records one lifecycle span tree per
  request (``Request.trace``); server counters live in the engine's
  metrics registry (``server_*`` series), so ``metrics_text()`` is one
  Prometheus-style dump covering engine, caches and server.  The engine's
  always-on serving telemetry rides along: every request (and every
  server-side rejection / journal re-dispatch / give-up) lands in the
  bounded flight recorder, ``--stats-interval N`` prints a windowed
  QPS/p50/p95/p99/error-rate line every N seconds, and ``--flight-dump
  PATH`` writes the JSONL dump at exit (incident auto-dumps — breaker
  open, deadline-rate spike — are armed to the same path).

The device-planned queries run on the card through the whole-graph
matcher (``repro_torch.torchgm.TorchGM``, its double simulation on the
``bitmm`` CUDA kernel).  ``--device cpu`` runs everything on the CPU with
the kernels' plain PyTorch versions; without CUDA and without
``--device cpu`` the server raises.

Usage:
  python -m repro_torch.launch.serve --n-queries 64 --graph-nodes 2000 \
      [--deadline-ms 50] [--profile] [--metrics] [--device cpu] \
      [--stats-interval 2] [--flight-dump FLIGHT_serve.jsonl]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from ..core.query import PatternQuery
from ..data.graphs import random_labeled_graph
from ..data.queries import random_query_from_graph
from ..engine import Engine, EngineOptions, QueryParseError, render_trace
from ..engine.engine import _CounterView
from ..obs import ServerEvent, Span
from ..robust import Budget, InjectedFault, TransientError, faults
from ..torchgm import frontier

_SERVER_COUNTERS = ("served", "redispatched", "rejected", "failed",
                    "host_fallback")

# terminal request states (everything else re-enters the pending pool)
_TERMINAL = ("done", "failed")


@dataclass
class Request:
    rid: int
    query: PatternQuery
    # monotonic, never wall clock: an NTP step must not age the queue
    submitted: float = field(default_factory=time.monotonic)
    attempts: int = 0
    done: bool = False
    status: str = "queued"          # queued | done | failed
    outcome: str = ""               # engine status of the served result
    count: Optional[int] = None
    overflowed: bool = False
    backend: str = ""
    error: str = ""                 # last failure detail (retries, give-up)
    trace: Optional[Span] = None    # lifecycle span tree (profiling servers)


class QueryServer:
    def __init__(self, graph, *, max_q=8, max_e=16, batch_size=16,
                 capacity=4096, deadline_s=30.0, max_attempts=3,
                 engine: Optional[Engine] = None,
                 profile: bool = False, budget: Optional[Budget] = None,
                 queue_limit: Optional[int] = None,
                 tenant: Optional[str] = None):
        self.graph = graph
        # ledger attribution: every device transfer/allocation this graph
        # causes is charged under its key — a caller-supplied tenant name
        # makes ``ledger_rollup()`` a per-tenant accounting surface
        # (pre-stamped before engine registration, which would otherwise
        # assign an anonymous epoch key)
        if tenant is not None:
            graph.graph_key = tenant
        self.tenant = getattr(graph, "graph_key", None)
        # device_min_nodes=0: this is the device-serving path, so
        # any query that fits the device caps goes through the batched
        # matcher regardless of graph size; wide queries plan onto the host.
        self.engine = engine or Engine(graph, options=EngineOptions(
            max_q=max_q, max_e=max_e, capacity=capacity, device_min_nodes=0,
            exact_sim=True, materialize=False))
        self.batch_size = batch_size
        self.deadline_s = deadline_s
        self.max_attempts = max_attempts
        self.profile = profile
        self.budget = budget            # per-request template (armed by the
        self.queue_limit = queue_limit  # engine for each batch member)
        self.journal: Dict[int, Request] = {}
        self.rejected: Dict[int, str] = {}      # rid -> rejection message
        # server counters share the engine's registry (series server_*), so
        # one metrics dump covers the whole serving stack; the dict-style
        # surface (stats["served"] += 1) is unchanged
        self.stats = _CounterView(self.engine.metrics,
                                  names=_SERVER_COUNTERS, prefix="server_")
        # server-side lifecycle actions (rejections, journal re-dispatches,
        # terminal give-ups) land in the engine's flight recorder next to
        # the per-request query events, so one dump tells the whole story
        self.flight = self.engine.flight

    def metrics_text(self) -> str:
        """Prometheus-style dump of engine + cache + server series."""
        return self.engine.metrics_text()

    def ledger_rollup(self) -> Dict[str, int]:
        """This tenant's device-memory/transfer account: cumulative h2d
        and d2h bytes charged under the served graph's ledger key, its
        live device-resident footprint, and that footprint's watermark."""
        key = self.tenant or getattr(self.graph, "graph_key", None)
        return self.engine.ledger.rollup(key if key else "-")

    def stats_line(self) -> str:
        """One windowed-telemetry summary line (QPS, error rate,
        p50/p95/p99 of total latency) from the engine's sliding windows."""
        return self.engine.windows.summary_line()

    def _record_server_event(self, action: str, r: "Request",
                             detail: str = "") -> None:
        if self.engine.telemetry:
            self.flight.record(ServerEvent(action=action, rid=r.rid,
                                           attempts=r.attempts,
                                           detail=detail or r.error))

    def submit(self, rid: int, query: Union[str, PatternQuery]) -> bool:
        """Journal a request.  Admission control happens here: malformed
        query text is rejected with the caret-annotated parse error, and a
        full queue (``queue_limit`` pending requests) rejects rather than
        buffering unboundedly — both recorded in ``self.rejected[rid]``."""
        if (self.queue_limit is not None
                and len(self._pending()) >= self.queue_limit):
            self.rejected[rid] = (f"queue full ({self.queue_limit} pending "
                                  f"requests); resubmit later")
            self.stats["rejected"] += 1
            if self.engine.telemetry:
                self.flight.record(ServerEvent(action="reject", rid=rid,
                                               detail=self.rejected[rid]))
            return False
        if isinstance(query, str):
            try:
                query = self.engine.parse(query)
            except QueryParseError as e:
                self.rejected[rid] = str(e)
                self.stats["rejected"] += 1
                if self.engine.telemetry:
                    self.flight.record(ServerEvent(action="reject", rid=rid,
                                                   detail="parse error"))
                return False
        self.journal[rid] = Request(rid=rid, query=query)
        return True

    def _pending(self) -> List[Request]:
        """Live requests, marking give-ups terminal as a side effect: a
        request whose attempts are spent becomes ``status="failed"``
        (``server_failed``) instead of circulating forever."""
        out = []
        for r in self.journal.values():
            if r.status in _TERMINAL:
                continue
            if r.attempts >= self.max_attempts:
                r.status = "failed"
                r.error = (r.error
                           or f"gave up after {r.attempts} attempt(s)")
                self.stats["failed"] += 1
                self._record_server_event("failed", r)
                continue
            out.append(r)
        return out

    def step(self, fail: bool = False) -> int:
        """Serve one micro-batch; ``fail=True`` (or a ``journal_dispatch``
        injected fault) simulates a worker dying mid-batch — the requests
        stay journaled, the attempt is spent, and the next step
        re-dispatches them."""
        batch = self._pending()[:self.batch_size]
        if not batch:
            return 0
        for r in batch:
            r.attempts += 1
        if fail:                              # worker loss: nothing returns
            self.stats["redispatched"] += len(batch)
            for r in batch:
                self._record_server_event("redispatch", r,
                                          detail="simulated worker loss")
            return 0
        try:
            faults.maybe_fail("journal_dispatch")
        except InjectedFault as e:            # simulated worker death
            for r in batch:
                r.error = str(e)
                self._record_server_event("redispatch", r)
            self.stats["redispatched"] += len(batch)
            return 0
        t0 = time.monotonic()
        try:
            results = self.engine.execute_many(
                [r.query for r in batch], profile=self.profile,
                budget=self.budget)
        except TransientError as e:
            # an engine-level transient lost the whole batch: requests are
            # still journaled, so the next step recomputes them
            for r in batch:
                r.error = str(e)
                self._record_server_event("redispatch", r)
            self.stats["redispatched"] += len(batch)
            return 0
        dt = time.monotonic() - t0
        if dt > self.deadline_s and len(batch) > 1:
            # straggler batch: split next time.  A deadline miss is a
            # re-dispatch, not a lost attempt (the results were produced,
            # just late — e.g. a cold-start compile), so roll attempts back.
            self.batch_size = max(1, self.batch_size // 2)
            self.stats["redispatched"] += len(batch)
            for r in batch:
                r.attempts -= 1
                self._record_server_event("redispatch", r,
                                          detail="straggler batch split")
            return 0
        served = 0
        for r, res in zip(batch, results):
            st = res.stats.status
            if st == "transient":
                # the engine exhausted its own recompute attempts for this
                # request; spend a server attempt and try again (or go
                # terminal once max_attempts is hit)
                r.error = "transient engine failure"
                self.stats["redispatched"] += 1
                self._record_server_event("redispatch", r)
                continue
            # everything else — including a deadline partial — is terminal:
            # re-running the same budget would blow the same deadline
            r.count = res.count
            r.overflowed = res.stats.overflow_fallback
            r.backend = res.stats.backend
            r.outcome = st
            r.trace = res.trace
            if res.stats.overflow_fallback:
                self.stats["host_fallback"] += 1
            r.done = True
            r.status = "done"
            self.stats["served"] += 1
            served += 1
        return served

    def drain(self, max_rounds: int = 100) -> None:
        for _ in range(max_rounds):
            if not self._pending():
                break
            self.step()
        self._pending()       # final sweep: mark any give-ups terminal


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph-nodes", type=int, default=1000)
    ap.add_argument("--n-queries", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request budget deadline in ms (0 = none)")
    ap.add_argument("--profile", action="store_true",
                    help="record and print one lifecycle span tree "
                         "per request")
    ap.add_argument("--metrics", action="store_true",
                    help="print the Prometheus-style metrics dump "
                         "after draining")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="print a windowed QPS/p50/p95/p99/error-rate "
                         "summary line every N seconds while serving "
                         "(0 = off)")
    ap.add_argument("--flight-dump", default=None, metavar="PATH",
                    help="dump the flight recorder (per-request event "
                         "records + tail-sampled exemplars) as JSONL "
                         "after draining; incident auto-dumps are armed "
                         "to the same path while serving")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the current CUDA "
                         "card; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args()
    if args.device:
        frontier.DEFAULT_DEVICE = args.device
    frontier.resolve()            # no CUDA and no --device cpu: raise now

    graph = random_labeled_graph(args.graph_nodes, avg_degree=3.0,
                                 n_labels=8, seed=args.seed)
    budget = (Budget(deadline_s=args.deadline_ms / 1000.0, max_attempts=2)
              if args.deadline_ms > 0 else None)
    server = QueryServer(graph, batch_size=args.batch_size,
                         profile=args.profile, budget=budget)
    if args.flight_dump:
        server.flight.arm_autodump(args.flight_dump)
    qtypes = ["C", "H", "D"]
    n = 0
    for i in range(args.n_queries):
        q = random_query_from_graph(graph, 3 + i % 3, qtype=qtypes[i % 3],
                                    seed=args.seed + i)
        n += int(server.submit(i, q))
    t0 = time.monotonic()
    next_stats = (t0 + args.stats_interval if args.stats_interval > 0
                  else None)
    for _ in range(100):                      # bounded drain with stats
        if not server._pending():
            break
        server.step()
        now = time.monotonic()
        if next_stats is not None and now >= next_stats:
            print(f"[serve] {server.stats_line()}")
            next_stats = now + args.stats_interval
    server.drain()                            # final sweep / give-ups
    dt = time.monotonic() - t0
    if args.stats_interval > 0:
        print(f"[serve] {server.stats_line()}")
    counts = [server.journal[i].count for i in sorted(server.journal)]
    print(f"[serve] {n} queries in {dt:.2f}s "
          f"({n / max(dt, 1e-9):.1f} qps) stats={server.stats} "
          f"engine={server.engine.cache_info()}")
    print(f"[serve] counts: {counts[:10]}{'...' if len(counts) > 10 else ''}")
    if args.profile:
        for rid in sorted(server.journal):
            r = server.journal[rid]
            if r.trace is not None:
                print(f"[serve] --- request {rid} ---")
                print(render_trace(r.trace))
    if args.metrics:
        print("[serve] --- metrics ---")
        print(server.metrics_text())
    if args.flight_dump:
        lines = server.flight.dump_jsonl(args.flight_dump, reason="exit")
        print(f"[serve] wrote flight-recorder dump: {args.flight_dump} "
              f"({lines} lines, {server.flight.recorded} recorded)")


if __name__ == "__main__":
    main()
