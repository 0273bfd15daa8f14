"""Driver of the served path: the port's ``QueryServer`` over an
``Engine`` whose device lane (``TorchGM``: the double simulation on
``bitmm``, the MJoin on ``gather_expand``) pages wide levels on the card
and stops at the configuration's limit (``EngineOptions.page_on_device``).

Set-up builds the data set and the query pool as the filter's driver does
(the same graph, the same traffic seed and stream), the engine and the
server, the graph's label structures, and serves the warm-up pool.  The
window is a closed loop with one batch in flight: it submits the next
``batch`` requests of the run's order and steps the server until every
one of them is terminal.  A request's latency runs from its submission to
the end of the step that finished it; a request that ends other than
``done`` is failed.

The check holds every request the window served to the plain reference
(:mod:`perfbench.reference.counts`): the reference counts each distinct
pool query served once, as ``min(count, limit)``, and every served
request of that query must give that count, with ``truncated`` set exactly
where the reference reached the limit; every served count is at most the
limit; no request is re-dispatched.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import work
from ..bench import Window
from .common import KernelWork, POOL, WARMUP, make_graph, make_pool, order


@dataclass
class State:
    seed: int
    device: object
    config: dict
    raw: object
    engine: object
    server: object
    pool: list
    pool_pq: list
    order: list = field(default_factory=list)
    next: int = 0
    rid: int = 0
    # (pool index, served count, truncated) of every request served done
    served: List[tuple] = field(default_factory=list)
    not_done: int = 0
    work: Optional["GatherWork"] = None
    bitmm: Optional[KernelWork] = None
    # program counters at the window's start and end
    marks: List[dict] = field(default_factory=list)


class GatherWork:
    """Wraps the enumerator's ``gather_expand`` for a traced run: each call
    becomes span ``kernel.gather_expand``, its shapes are kept, and its
    live-row count (a device scalar) is kept as the tensor, read after the
    window.  The gathered rows are not read: each call's distinct rows are
    counted as 1 where it gathers any, the lower bound of what it must
    read, so that the least time is never overstated."""

    def __init__(self, rec):
        self.rec = rec
        self.calls: List[tuple] = []

    def install(self) -> None:
        from repro_torch.torchgm import enumerate as penum
        self.rec.wrap(penum, "gather_expand", "kernel.gather_expand",
                      after=self._call)

    def _call(self, args, kw, out) -> None:
        mats, _, idx, n_alive = args[:4]
        w = mats.shape[1]
        f, k = idx.shape
        live = min(w, (kw["n_i"] + 31) // 32)
        self.calls.append((n_alive, f, k, live, kw["size"],
                           kw.get("expand", True)))

    def least_s(self) -> dict:
        if not self.calls:
            return {}
        alive_of: Dict[int, int] = {}
        for t, *_ in self.calls:
            if id(t) not in alive_of:
                alive_of[id(t)] = int(t)
        total = 0.0
        for t, f, k, live, size, expand in self.calls:
            alive = max(0, min(alive_of[id(t)], f))
            distinct = 1 if k and alive else 0
            total += work.least_s("gather_expand", *work.gather_expand(
                live, alive, k, distinct, size, expand))[0]
        return {"gather_expand": total}


def _counters(st: State) -> dict:
    from repro_torch.obs.metrics import get_registry
    out = dict(get_registry().snapshot(prefix="enum_"))
    out.update(st.engine.metrics_snapshot(prefix="server_"))
    return {k: v for k, v in out.items() if isinstance(v, (int, float))}


def _serve(st: State, idx: List[int], span=None) -> tuple:
    """Submit one batch and step until every request is terminal: (the
    requests, their journal entries; the done requests' seconds)."""
    srv = st.server
    t0 = time.perf_counter()
    rids = []
    for i in idx:
        srv.submit(st.rid, st.pool_pq[i])
        rids.append(st.rid)
        st.rid += 1
    ends: Dict[int, float] = {}
    for _ in range(4 * srv.max_attempts):
        if span is not None:
            with span("step"):
                srv.step()
        else:
            srv.step()
        now = time.perf_counter()
        for r in rids:
            if r not in ends and srv.journal[r].status in ("done", "failed"):
                ends[r] = now
        if len(ends) == len(rids):
            break
    reqs = [srv.journal[r] for r in rids]
    lat = [ends[r.rid] - t0 for r in reqs if r.status == "done"]
    return reqs, lat


def serve_pool(st: State) -> Window:
    """Serve the run's order once (the tests' run: a short window need
    not reach every pool query)."""
    b = int(st.config["server"]["batch"])
    win = Window()
    st.marks = [_counters(st)]
    for _ in range(len(st.order) // b):
        serve_batch(st, win)
    st.marks.append(_counters(st))
    return win


def _take(st: State, seq, b: int) -> List[int]:
    idx = [seq[(st.next + j) % len(seq)] for j in range(b)]
    st.next += b
    return idx


def setup(cell, seed: int, device) -> State:
    from repro_torch.engine import Engine, EngineOptions
    from repro_torch.launch.serve import QueryServer
    cfg, tr = cell.config, cell.traffic
    c = cfg["server"]
    b = int(c["batch"])
    if int(tr["outstanding"]) != b:
        raise ValueError(f"one batch in flight: the traffic's outstanding "
                         f"{tr['outstanding']} must be the batch {b}")
    # first, so that a program without the paging option fails at once
    options = EngineOptions(
        max_q=c["max_q"], max_e=c["max_e"], capacity=c["capacity"],
        device_min_nodes=c["device_min_nodes"], exact_sim=c["exact_sim"],
        materialize=c["materialize"], limit=c["limit"],
        page_on_device=c["page_on_device"])
    csr, raw, graph = make_graph(cfg, seed)
    pool, pool_pq = make_pool(csr, tr, POOL, int(tr["pool"]), c["max_q"],
                              c["max_e"])
    _, warm_pq = make_pool(csr, tr, WARMUP, int(tr["warmup"]), c["max_q"],
                           c["max_e"])
    engine = Engine(graph, options=options)
    server = QueryServer(graph, engine=engine, batch_size=b,
                         deadline_s=c["deadline_s"])
    st = State(seed=seed, device=device, config=cfg, raw=raw, engine=engine,
               server=server, pool=pool, pool_pq=pool_pq,
               order=order(seed, len(pool), int(tr["block"])).tolist())
    engine.register(graph).ensure_labels()
    saved = st.pool_pq
    st.pool_pq = warm_pq
    for _ in range(max(1, len(warm_pq) // b)):
        _serve(st, _take(st, range(len(warm_pq)), b))
    st.pool_pq, st.next = saved, 0
    return st


def instrument(st: State, rec) -> None:
    from repro_torch.torchgm.matcher import TorchGM
    rec.wrap(TorchGM, "_simulate", "sim")
    rec.wrap(TorchGM, "_enumerate", "enum")
    st.work = GatherWork(rec)
    st.work.install()
    st.bitmm = KernelWork(rec)
    st.bitmm.install()


def window(st: State, seconds: float, rec) -> Window:
    span = rec.span if rec.annotate else None
    win = Window()
    st.marks = [_counters(st)]
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        serve_batch(st, win, span)
    win.seconds = time.perf_counter() - t0
    win.answered = len(win.latencies)
    st.marks.append(_counters(st))
    return win


def serve_batch(st: State, win: Window, span=None) -> None:
    """Serve the order's next batch into ``win`` and keep every answer
    for the check."""
    b = int(st.config["server"]["batch"])
    idx = _take(st, st.order, b)
    reqs, lat = _serve(st, idx, span)
    win.attempted += b
    win.latencies.extend(lat)
    for i, r in zip(idx, reqs):
        if r.status == "done":
            st.served.append((i, r.count, r.truncated))
        else:
            st.not_done += 1
            win.failed += 1


def _delta(st: State) -> dict:
    if len(st.marks) < 2:
        return {}
    a, b = st.marks
    return {k: v - a.get(k, 0) for k, v in b.items()}


def readings(st: State, rec) -> dict:
    least = {}
    for w in (st.work, st.bitmm):
        if w is not None:
            least.update(w.least_s())
    return {"least_s": least, "counters": _delta(st)}


def teardown(st: State) -> None:
    st.server = st.engine = None


def check(st: State) -> Dict[str, tuple]:
    import torch
    from ..reference.counts import Counter
    from ..reference.graph import Reach
    limit = int(st.config["server"]["limit"])
    t0 = time.perf_counter()
    ref = Counter(Reach(st.raw.n, st.raw.edges, st.device),
                  torch.as_tensor(st.raw.labels, device=st.device))
    want: Dict[int, int] = {}
    for i in sorted({i for i, _, _ in st.served}):
        q = st.pool[i]
        want[i] = ref.count(q.labels, q.edges, limit=limit)
    mismatch = sum(min(got, limit) != want[i] for i, got, _ in st.served)
    trunc = sum(t != (want[i] >= limit) for i, _, t in st.served)
    over = sum(got > limit for _, got, _ in st.served)
    print(f"check: {len(st.served)} requests of {len(want)} distinct "
          f"queries against the reference in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return {"count_mismatch": (mismatch, 0),
            "truncated_mismatch": (trunc, 0),
            "over_limit": (over, 0),
            "redispatched": (int(_delta(st).get("server_redispatched", 0)),
                             0),
            "requests_unchecked": (st.not_done + int(not st.served), 0)}
