"""The program's own ranges in the device trace of a traced run.

The port opens ``torch.profiler`` ranges named ``repro_torch.<phase>``
around the filter step's host phases (``repro_torch.obs.trace.profiled``):
``query.reduce`` (a query's transitive reduction), ``query.encode`` (the
batch's encoding), ``serve.step`` (``gm_serve_step`` from its call to its
return: the host issuing the step, and waiting wherever a call blocks) and
``simulation.masks`` (the edge masks of a pass and the edge sums).  :func:`summarize` reads them from the events that
:func:`perfbench.trace.summarize` reads, inside the harness's window, and
gives for each phase:

* the host seconds in its ranges, and their count;
* the device seconds and the count of the operations launched inside one
  of its ranges, at any depth;
* the device's idle seconds that fall inside its ranges on the window's
  thread;
* the host seconds of the CUDA runtime and driver calls (``cu*``) made
  inside its ranges on the window's thread, by call: a launch that waits
  for room in the device's queue shows here.

The device operations are those :func:`perfbench.trace.summarize` counts
(launched inside the window, or with no launch record and starting in
it), clipped to the window, so that the busy time agrees with it.  Ranges
are taken half-open, ``[start, end)``.

    python3 -m perfbench.program_trace --workload <name> --seed <n> \\
        --seconds <s>

makes one traced run of the cell as ``perfbench.run --trace 1`` does,
which prints its result line, and then prints one more JSON line: the
phases' readings a step (:meth:`ProgramSummary.per_step`), their sums, and
the busy seconds beside the harness's.
"""

from __future__ import annotations

import bisect
import json
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .spans import PREFIX as HARNESS_PREFIX

PREFIX = "repro_torch."
WINDOW = HARNESS_PREFIX + "window"


@dataclass
class ProgramSummary:
    busy_s: float                   # union of the window's device ops
    host_s: Dict[str, float]        # phase -> host seconds in its ranges
    counts: Dict[str, int]          # phase -> ranges in the window
    device_s: Dict[str, float]      # phase -> device seconds launched in it
    ops: Dict[str, int]             # phase -> device operations launched
    idle_s: Dict[str, float]        # phase -> idle device seconds inside
    runtime_s: Dict[str, Dict[str, float]]  # phase -> call -> host seconds

    def per_step(self) -> Dict[str, Optional[float]]:
        """The readings a step, a step being a ``serve.step`` range; None
        where the phase or the step left no range."""
        steps = self.counts.get("serve.step")

        def each(table, phase, scale):
            if not steps or phase not in self.counts:
                return None
            return table.get(phase, 0) / steps * scale

        return {"reduce_ms": each(self.host_s, "query.reduce", 1e3),
                "encode_batch_ms": each(self.host_s, "query.encode", 1e3),
                "issue_ms": each(self.host_s, "serve.step", 1e3),
                "idle_issue_ms": each(self.idle_s, "serve.step", 1e3),
                "serve_ops": each(self.ops, "serve.step", 1),
                "masks_device_ms": each(self.device_s, "simulation.masks",
                                        1e3)}


def summarize(events) -> Optional[ProgramSummary]:
    """None when the trace holds no window or no device operation in it.
    Times are kept in microseconds."""
    from torch.autograd import DeviceType
    ranges: Dict[object, List[tuple]] = defaultdict(list)
    launches: Dict[int, tuple] = {}     # launch id -> (start, thread)
    device: List[tuple] = []            # (start, end, launch id)
    calls: List[tuple] = []             # (start, length, thread, name)
    window = None
    for e in events:
        if e.device_type() != DeviceType.CPU:
            if not e.is_user_annotation():
                t0 = e.start_ns() * 1e-3
                device.append((t0, t0 + e.duration_ns() * 1e-3,
                               e.correlation_id()))
        elif not e.is_user_annotation():
            if e.linked_correlation_id():
                launches[e.correlation_id()] = (e.start_ns() * 1e-3,
                                                e.start_thread_id())
            name = e.name()
            if name.startswith("cu"):
                calls.append((e.start_ns() * 1e-3, e.duration_ns() * 1e-3,
                              e.start_thread_id(), name))
        else:
            name = e.name()
            t0 = e.start_ns() * 1e-3
            rng = (t0, t0 + e.duration_ns() * 1e-3)
            if name.startswith(PREFIX):
                ranges[e.start_thread_id()].append(
                    (*rng, name[len(PREFIX):]))
            elif name == WINDOW:
                window = (*rng, e.start_thread_id())
    if window is None:
        return None
    w0, w1, wtid = window
    open_at = {tid: _open_phases(r) for tid, r in ranges.items()}

    device_s: Dict[str, float] = defaultdict(float)
    ops: Dict[str, int] = defaultdict(int)
    busy = []
    for t0, t1, corr in device:
        launch = launches.get(corr)
        if launch is None:
            inside, phases = w0 <= t0 <= w1, ()
        else:
            ts, tid = launch
            inside = tid == wtid and w0 <= ts <= w1
            phases = _phases_at(open_at.get(tid), ts)
        a, b = max(t0, w0), min(t1, w1)
        if not inside or b <= a:
            continue
        busy.append((a, b))
        for p in phases:
            device_s[p] += (b - a) * 1e-6
            ops[p] += 1
    if not busy:
        return None
    gaps = _gaps(busy, w0, w1)

    host_s: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    mine: Dict[str, List[tuple]] = defaultdict(list)
    for tid, rngs in ranges.items():
        for t0, t1, p in rngs:
            if w0 <= t0 and t1 <= w1:
                host_s[p] += (t1 - t0) * 1e-6
                counts[p] += 1
                if tid == wtid:
                    mine[p].append((t0, t1))
    idle_s = {p: _overlap(gaps, r) * 1e-6 for p, r in mine.items()}
    runtime_s: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for ts, dur, tid, name in calls:
        if tid == wtid and w0 <= ts <= w1:
            for p in _phases_at(open_at.get(tid), ts):
                runtime_s[p][name] += dur * 1e-6
    return ProgramSummary(
        busy_s=(w1 - w0 - float(np.sum(gaps[1] - gaps[0]))) * 1e-6,
        host_s=dict(host_s), counts=dict(counts), device_s=dict(device_s),
        ops=dict(ops), idle_s=idle_s,
        runtime_s={p: dict(v) for p, v in runtime_s.items()})


def _open_phases(rngs: List[tuple]) -> Tuple[List[float], List[tuple]]:
    """(times, phases): each time at which a range of the thread opens or
    closes, and the phases open from it up to the next."""
    marks = sorted([(t1, 0, p) for t0, t1, p in rngs]
                   + [(t0, 1, p) for t0, t1, p in rngs])
    depth: Dict[str, int] = defaultdict(int)
    shared: Dict[tuple, tuple] = {}
    times: List[float] = []
    phases: List[tuple] = []
    for t, opens, p in marks:
        depth[p] += 1 if opens else -1
        now = tuple(sorted(q for q, d in depth.items() if d > 0))
        if times and times[-1] == t:
            phases[-1] = shared.setdefault(now, now)
        else:
            times.append(t)
            phases.append(shared.setdefault(now, now))
    return times, phases


def _phases_at(open_at, ts: float) -> tuple:
    if open_at is None:
        return ()
    i = bisect.bisect_right(open_at[0], ts) - 1
    return open_at[1][i] if i >= 0 else ()


def _gaps(busy: List[tuple], w0: float, w1: float):
    """(starts, ends) of the window's stretches in which no operation
    ran."""
    iv = np.array(busy)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    starts = np.concatenate([[w0], reach])
    ends = np.concatenate([iv[:, 0], [w1]])
    keep = ends > starts
    return starts[keep], ends[keep]


def _overlap(gaps, rngs: List[tuple]) -> float:
    """Length of the gaps (sorted, disjoint) inside the union of
    ``rngs``."""
    starts, ends = gaps
    cum = np.concatenate([[0.0], np.cumsum(ends - starts)])

    def idle_before(t: float) -> float:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0.0
        return cum[i] + min(max(t - starts[i], 0.0), ends[i] - starts[i])

    total, cur = 0.0, None
    for t0, t1 in sorted(rngs) + [(np.inf, np.inf)]:
        if cur is not None and t0 <= cur[1]:
            cur = (cur[0], max(cur[1], t1))
            continue
        if cur is not None:
            total += idle_before(cur[1]) - idle_before(cur[0])
        cur = (t0, t1)
    return float(total)


def main(argv=None) -> int:
    from . import run, trace
    got = []
    harness = trace.summarize

    def both(events):
        t0 = time.perf_counter()
        got.append(summarize(events))
        print(f"program_trace: reduced in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        out = harness(events)
        got.append(out)
        return out

    trace.summarize = both
    try:
        rc = run.main(list(sys.argv[1:] if argv is None else argv)
                      + ["--trace", "1"])
    finally:
        trace.summarize = harness
    if rc == 0:
        prog, summary = (got + [None, None])[:2]
        print(json.dumps({
            "program": prog.per_step() if prog else None,
            "sums": None if prog is None else {
                k: getattr(prog, k) for k in ("host_s", "counts", "device_s",
                                              "ops", "idle_s", "runtime_s")},
            "busy_s": None if prog is None else prog.busy_s,
            "harness_busy_s": None if summary is None else summary.busy_s}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
