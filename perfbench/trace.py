"""The device trace of a traced run, reduced to what the metrics read.

``torch.profiler`` (CUPTI) records the window; its events are read as
the profiler returns them, with no trace file written.  Each device
operation (kernel, copy, set) is joined to the runtime call that launched
it by their correlation id, and that call to the ``perfbench.*`` ranges
(:mod:`perfbench.spans`) open on its thread.

From that: the busy seconds (the union of the operations' intervals inside
the window), the window's length, the device seconds under each harness
span, the device seconds by operation name, and the longest idle gaps,
each named by the harness span that the host was in when it began.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .spans import PREFIX

WINDOW = PREFIX + "window"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: int                                  # device operations counted
    unlinked: int                             # ops with no launch record
    by_span: Dict[str, float]                 # span -> device seconds
    span_counts: Dict[str, int]               # span -> ranges in window
    by_name: Dict[str, float]                 # operation name -> seconds
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[_short(k), v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def profile(fn):
    """Run ``fn()`` under ``torch.profiler`` (host and CUDA activity);
    returns (fn's result, the profiler's events)."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    print(f"trace: profiled {t1 - t0:.1f} s, {len(events)} events read in "
          f"{time.perf_counter() - t1:.1f} s", file=sys.stderr)
    return out, events


def summarize(events) -> Optional[TraceSummary]:
    """None when the trace holds no window or no device operation.
    Times are kept in microseconds."""
    from torch.autograd import DeviceType
    ann: Dict[object, List[tuple]] = defaultdict(list)
    launches: Dict[int, tuple] = {}     # launch id -> (start, thread)
    device: List[tuple] = []
    window = None
    for e in events:
        if e.device_type() != DeviceType.CPU:
            if not e.is_user_annotation():      # not a range's shadow
                device.append((e.start_ns() * 1e-3, e.duration_ns() * 1e-3,
                               e.name(), e.correlation_id()))
        elif e.linked_correlation_id():         # a runtime call in an op
            launches[e.correlation_id()] = (e.start_ns() * 1e-3,
                                            e.start_thread_id())
        elif e.is_user_annotation() and e.name().startswith(PREFIX):
            t0 = e.start_ns() * 1e-3
            rng = (t0, t0 + e.duration_ns() * 1e-3, e.name())
            ann[e.start_thread_id()].append(rng)
            if rng[2] == WINDOW:
                window = (rng[0], rng[1], e.start_thread_id())
    if window is None or not device:
        return None
    w0, w1, wtid = window
    enclosing = _enclosing(ann, launches)

    by_span: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    intervals = []
    unlinked = 0
    for ts, dur, name, corr in device:
        path = enclosing.get(corr)
        if path is None:            # no launch record: place it by time
            unlinked += 1
            path = (WINDOW,) if w0 <= ts <= w1 else ()
        if WINDOW not in path:
            continue
        a, b = max(ts, w0), min(ts + dur, w1)
        if b <= a:
            continue
        intervals.append((a, b))
        by_name[name] += (b - a) * 1e-6
        for s in set(path):
            by_span[s[len(PREFIX):]] += (b - a) * 1e-6
    if not intervals:
        return None
    intervals.sort()
    busy, gaps = 0.0, []
    cur0, cur1 = intervals[0]
    if cur0 > w0:
        gaps.append((w0, cur0))
    for a, b in intervals[1:]:
        if a > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    if cur1 < w1:
        gaps.append((cur1, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(ann.get(wtid, []))
    named = [(_host_span(host, g0), (g1 - g0) * 1e-6)
             for g0, g1 in gaps[:10]]
    counts: Dict[str, int] = defaultdict(int)
    for t0, t1, name in host:
        if w0 <= t0 and t1 <= w1:
            counts[name[len(PREFIX):]] += 1
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                        ops=len(intervals), unlinked=unlinked,
                        by_span=dict(by_span),
                        span_counts=dict(counts), by_name=dict(by_name),
                        gaps=named)


def _enclosing(ann, launches) -> Dict[int, tuple]:
    """launch id -> the names of the harness ranges open on the launching
    thread at the launch (outermost first)."""
    by_tid: Dict[object, List[tuple]] = defaultdict(list)
    for corr, (ts, tid) in launches.items():
        by_tid[tid].append((ts, corr))
    out: Dict[int, tuple] = {}
    for tid, calls in by_tid.items():
        calls.sort()
        ranges = sorted(ann.get(tid, []))
        stack: List[tuple] = []
        i = 0
        for ts, corr in calls:
            while i < len(ranges) and ranges[i][0] <= ts:
                while stack and stack[-1][1] < ranges[i][0]:
                    stack.pop()
                stack.append(ranges[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[corr] = tuple(r[2] for r in stack if r[0] <= ts <= r[1])
    return out


def _host_span(ranges: List[tuple], ts: float) -> str:
    """The innermost harness range open at ``ts`` on the window's thread."""
    best = None
    for t0, t1, name in ranges:
        if t0 > ts:
            break
        if t1 >= ts and (best is None or (t0, -t1) >= best[:2]):
            best = (t0, -t1, name)
    if best is None or best[2] == WINDOW:
        return "harness"
    return best[2][len(PREFIX):]
