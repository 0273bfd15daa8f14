#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--scale S]

1. Builds the CUDA kernels from the sources in the checkout (``nvcc``,
   ``sm_90a``, one process per source, all at once) and prints the build
   time and the compiler's register report.
2. ``GM.match`` path: ``GM(graph).match`` on a graph of the paper's
   Table 1 ``epinions`` profile (75,879 nodes at ``--scale 1.0``,
   power-law, 20 Zipf labels) with 4-node ``D`` and ``H`` queries, each run
   with ``enum_method="frontier-device-resident"`` in count and in
   materialize mode and with ``"frontier-device"``.  Every device run must
   equal the host ``"frontier"`` method byte for byte, run the method it
   was asked for with no degradation, and move the launch counts of
   ``gather_intersect``, ``expand_pairs`` and ``intersect`` (counts are
   reset just before the device runs and read just after).
3. Serve path, on the same graph object (its reachability index is built
   once): the port's ``QueryServer`` answers 12 requests in the
   server's own request mix (3-5 nodes, C/H/D) through the port's
   ``Engine``, drained in batches of up to 8, so that device-planned
   queries go to ``TorchGM.match_batch`` — the whole-graph double
   simulation on the ``bitmm`` kernel, then the frontier MJoin with
   ``CAPACITY`` rows.  The label structures are built before the drain,
   and the batch deadline covers a host re-run, so every batch runs once.
   Every request must be done with the host ``GM`` count (where the host
   stops at its 10^7 limit and the device answered, with the exact count
   of the resident ``GM.match`` method), at least one must be answered on
   the device without overflow, and ``bitmm`` and ``gather_expand`` (the
   enumerator's fused level) must be launched, and ``expand_pairs`` not
   inside the ``TorchGM`` calls (the engine's resident lane may launch
   it; counts reset just before the phase and read just after).  Prints each
   request's simulation and enumeration seconds.
4. Closure path, on the same graph object, after the serve path's engine
   is freed: ``TorchGM(graph, closure_on_device=True)`` squares the
   reachability matrix out of the uploaded adjacency with 17
   ``closure_step`` launches (the host index is not consulted) and
   transposes it with one ``transpose`` launch.  Its whole device stack
   must equal, byte for byte, that of a ``TorchGM`` built from the host
   index; both answer the serve path's 12 requests through
   ``match_batch`` in batches of 8 and 4, with equal counts and overflow
   flags, and counts equal to the host ``GM``'s where nothing
   overflowed; ``gather_expand`` launched and ``expand_pairs`` not.
   Prints ``closure_s``, each step's kernel time (CUDA events), the
   transpose time, the step after which R stopped changing (found after
   the timed run) and the bytes shipped.
5. Dense closure: the paper's Table 1 ``human`` profile (4,674 nodes,
   uniform, n_pad 5,120), whose closure is all ones, built the same way
   on the card and held to the host index's stack; prints each step's
   time (from the second step on every row takes the kernel's whole-row
   path).
6. A count past 2^31: a directed cycle of 46,341 nodes with one label,
   ``TorchGM`` from the host index with 65,536 frontier rows, and a
   2-node ``//`` query, whose count must equal the host reachability
   index's row sizes summed (n^2 = 2,147,488,281), with no overflow.
7. Holds each kernel to its plain PyTorch version on the card, exactly, on
   the largest input its path gave it (``gather_expand``: the serve
   path's largest expanded level; ``expand_pairs``: also that level's AND
   rows, 65,536 x 2,384 lanes; ``closure_step``: the last step's R, and
   the human profile's; ``transpose``: the closure) and on ragged edge
   cases, and times both with CUDA events beside the kernel's bound:
   ``ms`` is the kernel's device time per call with a cold L2 (each call
   captured in a CUDA graph behind a write of a buffer larger than L2,
   whose own time is replayed alone and subtracted), ``warm_ms`` the same
   without the flush, ``eager_ms`` the wrapper called eagerly (host
   overhead included), ``plain_ms`` the plain version eagerly,
   ``library_ms`` one PyTorch call computing the same product where there
   is one (``closure_step``: ``torch.matmul`` of the unpacked bf16 R by
   itself; ``bitmm``: ``torch._int_mm`` of the unpacked int8 A by X, held
   to the kernel's output, at B = 64 and at B = 32; ``expand_pairs``:
   ``torch.nonzero_static`` of the page's bits, unpacked beforehand and
   not timed, at both shapes; none for ``transpose``, ``gather_expand``,
   ``gather_intersect`` and ``intersect``).  ``bitmm`` is also timed at B = 32 (the batch of 4)
   and its CUDA-core floor printed.  ``gather_intersect`` and
   ``intersect`` are also held to their plain versions and timed cold at
   every launch shape the ``GM.match`` and serve paths gave them (the
   shape histogram, with each shape's launches and the cold ms summed over
   them), beside the launch floor (an empty kernel in the same harness)
   and a plain copy of the same bytes (``index_select`` of the gathered
   rows cut to ``w32``; a copy of the slab's output bytes).  Bounds: bytes
   over 3.35 TB/s against operations over 1,979 TOP/s for ``bitmm`` (the
   int8 tensor cores) and over 67 T/s for the others.
8. Prints the ``kernels`` JSON line, the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero, as does a spill that ptxas
reports in any instantiation of ``gather_intersect_kernel`` or
``intersect_kernel`` (checked after the ``kernels`` line is printed).
Without CUDA, or without the repository's ``src/repro_torch`` beside it,
it exits 2 and prints no result.
It imports nothing of JAX and nothing of the reference package.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RESIDENT = "frontier-device-resident"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
# H100 SXM published float32 rate outside the tensor cores (FMA); the
# yardstick of the word-operation kernels, whose bounds bytes set
INT32_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
LOP3_PER_SM_CLOCK = 64           # 32-bit logic results a clock per SM (9.0)
FLUSH_BYTES = 256 << 20          # written between timed calls: > 50 MB L2
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"gather_intersect": CSRC + "frontier_kernels.cu",
           "expand_pairs": CSRC + "frontier_kernels.cu",
           "gather_expand": CSRC + "frontier_kernels.cu",
           "intersect": CSRC + "frontier_kernels.cu",
           "bitmm": CSRC + "bitmm.cu",
           "closure_step": CSRC + "closure.cu",
           "transpose": CSRC + "closure.cu"}
REPLACES = {
    "gather_intersect": "src/repro/kernels/gather_intersect.py:96",
    "expand_pairs": "src/repro/kernels/gather_intersect.py:124",
    # the whole-graph enumerator's level, fused by XLA: not a Pallas kernel
    "gather_expand": "src/repro/jaxgm/enumerate.py:65-104",
    "intersect": "src/repro/kernels/intersect.py:79",
    "bitmm": "src/repro/kernels/bitmm.py:76",
    "closure_step": "src/repro/kernels/closure.py:75",
    # XLA unpack, numpy transpose and XLA repack: not a Pallas kernel
    "transpose": "src/repro/jaxgm/device_graph.py:76-78",
}
GM_KERNELS = ("gather_intersect", "expand_pairs", "intersect")
SERVE_KERNELS = ("bitmm", "gather_expand")
CLOSURE_KERNELS = ("closure_step", "transpose", "bitmm", "gather_expand")
# the whole-graph enumerator's levels go through gather_expand alone
NOT_ON_WHOLE_GRAPH = ("expand_pairs",)
# two of the four queries of the first slice (D s1: the largest resident
# RIG; H s0: the smallest), so that the serve path fits the time limit
QUERIES = (("D", 1), ("H", 0))
N_REQUESTS = 12
BATCH = 8
# frontier rows of the whole-graph matcher: 10 of the 12 requests finish on
# the device without overflow
CAPACITY = 1 << 16
# the count past 2^31: a directed cycle of this many nodes (n^2 >= 2^31)
CYCLE_NODES = 46_341
# per-batch deadline of the server: the host re-run of an overflowed
# request (10^7 results) takes tens of seconds, and the default 30 s would
# split the first batch and serve its requests twice
DEADLINE_S = 300.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_name(line: str) -> str:
    """A kernel's name and template arguments from the mangled name in a
    ptxas "Compiling entry function" line (``segment_counts_kernel<1, 4>``)."""
    m = re.search(r"\d([a-z_]+_kernel)(I(?:L[a-z]\d+E)+E)?(?=[IE])", line)
    if m is None:
        return line.strip()
    args = re.findall(r"L[a-z](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


# the kernels whose every instantiation must compile without a spill
NO_SPILL = ("gather_intersect_kernel", "intersect_kernel")


def ptxas_spills(build, source: str = "frontier_kernels"):
    """{kernel<template args>: (spill store bytes, spill load bytes)} of
    every instantiation of ``NO_SPILL`` in ptxas's report of ``source``,
    the one kept beside its library."""
    report, kernel = {}, None
    for line in build.report(source).splitlines():
        if "entry function" in line or "Function properties" in line:
            kernel = kernel_name(line)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel and kernel.split("<")[0] in NO_SPILL:
            report[kernel] = (int(m.group(1)), int(m.group(2)))
    if not report:
        raise AssertionError(f"ptxas reported nothing of {NO_SPILL} in "
                             f"{source}")
    return report


# ----------------------------------------------------------------- timing
def time_ms(torch, fn, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_of(torch, fn, iters: int):
    """``iters`` calls of ``fn`` captured into one CUDA graph (warmed up
    off the capture), replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replays_ms(torch, graph, replays: int) -> float:
    """Device ms of ``replays`` replays of ``graph`` (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def replay_ms(torch, fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured into one CUDA graph,
    replayed ``replays`` times, so host-side wrapper overhead drops out."""
    return replays_ms(torch, graph_of(torch, fn, iters), replays) / (
        iters * replays)


def cold_ms(torch, fn, flush, iters: int = 20, rounds: int = 5) -> float:
    """Device time per call with a cold L2: each call follows a write of
    ``flush`` (larger than L2) in the graph; the flushes alone are timed
    the same way and subtracted.  The two graphs are replayed in turn
    ``rounds`` times and the median difference kept: the flushes take a
    hundred times longer than a small kernel, so a clock that moves
    between two lone timings would swamp it."""
    def flushed():
        flush.zero_()
        fn()
    with_fn = graph_of(torch, flushed, iters)
    alone = graph_of(torch, flush.zero_, iters)
    diffs = [replays_ms(torch, with_fn, 10) - replays_ms(torch, alone, 10)
             for _ in range(rounds)]
    return statistics.median(diffs) / (iters * 10)


def set_bits(words) -> int:
    """Set bits of packed int32 lanes, counted a block of rows at a time."""
    from repro_torch.kernels import packed
    return sum(int(packed.popcount(words[r0:r0 + 4096]).sum())
               for r0 in range(0, words.shape[0], 4096))


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g is None and w is None:          # pairs of a count-only call
            continue
        if g is None or w is None:
            raise AssertionError("one side returned no pairs")
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype mismatch: {g.shape} "
                                 f"{g.dtype} vs {w.shape} {w.dtype}")
        if g.numel():
            err = max(err, int((g.double() - w.double()).abs().max()))
    return err


# -------------------------------------------------------------- main path
class Capture:
    """Records, under a key, the largest input a kernel wrapper received
    through one module's name for it on the main paths, or with no size
    every input, of which :meth:`keep_largest` picks one after the path
    (the wrapper itself, and its launch count, are untouched); ``on``
    pauses it.  For the keys of ``HISTOGRAM`` it also keeps every distinct
    launch shape with the number of its launches and its first input
    (``shapes[key][shape] = [launches, args, kw]``)."""

    def __init__(self, specs):
        self.inputs = {}
        self.every = {}
        self.shapes = {}
        self.on = True
        for module, name, key, size in specs:
            setattr(module, name, self._wrap(key, getattr(module, name),
                                             size))

    def keep_largest(self, key, size):
        """Of the inputs kept whole under ``key`` (a size that would wait
        for the device is taken only now, after the path), keep the one
        of largest ``size``; returns its size."""
        best = max(self.every.pop(key, []), key=lambda a: size(*a[0], **a[1]))
        s = size(*best[0], **best[1])
        self.inputs[key] = (s, *best)
        return s

    def _wrap(self, key, fn, size):
        shape = HISTOGRAM.get(key)

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            k = shape(*args, **kw) if self.on and shape else None
            if k is not None:
                seen = self.shapes.setdefault(key, {})
                if k in seen:
                    seen[k][0] += 1
                else:
                    seen[k] = [1, args, kw]
            if self.on and size is None:
                self.every.setdefault(key, []).append((args, kw))
            elif self.on:
                s = size(*args, **kw)
                if key not in self.inputs or s > self.inputs[key][0]:
                    self.inputs[key] = (s, args, kw)
            return out
        return wrapped


# launch shapes kept with their counts: (R, W, F, K, w32) of
# gather_intersect and (F, K, W) of intersect; None where the wrapper
# launches nothing (no rows)
HISTOGRAM = {
    "gather_intersect": lambda m, i, w32: (
        (*m.shape, *i.shape, w32) if i.shape[0] else None),
    "intersect": lambda r: tuple(r.shape) if r.shape[0] and r.shape[2]
    else None,
}


def capture_inputs():
    """The GM.match path's executor kernels, the serve path's bitmm and
    the whole-graph enumerator's levels (``gather_expand``: every level is
    kept, and the largest picked after the path, since its live rows are a
    device scalar)."""
    import repro_torch.torchgm.enumerate as enumerator
    from repro_torch.kernels import ops
    from repro_torch.torchgm import frontier
    return Capture((
        (frontier, "gather_intersect", "gather_intersect",
         lambda m, i, w32: i.shape[0] * i.shape[1] * w32),
        (frontier, "expand_pairs", "expand_pairs",
         lambda a, n_i, size: a.numel() + size),
        (frontier, "intersect", "intersect", lambda r: r.numel()),
        (ops, "bitmm", "bitmm",
         lambda a, x, threshold=True: a.numel() * x.shape[1]),
        (enumerator, "gather_expand", "gather_expand", None),
    ))


def level_size(mats, fb_row, idx, n_alive, *, n_i, size, expand=True):
    """A captured level's rank: expanded levels first, then the rows its
    live rows gather (waits for the device)."""
    return (expand, int(n_alive) * (idx.shape[1] + 1))


def gm_path(torch, card: str, graph, gm):
    """The first slice's path: ``GM.match`` with the device methods."""
    from repro_torch.core import GMOptions
    from repro_torch.core.mjoin import device_intersector
    from repro_torch.data.queries import random_query_from_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts

    queries = [random_query_from_graph(graph, n_nodes=4, qtype=qt,
                                       seed=seed, extra_edge_prob=0.3)
               for qt, seed in QUERIES]
    refs = [gm.match(q, GMOptions(enum_method="frontier")) for q in queries]

    runs, per_query = [], []
    reset_launch_counts()                # just before the device runs
    for q in queries:
        before = launch_counts()
        rc = gm.match(q, GMOptions(enum_method=RESIDENT, materialize=False))
        rm = gm.match(q, GMOptions(enum_method=RESIDENT))
        dev0 = device_intersector().kernel_s
        dv = gm.match(q, GMOptions(enum_method="frontier-device"))
        runs.append((rc, rm, dv, device_intersector().kernel_s - dev0))
        after = launch_counts()
        per_query.append({n: after.get(n, 0) - before.get(n, 0)
                          for n in GM_KERNELS})
    torch.cuda.synchronize()
    total = launch_counts()              # just after the device runs

    for q, ref, (rc, rm, dv, dv_kernel_s), launched in zip(
            queries, refs, runs, per_query):
        for name, r, method in (("resident count", rc, RESIDENT),
                                ("resident materialize", rm, RESIDENT),
                                ("frontier-device", dv, "frontier-device")):
            if r.count != ref.count or r.truncated != ref.truncated:
                raise AssertionError(f"{q.name} {name}: count {r.count} "
                                     f"truncated {r.truncated} vs host "
                                     f"{ref.count} {ref.truncated}")
            if r.enum_method != method or r.degradations:
                raise AssertionError(f"{q.name} {name}: ran {r.enum_method} "
                                     f"degradations {r.degradations}")
        for name, r in (("resident materialize", rm), ("frontier-device", dv)):
            if (r.tuples.dtype != ref.tuples.dtype
                    or r.tuples.shape != ref.tuples.shape
                    or r.tuples.tobytes() != ref.tuples.tobytes()):
                raise AssertionError(f"{q.name} {name}: tuples differ from "
                                     f"the host frontier method")
        res_c, res_m = rc.rig.resident, rm.rig.resident
        log(f"[{card}] query {q.name} {q}: rig {rm.rig_nodes} nodes / "
            f"{rm.rig_edges} edges, resident {rm.resident_bytes} B, "
            f"results {ref.count} (truncated={ref.truncated}, tuples "
            f"{ref.tuples.shape[0]}); host front half {rm.matching_s:.4f} s; "
            f"enumerate s: host frontier {ref.enumerate_s:.4f}, resident "
            f"count {rc.enumerate_s:.4f} (upload_s {res_c.upload_s:.4f}, "
            f"kernel_s {res_c.kernel_s:.4f}), resident materialize "
            f"{rm.enumerate_s:.4f} (upload_s {res_m.upload_s:.4f}, kernel_s "
            f"{res_m.kernel_s:.4f}, {res_m.calls} gathers, "
            f"{res_m.expand_calls} expands), frontier-device "
            f"{dv.enumerate_s:.4f} (kernel_s {dv_kernel_s:.4f}); h2d/d2h B: "
            f"resident count {rc.h2d_bytes}/{rc.d2h_bytes}, resident "
            f"materialize {rm.h2d_bytes}/{rm.d2h_bytes}, frontier-device "
            f"{dv.h2d_bytes}/{dv.d2h_bytes}; launches (its three device "
            f"runs) {json.dumps(launched, sort_keys=True)}")
    log(f"GM.match path launches: {json.dumps(total, sort_keys=True)}")
    for name in GM_KERNELS:
        if total.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"GM.match path")
    return total, per_query


class DeviceCalls:
    """Records each ``TorchGM.match`` / ``match_batch`` result with the
    ``bitmm`` launches of its call, keyed by the reduced query's shape,
    and sums every kernel's launches inside these calls in ``launched``
    (the matcher itself is untouched)."""

    def __init__(self, cls):
        from repro_torch.kernels import launch_counts
        self.by_query = {}
        self.calls = []
        self.launched = {}
        self.matcher = None
        self.cls = cls
        self.saved = {}
        for name in ("match", "match_batch"):
            fn = self.saved[name] = getattr(cls, name)

            def wrapped(gm, arg, *a, _fn=fn, **kw):
                before = launch_counts()
                out = _fn(gm, arg, *a, **kw)
                after = launch_counts()
                for k, v in after.items():
                    self.launched[k] = (self.launched.get(k, 0) + v
                                        - before.get(k, 0))
                bitmm = after.get("bitmm", 0) - before.get("bitmm", 0)
                self.matcher = gm
                qs, rs = (arg, out) if isinstance(out, list) else \
                    ([arg], [out])
                self.calls.append((len(qs), bitmm))
                for q, r in zip(qs, rs):
                    self.by_query[shape_key(q)] = (r, len(qs), bitmm)
                return out
            setattr(cls, name, wrapped)

    def restore(self):
        """Put the matcher's methods back and drop the matcher, so that
        its device graph can be freed."""
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)
        self.matcher = None


def shape_key(q):
    return (tuple(q.labels), tuple((e.src, e.dst, e.kind) for e in q.edges))


def serve_path(torch, card: str, graph, gm, capture):
    """The serving path: ``QueryServer`` -> ``Engine.execute_many`` ->
    ``TorchGM.match_batch`` (double simulation on ``bitmm``)."""
    from repro_torch.core import GMOptions
    from repro_torch.data.queries import random_query_from_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import QueryServer
    from repro_torch.obs.ledger import get_ledger
    from repro_torch.torchgm.matcher import TorchGM

    queries = [random_query_from_graph(graph, 3 + i % 3, qtype="CHD"[i % 3],
                                       seed=i) for i in range(N_REQUESTS)]
    t0 = time.perf_counter()
    refs = [gm.match(q, GMOptions(enum_method="frontier", materialize=False))
            for q in queries]
    log(f"[{card}] serve path: host GM counts of {N_REQUESTS} requests "
        f"{[r.count for r in refs]} (truncated at the limit: "
        f"{[i for i, r in enumerate(refs) if r.truncated]}; "
        f"{time.perf_counter() - t0:.1f} s)")
    calls = DeviceCalls(TorchGM)
    ledger0 = get_ledger().transfers.h2d_bytes(site="label_build")
    server = QueryServer(graph, batch_size=BATCH, capacity=CAPACITY,
                         deadline_s=DEADLINE_S)
    t0 = time.perf_counter()
    server.engine.context(graph).ensure_labels()   # host label structures
    log(f"[{card}] serve path: label structures {time.perf_counter() - t0:.2f}"
        f" s (host, before the drain)")
    reset_launch_counts()                # just before the serve path
    t0 = time.perf_counter()
    for i, q in enumerate(queries):
        if not server.submit(i, q):
            raise AssertionError(f"request {i} rejected: "
                                 f"{server.rejected.get(i)}")
    server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = launch_counts()              # just after the serve path
    upload = get_ledger().transfers.h2d_bytes(site="label_build") - ledger0

    jgm = calls.matcher
    if jgm is None:
        raise AssertionError("the server built no TorchGM: no request was "
                             "planned onto the device")
    log(f"[{card}] serve path: capacity {CAPACITY}, batches of up to "
        f"{BATCH}; TorchGM device graph n_pad {jgm.dg.n_pad}: host repack "
        f"{jgm.build_s:.4f} s, upload {jgm.upload_s:.4f} s, "
        f"{jgm.upload_bytes} B (ledger label_build {upload} B); device "
        f"calls (queries, bitmm launches) {calls.calls}; re-dispatched "
        f"{server.stats['redispatched']}")
    if server.stats["redispatched"]:
        raise AssertionError("a batch was re-dispatched: its requests were "
                             "served twice")
    exact = exact_counts(card, gm, queries, refs, server.journal, capture)
    on_device = 0
    for i, q in enumerate(queries):
        r = server.journal[i]
        if r.status != "done":
            raise AssertionError(f"request {i} not done: {r.status} "
                                 f"{r.error}")
        want = exact.get(i, refs[i].count)
        if r.count != want:
            how = "no limit" if i in exact else "frontier"
            raise AssertionError(f"request {i}: count {r.count} vs host "
                                 f"GM {want} ({how})")
        rec = calls.by_query.get(shape_key(q.transitive_reduction()))
        phases = "no device call"
        if rec is not None:
            dev, shared, bitmm = rec
            phases = (f"simulation {dev.sim_s:.4f} s / {dev.sim_passes} "
                      f"passes (shared by {shared}), enumerate "
                      f"{dev.enumerate_s:.4f} s, bitmm launches {bitmm} "
                      f"(its call)")
        on_device += r.backend == "device" and not r.overflowed
        log(f"[{card}] request {i} {q}: backend {r.backend}, "
            f"{'overflow -> host re-run' if r.overflowed else 'no overflow'}"
            f", count {r.count}; {phases}")
    log(f"[{card}] serve path: {on_device}/{N_REQUESTS} answered on the "
        f"device without overflow; wall {wall:.2f} s; server "
        f"{server.stats}; {server.stats_line()}")
    log(f"serve path launches: {json.dumps(total, sort_keys=True)} (in "
        f"TorchGM calls {json.dumps(calls.launched, sort_keys=True)}; the "
        f"rest in the engine's other lanes)")
    if on_device == 0:
        raise AssertionError("no request was answered on the device "
                             "without overflow")
    for name in SERVE_KERNELS:
        if total.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serve path")
    for name in NOT_ON_WHOLE_GRAPH:
        if calls.launched.get(name, 0):
            raise AssertionError(f"kernel {name} was launched by the "
                                 f"whole-graph matcher on the serve path")
    calls.restore()
    return total, calls.calls, queries, refs, exact


def exact_counts(card: str, gm, queries, refs, journal, capture):
    """Exact counts, by the resident ``GM.match`` method with no result
    limit, of the requests that the device answered without overflow where
    the host ``frontier`` reference stopped at its limit (the engine's host
    re-run of an overflow stops at the same limit)."""
    from repro_torch.core import GMOptions
    out = {}
    capture.on = False                   # not a main-path input
    for i, (q, ref) in enumerate(zip(queries, refs)):
        r = journal[i]
        if not (ref.truncated and r.backend == "device"
                and not r.overflowed):
            continue
        t0 = time.perf_counter()
        ex = gm.match(q, GMOptions(enum_method=RESIDENT, limit=None,
                                   materialize=False))
        if ex.truncated or ex.enum_method != RESIDENT or ex.degradations:
            raise AssertionError(f"request {i}: exact count run "
                                 f"{ex.enum_method} truncated {ex.truncated}"
                                 f" degradations {ex.degradations}")
        if ex.count < ref.count:
            raise AssertionError(f"request {i}: exact count {ex.count} "
                                 f"below the host's truncated {ref.count}")
        out[i] = ex.count
        log(f"[{card}] request {i}: host frontier stops at {ref.count}; "
            f"exact count {ex.count} (resident, no limit, "
            f"{time.perf_counter() - t0:.2f} s)")
    capture.on = True
    return out


class ClosureSteps:
    """Times each ``closure_step`` call of ``transitive_closure`` with CUDA
    events and each ``transpose`` call the same way, and keeps the last
    step's input R (the densest input of the path; no later step writes
    its buffer) and the transpose's input.  The wrappers and their launch
    counts are untouched."""

    def __init__(self, torch):
        from repro_torch.kernels import ops
        self.steps, self.transposes = [], []
        self.inputs = {}
        self._saved = [(ops, name, getattr(ops, name))
                       for name in ("closure_step", "transpose")]

        def timed(events, name, fn):
            def wrapped(r, *a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(r, *a, **kw)
                end.record()
                events.append((start, end))
                self.inputs[name] = r
                return out
            return wrapped

        ops.closure_step = timed(self.steps, "closure_step", ops.closure_step)
        ops.transpose = timed(self.transposes, "transpose", ops.transpose)

    def restore(self):
        for module, name, fn in self._saved:
            setattr(module, name, fn)

    @staticmethod
    def ms(events):
        return [start.elapsed_time(end) for start, end in events]


def closure_path(torch, card: str, graph, queries, refs, exact):
    """The on-device closure: ``TorchGM(closure_on_device=True)`` against
    a host-index ``TorchGM`` (byte-equal stacks, equal answers) and the
    host ``GM``.  Returns the path's launch counts, the last step's R and
    what the kernel row reports of the path."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.closure import closure_step
    from repro_torch.torchgm.matcher import TorchGM

    gc.collect()
    torch.cuda.empty_cache()
    live0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opts = dict(exact_sim=True, max_q=BATCH, max_e=16, capacity=CAPACITY)
    index_calls = []
    build_index = graph.reachability

    def counted_index():
        index_calls.append(1)
        return build_index()

    graph.reachability = counted_index
    timer = ClosureSteps(torch)
    reset_launch_counts()                # just before the closure path
    t0 = time.perf_counter()
    cgm = TorchGM(graph, closure_on_device=True, **opts)
    t1 = time.perf_counter()
    timer.restore()
    built = launch_counts()
    del graph.reachability
    if index_calls:
        raise AssertionError("the closure path built the host reachability "
                             "index")
    hgm = TorchGM(graph, **opts)
    steps = math.ceil(math.log2(cgm.dg.n_pad))     # 17 at scale 1.0
    if (built.get("closure_step", 0), built.get("transpose", 0)) != (steps,
                                                                     1):
        raise AssertionError(f"the closure made {built.get('closure_step')} "
                             f"closure_step launches, not {steps}, and "
                             f"{built.get('transpose')} transpose launches,"
                             f" not 1")
    if not (torch.equal(cgm.dg.stack, hgm.dg.stack)
            and torch.equal(cgm.dg.labels, hgm.dg.labels)):
        raise AssertionError("the closure-built device graph differs from "
                             "the host-index one")
    results = []
    for lo, hi in ((0, BATCH), (BATCH, len(queries))):
        batch = queries[lo:hi]
        results += list(zip(cgm.match_batch(batch), hgm.match_batch(batch)))
    torch.cuda.synchronize()
    total = launch_counts()              # just after the closure path
    peak = torch.cuda.max_memory_allocated()

    finished = 0
    for i, (q, (c, h)) in enumerate(zip(queries, results)):
        if (c.count, c.overflowed) != (h.count, h.overflowed):
            raise AssertionError(f"request {i}: closure-built TorchGM count "
                                 f"{c.count} overflow {c.overflowed} vs "
                                 f"host-index {h.count} {h.overflowed}")
        want = exact.get(i, None if refs[i].truncated else refs[i].count)
        if not c.overflowed and want is not None and c.count != want:
            raise AssertionError(f"request {i}: closure-built TorchGM count "
                                 f"{c.count} vs host GM {want}")
        finished += not c.overflowed
        log(f"[{card}] closure path request {i} {q}: count {c.count}, "
            f"overflow {c.overflowed} (host-index TorchGM the same; host GM "
            f"{want if want is not None else 'stops at its limit'}); "
            f"simulation {c.sim_s:.4f} s / {c.sim_passes} passes, enumerate "
            f"{c.enumerate_s:.4f} s")
    if finished == 0:
        raise AssertionError("no closure-path request finished without "
                             "overflow")
    for name in CLOSURE_KERNELS:
        if total.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"closure path")
    for name in NOT_ON_WHOLE_GRAPH:
        if total.get(name, 0):
            raise AssertionError(f"kernel {name} was launched on the "
                                 f"closure path")
    if total["closure_step"] != steps:
        raise AssertionError(f"closure_step launched {total['closure_step']}"
                             f" times on the closure path, not {steps}")
    step_ms = ClosureSteps.ms(timer.steps)
    transpose_ms = ClosureSteps.ms(timer.transposes)

    # outside the timings and the counted run: which steps changed R
    changed = []
    r = cgm.dg.adj
    for _ in range(steps):
        nxt = closure_step(r)
        changed.append(not torch.equal(nxt, r))
        r = nxt
    if not torch.equal(r, cgm.dg.reach):
        raise AssertionError("re-running the steps gave another closure")
    last_change = max((k + 1 for k, c in enumerate(changed) if c), default=0)
    nnz = set_bits(cgm.dg.reach)
    shipped = cgm.upload_bytes
    log(f"[{card}] closure path: n_pad {cgm.dg.n_pad}; closure_s "
        f"{cgm.closure_s:.4f} s (TorchGM construction {t1 - t0:.4f} s: host "
        f"repack {cgm.build_s:.4f} s, upload {cgm.upload_s:.4f} s); "
        f"closure_step ms per step {[round(t, 4) for t in step_ms]} (sum "
        f"{sum(step_ms):.4f}); transpose ms {transpose_ms}; R stopped "
        f"changing after step {last_change} of {steps} (changed: {changed});"
        f" closure set bits {nnz}; shipped {shipped} B (host-index TorchGM "
        f"{hgm.upload_bytes} B, difference {hgm.upload_bytes - shipped} B);"
        f" device memory live before {live0} B, peak {peak} B; stacks equal"
        f" byte for byte; {finished}/{len(queries)} requests without "
        f"overflow")
    log(f"closure path launches: {json.dumps(total, sort_keys=True)}")
    info = {"closure_s": cgm.closure_s, "step_ms": step_ms,
            "transpose_ms": transpose_ms, "steps_changed": last_change,
            "steps": steps, "shipped_bytes": shipped}
    return total, timer.inputs["closure_step"], \
        timer.inputs["transpose"].clone(), info


def dense_closure_case(torch, card: str):
    """A closure that is dense: the paper's Table 1 ``human`` profile
    (4,674 nodes, uniform, average degree 18.5) is one strongly connected
    component, so its closure is all ones.  ``from_host(...,
    closure_on_device=True)`` builds it on the card; its stack must equal
    the host index's byte for byte.  Returns the last step's R and the
    per-step times."""
    from repro_torch.data.graphs import paper_profile_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.torchgm import device_graph

    graph = paper_profile_graph("human", seed=0)
    t0 = time.perf_counter()
    host = device_graph.from_host(graph)           # host reachability index
    host_s = time.perf_counter() - t0
    timer = ClosureSteps(torch)
    reset_launch_counts()
    dg = device_graph.from_host(graph, closure_on_device=True)
    timer.restore()
    launched = launch_counts()
    steps = math.ceil(math.log2(dg.n_pad))         # 13 at n_pad 5,120
    if (launched.get("closure_step"), launched.get("transpose")) != (steps,
                                                                     1):
        raise AssertionError(f"human profile: launches {launched}")
    if not (torch.equal(dg.stack, host.stack)
            and torch.equal(dg.labels, host.labels)):
        raise AssertionError("human profile: the closure-built device graph "
                             "differs from the host-index one")
    nnz = set_bits(dg.reach)
    if nnz != graph.n * graph.n:
        raise AssertionError(f"human profile: closure holds {nnz} set bits, "
                             f"not {graph.n} x {graph.n}")
    step_ms = ClosureSteps.ms(timer.steps)
    info = {"graph": "human", "n": graph.n, "n_pad": dg.n_pad,
            "adjacency_set_bits": set_bits(dg.adj), "closure_set_bits": nnz,
            "closure_s": dg.closure_s, "step_ms": step_ms,
            "transpose_ms": ClosureSteps.ms(timer.transposes),
            "host_index_s": host_s}
    log(f"[{card}] dense closure (human, {graph.n} nodes, {graph.n_edges} "
        f"edges, n_pad {dg.n_pad}): closure_s {dg.closure_s:.4f} s (host "
        f"index and upload {host_s:.4f} s); closure_step ms per step "
        f"{[round(t, 4) for t in step_ms]} (sum {sum(step_ms):.4f}); "
        f"transpose ms {info['transpose_ms']}; adjacency "
        f"{info['adjacency_set_bits']} set bits, closure {nnz} (all ones); "
        f"stacks equal byte for byte")
    return timer.inputs["closure_step"], info


def int64_count_case(torch, card: str):
    """A count past 2^31: on a directed cycle of ``CYCLE_NODES`` nodes with
    one label every node reaches every node, so the 2-node ``//`` query
    has n^2 = 2,147,488,281 occurrences, and the whole-graph matcher must
    count them exactly (the last level's total in int64), equal to the
    host reachability index's row sizes summed, without overflow.
    Returns the phase's launch counts."""
    import numpy as np
    from repro_torch.convert import graph_from_arrays, query_from_spec
    from repro_torch.core import bitset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.torchgm.matcher import TorchGM

    n = CYCLE_NODES
    nodes = np.arange(n)
    graph = graph_from_arrays(n, np.zeros(n, dtype=np.int32), 1,
                              np.stack([nodes, (nodes + 1) % n], axis=1))
    t0 = time.perf_counter()
    want = int(bitset.count_rows(graph.reachability().reach_bits).sum())
    host_s = time.perf_counter() - t0
    gm = TorchGM(graph, capacity=CAPACITY, exact_sim=True)
    query = query_from_spec([0, 0], [(0, 1, 1)])
    reset_launch_counts()                # just before the count
    got = gm.match(query)
    torch.cuda.synchronize()
    launched = launch_counts()           # just after it
    log(f"[{card}] count past 2^31: directed cycle of {n} nodes, one label,"
        f" query {query}: count {got.count} (host reachability index row "
        f"sizes summed {want}, {host_s:.2f} s; 2^31 = {2 ** 31}), overflow "
        f"{got.overflowed}; simulation {got.sim_s:.4f} s, enumerate "
        f"{got.enumerate_s:.4f} s; TorchGM n_pad {gm.dg.n_pad}, set-up "
        f"{gm.build_s + gm.upload_s:.2f} s; launches "
        f"{json.dumps(launched, sort_keys=True)}")
    if want != n * n or got.count != want or got.overflowed:
        raise AssertionError(f"cycle of {n}: count {got.count} overflow "
                             f"{got.overflowed}, host index {want}, n^2 "
                             f"{n * n}")
    if launched.get("gather_expand", 0) == 0 or "expand_pairs" in launched:
        raise AssertionError(f"cycle of {n}: launches {launched}")
    del gm
    gc.collect()
    torch.cuda.empty_cache()
    return launched


# ---------------------------------------------------------------- kernels
def bound(name: str, args, kw):
    """(bytes, operations) the call must move / do on these inputs."""
    if name == "gather_intersect":
        matrix, idx = args
        f, k = idx.shape
        w32 = kw["w32"]
        distinct = int(idx.unique().numel())    # each gathered row read once
        return (4 * (distinct * w32 + f * (k + w32 + 1)),
                f * w32 * (k + 1))
    if name == "intersect":
        (rows,) = args
        f, k, w = rows.shape
        return 4 * f * (k * w + w + 1), f * w * (k + 1)
    if name == "bitmm":
        # A read once, X and Y once; the product as the int8 tensor cores
        # do it: 2 * M * 32 W * B operations (a multiply-add is two)
        a, x = args
        m, w = a.shape
        k, b = x.shape
        out = m * b * (1 if kw.get("threshold", True) else 4)
        return (4 * m * w + k * b * x.element_size() + out,
                2 * m * 32 * w * b)
    if name == "closure_step":
        # R read once, R' written once; the list work of the kernel's two
        # passes (the dense product would do N * N * W)
        (r,) = args
        n, w = r.shape
        return 2 * 4 * n * w, closure_step_ops(r)
    if name == "transpose":
        # the matrix read once and written once; five swap stages of one
        # word operation per lane
        (words,) = args
        n, w = words.shape
        return 2 * 4 * n * w, 5 * n * w
    if name == "gather_expand":
        # each distinct row the live rows gather read once over the live
        # lanes, their index, the candidate row and the pairs; one AND or
        # popcount per gathered lane
        mats, fb_row, idx, n_alive = args
        f, k = idx.shape
        live = min(mats.shape[1], (kw["n_i"] + 31) // 32)
        alive = max(0, min(int(n_alive), f))
        distinct = int(idx[:alive].unique().numel())
        pairs = 2 * kw["size"] if kw.get("expand", True) else 0
        return (4 * (distinct * live + alive * k + pairs + live),
                alive * live * (k + 1))
    (and_rows,) = args
    f, w = and_rows.shape
    live = min(w, (kw["n_i"] + 31) // 32)
    return 4 * (f * live + 2 * kw["size"]), 3 * f * live


def closure_step_ops(r) -> int:
    """Word operations of ``closure_step``'s two passes on R: each lane
    popcounted (first pass) and written (second); each lane of a dense row
    (more than ``LIST_CAP`` set bits) copied and scanned, and one shared
    OR per entry of a sparse row's own list; then, for each set bit
    (i, k), one OR per entry of row k's list, or one per lane of row k
    when it is dense."""
    import torch
    from repro_torch.kernels import packed
    from repro_torch.kernels.closure import LIST_CAP
    n, w = r.shape
    cnt = torch.empty(n, dtype=torch.int64, device=r.device)
    indeg = torch.zeros(n, dtype=torch.int64, device=r.device)
    for r0 in range(0, n, 4096):
        rows = r[r0:r0 + 4096]
        cnt[r0:r0 + rows.shape[0]] = packed.popcount(rows).sum(dim=1)
        indeg += packed.unpack(rows, n).sum(dim=0)
    work = torch.where(cnt > LIST_CAP, w, cnt)       # per row k
    return int(2 * n * w + work.sum() + (indeg * work).sum())


OPS_PER_S = {"bitmm": INT8_TENSOR_OPS_PER_S}


def bound_ms(name: str, args, kw):
    """(least ms, "bytes" or "operations", bytes, operations): the larger
    of the bytes over the memory rate and the operations over the rate of
    the units that do them (the int8 tensor cores for bitmm, else the
    float32 rate outside the tensor cores)."""
    nbytes, ops = bound(name, args, kw)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S.get(name, INT32_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def edge_cases(torch, np):
    """Seeded ragged inputs: odd lane counts, K=1, tail bits, cut pages;
    for expand_pairs and gather_expand W % 4 != 0, a ragged n_i, cuts
    inside a 256-lane segment, zero fills, one wide row, all-ones rows, a
    misaligned input, Kc 0 to 40 and n_alive 0 to past F; for bitmm B = 1 to 257 across the MMA widths, M off the row tiles,
    W % 4 != 0, K below 32 W, a misaligned A, X as a transposed view, a
    float and a strided slice, sum mode, all-zero and all-ones A; for
    closure_step N = 32 to 1,056 at densities 0.001 to 0.3, rows past the
    list capacity among sparse ones, a hub column listed by every row
    (its own row sparse, then dense), power-law rows, all-zero and
    all-ones R; for transpose N = 32 to 4,128 (W = 1, 3, 12, 16, 33, 129)
    and a misaligned matrix."""
    from repro_torch.kernels import packed
    rng = np.random.default_rng(7)

    def lanes(*shape):
        return torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, size=shape, dtype=np.int64).astype(
                np.int32)).cuda()

    def binary(*shape):
        return torch.from_numpy(rng.random(shape) < 0.3).cuda()

    cases = []
    m = lanes(41, 132)
    m[-1] = 0
    for f, k, w32 in ((1, 1, 2), (5, 2, 6), (33, 3, 130), (300, 4, 132),
                      (130, 40, 66), (9, 70, 132), (257, 5, 62),
                      (1, 1, 132)):
        idx = torch.from_numpy(rng.integers(0, 41, size=(f, k)).astype(
            np.int32)).cuda()
        cases.append(("gather_intersect", (m, idx), {"w32": w32}))
    for f, k, w in ((3, 1, 4), (129, 2, 8), (256, 5, 132), (129, 64, 132),
                    (1, 3, 1024), (1023, 1, 260)):
        cases.append(("intersect", (lanes(f, k, w),), {}))
    # expand_pairs: W % 4 != 0 (4-byte loads), n_i off a multiple of 32,
    # a cut inside a 256-lane segment, a zero fill, one wide row, all-ones
    # rows, rows one lane off a 16-byte boundary
    for f, w, n_i, size in ((6, 4, 70, 1024), (6, 4, 70, 37),
                            (200, 6, 161, 2048), (1, 2, 33, 5),
                            (300, 130, 4160, 1 << 16), (40, 1024, 32768,
                                                       12345),
                            (1, 2384, 76288, 65536)):
        cases.append(("expand_pairs", (lanes(f, w),),
                      {"n_i": n_i, "size": size}))
    ones = torch.full((33, 300), -1, dtype=torch.int32, device="cuda")
    cases.append(("expand_pairs", (ones,), {"n_i": 9580, "size": 77777}))
    cases.append(("expand_pairs", (lanes(50 * 260 + 1)[1:].view(50, 260),),
                  {"n_i": 8300, "size": 1 << 16}))
    # gather_expand: Kc 0, 1, 3 and 40 (past a warp's 32 row pointers);
    # n_alive 0, 1, partial, all and past F; W % 4 != 0; a cut inside a
    # segment and a zero fill; count only; a misaligned mats
    mats = lanes(300, 132) | lanes(300, 132)
    fb = lanes(132) | lanes(132)
    for f, k, alive, n_i, size, expand in (
            (1024, 0, 1, 4224, 65536, True), (1024, 1, 700, 4200, 5000, True),
            (512, 3, 512, 4224, 1 << 16, True), (96, 40, 60, 4224, 4096, True),
            (256, 2, 0, 4224, 1000, True), (256, 2, 900, 4224, 1 << 15, True),
            (2048, 2, 1500, 4224, 0, False)):
        idx = torch.from_numpy(rng.integers(0, 300, size=(f, k)).astype(
            np.int32)).cuda()
        n_alive = torch.tensor(alive, dtype=torch.int64, device="cuda")
        cases.append(("gather_expand", (mats, fb, idx, n_alive),
                      {"n_i": n_i, "size": size, "expand": expand}))
    odd = lanes(300 * 130 + 1)[1:].view(300, 130)
    idx = torch.from_numpy(rng.integers(0, 300, size=(400, 2)).astype(
        np.int32)).cuda()
    cases.append(("gather_expand", (odd, lanes(130), idx,
                                    torch.tensor(333, device="cuda")),
                  {"n_i": 4150, "size": 1 << 14}))
    # bitmm: B across the MMA widths (zero columns of padding) and past
    # 256 (a second column tile); M one below and past the row tiles (384
    # rows for B <= 64, 128 above); W % 4 != 0 (4-byte copies of A); K
    # below 32 W with A's tail bits set (random words); X as the
    # simulation's transposed view, a contiguous float and a strided slice
    bitmm_shapes = [(300, 2048, b) for b in (1, 15, 16, 17, 64, 65, 128,
                                             256, 257)]
    bitmm_shapes += [(383, 2048, 64), (385, 2048, 64), (127, 2048, 128),
                     (129, 2048, 128), (300, 32 * 37, 64), (257, 1000, 1),
                     (1000, 32 * 37, 128), (33, 33, 8), (2051, 70000, 9)]
    for mm, k, b in bitmm_shapes:
        a = lanes(mm, (k + 31) // 32)
        for threshold in (True, False):
            cases.append(("bitmm", (a, binary(k, b)),
                          {"threshold": threshold}))
    a = lanes(300, 64)
    fb = binary(64, 2048)                       # the simulation's FB rows
    misaligned = lanes(300 * 64 + 1)[1:].view(300, 64)
    for threshold in (True, False):
        for x in (fb.t(), binary(2048, 64).float(), binary(2048, 128)[:, ::2]):
            cases.append(("bitmm", (a, x), {"threshold": threshold}))
        cases.append(("bitmm", (misaligned, binary(2048, 64)),
                      {"threshold": threshold}))
    w = 2 * 41
    for fill in (0, -1):                        # all-zero and all-ones A
        a = torch.full((300, w), fill, dtype=torch.int32, device="cuda")
        cases.append(("bitmm", (a, binary(32 * w, 8)), {"threshold": False}))
    ones = torch.full((300, 32), -1, dtype=torch.int32, device="cuda")
    cases.append(("bitmm", (ones, torch.ones((1000, 16), device="cuda")),
                  {"threshold": False}))       # every count exactly K
    # closure_step: N = 96 and 1,056 have lane counts off a multiple of 4
    for n in (32, 96, 512, 1024, 1056):
        for density in (0.001, 0.03, 0.3):
            dense = torch.from_numpy(rng.random((n, n)) < density).cuda()
            cases.append(("closure_step", (packed.pack(dense),), {}))
    for fill in (0, -1):                        # all-zero and all-ones R
        cases.append(("closure_step", (torch.full(
            (1024, 32), fill, dtype=torch.int32, device="cuda"),), {}))
    # rows past the list capacity (33 to 199 bits, every third row) among
    # sparse ones; a hub column 7 set in every row, its own row sparse and
    # then dense; Zipf row degrees
    for n in (96, 1024, 1056):
        mixed = np.where(np.arange(n) % 3 == 0, rng.integers(33, 200, n),
                         rng.integers(0, 33, n))
        hub = rng.integers(0, 8, n)
        for deg, hub_bits in ((mixed, None), (hub, 0), (hub, min(n, 100)),
                              (rng.zipf(1.6, n), None)):
            dense = np.zeros((n, n), dtype=bool)
            for i, d in enumerate(np.minimum(deg, n)):
                dense[i, rng.choice(n, size=d, replace=False)] = True
            if hub_bits is not None:
                dense[:, 7] = True
                dense[7, rng.choice(n, size=hub_bits, replace=False)] = True
            cases.append(("closure_step",
                          (packed.pack(torch.from_numpy(dense)).cuda(),), {}))
    for n in (32, 96, 384, 512, 1056, 4128):
        cases.append(("transpose", (packed.pack(binary(n, n)),), {}))
    cases.append(("transpose", (lanes(512 * 16 + 1)[1:].view(512, 16),), {}))
    return cases


def chain_case(torch, closure_step, closure_step_ref) -> None:
    """A 1,024-node chain needs all of its 10 steps: each changes R, the
    kernel equals its plain version at each, and the last gives the strict
    upper triangle."""
    from repro_torch.kernels import packed
    n = 1024
    idx = torch.arange(n - 1, device="cuda")
    dense = torch.zeros((n, n), dtype=torch.bool, device="cuda")
    dense[idx, idx + 1] = True
    r = packed.pack(dense)
    for step in range(10):
        nxt = closure_step(r)
        if not torch.equal(nxt, closure_step_ref(r)):
            raise AssertionError(f"closure_step disagrees with its plain "
                                 f"version on the chain at step {step + 1}")
        if torch.equal(nxt, r):
            raise AssertionError(f"the chain stopped changing at step "
                                 f"{step + 1} of 10")
        r = nxt
    upper = torch.ones((n, n), dtype=torch.int32, device="cuda").triu(1)
    if not torch.equal(r, packed.pack(upper.bool())):
        raise AssertionError("10 steps on the chain did not give its "
                             "closure")


# iterations of each timing: the closure step and the transpose work on a
# 727 MB matrix at the epinions graph; their plain versions take about a
# second and 0.16 s
REPS = {"cold": 20, "warm": 20, "eager": 50, "plain": 10, "plain_warmup": 3}
CLOSURE_REPS = {"cold": 4, "warm": 4, "eager": 5, "plain": 2,
                "plain_warmup": 1}
TRANSPOSE_REPS = {"cold": 10, "warm": 10, "eager": 10, "plain": 2,
                  "plain_warmup": 1}


def bitmm_library_ms(torch, a, x, threshold=True) -> float:
    """One ``torch._int_mm`` of the unpacked int8 A (M x 32 W, built 2,048
    rows at a time) by X as int8 (columns padded to a multiple of 8): the
    product as a library computes it.  Its ``> 0`` (threshold) or its
    counts must equal the kernel's output on the same inputs."""
    from repro_torch.kernels import packed
    from repro_torch.kernels.bitmm import bitmm
    m, w = a.shape
    k, b = x.shape
    dense = torch.empty((m, 32 * w), dtype=torch.int8, device="cuda")
    for r0 in range(0, m, 2048):
        dense[r0:r0 + 2048] = packed.unpack(a[r0:r0 + 2048], 32 * w)
    xi = torch.zeros((-(-b // 8) * 8, 32 * w), dtype=torch.int8,
                     device="cuda")
    xi[:b, :k] = x.t() != 0
    xi = xi.t()                          # (32 W, B8), column-major
    out = torch._int_mm(dense, xi)
    want = bitmm(a, x, threshold=threshold)
    got = out[:, :b] > 0 if threshold else out[:, :b].float()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("torch._int_mm of the unpacked A disagrees "
                             "with the bitmm kernel")
    ms = time_ms(torch, lambda: torch._int_mm(dense, xi), iters=10,
                 warmup=2)
    del dense, xi, out, got, want
    torch.cuda.empty_cache()
    return ms


def cuda_core_floor_ms(torch, a, x) -> float:
    """The bitmm product on the CUDA cores at best: M * W * B fused AND+OR
    (lop3) results at 64 a clock on every SM at the card's maximum SM
    clock."""
    m, w = a.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    return m * w * x.shape[1] / (sms * LOP3_PER_SM_CLOCK * mhz * 1e6) * 1e3


def expand_library_ms(torch, rows, n_i, size):
    """``torch.nonzero_static`` of the page's bits (F x n_i bool, unpacked
    2,048 rows at a time beforehand and not timed), the JAX reference's own
    form; its flat indices split into (row, column) must equal the
    kernel's pairs.  Where the card's PyTorch refuses it, ``torch.nonzero``
    and a slice.  Returns (ms, the call used); (None, why) if neither
    runs."""
    from repro_torch.kernels import packed
    from repro_torch.kernels.gather_intersect import expand_pairs
    f = rows.shape[0]
    bits = torch.empty((f, n_i), dtype=torch.bool, device="cuda")
    for r0 in range(0, f, 2048):
        bits[r0:r0 + 2048] = packed.unpack(rows[r0:r0 + 2048], n_i)
    flat = bits.view(-1)
    calls = (("torch.nonzero_static",
              lambda: torch.nonzero_static(flat, size=size, fill_value=0)),
             ("torch.nonzero and a slice",
              lambda: torch.nonzero(flat)[:size]))
    ms, used = None, "neither torch.nonzero_static nor torch.nonzero ran"
    for name, call in calls:
        try:
            got = call().view(-1)
        except (RuntimeError, NotImplementedError) as e:
            log(f"  {name} on {f} x {n_i} bits: {str(e).splitlines()[0]}")
            continue
        rid, cid = expand_pairs(rows, n_i=n_i, size=size)
        k = got.numel()
        if not (torch.equal(got // n_i, rid[:k].long())
                and torch.equal(got % n_i, cid[:k].long())):
            raise AssertionError(f"{name} disagrees with the expand_pairs "
                                 f"kernel")
        del got, rid, cid
        ms, used = time_ms(torch, call, iters=10, warmup=2), name
        break
    del bits, flat
    torch.cuda.empty_cache()
    return ms, used


def closure_library_ms(torch, r) -> float:
    """One ``torch.matmul`` of the unpacked bf16 R by itself: the product
    at the heart of the closure step, as a library computes it."""
    from repro_torch.kernels import packed
    n = r.shape[0]
    dense = torch.empty((n, n), dtype=torch.bfloat16, device="cuda")
    for r0 in range(0, n, 2048):
        dense[r0:r0 + 2048] = packed.unpack(r[r0:r0 + 2048], n)
    out = torch.empty_like(dense)
    ms = time_ms(torch, lambda: torch.matmul(dense, dense, out=out),
                 iters=2, warmup=1)
    del dense, out
    torch.cuda.empty_cache()
    return ms


def launch_floor_ms(torch, flush) -> float:
    """A launch of a kernel that does nothing, timed as ``ms`` is (cold
    L2, CUDA graph, the flush subtracted): the floor of every time in the
    ``kernels`` line."""
    from repro_torch.kernels import _build
    fn = _build.function("frontier_kernels", "rt_empty", [ctypes.c_void_p])
    return cold_ms(torch, lambda: _build.check(
        fn(torch.cuda.current_stream().cuda_stream), "empty_kernel"), flush,
        iters=REPS["cold"])


def and_rows_yardstick(torch, name, args, kw, flush):
    """A plain copy of the bytes an AND-row kernel moves, timed as its
    ``ms``: for ``gather_intersect`` an ``index_select`` of each frontier
    row's first gathered row, cut to ``w32`` lanes (the same bytes at
    K = 1); for ``intersect`` a copy of each slab row's first constraint
    row into the output's shape.  Returns (ms, what was timed)."""
    if name == "gather_intersect":
        matrix, idx = args
        src = matrix[:, :kw["w32"]]
        first = idx[:, 0].long()
        out = torch.empty((idx.shape[0], kw["w32"]), dtype=matrix.dtype,
                          device=matrix.device)
        call = (lambda: torch.index_select(src, 0, first, out=out))
        what = "torch.index_select of each row's first gathered row, w32 lanes"
    else:
        (rows,) = args
        out = torch.empty((rows.shape[0], rows.shape[2]), dtype=rows.dtype,
                          device=rows.device)
        call = (lambda: out.copy_(rows[:, 0]))
        what = "copy of each slab row's first constraint row, (F, W)"
    return cold_ms(torch, call, flush, iters=REPS["cold"]), what


def kernel_phase(torch, np, card: str, launches, per_query, device_calls,
                 inputs, shapes, closure_info, dense_info, spills):
    from repro_torch.kernels import packed, ref
    from repro_torch.kernels.bitmm import bitmm
    from repro_torch.kernels.closure import closure_step, transpose
    from repro_torch.kernels.gather_intersect import (expand_pairs,
                                                      gather_expand,
                                                      gather_intersect)
    from repro_torch.kernels.intersect import intersect

    kernels = {"gather_intersect": gather_intersect,
               "expand_pairs": expand_pairs, "gather_expand": gather_expand,
               "intersect": intersect, "bitmm": bitmm,
               "closure_step": closure_step, "transpose": transpose}
    plain = {"gather_intersect": ref.gather_intersect_ref,
             "expand_pairs": ref.expand_pairs_ref,
             "gather_expand": ref.gather_expand_ref,
             "intersect": ref.intersect_ref, "bitmm": ref.bitmm_ref,
             "closure_step": ref.closure_step_ref,
             "transpose": packed.transpose}
    for name, args, kw in edge_cases(torch, np):
        got = kernels[name](*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        if max_abs_err(as_tuple(got), as_tuple(want)) != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {[tuple(a.shape) for a in args]} {kw}")
    chain_case(torch, closure_step, ref.closure_step_ref)
    log(f"edge cases: all {len(kernels)} kernels equal their plain versions "
        f"(closure_step: also every step of a 1,024-node chain)")

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def measure(name, args, kw, kern=None, reps=REPS):
        """Hold the kernel to its plain version on one input, then time
        both and compute the bound."""
        kern = kern or kernels[name]
        got = kern(*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(as_tuple(got), as_tuple(want))
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max abs err {err})")
        del got, want
        least, by, nbytes, ops = bound_ms(name, args, kw)
        out = {"shape": {f"a{i}": list(a.shape) if a.dim() else int(a)
                         for i, a in enumerate(args)} | kw,
               "max_abs_err": err,
               "ms": cold_ms(torch, lambda: kern(*args, **kw), flush,
                             iters=reps["cold"]),
               "warm_ms": replay_ms(torch, lambda: kern(*args, **kw),
                                    iters=reps["warm"]),
               "eager_ms": time_ms(torch, lambda: kern(*args, **kw),
                                   iters=reps["eager"]),
               "plain_ms": time_ms(torch, lambda: plain[name](*args, **kw),
                                   iters=reps["plain"],
                                   warmup=reps["plain_warmup"]),
               "bound_ms": least, "bound_by": by}
        log(f"[{card}] kernel {name} at {out['shape']}: {out['ms']:.6f} ms "
            f"(CUDA graph, cold L2), {out['warm_ms']:.6f} ms warm, "
            f"{out['eager_ms']:.6f} ms eager, plain {out['plain_ms']:.6f} ms "
            f"eager, bound {out['bound_ms']:.6f} ms ({nbytes} B, {ops} ops),"
            f" max abs err {err}")
        return out

    def measure_into(name, r, reps):
        """``measure`` with the kernel writing into one buffer."""
        buf = torch.empty_like(r)           # the timed calls write here
        m = measure(name, (r,), {}, kern=lambda x: kernels[name](x, out=buf),
                    reps=reps)
        del buf
        return m

    def histogram(name):
        """Every launch shape the paths gave ``name``, largest count
        first: held to the plain version, timed cold, with its launches
        and bound."""
        out = []
        for key, (n, args, kw) in sorted(shapes.get(name, {}).items(),
                                         key=lambda e: (-e[1][0], e[0])):
            got = kernels[name](*args, **kw)
            want = plain[name](*args, **kw)
            torch.cuda.synchronize()
            err = max_abs_err(as_tuple(got), as_tuple(want))
            if err != 0:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at launch shape {key}")
            del got, want
            distinct = (int(args[1].unique().numel())
                        if name == "gather_intersect" else None)
            out.append({"shape": list(key), "launches": n, "max_abs_err": err,
                        "distinct_rows": distinct,
                        "ms": cold_ms(torch, lambda: kernels[name](*args,
                                                                   **kw),
                                      flush, iters=REPS["cold"]),
                        "bound_ms": bound_ms(name, args, kw)[0]})
            log(f"[{card}] kernel {name} launch shape {key}: {n} launches, "
                f"{out[-1]['ms']:.6f} ms (cold L2), bound "
                f"{out[-1]['bound_ms']:.6f} ms")
        return out

    floor_ms = launch_floor_ms(torch, flush)
    log(f"[{card}] launch floor (an empty kernel, CUDA graph, cold L2): "
        f"{floor_ms:.6f} ms")

    def closure_row(r):
        m = measure_into("closure_step", r, CLOSURE_REPS)
        n, w = r.shape
        log(f"[{card}] kernel closure_step: the dense product would do "
            f"{n * n * w} word operations per step "
            f"({n * n * w / INT32_OPS_PER_S * 1e3:.3f} ms at 67 T/s, the "
            f"float32 rate outside the tensor cores) and 2 N^3 = "
            f"{2 * n ** 3} on the int8 tensor cores "
            f"({2 * n ** 3 / INT8_TENSOR_OPS_PER_S * 1e3:.3f} ms at 1,979 "
            f"TOP/s); R holds {set_bits(r)} set bits")
        m["library_ms"] = closure_library_ms(torch, r)
        log(f"[{card}] kernel closure_step: library torch.matmul of the "
            f"unpacked bf16 R by itself {m['library_ms']:.3f} ms")
        return m

    rows = []
    for name in REPLACES:
        library_ms = None
        if name == "closure_step":
            m = closure_row(inputs[name][1][0])
            library_ms = m["library_ms"]
        elif name == "transpose":
            words = inputs[name][1][0]
            m = measure_into(name, words, TRANSPOSE_REPS)
            # yardsticks of the same bytes (no PyTorch call transposes a
            # packed bit matrix): a plain copy, and the lanes transposed
            # as 32-bit words
            copy = torch.empty_like(words)
            word_t = torch.empty(words.shape[::-1], dtype=words.dtype,
                                 device=words.device)
            m["copy_ms"] = cold_ms(torch, lambda: copy.copy_(words), flush,
                                   iters=TRANSPOSE_REPS["cold"])
            m["word_transpose_ms"] = cold_ms(
                torch, lambda: word_t.copy_(words.t()), flush,
                iters=TRANSPOSE_REPS["cold"])
            del copy, word_t
            log(f"[{card}] kernel transpose: a copy of the same bytes "
                f"{m['copy_ms']:.6f} ms, the lanes transposed as 32-bit "
                f"words {m['word_transpose_ms']:.6f} ms (CUDA graph, cold "
                f"L2)")
        else:
            m = measure(name, *inputs[name][1:])
        if name == "bitmm":
            args, kw = inputs[name][1:]
            library_ms = bitmm_library_ms(torch, *args, **kw)
            log(f"[{card}] kernel bitmm: library torch._int_mm of the "
                f"unpacked int8 A by X {library_ms:.6f} ms; CUDA-core floor "
                f"{cuda_core_floor_ms(torch, *args):.6f} ms")
        by_path = {path: int(counts.get(name, 0))
                   for path, counts in launches.items()}
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name],
               "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "launches_per_query": [q.get(name, 0) for q in per_query],
               **{k: m[k] for k in ("max_abs_err", "ms", "warm_ms",
                                    "eager_ms", "plain_ms", "bound_ms",
                                    "bound_by")},
               "library_ms": library_ms, "shape": m["shape"]}
        if name == "bitmm":
            # (queries, bitmm launches) of each TorchGM call on the serve
            # path: four launches per simulation pass for the whole batch
            row["launches_per_device_call"] = device_calls
            # the batch of 4 (B = 32): the first 32 columns of the same
            # operand, a view of the same layout
            (a, x), kw = inputs[name][1:]
            row["batch_of_4"] = measure(name, (a, x[:, :32]), kw)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     row["batch_of_4"]["max_abs_err"])
            row["batch_of_4"]["library_ms"] = bitmm_library_ms(
                torch, a, x[:, :32], **kw)
            log(f"[{card}] kernel bitmm at B = 32: library torch._int_mm of "
                f"the unpacked int8 A by X "
                f"{row['batch_of_4']['library_ms']:.6f} ms")
        if name == "expand_pairs":
            args, kw = inputs[name][1:]
            library_ms, row["library_call"] = expand_library_ms(
                torch, args[0], kw["n_i"], kw["size"])
            row["library_ms"] = library_ms
            # the AND rows of the serve path's largest expanded level (the
            # page the enumerator expanded before gather_expand fused it)
            (mats, fb_row, idx, n_alive), lkw = inputs["gather_expand"][1:]
            page = ref.gather_level_ref(mats, fb_row, idx, n_alive,
                                        n_i=lkw["n_i"])
            pkw = {"n_i": lkw["n_i"], "size": lkw["size"]}
            serve = measure(name, (page,), pkw)
            serve["library_ms"], serve["library_call"] = expand_library_ms(
                torch, page, **pkw)
            row["serve"] = serve
            row["max_abs_err"] = max(row["max_abs_err"],
                                     serve["max_abs_err"])
            del page
            log(f"[{card}] kernel expand_pairs: library {row['library_call']}"
                f" {library_ms} ms; at the serve page "
                f"{serve['library_call']} {serve['library_ms']} ms")
        if name == "gather_expand":
            # the same level counted only, as every last level runs it
            # (pass 1 and the sum, no pairs)
            args, kw = inputs[name][1:]
            row["count_only"] = measure(name, args, kw | {"expand": False})
        if name == "transpose":
            row.update({k: m[k] for k in ("copy_ms", "word_transpose_ms")})
        if name in HISTOGRAM:
            hist = histogram(name)
            on_paths = by_path["gm_match"] + by_path["serve"]
            if sum(h["launches"] for h in hist) != on_paths:
                raise AssertionError(f"{name}: the shape histogram holds "
                                     f"{sum(h['launches'] for h in hist)} "
                                     f"launches, the paths made {on_paths}")
            row["shapes"] = hist
            row["path_ms"] = sum(h["launches"] * h["ms"] for h in hist)
            row["launch_floor_ms"] = floor_ms
            row["copy_ms"], row["copy_call"] = and_rows_yardstick(
                torch, name, *inputs[name][1:], flush)
            row["ptxas_spills"] = {k: list(v) for k, v in spills.items()
                                   if k.split("<")[0] == f"{name}_kernel"}
            log(f"[{card}] kernel {name}: {len(hist)} launch shapes, "
                f"{row['path_ms']:.6f} ms summed over the paths' launches "
                f"(cold); yardstick {row['copy_call']} {row['copy_ms']:.6f} "
                f"ms; launch floor {floor_ms:.6f} ms")
        if name == "closure_step":
            row["closure"] = closure_info
            # the dense closure: every row of its last step is dense
            dense = closure_row(inputs["closure_step@human"][1][0])
            row["human"] = dense | {"closure": dense_info}
            row["max_abs_err"] = max(row["max_abs_err"],
                                     dense["max_abs_err"])
        log(f"[{card}] kernel {name}: launches {by_path} (GM.match path per "
            f"query {row['launches_per_query']})")
        rows.append(row)
    return rows


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="epinions profile scale (1.0 = 75,879 nodes)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import GM
    from repro_torch.data.graphs import paper_profile_graph
    from repro_torch.kernels import _build

    card = card_line()
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")       # CUDA context, outside the timings
    torch.cuda.synchronize()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}; context "
        f"{time.perf_counter() - t0:.2f} s")
    built = _build.ensure_built()
    log(f"[{card}] nvcc build of {len(_build.sources())} source(s): "
        f"{built:.2f} s")
    for src in _build.sources():
        kernel = "?"
        for line in _build.report(src.stem).splitlines():
            if "entry function" in line:
                kernel = kernel_name(line)
            elif "registers" in line or "spill" in line:
                log(f"  {src.stem} {kernel}: {line.strip()}")
    spills = ptxas_spills(_build)
    spilled = {k: v for k, v in spills.items() if any(v)}
    log(f"[{card}] ptxas spills (store, load bytes) of {', '.join(NO_SPILL)}:"
        f" {json.dumps(spills, sort_keys=True)}")

    capture = capture_inputs()
    t0 = time.perf_counter()
    graph = paper_profile_graph("epinions", scale=args.scale, seed=0)
    t1 = time.perf_counter()
    gm = GM(graph)                       # reachability index (host)
    graph.reachability().bits_t()
    t2 = time.perf_counter()
    log(f"[{card}] graph epinions scale={args.scale}: {graph.n} nodes, "
        f"{graph.n_edges} edges, {graph.num_labels} labels; generate "
        f"{t1 - t0:.2f} s, reachability index {t2 - t1:.2f} s (host)")

    t0 = time.perf_counter()
    gm_launches, per_query = gm_path(torch, card, graph, gm)
    t1 = time.perf_counter()
    serve_launches, device_calls, queries, refs, exact = serve_path(
        torch, card, graph, gm, capture)
    capture.on = False
    level = capture.keep_largest("gather_expand", level_size)
    log(f"[{card}] serve path: largest expanded level kept for the kernel "
        f"phase: {level[1]} gathered rows")
    t2 = time.perf_counter()
    closure_launches, last_r, closure_t, closure_info = closure_path(
        torch, card, graph, queries, refs, exact)
    capture.inputs["closure_step"] = (last_r.numel(), (last_r,), {})
    capture.inputs["transpose"] = (closure_t.numel(), (closure_t,), {})
    if args.scale == 1.0 and closure_info["steps"] != 17:
        raise AssertionError(f"{closure_info['steps']} closure steps at "
                             f"the full epinions profile, not 17")
    t3 = time.perf_counter()
    human_r, dense_info = dense_closure_case(torch, card)
    capture.inputs["closure_step@human"] = (human_r.numel(), (human_r,), {})
    t4 = time.perf_counter()
    int64_launches = int64_count_case(torch, card)
    t5 = time.perf_counter()
    log(f"[{card}] GM.match path {t1 - t0:.1f} s, serve path "
        f"{t2 - t1:.1f} s, closure path {t3 - t2:.1f} s, dense closure "
        f"{t4 - t3:.1f} s, count past 2^31 {t5 - t4:.1f} s")
    rows = kernel_phase(torch, np, card,
                        {"gm_match": gm_launches, "serve": serve_launches,
                         "closure": closure_launches,
                         "int64_count": int64_launches},
                        per_query, device_calls, capture.inputs,
                        capture.shapes, closure_info, dense_info, spills)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    if leaked:
        raise AssertionError(f"imported modules outside the port: {leaked}")
    log(f"[{card}] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    if spilled:
        raise AssertionError(f"ptxas reports spills in {spilled}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
