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
   the device without overflow, and ``bitmm`` and ``expand_pairs`` must be
   launched (counts reset just before the phase and read just after).
4. Holds each kernel to its plain PyTorch version on the card, exactly, on
   the largest input its path gave it (``expand_pairs``: also the serve
   path's last frontier page) and on ragged edge cases, and times
   both with CUDA events beside the kernel's bound: ``ms`` is the kernel's
   device time per call with a cold L2 (each call captured in a CUDA
   graph behind a write of a buffer larger than L2, whose own time is
   replayed alone and subtracted), ``warm_ms`` the same without the
   flush, ``eager_ms`` the wrapper called eagerly (host overhead
   included), ``plain_ms`` the plain version eagerly.
5. Prints the ``kernels`` JSON line, the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero.  Without CUDA, or without the
repository's ``src/repro_torch`` beside it, it exits 2 and prints no result.
It imports nothing of JAX and nothing of the reference package.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RESIDENT = "frontier-device-resident"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12          # H100 SXM non-tensor 32-bit rate
FLUSH_BYTES = 256 << 20          # written between timed calls: > 50 MB L2
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"gather_intersect": CSRC + "frontier_kernels.cu",
           "expand_pairs": CSRC + "frontier_kernels.cu",
           "intersect": CSRC + "frontier_kernels.cu",
           "bitmm": CSRC + "bitmm.cu"}
REPLACES = {
    "gather_intersect": "src/repro/kernels/gather_intersect.py:96",
    "expand_pairs": "src/repro/kernels/gather_intersect.py:124",
    "intersect": "src/repro/kernels/intersect.py:79",
    "bitmm": "src/repro/kernels/bitmm.py:76",
}
GM_KERNELS = ("gather_intersect", "expand_pairs", "intersect")
SERVE_KERNELS = ("bitmm", "expand_pairs")
# two of the four queries of the first slice (D s1: the largest resident
# RIG; H s0: the smallest), so that the serve path fits the time limit
QUERIES = (("D", 1), ("H", 0))
N_REQUESTS = 12
BATCH = 8
# frontier rows of the whole-graph matcher: 10 of the 12 requests finish on
# the device without overflow
CAPACITY = 1 << 16
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


def replay_ms(torch, fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured into one CUDA graph,
    replayed ``replays`` times, so host-side wrapper overhead drops out."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def cold_ms(torch, fn, flush) -> float:
    """Device time per call with a cold L2: each call follows a write of
    ``flush`` (larger than L2) in the graph; the flushes alone are timed
    the same way and subtracted."""
    def flushed():
        flush.zero_()
        fn()
    return (replay_ms(torch, flushed, replays=10)
            - replay_ms(torch, flush.zero_, replays=10))


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype mismatch: {g.shape} "
                                 f"{g.dtype} vs {w.shape} {w.dtype}")
        if g.numel():
            err = max(err, int((g.double() - w.double()).abs().max()))
    return err


# -------------------------------------------------------------- main path
class Capture:
    """Records, under a key, the largest input a kernel wrapper received
    through one module's name for it on the main paths (the wrapper
    itself, and its launch count, are untouched); ``on`` pauses it."""

    def __init__(self, specs):
        self.inputs = {}
        self.on = True
        for module, name, key, size in specs:
            setattr(module, name, self._wrap(key, getattr(module, name),
                                             size))

    def _wrap(self, key, fn, size):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if self.on:
                s = size(*args, **kw)
                if key not in self.inputs or s > self.inputs[key][0]:
                    self.inputs[key] = (s, args, kw)
            return out
        return wrapped


def capture_inputs():
    """The GM.match path's executor kernels, the serve path's bitmm and
    the whole-graph enumerator's expand_pairs (every page there has the
    same shape: the last one is kept, a full page when a request
    overflowed)."""
    import repro_torch.torchgm.enumerate as enumerator
    from repro_torch.kernels import ops
    from repro_torch.torchgm import frontier
    page = itertools.count()
    return Capture((
        (frontier, "gather_intersect", "gather_intersect",
         lambda m, i, w32: i.shape[0] * i.shape[1] * w32),
        (frontier, "expand_pairs", "expand_pairs",
         lambda a, n_i, size: a.numel() + size),
        (frontier, "intersect", "intersect", lambda r: r.numel()),
        (ops, "bitmm", "bitmm",
         lambda a, x, threshold=True: a.numel() * x.shape[1]),
        (enumerator, "expand_pairs", "expand_pairs@serve",
         lambda a, n_i, size: (a.numel() + size, next(page))),
    ))


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
    ``bitmm`` launches of its call, keyed by the reduced query's shape
    (the matcher itself is untouched)."""

    def __init__(self, cls):
        from repro_torch.kernels import launch_counts
        self.by_query = {}
        self.calls = []
        self.matcher = None
        for name in ("match", "match_batch"):
            fn = getattr(cls, name)

            def wrapped(gm, arg, *a, _fn=fn, **kw):
                before = launch_counts().get("bitmm", 0)
                out = _fn(gm, arg, *a, **kw)
                bitmm = launch_counts().get("bitmm", 0) - before
                self.matcher = gm
                qs, rs = (arg, out) if isinstance(out, list) else \
                    ([arg], [out])
                self.calls.append((len(qs), bitmm))
                for q, r in zip(qs, rs):
                    self.by_query[shape_key(q)] = (r, len(qs), bitmm)
                return out
            setattr(cls, name, wrapped)


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
    log(f"serve path launches: {json.dumps(total, sort_keys=True)}")
    if on_device == 0:
        raise AssertionError("no request was answered on the device "
                             "without overflow")
    for name in SERVE_KERNELS:
        if total.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serve path")
    return total, calls.calls


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
        a, x = args
        m, w = a.shape
        k, b = x.shape
        threshold = kw.get("threshold", True)
        out = m * b * (1 if threshold else 4)
        # AND + OR per lane and column (threshold); AND + popc + add (sum)
        return (4 * m * w + k * b * x.element_size() + out,
                m * w * b * (2 if threshold else 3))
    (and_rows,) = args
    f, w = and_rows.shape
    live = min(w, (kw["n_i"] + 31) // 32)
    return 4 * (f * live + 2 * kw["size"]), 3 * f * live


def edge_cases(torch, np):
    """Seeded ragged inputs: odd lane counts, K=1, tail bits, cut pages;
    for bitmm M and K off every block, B = 1 and 128, sum mode, all-zero
    and all-ones A."""
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
                      (130, 40, 66), (9, 70, 132)):
        idx = torch.from_numpy(rng.integers(0, 41, size=(f, k)).astype(
            np.int32)).cuda()
        cases.append(("gather_intersect", (m, idx), {"w32": w32}))
    for f, k, w in ((3, 1, 4), (129, 2, 8), (256, 5, 132), (129, 64, 132)):
        cases.append(("intersect", (lanes(f, k, w),), {}))
    for f, w, n_i, size in ((6, 4, 70, 1024), (6, 4, 70, 37),
                            (200, 6, 161, 2048), (1, 2, 33, 5)):
        cases.append(("expand_pairs", (lanes(f, w),),
                      {"n_i": n_i, "size": size}))
    for mm, k, b in ((257, 1000, 1), (1000, 32 * 37, 128), (33, 33, 8),
                     (2051, 70000, 9)):
        a = lanes(mm, (k + 31) // 32)
        for threshold in (True, False):
            cases.append(("bitmm", (a, binary(k, b)),
                          {"threshold": threshold}))
    w = 2 * 41
    for fill in (0, -1):                        # all-zero and all-ones A
        a = torch.full((300, w), fill, dtype=torch.int32, device="cuda")
        cases.append(("bitmm", (a, binary(32 * w, 8)), {"threshold": False}))
    return cases


def kernel_phase(torch, np, card: str, launches, per_query, device_calls,
                 inputs):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitmm import bitmm
    from repro_torch.kernels.gather_intersect import (expand_pairs,
                                                      gather_intersect)
    from repro_torch.kernels.intersect import intersect

    kernels = {"gather_intersect": gather_intersect,
               "expand_pairs": expand_pairs, "intersect": intersect,
               "bitmm": bitmm}
    plain = {"gather_intersect": ref.gather_intersect_ref,
             "expand_pairs": ref.expand_pairs_ref,
             "intersect": ref.intersect_ref, "bitmm": ref.bitmm_ref}
    for name, args, kw in edge_cases(torch, np):
        got = kernels[name](*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        if max_abs_err(as_tuple(got), as_tuple(want)) != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {[tuple(a.shape) for a in args]} {kw}")
    log("edge cases: all four kernels equal their plain versions")

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def measure(name, args, kw):
        """Hold the kernel to its plain version on one input, then time
        both and compute the bound."""
        kern = kernels[name]
        got = kern(*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(as_tuple(got), as_tuple(want))
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max abs err {err})")
        nbytes, ops = bound(name, args, kw)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        out = {"shape": {k: list(a.shape) for k, a in
                         zip(("a0", "a1"), args)} | kw,
               "max_abs_err": err,
               "ms": cold_ms(torch, lambda: kern(*args, **kw), flush),
               "warm_ms": replay_ms(torch, lambda: kern(*args, **kw)),
               "eager_ms": time_ms(torch, lambda: kern(*args, **kw)),
               "plain_ms": time_ms(torch, lambda: plain[name](*args, **kw),
                                   iters=10),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"[{card}] kernel {name} at {out['shape']}: {out['ms']:.6f} ms "
            f"(CUDA graph, cold L2), {out['warm_ms']:.6f} ms warm, "
            f"{out['eager_ms']:.6f} ms eager, plain {out['plain_ms']:.6f} ms "
            f"eager, bound {out['bound_ms']:.6f} ms ({nbytes} B, {ops} ops),"
            f" max abs err {err}")
        return out

    rows = []
    for name in REPLACES:
        m = measure(name, *inputs[name][1:])
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
               "library_ms": None, "shape": m["shape"]}
        if name == "bitmm":
            # (queries, bitmm launches) of each TorchGM call on the serve
            # path: four launches per simulation pass for the whole batch
            row["launches_per_device_call"] = device_calls
        if name == "expand_pairs":
            # the whole-graph enumerator's frontier page on the serve path
            serve = measure(name, *inputs["expand_pairs@serve"][1:])
            row["serve"] = serve
            row["max_abs_err"] = max(row["max_abs_err"],
                                     serve["max_abs_err"])
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
    for src, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

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
    serve_launches, device_calls = serve_path(torch, card, graph, gm,
                                              capture)
    t2 = time.perf_counter()
    log(f"[{card}] GM.match path {t1 - t0:.1f} s, serve path "
        f"{t2 - t1:.1f} s")
    rows = kernel_phase(torch, np, card,
                        {"gm_match": gm_launches, "serve": serve_launches},
                        per_query, device_calls, capture.inputs)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    if leaked:
        raise AssertionError(f"imported modules outside the port: {leaked}")
    log(f"[{card}] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
