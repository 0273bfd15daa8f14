#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--scale S]

1. Builds the CUDA kernels from the sources in the checkout (``nvcc``,
   ``sm_90a``) and prints the build time and the compiler's register
   report.
2. Drives the main path through the user's entry point: ``GM(graph).match``
   on a graph of the paper's Table 1 ``epinions`` profile (75,879 nodes at
   ``--scale 1.0``, power-law, 20 Zipf labels) with 4-node ``D`` and ``H``
   queries, each run with ``enum_method="frontier-device-resident"`` in
   count and in materialize mode and with ``"frontier-device"``.  Every
   device run must equal the host ``"frontier"`` method byte for byte,
   run the method it was asked for with no degradation, and move the
   launch counts of ``gather_intersect``, ``expand_pairs`` and
   ``intersect`` (counts are reset just before the device runs and read
   just after).
3. Holds each kernel to its plain PyTorch version on the card, exactly, on
   the largest input the main path gave it and on a few ragged edge
   cases (K above one warp's pointer chunk included), and times both with
   CUDA events beside the kernel's memory bound: ``ms`` is the kernel's
   device time per call with a cold L2 (each call captured in a CUDA
   graph behind a write of a buffer larger than L2, whose own time is
   replayed alone and subtracted), ``warm_ms`` the same without the
   flush, ``eager_ms`` the wrapper called eagerly (host overhead
   included), ``plain_ms`` the plain version eagerly.
4. Prints the ``kernels`` JSON line, the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero.  Without CUDA, or without the
repository's ``src/repro_torch`` beside it, it exits 2 and prints no result.
It imports nothing of JAX and nothing of the reference package.
"""

from __future__ import annotations

import argparse
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
SOURCE = "src/repro_torch/kernels/csrc/frontier_kernels.cu"
REPLACES = {
    "gather_intersect": "src/repro/kernels/gather_intersect.py:96",
    "expand_pairs": "src/repro/kernels/gather_intersect.py:124",
    "intersect": "src/repro/kernels/intersect.py:79",
}
QUERIES = (("D", 0), ("D", 1), ("H", 0), ("H", 1))


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
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# -------------------------------------------------------------- main path
class Capture:
    """Records the largest input each kernel wrapper received on the main
    path (the wrapper itself, and its launch count, are untouched)."""

    def __init__(self, module):
        self.inputs = {}
        for name, size in (
                ("gather_intersect",
                 lambda m, i, w32: i.shape[0] * i.shape[1] * w32),
                ("expand_pairs", lambda a, n_i, size: a.numel() + size),
                ("intersect", lambda r: r.numel())):
            setattr(module, name, self._wrap(name, getattr(module, name),
                                             size))

    def _wrap(self, name, fn, size):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            s = size(*args, **kw)
            if s > self.inputs.get(name, (-1,))[0]:
                self.inputs[name] = (s, args, kw)
            return out
        return wrapped


def main_path(torch, card: str, scale: float):
    from repro_torch.core import GM, GMOptions
    from repro_torch.core.mjoin import device_intersector
    from repro_torch.data.graphs import paper_profile_graph
    from repro_torch.data.queries import random_query_from_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.torchgm import frontier

    capture = Capture(frontier)
    t0 = time.perf_counter()
    graph = paper_profile_graph("epinions", scale=scale, seed=0)
    t1 = time.perf_counter()
    gm = GM(graph)                       # reachability index (host)
    graph.reachability().bits_t()
    t2 = time.perf_counter()
    log(f"[{card}] graph epinions scale={scale}: {graph.n} nodes, "
        f"{graph.n_edges} edges, {graph.num_labels} labels; generate "
        f"{t1 - t0:.2f} s, reachability index {t2 - t1:.2f} s (host)")

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
                          for n in REPLACES})
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
        res = rm.rig.resident
        log(f"[{card}] query {q.name} {q}: rig {rm.rig_nodes} nodes / "
            f"{rm.rig_edges} edges, resident {rm.resident_bytes} B, "
            f"results {ref.count} (truncated={ref.truncated}, tuples "
            f"{ref.tuples.shape[0]}); host front half {rm.matching_s:.4f} s; "
            f"enumerate s: host frontier {ref.enumerate_s:.4f}, resident "
            f"count {rc.enumerate_s:.4f}, resident materialize "
            f"{rm.enumerate_s:.4f} (kernel_s {res.kernel_s:.4f}, "
            f"{res.calls} gathers, {res.expand_calls} expands), "
            f"frontier-device {dv.enumerate_s:.4f} (kernel_s "
            f"{dv_kernel_s:.4f}); h2d/d2h B: resident count "
            f"{rc.h2d_bytes}/{rc.d2h_bytes}, resident materialize "
            f"{rm.h2d_bytes}/{rm.d2h_bytes}, frontier-device "
            f"{dv.h2d_bytes}/{dv.d2h_bytes}; launches (its three device "
            f"runs) {json.dumps(launched, sort_keys=True)}")
    log(f"main path launches: {json.dumps(total, sort_keys=True)}")
    for name in REPLACES:
        if total.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    return total, per_query, capture.inputs


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
    (and_rows,) = args
    f, w = and_rows.shape
    live = min(w, (kw["n_i"] + 31) // 32)
    return 4 * (f * live + 2 * kw["size"]), 3 * f * live


def edge_cases(torch, np):
    """Seeded ragged inputs: odd lane counts, K=1, tail bits, cut pages."""
    rng = np.random.default_rng(7)

    def lanes(*shape):
        return torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, size=shape, dtype=np.int64).astype(
                np.int32)).cuda()

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
    return cases


def kernel_phase(torch, np, card: str, launches, per_query, inputs):
    from repro_torch.kernels import ref
    from repro_torch.kernels.gather_intersect import (expand_pairs,
                                                      gather_intersect)
    from repro_torch.kernels.intersect import intersect

    kernels = {"gather_intersect": gather_intersect,
               "expand_pairs": expand_pairs, "intersect": intersect}
    plain = {"gather_intersect": ref.gather_intersect_ref,
             "expand_pairs": ref.expand_pairs_ref,
             "intersect": ref.intersect_ref}
    for name, args, kw in edge_cases(torch, np):
        got = kernels[name](*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        if max_abs_err(got, want) != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {[tuple(a.shape) for a in args]} {kw}")
    log("edge cases: all three kernels equal their plain versions")

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    rows = []
    for name in REPLACES:
        _, args, kw = inputs[name]
        kern = kernels[name]
        got = kern(*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max abs err {err})")
        ms = cold_ms(torch, lambda: kern(*args, **kw), flush)
        warm_ms = replay_ms(torch, lambda: kern(*args, **kw))
        eager_ms = time_ms(torch, lambda: kern(*args, **kw))
        plain_ms = time_ms(torch, lambda: plain[name](*args, **kw), iters=10)
        nbytes, ops = bound(name, args, kw)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name],
               "launches": int(launches.get(name, 0)),
               "launches_per_query": [q[name] for q in per_query],
               "max_abs_err": err, "ms": ms, "warm_ms": warm_ms,
               "eager_ms": eager_ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None}
        shapes = {k: tuple(a.shape) for k, a in
                  zip(("a0", "a1"), args)}
        log(f"[{card}] kernel {name} at {shapes} {kw}: {ms:.6f} ms "
            f"(CUDA graph, cold L2), {warm_ms:.6f} ms warm, {eager_ms:.6f} "
            f"ms eager, plain {plain_ms:.6f} ms eager, bound "
            f"{row['bound_ms']:.6f} ms ({nbytes} B), max abs err {err}, "
            f"main-path launches {row['launches']} "
            f"(per query {row['launches_per_query']})")
        rows.append(row)
    return rows


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

    launches, per_query, inputs = main_path(torch, card, args.scale)
    rows = kernel_phase(torch, np, card, launches, per_query, inputs)

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
