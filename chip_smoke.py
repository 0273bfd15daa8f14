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
4. Sharded path, on the serve path's device graph (the ``TorchGM``'s
   ``dg``, before it is freed): ``make_local_mesh(1, 1)`` starts a
   one-process NCCL group, ``shard_graph_arrays`` hands back the graph's
   own stack as the one tile (no copy), and
   ``torchgm.distributed.gm_serve_step`` (4 passes, ``top_k`` 4,096,
   ``MAX_Q, MAX_E = 8, 16``) serves the serve path's 12 requests, reduced
   as the engine reduces them, in batches of 8 (``pack_y`` off) and 4
   (``pack_y`` on).  Each call must launch ``bitmm`` 18 times (4 a pass +
   2 for the edge counts; counts reset just before the call and read just
   after) and nothing else; its FB (``sharded_double_simulation``),
   ``fb_sizes``, ``edge_counts`` and ``candidates`` must equal, exactly,
   ``torchgm.simulation``'s single-device ``double_simulation``,
   ``fb_sizes``, ``rig_edge_counts`` and the plain rule (ascending set
   bits, the first 4,096, then -1).  Prints each call's seconds (fenced;
   and those of the same call again, outside the counted run, whose
   answer must be the same, with its 18 ``bitmm`` launches and the whole
   call timed by CUDA events) and each collective's calls and payload
   bytes as counted from the tensors passed (the bytes on the wire, a
   ring-model estimate, in the log only); runs ``rig_gm``'s dry-run unit
   at the batch of 8 once for real on the same mesh (its FLOPs,
   collectives and peak, for the dry-run phase); destroys the group.
5. Closure path, on the same graph object, after the serve path's engine
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
6. Dense closure: the paper's Table 1 ``human`` profile (4,674 nodes,
   uniform, n_pad 5,120), whose closure is all ones, built the same way
   on the card and held to the host index's stack; prints each step's
   time (from the second step on every row takes the kernel's whole-row
   path).
7. A count past 2^31: a directed cycle of 46,341 nodes with one label,
   ``TorchGM`` from the host index with 65,536 frontier rows, and a
   2-node ``//`` query, whose count must equal the host reachability
   index's row sizes summed (n^2 = 2,147,488,281), with no overflow.
8. Holds each kernel to its plain PyTorch version on the card, exactly, on
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
   ``gather_intersect`` and ``intersect``).  ``bitmm`` is also timed at
   B = 32 (the batch of 4) and in sum mode at the sharded path's
   first-pass input (the batch of 8), and its CUDA-core floor printed.
   ``gather_intersect`` and ``intersect`` are also held to their plain
   versions and timed cold at every launch shape the ``GM.match`` and
   serve paths gave them (the shape histogram, with each shape's launches
   and the cold ms summed over them), beside the launch floor (an empty
   kernel in the same harness) and a plain copy of the same bytes
   (``index_select`` of the gathered rows cut to ``w32``; a copy of the
   slab's output bytes).  Bounds: bytes over 3.35 TB/s against
   operations over 1,979 TOP/s for ``bitmm`` (the int8 tensor cores) and
   over 67 T/s for the others.
9. LM trainer path, after the graph paths' device tensors are freed (it
   launches none of the kernels above: its products are ``torch.matmul``
   / ``torch.einsum``; the launch counts must stay zero):
   qwen1.5-4b whole (40 layers, published widths, 3.95 B parameters,
   bf16, random weights from a seeded generator) takes 4 AdamW steps
   through ``launch.train.make_step`` on the token pipeline at B = 2,
   T = 1,024; each step fenced and timed (seconds, tokens/s, 6·N·D model
   FLOP/s and its share of the 989 TFLOP/s dense bf16 peak of NVIDIA's
   H100 SXM data sheet), a fifth split into forward + backward and
   update, a sixth under ``FlopCounterMode`` (its FLOPs, for the dry-run
   phase), and the peak of ``torch.cuda.max_memory_allocated``.  Every
   loss and gradient norm must be finite and the first loss within
   (ln V, ln V + 1); 8 ``decode_step`` calls from an empty cache must
   equal ``forward``'s logits at the same positions (max |err| <= 0.25,
   rms <= 0.02), and the flash (kv_chunk 256) and chunked (loss_chunk
   256) losses the dense one within 0.01.  deepseek-moe-16b at full
   width, 2 of its 28 layers (its AdamW state for all 28 does not fit in
   80 GB), takes 2 steps with the same numbers and the routed choices
   dropped at capacity.  qwen2-7b's smoke config in float32 (TF32 off)
   on the card and on the CPU from the same weights and batch: loss and
   gradients within 1e-5, parameters, m and v after 2 ``apply_updates``
   from the CPU's gradients within 1e-6 (relative to each leaf's largest
   entry).  ``ElasticTrainer`` at smoke size on the card crashes after
   step 3 of 6 and resumes from its step-2 checkpoint; its final state
   must equal an uninterrupted run's.
10. GNN / DIN trainer path, after the LM path frees its tensors (float32,
   TF32 off; it launches none of the kernels above: its products are
   ``torch.matmul``, its scatters ``index_add``, its gathers
   ``index_select``; the launch counts must stay zero).  Seven runs at the
   published widths, random weights from a seeded generator, data from
   the port's builders (seed 0), each AdamW step (the default
   ``AdamWConfig`` but for ``total_steps``) through
   ``launch.train.make_step``, fenced and timed: graphsage-reddit on
   15-10 sampled batches of 1,024 seeds (``minibatch_lg``: a CSR graph of
   232,965 nodes and 114,615,892 edges built on the host, the sampler run
   every step), 4 steps; gin-tu over the whole of ``ogb_products`` (2,449,029
   nodes, 61,859,140 edges), 3; schnet on 128 molecules (``molecule``), 4;
   graphcast (16 layers, d 512) over the 166,400-node grid and
   41,984-node mesh that ``_abstract_batch("minibatch_lg")`` gives, 3;
   DIN at ``train_batch`` (65,536 examples), 4; DIN forward under
   ``no_grad`` at ``serve_p99`` and ``serve_bulk`` and
   ``retrieval_scores`` over 262,144 candidates (``retrieval_cand``'s
   10^6 need about 90 GB unsharded: listed under ``reduced``).  Each run
   prints its seconds a step (or a call), edges or examples a second,
   ``model_flops`` of its shape against the 67 TFLOP/s FP32 peak of
   NVIDIA's H100 SXM data sheet, its peak memory above what it found and
   its host data seconds (and, sampled, the sampler's share of a step);
   every loss and gradient norm must be finite.  The five smoke configs,
   gin-tu at ``full_graph_sm`` (Cora's size, d_feat 1,433) and DIN at
   ``serve_p99`` on the card against the CPU from the same weights: loss
   within 1e-5 relative, every gradient leaf within 1e-5 of its largest
   entry (DIN's attention MLP: or within 1e-6 of its gradient with the
   scores' gradient in absolute value, see ``DIN_ATTN_REL``; the line
   gives that scale over each attn_* leaf's own largest entry);
   ``retrieval_scores`` against ``forward`` on 512 candidates within 1e-5;
   and
   ``launch.train.main --scale full --steps 3`` for gin-tu,
   graphsage-reddit and din, each in a fresh checkpoint directory.
11. Sharded GNN training step, after the GNN / DIN path frees its
   tensors (float32, TF32 off; no kernel of the port may launch): gin-tu
   at its published width over the whole of ``ogb_products`` padded as
   ``_pad512`` pads it (2,449,408 nodes, 61,859,328 edges; the padding
   masked and inert) through ``models.gnn_dist.sharded_train_step`` on a
   1 x 1 NCCL mesh, the edges sorted by destination on the card (the
   destination partition at one rank; the sort fenced and timed).  The
   single-device gradients and one step of ``launch.train.make_step``
   from the same weights and batch are the yardstick: the sharded
   step's loss within 2e-5 relative, every gradient leaf within 1e-5 of
   its largest entry or 4 times the spread of two single-device runs
   (float atomics; the updated leaves' error is reported: AdamW's first
   step normalises each entry by its own gradient).
   Then 3 steps fenced and timed (seconds, edges a second, the share of
   the 67 TFLOP/s FP32 peak), one split into forward + backward and
   update, the peak memory, each collective's calls and payload bytes,
   and one step under ``torch.profiler`` (its kernels' device time, the
   device's idle share, the kernels that take it).
12. The paper's own arch, ``rig_gm`` (``configs.pattern.PatternArch``):
   its smoke on the card for seeds 0 to 3 (``TorchGM``: ``bitmm`` and
   ``gather_expand``), each count equal to the host ``match``'s with no
   overflow; then ``closure_256k``: one ``closure_step`` at n_pad 2^18 (R
   262,144 x 8,192 lanes, 8 GiB: the email profile cut to 2^18 nodes,
   its adjacency transposed so that its in-degree hubs are rows past the
   list capacity, ORed with the identity, built from its pairs on the
   card), every row past the list capacity and 4,096 random rows of R'
   equal to the plain rule computed on the card row by row (the OR of
   R's rows at the row's set bits, ORed with the row), timed by CUDA
   events beside its bound (and again with the dense rows cleared), with
   its set bits before and after and its peak memory.  The phase's
   launches join the ``kernels`` line (``launches_by_path["pattern"]``;
   ``closure_step``'s row takes a ``closure_256k`` entry).
13. The dry-run units (``launch.dryrun``: each unit traced once on
   ``meta`` tensors over a fake process group, nothing allocated, no
   kernel launched; the launch counts must stay zero): ``gm_serve_step``'s
   unit at the sharded path's shape (the serve path's graph, the batch of
   8), which the sharded path also ran for real on its 1 x 1 NCCL mesh
   (``FlopCounterMode``, ``Collectives``, peak memory), traced on a fake
   1 x 1 group: its collectives' calls and payload bytes and its FLOPs
   must equal the real run's, and its peak and its temporaries (the peak
   less the arguments) each be within 20% of the real run's;
   qwen1.5-4b's train unit at the LM path's shape (B = 2, T = 1,024,
   1 x 1): its FLOPs must equal ``FlopCounterMode`` over one real step of
   the LM path and its peak be within 20% of the LM path's
   ``max_memory_allocated``; the H100 model's bound for that step beside
   its measured time (printed); ``rig_gm`` ``serve_1m`` and qwen1.5-4b
   ``train_4k`` traced on the fake (16, 16) production mesh, with their
   roofline terms (printed).
14. Prints the ``lm``, ``gnn``, ``gnn_dist``, ``pattern`` and ``dryrun``
   JSON lines, the ``kernels`` JSON line, the card's name and power limit,
   and last ``{"ok": true, "device": {...}}``.

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
# the sharded path's serve step, as the paper's configuration sets it
# (src/repro/configs/pattern.py:31 and :122)
MAX_Q, MAX_E = 8, 16
TOP_K = 4096
SHARDED_PASSES = 4
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
    dg = jgm.dg
    calls.restore()
    return total, calls.calls, queries, refs, exact, dg


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


class Collectives:
    """Records each ``all_reduce`` / ``all_gather`` / ``reduce_scatter`` of
    ``torch.distributed`` that a run calls: (name, ranks in its group,
    payload bytes per rank: the tensor reduced, the tensor each rank
    sends, the tensors each rank reduces); the functions themselves are
    untouched."""

    def __init__(self):
        import torch.distributed as dist
        self.calls = []
        self.saved = {name: getattr(dist, name) for name in
                      ("all_reduce", "all_gather", "reduce_scatter")}

        def all_reduce(t, *a, group=None, **kw):
            self.calls.append(("all_reduce", dist.get_world_size(group),
                               t.numel() * t.element_size()))
            return self.saved["all_reduce"](t, *a, group=group, **kw)

        def all_gather(parts, t, *a, group=None, **kw):
            self.calls.append(("all_gather", dist.get_world_size(group),
                               t.numel() * t.element_size()))
            return self.saved["all_gather"](parts, t, *a, group=group, **kw)

        def reduce_scatter(t, parts, *a, group=None, **kw):
            self.calls.append(("reduce_scatter", dist.get_world_size(group),
                               sum(p.numel() * p.element_size()
                                   for p in parts)))
            return self.saved["reduce_scatter"](t, parts, *a, group=group,
                                                **kw)

        dist.all_reduce, dist.all_gather = all_reduce, all_gather
        dist.reduce_scatter = reduce_scatter

    def restore(self):
        import torch.distributed as dist
        for name, fn in self.saved.items():
            setattr(dist, name, fn)

    def summary(self):
        """{name: [calls, payload bytes]}, as counted from the tensors
        passed."""
        out = {}
        for name, _, nbytes in self.calls:
            row = out.setdefault(name, [0, 0])
            row[0] += 1
            row[1] += nbytes
        return out

    def ring_estimate(self):
        """{name: bytes on the wire per rank} under a ring algorithm (an
        all-reduce sends 2 (n - 1) / n of its payload, an all-gather
        receives (n - 1) payloads, a reduce-scatter sends (n - 1) / n of
        its payload): a model, not a reading, since NCCL may choose another
        algorithm; for the log only."""
        share = {"all_reduce": lambda n, b: 2 * (n - 1) * b // n,
                 "all_gather": lambda n, b: (n - 1) * b,
                 "reduce_scatter": lambda n, b: (n - 1) * b // n}
        out = {}
        for name, n, nbytes in self.calls:
            out[name] = out.get(name, 0) + share[name](n, nbytes)
        return out


class KernelEvents:
    """Times each call of one ``repro_torch.kernels.ops`` wrapper with
    CUDA events while it is installed; the wrapper and its launch count
    are untouched."""

    def __init__(self, torch, name: str):
        from repro_torch.kernels import ops
        self.events, self._saved = [], (ops, name, getattr(ops, name))
        fn = self._saved[2]

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.events.append((start, end))
            return out

        setattr(ops, name, timed)

    def restore(self):
        module, name, fn = self._saved
        setattr(module, name, fn)

    def ms(self):
        return [start.elapsed_time(end) for start, end in self.events]


def plain_candidates(torch, fb, top_k: int):
    """The plain rule of the serve step's candidates: each FB row's set
    bits in ascending order, the first ``top_k``, then -1."""
    n_pad = fb.shape[-1]
    ids = torch.where(fb, torch.arange(n_pad, dtype=torch.int32,
                                       device=fb.device), n_pad)
    ids = ids.sort(dim=-1).values[..., :top_k]
    return torch.where(ids == n_pad, -1, ids)


def sharded_path(torch, card: str, dg, queries):
    """The sharded double simulation and serve step on a 1 x 1 mesh
    (NCCL) over the serve path's device graph, whose stack is the one
    tile.  Returns the phase's launch counts, the first pass' ``bitmm``
    input of the batch of 8 and the phase's numbers."""
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.torchgm import distributed, simulation
    from repro_torch.torchgm.encoding import encode_batch

    t0 = time.perf_counter()
    mesh = make_local_mesh(1, 1)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"the card's mesh runs "
                                 f"{dist.get_backend()}, not nccl")
        for axis in mesh.mesh_dim_names:     # each group's communicator
            dist.all_reduce(torch.zeros(1, device="cuda"),
                            group=mesh.get_group(axis))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        mats, labels = distributed.shard_graph_arrays(dg, mesh)
        if (mats.data_ptr(), mats.shape) != (dg.stack.data_ptr(),
                                             dg.stack.shape):
            raise AssertionError("the 1 x 1 mesh's tile is not the graph's "
                                 "own stack")
        total, info, first, unit_real = {}, [], None, None
        for lo, hi, pack_y in ((0, BATCH, False),
                               (BATCH, len(queries), True)):
            # the queries as the engine hands them to the device
            qts = encode_batch([q.transitive_reduction()
                                for q in queries[lo:hi]], MAX_Q, MAX_E)
            coll = Collectives()
            torch.cuda.synchronize()
            reset_launch_counts()            # just before the serve step
            t1 = time.perf_counter()
            try:
                out = distributed.gm_serve_step(
                    mats, labels, qts, mesh, n_passes=SHARDED_PASSES,
                    top_k=TOP_K, pack_y=pack_y)
                torch.cuda.synchronize()
            finally:
                coll.restore()
            step_s = time.perf_counter() - t1
            launched = launch_counts()       # just after the serve step
            want_launches = 4 * SHARDED_PASSES + 2
            if launched != {"bitmm": want_launches}:
                raise AssertionError(f"gm_serve_step launched {launched}, "
                                     f"not bitmm {want_launches} times")
            for k, v in launched.items():
                total[k] = total.get(k, 0) + v
            # the same call again, outside the counted run: a warm time,
            # and the device time of its bitmm launches against the call's
            # (CUDA events)
            timer = KernelEvents(torch, "bitmm")
            call0 = torch.cuda.Event(enable_timing=True)
            call1 = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            try:
                call0.record()
                again = distributed.gm_serve_step(
                    mats, labels, qts, mesh, n_passes=SHARDED_PASSES,
                    top_k=TOP_K, pack_y=pack_y)
                call1.record()
                torch.cuda.synchronize()
            finally:
                timer.restore()
            warm_s = time.perf_counter() - t1
            bitmm_ms = timer.ms()
            call_ms = call0.elapsed_time(call1)
            if len(bitmm_ms) != want_launches:
                raise AssertionError(f"{len(bitmm_ms)} timed bitmm calls "
                                     f"in the second gm_serve_step, not "
                                     f"{want_launches}")
            if not all(torch.equal(a, b) for a, b in zip(again, out)):
                raise AssertionError("a second gm_serve_step call gave "
                                     "another answer")
            del again
            t2 = time.perf_counter()
            fb = distributed.sharded_double_simulation(
                mats, labels, qts, mesh, n_passes=SHARDED_PASSES,
                pack_y=pack_y)
            want = simulation.double_simulation(dg, qts,
                                                n_passes=SHARDED_PASSES)
            checks = {
                "fb": torch.equal(fb, want),
                "fb_sizes": torch.equal(out.fb_sizes,
                                        simulation.fb_sizes(want)),
                "edge_counts": torch.equal(
                    out.edge_counts,
                    simulation.rig_edge_counts(dg, qts, want)),
                "candidates": torch.equal(out.candidates,
                                          plain_candidates(torch, want,
                                                           TOP_K))}
            torch.cuda.synchronize()
            if not all(checks.values()):
                raise AssertionError(f"the sharded serve step on requests "
                                     f"{lo}-{hi - 1} differs from the "
                                     f"single-device functions: {checks}")
            if first is None:
                # A alone (a copy), so that the graph's stack is freed
                # with the graph
                x = simulation.initial_fb(dg, qts)
                first = (mats[0].clone(), x.reshape(-1, x.shape[-1]).t())
                unit_real = serve_unit_real(torch, card, dg, qts, mesh)
            coll_bytes = coll.summary()
            info.append({"requests": [lo, hi], "pack_y": pack_y,
                         "seconds": step_s, "warm_seconds": warm_s,
                         "warm_call_ms": call_ms,
                         "warm_bitmm_ms": sum(bitmm_ms),
                         "launches": launched,
                         "collectives": coll_bytes,
                         "max_candidates": int(out.fb_sizes.max())})
            log(f"[{card}] sharded path, requests {lo}-{hi - 1} (pack_y "
                f"{pack_y}): gm_serve_step {step_s:.4f} s (fenced; "
                f"{warm_s:.4f} s called again: {call_ms:.6f} ms between "
                f"CUDA events, of it the {len(bitmm_ms)} bitmm launches "
                f"{sum(bitmm_ms):.6f} ms, "
                f"{100 * sum(bitmm_ms) / call_ms:.1f}%; each "
                f"{min(bitmm_ms):.6f}-{max(bitmm_ms):.6f} ms), bitmm "
                f"launches {launched['bitmm']}; collectives [calls, "
                f"payload B] {json.dumps(coll_bytes, sort_keys=True)} "
                f"(bytes on the wire per rank, ring-model estimate at "
                f"1 x 1: {json.dumps(coll.ring_estimate(), sort_keys=True)}"
                f"); largest "
                f"candidate set {info[-1]['max_candidates']}; FB, fb_sizes,"
                f" edge_counts and candidates equal the single-device "
                f"functions ({time.perf_counter() - t2:.2f} s to check)")
    finally:
        dist.destroy_process_group()
    log(f"[{card}] sharded path: 1 x 1 mesh on nccl, n_pad {dg.n_pad}, "
        f"tile {list(mats.shape)} (the graph's own stack); group set-up "
        f"{setup_s:.4f} s; {time.perf_counter() - t0:.1f} s in all")
    log(f"sharded path launches: {json.dumps(total, sort_keys=True)}")
    return total, first, {"setup_s": setup_s, "batches": info,
                          "unit": unit_real}


def serve_unit_shape(n_pad: int) -> dict:
    """The shape of ``gm_serve_step``'s dry-run unit at the sharded path's
    batch of 8: the serve path's graph, 4 passes, top-K 4,096."""
    return dict(kind="serve", n_pad=n_pad, batch=BATCH,
                passes=SHARDED_PASSES, top_k=TOP_K)


def serve_unit_real(torch, card: str, dg, qts, mesh) -> dict:
    """``rig_gm``'s serve unit at the serve path's graph and the batch of
    8 (``serve_unit_shape``), built by ``build_dryrun`` on the 1 x 1 NCCL
    mesh and run for real once, outside the counted runs: its FLOPs
    (``FlopCounterMode``), its collectives' calls and payload bytes
    (``Collectives``) and its peak (its arguments' bytes plus the most
    allocated above what the call found), for the dry-run phase to hold
    its trace to."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import argument_bytes, call, place

    shape = serve_unit_shape(dg.n_pad)
    unit = get_config("rig_gm").build_dryrun(shape, mesh)
    args = place(unit, (dg.stack, dg.labels, qts))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counter = FlopCounterMode(display=False)
    coll = Collectives()
    t0 = time.perf_counter()
    try:
        with counter:
            call(unit, args)
        torch.cuda.synchronize()
    finally:
        coll.restore()
    out = {"shape": shape, "seconds": time.perf_counter() - t0,
           "flops": counter.get_total_flops(),
           "collectives": coll.summary(),
           "argument_bytes": argument_bytes(args),
           "peak_bytes": argument_bytes(args)
           + torch.cuda.max_memory_allocated() - base}
    log(f"[{card}] gm_serve_step's dry-run unit run for real: "
        f"{json.dumps(out, sort_keys=True)}")
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


# ----------------------------------------------------------------- LM path
# NVIDIA's H100 SXM data sheet: dense bf16 on the tensor cores (no
# sparsity), at the full 700 W power limit
BF16_PEAK_FLOPS = 989e12
BF16_PEAK_SOURCE = "NVIDIA H100 SXM data sheet, dense bf16, 989 TFLOP/s"
LM_DEVICE = "cuda"
LM_BATCH, LM_SEQ = 2, 1024
# (arch, layers (None: all), optimizer steps) of the full-width runs:
# deepseek-moe-16b's AdamW state for all 28 layers does not fit in 80 GB
LM_RUNS = (("qwen1.5-4b", None, 4), ("deepseek-moe-16b", 2, 2))
LM_DECODE = 8
LM_CHUNK = 256
# bf16 tolerances at full width: the decode path runs other matmul shapes
# than forward (M = 2 rows, not 2,048), so each of 40 layers may round a
# bf16 output an ulp (2^-8) apart; logits have unit scale
DECODE_ATOL = 0.25
DECODE_RMS = 0.02
# flash and chunked losses against the dense loss (about 12.4): the same
# rounding points, another summation order
LOSS_ATOL = 0.01
# float32, TF32 off: the card against the CPU from the same weights
CARD_CPU_REL = {"loss": 1e-5, "grads": 1e-5, "updated": 1e-6}


def lm_train(torch, card: str, arch_id: str, n_layers, steps: int):
    """``steps`` optimizer steps of one LM arch at its published width
    (depth ``n_layers`` or all), bf16, random weights from a seeded
    generator, through ``launch.train.make_step`` on the token pipeline at
    B = 2, T = 1,024; each step fenced and timed.  Returns the numbers,
    the parameters and the last batch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import LMArch
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch.train import make_step
    from repro_torch.models import transformer as tf
    from repro_torch.train import AdamWConfig, apply_updates, init_state
    from repro_torch.train import tree as tr

    cfg = get_config(arch_id).cfg
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    arch = LMArch(cfg)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()     # what the run found allocated
    t0 = time.perf_counter()
    params = tf.TransformerLM(cfg, generator=torch.Generator(
        LM_DEVICE).manual_seed(0)).params
    state = {"params": params, "opt": init_state(params)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, batch=LM_BATCH, seq_len=LM_SEQ, seed=0))
    # the launcher's optimizer settings (launch/train.py main)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=min(20, steps // 5),
                       total_steps=steps, weight_decay=0.01)
    step = make_step(lambda p, b: tf.loss_fn(p, b, cfg), ocfg)
    flops = arch.model_flops(dict(kind="train", seq_len=LM_SEQ,
                                  global_batch=LM_BATCH))
    out = {"layers": cfg.n_layers, "of_layers": get_config(arch_id).cfg
           .n_layers, "n_params": cfg.n_params(),
           "n_active_params": cfg.n_active_params(), "batch": LM_BATCH,
           "seq_len": LM_SEQ, "init_s": init_s, "model_flops_per_step": flops,
           "step_s": [], "tokens_per_s": [], "model_flops_per_s": [],
           "bf16_peak_share": [], "loss": [], "grad_norm": []}
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(LM_DEVICE)
                 for k, v in pipe.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["step_s"].append(dt)
        out["tokens_per_s"].append(LM_BATCH * LM_SEQ / dt)
        out["model_flops_per_s"].append(flops / dt)
        out["bf16_peak_share"].append(flops / dt / BF16_PEAK_FLOPS)
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        log(f"[{card}] {arch_id} ({cfg.n_layers} layers) step {i}: "
            f"{dt:.4f} s, {LM_BATCH * LM_SEQ / dt:.1f} tokens/s, "
            f"{flops / dt / 1e12:.2f} model TFLOP/s "
            f"({100 * flops / dt / BF16_PEAK_FLOPS:.2f}% of the bf16 peak), "
            f"loss {out['loss'][-1]:.4f}, grad_norm "
            f"{out['grad_norm'][-1]:.4f}")
    # the run's own peak: parameters, gradients, AdamW state, activations
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["found_allocated_bytes"] = base
    # where a step's time goes: one step more, its forward + backward and
    # its update fenced and timed apart
    params = state["params"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = tf.loss_fn(params, batch, cfg)
    grads = tr.unflatten_like(params, torch.autograd.grad(
        loss, tr.leaves(params)))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    apply_updates(params, grads, state["opt"], ocfg)
    torch.cuda.synchronize()
    out["split_s"] = {"forward_backward": t1 - t0,
                      "update": time.perf_counter() - t1}
    del loss, grads
    # the FLOPs of one step as FlopCounterMode counts them, for the dry-run
    # phase to hold its trace of the same step to
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        state, _ = step(state, batch)
    out["step_flops"] = counter.get_total_flops()
    log(f"[{card}] {arch_id}: {cfg.n_params():,} parameters, init "
        f"{init_s:.2f} s, peak memory {out['peak_bytes']:,} B above the "
        f"{base:,} B found allocated; a further "
        f"step split: forward + backward "
        f"{out['split_s']['forward_backward']:.4f} s, update "
        f"{out['split_s']['update']:.4f} s")
    bad = [v for v in out["loss"] + out["grad_norm"] if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{arch_id}: non-finite loss or grad_norm {bad}")
    return out, state["params"], batch, cfg


def lm_checks(torch, card: str, params, batch, cfg, out: dict) -> None:
    """The first loss near ln V + 0.5 (logits of unit variance at init);
    ``LM_DECODE`` decode steps from an empty cache equal to forward's
    logits at the same positions; the flash (kv_chunk 256) and chunked
    (loss_chunk 256) losses equal to the dense loss."""
    import dataclasses

    from repro_torch.models import transformer as tf

    ln_v = math.log(cfg.vocab)
    if not ln_v < out["loss"][0] < ln_v + 1:
        raise AssertionError(f"first loss {out['loss'][0]} outside "
                             f"(ln V, ln V + 1) = ({ln_v}, {ln_v + 1})")
    tokens = batch["tokens"][:, :LM_DECODE]
    with torch.no_grad():
        full = tf.forward(params, tokens, cfg)
        cache = tf.init_cache(cfg, LM_BATCH, LM_DECODE, LM_DEVICE)
        steps = []
        for i in range(LM_DECODE):
            logits, cache = tf.decode_step(params, cache,
                                           tokens[:, i:i + 1], cfg)
            steps.append(logits)
        diff = torch.cat(steps, 1) - full
        out["decode_max_abs_err"] = float(diff.abs().max())
        out["decode_rms_err"] = float(diff.square().mean().sqrt())
        out["logits_rms"] = float(full.square().mean().sqrt())
        losses = {}
        for name, over in (("dense", {}),
                           ("flash", dict(flash_attention=True,
                                          kv_chunk=LM_CHUNK)),
                           ("chunked", dict(chunked_loss=True,
                                            loss_chunk=LM_CHUNK))):
            losses[name] = float(tf.loss_fn(
                params, batch, dataclasses.replace(cfg, **over)))
    out["loss_dense_flash_chunked"] = [losses[k] for k in
                                       ("dense", "flash", "chunked")]
    log(f"[{card}] {cfg.name}: decode x {LM_DECODE} against forward: max "
        f"|err| {out['decode_max_abs_err']:.6f}, rms {out['decode_rms_err']:.6f}"
        f" (logits rms {out['logits_rms']:.4f}); losses dense / flash / "
        f"chunked {losses['dense']:.6f} / {losses['flash']:.6f} / "
        f"{losses['chunked']:.6f}")
    if not (out["decode_max_abs_err"] <= DECODE_ATOL
            and out["decode_rms_err"] <= DECODE_RMS):
        raise AssertionError(f"decode differs from forward: max "
                             f"{out['decode_max_abs_err']} (limit "
                             f"{DECODE_ATOL}), rms {out['decode_rms_err']} "
                             f"(limit {DECODE_RMS})")
    for name in ("flash", "chunked"):
        if not abs(losses[name] - losses["dense"]) <= LOSS_ATOL:
            raise AssertionError(f"{name} loss {losses[name]} against dense "
                                 f"{losses['dense']} (limit {LOSS_ATOL})")


def moe_dropped(torch, params, tokens, cfg) -> list:
    """Routed choices dropped at capacity in each MoE layer, in a no-grad
    forward of ``tokens``: each layer's router on its own input, the
    dispatch rule of ``moe_ffn``."""
    from repro_torch.models import transformer as tf

    dropped, moe_ffn = [], tf.moe_ffn

    def counting(x, layer, cfg):
        cap = math.ceil(x.shape[1] * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor)
        sel = torch.topk((x @ layer["router"]).float(), cfg.top_k,
                         dim=-1).indices
        dropped.append(int((~tf.moe_dispatch(sel, cfg.n_experts,
                                             cap)[2]).sum()))
        return moe_ffn(x, layer, cfg)

    tf.moe_ffn = counting
    try:
        with torch.no_grad():
            tf.forward_hidden(params, tokens, cfg)
    finally:
        tf.moe_ffn = moe_ffn
    return dropped


def _max_rel(torch, got, want, scale: float = 0.0) -> float:
    """max |got - want| over the largest |want| (or ``scale``, if larger),
    on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), scale, 1e-30)


def lm_card_vs_cpu(torch, card: str) -> dict:
    """qwen2-7b's smoke config (GQA, QKV bias) in float32, TF32 off, on the
    card and on the CPU from the same weights and batch: the loss, every
    gradient leaf, and the parameters, m and v after two
    ``apply_updates`` from the CPU's gradients (a step from each device's
    own gradients would differ by up to lr where a gradient is within its
    summation noise of eps)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import AdamWConfig, apply_updates, init_state
    from repro_torch.train import tree as tr

    cfg = get_config("qwen2-7b").smoke_config()
    host = tf.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = []
        for dev in ("cpu", LM_DEVICE):
            params = tr.map_tree(lambda p: p.to(dev).requires_grad_(True),
                                 host)
            loss = tf.loss_fn(params, {k: v.to(dev) for k, v in
                                       batch.items()}, cfg)
            runs.append((params, loss.detach(), torch.autograd.grad(
                loss, tr.leaves(params))))
        cpu_grads = tr.unflatten_like(runs[0][0], runs[0][2])
        updated = []
        for params, _, _ in runs:
            dev = tr.leaves(params)[0].device
            grads = tr.map_tree(lambda g: g.to(dev), cpu_grads)
            st = init_state(params)
            for _ in range(2):
                params, st, _ = apply_updates(params, grads, st, ocfg)
            updated.append((params, st["m"], st["v"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = {"loss": _max_rel(torch, runs[1][1], runs[0][1]),
           "grads": max(_max_rel(torch, a, b)
                        for a, b in zip(runs[1][2], runs[0][2])),
           "updated": max(_max_rel(torch, a, b) for a, b in
                          zip(tr.leaves(updated[1]), tr.leaves(updated[0])))}
    log(f"[{card}] card against CPU, qwen2-7b smoke, float32: max relative "
        f"error loss {out['loss']:.3e}, gradients {out['grads']:.3e}, after "
        f"2 updates {out['updated']:.3e} (limits {CARD_CPU_REL})")
    for k, limit in CARD_CPU_REL.items():
        if not out[k] <= limit:
            raise AssertionError(f"card against CPU: {k} {out[k]} > {limit}")
    return out


def lm_elastic(torch, card: str) -> dict:
    """``ElasticTrainer`` on the card at smoke size (qwen2-7b, B = 2,
    T = 16): 6 steps uninterrupted, and 6 steps that crash after step 3
    (``fail_at``) and resume from the step-2 checkpoint; the final state
    must be equal."""
    import tempfile
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_lm, make_step
    from repro_torch.train import (AdamWConfig, ElasticConfig,
                                   ElasticTrainer, SimulatedFailure,
                                   init_state)
    from repro_torch.train import tree as tr

    args = SimpleNamespace(scale="smoke", batch=2, seq_len=16, seed=0)
    _, init, loss, batch_fn = build_lm(get_config("qwen2-7b"), args,
                                       torch.device(LM_DEVICE))
    step = make_step(loss, AdamWConfig(lr=1e-2, warmup_steps=1,
                                       total_steps=6))

    def fresh():
        params = init()
        return {"params": params, "opt": init_state(params)}

    def trainer(ckpt_dir):
        return ElasticTrainer(
            step_fn=step, make_batch=batch_fn, init_state=fresh,
            cfg=ElasticConfig(checkpoint_dir=ckpt_dir, checkpoint_every=2),
            get_step=lambda s: int(s["opt"]["step"]))

    with tempfile.TemporaryDirectory() as tmp:
        whole = trainer(f"{tmp}/whole")
        whole.start_or_resume()
        whole.run(6)
        first = trainer(f"{tmp}/crash")
        first.start_or_resume()
        try:
            first.run(6, fail_at=3)
            raise AssertionError("no simulated failure at step 3")
        except SimulatedFailure as e:
            crashed = e.step
        second = trainer(f"{tmp}/crash")
        resumed = second.start_or_resume()
        second.run(6)
    equal = all(torch.equal(a, b) for a, b in
                zip(tr.leaves(second.state), tr.leaves(whole.state)))
    out = {"crashed_at": crashed, "resumed_from": resumed["step"],
           "final_step": int(second.state["opt"]["step"]),
           "equal_to_uninterrupted": equal}
    log(f"[{card}] elastic trainer on the card: {out}")
    if not (equal and crashed == 3 and resumed == {"resumed": True,
                                                     "step": 2}):
        raise AssertionError(f"elastic resume: {out}")
    return out


def lm_path(torch, card: str) -> dict:
    """The LM trainer path (no kernel of the port: its products are
    torch.matmul / torch.einsum): qwen1.5-4b whole, deepseek-moe-16b at
    full width and 2 layers, the card against the CPU, the elastic
    trainer.  Launch counts are reset just before and read just after,
    and must stay zero."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    reset_launch_counts()                # just before the LM path
    result = {"card": card, "peak_source": BF16_PEAK_SOURCE}
    for arch_id, n_layers, steps in LM_RUNS:
        out, params, batch, cfg = lm_train(torch, card, arch_id, n_layers,
                                           steps)
        if cfg.is_moe:
            out["dropped"] = moe_dropped(torch, params, batch["tokens"], cfg)
            out["routed_per_layer"] = LM_BATCH * LM_SEQ * cfg.top_k
            log(f"[{card}] {arch_id}: choices dropped at capacity per layer "
                f"{out['dropped']} of {out['routed_per_layer']}")
        else:
            lm_checks(torch, card, params, batch, cfg, out)
        result[arch_id] = out
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
    result["card_vs_cpu"] = lm_card_vs_cpu(torch, card)
    result["elastic"] = lm_elastic(torch, card)
    launched = launch_counts()           # just after the LM path
    if any(launched.values()):
        raise AssertionError(f"the LM path launched kernels: {launched}")
    result["seconds"] = time.perf_counter() - t0
    log(f"[{card}] LM path {result['seconds']:.1f} s")
    return result


# ------------------------------------------------------ GNN / DIN trainer
# float32 outside the tensor cores (the phase runs with TF32 off): NVIDIA's
# H100 SXM data sheet, dense, at the full 700 W power limit
FP32_PEAK_FLOPS = 67e12
FP32_PEAK_SOURCE = "NVIDIA H100 SXM data sheet, dense FP32, 67 TFLOP/s"
GNN_DEVICE = "cuda"
# (run, arch, shape, optimizer steps) of the training runs
GNN_RUNS = (("sage_reddit_sampled", "graphsage-reddit", "minibatch_lg", 4),
            ("gin_products_full", "gin-tu", "ogb_products", 3),
            ("schnet_molecule", "schnet", "molecule", 4),
            ("graphcast_mesh", "graphcast", "minibatch_lg", 3),
            ("din_train", "din", "train_batch", 4))
# runs whose batch is built and uploaded once, not every step
WHOLE_BATCH_RUNS = ("gin_products_full", "graphcast_mesh")
# DIN's 10^6 candidates need about 90 GB unsharded (the reference's dry
# run shards them 16-32 ways): one card scores 262,144
RETRIEVAL_CANDIDATES = 262_144
SERVE_CALLS = 5
# float32, TF32 off: the card against the CPU from the same weights
GNN_CARD_CPU_REL = 1e-5
DIN_ATTN_REL = 1e-6
# DIN's attention MLP: the gradient of its scores sums to zero over each
# history (the softmax is shift-invariant), so its leaves' gradients are
# sums whose terms cancel (attn_b2's exactly: its gradient is zero) and a
# float32 rounding of the scores' gradient shows there at 2e-5 of a leaf's
# largest entry.  Each attn_* leaf is held within ``DIN_ATTN_REL`` (16
# float32 ulps) of the largest entry of its gradient with the scores'
# gradient taken in absolute value (the cancelling terms' magnitudes:
# ``recsys.attention_grad_scales`` on the CPU), or within 1e-5 of its own,
# whichever is larger.  Each DIN case's line gives, for each attn_* leaf,
# that scale over the leaf's own largest entry and the card's error over
# each.


def gnn_run_batch(arch, run: str, shape: str, step: int, graph):
    """(numpy batch, items) of one step of a training run from the port's
    builders at the run's shape, seed 0: items are the batch's edges (a
    GNN's; mesh + grid-to-mesh + mesh-to-grid for graphcast) or its
    examples (DIN)."""
    from repro_torch.data import gnn_data, recsys_data, sampler

    cfg, sp = arch.cfg, arch.shapes[shape]
    if arch.family == "recsys":
        return recsys_data.din_batch(
            sp["batch"], cfg.seq_len, cfg.n_items, cfg.n_cates,
            cfg.n_user_feats, cfg.user_feat_vocab, step=step,
            seed=0), sp["batch"]
    if run == "sage_reddit_sampled":
        b = sampler.sampled_batch(graph, sp["batch_nodes"], sp["fanout"],
                                  step, seed=0)
        sink = len(b["node_mask"]) - 1      # padded edges are sink -> sink
        return b, int((b["edge_src"] != sink).sum())
    if run == "schnet_molecule":
        b = gnn_data.schnet_batch(sp["n_nodes"], sp["n_edges"],
                                  sp["d_feat"], batch=sp["batch"], seed=step)
        return b, len(b["edge_src"])
    if run == "graphcast_mesh":
        ab, _ = arch._abstract_batch(shape)
        ng, nm = ab["node_feat"].shape[0], ab["mesh_feat"].shape[0]
        ne = ab["mesh_src"].shape[0]
        return gnn_data.graphcast_batch(ng, nm, cfg.n_vars, ne, ne, ne,
                                        seed=0), 3 * ne
    return gnn_data.full_graph_batch(sp["n_nodes"], sp["n_edges"],
                                     sp["d_feat"], cfg.n_classes,
                                     seed=0), sp["n_edges"]


def gnn_train(torch, card: str, run: str, arch_id: str, shape: str,
              steps: int) -> dict:
    """``steps`` AdamW steps (the default ``AdamWConfig`` but for
    ``total_steps``) of one GNN or DIN arch at its published width and the
    run's shape, float32, random weights from a seeded generator, through
    ``launch.train.make_step``; each step fenced and timed.  The batch is
    built and uploaded once (a whole graph, the mesh) or every step
    (sampled batches, molecules, click logs), its host seconds kept apart
    from the step's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import batch_to
    from repro_torch.data import sampler
    from repro_torch.launch.train import make_step
    from repro_torch.models import gnn, recsys
    from repro_torch.train import AdamWConfig, apply_updates, init_state
    from repro_torch.train import tree as tr

    arch = get_config(arch_id)
    sp = arch.shapes[shape]
    if arch.family == "gnn":
        cfg, mod, model = arch._shape_cfg(sp), gnn, gnn.GNN
    else:
        cfg, mod, model = arch.cfg, recsys, recsys.DIN
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()     # what the run found allocated
    flops = arch.model_flops(shape)
    out = {"arch": arch_id, "shape": shape, "model_flops_per_step": flops,
           "items": "edges" if arch.family == "gnn" else "examples",
           "items_per_step": [], "data_s": [], "upload_s": [], "step_s": [],
           "items_per_s": [],
           "model_flops_per_s": [], "fp32_peak_share": [], "loss": [],
           "grad_norm": []}
    graph = None
    if run == "sage_reddit_sampled":
        t0 = time.perf_counter()
        graph = sampler.random_csr_graph(
            sp["n_nodes"], avg_deg=sp["n_edges"] / sp["n_nodes"],
            d_feat=sp["d_feat"], n_classes=cfg.n_classes, seed=0)
        out["graph_build_s"] = time.perf_counter() - t0
        out["graph_edges"] = int(graph.indptr[-1])
        log(f"[{card}] {run}: CSR graph of {graph.n:,} nodes and "
            f"{out['graph_edges']:,} edges built on the host in "
            f"{out['graph_build_s']:.2f} s")
    params = model(cfg, generator=torch.Generator(GNN_DEVICE)
                   .manual_seed(0)).params
    out["n_params"] = sum(p.numel() for p in tr.leaves(params))
    state = {"params": params, "opt": init_state(params)}
    ocfg = AdamWConfig(total_steps=steps)
    step = make_step(lambda p, b: mod.loss_fn(p, b, cfg), ocfg)
    for i in range(steps):
        if i == 0 or run not in WHOLE_BATCH_RUNS:
            t0 = time.perf_counter()
            np_batch, items = gnn_run_batch(arch, run, shape, i, graph)
            t1 = time.perf_counter()
            batch = batch_to(np_batch, GNN_DEVICE)
            torch.cuda.synchronize()
            out["data_s"].append(t1 - t0)
            out["upload_s"].append(time.perf_counter() - t1)
            del np_batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["step_s"].append(dt)
        out["items_per_step"].append(items)
        out["items_per_s"].append(items / dt)
        out["model_flops_per_s"].append(flops / dt)
        out["fp32_peak_share"].append(flops / dt / FP32_PEAK_FLOPS)
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        log(f"[{card}] {run} step {i}: {dt:.4f} s, {items / dt:,.0f} "
            f"{out['items']}/s, "
            f"{flops / dt / 1e12:.3f} model TFLOP/s "
            f"({100 * flops / dt / FP32_PEAK_FLOPS:.2f}% of the FP32 "
            f"peak), loss {out['loss'][-1]:.4f}, grad_norm "
            f"{out['grad_norm'][-1]:.4f}")
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["found_allocated_bytes"] = base
    # where a step's time goes: one step more on the last batch, its
    # forward + backward and its update fenced and timed apart
    params = state["params"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = mod.loss_fn(params, batch, cfg)
    grads = tr.unflatten_like(params, torch.autograd.grad(
        loss, tr.leaves(params), materialize_grads=True))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    apply_updates(params, grads, state["opt"], ocfg)
    torch.cuda.synchronize()
    out["split_s"] = {"forward_backward": t1 - t0,
                      "update": time.perf_counter() - t1}
    del loss, grads
    if graph is not None:
        # the sampler's share of a step: host sampling over sampling,
        # upload and the device step
        whole = [d + u + s for d, u, s in
                 zip(out["data_s"], out["upload_s"], out["step_s"])]
        out["sampler_share"] = [d / w for d, w in zip(out["data_s"], whole)]
        out["edges_per_s_with_sampler"] = [
            n / w for n, w in zip(out["items_per_step"], whole)]
    log(f"[{card}] {run}: {out['n_params']:,} parameters, peak memory "
        f"{out['peak_bytes']:,} B above the {base:,} B found allocated; a "
        f"further step split: forward + backward "
        f"{out['split_s']['forward_backward']:.4f} s, update "
        f"{out['split_s']['update']:.4f} s; "
        f"host data seconds {[round(s, 4) for s in out['data_s']]}, upload "
        f"{[round(s, 4) for s in out['upload_s']]}"
        + (f", sampler share {[round(s, 4) for s in out['sampler_share']]}"
           if graph is not None else ""))
    bad = [v for v in out["loss"] + out["grad_norm"] if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{run}: non-finite loss or grad_norm {bad}")
    return out


def din_serve(torch, card: str) -> dict:
    """DIN at its published width, random weights: forward under
    ``no_grad`` at ``serve_p99`` (512) and ``serve_bulk`` (262,144)
    examples and ``retrieval_scores`` over ``RETRIEVAL_CANDIDATES``
    candidates, each called ``SERVE_CALLS`` times, fenced and timed; then
    ``retrieval_scores`` against ``forward`` on 512 candidates with the
    user's history repeated."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import batch_to
    from repro_torch.data import recsys_data
    from repro_torch.models import recsys

    arch = get_config("din")
    cfg = arch.cfg
    params = recsys.DIN(cfg, generator=torch.Generator(GNN_DEVICE)
                        .manual_seed(0)).params
    common = (cfg.seq_len, cfg.n_items, cfg.n_cates, cfg.n_user_feats,
              cfg.user_feat_vocab)
    cases = [(shape, arch.shapes[shape]["batch"], shape)
             for shape in ("serve_p99", "serve_bulk")]
    cases.append(("retrieval_cand", RETRIEVAL_CANDIDATES,
                  dict(kind="retrieval", batch=1,
                       n_candidates=RETRIEVAL_CANDIDATES)))
    out = {}
    with torch.no_grad():
        for name, n, shape in cases:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            if name == "retrieval_cand":
                np_batch = recsys_data.retrieval_batch(*common,
                                                       n_candidates=n,
                                                       seed=0)
                fn = recsys.retrieval_scores
            else:
                np_batch = recsys_data.din_batch(n, *common, step=0, seed=0)
                fn = recsys.forward
            data_s = time.perf_counter() - t0
            batch = batch_to(np_batch, GNN_DEVICE)
            flops = arch.model_flops(shape)
            call_s = []
            for _ in range(SERVE_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scores = fn(params, batch, cfg)
                torch.cuda.synchronize()
                call_s.append(time.perf_counter() - t0)
            if scores.shape != (n,) or not bool(torch.isfinite(scores).all()):
                raise AssertionError(f"din {name}: scores of shape "
                                     f"{tuple(scores.shape)}, finite "
                                     f"{bool(torch.isfinite(scores).all())}")
            out[name] = {
                "examples": n, "data_s": data_s, "call_s": call_s,
                "examples_per_s": [n / s for s in call_s],
                "model_flops_per_call": flops,
                "fp32_peak_share": [flops / s / FP32_PEAK_FLOPS
                                    for s in call_s],
                "peak_bytes": torch.cuda.max_memory_allocated() - base}
            log(f"[{card}] din {name}: {n:,} examples, calls "
                f"{[round(s, 5) for s in call_s]} s, "
                f"{n / min(call_s):,.0f} examples/s at best, "
                f"{100 * flops / min(call_s) / FP32_PEAK_FLOPS:.2f}% of the "
                f"FP32 peak, peak memory {out[name]['peak_bytes']:,} B")
            del batch, scores
        out["retrieval_cand"]["reduced"] = {
            "n_candidates": [arch.shapes["retrieval_cand"]["n_candidates"],
                             RETRIEVAL_CANDIDATES],
            "why": "10^6 candidates need about 90 GB unsharded; the "
                   "reference's dry run shards them 16-32 ways"}
        rb = batch_to(recsys_data.retrieval_batch(*common, n_candidates=512,
                                                  seed=1), GNN_DEVICE)
        scores = recsys.retrieval_scores(params, rb, cfg)
        as_batch = {"item_id": rb["cand_items"], "cate_id": rb["cand_cates"],
                    **{k: rb[k].expand(512, -1) for k in
                       ("hist_items", "hist_cates", "hist_mask",
                        "user_feats")}}
        err = _max_rel(torch, scores, recsys.forward(params, as_batch, cfg))
    out["retrieval_vs_forward"] = err
    log(f"[{card}] din retrieval_scores against forward on 512 candidates: "
        f"max relative error {err:.3e} (limit {GNN_CARD_CPU_REL})")
    if not err <= GNN_CARD_CPU_REL:
        raise AssertionError(f"retrieval_scores against forward: {err}")
    return out


def _grads_on(torch, mod, cfg, host, np_batch, device):
    """(loss, {path: gradient}) of one forward and backward on
    ``device``."""
    from repro_torch.configs.base import batch_to
    from repro_torch.train import tree as tr

    params = tr.map_tree(lambda p: p.to(device).requires_grad_(True), host)
    loss = mod.loss_fn(params, batch_to(np_batch, device), cfg)
    grads = torch.autograd.grad(loss, tr.leaves(params),
                                materialize_grads=True)
    return loss.detach(), dict(zip(tr.to_dict(params), grads))


def gnn_card_vs_cpu(torch, card: str) -> dict:
    """Each of the five smoke configs, ``gin-tu`` at ``full_graph_sm``
    (Cora's 2,708 nodes and 10,556 edges, d_feat 1,433) and ``din`` at
    ``serve_p99`` (512 examples, the whole 10^6-row table), float32 with
    TF32 off, on the card and on the CPU from the same weights and batch:
    the loss within 1e-5 relative, every gradient leaf within 1e-5 of its
    largest entry (DIN's attention MLP: see ``GNN_CARD_CPU_REL``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import batch_to
    from repro_torch.data import gnn_data, recsys_data
    from repro_torch.models import gnn, recsys

    cases = []
    for arch_id in ("gin-tu", "graphsage-reddit", "schnet", "graphcast",
                    "din"):
        arch = get_config(arch_id)
        cfg = arch.smoke_config()
        if arch.family == "gnn":
            cases.append((f"{arch_id} smoke", gnn, cfg,
                          arch.smoke_batch(seed=1)))
        else:
            cases.append((f"{arch_id} smoke", recsys, cfg,
                          recsys_data.din_batch(
                              8, cfg.seq_len, cfg.n_items, cfg.n_cates,
                              cfg.n_user_feats, cfg.user_feat_vocab,
                              step=0, seed=1)))
    gin = get_config("gin-tu")
    sp = gin.shapes["full_graph_sm"]
    cases.append(("gin-tu full_graph_sm", gnn, gin._shape_cfg(sp),
                  gnn_data.full_graph_batch(sp["n_nodes"], sp["n_edges"],
                                            sp["d_feat"], seed=0)))
    din = get_config("din").cfg
    cases.append(("din serve_p99", recsys, din, recsys_data.din_batch(
        get_config("din").shapes["serve_p99"]["batch"], din.seq_len,
        din.n_items, din.n_cates, din.n_user_feats, din.user_feat_vocab,
        step=0, seed=0)))
    out = {}
    for name, mod, cfg, np_batch in cases:
        host = mod.init_params(cfg, torch.Generator().manual_seed(0))
        l_cpu, g_cpu = _grads_on(torch, mod, cfg, host, np_batch, "cpu")
        l_card, g_card = _grads_on(torch, mod, cfg, host, np_batch,
                                   GNN_DEVICE)
        scales = {} if mod is not recsys else recsys.attention_grad_scales(
            host, batch_to(np_batch, "cpu"), cfg)
        res = {"loss": _max_rel(torch, l_card, l_cpu),
               "grads": max(_max_rel(torch, g_card[k], g_cpu[k],
                                     scales.get(k, 0.0) * DIN_ATTN_REL
                                     / GNN_CARD_CPU_REL) for k in g_cpu)}
        if scales:
            res["attn"] = {k: {
                "scale_over_own": v / max(float(g_cpu[k].abs().max()),
                                          1e-30),
                "err_over_own": _max_rel(torch, g_card[k], g_cpu[k]),
                "err_over_scale": _max_rel(torch, g_card[k], g_cpu[k], v)}
                for k, v in scales.items()}
        out[name] = res
        log(f"[{card}] card against CPU, {name}, float32: max relative "
            f"error {json.dumps(res)} (limit {GNN_CARD_CPU_REL})")
        bad = {k: res[k] for k in ("loss", "grads")
               if not res[k] <= GNN_CARD_CPU_REL}
        if bad:
            raise AssertionError(f"card against CPU, {name}: {bad}")
    return out


def gnn_launcher(torch, card: str) -> dict:
    """``launch.train.main`` on the card at ``--scale full`` for 3 steps,
    for the three archs the reference's launcher trains (``schnet`` and
    ``graphcast`` fail there with a ``KeyError``: its sampled batches
    carry no geometry), each in a fresh checkpoint directory."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import train as launch

    out = {}
    for arch_id in ("gin-tu", "graphsage-reddit", "din"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(buf):
            launch.main(["--arch", arch_id, "--scale", "full", "--steps",
                         "3", "--ckpt-dir", tmp])
        text = buf.getvalue()
        out[arch_id] = {"seconds": time.perf_counter() - t0,
                        "log": text.strip().splitlines()}
        log(f"[{card}] launch.train --arch {arch_id} --scale full --steps 3:"
            f" {out[arch_id]['seconds']:.2f} s; "
            + " | ".join(out[arch_id]["log"]))
        if "device=cuda" not in text or "done: step=3" not in text:
            raise AssertionError(f"launch.train {arch_id}: {text}")
    return out


def gnn_path(torch, card: str) -> dict:
    """The GNN and DIN trainer path (no kernel of the port: its products
    are torch.matmul, its scatters index_add, its gathers index_select):
    the seven runs, the card against the CPU, the launcher.  TF32 is off
    for the whole phase (float32 throughout); launch counts are reset
    just before and read just after, and must stay zero."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()                # just before the GNN / DIN path
    result = {"card": card, "peak_source": FP32_PEAK_SOURCE, "runs": {}}
    try:
        for run, arch_id, shape, steps in GNN_RUNS:
            result["runs"][run] = gnn_train(torch, card, run, arch_id,
                                            shape, steps)
            gc.collect()
            torch.cuda.empty_cache()
        result["runs"]["din_serve"] = din_serve(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        result["card_vs_cpu"] = gnn_card_vs_cpu(torch, card)
        result["launcher"] = gnn_launcher(torch, card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    launched = launch_counts()           # just after the GNN / DIN path
    result["launches"] = launched
    if any(launched.values()):
        raise AssertionError(f"the GNN / DIN path launched kernels: "
                             f"{launched}")
    result["seconds"] = time.perf_counter() - t0
    log(f"[{card}] GNN / DIN path {result['seconds']:.1f} s")
    return result


# ------------------------------------------------- sharded GNN training step
# gin-tu over the whole of ogb_products through models.gnn_dist on a 1 x 1
# NCCL mesh, against one step of the single-device make_step
GNN_DIST_STEPS = 3
GNN_DIST_LOSS_REL = 2e-5
# every gradient leaf within this share of its largest entry, or within
# GNN_DIST_SPREADS times the largest that two single-device runs differ
# by (the float atomics sum in no fixed order, and at this shape the
# activations reach 1e5).  The updated leaves are reported, not held:
# after clipping to a global norm of 1, AdamW's first step moves each
# entry by lr * g / (|g| + eps), so an entry near eps moves by a share of
# lr that the atomics' order changes at will
GNN_DIST_GRAD_REL = 1e-5
GNN_DIST_SPREADS = 4


def _padded_products_batch(np, cfg, sp):
    """``ogb_products``' whole-graph batch (seed 0) padded as ``_pad512``
    pads it: padding nodes with ``node_mask`` 0 and no feature, padding
    edges from the last padding node to itself."""
    from repro_torch.configs.base import _pad512
    from repro_torch.data import gnn_data

    b = gnn_data.full_graph_batch(sp["n_nodes"], sp["n_edges"],
                                  sp["d_feat"], cfg.n_classes, seed=0)
    n, e = _pad512(sp["n_nodes"]), _pad512(sp["n_edges"])
    pad_n, pad_e = n - sp["n_nodes"], e - sp["n_edges"]
    sink = np.full(pad_e, n - 1, dtype=np.int32)
    return {
        "node_feat": np.concatenate([b["node_feat"], np.zeros(
            (pad_n, sp["d_feat"]), np.float32)]),
        "edge_src": np.concatenate([b["edge_src"], sink]),
        "edge_dst": np.concatenate([b["edge_dst"], sink]),
        "labels": np.concatenate([b["labels"], np.zeros(pad_n, np.int32)]),
        "node_mask": np.concatenate([b["node_mask"], np.zeros(pad_n, bool)]),
        "train_mask": np.concatenate([b["train_mask"],
                                      np.zeros(pad_n, bool)])}


def profiled_step(torch, fn, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA
    activities): its wall seconds (fenced), the device seconds of its
    kernels (CUPTI), the device's idle share of the wall time, and the
    ``top`` kernels by device time with their calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.self_device_time_total for e in kernels) / 1e6
    if device <= 0:
        raise AssertionError("the profiler saw no device time")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_s": wall, "device_s": device,
            "idle_share": max(0.0, 1 - device / wall),
            "top": [{"kernel": e.key[:120], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in kernels[:top]]}


def gnn_dist_path(torch, np, card: str) -> dict:
    """gin-tu at its published width over the whole of ``ogb_products``
    (float32, TF32 off) through ``models.gnn_dist.sharded_train_step`` on
    a 1 x 1 NCCL mesh, the edges sorted by destination on the card (the
    destination partition at one rank).  First the single-device
    gradients and one step of ``launch.train.make_step`` from the same
    parameters and batch (kept on the host), then the sharded
    gradients (``sharded_loss_and_grads``) and step from the same
    parameters: losses within 2e-5 relative, every gradient leaf within
    1e-5 of its largest entry or 4 times the single-device gradients'
    own run-to-run spread; the updated leaves' error is reported (see
    ``GNN_DIST_GRAD_REL``).  Then
    ``GNN_DIST_STEPS`` steps fenced and timed, and one more split into
    forward + backward and update.  No kernel of the port may launch."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import batch_to
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import make_step
    from repro_torch.models import gnn, gnn_dist
    from repro_torch.train import AdamWConfig, apply_updates, init_state
    from repro_torch.train import tree as tr

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()               # just before the gnn_dist path
    arch = get_config("gin-tu")
    sp = arch.shapes["ogb_products"]
    cfg = arch._shape_cfg(sp)
    ocfg = AdamWConfig(total_steps=GNN_DIST_STEPS + 2)
    flops = arch.model_flops("ogb_products")
    t0 = time.perf_counter()
    np_batch = _padded_products_batch(np, cfg, sp)
    data_s = time.perf_counter() - t0
    batch = batch_to(np_batch, GNN_DEVICE)
    n_nodes, n_edges = len(np_batch["node_mask"]), len(np_batch["edge_src"])
    del np_batch
    host = tr.map_tree(lambda p: p.cpu(), gnn.init_params(
        cfg, torch.Generator(GNN_DEVICE).manual_seed(0)))

    def fresh():
        params = gnn.GNN(cfg, tr.map_tree(
            lambda p: p.to(GNN_DEVICE, copy=True), host)).params
        return params, init_state(params)

    out = {"arch": "gin-tu", "shape": "ogb_products", "card": card,
           "mesh": [1, 1], "nodes": n_nodes, "edges": n_edges,
           "real_edges": sp["n_edges"], "model_flops_per_step": flops,
           "peak_source": FP32_PEAK_SOURCE, "data_s": data_s}
    try:
        # the single-device gradients (twice: their run-to-run spread on
        # the card) and step, the yardstick
        params, state = fresh()

        def single_grads():
            loss = gnn.loss_fn(params, batch, cfg)
            return {k: g.cpu() for k, g in zip(
                tr.to_dict(params), torch.autograd.grad(
                    loss, tr.leaves(params), materialize_grads=True))}
        want_grads, again = single_grads(), single_grads()
        step = make_step(lambda p, b: gnn.loss_fn(p, b, cfg), ocfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s1, metrics = step({"params": params, "opt": state}, batch)
        torch.cuda.synchronize()
        out["single_device_step_s"] = time.perf_counter() - t0
        want_loss = float(metrics["loss"])
        want = {k: v.detach().cpu() for k, v in
                tr.to_dict(s1["params"]).items()}
        del params, state, s1, metrics, step
        gc.collect()
        torch.cuda.empty_cache()

        # the destination partition at one rank: edges sorted by edge_dst
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst, order = torch.sort(batch["edge_dst"], stable=True)
        batch["edge_src"] = batch["edge_src"].index_select(0, order)
        batch["edge_dst"] = dst
        torch.cuda.synchronize()
        out["sort_s"] = time.perf_counter() - t0
        del dst, order

        t0 = time.perf_counter()
        mesh = make_local_mesh(1, 1)
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"the card's mesh runs "
                                     f"{dist.get_backend()}, not nccl")
            dist.all_reduce(torch.zeros(1, device=GNN_DEVICE))
            torch.cuda.synchronize()
            out["setup_s"] = time.perf_counter() - t0
            step, spec = gnn_dist.sharded_train_step(cfg, mesh, ocfg)
            out["batch_spec"] = {k: [list(a) if a else None for a in v]
                                 for k, v in spec.items()}
            loss_and_grads = gnn_dist.sharded_loss_and_grads(cfg, mesh)
            params, state = fresh()
            grad_loss, grads = loss_and_grads(params, batch)
            got_grads = {k: g.cpu() for k, g in tr.to_dict(grads).items()}
            del grads
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            coll = Collectives()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, loss = step(params, state, batch)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
            finally:
                coll.restore()
            out["collectives_per_step"] = coll.summary()
            loss_err = max(abs(float(x) - want_loss) for x in
                           (grad_loss, loss)) / max(abs(want_loss), 1.0)

            def rel(got, w):
                return float((got - w).abs().max()) / max(
                    float(w.abs().max()), 1e-30)
            grad_err = {k: rel(got_grads[k], w)
                        for k, w in want_grads.items()}
            spread = max(rel(again[k], w) for k, w in want_grads.items())
            grad_limit = max(GNN_DIST_GRAD_REL, GNN_DIST_SPREADS * spread)
            updated = {k: v.detach().cpu()
                       for k, v in tr.to_dict(params).items()}
            leaf_err = {k: rel(updated[k], w) for k, w in want.items()}
            worst = max(leaf_err, key=leaf_err.get)
            at = int((updated[worst] - want[worst]).abs().argmax())
            g = want_grads[worst].reshape(-1)
            out["equality"] = {
                "loss": float(loss), "single_device_loss": want_loss,
                "loss_rel_err": loss_err,
                "max_grad_rel_err": max(grad_err.values()),
                "single_device_grad_spread": spread,
                "limits": [GNN_DIST_LOSS_REL, grad_limit],
                "max_updated_leaf_rel_err": leaf_err[worst],
                "worst_updated_entry": {
                    "leaf": worst, "index": at,
                    "grad_over_leaf_max": float(g[at].abs())
                    / max(float(g.abs().max()), 1e-30)}}
            log(f"[{card}] gnn_dist: gin-tu ogb_products sharded step on the"
                f" 1 x 1 mesh {first_s:.4f} s (first), loss "
                f"{float(loss):.6f} against the single-device step's "
                f"{want_loss:.6f} ({out['single_device_step_s']:.4f} s): "
                f"relative error {loss_err:.3e}; gradients' largest error "
                f"{max(grad_err.values()):.3e} of their leaf's largest entry "
                f"(two single-device runs: {spread:.3e}; limits "
                f"{GNN_DIST_LOSS_REL}, {grad_limit:.3e}); "
                f"updated leaves' largest error {leaf_err[worst]:.3e} "
                f"({json.dumps(out['equality']['worst_updated_entry'])}); "
                f"collectives [calls, payload B] "
                f"{json.dumps(out['collectives_per_step'], sort_keys=True)}")
            bad = {k: e for k, e in grad_err.items() if not e <= grad_limit}
            if not loss_err <= GNN_DIST_LOSS_REL or bad:
                raise AssertionError(f"the sharded step differs from the "
                                     f"single-device step: loss {loss_err},"
                                     f" gradients {bad}")
            out["step_s"], out["loss"] = [first_s], [float(loss)]
            for _ in range(GNN_DIST_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, loss = step(params, state, batch)
                torch.cuda.synchronize()
                out["step_s"].append(time.perf_counter() - t0)
                out["loss"].append(float(loss))
            steady = out["step_s"][1:]
            out["edges_per_s"] = [sp["n_edges"] / s for s in steady]
            out["fp32_peak_share"] = [flops / s / FP32_PEAK_FLOPS
                                      for s in steady]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(params, batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            apply_updates(params, grads, state, ocfg)
            torch.cuda.synchronize()
            out["split_s"] = {"forward_backward": t1 - t0,
                              "update": time.perf_counter() - t1}
            out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
            out["found_allocated_bytes"] = base
            del loss, grads
            out["profile"] = profiled_step(
                torch, lambda: step(params, state, batch))
            del params, state
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    bad = [v for v in out["loss"] if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"gnn_dist: non-finite loss {bad}")
    launched = launch_counts()          # just after the gnn_dist path
    out["launches"] = launched
    if any(launched.values()):
        raise AssertionError(f"the gnn_dist path launched kernels: "
                             f"{launched}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[{card}] gnn_dist: steps {[round(s, 4) for s in out['step_s']]} s"
        f" (fenced), {sp['n_edges'] / min(steady):,.0f} edges/s at best, "
        f"{100 * flops / min(steady) / FP32_PEAK_FLOPS:.2f}% of the FP32 "
        f"peak; a further step split: forward + backward "
        f"{out['split_s']['forward_backward']:.4f} s, update "
        f"{out['split_s']['update']:.4f} s; peak memory "
        f"{out['peak_bytes']:,} B above the {base:,} B found allocated; the "
        f"sort by destination {out['sort_s']:.4f} s; host data "
        f"{data_s:.2f} s; {out['seconds']:.1f} s in all")
    prof = out["profile"]
    log(f"[{card}] gnn_dist: a profiled step {prof['wall_s']:.4f} s, its "
        f"kernels {prof['device_s']:.4f} s of device time (idle share "
        f"{prof['idle_share']:.4f}); by device time: "
        + "; ".join(f"{k['kernel'][:60]} x{k['calls']} {k['device_ms']:.3f}"
                    f" ms" for k in prof["top"]))
    return out


# ------------------------------------------------------- the paper's arch
PATTERN_DEVICE = "cuda"
PATTERN_SEEDS = (0, 1, 2, 3)
# closure_256k: one closure_step at n_pad 2^18 on R = adjacency^T | I of
# the email profile cut to 2^18 nodes (its in-degree hubs are dense rows)
CLOSURE_256K_RANDOM_ROWS = 4096
CLOSURE_256K_GATHER_ROWS = 8192     # R rows gathered at once by the check
CLOSURE_256K_ITERS = 5


def _or_rows(rows):
    """The OR of a (k, W) block of lanes' rows, k >= 1, by halving."""
    while rows.shape[0] > 1:
        h = rows.shape[0] // 2
        head = rows[:h] | rows[h:2 * h]
        if rows.shape[0] % 2:
            head[0] |= rows[2 * h]
        rows = head
    return rows[0]


def closure_rows_by_rule(torch, r, rows):
    """Row ``i`` of ``R | (R·R > 0)`` for each ``i`` of ``rows``, by the
    plain rule on the card: R's row ``i`` ORed with the OR of R's rows at
    its set bits.  (len(rows), W) int32 lanes."""
    from repro_torch.kernels import packed
    n = r.shape[0]
    out = []
    for i in rows:
        acc = r[i].clone()
        ks = packed.unpack(r[i], n).nonzero().view(-1)
        for c0 in range(0, ks.numel(), CLOSURE_256K_GATHER_ROWS):
            acc |= _or_rows(r.index_select(
                0, ks[c0:c0 + CLOSURE_256K_GATHER_ROWS]))
        out.append(acc)
    return torch.stack(out)


def closure_256k(torch, np, card: str):
    """``rig_gm``'s ``closure_256k`` shape on one card: one ``closure_step``
    at n_pad 2^18 (R 8 GiB).  R is the adjacency of
    ``paper_profile_graph("email", scale=262144/265214, seed=0)``
    transposed (each row a node's in-neighbours, so the profile's in-degree
    hubs are rows past ``LIST_CAP``) ORed with the identity, built from
    its pairs (``packed.from_pairs``) straight into the card's zeroed
    matrix.  Every row past ``LIST_CAP`` set bits and
    ``CLOSURE_256K_RANDOM_ROWS`` random rows of R' must equal the plain
    rule exactly (the plain version's bf16 unpack of R would take
    128 GiB)."""
    from repro_torch.configs import get_config
    from repro_torch.data.graphs import paper_profile_graph
    from repro_torch.kernels import packed
    from repro_torch.kernels.closure import LIST_CAP, closure_step

    arch = get_config("rig_gm")
    n = arch.shapes["closure_256k"]["n_pad"]
    t0 = time.perf_counter()
    g = paper_profile_graph("email", scale=n / 265_214, seed=0)
    if g.n != n:
        raise AssertionError(f"the email profile cut to {n} nodes has "
                             f"{g.n}")
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ids = np.arange(n)
    r = packed.from_pairs(np.concatenate([g.edges[:, 1], ids]),
                          np.concatenate([g.edges[:, 0], ids]), (n, n),
                          device=PATTERN_DEVICE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cnt = torch.cat([packed.popcount(r[r0:r0 + 4096]).sum(dim=1)
                     for r0 in range(0, n, 4096)])
    dense = (cnt > LIST_CAP).nonzero().view(-1).tolist()
    out = {"n_pad": n, "lanes": r.shape[1], "r_bytes": r.numel() * 4,
           "graph_edges": int(g.n_edges), "graph_s": t1 - t0,
           "build_r_s": t2 - t1, "set_bits_before": int(cnt.sum()),
           "dense_rows": len(dense), "densest_row_bits": int(cnt.max()),
           "model_flops": arch.model_flops("closure_256k")}
    del cnt
    return r, dense, out, base


def pattern_path(torch, np, card: str, rows) -> dict:
    """The paper's own arch, ``rig_gm``: (a) its smoke (``TorchGM`` on the
    card: the simulation on ``bitmm``, the enumeration on
    ``gather_expand``) for seeds 0 to 3, each count equal to the host
    ``match``'s with no overflow; (b) ``closure_256k``: one
    ``closure_step`` at n_pad 2^18, rows held to the plain rule, timed by
    CUDA events beside its bound.  Launch counts are reset just before
    the phase and read after the smoke and after the step; the phase's
    launches join the ``kernels`` rows (``launches_by_path["pattern"]``)
    and ``closure_step``'s row takes a ``closure_256k`` entry."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.closure import closure_step

    t_phase = time.perf_counter()
    arch = get_config("rig_gm")
    reset_launch_counts()               # just before the pattern path
    smoke = {}
    for seed in PATTERN_SEEDS:
        before = launch_counts()
        t0 = time.perf_counter()
        res = arch.smoke(seed)
        after = launch_counts()
        smoke[seed] = {**res, "seconds": time.perf_counter() - t0,
                       "launches": {k: v - before.get(k, 0)
                                    for k, v in after.items()}}
        log(f"[{card}] rig_gm smoke seed {seed}: {json.dumps(smoke[seed])}")
        if not res["finite"] or res["count"] != res["host_count"]:
            raise AssertionError(f"rig_gm smoke seed {seed}: {res}")
        if not all(smoke[seed]["launches"].get(k) for k in SERVE_KERNELS):
            raise AssertionError(f"rig_gm smoke seed {seed} launched "
                                 f"{smoke[seed]['launches']}, not "
                                 f"{SERVE_KERNELS}")
    smoke_launches = launch_counts()

    r, dense, info, base = closure_256k(torch, np, card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r2 = closure_step(r)
    torch.cuda.synchronize()
    info["first_call_s"] = time.perf_counter() - t0
    launched = launch_counts()          # just after the pattern path
    closure_launches = {k: v - smoke_launches.get(k, 0)
                        for k, v in launched.items()
                        if v != smoke_launches.get(k, 0)}
    if closure_launches != {"closure_step": 1}:
        raise AssertionError(f"closure_256k launched {closure_launches}")
    info["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    n = r.shape[0]
    random_rows = np.random.default_rng(0).choice(
        n, CLOSURE_256K_RANDOM_ROWS, replace=False).tolist()
    checked = sorted(set(dense) | set(random_rows))
    t0 = time.perf_counter()
    want = closure_rows_by_rule(torch, r, checked)
    got = r2.index_select(0, torch.tensor(checked, device=PATTERN_DEVICE))
    equal = torch.equal(got, want)
    torch.cuda.synchronize()
    info["check_s"] = time.perf_counter() - t0
    info["rows_checked"] = len(checked)
    del got, want
    if not equal:
        raise AssertionError("closure_256k: closure_step's rows differ from "
                             "the plain rule")
    info["set_bits_after"] = set_bits(r2)
    info["ms"] = time_ms(torch, lambda: closure_step(r, out=r2),
                         iters=CLOSURE_256K_ITERS, warmup=1)
    least, by, nbytes, ops = bound_ms("closure_step", (r,), {})
    # where the time goes: the same step with the rows past LIST_CAP
    # cleared (R is not read again after this)
    r[torch.tensor(dense, device=PATTERN_DEVICE)] = 0
    info["ms_dense_rows_cleared"] = time_ms(
        torch, lambda: closure_step(r, out=r2), iters=CLOSURE_256K_ITERS,
        warmup=1)
    info.update({"bound_ms": least, "bound_by": by, "bound_bytes": nbytes,
                 "bound_ops": ops, "launches": 1, "max_abs_err": 0,
                 "plain_ms": None, "library_ms": None,
                 "library": "none: the unpacked R does not fit (128 GiB "
                            "in bf16)",
                 "plain": "not run: its bf16 unpack of R takes 128 GiB; "
                          "rows held to the plain rule instead"})
    log(f"[{card}] closure_256k: R {n} x {r.shape[1]} lanes "
        f"({info['r_bytes']:,} B), graph {info['graph_s']:.2f} s, R built "
        f"from its pairs in {info['build_r_s']:.2f} s; set bits "
        f"{info['set_bits_before']:,} -> {info['set_bits_after']:,}; "
        f"{info['dense_rows']} rows past the list capacity (the densest "
        f"{info['densest_row_bits']:,} bits); closure_step "
        f"{info['ms']:.6f} ms (CUDA events, {CLOSURE_256K_ITERS} calls; "
        f"{info['ms_dense_rows_cleared']:.6f} ms with the dense rows "
        f"cleared), "
        f"first call {info['first_call_s']:.4f} s (fenced), bound "
        f"{least:.6f} ms ({by}: {nbytes:,} B, {ops:,} ops); "
        f"{info['rows_checked']} rows equal the plain rule "
        f"({info['check_s']:.2f} s); peak memory {info['peak_bytes']:,} B; "
        f"model_flops 2 N^3 = {info['model_flops']:.4e} (the dense form's "
        f"count; the kernel does list work)")
    del r, r2
    gc.collect()
    torch.cuda.empty_cache()

    for row in rows:
        k = launched.get(row["name"], 0)
        row["launches_by_path"]["pattern"] = k
        row["launches"] += k
        if row["name"] == "closure_step":
            row["closure_256k"] = info
    out = {"card": card, "smoke": smoke, "launches": launched,
           "closure_256k": info,
           "seconds": time.perf_counter() - t_phase}
    log(f"[{card}] pattern path {out['seconds']:.1f} s; launches "
        f"{json.dumps(launched, sort_keys=True)}")
    return out


# ------------------------------------------------------------------ dry-run
# a trace's peak of live bytes against the card's measured peak
DRYRUN_PEAK_REL = 0.20
# the production cells the phase traces on the fake (16, 16) mesh
DRYRUN_CELLS = (("rig_gm", "serve_1m"), ("qwen1.5-4b", "train_4k"))


def dryrun_record(card: str, arch_id: str, shape, mesh_shape) -> dict:
    """One unit traced on ``meta`` tensors over a fake process group of
    ``mesh_shape`` (``launch.dryrun.trace``), with its H100 roofline
    terms (``launch.hillclimb.roofline``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.mesh import make_local_mesh

    cfg = get_config(arch_id)
    n_dev = math.prod(mesh_shape)
    with dryrun.fake_group(n_dev):
        t = dryrun.trace(cfg.build_dryrun(shape, make_local_mesh(
            *mesh_shape)))
    t["roofline"] = hillclimb.roofline(t, cfg.model_flops(shape), n_dev)
    t["collectives"] = {k: v for k, v in t["collectives"].items()
                        if v["count"]}
    log(f"[{card}] dry-run {arch_id} {shape} on {mesh_shape}: "
        f"{json.dumps(t, sort_keys=True)}")
    return t


def dryrun_path(torch, card: str, lm: dict, serve_real: dict) -> dict:
    """The dry-run units (``launch.dryrun``) held to the card.  (a)
    ``gm_serve_step``'s unit at the sharded path's shape traced on a fake
    1 x 1 group: collectives (calls, payload bytes) and FLOPs equal to the
    sharded path's real run of the same unit, peak and temporaries (the
    peak less the arguments) each within ``DRYRUN_PEAK_REL`` of its
    measured ones; (b) qwen1.5-4b's train unit
    at the LM path's shape (B = 2, T = 1,024) traced on a fake 1 x 1
    group: FLOPs equal to ``FlopCounterMode`` over one real step of the LM
    path, peak within ``DRYRUN_PEAK_REL`` of the LM path's
    ``max_memory_allocated``, and the H100 model's bound beside the
    measured step (printed, not held); (c) ``DRYRUN_CELLS`` traced on the
    fake (16, 16) production mesh, printed.  No trace may launch a
    kernel (launch counts reset just before and read just after)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    reset_launch_counts()               # just before the traces
    out = {"card": card}

    t = dryrun_record(card, "rig_gm", serve_real["shape"], (1, 1))
    census = {k.replace("-", "_"): [v["count"], v["payload_bytes"]]
              for k, v in t["collectives"].items()}
    peak = t["memory"]["peak_size_in_bytes"]
    # the arguments are most of the peak (the stack): the temporaries,
    # what the trace adds on top of them, are held apart
    temp = t["memory"]["temp_size_in_bytes"]
    real_temp = serve_real["peak_bytes"] - serve_real["argument_bytes"]
    out["serve_unit"] = {
        "traced": t, "real": serve_real,
        "peak_rel_err": peak / serve_real["peak_bytes"] - 1,
        "temp_rel_err": temp / real_temp - 1}
    checks = {"census": census == serve_real["collectives"],
              "flops": t["flops"] == serve_real["flops"],
              "peak": abs(out["serve_unit"]["peak_rel_err"])
              <= DRYRUN_PEAK_REL,
              "temporaries": abs(out["serve_unit"]["temp_rel_err"])
              <= DRYRUN_PEAK_REL}
    log(f"[{card}] dry-run serve unit against its real run: census "
        f"{census} / {serve_real['collectives']}, FLOPs {t['flops']:,} / "
        f"{serve_real['flops']:,}, peak {peak:,} / "
        f"{serve_real['peak_bytes']:,} B, temporaries {temp:,} / "
        f"{real_temp:,} B: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"the serve unit's trace differs from its "
                             f"real run: {checks}")

    qwen = lm["qwen1.5-4b"]
    shape = dict(kind="train", seq_len=LM_SEQ, global_batch=LM_BATCH)
    t = dryrun_record(card, "qwen1.5-4b", shape, (1, 1))
    peak = t["memory"]["peak_size_in_bytes"]
    step_s = statistics.median(qwen["step_s"])
    bound_s = t["roofline"]["bound_s"]
    out["lm_unit"] = {
        "traced": t, "step_flops": qwen["step_flops"],
        "peak_bytes": qwen["peak_bytes"],
        "peak_rel_err": peak / qwen["peak_bytes"] - 1,
        "step_s": step_s, "bound_s": bound_s,
        "bound_over_step": bound_s / step_s}
    checks = {"flops": t["flops"] == qwen["step_flops"],
              "peak": abs(out["lm_unit"]["peak_rel_err"])
              <= DRYRUN_PEAK_REL}
    log(f"[{card}] dry-run qwen1.5-4b train unit (B = {LM_BATCH}, T = "
        f"{LM_SEQ}, 1 x 1) against the LM path: FLOPs {t['flops']:,} / "
        f"{qwen['step_flops']:,}, peak {peak:,} / {qwen['peak_bytes']:,} B "
        f"({100 * out['lm_unit']['peak_rel_err']:+.2f}%); H100 model bound "
        f"{bound_s:.6f} s ({t['roofline']['dominant']}) against the "
        f"measured step {step_s:.6f} s: {bound_s / step_s:.4f}: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"the LM unit's trace differs from the LM "
                             f"path: {checks}")

    out["production"] = {}
    for arch_id, shape in DRYRUN_CELLS:
        out["production"][f"{arch_id}:{shape}"] = dryrun_record(
            card, arch_id, shape, (16, 16))
    launched = launch_counts()          # just after the traces
    if any(launched.values()):
        raise AssertionError(f"a traced unit launched kernels: {launched}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[{card}] dry-run phase {out['seconds']:.1f} s")
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
                 inputs, shapes, closure_info, dense_info, sharded_info,
                 spills):
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
            # the sharded path's sum mode: the 1 x 1 mesh's tile (A itself)
            # by the batch of 8's first-pass columns
            sargs, skw = inputs["bitmm@sharded"][1:]
            sharded = measure(name, sargs, skw)
            sharded["library_ms"] = bitmm_library_ms(torch, *sargs, **skw)
            row["sharded"] = sharded | {"path": sharded_info}
            row["max_abs_err"] = max(row["max_abs_err"],
                                     sharded["max_abs_err"])
            log(f"[{card}] kernel bitmm in sum mode (sharded path): library "
                f"torch._int_mm of the unpacked int8 A by X "
                f"{sharded['library_ms']:.6f} ms")
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
    serve_launches, device_calls, queries, refs, exact, dg = serve_path(
        torch, card, graph, gm, capture)
    capture.on = False
    level = capture.keep_largest("gather_expand", level_size)
    log(f"[{card}] serve path: largest expanded level kept for the kernel "
        f"phase: {level[1]} gathered rows")
    t_sharded = time.perf_counter()
    sharded_launches, sharded_input, sharded_info = sharded_path(
        torch, card, dg, queries)
    capture.inputs["bitmm@sharded"] = (0, sharded_input, {"threshold": False})
    del dg, sharded_input
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
        f"{t_sharded - t1:.1f} s, sharded path {t2 - t_sharded:.1f} s, "
        f"closure path {t3 - t2:.1f} s, dense closure "
        f"{t4 - t3:.1f} s, count past 2^31 {t5 - t4:.1f} s")
    rows = kernel_phase(torch, np, card,
                        {"gm_match": gm_launches, "serve": serve_launches,
                         "sharded": sharded_launches,
                         "closure": closure_launches,
                         "int64_count": int64_launches},
                        per_query, device_calls, capture.inputs,
                        capture.shapes, closure_info, dense_info,
                        sharded_info, spills)

    # the graph paths' device tensors go before the LM path's 50-odd GB
    del capture, last_r, closure_t, human_r, level
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{card}] device memory before the LM path: "
        f"{torch.cuda.memory_allocated():,} B allocated")
    lm = lm_path(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{card}] device memory before the GNN / DIN path: "
        f"{torch.cuda.memory_allocated():,} B allocated")
    gnn = gnn_path(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{card}] device memory before the gnn_dist path: "
        f"{torch.cuda.memory_allocated():,} B allocated")
    t0 = time.perf_counter()
    gnn_dist = gnn_dist_path(torch, np, card)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    pattern = pattern_path(torch, np, card, rows)
    t2 = time.perf_counter()
    dry = dryrun_path(torch, card, lm, sharded_info["unit"])
    log(f"[{card}] gnn_dist path {t1 - t0:.1f} s, pattern path "
        f"{t2 - t1:.1f} s, dry-run phase {time.perf_counter() - t2:.1f} s")

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    if leaked:
        raise AssertionError(f"imported modules outside the port: {leaked}")
    log(f"[{card}] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"lm": lm}))
    print(json.dumps({"gnn": gnn}))
    print(json.dumps({"gnn_dist": gnn_dist}))
    print(json.dumps({"pattern": pattern}))
    print(json.dumps({"dryrun": dry}))
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
