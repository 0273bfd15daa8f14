"""Driver of the sharded filter step: the port's ``gm_serve_step`` on a
``make_local_mesh`` mesh (one card: 1 x 1 over NCCL), over the graph
that ``device_graph.from_host(closure_on_device=True)`` packs.

A closed loop keeps one step in flight: each step takes the next
``outstanding`` queries of the pool that set-up drew from the seed,
reduces them transitively and encodes them (``encode_batch``; span
``encode`` in a traced run), runs the step, and reads its outputs back to
the host.  Each query's latency is that of the step that answered it.

The check: the outputs of a sample of steps drawn from the seed (FB
sizes, RIG edge counts, the compacted candidates), entry by entry, against
the plain reference (:mod:`perfbench.reference.simulation`).
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..bench import Window
from ..gen.queries import seed_stream, transitive_reduction
from .common import (POOL, SAMPLE, WARMUP, KernelWork, make_graph, make_pool,
                     order)

# steps whose outputs the reference recomputes
CHECK_STEPS = 8


@dataclass
class State:
    seed: int
    device: object
    config: dict
    raw: object
    mesh: object
    dg: object
    mats: object
    labels: object
    pool: list
    pool_pq: list
    order: list = field(default_factory=list)
    next: int = 0
    steps: int = 0
    # reservoir of (step number, pool indices, fb_sizes, edge_counts,
    # candidates) kept for the check
    kept: List[tuple] = field(default_factory=list)
    rng: Optional[np.random.Generator] = None
    work: Optional[KernelWork] = None
    # the reference's reachability and node labels on the device
    ref: Optional[tuple] = None


def _step(st: State, idx: List[int], span=None):
    from repro_torch.torchgm.distributed import gm_serve_step
    from repro_torch.torchgm.encoding import encode_batch
    c = st.config["filter"]
    with span("encode") if span is not None else nullcontext():
        qts = encode_batch([st.pool_pq[i].transitive_reduction()
                            for i in idx], c["max_q"], c["max_e"])
    out = gm_serve_step(st.mats, st.labels, qts, st.mesh,
                        n_passes=c["n_passes"], top_k=c["top_k"])
    return (out.fb_sizes.cpu().numpy(), out.edge_counts.cpu().numpy(),
            out.candidates.cpu().numpy())


def _take(st: State, seq, b: int) -> List[int]:
    """The next ``b`` pool indices of the order ``seq`` (repeated)."""
    idx = [seq[(st.next + j) % len(seq)] for j in range(b)]
    st.next += b
    return idx


def setup(cell, seed: int, device) -> State:
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.torchgm import device_graph
    from repro_torch.torchgm.distributed import shard_graph_arrays
    cfg, tr = cell.config, cell.traffic
    c = cfg["filter"]
    csr, raw, graph = make_graph(cfg, seed)
    pool, pool_pq = make_pool(csr, tr, POOL, int(tr["pool"]), c["max_q"],
                              c["max_e"])
    _, warm_pq = make_pool(csr, tr, WARMUP, int(tr["warmup"]), c["max_q"],
                           c["max_e"])
    mesh = make_local_mesh(*cfg["mesh"])
    dg = device_graph.from_host(graph, closure_on_device=True, device=device)
    mats, labels = shard_graph_arrays(dg, mesh)
    st = State(seed=seed, device=device, config=cfg, raw=raw, mesh=mesh, dg=dg,
               mats=mats, labels=labels, pool=pool, pool_pq=pool_pq,
               order=order(seed, len(pool), int(tr["block"])).tolist(),
               rng=seed_stream(seed, SAMPLE))
    b = int(c["batch"])
    if int(tr["outstanding"]) != b:
        raise ValueError(f"one step in flight: the traffic's outstanding "
                         f"{tr['outstanding']} must be the batch {b}")
    saved = st.pool_pq
    st.pool_pq = warm_pq
    for _ in range(max(1, len(warm_pq) // b)):
        _step(st, _take(st, range(len(warm_pq)), b))
    st.pool_pq, st.next = saved, 0
    return st


def instrument(st: State, rec) -> None:
    st.work = KernelWork(rec)
    st.work.install()


def window(st: State, seconds: float, rec) -> Window:
    b = int(st.config["filter"]["batch"])
    win = Window()
    span = rec.span if rec.annotate else None
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        idx = _take(st, st.order, b)
        ts = time.perf_counter()
        if span is not None:
            with span("step"):
                out = _step(st, idx, span)
        else:
            out = _step(st, idx)
        dt = time.perf_counter() - ts
        win.attempted += b
        win.latencies.extend([dt] * b)
        _keep(st, idx, out)
        st.steps += 1
    win.seconds = time.perf_counter() - t0
    win.answered = len(win.latencies)
    return win


def _keep(st: State, idx, out) -> None:
    """Reservoir sample of the window's steps, drawn from the seed."""
    item = (st.steps, list(idx), *out)
    if len(st.kept) < CHECK_STEPS:
        st.kept.append(item)
        return
    j = int(st.rng.integers(0, st.steps + 1))
    if j < CHECK_STEPS:
        st.kept[j] = item


def readings(st: State, rec) -> dict:
    return {"least_s": st.work.least_s()}


def teardown(st: State) -> None:
    import torch.distributed as dist
    st.mats = st.labels = st.dg = None
    st.mesh = None
    if dist.is_initialized():
        dist.destroy_process_group()


def reference(st: State, queries):
    """The reference's outputs for one step's queries."""
    import torch
    from ..reference.graph import Reach
    from ..reference.simulation import simulate
    if st.ref is None:
        st.ref = (Reach(st.raw.n, st.raw.edges, st.device),
                  torch.as_tensor(st.raw.labels, device=st.device))
    c = st.config["filter"]
    return simulate(st.ref[0], st.ref[1],
                    [transitive_reduction(q) for q in queries],
                    max_q=c["max_q"], max_e=c["max_e"],
                    n_passes=c["n_passes"], top_k=c["top_k"])


def check(st: State) -> Dict[str, tuple]:
    bad = {"fb_sizes": 0, "edge_counts": 0, "candidates": 0}
    for _, idx, sizes, counts, cand in st.kept:
        ref = reference(st, [st.pool[i] for i in idx])
        bad["fb_sizes"] += int((sizes != ref.fb_sizes).sum())
        bad["edge_counts"] += int((counts != ref.edge_counts).sum())
        bad["candidates"] += int((cand != ref.candidates).sum())
    return {"fb_sizes_mismatch": (bad["fb_sizes"], 0),
            "edge_counts_mismatch": (bad["edge_counts"], 0),
            "candidates_mismatch": (bad["candidates"], 0),
            "steps_unchecked": (int(not st.kept), 0)}
