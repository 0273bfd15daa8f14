"""The control comes out as not correct, at the cell's own size on the
card (``-m cuda``), on three seeds: the reference put in the program's
place with one stated guarantee broken (reachability cut at paths of two
edges instead of the whole closure), compared as a run compares.  It
prints its readings (mismatches out of the numbers compared), which
PERF.md records."""

import numpy as np
import pytest
import torch

from perfbench import bench
from perfbench.drivers import common, serve_step
from perfbench.gen.queries import transitive_reduction
from perfbench.reference.graph import Reach
from perfbench.reference.simulation import simulate

SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


def _inputs(name, seed, n):
    cell = bench.load_cell(name)
    cfg, tr = cell.config, cell.traffic
    caps = cfg["filter"]
    csr, raw, _ = common.make_graph(cfg, seed)
    pool, _ = common.make_pool(csr, tr, common.POOL, int(tr["pool"]),
                               caps["max_q"], caps["max_e"])
    seq = common.order(seed, len(pool), int(tr["block"]))[:n]
    return cfg, raw, [pool[i] for i in seq]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_filter_control_two_hops(seed, cuda):
    b = 32
    cfg, raw, pool = _inputs("epinions_filter.hybrid", seed,
                             serve_step.CHECK_STEPS * b)
    c = cfg["filter"]
    labels = torch.as_tensor(raw.labels, device="cuda")
    full = Reach(raw.n, raw.edges, "cuda")
    cut = Reach(raw.n, raw.edges, "cuda", max_hops=2)
    bad = np.zeros(3, dtype=np.int64)
    for s in range(serve_step.CHECK_STEPS):
        qs = [transitive_reduction(q) for q in pool[s * b:(s + 1) * b]]
        kw = dict(max_q=c["max_q"], max_e=c["max_e"],
                  n_passes=c["n_passes"], top_k=c["top_k"])
        want, got = simulate(full, labels, qs, **kw), \
            simulate(cut, labels, qs, **kw)
        bad += [int((w != g).sum()) for w, g in zip(want, got)]
    print(f"control filter seed {seed}: fb_sizes_mismatch {bad[0]}, "
          f"edge_counts_mismatch {bad[1]}, candidates_mismatch {bad[2]}")
    assert bad.sum() > 0
