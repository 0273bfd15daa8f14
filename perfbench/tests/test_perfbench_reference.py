"""The plain reference's reachability agrees with the port's index (its
simulation is held to the port's CPU path by the end-to-end run test)."""

import numpy as np
import pytest

from perfbench.gen import graphs
from perfbench.reference.graph import Reach


@pytest.fixture(scope="module")
def small():
    from repro_torch.core.graph import graph_from_edge_list
    raw = graphs.paper_profile_graph("epinions", scale=0.01, seed=3)
    g = graph_from_edge_list(raw.edges, raw.labels,
                             num_labels=raw.num_labels)
    return raw, graphs.Csr(raw), g


def test_reach_rows_equal_the_ports_index(small):
    raw, _, g = small
    r = Reach(raw.n, raw.edges, "cpu")
    full = np.zeros((raw.n, raw.n), dtype=bool)
    full[:, r.targets.numpy()] = r.reach.numpy()
    idx = g.reachability()
    want = np.unpackbits(idx.reach_bits.view(np.uint8), axis=1,
                         bitorder="little")[:, :raw.n].astype(bool)
    assert np.array_equal(full, want)
    two = Reach(raw.n, raw.edges, "cpu", max_hops=2).reach.numpy()
    adj = r.adj.numpy()
    a = np.zeros((raw.n, raw.n), dtype=bool)
    a[:, r.targets.numpy()] = adj
    want2 = a | ((a.astype(np.int64) @ a.astype(np.int64)) > 0)
    assert np.array_equal(two, want2[:, r.targets.numpy()])
