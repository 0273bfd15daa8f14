"""The frozen generators give the port's graph and queries byte for byte."""

import numpy as np
import pytest

from perfbench.gen import graphs, queries


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_graph_and_queries_equal_the_ports(seed):
    from repro_torch.core.query import PatternQuery
    from repro_torch.data.graphs import paper_profile_graph
    from repro_torch.data.queries import random_query_from_graph
    from repro_torch.core.graph import graph_from_edge_list

    port = paper_profile_graph("epinions", scale=1.0, seed=seed)
    raw = graphs.paper_profile_graph("epinions", scale=1.0, seed=seed)
    mine = graph_from_edge_list(raw.edges, raw.labels,
                                num_labels=raw.num_labels)
    assert mine.n == port.n and mine.num_labels == port.num_labels
    assert np.array_equal(mine.labels, port.labels)
    assert mine.edges.tobytes() == port.edges.tobytes()
    csr = graphs.Csr(raw)
    assert csr.edges.tobytes() == port.edges.tobytes()
    for i, (n, qt) in enumerate([(2, "H"), (3, "C"), (5, "H"), (8, "H")]):
        s = 1000 * seed + i
        want = random_query_from_graph(port, n, qtype=qt, seed=s)
        labels, edges = queries.random_query_from_graph(csr, n, qt, seed=s)
        got = PatternQuery(labels=labels, edges=edges)
        assert got.labels == want.labels
        assert [(e.src, e.dst, e.kind) for e in got.edges] == \
            [(e.src, e.dst, e.kind) for e in want.edges]
        norm = queries.normalize(labels, edges)
        assert list(norm.edges) == [(e.src, e.dst, e.kind)
                                    for e in want.edges]
        tr = queries.transitive_reduction(norm)
        assert list(tr.edges) == [(e.src, e.dst, e.kind) for e in
                                  want.transitive_reduction().edges]


def test_stream_is_seeded_and_keeps_the_mix():
    raw = graphs.paper_profile_graph("epinions", scale=0.05, seed=7)
    csr = graphs.Csr(raw)
    mix = {"mix": [{"n_nodes": 2, "qtype": "H", "count": 1},
                   {"n_nodes": 3, "qtype": "C", "count": 1}]}

    def take(seed):
        return queries.QueryStream(csr, mix, queries.seed_stream(seed, 1),
                                   8, 16).take(40)

    a, b, c = take(2 ** 31 + 5), take(2 ** 31 + 5), take(11)
    assert a == b and a != c
    for qs in (a, c):
        assert sorted(q.n for q in qs) == [2] * 20 + [3] * 20
