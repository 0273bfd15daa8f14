"""``PatternQuery.transitive_reduction`` of the port against the JAX
package's, edge for edge: the same ``edges`` in the same order, the same
``labels`` and the same ``name``.

The port reduces in one ordered pass over int bitmasks; the reference
rescans from the first edge after each removal and builds a query for every
edge it tries.  Cyclic patterns, where the reduction is not unique, show
that both keep the same one.
"""

import pytest

from repro.core.query import PatternQuery as JPatternQuery
from repro_torch.core.query import (CHILD, DESC, PatternQuery, QueryEdge,
                                    paper_example_query, query)
from repro_torch.data.graphs import random_labeled_graph
from repro_torch.data.queries import random_query_from_graph


def _triples(q):
    return [(e.src, e.dst, e.kind) for e in q.edges]


def _same_as_reference(q):
    """Reduce ``q`` in both packages; the port's result, after asserting
    that it equals the reference's."""
    ref = JPatternQuery(labels=list(q.labels), edges=_triples(q),
                        name=q.name).transitive_reduction()
    got = q.transitive_reduction()
    assert _triples(got) == _triples(ref)
    assert got.labels == ref.labels
    assert got.name == ref.name
    return got


@pytest.mark.parametrize("seed", range(12))
def test_random_queries_equal_reference(seed):
    """3-8 nodes, H / D / C, sparse and dense extra edges, sampled from a
    uniform graph (cycles included)."""
    g = random_labeled_graph(120, avg_degree=6.0, n_labels=3, kind="uniform",
                             seed=seed)
    dropped = 0
    for n in range(3, 9):
        for qtype in ("H", "D", "C"):
            for p in (0.3, 0.8):
                q = random_query_from_graph(g, n_nodes=n, qtype=qtype,
                                            extra_edge_prob=p,
                                            seed=1000 * seed + 10 * n)
                got = _same_as_reference(q)
                dropped += q.m - got.m
    assert dropped > 0   # the sweep exercises removals, not only keeps


@pytest.mark.parametrize("edges, kept", [
    # 0//2 and 1//2 each imply the other through the 2-cycle 0//1, 1//0;
    # the first tried, 0//2, goes
    ([(0, 1, DESC), (1, 0, DESC), (1, 2, DESC), (0, 2, DESC)],
     [(0, 1, DESC), (1, 0, DESC), (1, 2, DESC)]),
    # a descendant 3-cycle with a chord: the chord 0//2 goes first, and
    # then no cycle edge is implied by the others
    ([(0, 1, DESC), (1, 2, DESC), (2, 0, DESC), (0, 2, DESC)],
     [(0, 1, DESC), (1, 2, DESC), (2, 0, DESC)]),
    # a 4-cycle with both chords in each direction: 0//1 goes first (by
    # 0//2//3//1), and the cycle 0-1-2-3 is not what is kept
    ([(0, 1, DESC), (1, 2, DESC), (2, 3, DESC), (3, 0, DESC),
      (0, 2, DESC), (2, 0, DESC), (1, 3, DESC), (3, 1, DESC)],
     [(0, 2, DESC), (1, 3, DESC), (2, 3, DESC), (3, 0, DESC), (3, 1, DESC)]),
    # a child cycle justifies the descendant edges against it
    ([(0, 1, CHILD), (1, 2, CHILD), (2, 0, CHILD), (1, 0, DESC),
      (2, 1, DESC)],
     [(0, 1, CHILD), (1, 2, CHILD), (2, 0, CHILD)]),
])
def test_cyclic_patterns_equal_reference(edges, kept):
    q = query(labels=[0, 1, 2, 3][:1 + max(max(e[:2]) for e in edges)],
              edges=edges, name="cyc")
    got = _same_as_reference(q)
    assert _triples(got) == sorted(kept)
    assert got.name == "cyc+tr"


def test_child_only_pattern_unchanged():
    q = query(labels=[0, 1, 2, 1],
              edges=[(0, 1, CHILD), (1, 2, CHILD), (0, 2, CHILD),
                     (2, 3, CHILD), (3, 0, CHILD)])
    got = _same_as_reference(q)
    assert _triples(got) == _triples(q)
    assert got.name == "tr"


def test_paper_example_equals_reference():
    got = _same_as_reference(paper_example_query())
    assert got.name == "fig1b+tr"


def test_one_query_built(monkeypatch):
    """One reduction builds exactly one ``PatternQuery``, however many
    descendant edges it tries."""
    q = query(labels=list(range(8)),
              edges=[(i, i + 1, DESC) for i in range(7)] + [(0, 7, DESC)])
    assert sum(e.kind == DESC for e in q.edges) == 8
    built = []
    post_init = PatternQuery.__post_init__

    def counted(self):
        built.append(self)
        post_init(self)

    monkeypatch.setattr(PatternQuery, "__post_init__", counted)
    got = q.transitive_reduction()
    assert len(built) == 1 and built[0] is got
    assert QueryEdge(0, 7, DESC) not in got.edges and got.m == 7
