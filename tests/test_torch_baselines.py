"""The port's JM / TM baselines (``repro_torch.core.baselines``) against the
reference's (``repro.core.baselines``).

The inputs are those of ``tests/core/test_matcher.py::test_jm_tm_gm_agree``
(a 40-node graph, a 4-node query), at fixed seeds instead of hypothesis
draws, and the same for C and D queries.  Both packages get the same graph
and query (carried across with ``repro_torch.convert``) and must give
equal tuples, counts and plans, and raise their budget exceptions on the
same inputs when ``budget_rows`` is small.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import baselines as ref  # noqa: E402
from repro.data.graphs import random_labeled_graph  # noqa: E402
from repro.data.queries import random_query_from_graph  # noqa: E402
from repro_torch.convert import graph_from_arrays, query_from_spec  # noqa: E402
from repro_torch.core import baselines as port  # noqa: E402

SEEDS = (0, 7, 52, 1234, 4999)
# budget_rows small enough that some of these inputs blow it
BUDGETS = (8, 64, 256)


def _case(seed, qtype):
    g = random_labeled_graph(40, avg_degree=2.0, n_labels=4, seed=seed % 53)
    q = random_query_from_graph(g, n_nodes=4, qtype=qtype, seed=seed)
    pg = graph_from_arrays(g.n, g.labels, g.num_labels, g.edges)
    pq = query_from_spec(q.labels, [(e.src, e.dst, e.kind) for e in q.edges])
    return (g, q), (pg, pq)


def _edges(edges):
    return [(e.src, e.dst, e.kind) for e in edges]


@pytest.mark.parametrize("qtype", ["H", "C", "D"])
@pytest.mark.parametrize("seed", SEEDS)
def test_jm_equals_reference(seed, qtype):
    (g, q), (pg, pq) = _case(seed, qtype)
    want = ref.jm_match(g, q)
    got = port.jm_match(pg, pq)
    assert got.count == want.count
    np.testing.assert_array_equal(got.tuples, want.tuples)
    assert got.plan == want.plan
    assert got.plans_enumerated == want.plans_enumerated
    assert got.max_intermediate == want.max_intermediate


@pytest.mark.parametrize("qtype", ["H", "C", "D"])
@pytest.mark.parametrize("seed", SEEDS)
def test_tm_equals_reference(seed, qtype):
    (g, q), (pg, pq) = _case(seed, qtype)
    want = ref.tm_match(g, q)
    got = port.tm_match(pg, pq)
    assert got.count == want.count
    np.testing.assert_array_equal(got.tuples, want.tuples)
    assert _edges(got.tree_edges) == _edges(want.tree_edges)
    assert _edges(got.nontree_edges) == _edges(want.nontree_edges)
    assert got.tree_solutions == want.tree_solutions


def _outcome(fn, exc):
    """(count, tuples) of ``fn()``, or the message of ``exc`` it raises."""
    try:
        r = fn()
    except exc as e:
        return str(e)
    return r.count, r.tuples.tolist()


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("qtype", ["H", "D"])
def test_budget_exceptions_equal_reference(qtype, budget):
    raised = 0
    for seed in SEEDS:
        (g, q), (pg, pq) = _case(seed, qtype)
        for fn, exc_ref, exc_port in (
                ("jm_match", ref.JMBudgetExceeded, port.JMBudgetExceeded),
                ("tm_match", ref.TMTimeout, port.TMTimeout)):
            want = _outcome(lambda: getattr(ref, fn)(g, q, budget_rows=budget),
                            exc_ref)
            got = _outcome(lambda: getattr(port, fn)(pg, pq,
                                                     budget_rows=budget),
                           exc_port)
            assert got == want, (fn, seed)
            raised += isinstance(got, str)
    if budget == 8:
        assert raised, "no input blew a budget of 8 rows"
