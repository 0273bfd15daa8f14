"""What the drivers share: the data graph and query pool made from the
seed, the kernel wrapper of a traced run, and its work counts."""

from __future__ import annotations

from typing import List

import numpy as np

from .. import work
from ..gen.graphs import Csr, RawGraph, paper_profile_graph
from ..gen.queries import QueryStream, seed_stream

# streams of a generator seed: traffic pool, warm-up pool, the run's
# order of the pool, the run's node ids, the check's sample
POOL, WARMUP, ORDER, IDS, SAMPLE = 1, 2, 3, 4, 5


# what a configuration's ``graph`` may state about its data set
STATED = ("nodes", "edges", "edge_targets", "labels")


def graph_facts(base: RawGraph) -> dict:
    """Nodes, distinct edges, nodes with an incoming edge, labels."""
    edges = np.unique(base.edges, axis=0)
    return {"nodes": base.n, "edges": len(edges),
            "edge_targets": len(np.unique(edges[:, 1])),
            "labels": base.num_labels}


def make_graph(config: dict, seed: int):
    """The configuration's data set, its node ids permuted by the run's
    seed: (the CSR of the data set as generated, which the query pool is
    drawn from; the permuted raw graph; the port's DataGraph of it).  The
    data set is the profile's graph at the configuration's generator
    seed, the same in every run, as a deployment serves one graph; what
    the configuration states of it (``STATED``) is held to it."""
    from repro_torch.core.graph import graph_from_edge_list
    g = config["graph"]
    base = paper_profile_graph(g["profile"],
                               scale=float(g.get("scale", 1.0)),
                               seed=int(g["seed"]))
    facts = graph_facts(base)
    wrong = {k: (g[k], facts[k]) for k in STATED
             if k in g and g[k] != facts[k]}
    if wrong:
        raise ValueError(f"the data set is not what the configuration "
                         f"states (stated, made): {wrong}")
    perm = seed_stream(seed, IDS).permutation(base.n)
    labels = np.empty_like(base.labels)
    labels[perm] = base.labels
    raw = RawGraph(edges=perm[base.edges], labels=labels,
                   num_labels=base.num_labels)
    graph = graph_from_edge_list(raw.edges, raw.labels,
                                 num_labels=raw.num_labels)
    return Csr(base), raw, graph


def make_pool(csr: Csr, traffic: dict, stream: int, size: int,
              max_q: int, max_e: int):
    """``size`` queries of the mix, drawn from the data set with the
    traffic's generator seed (the same in every run), in the harness's
    normal form and as the port's ``PatternQuery``."""
    from repro_torch.core.query import PatternQuery
    qs = QueryStream(csr, traffic, seed_stream(int(traffic["seed"]), stream),
                     max_q, max_e).take(size)
    return qs, [PatternQuery(labels=list(q.labels), edges=list(q.edges))
                for q in qs]


def order(seed: int, size: int, block: int) -> np.ndarray:
    """The run's order of the pool: the pool's consecutive blocks of
    ``block`` queries in turn, each in an order drawn from the seed, so
    that a window sends the same queries whatever the seed, up to its
    last block."""
    rng = seed_stream(seed, ORDER)
    return np.concatenate([a + rng.permutation(min(block, size - a))
                           for a in range(0, size, block)])


class KernelWork:
    """Wraps the port's ``bitmm`` for a traced run: each call becomes span
    ``kernel.bitmm``, and its work is counted from its inputs' shapes
    (host only: nothing is launched or read on the device)."""

    def __init__(self, rec):
        self.rec = rec
        self.bitmm: List[tuple] = []

    def install(self) -> None:
        from repro_torch.kernels import ops
        self.rec.wrap(ops, "bitmm", "kernel.bitmm", after=self._bitmm)

    def _bitmm(self, args, kw, out) -> None:
        a, x = args[0], args[1]
        m, w = a.shape
        k, b = x.shape
        self.bitmm.append((m, w, k, b, x.element_size(),
                           kw.get("threshold", True)))

    def least_s(self) -> dict:
        """Least seconds, summed over the traced calls, of each kernel."""
        if not self.bitmm:
            return {}
        return {"bitmm": sum(work.least_s("bitmm", *work.bitmm(
            m, w, k, b, x_bytes=xb, threshold=t))[0]
            for m, w, k, b, xb, t in self.bitmm)}
