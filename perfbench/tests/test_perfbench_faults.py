"""A run whose timed path is broken underneath comes out not correct:
once for each fault that the cells can have.  (One card: no exchange
between chips to leave out.)"""

import time
from dataclasses import fields

import pytest

from perfbench import bench

from .conftest import tiny_cell


def run(name):
    return bench.run_cell(tiny_cell(name), seed=2 ** 31 + 99, seconds=1.0,
                          trace=False, t_start=time.perf_counter())


def _filter_state_unchanged(mp):
    from repro_torch.torchgm import distributed
    mp.setattr(distributed, "apply_edge_masks",
               lambda fb, y, n_e, edges: fb)


def _filter_half_batch(mp):
    from repro_torch.torchgm import distributed
    from repro_torch.torchgm.encoding import QueryTensor
    orig = distributed.gm_serve_step

    def half(mats, labels, qts, mesh, **kw):
        h = max(1, qts.labels.shape[0] // 2)
        cut = QueryTensor(*(getattr(qts, f.name)[:h]
                            for f in fields(QueryTensor)))
        out = orig(mats, labels, cut, mesh, **kw)
        b = qts.labels.shape[0]
        rep = [i % h for i in range(b)]
        return distributed.ServeStepOut(*(t[rep] for t in out))
    mp.setattr(distributed, "gm_serve_step", half)


def _filter_answer_altered(mp):
    from repro_torch.torchgm import distributed
    orig = distributed.gm_serve_step

    def bumped(*a, **kw):
        out = orig(*a, **kw)
        out.edge_counts[0, 0] += 1
        return out
    mp.setattr(distributed, "gm_serve_step", bumped)


@pytest.mark.parametrize("name,fault", [
    ("epinions_filter.hybrid", _filter_state_unchanged),
    ("epinions_filter.hybrid", _filter_half_batch),
    ("epinions_filter.hybrid", _filter_answer_altered),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(name, fault, cpu_pin, monkeypatch):
    fault(monkeypatch)
    out = run(name)
    assert out["correct"] is False, out["checks"]
