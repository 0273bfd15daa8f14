"""The served cell (``epinions_serve.hybrid``, driver ``query_server``) on
the CPU pin: a run at 1% of the graph comes out correct, traced and not;
a run whose served path is broken underneath comes out not correct, once
for each fault: an answer off by one, one page of a paged level dropped,
the limit ignored, the ``truncated`` flag flipped.

The small cells keep the configuration's settings but for the graph's
scale, ``capacity`` (the small graph's padded node count, the least that
paging allows), ``limit`` and the pools, so that a small graph pages and
truncates.  The faults serve the whole pool once (96 queries at 3% of the
graph, among them some that page below the limit) and check every request.
"""

import copy
import json
import time

import pytest

from perfbench import bench
from perfbench.drivers.common import STATED

CELL = "epinions_serve.hybrid"
SEED = 2 ** 31 + 58


def small_cell(scale=0.01, capacity=1024, limit=5000, pool=64):
    cell = bench.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    g = cell.config["graph"]
    for k in STATED:
        g.pop(k, None)
    g["scale"] = scale
    cell.config["server"].update(capacity=capacity, limit=limit)
    cell.traffic = dict(cell.traffic, pool=pool,
                        warmup=cell.traffic["outstanding"])
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_serve_cell_runs_correct(trace, cpu_pin):
    from repro_torch.obs.metrics import get_registry
    hits = get_registry().counter("enum_limit_hits").value
    line = json.loads(json.dumps(bench.run_cell(
        small_cell(), seed=SEED, seconds=1.0, trace=trace,
        t_start=time.perf_counter())))
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"count_mismatch", "truncated_mismatch",
                                   "over_limit", "redispatched",
                                   "requests_unchecked"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert get_registry().counter("enum_limit_hits").value > hits
    if trace:
        m = line["metrics"]
        assert m["host_fallback_share"]["value"] == 0.0
        assert m["enum_pages"]["value"] > 1
        assert m["enum_host_ms"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"qps", "p95_ms", "setup_s"}


def serve_pool():
    """Set-up, the pool served once, every request checked."""
    from perfbench.drivers import query_server as qs
    from repro_torch.torchgm import frontier
    cell = small_cell(scale=0.03, capacity=2560, limit=100_000, pool=96)
    st = qs.setup(cell, SEED, frontier.resolve())
    qs.serve_pool(st)
    checks = qs.check(st)
    return all(v <= lim for v, lim in checks.values()), checks


def _off_by_one(mp):
    from repro_torch.torchgm.matcher import TorchGM
    orig = TorchGM._enumerate

    def bumped(self, *a, **kw):
        res, order, count, overflowed, s = orig(self, *a, **kw)
        return res, order, count + 1, overflowed, s
    mp.setattr(TorchGM, "_enumerate", bumped)


def _page_dropped(mp):
    from repro_torch.torchgm import enumerate as penum
    orig = penum._cut
    mp.setattr(penum, "_cut", lambda incl, cap: orig(incl, cap)[:-1])


def _limit_ignored(mp):
    """The count not cut at the limit: the enumerator runs on to ten times
    it (unbounded, a query of billions of matches would take hours)."""
    from repro_torch.torchgm import enumerate as penum
    orig = penum._mjoin_paged
    mp.setattr(penum, "_mjoin_paged",
               lambda *a, **kw: orig(*a, **dict(kw, limit=10 * kw["limit"])))


def _truncated_flipped(mp):
    """The engine reports ``truncated`` the wrong way round on the device
    lane, the counts left right."""
    from repro_torch.engine.engine import Engine
    orig = Engine._post_device

    def flipped(self, res, qr, entry, stats, dev, *a, **kw):
        out = orig(self, res, qr, entry, stats, dev, *a, **kw)
        stats.truncated = not stats.truncated
        return out
    mp.setattr(Engine, "_post_device", flipped)


def test_served_pool_is_correct(cpu_pin):
    ok, checks = serve_pool()
    assert ok, checks
    assert checks["truncated_mismatch"] == (0, 0)


@pytest.mark.parametrize("fault", [_off_by_one, _page_dropped,
                                   _limit_ignored, _truncated_flipped],
                         ids=lambda f: f.__name__)
def test_serve_fault_is_not_correct(fault, cpu_pin, monkeypatch):
    fault(monkeypatch)
    ok, checks = serve_pool()
    assert not ok, checks
