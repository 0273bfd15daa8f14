"""The port's engine and server (``repro_torch.engine``,
``repro_torch.launch.serve``) against the JAX package's.

The same seeded graph and requests go through both packages.  The device
lane (``force_backend="device"``: the whole-graph matcher, ``TorchGM``
against ``JaxGM``) must give the same counts, backends and overflow
fallbacks through ``execute`` and ``execute_many``; so must the host and
``frontier-device`` lanes.  The server must give the same per-request
counts and statuses and the same ``server_*`` counters, with an injected
worker fault and a parse rejection among the requests.  The port runs on
the CPU pin; a device error is never re-routed to the host.
"""

import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import match as j_match  # noqa: E402
from repro.data.graphs import random_labeled_graph  # noqa: E402
from repro.data.queries import random_query_from_graph  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineOptions as JOptions  # noqa: E402
from repro.launch.serve import QueryServer as JServer  # noqa: E402
from repro.robust import faults as j_faults  # noqa: E402
from repro_torch.convert import graph_from_arrays, query_from_spec  # noqa: E402
from repro_torch.engine import CircuitBreaker, Engine, EngineOptions  # noqa: E402
from repro_torch.launch.serve import QueryServer  # noqa: E402
from repro_torch.robust import faults  # noqa: E402
from repro_torch.torchgm import frontier as pfrontier  # noqa: E402
from repro_torch.torchgm import matcher as pmatcher  # noqa: E402

CAPACITY = 512          # small enough that the dense queries overflow
MALFORMED = "(a:L0)-/->("


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pfrontier, "DEFAULT_DEVICE", "cpu")
        yield


def _port_query(jq):
    return query_from_spec(jq.labels, [(e.src, e.dst, e.kind)
                                       for e in jq.edges], name=jq.name)


@pytest.fixture(scope="module")
def case():
    """A 300-node graph in both packages and six requests in the server's
    own mix (3-5 nodes, C/H/D), as JAX-package and port queries."""
    jg = random_labeled_graph(300, avg_degree=3.0, n_labels=4, seed=2)
    pg = graph_from_arrays(jg.n, jg.labels, jg.num_labels, jg.edges)
    jqs = [random_query_from_graph(jg, 3 + i % 3, qtype="CHD"[i % 3],
                                   seed=i) for i in range(6)]
    return jg, pg, jqs, [_port_query(q) for q in jqs]


def _device_options(cls, **kw):
    extra = {"device_impl": "reference"} if cls is JOptions else {}
    return cls(device_min_nodes=0, materialize=False, force_backend="device",
               capacity=CAPACITY, exact_sim=True, **extra, **kw)


def _outcome(r):
    return (r.count, r.stats.backend, r.stats.overflow_fallback,
            r.stats.status)


@pytest.fixture(scope="module")
def device_engines(case):
    jg, pg, _, _ = case
    return (JEngine(jg, options=_device_options(JOptions)),
            Engine(pg, options=_device_options(EngineOptions)))


def test_device_lane_equals_reference(case, device_engines):
    jg, _, jqs, pqs = case
    jeng, peng = device_engines
    want = [jeng.execute(q) for q in jqs]
    got = [peng.execute(q) for q in pqs]
    assert [_outcome(r) for r in got] == [_outcome(r) for r in want]
    assert all(r.stats.backend == "device" for r in got)
    assert any(r.stats.overflow_fallback for r in got)     # host re-run
    assert any(not r.stats.overflow_fallback for r in got)
    assert [r.count for r in got] == [j_match(jg, q, limit=None).count
                                      for q in jqs]
    assert got[0].stats.enum_method == "torchgm-frontier"
    # execute_many: one batched dispatch for the device-planned queries
    want = jeng.execute_many(jqs)
    got = peng.execute_many(pqs)
    assert [_outcome(r) for r in got] == [_outcome(r) for r in want]


@pytest.mark.parametrize("lane", [{}, {"force_enum": "frontier-device"}])
def test_host_lanes_equal_reference(case, lane):
    jg, pg, jqs, pqs = case
    jeng = JEngine(jg, options=JOptions(materialize=False, **lane))
    peng = Engine(pg, options=EngineOptions(materialize=False, **lane))
    for method in ("execute", "execute_many"):
        if method == "execute":
            want = [jeng.execute(q) for q in jqs]
            got = [peng.execute(q) for q in pqs]
        else:
            want, got = jeng.execute_many(jqs), peng.execute_many(pqs)
        assert [_outcome(r) for r in got] == [_outcome(r) for r in want]
        assert [r.stats.enum_method for r in got] == \
            [r.stats.enum_method for r in want]
        assert all(r.stats.backend == "host" for r in got)
    if lane:
        assert peng.counters["frontier_batches"] == \
            jeng.counters["frontier_batches"] > 0


def test_device_construction_error_propagates(case, monkeypatch):
    _, pg, _, pqs = case

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(pmatcher.TorchGM, "__init__", broken)
    eng = Engine(pg, options=_device_options(EngineOptions))
    with pytest.raises(RuntimeError, match="CUDA error"):
        eng.execute(pqs[0])
    with pytest.raises(RuntimeError, match="CUDA error"):
        eng.execute_many(pqs[:2])


def test_device_lane_raises_without_cuda_and_without_pin(case, monkeypatch):
    _, pg, _, pqs = case
    monkeypatch.setattr(pfrontier, "DEFAULT_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(pg, options=EngineOptions(force_backend="device"))
    eng = Engine(pg, options=_device_options(EngineOptions,
                                             frontier_device=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.execute(pqs[0])


def test_breaker_transitions_land_in_recorder(case, tmp_path):
    _, pg, _, _ = case
    br = CircuitBreaker(sleep=lambda s: None, failure_threshold=3)
    eng = Engine(pg, options=_device_options(EngineOptions, breaker=br))
    path = tmp_path / "incident.jsonl"
    eng.flight.arm_autodump(str(path))
    with faults.inject(faults.every("device_dispatch", 1)):
        res = eng.execute("(a:L0)-/->(b:L1)")
    faults.uninstall()
    assert res.stats.backend == "host" and "host" in res.stats.degradations
    trans = [e for e in eng.flight.events() if e["kind"] == "breaker"]
    assert trans and trans[-1]["new_state"] == "open"
    meta = json.loads(path.read_text().splitlines()[0])
    assert meta["reason"] == "breaker_open"


def _serve(server_cls, fault_module, graph, queries):
    server = server_cls(graph, batch_size=8, capacity=CAPACITY)
    accepted = [server.submit(i, q) for i, q in enumerate(queries)]
    accepted.append(server.submit(len(queries), MALFORMED))
    with fault_module.inject(fault_module.nth("journal_dispatch", 1)):
        server.drain()
    fault_module.uninstall()
    requests = [(r.rid, r.status, r.count, r.backend, r.overflowed)
                for r in sorted(server.journal.values(),
                                key=lambda r: r.rid)]
    return accepted, requests, sorted(server.rejected), server.stats.copy()


def test_server_equals_reference(case):
    jg, pg, jqs, pqs = case
    want = _serve(JServer, j_faults, jg, jqs)
    got = _serve(QueryServer, faults, pg, pqs)
    assert got == want
    accepted, requests, rejected, stats = got
    assert accepted[-1] is False and rejected == [len(pqs)]
    assert all(status == "done" for _, status, *_ in requests)
    assert stats["redispatched"] == len(pqs) and stats["served"] == len(pqs)
    assert {backend for *_, backend, _ in requests} == {"device"}
