"""The port's device executors against the JAX package's.

``repro_torch.torchgm`` (torch mode on the CPU) is held to
``repro.jaxgm`` (``xla`` and Pallas ``interpret`` modes) on the same RIG:
the same resident packing byte for byte, the same counts and pairs, and
the same bytes charged to each transfer-ledger site.  The executors run
on the card unless the CPU is asked for, and a device error is never
hidden behind the host fallback.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.mjoin import mjoin as j_mjoin  # noqa: E402
from repro.core.ordering import get_order as j_get_order  # noqa: E402
from repro.core.rig import build_rig as j_build_rig  # noqa: E402
from repro.data.graphs import random_labeled_graph  # noqa: E402
from repro.data.queries import random_query_from_graph  # noqa: E402
from repro.jaxgm import frontier as jfrontier  # noqa: E402
from repro.jaxgm.device_graph import pack_resident_rig as j_pack  # noqa: E402
from repro.obs.ledger import LEDGER as J_LEDGER  # noqa: E402
from repro_torch.convert import (graph_from_arrays, query_from_spec,  # noqa: E402
                                 resident_from_packed)
from repro_torch.core import GM, GMOptions  # noqa: E402
from repro_torch.core.mjoin import mjoin as p_mjoin  # noqa: E402
from repro_torch.core.ordering import get_order as p_get_order  # noqa: E402
from repro_torch.core.rig import build_rig as p_build_rig  # noqa: E402
from repro_torch.obs.ledger import LEDGER as P_LEDGER  # noqa: E402
from repro_torch.robust import CircuitBreaker, faults  # noqa: E402
from repro_torch.torchgm import frontier as pfrontier  # noqa: E402
from repro_torch.torchgm.device_graph import pack_resident_rig as p_pack  # noqa: E402

RESIDENT = "frontier-device-resident"
SITES = ("resident_upload", "index_vectors", "pair_extract_d2h")


@pytest.fixture(autouse=True)
def _cpu_and_fresh_ledgers(monkeypatch):
    monkeypatch.setattr(pfrontier, "DEFAULT_DEVICE", "cpu")
    for led in (J_LEDGER, P_LEDGER):
        led.reset()
        led.arm()
    yield
    for led in (J_LEDGER, P_LEDGER):
        led.reset()
        led.arm()


def _both(n=60, deg=2.5, labels=3, gseed=7, qn=4, qtype="H", qseed=8):
    """One seeded graph + query as JAX-package and port objects, with the
    RIG and order each package builds for it."""
    jg = random_labeled_graph(n, avg_degree=deg, n_labels=labels, seed=gseed)
    jq = random_query_from_graph(jg, n_nodes=qn, qtype=qtype, seed=qseed)
    pg = graph_from_arrays(jg.n, jg.labels, jg.num_labels, jg.edges)
    pq = query_from_spec(jq.labels, [(e.src, e.dst, e.kind)
                                     for e in jq.edges], name=jq.name)
    jrig = j_build_rig(jg, jq.transitive_reduction())
    prig = p_build_rig(pg, pq.transitive_reduction())
    jorder, porder = j_get_order(jrig, "jo"), p_get_order(prig, "jo")
    assert jorder == porder
    return (jg, jq, jrig, jorder), (pg, pq, prig, porder)


def _ledger_bytes(led, site):
    t = led.transfers
    return t.h2d_bytes(site=site), t.d2h_bytes(site=site)


# ------------------------------------------------------------ packing
@pytest.mark.parametrize("qtype,qseed", [("C", 3), ("H", 8), ("D", 4)])
def test_pack_resident_rig_byte_equal(qtype, qseed):
    (_, _, jrig, _), (_, _, prig, _) = _both(qtype=qtype, qseed=qseed)
    want = j_pack(jrig)
    for got in (p_pack(prig), p_pack(jrig)):
        assert got[0].dtype == want[0].dtype == np.uint32
        assert got[0].shape == want[0].shape
        assert got[0].tobytes() == want[0].tobytes()
        assert list(got[1:]) == list(want[1:])


# ------------------------------------------------ resident executor
@pytest.mark.parametrize("jmode,cfg", [
    ("xla", dict()),
    ("xla", dict(n=80, deg=3.0, labels=2, gseed=3, qn=3, qtype="D",
                 qseed=4)),
    ("interpret", dict(n=40, deg=2.2, labels=3, gseed=11, qn=3,
                       qseed=12)),
])
def test_resident_matches_jax_executor(jmode, cfg, monkeypatch):
    monkeypatch.setattr(jfrontier, "DEFAULT_MODE", jmode)
    (_, _, jrig, order), (_, _, prig, _) = _both(**cfg)
    for limit, max_frontier in ((None, 1 << 25), (None, 3), (7, 1 << 25)):
        jr = j_mjoin(jrig, order, limit=limit, method=RESIDENT,
                     max_frontier=max_frontier)
        pr = p_mjoin(prig, order, limit=limit, method=RESIDENT,
                     max_frontier=max_frontier)
        assert pr.count == jr.count
        assert pr.stats.truncated == jr.stats.truncated
        assert pr.tuples.tobytes() == jr.tuples.tobytes()
        assert pr.stats.method == RESIDENT and pr.stats.degradations == []
        assert pr.stats.device_calls == jr.stats.device_calls
        assert pr.stats.resident_pages == jr.stats.resident_pages
        assert pr.stats.frontier_levels == jr.stats.frontier_levels
        if jmode == "xla":          # the same host-extraction readback
            assert (pr.stats.h2d_bytes, pr.stats.d2h_bytes) == \
                (jr.stats.h2d_bytes, jr.stats.d2h_bytes)
    for site in SITES:
        if site == "pair_extract_d2h" and jmode != "xla":
            continue                # interpret mode ships full pair pages
        assert _ledger_bytes(P_LEDGER, site) == _ledger_bytes(J_LEDGER, site)
    assert P_LEDGER.transfers.h2d_bytes(site="index_vectors") > 0


def test_resident_dispatch_api_matches_jax(monkeypatch):
    monkeypatch.setattr(jfrontier, "DEFAULT_MODE", "xla")
    (_, _, jrig, order), (_, _, prig, _) = _both(qtype="D", qseed=4)
    jres = jfrontier.ResidentIntersector.build(jrig)
    pres = pfrontier.ResidentIntersector.build(prig)
    assert pres.nbytes == jres.nbytes and pres.device.type == "cpu"
    assert pres.fingerprint == jres.fingerprint
    from repro.core import bitset
    from repro.core.mjoin import _constraints
    cons = _constraints(jrig.query, order)
    slab = np.arange(jrig.cos_size(order[0]), dtype=np.int64)[:, None]
    n_i = jrig.cos_size(order[1])
    jh, jc = jres.intersect(cons[1], slab, bitset.n_words(n_i))
    ph, pc = pres.intersect(cons[1], slab, bitset.n_words(n_i))
    assert np.array_equal(pc, jc) and pc.dtype == jc.dtype == np.int64
    want = int(jc.sum())
    for cut in (want, max(1, want // 2)):
        jr, jcid = jres.expand(jh, n_i, cut)
        pr, pcid = pres.expand(ph, n_i, cut)
        assert np.array_equal(pr, jr) and np.array_equal(pcid, jcid)
    assert pres.close() == pres.nbytes and pres.closed
    assert pres.close() == 0
    assert P_LEDGER.resident.live_bytes() == 0 and P_LEDGER.resident.conserved()
    jres.close()


def test_resident_from_packed_reference_matrix():
    (_, _, jrig, order), (pg, pq, prig, _) = _both(qtype="D", qseed=4)
    want = p_mjoin(prig, order, limit=None)              # host backtrack
    ex = resident_from_packed(*j_pack(jrig), device="cpu")
    prig.resident = ex
    got = p_mjoin(prig, order, limit=None, method=RESIDENT)
    assert got.stats.resident_uploads == 0               # the preset matrix
    assert got.count == want.count
    assert got.tuples.tobytes() == want.tuples.tobytes()
    # warm reuse through the user's entry point
    ex.fingerprint = pfrontier.resident_fingerprint(prig)
    res = GM(pg).match(pq, GMOptions(enum_method=RESIDENT, limit=None,
                                     resident_executor=ex))
    assert res.resident_uploads == 0 and res.count == want.count
    assert ex.close() == ex.nbytes


# ---------------------------------------------------------- slab executor
@pytest.mark.parametrize("jmode", ["xla", "interpret"])
def test_device_intersector_matches_jax(jmode):
    rng = np.random.default_rng(17)
    rows = rng.integers(0, 1 << 63, size=(37, 3, 5), dtype=np.uint64)
    jex = jfrontier.DeviceIntersector(mode=jmode)
    pex = pfrontier.DeviceIntersector(device="cpu")
    ja, jc = jex(rows)
    pa, pc = pex(rows)
    assert pa.dtype == ja.dtype == np.uint64 and np.array_equal(pa, ja)
    assert pc.dtype == jc.dtype and np.array_equal(pc, jc)
    assert (pex.h2d_bytes, pex.d2h_bytes) == (jex.h2d_bytes, jex.d2h_bytes)
    assert pex.peak_slab_bytes == jex.peak_slab_bytes
    assert _ledger_bytes(P_LEDGER, "slab_ship") == \
        _ledger_bytes(J_LEDGER, "slab_ship")


# ------------------------------------------------- no hidden fallbacks
def test_no_cuda_and_no_pin_raises(monkeypatch):
    monkeypatch.setattr(pfrontier, "DEFAULT_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mj = importlib.import_module("repro_torch.core.mjoin")
    monkeypatch.setattr(mj, "_DEVICE", None)
    _, (pg, pq, prig, order) = _both()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfrontier.DeviceIntersector()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfrontier.ResidentIntersector.build(prig)
    for method in (RESIDENT, "frontier-device"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GM(pg).match(pq, GMOptions(enum_method=method))
    with pytest.raises(ValueError, match="unsupported device"):
        pfrontier.resolve("meta")
    assert pfrontier.resolve("cpu") == torch.device("cpu")


def test_device_error_is_not_degraded_to_host():
    """Only injected faults and an open breaker take the degradation
    ladder: any other device error propagates."""
    _, (_, _, prig, order) = _both()

    class Broken(pfrontier.ResidentIntersector):
        def intersect(self, cs, slab, w64):
            raise RuntimeError("CUDA error: an illegal memory access")

    prig.resident = Broken(*p_pack(prig), device="cpu")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        p_mjoin(prig, order, limit=None, method=RESIDENT,
                breaker=CircuitBreaker())
    prig.release_resident()


def test_injected_fault_degrades_to_host():
    _, (_, _, prig, order) = _both()
    want = p_mjoin(prig, order, limit=None)
    with faults.inject(faults.every("device_dispatch", 1)):
        got = p_mjoin(prig, order, limit=None, method=RESIDENT,
                      breaker=CircuitBreaker(sleep=lambda s: None))
    assert "host-intersect" in got.stats.degradations
    assert got.tuples.tobytes() == want.tuples.tobytes()
    prig.release_resident()
    assert P_LEDGER.resident.live_bytes() == 0
