"""The program's ``repro_torch.*`` ranges read from a hand-made trace
(:mod:`perfbench.program_trace`), the harness's reduction left as it was
beside them, and the counter reading of ``edge_slot_use``."""

import pytest

from perfbench import program_trace, trace
from perfbench.metrics import edge_slot_use

from .test_perfbench_trace import Ev, events


def program_events():
    """The window is [0, 1000) on thread 1.  Times in microseconds."""
    return [
        Ev("user_annotation", "perfbench.window", 0, 1000, corr=1),
        Ev("user_annotation", "repro_torch.query.reduce", 10, 30, corr=2),
        Ev("user_annotation", "repro_torch.query.reduce", 50, 20, corr=3),
        Ev("user_annotation", "repro_torch.query.encode", 80, 20, corr=4),
        Ev("user_annotation", "repro_torch.serve.step", 100, 200, corr=5),
        Ev("cuda_runtime", "cudaLaunchKernel", 110, 2, corr=900, linked=6),
        Ev("kernel", "bitmm", 150, 100, corr=900, linked=6),
        Ev("user_annotation", "repro_torch.simulation.masks", 200, 60,
           corr=7),
        Ev("cuda_runtime", "cudaLaunchKernel", 210, 2, corr=901, linked=8),
        Ev("kernel", "index", 240, 50, corr=901, linked=8),
        Ev("gpu_user_annotation", "repro_torch.simulation.masks", 240, 50,
           corr=7),
        Ev("cuda_runtime", "cudaLaunchKernel", 280, 2, corr=902, linked=9),
        Ev("kernel", "topk", 400, 20, corr=902, linked=9),
        Ev("cuda_runtime", "cudaMemcpyAsync", 320, 2, corr=903, linked=10),
        Ev("gpu_memcpy", "Memcpy DtoH", 430, 20, corr=903, linked=10),
        # a step on another thread: its host time counts, its idle does not
        Ev("user_annotation", "repro_torch.serve.step", 600, 100, corr=11,
           tid=2),
        # after the window: nothing of it counts
        Ev("user_annotation", "repro_torch.query.reduce", 1100, 50,
           corr=12),
        Ev("cuda_runtime", "cudaLaunchKernel", 1110, 2, corr=904, linked=13),
        Ev("kernel", "late", 1120, 30, corr=904, linked=13),
    ]


def test_phases_read_by_hand():
    s = program_trace.summarize(program_events())
    us = pytest.approx
    # busy [150, 290), [400, 420), [430, 450); idle [0, 150), [290, 400),
    # [420, 430), [450, 1000)
    assert s.busy_s == us(180e-6)
    assert s.counts == {"query.reduce": 2, "query.encode": 1,
                        "serve.step": 2, "simulation.masks": 1}
    assert s.host_s == {"query.reduce": us(50e-6), "query.encode": us(20e-6),
                        "serve.step": us(300e-6),
                        "simulation.masks": us(60e-6)}
    assert s.device_s == {"serve.step": us(170e-6),
                          "simulation.masks": us(50e-6)}
    assert s.ops == {"serve.step": 3, "simulation.masks": 1}
    assert s.idle_s == {"query.reduce": us(50e-6), "query.encode": us(20e-6),
                        "serve.step": us(60e-6), "simulation.masks": 0.0}
    # the launches at 110, 210 and 280 are in the step, the copy's at 320
    # after it
    assert s.runtime_s == {"serve.step": {"cudaLaunchKernel": us(6e-6)},
                           "simulation.masks": {"cudaLaunchKernel": us(2e-6)}}
    assert s.per_step() == {"reduce_ms": us(0.025),
                            "encode_batch_ms": us(0.010),
                            "issue_ms": us(0.150), "idle_issue_ms": us(0.030),
                            "serve_ops": us(1.5),
                            "masks_device_ms": us(0.025)}


def test_harness_reads_the_same_with_the_program_ranges():
    plain = events()
    ranges = [e for e in program_events()
              if e.kind == "user_annotation" and e._name.startswith(
                  program_trace.PREFIX)]
    assert trace.summarize(plain + ranges) == trace.summarize(plain)
    both = program_trace.summarize(plain + ranges)
    assert both.busy_s == pytest.approx(trace.summarize(plain).busy_s)


def test_absent_phases_read_nothing():
    s = program_trace.summarize(events())
    assert s.counts == {} and s.busy_s > 0
    assert set(s.per_step().values()) == {None}
    no_masks = [e for e in program_events()
                if "simulation.masks" not in e._name]
    got = program_trace.summarize(no_masks).per_step()
    assert got["masks_device_ms"] is None and got["issue_ms"] is not None
    assert program_trace.summarize(program_events()[1:]) is None


def test_edge_slot_use_reads_the_counters(monkeypatch):
    from repro_torch.obs import metrics
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "REGISTRY", reg)
    assert edge_slot_use.read(None) is None
    reg.counter("serve_edge_slots").inc(200)
    reg.counter("serve_edge_slots_real").inc(90)
    assert edge_slot_use.read(None) == pytest.approx(45.0)
