"""The trace reduction on a hand-made event list, laid out as torch's
profiler gives it: device operations joined through their runtime calls
to the harness spans, the busy time as a union, the idle gaps named by
what the host was in."""

import pytest
from torch.autograd import DeviceType

from perfbench import trace


class Ev:
    """What :func:`perfbench.trace.summarize` reads of a profiler event
    (times in microseconds here, nanoseconds as the profiler gives them)."""

    def __init__(self, kind, name, t0, dur, corr=0, linked=0, tid=1):
        self.kind, self._name, self.corr, self.linked = kind, name, corr, linked
        self.t0, self.dur, self.tid = t0, dur, tid

    def device_type(self):
        return (DeviceType.CUDA if self.kind in DEVICE else DeviceType.CPU)

    def name(self):
        return self._name

    def start_ns(self):
        return int(self.t0 * 1000)

    def duration_ns(self):
        return int(self.dur * 1000)

    def start_thread_id(self):
        return self.tid

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def is_user_annotation(self):
        return "user_annotation" in self.kind


DEVICE = ("kernel", "gpu_memcpy", "gpu_user_annotation")


def events():
    # correlation ids: host ops and ranges count from 1, runtime calls and
    # the device operations they launch share theirs (from 900); an
    # overhead record may carry its op's id
    return [
        Ev("user_annotation", "perfbench.window", 0, 1000, corr=1),
        Ev("user_annotation", "perfbench.step", 0, 380, corr=2),
        Ev("user_annotation", "perfbench.encode", 0, 200, corr=3),
        Ev("cpu_op", "aten::mm", 250, 10, corr=4),
        Ev("overhead", "Lazy Function Loading", 251, 1, corr=4),
        Ev("cuda_runtime", "cudaLaunchKernel", 255, 2, corr=900, linked=4),
        Ev("kernel", "mm_kernel", 300, 100, corr=900, linked=4),
        Ev("gpu_user_annotation", "perfbench.step", 300, 100, corr=2),
        Ev("user_annotation", "perfbench.step", 600, 300, corr=5),
        Ev("cpu_op", "aten::copy_", 610, 10, corr=6),
        Ev("cuda_runtime", "cudaMemcpyAsync", 612, 2, corr=901, linked=6),
        Ev("gpu_memcpy", "Memcpy DtoH", 650, 50, corr=901, linked=6),
        Ev("cuda_runtime", "cudaLaunchKernel", 615, 2, corr=902, linked=6),
        Ev("kernel", "overlapping", 680, 40, corr=902, linked=6),
        Ev("cuda_runtime", "cudaDeviceSynchronize", 950, 9, corr=4),
        Ev("kernel", "before the window", -50, 20, corr=903),
    ]


def test_summary_joins_device_ops_to_spans():
    s = trace.summarize(events())
    assert s.window_s == pytest.approx(1e-3)
    assert s.ops == 3 and s.unlinked == 1
    assert s.busy_s == pytest.approx((100 + 70) * 1e-6)
    assert s.by_span["step"] == pytest.approx(190 * 1e-6)
    assert s.by_span["window"] == pytest.approx(190 * 1e-6)
    assert "encode" not in s.by_span
    assert s.span_counts == {"window": 1, "step": 2, "encode": 1}
    assert s.by_name["overlapping"] == pytest.approx(40e-6)
    # idle: [0, 300) from the encode span on, [720, 1000) in the second
    # step, [400, 650) between the steps
    assert [round(g * 1e6) for _, g in s.gaps] == [300, 280, 250]
    assert [n for n, _ in s.gaps] == ["encode", "step", "harness"]


def test_no_window_or_no_device_op_reads_nothing():
    assert trace.summarize(events()[1:]) is None
    assert trace.summarize([e for e in events()
                            if e.kind not in DEVICE]) is None
