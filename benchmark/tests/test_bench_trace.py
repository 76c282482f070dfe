"""The reduction of a trace on a small synthetic one: the interval union,
the idle share, ranges and kernels by name, the breakdown, and the
roofline arithmetic of the suppression kernel."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import peaks
from benchmark.harness.cell import BENCH_DIR, load_module
from benchmark.harness.trace import WINDOW, TraceSummary, union_us


def ev(name, start, end, device="CPU", annotation=False):
    return SimpleNamespace(name=name, device_type=SimpleNamespace(name=device),
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def avg(key, device, count, device_us=0.0, cpu_us=0.0, self_device_us=0.0):
    return SimpleNamespace(key=key, device_type=SimpleNamespace(name=device),
                           count=count, device_time_total=device_us,
                           self_device_time_total=self_device_us,
                           cpu_time_total=cpu_us)


class FakeProf:
    """A window of 1000 us; `forward` on the host from 100 to 500 us; on
    the device two overlapping kernels (200-400, 300-450), a copy
    (600-700), a kernel partly outside the window (950-1100) and the GPU
    side of the `forward` range, which is no device work."""

    def events(self):
        return [ev(WINDOW, 0, 1000, annotation=True),
                ev("forward", 100, 500, annotation=True),
                ev("conv_kernel", 200, 400, "CUDA"),
                ev("nms_suppress_kernel", 300, 450, "CUDA"),
                ev("Memcpy HtoD", 600, 700, "CUDA"),
                ev("late_kernel", 950, 1100, "CUDA"),
                ev("forward", 100, 500, "CUDA", annotation=True)]

    def key_averages(self):
        return [avg("forward", "CPU", 2, device_us=350.0, cpu_us=400.0),
                avg(WINDOW, "CPU", 1, cpu_us=1000.0),
                avg("nms_suppress_kernel", "CUDA", 3, self_device_us=150.0),
                avg("conv_kernel", "CUDA", 1, self_device_us=200.0)]


def test_union():
    assert union_us([(5, 7), (0, 2), (1, 3), (3, 4), (6, 9)]) == [(0, 4), (5, 9)]


def test_summary():
    s = TraceSummary(FakeProf())
    assert s.window_s == pytest.approx(1e-3)
    # 200-450, 600-700 and 950-1000 inside the window: 400 us busy
    assert s.busy_s == pytest.approx(400e-6)
    assert s.range("forward") == {"device_ms": 0.35, "host_ms": 0.4, "count": 2}
    assert s.range("missing") is None
    assert s.kernel("nms_suppress") == {"device_ms": 0.15, "count": 3}
    b = s.breakdown()
    assert b["device_ops"][0] == ["conv_kernel", pytest.approx(200e-6)]
    gaps = dict(b["idle_gaps"])
    # idle 0-200 (mid 100: forward), 450-600 (mid 525: the window only),
    # 700-950 (the window only)
    assert gaps["forward"] == pytest.approx(200e-6)
    assert gaps[WINDOW] == pytest.approx(400e-6)


def read(name, run):
    return load_module(f"{BENCH_DIR}/metrics/{name}.py", f"m_{name.replace('.', '_')}").read(run)


def test_idle_share_and_roofline():
    s = TraceSummary(FakeProf())
    run = SimpleNamespace(trace=s, window_s=s.window_s, busy_s=s.busy_s, frames=16,
                          batches=2, timers={"detect": 0.0006}, counters={},
                          flops_per_frame=1e9, nms_bound_s=3e-6, nms_launches=3,
                          peaks=peaks)
    assert read("device_idle_share.serve", run) == pytest.approx(60.0)
    assert read("nms_roofline", run) == pytest.approx(100 * 3e-6 / 150e-6)
    assert read("forward_ms", run) == pytest.approx(0.175)
    assert read("upload_ms", run) is None
    assert read("pipeline_host_ms", run) == pytest.approx(1e3 * 0.0004 / 16)
    assert read("mfu.serve", run) == pytest.approx(100 * 16e9 / (1e-3 * 989e12))
    run.nms_launches = 2  # a launch the trace lacks: no reading, not a wrong one
    assert read("nms_roofline", run) is None


def test_suppress_bound_is_chip_smokes_rule():
    """The frozen bound equals chip_smoke.py's on random kept sets."""
    chip_smoke = pytest.importorskip("chip_smoke")
    g = torch.Generator().manual_seed(3)
    for b, k in ((8, 256), (64, 256), (8, 64), (1, 33)):
        keep = torch.rand(b, k, generator=g) < 0.1
        tail = int((keep * (k - 1 - torch.arange(k))).sum())
        ms, nbytes, elems = chip_smoke.suppress_bound(keep)
        assert elems == tail
        assert 1e3 * peaks.suppress_bound_s(b, k, tail) == pytest.approx(ms)
