"""The trace reader on a synthetic Chrome trace: busy time as the union of
device events, kernels charged to the range open when they were launched
(from any thread), the window refused when its kernels span more or much
less than the CUDA events around it allow."""
import pytest

from perfbench import trace


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


EVENTS = [
    _ev("user_annotation", "rangeA", 0, 50),
    _ev("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 20, 2, tid=2, corr=2),  # autograd's
    _ev("cpu_op", "aten::item", 60, 30),
    _ev("cuda_runtime", "cudaLaunchKernel", 95, 2, corr=3),
    _ev("kernel", "k1", 100, 100, tid=7, corr=1),
    _ev("kernel", "k2", 150, 100, tid=7, corr=2),      # overlaps k1
    _ev("kernel", "k3", 400, 100, tid=7, corr=3),
]


def test_busy_ranges_and_gaps():
    s = trace.summarize(EVENTS, ["rangeA"], events_s=400e-6)
    assert s["busy_s"] == pytest.approx(250e-6)          # [100,250] + [400,500]
    assert s["span_ratio"] == pytest.approx(1.0) and s["trusted"]
    assert s["ranges"]["rangeA"] == {"device_s": pytest.approx(200e-6), "calls": 1}
    assert s["device_ops"][0][0] in ("k1", "k2", "k3")
    assert s["idle_gaps"][0][1] == pytest.approx(150e-6)


def test_scaled_window_is_refused():
    assert not trace.summarize(EVENTS, [], events_s=350e-6)["trusted"]   # 1.14x
    assert not trace.summarize(EVENTS, [], events_s=500e-6)["trusted"]   # 0.8x


def test_no_device_events():
    assert trace.summarize(EVENTS[:5], [], events_s=None)["trusted"] is False
