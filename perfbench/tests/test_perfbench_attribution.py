"""Exclusive attribution on a synthetic Chrome trace: nested program ranges
on two threads, each kernel charged once to the innermost range open on its
launching thread (else the step range, else ``unranged``), the charges
adding up to the busy time, idle gaps split across the host's innermost
range; and the ranges-only window's readers, which read nothing where
their ranges are missing."""
from types import SimpleNamespace

import pytest

from perfbench import attribution, cells


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _ua(name, a, b, tid=1):
    return _ev("user_annotation", name, a, b - a, tid)


def _launch(ts, corr, tid=1):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 2, tid, corr)


def _kernel(name, a, b, corr=None):
    return _ev("kernel", name, a, b - a, tid=7, corr=corr)


EVENTS = [
    # main thread: the step, a forward range, the loss
    _ua("train_step.grads", 0, 1000), _ua("attn", 10, 100),
    _ua("lm_loss", 100, 150),
    # autograd's thread: a backward range holding the recomputation
    _ua("moe.bwd", 200, 400, tid=2), _ua("attn", 220, 260, tid=2),
    _ua("attn.bwd", 450, 600, tid=2),
    _launch(20, 1), _kernel("k1", 30, 80, 1),                 # attn
    _launch(120, 2), _kernel("k2", 120, 170, 2),              # lm_loss
    _launch(230, 3, tid=2), _kernel("k3", 240, 300, 3),       # attn, recomputed
    _launch(300, 4, tid=2), _kernel("k4", 290, 350, 4),       # moe.bwd, overlaps
    _launch(420, 5, tid=2), _kernel("k5", 420, 440, 5),       # the step's
    _launch(500, 6, tid=2), _kernel("k6", 500, 550, 6),       # attn.bwd
    _launch(1100, 7, tid=3), _kernel("k7", 1100, 1120, 7),    # no range
    _kernel("k8", 1200, 1210),                                # no launch
]

DEVICE_US = {"attn": 110, "attn.bwd": 50, "moe.bwd": 50, "lm_loss": 50,
             "train_step.grads": 20, "unranged": 30}
IDLE_US = {"attn": 40, "lm_loss": 20, "train_step.grads": 460, "moe.bwd": 70,
           "attn.bwd": 100, "unranged": 180}


def test_each_kernel_charged_once_and_gaps_split():
    s = attribution.attribute(EVENTS, events_s=1180e-6)
    assert s["trusted"] and s["busy_s"] == pytest.approx(310e-6)
    got = {n: r["device_s"] * 1e6 for n, r in s["ranges"].items()
           if r["device_s"]}
    assert got == pytest.approx(DEVICE_US)
    assert sum(got.values()) == pytest.approx(s["busy_s"] * 1e6)
    idle = {n: r["idle_s"] * 1e6 for n, r in s["ranges"].items() if r["idle_s"]}
    assert idle == pytest.approx(IDLE_US)
    assert s["ranges"]["attn"]["calls"] == 2
    lines = attribution.table(s, steps=2)
    assert lines[1].split()[0] == "attn" and len(lines) == 1 + len(s["ranges"])


def test_no_device_work_is_untrusted():
    s = attribution.attribute(EVENTS[:6], events_s=None)
    assert s == {"kernels": 0, "trusted": False}


NEW = ["attn_device_ms.train", "moe_device_ms.train",
       "moe_assign_device_ms.train", "loss_device_ms.train",
       "step_idle_ms.train"]


def _run(summary):
    return SimpleNamespace(rec={"ranges": summary} if summary else {})


def test_readers_of_the_ranges_only_window():
    s = dict(attribution.attribute(EVENTS, events_s=1180e-6), steps=2)
    read = {n: cells.metric_reader(n)(_run(s)) for n in NEW}
    assert read["attn_device_ms.train"] == pytest.approx(0.080)
    assert read["loss_device_ms.train"] == pytest.approx(0.025)
    assert read["moe_device_ms.train"] == pytest.approx(0.025)
    assert read["moe_assign_device_ms.train"] is None     # no such range
    assert read["step_idle_ms.train"] == pytest.approx(0.435)


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_the_window_or_its_ranges(name):
    assert cells.metric_reader(name)(_run(None)) is None
    bare = [e for e in EVENTS if e.get("cat") != "user_annotation"]
    s = dict(attribution.attribute(bare, events_s=1180e-6), steps=2)
    got = cells.metric_reader(name)(_run(s))
    assert (got is None) == (name != "step_idle_ms.train")
