"""``chip_smoke.py``'s profiler-window check on the CPU (ROADMAP.md C.21).

``_window_trusted`` is a plain function of numbers: it accepts a window
whose device time agrees with CUDA events and refuses the window C.21 found
(0.599 ms of device a call against 1.268 ms of CUDA events, a device-bound
scan).  ``_profile_windows`` is driven with a stand-in profiler: a refused
window is retried, a trusted one is kept, and five refused windows fail the
phase, so no untrusted reading gets through.
"""
import contextlib
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the zamba2-7b scan's host cost a call: three launches, two allocations and
# u's fill, tens of microseconds (chip_smoke.py's host cost phase reads ~27 us
# for one wrapper call of one launch)
SCAN_HOST_MS = 0.05


def test_accepts_a_full_window(smoke):
    # the zamba2-7b scan read whole: 1.258 ms of device against 1.268 of CUDA
    # events (PERF.md §6)
    assert smoke._window_trusted(1.258, 1.30, 1.268, SCAN_HOST_MS) is None
    # device time equal to the window's own events, to the clocks' rounding
    assert smoke._window_trusted(1.3, 1.3, 1.268, SCAN_HOST_MS) is None


def test_refuses_the_short_scan_window(smoke):
    why = smoke._window_trusted(0.599, 1.27, 1.268, SCAN_HOST_MS)
    assert why is not None and "device-bound" in why


def test_refuses_device_time_over_the_events(smoke):
    why = smoke._window_trusted(1.40, 1.30, 1.268, SCAN_HOST_MS)
    assert why is not None and "exceeds" in why


def test_a_host_bound_call_is_held_only_by_its_events(smoke):
    # a serve step: 29.9 ms of wall, the host's 28 ms of enqueue, 3.7 ms of
    # device (PERF.md §5): busy 12%, not short
    assert smoke._window_trusted(3.7, 29.9, 29.9, 28.0) is None
    assert smoke._window_trusted(31.0, 29.9, 29.9, 28.0) is not None


def test_the_margin(smoke):
    call, host = 2.0, 0.1                 # device-bound: 20x its host cost
    floor = (call - host) * (1 - smoke.WINDOW_MARGIN)
    assert smoke._window_trusted(floor * 1.001, 2.1, call, host) is None
    assert smoke._window_trusted(floor * 0.999, 2.1, call, host) is not None


class _Event:
    """A CUDA event whose window reads ``ms`` a call over ``n`` calls."""
    ms = 0.0
    n = 1

    def __init__(self, enable_timing=True):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return _Event.ms * _Event.n


@pytest.fixture
def stand_in(smoke, monkeypatch):
    """Windows read from a script of per-call device times."""
    import torch.profiler
    script = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(smoke, "_call_and_host_ms", lambda fn, n: (1.268, 0.05))

    def events(prof, counts=None):
        per_call = script.pop(0)
        counts.update({"chunk_out": _Event.n})
        return {"chunk_out": per_call * _Event.n}
    monkeypatch.setattr(smoke, "_device_events", events)
    return script


def test_a_refused_window_is_retried(smoke, stand_in):
    _Event.ms, _Event.n = 1.30, 20
    stand_in.extend([0.599, 1.258, 1.259])
    w = smoke._profile_windows(lambda: None, iters=20)
    assert w["device_ms"] == pytest.approx(1.258)
    assert len(w["refused"]) == 1 and stand_in == [1.259]


def test_five_refused_windows_fail_the_phase(smoke, stand_in):
    _Event.ms, _Event.n = 1.30, 20
    stand_in.extend([0.599] * 5)
    with pytest.raises(smoke.PhaseFailed, match="0 trusted"):
        smoke._profile_windows(lambda: None, iters=20)
