"""Exclusive attribution of a traced window to the program's ranges, read
from a session that records only those ranges (the ranges-only window).

Beside ``trace.summarize``, which charges a kernel to every named range
open when it was launched, this charges each stretch of device time once:

- device time: each kernel, copy and fill goes to the innermost program
  range open on the thread that launched it, when it was launched; where
  that thread has none open (autograd's thread between two ``.bwd``
  ranges), to the step range open then (``train_step.grads``,
  ``train_step.optimizer``); else to ``unranged``.  Where device work
  overlaps, only the part no earlier event covered is charged, so the
  charges add up to the device's busy time.
- idle time: each stretch in which no device work runs goes to the most
  recently opened program range still open on any thread while it lasts
  (the host's innermost work then), else to ``unranged``.

``RangesWindow`` is the session: ``torch.profiler``'s CPU activity
limited to the ``USER_SCOPE`` (``record_function`` ranges), with the CUDA
activity (the runtime's launches with their correlation ids and the
device's work), on one clock.  It records none of the operators that a
default session records on every thread, so the steps it traces keep
their pace.  Like ``trace.Window`` it reads the window's length by CUDA
events around it and trusts it only where its device work spans 0.97-1.01
of them (C.21).
"""
from __future__ import annotations

import bisect
import heapq
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from perfbench import trace

STEP_RANGES = ("train_step.grads", "train_step.optimizer")
UNRANGED = "unranged"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

Interval = Tuple[float, float, str]          # (start us, end us, name)


def _segments(ranges: Sequence[Interval]
              ) -> Tuple[List[float], List[Optional[str]]]:
    """The innermost open range as a step function of time: (boundaries,
    name from each boundary to the next, None where none is open).  The
    innermost is the most recently opened range still open."""
    points = sorted({t for a, b, _ in ranges for t in (a, b)})
    if not points:
        return [], []
    opens = defaultdict(list)
    for a, b, name in ranges:
        opens[a].append((a, b, name))
    # the latest start on top; of two with one start, the one ending first
    heap: List[Tuple[float, float, str]] = []          # (-start, end, name)
    names: List[Optional[str]] = []
    for t in points:
        for a, b, name in opens.get(t, ()):
            heapq.heappush(heap, (-a, b, name))
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        # a range that ended is dropped once it reaches the top; one under
        # a still-open range can only be reached after that range ends
        names.append(heap[0][2] if heap else None)
    return points, names


def _at(seg: Tuple[List[float], List[Optional[str]]], t: float) -> Optional[str]:
    points, names = seg
    j = bisect.bisect_right(points, t) - 1
    return names[j] if j >= 0 else None


def attribute(events: List[Dict], events_s: Optional[float],
              step_ranges: Sequence[str] = STEP_RANGES) -> Dict:
    """Device and idle seconds of each program range (``user_annotation``
    events) and of ``unranged``, from a Chrome trace's events."""
    dev, launches = [], {}
    by_tid: Dict[object, List[Interval]] = defaultdict(list)
    steps: List[Interval] = []
    calls: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in trace.DEVICE_CATS:
            dev.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat == "user_annotation":
            iv = (e["ts"], e["ts"] + e["dur"], e["name"])
            by_tid[e["tid"]].append(iv)
            calls[e["name"]] += 1
            if e["name"] in step_ranges:
                steps.append(iv)
    out: Dict = {"kernels": len(dev)}
    if not dev:
        out["trusted"] = False
        return out
    thread_seg = {tid: _segments(iv) for tid, iv in by_tid.items()}
    step_seg = _segments(steps)
    host_seg = _segments([iv for ivs in by_tid.values() for iv in ivs])

    device_us: Dict[str, float] = defaultdict(float)
    busy: List[Tuple[float, float]] = []
    covered = -float("inf")
    for e in sorted(dev, key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        launch = launches.get(e.get("args", {}).get("correlation"))
        name = None
        if launch is not None:
            name = (_at(thread_seg.get(launch["tid"], ([], [])), launch["ts"])
                    or _at(step_seg, launch["ts"]))
        charged = b - max(a, covered)
        if charged > 0:
            device_us[name or UNRANGED] += charged
        if busy and a <= busy[-1][1]:
            busy[-1] = (busy[-1][0], max(busy[-1][1], b))
        else:
            busy.append((a, b))
        covered = max(covered, b)

    idle_us: Dict[str, float] = defaultdict(float)
    points, names = host_seg
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        # the gap [g0, g1) cut at the boundaries of the innermost range
        t = g0
        j = bisect.bisect_right(points, t) - 1
        while t < g1:
            nxt = points[j + 1] if j + 1 < len(points) else g1
            end = min(g1, nxt)
            name = names[j] if j >= 0 else None
            idle_us[name or UNRANGED] += end - t
            t, j = end, j + 1

    busy_us = sum(b - a for a, b in busy)
    span_us = busy[-1][1] - busy[0][0]
    window_s = events_s if events_s is not None else span_us / 1e6
    ratio = span_us / 1e6 / window_s
    out.update(busy_s=busy_us / 1e6, window_s=window_s, span_ratio=ratio,
               trusted=trace.SPAN_RATIO[0] <= ratio <= trace.SPAN_RATIO[1])
    out["ranges"] = {
        name: {"device_s": device_us.get(name, 0.0) / 1e6,
               "idle_s": idle_us.get(name, 0.0) / 1e6,
               "calls": calls.get(name, 0)}
        for name in sorted(set(device_us) | set(idle_us) | set(calls))}
    return out


def table(summary: Dict, steps: int) -> List[str]:
    """Lines of range, device ms a step and idle ms a step, by device
    time."""
    rows = sorted(summary.get("ranges", {}).items(),
                  key=lambda kv: -kv[1]["device_s"])
    lines = [f"{'range':<24} {'device ms/step':>14} {'idle ms/step':>12} "
             f"{'calls':>6}"]
    for name, r in rows:
        lines.append(f"{name:<24} {r['device_s'] / steps * 1e3:>14.3f} "
                     f"{r['idle_s'] / steps * 1e3:>12.3f} {r['calls']:>6}")
    return lines


class RangesWindow:
    """``with RangesWindow(device) as w: <steps>``; then ``w.read()``."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.path: Optional[str] = None

    def __enter__(self):
        # the session is the harness's own, as ``obs.ranges.profile`` sets
        # it up in the program: the yardstick does not move with the program
        # and runs where the program has no such session
        from torch._C._profiler import ProfilerActivity, RecordScope
        self.acts = {ProfilerActivity.CPU}
        if self.cuda:
            self.acts.add(ProfilerActivity.CUDA)
        cfg = torch.autograd.profiler.profile(
            use_device="cuda" if self.cuda else None).config
        torch._C._autograd._prepare_profiler(cfg(create_trace_id=True),
                                             self.acts)
        self._sync()
        torch._C._autograd._enable_profiler(cfg(), self.acts,
                                            {RecordScope.USER_SCOPE})
        if self.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter()
        return self

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc):
        if self.cuda:
            self.ev1.record()
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        result = torch._C._autograd._disable_profiler()
        self.events_s = (self.ev0.elapsed_time(self.ev1) / 1e3
                         if self.cuda else None)
        fd, self.path = tempfile.mkstemp(prefix="perfbench_ranges_",
                                         suffix=".json")
        os.close(fd)
        result.save(self.path)
        return False

    def events(self) -> List[Dict]:
        try:
            with open(self.path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)

    def read(self) -> Dict:
        out = attribute(self.events(), self.events_s)
        out["wall_s"] = self.wall_s
        return out


def device_ms(run, names: Sequence[str]) -> Optional[float]:
    """Exclusive device ms a step of the ranges ``names`` in the run's
    ranges-only window (``run.rec["ranges"]``, its ``steps`` traced); None
    where the window or every one of the ranges is missing."""
    r = run.rec.get("ranges") or {}
    got = [r["ranges"][n]["device_s"] for n in names
           if n in r.get("ranges", {})]
    if not got or not r.get("steps") or sum(got) <= 0:
        return None
    return sum(got) / r["steps"] * 1e3
