"""The traced window: ``torch.profiler`` over a few steps of the measured
window, read back from its Chrome trace.

What it yields, for the metric readers: the device's busy seconds (the
union of every kernel, copy and fill on the device) and the window's
length by CUDA events; the device seconds of the kernels launched inside
each named ``record_function`` range; the kernels that took most time and
the longest idle gaps, named by what the host was doing.

The profiler's device timestamps can come out scaled by a factor that
varies between profiling sessions (the port's ``ROADMAP.md`` C.21).  A
window whose kernels span more than the CUDA events around it, or much
less, is refused, and the caller traces another.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
# the kernels' span over the CUDA events around the window, accepted
SPAN_RATIO = (0.97, 1.01)


class Window:
    """``with Window(device) as w: <steps>``; then ``w.read(ranges)``."""

    def __init__(self, device):
        self.device = device
        self.path: Optional[str] = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._sync()
        if self.device.type == "cuda":
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        return self

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self.ev1.record()
        self._sync()
        self.t_end = time.perf_counter()
        self.prof.__exit__(*exc)
        self.events_s = (self.ev0.elapsed_time(self.ev1) / 1e3
                         if self.device.type == "cuda" else None)
        fd, self.path = tempfile.mkstemp(prefix="perfbench_trace_",
                                         suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        return False

    def read(self, ranges: Sequence[str]) -> Dict:
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        return summarize(events, ranges, self.events_s)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events: List[Dict], ranges: Sequence[str],
              events_s: Optional[float]) -> Dict:
    """The window's numbers from its Chrome trace events (times in us)."""
    dev, host, launches = [], [], {}
    spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in HOST_CATS:
            host.append(e)
            corr = e.get("args", {}).get("correlation")
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = e
            if cat == "user_annotation" and e["name"] in ranges:
                spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    out: Dict = {"kernels": len(dev)}
    if not dev:
        out["trusted"] = False
        return out
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_us = sum(b - a for a, b in busy)
    span_us = busy[-1][1] - busy[0][0]
    window_s = events_s if events_s is not None else span_us / 1e6
    ratio = span_us / 1e6 / window_s
    out.update(busy_s=busy_us / 1e6, window_s=window_s, span_ratio=ratio,
               trusted=SPAN_RATIO[0] <= ratio <= SPAN_RATIO[1])

    # device seconds of the kernels launched while each named range was
    # open, from any thread: autograd launches the backward from its own
    range_s = {}
    for name in ranges:
        iv = sorted(spans.get(name, []))
        starts = [a for a, _ in iv]
        total, calls = 0.0, len(iv)
        for e in dev:
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is None:
                continue
            j = bisect.bisect_right(starts, launch["ts"]) - 1
            if j >= 0 and launch["ts"] <= iv[j][1]:
                total += e["dur"]
        range_s[name] = {"device_s": total / 1e6, "calls": calls}
    out["ranges"] = range_s

    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"][:160]] += e["dur"] / 1e6
    out["device_ops"] = sorted(([k, v] for k, v in by_name.items()),
                               key=lambda kv: -kv[1])[:10]

    gaps = sorted(((b0 - a1, a1) for (_, a1), (b0, _) in zip(busy, busy[1:])
                   if b0 > a1), reverse=True)[:10]
    hs = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host))
    named = []
    for length, at in gaps:
        inner = None
        for a, b, name in hs:
            if a > at:
                break
            if b >= at and (inner is None or b - a < inner[1] - inner[0]):
                inner = (a, b, name)
        named.append([f"host: {inner[2][:120]}" if inner else "host: no op",
                      length / 1e6])
    out["idle_gaps"] = named
    return out
