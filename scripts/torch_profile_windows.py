#!/usr/bin/env python3
"""Repeat the scan path's profiler windows on the card and compare each with
CUDA events over the same calls.

    python3 scripts/torch_profile_windows.py [--reps N] [--tail N] [--out FILE]

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  ``chip_smoke.py`` reads a kernel's device time from
``torch.profiler`` windows of back-to-back calls.  This script repeats, in
one process, what its scan path does (``phase_path_times`` over
``scan_cases``): for each of ``--reps`` rounds, the rwkv6-7b bonus scan and
its plain version, then the zamba2-7b inclusive scan and its plain version,
each as five windows of 20 kernel calls or two of two plain calls; then
``--tail`` more windows of the zamba2 kernel alone.  Every window records
CUDA events around the same calls inside the profiler, and prints one JSON
line: the device time a call as ``chip_smoke.py`` computes it (each
kernel's mean over the events kept, times its events a call, summed), the
raw sum over every kept event divided by the calls, the events' span
(first start to last end) a call, the CUDA-event time a call, each
kernel's events and mean duration, and the card's SM clock beside it.  A
last ``summary`` line gives, per case, the ratio of device to CUDA-event
time: its median, its least value, and the windows under 0.9.  The lines
also go to ``--out`` (default ``build/profile_windows.jsonl``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    return r.stdout.strip()


def window(fn, n: int) -> dict:
    """One profiler window of ``n`` calls with CUDA events around them."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / n
    kernels, first, last = {}, None, None
    for ev in prof.events():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith("Activity Buffer")):
            continue
        us = ev.time_range.elapsed_us()
        if us <= 0:
            continue
        row = kernels.setdefault(ev.key[:70], {"events": 0, "ms": 0.0,
                                               "min_us": us, "max_us": us})
        row["events"] += 1
        row["ms"] += us / 1e3
        row["min_us"], row["max_us"] = min(row["min_us"], us), max(row["max_us"], us)
        first = ev.time_range.start if first is None else min(first, ev.time_range.start)
        last = ev.time_range.end if last is None else max(last, ev.time_range.end)
    # chip_smoke.py's reading: mean over the kept events times events a call
    smoke = sum(r["ms"] / r["events"] * max(1, round(r["events"] / n))
                for r in kernels.values())
    return {"n": n, "event_ms": event_ms, "device_ms": smoke,
            "raw_ms": sum(r["ms"] for r in kernels.values()) / n,
            "span_ms": ((last - first) / 1e3 / n) if kernels else 0.0,
            "ratio": smoke / event_ms if event_ms else 0.0,
            "kernels": {k: {"events": r["events"], "mean_us": r["ms"] * 1e3 / r["events"],
                            "min_us": r["min_us"], "max_us": r["max_us"]}
                        for k, r in kernels.items()},
            "sm_clock": _smi("clocks.sm")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--tail", type=int, default=30)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_windows.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_windows: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import checks, ops, ref
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def emit(row):
        print(json.dumps(row), flush=True)
        lines.append(row)

    emit({"card": _smi("name,power.limit"), "torch": torch.__version__})
    cases = []
    for label, cfg in (("rwkv6-7b bonus", checks.RWKV6_7B_SCAN),
                       ("zamba2-7b inclusive", checks.ZAMBA2_7B_SCAN)):
        q, k, v, w, u = checks.full_width_scan("cuda", cfg)
        mode, chunk = cfg["mode"], cfg["chunk"]
        cases.append((label,
                      lambda q=q, k=k, v=v, w=w, u=u, m=mode, c=chunk:
                          ops.decay_scan(q, k, v, w, u=u, chunk=c, diag_mode=m),
                      lambda q=q, k=k, v=v, w=w, u=u, m=mode:
                          ref.ssm_scan_ref(q, k, v, w, u=u, diag_mode=m)))
    for rep in range(args.reps):
        for label, kernel, plain in cases:
            for what, fn, n, count in (("kernel", kernel, 20, 5), ("plain", plain, 2, 2)):
                fn()
                for i in range(count):
                    emit({"case": label, "what": what, "rep": rep, "window": i,
                          **window(fn, n)})
    label, kernel, _ = cases[1]
    for i in range(args.tail):
        emit({"case": label, "what": "kernel", "rep": "tail", "window": i,
              **window(kernel, 20)})
    summary = {}
    for label, _, _ in cases:
        ratios = [r["ratio"] for r in lines
                  if r.get("case") == label and r.get("what") == "kernel"]
        summary[label] = {"windows": len(ratios),
                          "median_ratio": statistics.median(ratios),
                          "least_ratio": min(ratios),
                          "under_0.9": [(r["rep"], r["window"], round(r["ratio"], 4))
                                        for r in lines
                                        if r.get("case") == label
                                        and r.get("what") == "kernel"
                                        and r["ratio"] < 0.9]}
    emit({"summary": summary})
    out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
