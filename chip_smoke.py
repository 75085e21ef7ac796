#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card: build, check, time.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  Phases:

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   CUDA kernel of the port from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together);
   and, where the toolkit has ``cuobjdump``, counts the tensor-core
   instructions (HMMA, HGMMA) in the attention kernel's SASS;
2. holds each kernel against its plain PyTorch version on the card at every
   case of ``tests/test_kernels.py``'s ``TestBankedMatmul``,
   ``TestFlashAttention``, ``TestDecayScan`` and ``TestBankedConv2d``, the
   shapes of ``benchmarks/kernel_bench.py``, every matmul of the main path
   and the boundaries of the kernels' own variants (the tables of
   ``repro_torch.kernels.checks``, which the card tests share); then calls
   each redesigned kernel twice on the same inputs (the CNN's product, a
   split-K product, full-width attention in f32 and bf16, both full-width
   scans, the paper's conv) and requires the same bits;
3. drives the main path, the paper's flow: compiles the paper's FFNN, MHA
   and CNN at full width with the port, runs each design on the card through
   the banked-kernel backend (``execute_graph_cuda``) and checks it against
   the torch oracle on the card and the affine interpreter (``d.run``); the
   launch counts are zeroed just before and read just after, and must equal
   the graphs' matmul counts; the products must be the 17 of
   ``checks.MAIN_PATH_MATMULS``, each planned for the skinny variant; the
   designs that conflict on banks must still raise ``BankConflictError``;
4. drives the kernels' own entry points, ``ops.attention``,
   ``ops.decay_scan`` and ``ops.conv2d``, at full width, each path with
   every launch count zeroed just before and read just after: attention at
   qwen2-0.5b's heads (14 q, 2 kv, head dim 64) over 4096 tokens, causal
   and not, f32 and bf16; the RWKV6 bonus scan at rwkv6-7b's (64 heads of
   64) and the Mamba2 inclusive scan at zamba2-7b's (112 heads of 64,
   state 64), 4096 tokens at chunk 64 (each call three launches of the
   scan's kernels, counted as one); the conv of the paper's CNN as the
   port compiles it, at banks (1,1), (2,2) and (4,2); each output is held
   against the plain version (and the conv against the torch oracle);
5. at each path's own shapes, holds each kernel against its plain version
   and times kernel, plain version and the library yardstick, which the
   port never calls (``torch.matmul``, ``scaled_dot_product_attention``
   with GQA and with k, v repeated, the faster reported and each with the
   backend its kernels show, ``F.conv2d``; no single call computes the
   scan): each call with CUDA events over back-to-back calls, and its
   device time alone with ``torch.profiler``;
6. times each design's banked-backend run on the host clock and takes its
   device time by kernel from ``torch.profiler``;
7. times the host's share of one wrapper call (``ops.matmul`` at a main-path
   shape, ``ops.attention`` at a small one): enqueue time over many calls,
   and the ten costliest functions of a ``cProfile`` of them;
8. the dense decode and serving path (``repro_torch.models``,
   ``repro_torch.launch.serve``), at qwen2-0.5b's full width with its
   weights drawn once from a numpy seed (the reference's draw): ``decode vs
   forward`` feeds 16 tokens of 2 sequences teacher-forced through
   ``serve_step`` in float32 without TF32 and holds every position's logits
   against the port's ``forward`` on the card at 2e-2
   (``tests/test_decode_consistency.py``), and the first 4 steps against the
   same steps on the CPU at 2e-2; ``serve`` runs ``Engine`` on the bf16
   config (4 slots, 8 requests of prompt 8 and gen 16 on a seeded arrival
   trace) with a ``MetricsRegistry`` and a ``SpanTracer``: every request
   finishes, every logit is finite, the spans validate, and one JSON
   ``serve`` line gives tokens/s, steps, step wall and device time, the
   device's busy share, memory and the card; the same requests with a
   ``LayerProfiler`` give per-operator times and a join that closes;
   ``serve chaos`` runs the reduced bf16 config twice under one seeded
   ``FaultPlan`` with resilience on: no request is lost and the two
   ``--stable`` span streams are byte-identical.  This path launches none
   of the four kernels (the reference's serving path runs no Pallas kernel).

Prints one JSON ``kernels`` line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a card, outside a checkout of
the repository, or when any phase fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DESIGN_TOL = 1e-4            # tests/test_core_sim.py: design vs oracle

# the main path: (model, input shape, factors that compile, factors that
# must raise BankConflictError)
DESIGNS = [("paper_ffnn", (1, 64), (1, 2, 4), ()),
           ("paper_mha", (8, 42), (1, 2), (4,)),
           ("paper_cnn", (3, 80, 60), (1,), (2, 4))]

# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, bf16 on
# the tensor cores, and the HBM3 rate
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12

KERNEL_SOURCES = ["banked_matmul", "banked_conv2d", "flash_attention", "ssm_scan"]

CONV_BANKS = [(1, 1), (2, 2), (4, 2)]      # as tests/test_kernels.py


class PhaseFailed(Exception):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def _excess(got: torch.Tensor, want: torch.Tensor, rtol: float,
            atol: Optional[float] = None):
    """(max |got - want|, max of |got - want| - (atol + rtol * |want|));
    ``atol`` defaults to ``rtol``."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    atol = rtol if atol is None else atol
    return float(diff.max()), float((diff - atol - rtol * w.abs()).max())


def _time_ms(fn, reps: int = 7, iters: int = 50, warm: bool = True) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _device_events(prof, counts: Optional[dict] = None) -> dict:
    """{name: ms} of the device-side events (kernels, copies) of a profile;
    ``counts``, if given, receives {name: events}.

    A host op's own device time repeats its kernels', so host ops are left
    out; CUPTI's buffer requests are the profiler's, not the program's.
    Events are read one by one, and only those with a duration are counted:
    from the per-name totals and counts of ``key_averages`` one window of
    twenty ``F.conv2d`` calls read half the time the other windows read.
    """
    device = {}
    for ev in prof.events():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith("Activity Buffer")):
            continue
        us = ev.time_range.elapsed_us()
        if us > 0:
            device[ev.key] = device.get(ev.key, 0.0) + us / 1e3
            if counts is not None:
                counts[ev.key] = counts.get(ev.key, 0) + 1
    return device


def _device_profile(fn, iters: int = 20):
    """(mean device time of one call, {device kernel: mean ms a call},
    costliest first): the kernels and copies on the card, from
    ``torch.profiler``.  At the main path's shapes a call is far shorter
    than its launch from Python, which CUDA events also count.

    The profiler may drop a window's events (it kept 19 of 20 calls' tiny
    kernels in most windows of one run, none of two calls' in another, and
    none of one plain scan call's first fill), so a window is at least two
    calls, a kernel's time a call is its mean over the events kept, times
    its events a call, and a window counts only when it holds every kernel
    any window of the same calls held: two windows that kept events at
    least, more when they differ, five windows at most, and then the call
    fails.  An empty window is the profiler's (the first of a process often
    is), not the call's."""
    from torch.profiler import ProfilerActivity, profile

    def window(n: int):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        counts = {}
        return _device_events(prof, counts), counts

    fn()
    n = max(2, iters)
    windows, seen, full = [], set(), []
    for _ in range(5):
        events, counts = window(n)
        if not events:
            continue
        windows.append((events, counts))
        seen |= set(events)
        full = [w for w in windows if set(w[0]) == seen]
        if len(windows) >= 2 and full:
            break
    _check(len(windows) >= 2 and bool(full),
           f"five profiler windows of {n} calls: {len(windows)} kept events, "
           f"none of them every kernel of {sorted(seen)}")
    events, counts = full[-1]
    by_kernel = {k: ms / counts[k] * max(1, round(counts[k] / n))
                 for k, ms in sorted(events.items(), key=lambda kv: -kv[1])}
    return sum(by_kernel.values()), by_kernel


def _device_ms(fn, iters: int = 20) -> float:
    return _device_profile(fn, iters)[0]


def _times(fn) -> dict:
    """Call time (CUDA events), device time and device kernels (profiler)
    of ``fn``, with as many calls as fit in about 0.2 s (one call at
    least): the plain scan's loop over 4096 steps takes a good part of a
    second."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    iters = max(1, min(50, int(0.2 / max(one, 1e-6))))
    reps = 7 if iters > 1 else 3
    device_ms, by_kernel = _device_profile(fn, max(1, min(20, iters)))
    return {"ms": _time_ms(fn, reps, iters, warm=False), "device_ms": device_ms,
            "kernels": {n[:100]: ms for n, ms in list(by_kernel.items())[:3]}}


def _bound(m: int, k: int, n: int, dtype, out_dtype):
    """(flops, bytes) one product needs: each input read once, C written once."""
    flops = 2 * m * n * k
    nbytes = ((m * k + k * n) * torch.empty((), dtype=dtype).element_size()
              + m * n * torch.empty((), dtype=out_dtype).element_size())
    return flops, nbytes


def _card_name_and_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, as it prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


def phase_card_and_build(build):
    for line in _card_name_and_limit().splitlines():
        print(line.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    secs = build.build(KERNEL_SOURCES)
    print(f"build: {secs:.1f}s")
    for name, text in build.log.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill",
                                       "error")):
                print(f"  {name}: {line.strip()}")
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    if not cuobjdump.is_file():
        print("SASS: no cuobjdump in the toolkit; tensor-core use not shown")
        return
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.lib_path("flash_attention"))],
                          capture_output=True, text=True, timeout=120).stdout
    counts = {op: sum(f" {op}" in line for line in sass.splitlines())
              for op in ("HMMA", "HGMMA")}
    print(f"SASS flash_attention: {counts['HMMA']} HMMA, {counts['HGMMA']} HGMMA "
          f"instructions")
    _check(counts["HMMA"] + counts["HGMMA"] > 0,
           "flash_attention's SASS holds no tensor-core instruction")


def phase_main_path(frontend, pipeline, cuda_backend, banked, checks,
                    BankConflictError):
    """Returns the main path's matmuls {(m, k, n, factor, b_is_view): count},
    its launch count and the designs it ran [(label, design, inputs)]."""
    rng = np.random.default_rng(0)
    designs = []
    for name, shape, factors, conflicts in DESIGNS:
        for f in conflicts:
            try:
                pipeline.compile_model(getattr(frontend, name)(), [shape], factor=f)
            except BankConflictError as e:
                print(f"{name} f{f}: BankConflictError as expected ({e})"[:160])
            else:
                raise PhaseFailed(f"{name} f{f} compiled; expected BankConflictError")
        x = rng.normal(size=shape).astype(np.float32)
        designs += [(name, shape, f, x) for f in factors]

    shapes, ran = {}, []
    banked.launches = 0                       # zeroed just before the path
    expected = 0
    for name, shape, f, x in designs:
        t0 = time.perf_counter()
        d = pipeline.compile_model(getattr(frontend, name)(), [shape], factor=f)
        t_compile = time.perf_counter() - t0
        producers = {op.name: op for op in d.graph.ops}
        n_mm = 0
        for op in d.graph.ops:
            if op.kind == "matmul":
                n_mm += 1
                (m, k), n = producers[op.inputs[0]].shape, producers[op.inputs[1]].shape[1]
                view = producers[op.inputs[1]].kind == "transpose"
                key = (m, k, n, f, view)
                shapes[key] = shapes.get(key, 0) + 1
        before = banked.launches
        hw = cuda_backend.execute_graph_cuda(d.graph, {"arg0": x}, d.spec)
        launched = banked.launches - before
        oracle = d.run_oracle({"arg0": x})
        t0 = time.perf_counter()
        interp = d.run({"arg0": x})
        t_run = time.perf_counter() - t0
        expected += n_mm
        _check(launched == n_mm, f"{name} f{f}: {launched} kernel launches for "
                                 f"{n_mm} matmul ops")
        errs = []
        for h, o, r, out in zip(hw, oracle, interp, d.graph.outputs):
            want = tuple(producers[out].shape)
            _check(h.shape == want == o.shape == r.shape,
                   f"{name} f{f}: output shapes {h.shape} {o.shape} {r.shape}, "
                   f"expected {want}")
            _check(bool(np.isfinite(h).all()), f"{name} f{f}: non-finite output")
            for label, p, q in (("cuda-oracle", h, o), ("cuda-interp", h, r),
                                ("oracle-interp", o, r)):
                bad = np.abs(p - q) - DESIGN_TOL - DESIGN_TOL * np.abs(q)
                errs.append(float(np.abs(p - q).max()))
                _check(bool((bad <= 0).all()),
                       f"{name} f{f}: {label} max |diff| {errs[-1]:.3g} "
                       f"beyond {DESIGN_TOL}")
        line = (f"{name} f{f}: cycles {d.estimate.cycles} matmuls {n_mm} "
                f"launches {launched} max|diff| {max(errs):.3g} "
                f"compile {t_compile:.2f}s run {t_run:.2f}s")
        if name == "paper_ffnn" and f == 4:
            _, stats = d.simulate({"arg0": x})
            _check(stats.cycles == d.estimate.cycles,
                   f"simulate cycles {stats.cycles} != estimate "
                   f"{d.estimate.cycles}")
            line += f" sim cycles {stats.cycles} == estimate"
        print(line)
        ran.append((f"{name} f{f}", d, {"arg0": x}))
    total = banked.launches                   # read just after the path
    _check(total == expected, f"main path: {total} launches, {expected} matmuls")
    _check(total > 0, "main path launched banked_matmul no time")
    _check(sorted(shapes) == sorted(checks.MAIN_PATH_MATMULS),
           f"main path's matmuls {sorted(shapes)} are not checks.MAIN_PATH_MATMULS")
    for m, k, n, f, _ in shapes:
        _check(banked.plan(m, n, k, banked.derive_block(m, n, k, (f, f, f))).skinny,
               f"{m}x{k}x{n} f{f}: not planned for the skinny variant")
    print(f"main path: banked_matmul launched {total} times, over "
          f"{len(shapes)} distinct products, all of the skinny variant")
    return shapes, total, ran


def phase_profile(cuda_backend, ran):
    """Per design: host wall time of one banked-backend run (inputs and
    weights copied in, outputs copied out), and the device time by kernel
    from ``torch.profiler`` over one more run."""
    from torch.profiler import ProfilerActivity, profile
    rows = {}
    for label, d, x in ran:
        run = lambda: cuda_backend.execute_graph_cuda(d.graph, x, d.spec)  # noqa: E731
        run()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        device = {key[:60]: ms for key, ms in _device_events(prof).items()}
        wall = statistics.median(walls)
        busy = sum(device.values())
        rows[label] = {"wall_ms": wall, "device_ms": busy,
                       "device_busy_share": busy / wall,
                       "device_ms_by_kernel": dict(sorted(
                           device.items(), key=lambda kv: -kv[1])[:6])}
    print(json.dumps({"main_path_profile": rows}))


def phase_times(ops, ref, full_f32, checks, banked, shapes, launches):
    """Kernel vs plain at the main path's shapes, then times; the kernels line."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    rows, flops, nbytes, max_err = [], 0, 0, 0.0
    total = dict.fromkeys(("ms", "plain_ms", "library_ms", "device_ms",
                           "plain_device_ms", "library_device_ms"), 0.0)
    for (m, k, n, f, view), count in sorted(shapes.items()):
        a = torch.tensor(rng.normal(size=(m, k)), dtype=torch.float32, device=dev)
        w = torch.tensor(checks.linear_weight(rng, k, n), device=dev)
        b = w.t().contiguous().t() if view else w      # a transposed view, as kh.t()
        banks = (f, f, f)
        got, want = ops.matmul(a, b, banks=banks), ref.matmul_ref(a, b)
        torch.cuda.synchronize()
        err, excess = _excess(got, want, TOL[torch.float32])
        _check(excess <= 0, f"{m}x{k}x{n} f{f}: max |kernel - plain| {err:.3g}")
        max_err = max(max_err, err)
        kernel = lambda: ops.matmul(a, b, banks=banks)  # noqa: E731
        plain = lambda: ref.matmul_ref(a, b)  # noqa: E731
        with full_f32():
            row = {"ms": _time_ms(kernel), "plain_ms": _time_ms(plain),
                   "library_ms": _time_ms(lambda: torch.matmul(a, b)),
                   "device_ms": _device_ms(kernel),
                   "plain_device_ms": _device_ms(plain),
                   "library_device_ms": _device_ms(lambda: torch.matmul(a, b))}
        for key, t in row.items():
            total[key] += count * t
        fl, by = _bound(m, k, n, torch.float32, torch.float32)
        p = banked.plan(m, n, k, banked.derive_block(m, n, k, banks))
        rows.append({"m": m, "k": k, "n": n, "banks": f, "b_view": view,
                     "count": count, "variant": "skinny" if p.skinny else "tiled",
                     "grid": p.grid, "threads": p.threads, **row,
                     "max_abs_err": err})
        flops, nbytes = flops + count * fl, nbytes + count * by
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"main_path_shapes": rows}))

    large = []
    for s, dtype, out in ((256, torch.float32, torch.float32),
                          (1024, torch.float32, torch.float32),
                          (1024, torch.bfloat16, torch.float32)):
        a = torch.tensor(rng.normal(size=(s, s)), dtype=dtype, device=dev)
        b = torch.tensor(checks.linear_weight(rng, s, s), dtype=dtype, device=dev)
        with full_f32():
            row = {"shape": f"{s}^3", "dtype": str(dtype).replace("torch.", ""),
                   "ms": _time_ms(lambda: ops.matmul(a, b, out_dtype=out)),
                   "plain_ms": _time_ms(lambda: ref.matmul_ref(a, b, out)),
                   "library_ms": _time_ms(lambda: torch.matmul(a, b))}
        fl, by = _bound(s, s, s, dtype, out)
        row["bound_ms"] = max(fl / PEAK_FLOPS[dtype], by / HBM_BYTES_PER_S) * 1e3
        row["tflops"] = fl / row["ms"] / 1e9
        large.append(row)
    print(json.dumps({"large_shapes": large}))

    return {"name": "banked_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/banked_matmul.cu",
            "replaces": "src/repro/kernels/banked_matmul.py:62",
            "launches": launches, "max_abs_err": max_err,
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": total["library_ms"],
            "device_ms": total["device_ms"],
            "plain_device_ms": total["plain_device_ms"],
            "library_device_ms": total["library_device_ms"]}



def _cuda(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """numpy -> float32 on the card -> dtype (both sides see the same values)."""
    return torch.tensor(x, dtype=torch.float32, device="cuda").to(dtype)


def _hold(label: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
          atol: float, worst: dict) -> float:
    """Check ``got`` against ``want`` at ``rtol``, ``atol``; keep the worst."""
    torch.cuda.synchronize()
    _check(got.shape == want.shape and got.dtype == want.dtype,
           f"{label}: got {got.dtype} {tuple(got.shape)}, "
           f"want {want.dtype} {tuple(want.shape)}")
    _check(bool(torch.isfinite(got.float()).all()), f"{label}: not finite")
    err, excess = _excess(got, want, rtol, atol)
    _check(excess <= 0, f"{label}: max |kernel - plain| {err:.3g} beyond "
                        f"rtol {rtol}, atol {atol}")
    worst[label.split(":")[0]] = max(worst.get(label.split(":")[0], 0.0), err)
    return err


def phase_vs_plain(name: str, table) -> None:
    """Every check of ``table`` (``repro_torch.kernels.checks``): the cases of
    tests/test_kernels.py and the shapes of kernel_bench.py, on the card."""
    worst = {}
    cases = table("cuda")
    for c in cases:
        _hold(c.label, c.got(), c.want(), c.rtol, c.atol, worst)
    print(f"{name} vs plain: {len(cases)} cases pass; max |err| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def phase_determinism(checks) -> None:
    """Each redesigned kernel gives the same bits on two calls with the same
    inputs (fixed-order reductions, no float atomics)."""
    for label, call in checks.deterministic("cuda"):
        first, second = call(), call()
        torch.cuda.synchronize()
        _check(torch.equal(first, second), f"{label}: two calls differ")
        print(f"  {label}: bitwise equal over two calls")


def phase_host_cost(ops, checks) -> None:
    """The host's share of a wrapper call: enqueue time per call over 2000
    back-to-back calls (the card keeps up: these calls take a few us on it),
    and the costliest functions of a cProfile of them."""
    import cProfile
    import io
    import pstats
    rng = np.random.default_rng(5)
    m, k, n, f, _ = checks.MAIN_PATH_MATMULS[-1]
    a, b = _cuda(rng.normal(size=(m, k))), _cuda(checks.linear_weight(rng, k, n))
    q, kk, v = (_cuda(rng.normal(size=(1, h, 64, 64))) for h in (4, 2, 2))
    calls = {f"ops.matmul {m}x{k}x{n} f{f}": lambda: ops.matmul(a, b, banks=(f, f, f)),
             f"torch.matmul {m}x{k}x{n}": lambda: torch.matmul(a, b),
             "ops.attention 4:2x64x64": lambda: ops.attention(
                 q, kk, v, block_q=64, block_k=64)}
    rows = {}
    for label, fn in calls.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        rows[label] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    print(json.dumps({"host_us_per_call": rows}))
    for label, fn in calls.items():
        if label.startswith("torch"):
            continue
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(2000):
            fn()
        prof.disable()
        torch.cuda.synchronize()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(10)
        lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
        print(f"cProfile of 2000 calls of {label}:")
        print("\n".join("  " + ln for ln in lines[3:16]))


class Case:
    """One call of a kernel's path at full width: the kernel's call, its
    plain version, the library yardsticks by name (none, or the calls that
    compute the same function, the fastest of which is reported), the
    operations and bytes the call needs, the peak rate for its type, the
    tolerance and any notes for its row."""

    def __init__(self, label: str, kernel: Callable, plain: Callable,
                 libraries: Dict[str, Callable], flops: float, nbytes: float,
                 dtype, rtol: float, atol: float, notes: Optional[dict] = None):
        self.label, self.kernel, self.plain = label, kernel, plain
        self.libraries = libraries
        self.flops, self.nbytes, self.dtype = flops, nbytes, dtype
        self.rtol, self.atol, self.notes = rtol, atol, notes or {}
        self.err = 0.0


def _zero_counts(counters) -> None:
    for mod in counters:
        mod.launches = 0


def _drive(name: str, cases: List[Case], counters, own) -> int:
    """The path: every count zeroed just before, the kernel's entry point
    called once per case, counts read just after; then each output is held
    against its plain version."""
    _zero_counts(counters)                    # zeroed just before the path
    outs = [c.kernel() for c in cases]
    torch.cuda.synchronize()
    launches = own.launches                   # read just after the path
    _check(launches == len(cases), f"{name} path: {launches} launches for "
                                   f"{len(cases)} calls")
    for c, out in zip(cases, outs):
        c.err = _hold(c.label, out, c.plain(), c.rtol, c.atol, {})
        print(f"  {c.label}: max |kernel - plain| {c.err:.3g} "
              f"(rtol {c.rtol}, atol {c.atol})")
    print(f"{name} path: launched {launches} times")
    return launches


def _attention_bound(b, hq, hkv, s, sk, d, causal, dtype):
    pairs = s * (s + 1) // 2 if causal else s * sk      # score entries needed
    flops = 4 * b * hq * pairs * d                      # q k^T and p v
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = size * (2 * b * hq * s * d + 2 * b * hkv * sk * d)
    return flops, nbytes


# bf16 outputs at full width are held to the plain version rounded to bf16:
# the two round f32 values about 1e-6 apart, so they differ by at most one
# bf16 ulp, 2**-7 = 7.8e-3 of the value at the bottom of a binade
ATTN_BF16_TOL = dict(rtol=8e-3, atol=1e-4)


def attention_cases(ops, ref, full_f32, checks) -> List[Case]:
    """qwen2-0.5b's heads at 4096 tokens.  The library yardstick is SDPA,
    timed two ways: with ``enable_gqa`` (where this torch has it) and with k
    and v repeated to the q heads outside the timed call, so that a backend
    without GQA may take it; the faster is reported."""
    import torch.nn.functional as F
    cfg = checks.QWEN2_0_5B_ATTENTION
    b, hq, hkv, s, d = cfg["b"], cfg["hq"], cfg["hkv"], cfg["s"], cfg["d"]
    rng = np.random.default_rng(4096)
    base = [rng.normal(size=(b, hq, s, d)), rng.normal(size=(b, hkv, s, d)),
            rng.normal(size=(b, hkv, s, d))]
    try:                                      # enable_gqa: torch >= 2.5
        probe = torch.zeros(1, 2, 4, 8, device="cuda")
        F.scaled_dot_product_attention(probe, probe[:, :1], probe[:, :1],
                                       enable_gqa=True)
        gqa = True
    except TypeError:
        gqa = False
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (_cuda(a, dtype) for a in base)
        kr, vr = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
        for causal in (True, False):
            flops, nbytes = _attention_bound(b, hq, hkv, s, s, d, causal, dtype)

            def sdpa(k, v, causal=causal, q=q, **kw):
                def call():
                    with full_f32():
                        return F.scaled_dot_product_attention(
                            q, k, v, is_causal=causal, **kw)
                return call
            libraries = {"sdpa repeated kv": sdpa(kr, vr)}
            if gqa:
                libraries["sdpa enable_gqa"] = sdpa(k, v, enable_gqa=True)
            tol = ATTN_BF16_TOL if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)
            cases.append(Case(
                f"attention {hq}:{hkv}x{s}x{d} causal {causal} "
                f"{str(dtype).replace('torch.', '')}",
                lambda q=q, k=k, v=v, c=causal: ops.attention(q, k, v, causal=c),
                lambda q=q, k=k, v=v, c=causal: ref.attention_ref(q, k, v, causal=c),
                libraries, flops, nbytes, dtype, **tol))
    return cases


def _scan_bound(b, h, s, dk, dv, chunk, bonus):
    """(flops, bytes, chunked flops).  The bound counts the step recurrence,
    the least work the scan needs, per step and head: dk exps, dk*dv decay
    multiplies, 2*dk*dv for the k v outer product's add and 2*dk*dv for
    q . h, and in bonus mode 3*dk + 2*dv for (q . (u k)) v.  Bytes: q, k, v,
    w (and u) read once, o written once, in f32.  The chunked form's count
    (products with the state, the masked window decay terms of an add, an
    exp and three multiply-adds, the state update) is what the kernel does,
    reported beside it."""
    flops = b * h * s * (dk + 5 * dk * dv + ((3 * dk + 2 * dv) if bonus else 0))
    nbytes = 4 * (b * h * s * (3 * dk + 2 * dv) + (h * dk if bonus else 0))
    c = chunk
    pairs = c * (c - 1) // 2 if bonus else c * (c + 1) // 2
    per_chunk = (2 * c * dk * dv + 2 * c * dk          # q exp(W) @ h0
                 + 5 * pairs * dk                       # window decay terms
                 + 2 * pairs * dv                       # scores @ v
                 + 2 * c * dk * dv + 2 * c * dk          # k_dec^T @ v
                 + 2 * dk * dv + 2 * dk)                 # exp(w_total) h0
    if bonus:
        per_chunk += 3 * c * dk + 2 * c * dv            # (q u k) v
    return flops, nbytes, b * h * (s // c) * per_chunk


def scan_cases(ops, ref, checks) -> List[Case]:
    """The two full-width scans of ``checks`` (rwkv6-7b bonus, zamba2-7b
    inclusive), drawn by ``checks.full_width_scan``.  Each call runs the
    kernel's three launches (chunk states, state pass, chunk outputs)."""
    cases = []
    for label, cfg in (("rwkv6-7b bonus", checks.RWKV6_7B_SCAN),
                       ("zamba2-7b inclusive", checks.ZAMBA2_7B_SCAN)):
        b, h, s, dk, dv, chunk = (cfg[x] for x in ("b", "h", "s", "dk", "dv", "chunk"))
        mode = cfg["mode"]
        q, k, v, w, u = checks.full_width_scan("cuda", cfg)
        flops, nbytes, chunked = _scan_bound(b, h, s, dk, dv, chunk, mode == "bonus")
        cases.append(Case(
            f"scan {label} {b}x{h}x{s}x{dk}/{dv} chunk {chunk}",
            lambda q=q, k=k, v=v, w=w, u=u, c=chunk, m=mode:
                ops.decay_scan(q, k, v, w, u=u, chunk=c, diag_mode=m),
            lambda q=q, k=k, v=v, w=w, u=u, m=mode:
                ref.ssm_scan_ref(q, k, v, w, u=u, diag_mode=m),
            {}, flops, nbytes, torch.float32, 1e-4, 1e-4,
            notes={"chunked_flops": chunked,
                   "chunked_ops_ms": chunked / PEAK_FLOPS[torch.float32] * 1e3,
                   "exps": b * h * (s // chunk) * chunk * (chunk + 1) // 2 * dk}))
    return cases


def conv_cases(ops, ref, full_f32, frontend, pipeline, torch_backend) -> List[Case]:
    """The conv of the paper's CNN as the port compiles it (factor 1): its
    weight from the graph's params, its input from a seed; the torch
    oracle's conv output of the same graph must agree with the plain one."""
    import torch.nn.functional as F
    d = pipeline.compile_model(frontend.paper_cnn(), [(3, 80, 60)], factor=1)
    conv = next(op for op in d.graph.ops if op.kind == "conv2d")
    x = _cuda(np.random.default_rng(0).normal(size=(3, 80, 60)))
    w = _cuda(np.asarray(d.graph.params[conv.inputs[1]]))
    with full_f32():
        oracle = torch_backend._op_fn(conv, {conv.inputs[0]: x, conv.inputs[1]: w},
                                      d.graph)
    _hold("paper_cnn conv: oracle", oracle, ref.conv2d_ref(x, w), 2e-5, 2e-5, {})
    cout, cin, kh, kw = w.shape
    ho, wo = x.shape[1] - kh + 1, x.shape[2] - kw + 1
    flops = 2 * cout * ho * wo * cin * kh * kw
    nbytes = 4 * (x.numel() + w.numel() + cout * ho * wo)

    def library():
        with full_f32():
            return F.conv2d(x[None], w)[0]
    return [Case(f"conv paper_cnn {cin}->{cout} 80x60 k5x5 banks {banks}",
                 lambda banks=banks: ops.conv2d(x, w, banks=banks),
                 lambda: ref.conv2d_ref(x, w), {"F.conv2d": library}, flops, nbytes,
                 torch.float32, 2e-5, 2e-5)
            for banks in CONV_BANKS]


def _backend(kernels) -> str:
    """Which SDPA backend a call's device kernel names show: cudnn, flash,
    mem-efficient, or other (the math backend's GEMMs and softmax, or a
    library call that is not SDPA)."""
    text = " ".join(kernels).lower()
    return ("cudnn" if "cudnn" in text else "flash" if "flash" in text else
            "mem-efficient" if ("fmha" in text or "efficient" in text) else "other")


def phase_path_times(name, route_src, replaces, cases: List[Case], launches,
                     full_f32) -> dict:
    """Times at the path's own shapes; one kernels-line entry (sums over
    the path's calls).  Where a case has several library calls, the one
    with the least call time is its ``library_ms``."""
    rows = []
    total = dict.fromkeys(("ms", "plain_ms", "device_ms", "plain_device_ms"), 0.0)
    lib_total = {"library_ms": 0.0, "library_device_ms": 0.0}
    t_ops = t_bytes = 0.0
    for c in cases:
        with full_f32():
            k, p = _times(c.kernel), _times(c.plain)
            libs = {lab: _times(fn) for lab, fn in c.libraries.items()}
        for t in libs.values():
            t["backend"] = _backend(t["kernels"])
        best = min(libs, key=lambda lab: libs[lab]["ms"]) if libs else None
        row = {"case": c.label, "ms": k["ms"], "device_ms": k["device_ms"],
               "device_kernels": k["kernels"],
               "plain_ms": p["ms"], "plain_device_ms": p["device_ms"],
               "library": best,
               "library_ms": best and libs[best]["ms"],
               "library_device_ms": best and libs[best]["device_ms"],
               "library_calls": libs}
        ops_ms = c.flops / PEAK_FLOPS[c.dtype] * 1e3
        bytes_ms = c.nbytes / HBM_BYTES_PER_S * 1e3
        row.update(bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   flops=c.flops, bytes=c.nbytes, max_abs_err=c.err,
                   rtol=c.rtol, atol=c.atol, **c.notes)
        rows.append(row)
        for key in total:
            total[key] += row[key]
        if best is not None:
            lib_total["library_ms"] += row["library_ms"]
            lib_total["library_device_ms"] += row["library_device_ms"]
        t_ops, t_bytes = t_ops + ops_ms, t_bytes + bytes_ms
    print(json.dumps({f"{name}_path_shapes": rows}))
    has_lib = all(c.libraries for c in cases)
    return {"name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c.err for c in cases),
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_total["library_ms"] if has_lib else None,
            "device_ms": total["device_ms"],
            "plain_device_ms": total["plain_device_ms"],
            "library_device_ms": lib_total["library_device_ms"] if has_lib else None}


# -- the dense decode and serving path -------------------------------------

CARD = "cuda"
SERVE_ARCH = "qwen2-0.5b"
SERVE_SEED = 0
DECODE_TOL = 2e-2            # tests/test_decode_consistency.py:60


class ServePath:
    """The modules of the serving path and the full-width weights, drawn once
    (numpy, ~494 M normals) and carried to the card per phase."""

    def __init__(self):
        from repro_torch.launch import faults, resilience, serve
        from repro_torch.models import decode, get_config, params, transformer
        from repro_torch.obs import modelprof, spans, traffic
        from repro_torch.obs import MetricsRegistry, SpanTracer
        self.faults, self.resilience, self.serve = faults, resilience, serve
        self.decode, self.params, self.transformer = decode, params, transformer
        self.modelprof, self.spans, self.traffic = modelprof, spans, traffic
        self.MetricsRegistry, self.SpanTracer = MetricsRegistry, SpanTracer
        self.cfg = get_config(SERVE_ARCH)
        self.reduced = get_config(SERVE_ARCH).reduced()
        t0 = time.perf_counter()
        self.tree = params.init_numpy_params(self.cfg, SERVE_SEED)
        print(f"{SERVE_ARCH}: {params.count_params(self.cfg):,} parameters drawn "
              f"in {time.perf_counter() - t0:.1f}s (numpy, seed {SERVE_SEED})")


def phase_decode_vs_forward(sp: ServePath) -> dict:
    """Teacher-forced decode against forward at full width in float32, on
    the card, and the first steps on the card against the CPU."""
    import dataclasses
    cfg = dataclasses.replace(sp.cfg, dtype="float32")
    b, s, cpu_steps = 2, 16, 4
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (b, s)))
    out = {}
    for where, dev in (("card", CARD), ("cpu", "cpu")):
        prm = sp.params.params_from_numpy(sp.tree, dev, "float32")
        cache = sp.decode.init_cache(cfg, prm, b, s + 4)
        steps = s if where == "card" else cpu_steps
        toks = tokens.to(dev)
        logits = [sp.decode.serve_step(cfg, prm, cache, toks[:, i:i + 1], i)[0]
                  for i in range(steps)]
        out[where] = torch.cat(logits, dim=1).cpu()
        if where == "card":
            from repro_torch.device import full_f32
            with full_f32():
                full, _ = sp.transformer.forward(cfg, prm, toks)
            full = full.cpu()
        del prm, cache, logits
        torch.cuda.empty_cache()
    for label, got in (("decode", out["card"]), ("forward", full)):
        _check(got.shape[0] == b and got.shape[2] == cfg.vocab_size
               and bool(torch.isfinite(got).all()), f"{label}: shape or finite")
    per_pos = (out["card"] - full).abs().amax(dim=(0, 2))
    vs_cpu = float((out["card"][:, :cpu_steps] - out["cpu"]).abs().max())
    row = {"arch": SERVE_ARCH, "batch": b, "tokens": s, "dtype": "float32",
           "max_abs_decode_vs_forward": float(per_pos.max()),
           "per_position": [float(x) for x in per_pos],
           "max_abs_card_vs_cpu_first_steps": vs_cpu, "cpu_steps": cpu_steps,
           "logit_scale": float(full.abs().max()), "tol": DECODE_TOL}
    print(json.dumps({"decode_vs_forward": row}))
    _check(row["max_abs_decode_vs_forward"] < DECODE_TOL,
           f"decode vs forward: max |diff| {row['max_abs_decode_vs_forward']:.3g}")
    _check(vs_cpu < DECODE_TOL, f"card vs cpu: max |diff| {vs_cpu:.3g}")
    return row


def _serve_requests(sp: ServePath, cfg, requests: int, prompt: int, gen: int,
                    mean: float):
    """The CLI's arrival trace and prompts (``launch/serve.py``'s ``main``)."""
    rng = np.random.default_rng(SERVE_SEED)
    trace = sp.traffic.synth_trace(SERVE_SEED, requests, mean, [prompt], [gen])
    return [(t.arrival_step, sp.serve.Request(
        t.rid, rng.integers(1, cfg.vocab_size, size=t.prompt_len).astype(np.int32),
        t.gen_len)) for t in trace]


def phase_serve(sp: ServePath) -> dict:
    """The engine on the full bf16 config: a checked run (every logit
    finite), a timed run, a run under the profiler for the device time, and
    a run with the layer profiler."""
    from torch.profiler import ProfilerActivity, profile
    cfg, slots, requests, prompt, gen, mean = sp.cfg, 4, 8, 8, 16, 0.5
    max_len = (prompt + gen) * requests + 8          # the CLI's, for spread arrivals
    torch.cuda.reset_peak_memory_stats()
    prm = sp.params.params_from_numpy(sp.tree, CARD, cfg.dtype)
    param_bytes = sp.decode.cache_num_bytes(prm)        # bytes of any tree

    def engine(**kw):
        return sp.serve.Engine(cfg, prm, slots, max_len, device=CARD, **kw)

    def run(eng):
        t0 = time.perf_counter()
        sp.serve.replay(eng, _serve_requests(sp, cfg, requests, prompt, gen, mean))
        return time.perf_counter() - t0

    def finished(eng, label):
        done = [r for r in eng.done if r.reason == sp.spans.FINISHED]
        _check(len(eng.done) == requests and len(done) == requests,
               f"{label}: {len(done)}/{requests} requests finished")
        _check(all(len(r.out) == gen for r in done), f"{label}: short outputs")

    # 1. checked: every step's logits finite, every request finished
    eng = engine(spans=sp.SpanTracer())
    step, nonfinite = eng._step, []

    def checked(*args):
        logits, cache = step(*args)
        if not bool(torch.isfinite(logits).all()):
            nonfinite.append(eng.steps)
        return logits, cache
    eng._step = checked
    run(eng)
    finished(eng, "checked run")
    _check(not nonfinite, f"non-finite logits at steps {nonfinite[:5]}")

    # 2. timed, with metrics and spans (the CLI's instruments)
    reg, tracer = sp.MetricsRegistry(), sp.SpanTracer()
    eng = engine(metrics=reg, spans=tracer)
    wall = run(eng)
    finished(eng, "timed run")
    problems = sp.spans.validate(tracer.events, slots=slots, engine_steps=eng.steps)
    _check(problems == [], f"spans.validate: {problems[:3]}")
    step_us = [e.dur_us for e in tracer.events if e.kind == sp.spans.STEP]
    ntok = sum(len(r.out) for r in eng.done)
    cache_bytes = sp.decode.cache_num_bytes(eng.cache)
    steps = eng.steps

    # 3. the same run under the profiler: device time of the engine's steps
    eng = engine()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(eng)
        torch.cuda.synchronize()
    counts = {}
    device = _device_events(prof, counts)
    device_ms_step = sum(device.values()) / eng.steps
    mean_step_ms = statistics.fmean(step_us) / 1e3

    # 4. the layer profiler: per-operator walls, and the join
    tracer, layers = sp.SpanTracer(), sp.modelprof.LayerProfiler()
    eng = engine(spans=tracer, layers=layers)
    run(eng)
    finished(eng, "layer-profiled run")
    mpf = sp.modelprof
    problems = (mpf.validate(layers.records, cfg=cfg, engine_steps=eng.steps)
                + mpf.join_mismatches(layers.records, tracer.events, cfg=cfg))
    _check(problems == [], f"layer records: {problems[:3]}")
    by_op = {}
    for r in layers.records:
        by_op.setdefault(r.op, []).append(r.dur_us)
    row = {
        "arch": SERVE_ARCH, "dtype": cfg.dtype, "slots": slots,
        "requests": requests, "prompt": prompt, "gen": gen, "arrival_mean": mean,
        "max_len": max_len, "finished": requests, "tokens": ntok,
        "wall_s": wall, "tokens_per_s": ntok / wall, "engine_steps": steps,
        "step_wall_ms_median": statistics.median(step_us) / 1e3,
        "step_wall_ms_mean": mean_step_ms,
        "step_device_ms": device_ms_step,
        "device_busy_share": device_ms_step / mean_step_ms,
        "device_events_per_step": sum(counts.values()) / eng.steps,
        "device_kernels_top": {k[:60]: v / eng.steps for k, v in sorted(
            device.items(), key=lambda kv: -kv[1])[:6]},
        "cache_bytes": cache_bytes, "param_bytes": param_bytes,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "op_mean_us": {op: statistics.fmean(by_op[op])
                       for op in ("embed", "attn", "mlp", "head")},
        "layer_steps": eng.steps,
        "card": _card_name_and_limit(),
    }
    print(json.dumps({"serve": row}))
    del prm
    torch.cuda.empty_cache()
    return row


def phase_serve_chaos(sp: ServePath) -> dict:
    """The reduced bf16 config under one seeded fault plan, resilience on,
    twice: no request lost, byte-identical ``--stable`` span streams."""
    import dataclasses
    cfg = dataclasses.replace(sp.reduced, dtype="bfloat16")
    slots, requests, prompt, gen, mean = 4, 12, 6, 10, 0.5
    max_len = ((prompt + gen) * requests + 8) * 2 + 64   # the CLI's, under faults
    plan = sp.faults.FaultPlan.generate(11, 128, 0.15, slots, spike_ticks=3,
                                        spike_us=200)
    res = sp.resilience.ResilienceConfig(deadline_ticks=300, seed=SERVE_SEED)
    prm = sp.params.init_params(cfg, seed=SERVE_SEED, device=CARD)
    streams, engines = [], []
    for _ in range(2):
        tracer = sp.SpanTracer()
        eng = sp.serve.Engine(cfg, prm, slots, max_len, spans=tracer, faults=plan,
                              resilience=res, device=CARD)
        sp.serve.replay(eng, _serve_requests(sp, cfg, requests, prompt, gen, mean))
        problems = sp.spans.validate(tracer.events, slots=slots,
                                     engine_steps=eng.steps)
        _check(problems == [], f"chaos spans: {problems[:3]}")
        _check(len(eng.done) == requests, f"chaos: {len(eng.done)}/{requests} "
                                          f"requests accounted for")
        streams.append(sp.spans.to_jsonl(tracer.events, stable=True))
        engines.append(eng)
    _check(streams[0] == streams[1], "chaos span streams differ between two runs")
    eng = engines[0]
    _check(eng.faults_injected > 0, "the plan injected no fault")
    reasons = {}
    for r in eng.done:
        reasons[r.reason] = reasons.get(r.reason, 0) + 1
    row = {"arch": f"{SERVE_ARCH} reduced", "dtype": cfg.dtype, "slots": slots,
           "requests": requests, "plan": plan.counts(),
           "faults_injected": eng.faults_injected,
           "faults_detected": eng.faults_detected, "retries": eng.retries,
           "reasons": reasons, "engine_steps": eng.steps,
           "span_events": len(streams[0].splitlines()), "identical": True}
    print(json.dumps({"serve_chaos": row}))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (BankConflictError, cuda_backend, frontend,
                                  pipeline, torch_backend)
    from repro_torch.device import full_f32
    from repro_torch.kernels import _build, checks, ops, ref
    from repro_torch.kernels import banked_conv2d as conv_mod
    from repro_torch.kernels import banked_matmul as banked
    from repro_torch.kernels import flash_attention as attn_mod
    from repro_torch.kernels import ssm_scan as scan_mod
    counters = (banked, conv_mod, attn_mod, scan_mod)

    failures = []
    kernels = []
    results = {}

    def main_path():
        _zero_counts(counters)
        return phase_main_path(frontend, pipeline, cuda_backend, banked, checks,
                               BankConflictError)

    # each new kernel's path: (name, source, TPU kernel, its module, its cases)
    paths = [
        ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:58", attn_mod,
         lambda: attention_cases(ops, ref, full_f32, checks)),
        ("ssm_scan", "src/repro_torch/csrc/ssm_scan.cu",
         "src/repro/kernels/ssm_scan.py:110", scan_mod,
         lambda: scan_cases(ops, ref, checks)),
        ("banked_conv2d", "src/repro_torch/csrc/banked_conv2d.cu",
         "src/repro/kernels/banked_conv2d.py:43", conv_mod,
         lambda: conv_cases(ops, ref, full_f32, frontend, pipeline, torch_backend)),
    ]
    phases = [
        ("card and build", lambda: phase_card_and_build(_build)),
        ("matmul vs plain", lambda: phase_vs_plain("matmul", checks.matmul)),
        ("attention vs plain", lambda: phase_vs_plain("attention", checks.attention)),
        ("scan vs plain", lambda: phase_vs_plain("scan", checks.decay_scan)),
        ("conv vs plain", lambda: phase_vs_plain("conv", checks.conv2d)),
        ("determinism", lambda: phase_determinism(checks)),
        ("main path", main_path),
    ]
    for name, _, _, mod, make in paths:
        def drive(name=name, mod=mod, make=make):
            cases = make()
            return cases, _drive(name, cases, counters, mod)
        phases.append((f"{name} path", drive))

    def run(label, fn):
        t0 = time.perf_counter()
        print(f"== {label}", flush=True)
        try:
            results[label] = fn()
        except Exception as e:              # every phase runs; any failure fails
            failures.append(f"{label}: {e}")
            traceback.print_exc()
            return False
        print(f"   ({time.perf_counter() - t0:.1f}s)", flush=True)
        return True

    for label, fn in phases:
        if not run(label, fn) and label == "card and build":
            break
    if "main path" in results:
        shapes, launches, ran = results["main path"]
        if run("times", lambda: phase_times(ops, ref, full_f32, checks, banked,
                                            shapes, launches)):
            kernels.append(results["times"])
        run("profile", lambda: phase_profile(cuda_backend, ran))
    for name, src, replaces, _, _ in paths:
        if f"{name} path" not in results:
            continue
        cases, launches = results[f"{name} path"]
        if run(f"{name} times", lambda: phase_path_times(
                name, src, replaces, cases, launches, full_f32)):
            kernels.append(results[f"{name} times"])
    run("host cost", lambda: phase_host_cost(ops, checks))
    if run("serve path weights", ServePath):
        sp = results["serve path weights"]
        run("decode vs forward", lambda: phase_decode_vs_forward(sp))
        run("serve", lambda: phase_serve(sp))
        run("serve chaos", lambda: phase_serve_chaos(sp))
    if kernels:
        print(json.dumps({"kernels": kernels}))
    if failures:
        for f in failures:
            print(f"FAILED {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
