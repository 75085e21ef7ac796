#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card: build, check, time.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  Phases:

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   CUDA kernel of the port from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes of ``tests/test_kernels.py`` and at 256^3 and 1024^3;
3. drives the main path, the paper's flow: compiles the paper's FFNN, MHA
   and CNN at full width with the port, runs each design on the card through
   the banked-kernel backend (``execute_graph_cuda``) and checks it against
   the torch oracle on the card and the affine interpreter (``d.run``); the
   launch counts are zeroed just before and read just after, and must equal
   the graphs' matmul counts; the designs that conflict on banks must still
   raise ``BankConflictError``;
4. at the main path's own shapes, holds the kernel against its plain version
   once more and times kernel, plain version and ``torch.matmul`` (the
   library yardstick, which the port never calls): each call with CUDA
   events over back-to-back calls, and its device time alone with
   ``torch.profiler``;
5. times each design's banked-backend run on the host clock and takes its
   device time by kernel from ``torch.profiler``.

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# (M, K, N) sweeps of tests/test_kernels.py, at that file's tolerances
TEST_SHAPES = [(8, 16, 8), (32, 64, 48), (48, 64, 40), (1, 64, 48),
               (17, 33, 9), (128, 128, 128)]
TEST_BANKS = [(1, 1, 1), (2, 2, 2), (4, 2, 1), (1, 4, 4)]
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


class PhaseFailed(Exception):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def _excess(got: torch.Tensor, want: torch.Tensor, tol: float):
    """(max |got - want|, max of |got - want| - (tol + tol * |want|))."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float(diff.max()), float((diff - tol - tol * w.abs()).max())


def _linear_weight(rng, k: int, n: int) -> np.ndarray:
    """A (K, N) weight drawn as ``frontend.Linear`` draws it (fan-in scaled).

    With unit-variance B the f32 rounding of a K = 1024 sum alone is about
    2e-5 rms, the tolerance itself; a Linear's weights keep the products'
    sum at unit scale.
    """
    bound = (1.0 / max(k, 1)) ** 0.5
    return rng.uniform(-bound, bound, size=(k, n)).astype(np.float32)


def _time_ms(fn, reps: int = 7, iters: int = 50) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls."""
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


def _device_events(prof) -> dict:
    """{name: ms} of the device-side events (kernels, copies) of a profile.

    A host op's own device time repeats its kernels', so host ops are left
    out; CUPTI's buffer requests are the profiler's, not the program's.
    """
    device = {}
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith("Activity Buffer")):
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us > 0:
            device[ev.key] = device.get(ev.key, 0.0) + us / 1e3
    return device


def _device_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call (its kernels and copies on the card,
    from ``torch.profiler``): at the main path's shapes a call is far
    shorter than its launch from Python, which CUDA events also count."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(_device_events(prof).values()) / iters


def _bound(m: int, k: int, n: int, dtype, out_dtype):
    """(flops, bytes) one product needs: each input read once, C written once."""
    flops = 2 * m * n * k
    nbytes = ((m * k + k * n) * torch.empty((), dtype=dtype).element_size()
              + m * n * torch.empty((), dtype=out_dtype).element_size())
    return flops, nbytes


def phase_card_and_build(build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    secs = build.build(["banked_matmul"])
    print(f"build: {secs:.1f}s")
    for name, text in build.log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")


def phase_kernel_vs_plain(ops, ref):
    dev = torch.device("cuda")
    cases = []   # (label, a, b, banks, out_dtype)
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in TEST_SHAPES:
            rng = np.random.default_rng(m * 1000 + k * 10 + n)
            a = torch.tensor(rng.normal(size=(m, k)), dtype=dtype, device=dev)
            b = torch.tensor(rng.normal(size=(k, n)), dtype=dtype, device=dev)
            cases.append((f"{m}x{k}x{n} {dtype}", a, b, (2, 2, 2), None))
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.normal(size=(64, 96)), dtype=torch.float32, device=dev)
    b = torch.tensor(rng.normal(size=(96, 64)), dtype=torch.float32, device=dev)
    for banks in TEST_BANKS:
        cases.append((f"64x96x64 banks{banks}", a, b, banks, None))
    rng = np.random.default_rng(0)
    for s in (256, 1024):
        a32 = torch.tensor(rng.normal(size=(s, s)), dtype=torch.float32, device=dev)
        b32 = torch.tensor(_linear_weight(rng, s, s), device=dev)
        for f in ((1, 2, 4) if s == 256 else (1,)):
            cases.append((f"{s}^3 f32 banks{f}", a32, b32, (f, f, f), None))
    a16 = torch.tensor(rng.normal(size=(1024, 1024)), dtype=torch.bfloat16, device=dev)
    b16 = torch.tensor(rng.normal(size=(1024, 1024)), dtype=torch.bfloat16, device=dev)
    cases.append(("1024^3 bf16->f32", a16, b16, (1, 1, 1), torch.float32))

    worst = {}
    for label, a, b, banks, out_dtype in cases:
        got = ops.matmul(a, b, banks=banks, out_dtype=out_dtype)
        want = ref.matmul_ref(a, b, out_dtype)
        torch.cuda.synchronize()
        tol = TOL[a.dtype]
        err, excess = _excess(got, want, tol)
        _check(got.dtype == (out_dtype or a.dtype) and got.shape == want.shape,
               f"{label}: got {got.dtype} {tuple(got.shape)}")
        _check(bool(torch.isfinite(got.float()).all()), f"{label}: not finite")
        _check(excess <= 0, f"{label}: max |kernel - plain| {err:.3g} "
                            f"beyond {tol} (rtol = atol)")
        key = str(a.dtype).replace("torch.", "")
        worst[key] = max(worst.get(key, 0.0), err)
    ones = ops.matmul(torch.ones(8, 512, dtype=torch.bfloat16, device=dev),
                      torch.ones(512, 8, dtype=torch.bfloat16, device=dev),
                      out_dtype=torch.float32)
    _check(bool((ones == 512.0).all()), "bf16 ones at K=512: not exactly 512.0")
    print(f"kernel vs plain: {len(cases) + 1} cases pass; max |err| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def phase_main_path(frontend, pipeline, cuda_backend, banked, BankConflictError):
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
    print(f"main path: banked_matmul launched {total} times")
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


def phase_times(ops, ref, full_f32, shapes, launches):
    """Kernel vs plain at the main path's shapes, then times; the kernels line."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    rows, flops, nbytes, max_err = [], 0, 0, 0.0
    total = dict.fromkeys(("ms", "plain_ms", "library_ms", "device_ms",
                           "plain_device_ms", "library_device_ms"), 0.0)
    for (m, k, n, f, view), count in sorted(shapes.items()):
        a = torch.tensor(rng.normal(size=(m, k)), dtype=torch.float32, device=dev)
        w = torch.tensor(_linear_weight(rng, k, n), device=dev)
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
        rows.append({"m": m, "k": k, "n": n, "banks": f, "b_view": view,
                     "count": count, **row, "max_abs_err": err})
        flops, nbytes = flops + count * fl, nbytes + count * by
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"main_path_shapes": rows}))

    large = []
    for s, dtype, out in ((256, torch.float32, torch.float32),
                          (1024, torch.float32, torch.float32),
                          (1024, torch.bfloat16, torch.float32)):
        a = torch.tensor(rng.normal(size=(s, s)), dtype=dtype, device=dev)
        b = torch.tensor(_linear_weight(rng, s, s), dtype=dtype, device=dev)
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
    from repro_torch.core import BankConflictError, cuda_backend, frontend, pipeline
    from repro_torch.device import full_f32
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import banked_matmul as banked

    failures = []
    kernels = None
    shapes = launches = ran = None
    phases = [
        ("card and build", lambda: phase_card_and_build(_build)),
        ("kernel vs plain", lambda: phase_kernel_vs_plain(ops, ref)),
        ("main path", lambda: phase_main_path(
            frontend, pipeline, cuda_backend, banked, BankConflictError)),
    ]
    for label, fn in phases:
        t0 = time.perf_counter()
        print(f"== {label}", flush=True)
        try:
            result = fn()
        except Exception as e:              # every phase runs; any failure fails
            failures.append(f"{label}: {e}")
            traceback.print_exc()
            if label == "card and build":
                break
            continue
        if label == "main path":
            shapes, launches, ran = result
        print(f"   ({time.perf_counter() - t0:.1f}s)", flush=True)
    if shapes is not None:
        print("== times", flush=True)
        try:
            kernels = phase_times(ops, ref, full_f32, shapes, launches)
        except Exception as e:
            failures.append(f"times: {e}")
            traceback.print_exc()
        print("== profile", flush=True)
        try:
            phase_profile(cuda_backend, ran)
        except Exception as e:
            failures.append(f"profile: {e}")
            traceback.print_exc()
    if kernels is not None:
        print(json.dumps({"kernels": [kernels]}))
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
