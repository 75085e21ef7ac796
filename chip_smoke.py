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
8. the decode and serving path (``repro_torch.models``,
   ``repro_torch.launch.serve``), for each architecture of
   ``SERVE_ARCHS`` at full width: qwen2-0.5b (dense), rwkv6-7b (ssm,
   RWKV6; 4 of its 32 layers), zamba2-7b (hybrid: Mamba2 and one shared
   attention block; 9 of its 27 groups), olmoe-1b-7b (moe, banked expert
   dispatch; 2 of its 16 layers), whisper-large-v3 (audio: the encoder over 1500 frames, decoder
   layers with self and cross attention) and llama-3.2-vision-11b (vlm:
   groups of 4 self layers and a gated cross layer over 1601 patches); each
   depth cut is listed as ``reduced``.  Its weights are drawn once
   from a numpy seed (the reference's draw) and streamed leaf by leaf to the
   card in float32 (``params.stream_params``; the draw's seconds are
   printed): ``decode vs forward`` feeds 16 tokens of 2 sequences
   teacher-forced through ``serve_step`` in float32 without TF32 and holds
   every position's logits against the port's ``forward`` on the card at
   2e-2 (``tests/test_decode_consistency.py``; olmoe at its capacity factor
   8.0, the override printed; whisper and the VLM with frames or patches
   drawn from numpy, projected into the cross caches by ``init_cache``, the
   VLM's cross gates set to seeded non-zero values, printed; the forward's
   spread under a one-ulp change of its input printed beside it), and the
   first 4 steps against the same steps on the CPU at 2e-2, at full width
   and every layer for qwen2-0.5b, the first groups of the others (2 of
   rwkv6-7b's, 1 of zamba2-7b's with its shared block, 2 of
   olmoe-1b-7b's, 2 of whisper's 32 with 2 of its 32 encoder layers, 1 of
   the VLM's 8; listed as ``reduced``);
   ``serve`` casts the weights to bf16 in place (``params.cast_params``)
   and runs ``Engine`` (4 slots, 8 requests of prompt 8 and gen 16 on a
   seeded arrival trace) with a ``MetricsRegistry`` and a ``SpanTracer``:
   every request finishes, every logit is finite, the spans validate, and
   one JSON ``serve`` line gives tokens/s, steps, step wall and device time,
   the device's busy share, the cache's bytes at init and after the first
   step (RWKV6's wkv state and zamba2's Mamba state turn float32 there;
   both must equal the reference's layout), memory and the card; the
   same requests with a ``LayerProfiler`` give the time of every operator
   of ``decode.profile_ops`` and a join that closes (not for whisper and the
   VLM, which the reference's layer profiler refuses); for whisper and the
   VLM, whose engine serves zeroed cross caches as the reference's does,
   the line's ``modality`` entry times ``init_cache`` filling them from a
   modality at 4 slots in bf16 (the wall and the device time); ``serve
   chaos`` runs the reduced bf16 config twice under one seeded
   ``FaultPlan`` with resilience on: no request is lost and the two
   ``--stable`` span streams are byte-identical.  This path launches none
   of the four kernels (the reference's serving path runs no Pallas
   kernel);
9. the training path (``repro_torch.runtime.trainer``, ``launch.steps``,
   ``optim.adamw``, ``checkpoint.manager``, ``data.pipeline``) on
   qwen2-0.5b at full width, every kernel count zeroed just before it and
   read just after (it launches none of the four: the reference's train
   step is ``jax.value_and_grad`` over jnp ops): (a) ``train card vs cpu``
   holds one step's loss and every gradient leaf, float32, all 24 layers,
   one ``SyntheticLM`` batch of 2 x 64, against the same step on the CPU
   (loss at 1e-4 relative, each leaf at 2e-3 of its largest magnitude, the
   tolerance of ``tests/test_torch_trainer.py``), then one AdamW update on
   the card and on the CPU from the same CPU gradients (params, m and v
   within 2e-5); ``train atomics`` calls the path's scatter-adds twice
   each (the embedding's backward as indexing and as ``F.embedding``,
   ``take_along_dim``'s in the CE, the MoE dispatch's ``index_add_``) and
   says which give other bits; (b) ``train restart`` runs
   ``Trainer.run_with_restarts`` in float32 at full width on 4 of the 24
   layers (listed under ``reduced``: a float32 state of all 24 is ~6 GB
   to write at every checkpoint), 8 steps of 8 x 64, a checkpoint every 4,
   a ``WorkerFailure`` at step 5: it must resume at 4, its steps 6-7 must
   equal an unfailed run's at ``rel=1e-4`` (whether steps 4-7 are bitwise
   equal is printed), and the unfailed run's checkpoint, saved from the
   card, must restore on the CPU with its bits; (c) ``train timed`` trains
   the registered bfloat16 config, all 24 layers, remat as registered,
   with ``examples/train_lm.py``'s AdamW (lr 3e-3, warm-up 2, weight decay
   0.01) for 12 steps of 8 x 1024 tokens (the first 2 not timed): a finite
   loss that falls, tokens/s, the median step wall, the device time,
   events and busy share of 2 profiled steps, the optimizer's device time
   alone and its share, the peak allocated memory with remat on and for
   one step with it off, the seconds and bytes of the final checkpoint
   save, and ``6·N·T`` against 989 TFLOP/s; (d) ``train example`` runs
   ``examples/train_lm_torch.py --steps 14 --inject-failure 6 --batch 4
   --seq 32`` on the card: ``restarts=1`` and ``OK``.  One JSON ``train``
   line holds them.  Checkpoints go to ``build/chip_smoke_train`` and are
   removed;
10. ``op analysis`` (after qwen2-0.5b's ``serve``): ``modelprof.crosscheck``
   counts one full-width bf16 ``serve_step`` at 4 slots and cache 200 with
   ``launch.op_analysis`` on the card: FLOPs within 2% of the analytic
   model's, bytes within a factor 5 (the reference's constants), no
   collective bytes; the serve phase's layer records ranked by
   ``offload_report`` under the analytic costs at batch 1, cache 4096 and
   the H100's datasheet peaks; one JSON ``analysis`` line;
11. ``dry run``: ``python -m repro_torch.launch.dryrun --device cuda`` in
   processes of their own (gemma2-27b's cell in a second one), started
   before the VLM's weight draw and run on the host's CPU beside it, over
   ``DRYRUN_CELLS`` on the fake 16x16 and
   2x16x16 meshes (fake CUDA tensors, a fake process group), and waited
   for right after that draw, before the VLM's first timed phase: every
   cell ``ok``, olmoe-1b-7b's expert-parallel all-reduce among its
   collectives; one JSON ``dryrun`` line a cell, with the process's
   seconds, the draw's and the script's wait (its ``run_s`` are taken on a
   host the draw shares).  A third process beside them runs qwen2-0.5b
   ``train_4k`` on 16x16 with ``REPRO_MICROBATCH=4`` (the microbatch split
   on DTensors), which the first runs at 1: it ends ``ok``, counts the same
   dot FLOPs a device within 1% and a lower ``peak_live_bytes``;
   ``dry-run report`` then works on every process's records:
   ``benchmarks/fix_artifacts_torch.py`` restores a record whose
   ``model_flops`` and ``roofline`` were made stale, bit for bit;
   ``benchmarks/make_report_torch.py`` lists every record in its mesh's
   table; ``scripts/gen_experiments_torch.py --out build/...`` writes a
   document holding them, with the microbatched cell's summary line; one
   JSON ``dryrun_report`` line;
12. ``compiler examples``: ``examples/compile_to_calyx_torch.py --model
   ffnn --factor 2 --simulate-rtl`` prints ``matches estimate`` and an
   oracle error (the torch oracle on the card) under 1e-4;
   ``examples/banking_sweep_torch.py``, a check on the host, prints the
   sweep; one JSON ``compiler_examples`` line;
13. ``bench profile`` (after qwen2-0.5b's ``op analysis``): the first 32
   engine steps of the serve twin's ``full`` and ``full_wide`` replays on
   qwen2-0.5b's registered bf16 weights, profiled; one JSON
   ``bench_profile`` line (device ms and busy share a step);
14. ``bench`` (after the last serve phase, before training):
   ``benchmarks/run_torch.py serve_bench resilience_bench kernel_bench
   model_profile_bench roofline_report --device cuda`` in a process of its
   own, 2 repeats, its records in ``build/chip_smoke_bench`` (kept), then
   ``scripts/check_perf_regression.py`` with ``--serve-new``,
   ``--resilience-new`` and ``--model-new`` on them, no baseline: the
   contract checks; one JSON ``bench`` line a twin, the serve line with the
   ``full`` and ``full_wide`` records and ``bench profile``'s device time;
15. ``compiler bench`` (after ``compiler examples``, last, beside nothing:
   the verifier-overhead gate reads host clocks): every kernel count
   zeroed, ``benchmarks/run_torch.py paper_tables banking_ablation
   calyx_bench --device cuda`` in a process of its own (the 48-point Calyx
   matrix with the torch oracle on the card; the MoE dispatch census on the
   card), its file in ``build/chip_smoke_compiler`` (kept), then
   ``scripts/check_perf_regression.py --baseline BENCH_calyx.json`` on it
   (``calyx_bench`` run again, three runs at most, only while the gate's
   one failure is the verifier overhead); every field of the 48 records
   but the host clocks and the oracle's error equal to
   ``BENCH_calyx.json``'s, each oracle error within 1e-4, the opt geomean
   the reference's, banked MoE reading fewer slices than gather;
   ``scripts/verify_matrix_torch.py`` and ``scripts/lint_design_torch.py
   --model ffnn --factor 4 --profile`` exit 0; the counts still 0; one
   JSON ``compiler_bench`` line.

Every device time from ``torch.profiler`` comes from windows checked against
CUDA events over the same calls (``_window_trusted``): a window whose
device time exceeds them, or, for a device-bound call, falls short of the
calls' CUDA-event time less the host's enqueue cost by more than 5%, is
refused and retried (ROADMAP.md C.21).

Prints one JSON ``kernels`` line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a card, outside a checkout of
the repository, or when any phase fails.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
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


# A profiler window is trusted only where its device time agrees with CUDA
# events (ROADMAP.md C.21).  On one stream a call's kernels run one after
# another inside the events that bracket them, so the device time a call can
# exceed the events' time of the same calls only by the two clocks' rounding
# (EVENT_SLACK of it, and a microsecond).  Where a call is device-bound (its
# CUDA-event time DEVICE_BOUND times the host's enqueue cost or more), the
# card runs it back to back and idles at most the host's cost a call, so its
# device time is at least the CUDA-event time less that cost; WINDOW_MARGIN
# allows for the spread of one kernel's time between windows and calls,
# which stayed within 1.5% across the kernel rows PERF.md §6 records, and is
# a tenth of the 52% drop of the window C.21 found.
EVENT_SLACK = 0.01
DEVICE_BOUND = 4.0
WINDOW_MARGIN = 0.05


def _window_trusted(device_ms: float, event_ms: float, call_ms: float,
                    host_ms: float) -> Optional[str]:
    """None where a profiler window's device time a call can be trusted,
    else why not.  ``device_ms``: the window's device time a call;
    ``event_ms``: CUDA events around the window's own calls, a call;
    ``call_ms``: CUDA events over back-to-back calls outside the profiler, a
    call; ``host_ms``: the host's enqueue cost a call."""
    if device_ms > event_ms * (1 + EVENT_SLACK) + 1e-3:
        return (f"device {device_ms:.4g} ms a call exceeds the {event_ms:.4g} "
                f"ms of CUDA events around the same calls")
    floor = (call_ms - host_ms) * (1 - WINDOW_MARGIN)
    if call_ms >= DEVICE_BOUND * host_ms and device_ms < floor:
        return (f"device {device_ms:.4g} ms a call, under {floor:.4g} ms: a "
                f"device-bound call of {call_ms:.4g} ms (CUDA events) less its "
                f"{host_ms:.4g} ms of host cost, less {WINDOW_MARGIN:.0%}")
    return None


def _call_and_host_ms(fn, n: int):
    """(CUDA-event ms, host enqueue ms) a call over ``n`` back-to-back calls
    outside the profiler: the host's clock stops when the last call returns,
    before the card is waited for."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / n
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, host


def _profile_windows(fn, iters: int = 20, min_calls: int = 2) -> dict:
    """The device time of one call of ``fn`` from ``torch.profiler``
    windows, checked against CUDA events: ``device_ms`` (a call),
    ``by_kernel`` ({device kernel: mean ms a call}, costliest first),
    ``call_ms`` and ``host_ms`` (CUDA events and the host's enqueue cost a
    call, outside the profiler), ``refused`` (why each refused window was).

    The profiler may drop a window's events (it kept 19 of 20 calls' tiny
    kernels in most windows of one run, none of two calls' in another, and
    none of one plain scan call's first fill), so a window is at least
    ``min_calls`` calls (two, but for a call of hundreds of steps), a
    kernel's time a call is its mean over the events kept, times its events
    a call, and a window counts only when it holds every kernel any window
    of the same calls held and ``_window_trusted`` accepts its device time
    against CUDA events (the window's own, and the calls' time and host
    cost outside the profiler): two windows that kept events at least, more
    when they differ or one is refused, five windows at most, and then the
    call fails.  An empty window is the profiler's (the first of a process
    often is), not the call's."""
    from torch.profiler import ProfilerActivity, profile
    n = max(min_calls, iters)

    def window():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
        counts = {}
        events = _device_events(prof, counts)
        by_kernel = {k: ms / counts[k] * max(1, round(counts[k] / n))
                     for k, ms in sorted(events.items(), key=lambda kv: -kv[1])}
        return by_kernel, start.elapsed_time(end) / n

    fn()
    call_ms, host_ms = _call_and_host_ms(fn, n)
    kept, seen, refused = [], set(), []
    for _ in range(5):
        by_kernel, event_ms = window()
        if not by_kernel:
            continue
        seen |= set(by_kernel)
        why = _window_trusted(sum(by_kernel.values()), event_ms, call_ms, host_ms)
        if why is None:
            kept.append(by_kernel)
        else:
            refused.append(why)
            print(f"  profiler window refused: {why}", flush=True)
        full = [w for w in kept if set(w) == seen]
        if len(kept) + len(refused) >= 2 and full:
            break
    full = [w for w in kept if set(w) == seen]
    _check(bool(full), f"five profiler windows of {n} calls: {len(kept)} trusted "
                       f"(refused: {refused}), none of them every kernel of "
                       f"{sorted(seen)}")
    return {"device_ms": sum(full[-1].values()), "by_kernel": full[-1],
            "call_ms": call_ms, "host_ms": host_ms, "refused": refused}


def _device_profile(fn, iters: int = 20):
    """(mean device time of one call, {device kernel: mean ms a call},
    costliest first), from trusted profiler windows (``_profile_windows``).
    At the main path's shapes a call is far shorter than its launch from
    Python, which CUDA events also count."""
    w = _profile_windows(fn, iters)
    return w["device_ms"], w["by_kernel"]


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


# -- the decode and serving path -------------------------------------------

CARD = "cuda"
SERVE_SEED = 0
DECODE_TOL = 2e-2            # tests/test_decode_consistency.py:60

# the served architectures, each (arch, layers, cpu_groups): full width, at
# ``layers`` (None: full depth), with the depth in groups of its card vs CPU
# check (None: every group).  rwkv6-7b, zamba2-7b and olmoe-1b-7b run 4 of
# 32 layers, 9 of 27 groups and 2 of 16 layers, to pay for the draws of
# whisper-large-v3 and llama-3.2-vision-11b and the compiler benchmarks
# within the script's time (their full-depth and earlier numbers are in
# PERF_HISTORY.md).  At each depth the
# forward's spread under a one-ulp change of its input stays under the
# 2e-2 decode vs forward holds (at 16 layers olmoe-1b-7b's seeded model,
# blocks drawn at std 1/sqrt(16), ROADMAP.md C.6, moved by ~0.26), so every
# layer is held.  The float32 weights of the 7B-11B models, 18-39 GB,
# would not fit a host of unknown size, so the card vs CPU checks run their
# first groups: ~2.4 GB of host copies for zamba2-7b's, its shared block
# included, ~4.6 GB for olmoe-1b-7b's, ~1.8 GB for whisper's 2 decoder
# groups (and 2 encoder layers, ``CPU_ENCODER_LAYERS``), ~8.6 GB for the
# VLM's first group of 4 self layers and its cross layer
SERVE_ARCHS = (("qwen2-0.5b", None, None), ("rwkv6-7b", 4, 2),
               ("zamba2-7b", 27, 1), ("olmoe-1b-7b", 2, 2),
               ("whisper-large-v3", None, 2), ("llama-3.2-vision-11b", None, 1))
CPU_ENCODER_LAYERS = 2
# tests/test_decode_consistency.py:27-31: the full-sequence forward may drop
# tokens at a tight capacity while per-token decode never does
DECODE_OVERRIDES = {"moe": {"moe_capacity_factor": 8.0}}
# ROADMAP.md C.15: the VLM's cross gates are drawn as zeros, and tanh(0) = 0
# hides its whole cross layer; decode vs forward sets these, one a group
GATE_SEED = 15


class ServePath:
    """The modules of the serving path and one architecture's full-width
    weights, drawn once from numpy (the reference's draw, bit for bit) and
    streamed leaf by leaf to the card in float32; the serve phase casts them
    to the model dtype in place."""

    def __init__(self, arch: str, layers: Optional[int],
                 cpu_groups: Optional[int]):
        from repro_torch.launch import faults, resilience, serve
        from repro_torch.models import decode, get_config, params, transformer
        from repro_torch.obs import modelprof, spans, traffic
        from repro_torch.obs import MetricsRegistry, SpanTracer
        self.faults, self.resilience, self.serve = faults, resilience, serve
        self.decode, self.params, self.transformer = decode, params, transformer
        self.modelprof, self.spans, self.traffic = modelprof, spans, traffic
        self.MetricsRegistry, self.SpanTracer = MetricsRegistry, SpanTracer
        import dataclasses
        self.arch = arch
        full = get_config(arch)
        self.cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
        self.depth_cut = (
            [f"depth: {self.cfg.num_layers} of {full.num_layers} layers "
             f"(time budget; full width)"] if layers else [])
        self.reduced = get_config(arch).reduced()
        n = self.cfg.num_groups
        self.cpu_groups = min(cpu_groups or n, n)
        t0 = time.perf_counter()
        self.prm = params.stream_params(self.cfg, SERVE_SEED, CARD, "float32")
        torch.cuda.synchronize()
        self.draw_s = time.perf_counter() - t0
        self.n_params = params.count_params(self.cfg)
        print(f"{arch}: {self.n_params:,} parameters drawn in "
              f"{self.draw_s:.1f}s (numpy, seed {SERVE_SEED}, streamed to the "
              f"card in float32)", flush=True)


def _first(tree, key: str, n: int):
    """The tree with its stacked ``key`` subtree cut to the first ``n``."""
    cut = lambda t: ({k: cut(v) for k, v in t.items()}       # noqa: E731
                     if isinstance(t, dict) else t[:n])
    return {k: cut(v) if k == key else v for k, v in tree.items()}


def _modality(cfg, batch: int, seed: int):
    """Frame (audio: (B, encoder_seq, D)) or patch (vlm: (B, num_patches,
    D)) embeddings drawn from numpy, float32 on the host; None for the
    families without one."""
    if cfg.family not in ("audio", "vlm"):
        return None
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.num_patches
    a = np.random.default_rng(seed).normal(size=(batch, n, cfg.d_model))
    return torch.from_numpy(a.astype(np.float32))


def _with_gates(prm, gates):
    """``prm`` with the VLM's cross gates replaced (no copy of the rest)."""
    cross = dict(prm["blocks"]["cross"], **gates)
    return dict(prm, blocks=dict(prm["blocks"], cross=cross))


def _to(tree, dev):
    return ({k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.to(dev))


def phase_decode_vs_forward(sp: ServePath) -> dict:
    """Teacher-forced decode against forward at full width in float32, on
    the card, at every layer, beside the forward's own spread under a
    one-ulp change of its input (each embedding row scaled by 1 + 2**-23);
    and the first steps
    of the first ``cpu_groups`` groups (and ``CPU_ENCODER_LAYERS`` of
    whisper's encoder), at full width, on the card against the same on the
    CPU.  whisper and the VLM decode with frames or patches drawn from
    numpy, which ``init_cache`` projects into the cross caches (through the
    encoder, for whisper), and the VLM's cross gates set to seeded non-zero
    values on both sides (C.15; printed under ``overrides``)."""
    import dataclasses
    from repro_torch.device import full_f32
    overrides = dict(DECODE_OVERRIDES.get(sp.cfg.family, {}))
    cfg = dataclasses.replace(sp.cfg, dtype="float32", **overrides)
    b, s, cpu_steps = 2, 16, 4
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (b, s)))
    modality = _modality(cfg, b, 17)
    prm = sp.prm
    if cfg.family == "vlm":
        g = np.random.default_rng(GATE_SEED).uniform(0.5, 1.5, (2, cfg.num_groups))
        gates = {"gate_attn": g[0], "gate_mlp": -g[1]}
        overrides["cross_gates"] = {k: [float(x) for x in v]
                                    for k, v in gates.items()}
        prm = _with_gates(prm, {k: torch.from_numpy(v.astype(np.float32)).to(CARD)
                                for k, v in gates.items()})

    def decode(c, prm, toks, mod, steps):
        cache = sp.decode.init_cache(c, prm, b, s + 4, modality=mod)
        return torch.cat([sp.decode.serve_step(c, prm, cache, toks[:, i:i + 1],
                                               i)[0] for i in range(steps)],
                         dim=1).cpu()

    def forward(c, prm):
        with full_f32():
            return sp.transformer.forward(c, prm, toks, modality=mod)[0].cpu()

    toks = tokens.to(CARD)
    mod = None if modality is None else modality.to(CARD)
    card = decode(cfg, prm, toks, mod, s)
    full = forward(cfg, prm)
    ulp = forward(cfg, dict(prm, embed=prm["embed"] * (1 + 2 ** -23)))
    spread = float((ulp - full).abs().max())
    del ulp
    cut = dataclasses.replace(cfg, num_layers=sp.cpu_groups * cfg.group_size)
    cut_prm = _first(prm, "blocks", cut.num_groups)
    if cfg.family == "audio":
        cut = dataclasses.replace(cut, encoder_layers=CPU_ENCODER_LAYERS)
        cut_prm = _first(cut_prm, "encoder", CPU_ENCODER_LAYERS)
    cut_card = decode(cut, cut_prm, toks, mod, cpu_steps)
    cut_cpu = decode(cut, _to(cut_prm, "cpu"), tokens, modality, cpu_steps)
    torch.cuda.empty_cache()
    for label, got in (("decode", card), ("forward", full),
                       ("card, cut", cut_card), ("cpu, cut", cut_cpu)):
        _check(got.shape[0] == b and got.shape[2] == cfg.vocab_size
               and bool(torch.isfinite(got).all()), f"{label}: shape or finite")
    per_pos = (card - full).abs().amax(dim=(0, 2))
    vs_cpu = float((cut_card - cut_cpu).abs().max())
    reduced = list(sp.depth_cut)
    if cut.num_layers < cfg.num_layers:
        enc = (f", {cut.encoder_layers} of {cfg.encoder_layers} encoder layers"
               if cfg.family == "audio" else "")
        reduced.append(f"card vs cpu: {sp.cpu_groups} of {cfg.num_groups} "
                       f"groups, {cut.num_layers} of {cfg.num_layers} layers"
                       f"{enc} (host memory)")
    row = {"arch": sp.arch, "batch": b, "tokens": s, "dtype": "float32",
           "modality": None if modality is None else list(modality.shape),
           "max_abs_decode_vs_forward": float(per_pos.max()),
           "per_position": [float(x) for x in per_pos],
           "forward_spread_one_ulp_input": spread,
           "max_abs_card_vs_cpu_first_steps": vs_cpu, "cpu_steps": cpu_steps,
           "cpu_groups": sp.cpu_groups, "cpu_layers": cut.num_layers,
           "layers": cfg.num_layers, "overrides": overrides,
           "reduced": reduced,
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


def _reference_cache_bytes(sp: ServePath, cfg, batch: int, max_len: int):
    """The reference's cache bytes at init and after its first step, from
    the cache's shapes: every leaf in the model dtype at init; the recurrent
    states its step returns in float32 (RWKV6's ``wkv``, Mamba's ``h``)
    float32 after (``src/repro/models/decode.py``)."""
    shapes, es = [], torch.finfo(getattr(torch, cfg.dtype)).bits // 8

    def walk(tree, key=""):
        if isinstance(tree, tuple):
            shapes.append((key, int(np.prod(tree))))
        else:
            for k, v in tree.items():
                walk(v, k)
    walk(sp.decode.cache_shapes(cfg, batch, max_len))
    init = sum(n for _, n in shapes) * es
    return [init, init + sum(n * (4 - es) for k, n in shapes
                             if k in ("wkv", "h"))]


def phase_serve(sp: ServePath) -> dict:
    """The engine on the full bf16 config: a checked run (every logit
    finite), a timed run, a run under the profiler for the device time, and
    a run with the layer profiler.  The weights are cast to bf16 in place
    first; the peak memory is taken from there on."""
    from torch.profiler import ProfilerActivity, profile
    cfg, slots, requests, prompt, gen, mean = sp.cfg, 4, 8, 8, 16, 0.5
    max_len = (prompt + gen) * requests + 8          # the CLI's, for spread arrivals
    prm = sp.params.cast_params(sp.prm, cfg.dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()   # weights + earlier phases' tensors
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

    # 1. checked: every step's logits finite, every request finished; the
    # cache's bytes at init and after the first step (RWKV6's wkv state and
    # Mamba's h are float32 from then on, ROADMAP.md C.13, C.14) against the
    # reference's layout
    eng = engine(spans=sp.SpanTracer())
    step, nonfinite = eng._step, []
    cache_bytes = [sp.decode.cache_num_bytes(eng.cache)]

    def checked(*args):
        logits, cache = step(*args)
        if not bool(torch.isfinite(logits).all()):
            nonfinite.append(eng.steps)
        if len(cache_bytes) == 1:
            cache_bytes.append(sp.decode.cache_num_bytes(cache))
        return logits, cache
    eng._step = checked
    run(eng)
    finished(eng, "checked run")
    _check(not nonfinite, f"non-finite logits at steps {nonfinite[:5]}")
    layout = _reference_cache_bytes(sp, cfg, slots, max_len)
    _check(cache_bytes == layout, f"cache bytes {cache_bytes} at init and "
                                  f"after step 1, the reference's {layout}")

    # 2. timed, with metrics and spans (the CLI's instruments)
    reg, tracer = sp.MetricsRegistry(), sp.SpanTracer()
    eng = engine(metrics=reg, spans=tracer)
    wall = run(eng)
    finished(eng, "timed run")
    problems = sp.spans.validate(tracer.events, slots=slots, engine_steps=eng.steps)
    _check(problems == [], f"spans.validate: {problems[:3]}")
    step_us = [e.dur_us for e in tracer.events if e.kind == sp.spans.STEP]
    ntok = sum(len(r.out) for r in eng.done)
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

    # 4. the layer profiler: per-operator walls, and the join; the reference
    # slices neither audio nor vlm (its PROFILED_FAMILIES)
    reduced = list(sp.depth_cut)
    op_mean_us, layer_steps = None, None
    if cfg.family in sp.decode.PROFILED_FAMILIES:
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
        ops = dict.fromkeys(op for op, _ in sp.decode.profile_ops(cfg))
        op_mean_us = {op: statistics.fmean(by_op[op]) for op in ops}
        layer_steps = eng.steps
        sp.layer_records = layers.records
    else:
        reduced.append(f"no layer-profiled run: the reference's "
                       f"PROFILED_FAMILIES leave out {cfg.family!r}")

    # 5. the cross caches filled from a modality (bf16, 4 slots): whisper's
    # encoder over its frames and a cross fill a layer, or the VLM's cross
    # fill a group over its patches; the engine itself serves them zeroed
    modality = None
    mod = _modality(cfg, slots, 18)
    if mod is not None:
        mod = mod.to(CARD, getattr(torch, cfg.dtype))

        def fill():
            return sp.decode.init_cache(cfg, prm, slots, max_len, modality=mod)
        fill()                                                  # warm
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            filled = fill()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        fill_device_ms, fill_kernels = _device_profile(fill, iters=2)
        cross = filled["lyr"]["cross"] if cfg.family == "audio" else filled["cross"]
        _check(all(bool(torch.isfinite(t).all()) and bool(t.any())
                   for t in cross.values()), "cross caches: finite, filled")
        _check(sp.decode.cache_num_bytes(filled) == layout[0],
               "filled cache bytes differ from the reference's layout")
        modality = {
            "shape": list(mod.shape), "dtype": cfg.dtype, "slots": slots,
            "wall_ms_median": statistics.median(walls) * 1e3,
            "device_ms": fill_device_ms,
            "device_kernels_top": {k[:60]: v for k, v in
                                   list(fill_kernels.items())[:4]},
            "work": (f"encoder over {cfg.encoder_seq} frames, "
                     f"{cfg.encoder_layers} layers, and {cfg.num_groups} "
                     f"cross fills" if cfg.family == "audio" else
                     f"{cfg.num_groups} cross fills over "
                     f"{cfg.num_patches} patches"),
            "cross_bytes": sp.decode.cache_num_bytes(cross)}
        del filled, cross, mod
    row = {
        "arch": sp.arch, "dtype": cfg.dtype, "slots": slots,
        "requests": requests, "prompt": prompt, "gen": gen, "arrival_mean": mean,
        "max_len": max_len, "finished": requests, "tokens": ntok,
        "wall_s": wall, "tokens_per_s": ntok / wall, "engine_steps": steps,
        "step_wall_ms_median": statistics.median(step_us) / 1e3,
        "step_wall_ms_mean": mean_step_ms,
        "step_device_ms": device_ms_step,
        "device_busy_share": device_ms_step / mean_step_ms,
        "device_events_per_step": sum(counts.values()) / steps,
        "device_kernels_top": {k[:60]: v / steps for k, v in sorted(
            device.items(), key=lambda kv: -kv[1])[:6]},
        "cache_bytes_init": cache_bytes[0],
        "cache_bytes_after_first_step": cache_bytes[-1],
        "param_bytes": param_bytes, "params": sp.n_params, "draw_s": sp.draw_s,
        "memory_allocated_at_start": at_start,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "op_mean_us": op_mean_us,
        "modality": modality,
        "layers": cfg.num_layers, "reduced": reduced,
        "layer_steps": layer_steps,
        "card": _card_name_and_limit(),
    }
    print(json.dumps({"serve": row}))
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
    row = {"arch": f"{sp.arch} reduced", "dtype": cfg.dtype, "slots": slots,
           "requests": requests, "plan": plan.counts(),
           "faults_injected": eng.faults_injected,
           "faults_detected": eng.faults_detected, "retries": eng.retries,
           "reasons": reasons, "engine_steps": eng.steps,
           "span_events": len(streams[0].splitlines()), "identical": True}
    print(json.dumps({"serve_chaos": row}))
    return row


# -- the training path ----------------------------------------------------------

TRAIN_ARCH = "qwen2-0.5b"
# examples/train_lm.py's AdamW; total_steps is each phase's own
TRAIN_OPT = dict(lr=3e-3, warmup_steps=2, weight_decay=0.01)
# tests/test_torch_trainer.py's GRAD_TOL: both packages' float32 gradients
# sit up to 1e-3 of a leaf's largest magnitude from a float64 evaluation
TRAIN_GRAD_TOL = 2e-3
TRAIN_LOSS_RTOL = 1e-4       # one float32 loss over 24 layers, two devices
TRAIN_UPDATE_TOL = 2e-5      # params, m, v after one update, card vs CPU
RESTART_LAYERS = 4           # a full-depth float32 state is ~6 GB a save
TIMED = dict(batch=8, seq=1024, steps=12, untimed=2)
TRAIN_CKPT = ROOT / "build" / "chip_smoke_train"    # ignored by git


def _train_modules():
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import get_config, params
    from repro_torch.optim import adamw
    from repro_torch.runtime import trainer
    return DataConfig, SyntheticLM, steps, get_config, params, adamw, trainer


def _keys(tree, prefix: str = "") -> List[str]:
    """The leaves' paths of a dict tree in sorted-key order (``adamw.leaves``'s)."""
    if isinstance(tree, dict):
        return [k for name in sorted(tree) for k in _keys(tree[name], f"{prefix}/{name}")]
    return [prefix]


def _leaf_excess(got: List[torch.Tensor], want: List[torch.Tensor],
                 keys: Optional[List[str]] = None):
    """(max |got - want| over leaves, the largest of each leaf's max |got -
    want| over its largest |want|, that leaf's key)."""
    worst_abs, worst_rel, worst_key = 0.0, 0.0, None
    for i, (g, w) in enumerate(zip(got, want)):
        d = float((g.float().cpu() - w.float().cpu()).abs().max())
        rel = d / max(float(w.float().abs().max()), 1e-30)
        worst_abs = max(worst_abs, d)
        if rel > worst_rel:
            worst_rel, worst_key = rel, keys[i] if keys else i
    return worst_abs, worst_rel, worst_key


def phase_train_vs_cpu() -> dict:
    """(a) One train step's loss and gradients at full width and depth in
    float32 on the card against the CPU, then one AdamW update on each from
    the same (CPU) gradients."""
    import dataclasses
    from repro_torch.device import full_f32
    DataConfig, SyntheticLM, steps, get_config, params, adamw, _ = _train_modules()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(
        DataConfig(cfg.vocab_size, 64, 2), model_cfg=cfg).batch(0).items()}
    prm = params.stream_params(cfg, SERVE_SEED, CARD, "float32")
    cpu_prm = _to(prm, "cpu")
    with full_f32():
        t0 = time.perf_counter()
        card_m, card_g = steps.grad_of(cfg, prm, _to(batch, CARD))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_m, cpu_g = steps.grad_of(cfg, cpu_prm, batch)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(float(card_m["loss"]) - float(cpu_m["loss"])) / abs(float(cpu_m["loss"]))
    grad_abs, grad_rel, grad_leaf = _leaf_excess(card_g, cpu_g, _keys(cpu_prm))
    finite = all(bool(torch.isfinite(g).all()) for g in card_g)
    del card_g

    opt = adamw.AdamWConfig(total_steps=TIMED["steps"], **TRAIN_OPT)
    it = iter(cpu_g)
    g_tree = adamw.tree_map(lambda _: next(it), cpu_prm)
    cpu_new = adamw.apply_updates(opt, cpu_prm, g_tree, adamw.init_state(cpu_prm))
    card_new = adamw.apply_updates(opt, prm, _to(g_tree, CARD), adamw.init_state(prm))
    update = {}
    for name, pick in (("params", lambda r: r[0]), ("m", lambda r: r[1].m),
                       ("v", lambda r: r[1].v)):
        update[name] = _leaf_excess(adamw.leaves(pick(card_new)),
                                    adamw.leaves(pick(cpu_new)))[0]
    lr = [float(r[2]["lr"]) for r in (card_new, cpu_new)]
    gn = [float(r[2]["grad_norm"]) for r in (card_new, cpu_new)]
    del prm, card_new
    torch.cuda.empty_cache()
    row = {"arch": TRAIN_ARCH, "dtype": "float32", "layers": cfg.num_layers,
           "batch": [2, 64], "params": params.count_params(cfg),
           "loss_card": float(card_m["loss"]), "loss_cpu": float(cpu_m["loss"]),
           "loss_rel_diff": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
           "grad_max_abs_diff": grad_abs, "grad_max_leaf_rel_diff": grad_rel,
           "grad_worst_leaf": grad_leaf,
           "grad_tol_of_leaf_max": TRAIN_GRAD_TOL,
           "update_max_abs_diff": update, "update_tol": TRAIN_UPDATE_TOL,
           "lr": lr, "grad_norm": gn,
           "grad_seconds": {"card": card_s, "cpu": cpu_s}}
    _check(finite, "card gradients not finite")
    _check(loss_rel <= TRAIN_LOSS_RTOL, f"train loss card vs cpu: {loss_rel:.3g}")
    _check(grad_rel <= TRAIN_GRAD_TOL, f"gradients card vs cpu: {grad_rel:.3g}")
    _check(max(update.values()) <= TRAIN_UPDATE_TOL, f"update card vs cpu: {update}")
    return row


def _bits_twice(fn) -> bool:
    """Two calls of ``fn`` (a list of tensors) give the same bits."""
    first = [t.clone() for t in fn()]
    second = fn()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def phase_atomics() -> dict:
    """Do the training path's scatter-adds give the same bits twice on the
    card?  The backward of the embedding lookup (qwen2-0.5b's 151,936 x
    896 table, 8 x 64 tokens) as indexing (the reference's form) and as
    ``F.embedding`` (the port's, ``models/common.embed``), of
    ``take_along_dim`` in ``chunked_ce`` (a (8, 64, 151,936) float32
    log-softmax), and the MoE dispatch's ``index_add_`` with its
    ``index_select``'s backward (olmoe-1b-7b's layer: 64 experts of 2048 ->
    1024, top 8, 512 tokens, weights from a seeded card generator)."""
    import dataclasses
    from repro_torch.models import get_config, params
    from repro_torch.models import moe as MOE
    gen = torch.Generator(device=CARD).manual_seed(SERVE_SEED)
    cfg = get_config(TRAIN_ARCH)
    tokens = torch.randint(0, cfg.vocab_size, (8, 64), device=CARD, generator=gen)
    table = torch.randn(cfg.vocab_size, cfg.d_model, device=CARD, generator=gen,
                        requires_grad=True)
    g_emb = torch.randn(8, 64, cfg.d_model, device=CARD, generator=gen)
    lp = torch.randn(8, 64, cfg.vocab_size, device=CARD, generator=gen,
                     requires_grad=True)
    g_nll = torch.randn(8, 64, 1, device=CARD, generator=gen)
    mcfg = dataclasses.replace(get_config("olmoe-1b-7b"), dtype="float32")
    d, e = mcfg.d_model, mcfg.num_experts
    p = {"router": torch.randn(d, e, device=CARD, generator=gen) / d ** 0.5}
    for k, (shape, _) in params.moe_shapes(mcfg).items():
        if k != "router":
            p[k] = (torch.randn(*shape, device=CARD, generator=gen)
                    / shape[1] ** 0.5).requires_grad_(True)
    x = torch.randn(8, 64, d, device=CARD, generator=gen, requires_grad=True)
    g_y = torch.randn(8, 64, d, device=CARD, generator=gen)

    def moe():
        y, _ = MOE.moe_block(mcfg, p, x)
        return [y, *torch.autograd.grad(y, [x, p["w1"], p["w2"]], g_y)]
    row = {
        "embed_index_backward": _bits_twice(
            lambda: torch.autograd.grad(table[tokens], table, g_emb)),
        "embedding_backward": _bits_twice(
            lambda: torch.autograd.grad(torch.nn.functional.embedding(
                tokens, table), table, g_emb)),
        "take_along_dim_backward": _bits_twice(
            lambda: torch.autograd.grad(torch.take_along_dim(
                lp, tokens[..., None], dim=-1), lp, g_nll)),
        "moe_index_add": _bits_twice(moe)}
    del table, lp, p, x
    torch.cuda.empty_cache()
    return row


def phase_train_restart() -> dict:
    """(b) ``run_with_restarts`` at full width, float32, 4 of the 24 layers:
    8 steps of 8 x 64, a checkpoint every 4, a ``WorkerFailure`` at step 5;
    the run resumes at 4 and its steps 6-7 equal an unfailed run's at
    ``rel=1e-4``; the unfailed run's last checkpoint, saved from the card,
    restores on the CPU with its bits."""
    import dataclasses
    import shutil
    DataConfig, _, _, get_config, params, adamw, trainer = _train_modules()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32",
                              num_layers=RESTART_LAYERS)
    steps = 8

    def run(name, hook=None):
        tr = trainer.Trainer(
            cfg, trainer.TrainerConfig(total_steps=steps, checkpoint_every=4,
                                       checkpoint_dir=str(TRAIN_CKPT / name),
                                       max_restarts=2),
            opt_cfg=adamw.AdamWConfig(total_steps=steps, **TRAIN_OPT),
            data_cfg=DataConfig(cfg.vocab_size, 64, 8), failure_hook=hook,
            device=CARD)
        t0 = time.perf_counter()
        state = tr.run_with_restarts()
        torch.cuda.synchronize()
        return tr, state, time.perf_counter() - t0

    fired = []

    def fail_once(step):
        if step == 5 and not fired:
            fired.append(step)
            raise trainer.WorkerFailure("injected at step 5")

    try:
        base, state, base_s = run("base")
        failed, _, failed_s = run("failed", fail_once)
        resumes = [h for h in failed.history if "restart" in h]
        want = {h["step"]: h["loss"] for h in base.history if "step" in h}
        got = {h["step"]: h["loss"] for h in failed.history if "step" in h}
        host = lambda t: torch.empty(t.shape, dtype=t.dtype)     # noqa: E731
        like = {"params": adamw.tree_map(host, state["params"]),
                "opt": adamw.OptState(host(state["opt"].step),
                                      adamw.tree_map(host, state["opt"].m),
                                      adamw.tree_map(host, state["opt"].v))}
        back, at = base.ckpt.restore(like)
        same = [torch.equal(a, b.cpu()) for a, b in zip(
            adamw.leaves(back["params"]) + adamw.leaves(back["opt"].m)
            + adamw.leaves(back["opt"].v) + [back["opt"].step],
            adamw.leaves(state["params"]) + adamw.leaves(state["opt"].m)
            + adamw.leaves(state["opt"].v) + [state["opt"].step])]
        ckpt_bytes = (base.ckpt.dir / f"step_{at:08d}" / "arrays.npz").stat().st_size
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    del state
    torch.cuda.empty_cache()
    row = {"arch": TRAIN_ARCH, "dtype": "float32", "layers": cfg.num_layers,
           "batch": [8, 64], "steps": steps, "checkpoint_every": 4,
           "failure_at": 5, "resumes": resumes,
           "losses": [want[s] for s in range(steps)],
           "replayed_losses": [got[s] for s in range(4, steps)],
           "steps_6_7_within_rel_1e-4": all(
               abs(got[s] - want[s]) <= 1e-4 * abs(want[s]) for s in (6, 7)),
           "bitwise_equal_steps_4_7": all(got[s] == want[s] for s in range(4, steps)),
           "restored_on_cpu_bitwise": all(same), "restored_step": at,
           "checkpoint_bytes": ckpt_bytes,
           "wall_s": {"unfailed": base_s, "failed": failed_s},
           "reduced": [f"depth: {cfg.num_layers} of 24 layers (a float32 "
                       f"state of all 24 is ~6 GB a save; full width)"]}
    _check(resumes == [{"restart": 1, "resume_step": 4}], f"resumes {resumes}")
    _check(row["steps_6_7_within_rel_1e-4"], f"replay {row['replayed_losses']} "
                                             f"vs {row['losses'][4:]}")
    _check(row["restored_on_cpu_bitwise"], "card checkpoint restored on the "
                                           "CPU with other bits")
    return row


def _kernel_class(name: str) -> str:
    """A device kernel's class by its name: cuBLAS products with float32
    inputs (``f32f32``) and the others (``nvjet`` is cuBLASLt's Hopper
    family), reductions, copies, elementwise, other."""
    low = name.lower()
    if any(w in low for w in ("gemm", "xmma", "cutlass", "sm90_", "nvjet")):
        return "gemm_f32" if "f32f32_f32f32" in low else "gemm_other"
    if "reduce" in low or "softmax" in low or "norm" in low:
        return "reduce"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def _range_ms(prof, prefix: str) -> dict:
    """Device ms of the profiler's user ranges named ``prefix*`` (the spans
    it draws on the device timeline for a CPU ``record_function``), or {}
    when it drew none."""
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.key.startswith(prefix):
            out[ev.key] = out.get(ev.key, 0.0) + ev.time_range.elapsed_us() / 1e3
    return out


def phase_train_timed() -> dict:
    """(c) The registered bfloat16 config at full width and depth (remat as
    registered), ``Trainer.run_with_restarts`` for 12 steps of 8 x 1024
    tokens with ``examples/train_lm.py``'s AdamW, the first 2 steps not
    timed; then 2 steps under the profiler, the optimizer alone under the
    profiler, and one step with remat off for its peak memory."""
    import dataclasses
    import shutil
    from torch.profiler import ProfilerActivity, profile
    DataConfig, _, steps_mod, get_config, params, adamw, trainer = _train_modules()
    cfg = get_config(TRAIN_ARCH)
    b, s, n, untimed = TIMED["batch"], TIMED["seq"], TIMED["steps"], TIMED["untimed"]
    opt = adamw.AdamWConfig(total_steps=n, **TRAIN_OPT)
    tr = trainer.Trainer(cfg, trainer.TrainerConfig(
        total_steps=n, checkpoint_every=n, checkpoint_dir=str(TRAIN_CKPT / "timed"),
        max_restarts=0), opt_cfg=opt, data_cfg=DataConfig(cfg.vocab_size, s, b),
        device=CARD)
    saves, save = [], tr.ckpt.save

    def timed_save(step, state, blocking=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(step, state, blocking=True)
        saves.append((step, time.perf_counter() - t0))
    tr.ckpt.save = timed_save
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        state = tr.run_with_restarts()
        run_s = time.perf_counter() - t0
        peak_remat = torch.cuda.max_memory_allocated()
        ckpt_bytes = (tr.ckpt.dir / f"step_{n:08d}" / "arrays.npz").stat().st_size
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    hist = [h for h in tr.history if "step" in h]
    losses = [h["loss"] for h in hist]
    walls = [h["step_time_s"] for h in hist[untimed:]]
    tokens = b * s

    # 2 steps under the profiler: device time, events, busy share, ranges
    batch = tr.batch(n)

    def step():
        _, m = tr.step_fn(state, batch)
        return float(m["loss"])
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) / 2
    counts = {}
    device = {k: v for k, v in _device_events(prof, counts).items()
              if not k.startswith("train_step.")}
    ranges = {k: v / 2 for k, v in _range_ms(prof, "train_step.").items()}
    step_device_ms = sum(device.values()) / 2
    events = sum(c for k, c in counts.items() if not k.startswith("train_step.")) / 2
    by_class = {}
    for k, v in device.items():
        by_class[_kernel_class(k)] = by_class.get(_kernel_class(k), 0.0) + v / 2

    # the optimizer alone, on one step's gradients
    _, grads = steps_mod.grad_of(cfg, state["params"], batch)
    it = iter(grads)
    g_tree = adamw.tree_map(lambda _: next(it), state["params"])
    opt_ms, opt_kernels = _device_profile(
        lambda: adamw.apply_updates_(opt, state["params"], g_tree, state["opt"]),
        iters=2)
    del grads, g_tree

    # one step with remat off
    off = steps_mod.make_train_step(dataclasses.replace(cfg, remat=False), opt)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m_off = off(state, batch)
    loss_off = float(m_off["loss"])
    off_wall = time.perf_counter() - t0
    peak_off = torch.cuda.max_memory_allocated()
    n_params = params.count_params(cfg)
    flops = 6 * n_params * tokens
    del state
    torch.cuda.empty_cache()
    row = {"arch": TRAIN_ARCH, "dtype": cfg.dtype, "remat": cfg.remat,
           "layers": cfg.num_layers, "params": n_params,
           "batch": [b, s], "tokens_per_step": tokens, "steps": n,
           "untimed_steps": untimed, "losses": losses,
           "tokens_per_s": tokens * len(walls) / sum(walls),
           "step_wall_ms_median": statistics.median(walls) * 1e3,
           "step_wall_ms": [w * 1e3 for w in walls],
           "run_wall_s": run_s,
           "profiled_step_wall_ms": prof_wall * 1e3,
           "step_device_ms": step_device_ms,
           "device_busy_share": step_device_ms / (statistics.median(walls) * 1e3),
           "device_events_per_step": events,
           "device_kernels_top": {k[:60]: v / 2 for k, v in sorted(
               device.items(), key=lambda kv: -kv[1])[:8]},
           "device_ms_by_class": by_class,
           "optimizer_device_ms": opt_ms,
           "optimizer_share_of_step": opt_ms / step_device_ms,
           "grads_device_ms": step_device_ms - opt_ms,
           "optimizer_kernels_top": {k[:60]: v for k, v in
                                     list(opt_kernels.items())[:4]},
           "ranges_device_ms": ranges,
           "peak_allocated_remat_on": peak_remat,
           "peak_allocated_remat_off": peak_off,
           "remat_off_step_wall_ms": off_wall * 1e3, "remat_off_loss": loss_off,
           "final_save_s": saves[-1][1] if saves else None,
           "final_save_step": saves[-1][0] if saves else None,
           "checkpoint_bytes": ckpt_bytes,
           "model_flops_per_step": flops,
           "mfu_device_989": flops / (step_device_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "mfu_wall_989": flops / statistics.median(walls) / PEAK_FLOPS[torch.bfloat16],
           "card": _card_name_and_limit()}
    _check(all(np.isfinite(losses)) and np.isfinite(loss_off), f"losses {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses[0]} -> {losses[-1]}")
    _check(len(saves) == 1 and saves[0][0] == n, f"saves {saves}")
    return row


def phase_train_example() -> dict:
    """(d) ``examples/train_lm_torch.py`` on the card: a failure injected at
    step 6 of 14, one restart, and ``OK``."""
    import shutil
    args = ["--steps", "14", "--inject-failure", "6", "--batch", "4", "--seq", "32"]
    try:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"), *args,
             "--ckpt-dir", str(TRAIN_CKPT / "example")],
            capture_output=True, text=True, timeout=600, cwd=str(ROOT),
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    lines = r.stdout.strip().splitlines()
    summary = next((line for line in lines if line.startswith("arch=")), "")
    row = {"args": args, "returncode": r.returncode, "summary": summary,
           "last_line": lines[-1] if lines else "", "wall_s": wall}
    _check(r.returncode == 0, f"train_lm_torch.py: {r.stderr[-1000:]}")
    _check("restarts=1" in summary and row["last_line"] == "OK",
           f"train_lm_torch.py printed {lines[-3:]}")
    return row


# -- the launch layer: op analysis, dry run, compiler examples ---------------

ANALYSIS_ARCH = "qwen2-0.5b"
ANALYSIS_AT = dict(batch=4, cache_len=200)      # the serve phase's slots, cache
OFFLOAD_AT = dict(batch=1, cache_len=4096)      # tests/test_modelprof.py's
# the dry run's cells on the production meshes; llama-3.2-vision-11b
# prefill_32k is left out: its step dispatches ~5.5M ops (the port's Python
# attention loop over 2,080 kv blocks a layer at 32k tokens, PERF.md §6),
# several minutes alone
DRYRUN_CELLS = (("qwen2-7b", "train_4k", "pod16x16"),
                ("gemma2-27b", "train_4k", "pod2x16x16"),
                ("olmoe-1b-7b", "decode_32k", "pod16x16"),
                ("zamba2-7b", "long_500k", "pod16x16"),
                ("qwen2-0.5b", "train_4k", "pod16x16"))
# gemma2-27b's cell, the longest, runs in a process of its own beside the
# others', so the cells end within the draw they run beside
DRYRUN_ALONE = (("gemma2-27b", "train_4k", "pod2x16x16"),)
DRYRUN_BESIDE = "llama-3.2-vision-11b"     # beside its weight draw
DRYRUN_OUT = ROOT / "build" / "chip_smoke_dryrun"     # ignored by git
DRYRUN_TIMEOUT = 480
# the microbatched train step on the mesh, in a second process; the first
# runs the same cell at one microbatch
DRYRUN_MB = 4
DRYRUN_MB_CELLS = (("qwen2-0.5b", "train_4k", "pod16x16"),)
DRYRUN_MB_OUT = ROOT / "build" / "chip_smoke_dryrun_mb"
MB_FLOPS_RTOL = 0.01
REPORT_OUT = "build/chip_smoke_experiments.md"       # relative to ROOT
EXAMPLES_OUT = ROOT / "build" / "chip_smoke_examples"


def phase_op_analysis(sp: ServePath) -> dict:
    """``modelprof.crosscheck`` on the full-width bf16 serve step at the
    serve phase's 4 slots and cache 200: the op counter's FLOPs and bytes
    against the analytic model (FLOPs within ``FLOPS_RTOL``, bytes within a
    factor ``BYTES_FACTOR``), no collective on one card; and the offload
    ranking of the serve phase's layer records under the analytic costs at
    batch 1, cache 4096 and the H100's peaks."""
    mpf, cfg = sp.modelprof, sp.cfg
    t0 = time.perf_counter()
    report, problems = mpf.crosscheck(cfg, device=CARD, params=sp.prm,
                                      **ANALYSIS_AT)
    run_s = time.perf_counter() - t0
    _check(problems == [], f"crosscheck: {problems}")
    _check(report["collective_bytes"] == 0,
           f"collective bytes on one card: {report['collective_bytes']}")
    peaks = mpf.device_peaks()
    rows = mpf.offload_report(cfg, sp.layer_records,
                              mpf.analytic_op_costs(cfg, **OFFLOAD_AT), peaks)
    _check(rows and [r["rank"] for r in rows] == list(range(1, len(rows) + 1)),
           "offload report: no ranked rows")
    row = {"arch": sp.arch, "dtype": cfg.dtype, **ANALYSIS_AT, **report,
           "flops_rtol": mpf.FLOPS_RTOL, "bytes_factor": mpf.BYTES_FACTOR,
           "run_s": run_s, "offload_at": OFFLOAD_AT, "peaks": list(peaks),
           "offload": rows, "card": _card_name_and_limit()}
    print(json.dumps({"analysis": row}))
    return row


def start_dryrun(cells=DRYRUN_CELLS, out: Path = DRYRUN_OUT,
                 microbatches: int = 1) -> subprocess.Popen:
    """Start ``python -m repro_torch.launch.dryrun --device cuda`` over
    ``cells`` in a process of its own (the fake process group owns it), on
    the host's CPU beside a weight draw, which times nothing."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
           CARD, "--force", "--out", str(out)]
    cmd += [f"--cell={a}:{s}:{m}" for a, s, m in cells]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(ROOT),
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                                 "REPRO_MICROBATCH": str(microbatches)})
    proc.started = time.time()
    proc.cells, proc.out = cells, out
    return proc


def _dryrun_row(rec: dict, proc, draw_end: float, waited: float,
                wall: float, card: str) -> dict:
    roof = rec["roofline"]
    return {"arch": rec["arch"], "shape": rec["shape"],
            "mesh": rec["mesh"], "chips": rec["chips"],
            "microbatches": rec["microbatches"],
            "arg_bytes_per_device": rec["arg_bytes_per_device"],
            "peak_live_bytes_per_device":
                rec["memory_analysis"]["peak_live_bytes"],
            "flops_per_device": rec["hlo_cost"]["flops"],
            "bytes_per_device": rec["hlo_cost"]["traffic_bytes"],
            "collective_bytes_per_device": rec["collectives"]["bytes_by_kind"],
            "collective_ops": rec["collectives"]["count_by_kind"],
            "model_flops": rec["model_flops"],
            "dominant": roof["dominant"],
            "roofline_frac": roof["roofline_frac"],
            "useful_flops_frac": roof["useful_flops_frac"],
            "ops": rec["hlo_bytes"], "run_s": rec["run_s"],
            "process_s": wall, "draw_s": draw_end - proc.started,
            "waited_s": waited, "card": card}


def phase_dryrun(procs: List[subprocess.Popen], draw_end: float) -> List[dict]:
    """Wait for the dry-run processes, right after the draw they ran beside
    and before any timed phase: every cell ``ok``, the expert-parallel
    cell's all-reduce among its collectives, the microbatched cell's dot
    FLOPs a device within ``MB_FLOPS_RTOL`` of the same cell's at one
    microbatch and its peak of live bytes lower; one ``dryrun`` line a
    cell, with the seconds from its process's start to its last record
    (``process_s``) and to the draw's end (``draw_s``), and the script's
    wait for it (``waited_s``).  The records stay for ``dry-run report``."""
    card = _card_name_and_limit()
    rows = []
    for proc in procs:
        try:
            left = DRYRUN_TIMEOUT - (time.time() - proc.started)
            out, err = proc.communicate(timeout=max(left, 1.0))
        finally:
            proc.kill()
            proc.wait()
        waited = time.time() - draw_end
        _check(proc.returncode == 0, f"dryrun exited {proc.returncode}: "
                                     f"{out[-800:]} {err[-1500:]}")
        paths = [proc.out / f"{a}__{s}__{m}.json" for a, s, m in proc.cells]
        paths = [p for p in paths if p.exists()]
        _check(len(paths) == len(proc.cells), f"{len(paths)} dry-run records")
        wall = max(p.stat().st_mtime for p in paths) - proc.started
        for p in paths:
            rec = json.loads(p.read_text())
            _check(rec["status"] == "ok", f"{rec['arch']} {rec['shape']}: "
                                          f"{rec.get('error')}")
            row = _dryrun_row(rec, proc, draw_end, waited, wall, card)
            print(json.dumps({"dryrun": row}))
            rows.append(row)
    moe = [r for r in rows if r["arch"] == "olmoe-1b-7b"]
    _check(all(r["collective_ops"].get("all-reduce", 0) > 0 for r in moe),
           "the expert-parallel cell shows no all-reduce")
    for a, s, m in DRYRUN_MB_CELLS:
        one, many = ([r for r in rows if (r["arch"], r["shape"], r["mesh"])
                      == (a, s, m) and r["microbatches"] == n][0]
                     for n in (1, DRYRUN_MB))
        rel = abs(many["flops_per_device"] / one["flops_per_device"] - 1)
        _check(rel <= MB_FLOPS_RTOL, f"{a} {s}: {DRYRUN_MB} microbatches "
                                     f"count {rel:.2%} other dot FLOPs")
        _check(many["peak_live_bytes_per_device"]
               < one["peak_live_bytes_per_device"],
               f"{a} {s}: {DRYRUN_MB} microbatches hold no fewer live bytes")
    return rows


def phase_dryrun_report() -> dict:
    """The report tooling on the dry run's records: ``fix_artifacts_torch``
    restores the one-microbatch record of ``DRYRUN_MB_CELLS`` bit for bit
    after its ``model_flops`` and ``roofline`` were made stale;
    ``make_report_torch`` lists every record, ``ok``, in its mesh's table;
    ``gen_experiments_torch`` writes ``REPORT_OUT`` from both directories,
    holding every record's row and the microbatched cell's summary line."""
    sys.path.insert(0, str(ROOT))
    from benchmarks import fix_artifacts_torch, make_report_torch
    (DRYRUN_OUT / "host.txt").write_text(
        f"{_card_name_and_limit()}; --device {CARD}; torch {torch.__version__}\n")
    a, s, m = DRYRUN_MB_CELLS[0]
    before = {p: p.read_bytes() for p in DRYRUN_OUT.glob("*.json")}
    path = DRYRUN_OUT / f"{a}__{s}__{m}.json"
    stale = json.loads(before[path])
    stale["model_flops"] = 0.0
    stale["roofline"] = {}
    path.write_text(json.dumps(stale, indent=1))
    fixed = fix_artifacts_torch.fix_dir(DRYRUN_OUT)
    _check(all(p.read_bytes() == b for p, b in before.items()),
           "fix_artifacts_torch did not restore the records bit for bit")
    _check(fixed == len(DRYRUN_CELLS), f"fix_dir fixed {fixed} records")
    base = make_report_torch.load(str(DRYRUN_OUT))
    opt = make_report_torch.load(str(DRYRUN_MB_OUT))
    listed = 0
    for cells, table_of in ((base, make_report_torch.dryrun_table),
                            (opt, make_report_torch.roofline_table)):
        for mesh in ("pod16x16", "pod2x16x16"):
            table = table_of(cells, mesh)
            for (ca, cs, cm) in cells:
                if cm == mesh:
                    _check(f"| {ca} | {cs} |" in table,
                           f"{ca} {cs} missing from the {mesh} table")
                    listed += 1
    _check(listed == len(base) + len(opt), f"{listed} records listed")
    r = subprocess.run([sys.executable, "scripts/gen_experiments_torch.py",
                        "--base", str(DRYRUN_OUT), "--opt", str(DRYRUN_MB_OUT),
                        "--out", REPORT_OUT], capture_output=True, text=True,
                       cwd=str(ROOT), timeout=120)
    _check(r.returncode == 0, f"gen_experiments_torch: {r.stderr[-1500:]}")
    doc = (ROOT / REPORT_OUT).read_text()
    for (ca, cs, cm) in list(base) + list(opt):
        _check(f"| {ca} | {cs} |" in doc, f"{ca} {cs} missing from the document")
    _check(f"* **{a} × {s}**" in doc, f"no summary line for {a} {s}")
    _check("Records taken on: " + _card_name_and_limit() in doc,
           "the document does not name the card")
    row = {"fixed": fixed, "restored": True, "listed": listed,
           "opt_rows": len(opt), "document_lines": len(doc.splitlines()),
           "gen_experiments": r.stdout.strip().splitlines()}
    print(json.dumps({"dryrun_report": row}))
    return row


def phase_compiler_examples() -> dict:
    """The compiler example twins: ``compile_to_calyx_torch.py --model ffnn
    --factor 2 --simulate-rtl`` prints ``matches estimate`` and an oracle
    error (the torch oracle on the card) under the design tolerance;
    ``banking_sweep_torch.py``, a check on the host (it compiles and
    estimates only), prints the paper's sweep."""
    import re
    import shutil
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    EXAMPLES_OUT.mkdir(parents=True, exist_ok=True)
    try:
        r = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "compile_to_calyx_torch.py"),
             "--model", "ffnn", "--factor", "2", "--simulate-rtl",
             "--device", CARD, "--emit-verilog", str(EXAMPLES_OUT / "ffnn_f2.sv"),
             "--out", str(EXAMPLES_OUT / "ffnn_f2.futil")],
            capture_output=True, text=True, timeout=300, cwd=str(ROOT), env=env)
        sweep = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "banking_sweep_torch.py")],
            capture_output=True, text=True, timeout=300, cwd=str(ROOT), env=env)
    finally:
        shutil.rmtree(EXAMPLES_OUT, ignore_errors=True)
    _check(r.returncode == 0, f"compile_to_calyx_torch.py: {r.stderr[-1000:]}")
    rtl = next((line.strip() for line in r.stdout.splitlines()
                if "rtl cycles=" in line), "")
    err = re.search(r"max\|out - oracle\|=([0-9.e+-]+)", rtl)
    _check("(matches estimate)" in rtl and err is not None,
           f"compile_to_calyx_torch.py printed {rtl!r}")
    _check(float(err.group(1)) < DESIGN_TOL,
           f"oracle error {err.group(1)} over {DESIGN_TOL}")
    _check(sweep.returncode == 0 and "speedup 2->4" in sweep.stdout,
           f"banking_sweep_torch.py: {sweep.stderr[-1000:]}")
    row = {"compile_to_calyx": rtl, "oracle_max_abs_err": float(err.group(1)),
           "tolerance": DESIGN_TOL,
           "banking_sweep": sweep.stdout.strip().splitlines()[-2:]}
    print(json.dumps({"compiler_examples": row}))
    return row


COMPILER_OUT = ROOT / "build" / "chip_smoke_compiler"     # ignored by git
COMPILER_SECTIONS = ("paper_tables", "banking_ablation", "calyx_bench")
COMPILER_TIMEOUT = 400
COMPILER_TRIES = 3           # as tests/test_torch_calyx_bench.py
CALYX_CLOCKS = ("compile_us", "verify_us", "sim_wall_us", "trace_wall_us")
VERIFY_OVERHEAD = "FAIL: stage-boundary verifier costs"


def phase_compiler_bench(counters) -> dict:
    """The compiler-side twins on the card, after ``compiler examples``
    and beside nothing (the verifier-overhead gate reads host clocks):
    ``benchmarks/run_torch.py paper_tables banking_ablation calyx_bench
    --device cuda`` in a process of its own (the 48-point matrix's torch
    oracle on the card, the MoE census's calls on the card), then
    ``scripts/check_perf_regression.py --baseline BENCH_calyx.json`` on its
    file, run again (``calyx_bench`` alone, three runs at most) only while
    the gate's one failure is the verifier overhead; every field of the 48
    records but the host clocks and the oracle's error equal to
    ``BENCH_calyx.json``'s, each error within the matrix's 1e-4; banked MoE
    dispatch reading fewer slices than gather; ``verify_matrix_torch.py``
    and ``lint_design_torch.py --model ffnn --factor 4 --profile`` exit 0;
    every kernel count still 0 (their oracle is plain torch).  One
    JSON ``compiler_bench`` line."""
    import re
    import shutil
    _zero_counts(counters)
    t_phase = time.perf_counter()
    shutil.rmtree(COMPILER_OUT, ignore_errors=True)
    COMPILER_OUT.mkdir(parents=True)
    out = COMPILER_OUT / "BENCH_calyx_torch.json"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
           "CALYX_BENCH_OUT": str(out), "CALYX_BENCH_DESIGNS": ""}
    sections, runs, csv = COMPILER_SECTIONS, [], {}
    for attempt in range(1, COMPILER_TRIES + 1):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "benchmarks" / "run_torch.py"),
                            *sections, "--device", CARD], capture_output=True, text=True,
                           timeout=COMPILER_TIMEOUT, cwd=str(ROOT), env=env)
        runs.append(time.perf_counter() - t0)
        (COMPILER_OUT / f"run{attempt}.log").write_text(r.stdout + r.stderr)
        _check(r.returncode == 0, f"run_torch.py exited {r.returncode}: "
                                  f"{r.stdout[-800:]} {r.stderr[-1500:]}")
        for line in r.stdout.splitlines():
            parts = line.split(",", 2)
            if len(parts) == 3 and not line.startswith("#"):
                csv[parts[0]] = (float(parts[1]), parts[2])
        gate = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_perf_regression.py"),
                               "--baseline", str(ROOT / "BENCH_calyx.json"), "--new", str(out)],
                              capture_output=True, text=True, timeout=120, cwd=str(ROOT))
        (COMPILER_OUT / f"gate{attempt}.log").write_text(gate.stdout + gate.stderr)
        fails = [ln for ln in gate.stdout.splitlines() if ln.startswith("FAIL:")]
        if gate.returncode == 0 or attempt == COMPILER_TRIES or not fails \
                or not all(ln.startswith(VERIFY_OVERHEAD) for ln in fails):
            break
        sections = ("calyx_bench",)
    _check(gate.returncode == 0, f"the Calyx gate failed: {gate.stdout[-1500:]}")
    data = json.loads(out.read_text())
    ref = json.loads((ROOT / "BENCH_calyx.json").read_text())
    recs = data["records"]
    _check(len(recs) == len(ref["records"]) == 48, f"{len(recs)} records, not 48")
    drop = set(CALYX_CLOCKS) | {"oracle_max_abs_err"}
    differ = [f"{g['design']} f{g['banks']} share={g['share']} o{g['opt_level']}: {k}"
              for g, w in zip(recs, ref["records"]) for k in set(g) | set(w)
              if k not in drop and g.get(k) != w.get(k)]
    _check(not differ, f"fields differ from BENCH_calyx.json: {differ[:5]}")
    _check(data["opt_geomean_speedup"] == ref["opt_geomean_speedup"],
           f"opt geomean {data['opt_geomean_speedup']} != {ref['opt_geomean_speedup']}")
    errs = [g["oracle_max_abs_err"] for g in recs]
    _check(max(errs) <= DESIGN_TOL, f"oracle error {max(errs)} over {DESIGN_TOL}")
    moe = {}
    for mode in ("banked", "gather"):
        us, derived = csv[f"moe_{mode}_us_per_call"]
        moe[mode] = {"us_per_call": us,
                     "index_reads": int(re.fullmatch(r"gather_ops=(\d+)", derived).group(1))}
    _check(moe["banked"]["index_reads"] < moe["gather"]["index_reads"],
           f"banked MoE dispatch reads no fewer slices than gather: {moe}")
    # the two scripts read no clock the gate holds: run them side by side
    t0 = time.perf_counter()
    procs = {label: subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / script), *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(ROOT), env=env)
        for label, script, args in (
            ("verify_matrix", "verify_matrix_torch.py", []),
            ("lint_design", "lint_design_torch.py",
             ["--model", "ffnn", "--factor", "4", "--profile"]))}
    tools = {}
    try:
        for label, proc in procs.items():
            text, err = proc.communicate(timeout=300)
            (COMPILER_OUT / f"{label}.log").write_text(text + err)
            _check(proc.returncode == 0, f"{label} exited {proc.returncode}: "
                                         f"{text[-800:]} {err[-800:]}")
            tools[label] = {"s": time.perf_counter() - t0,
                            "last": text.strip().splitlines()[-1]}
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    _check(tools["verify_matrix"]["last"].startswith(
        "OK: 48 points x verify, 192 stage reports, all clean"),
        f"verify_matrix_torch.py printed {tools['verify_matrix']['last']!r}")
    launches = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in counters}
    _check(not any(launches.values()), f"the compiler benchmarks launched kernels: {launches}")
    verify_us = sum(g["verify_us"] for g in recs)
    compile_us = sum(g["compile_us"] for g in recs)
    row = {"phase_s": time.perf_counter() - t_phase, "runner_s": runs,
           "records": len(recs), "device": data["device"],
           "oracle_max_abs_err": [min(errs), max(errs)], "tolerance": DESIGN_TOL,
           "opt_geomean_speedup": data["opt_geomean_speedup"],
           "verifier_overhead": verify_us / compile_us, "compile_s": compile_us / 1e6,
           "sim_wall_s": sum(g["sim_wall_us"] for g in recs) / 1e6,
           "gate": "ok", "moe": moe, "tools": tools,
           "paper": {k: csv[k][1] for k in ("fig3_speedup_1to2", "fig3_speedup_2to4",
                                             "table2_ffnn_f4_lut")},
           "kernel_launches": launches, "card": _card_name_and_limit()}
    print(json.dumps({"compiler_bench": row}))
    return row


# -- the benchmark twins -------------------------------------------------------

BENCH_OUT = ROOT / "build" / "chip_smoke_bench"       # ignored by git
BENCH_SECTIONS = ("serve_bench", "resilience_bench", "kernel_bench",
                  "model_profile_bench", "roofline_report")
BENCH_TIMEOUT = 420
BENCH_REPEATS = "2"
BENCH_FULL = ("full", "full_wide")       # serve_bench_torch's full-width profiles
BENCH_PROFILED_TICKS = 32
# the twins' records and the gate's flag for each
BENCH_FILES = {"serve": ("BENCH_serve_torch.json", "SERVE_BENCH_OUT", "--serve-new"),
               "resilience": ("BENCH_resilience_torch.json", "RESILIENCE_BENCH_OUT",
                              "--resilience-new"),
               "model": ("BENCH_model_torch.json", "MODEL_BENCH_OUT", "--model-new")}


def _serve_twin():
    """``benchmarks/serve_bench_torch.py``, imported as the runner imports it."""
    if str(ROOT) not in sys.path:
        sys.path.insert(1, str(ROOT))
    from benchmarks import serve_bench_torch
    return serve_bench_torch


def phase_bench_profile(sp: ServePath) -> dict:
    """The device time of the serve twin's full-width profiles (``full``,
    ``full_wide``) on qwen2-0.5b's registered bf16 weights: the first
    ``BENCH_PROFILED_TICKS`` engine steps of each profile's replay (the
    arrivals, admissions and the slots filling, then full), from a fresh
    engine at every call, read by ``_profile_windows`` against CUDA events
    (C.21); the device ms and busy share a step for the ``bench`` line.  A
    whole replay is 138-255 steps of ~1,800 device events, which the
    profiler takes minutes to process."""
    SB = _serve_twin()
    rows = {}
    for name in BENCH_FULL:
        prof = SB.PROFILES[name]
        cfg = SB.point_config(prof["arch"], name)
        _check(prof["arch"] == sp.arch and cfg == sp.cfg
               and sp.prm["embed"].dtype == getattr(torch, cfg.dtype),
               f"{name}: the served weights are not {prof['arch']}'s registered "
               f"{cfg.dtype} config")
        trace = SB.profile_trace(prof)

        def replay():
            drv = SB.make_driver(cfg, sp.prm, prof, trace, SB.SEED, CARD)
            for _ in range(BENCH_PROFILED_TICKS):
                _check(drv.tick(), f"{name}: the replay ended within "
                                   f"{BENCH_PROFILED_TICKS} steps")
        w = _profile_windows(replay, iters=1, min_calls=1)
        n = BENCH_PROFILED_TICKS
        rows[name] = {"profiled_steps": n, "device_ms_per_step": w["device_ms"] / n,
                      "wall_ms_per_step": w["call_ms"] / n,
                      "device_busy_share": w["device_ms"] / w["call_ms"],
                      "host_enqueue_ms_per_step": w["host_ms"] / n,
                      "windows_refused": len(w["refused"]),
                      "device_kernels_top": {k[:60]: v / n for k, v in
                                             list(w["by_kernel"].items())[:5]}}
    print(json.dumps({"bench_profile": {**rows, "card": _card_name_and_limit()}}))
    return rows


def _gate(flag: str, path: Path):
    return subprocess.run([sys.executable, str(ROOT / "scripts" / "check_perf_regression.py"),
                           flag, str(path)], capture_output=True, text=True, timeout=120,
                          cwd=str(ROOT))


def phase_bench(profiled: Optional[dict]) -> List[dict]:
    """``benchmarks/run_torch.py`` over the five twins on the card, in a
    process of its own (2 repeats; the records under ``build/chip_smoke_bench``
    through the twins' ``*_OUT`` overrides), then
    ``scripts/check_perf_regression.py`` on each record file with no
    baseline: the contract checks (trace, resilience and record overheads
    under 5%, deterministic streams, every request completed, goodput at
    least 0.90, no request lost, the analytic cross-check).  One ``bench``
    line a twin; the serve line carries the ``full`` and ``full_wide``
    records with the device time of ``phase_bench_profile``."""
    import shutil
    shutil.rmtree(BENCH_OUT, ignore_errors=True)
    BENCH_OUT.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
           "SERVE_BENCH_REPEATS": BENCH_REPEATS, "MODEL_BENCH_REPEATS": BENCH_REPEATS}
    for fname, var, _ in BENCH_FILES.values():
        env[var] = str(BENCH_OUT / fname)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / "benchmarks" / "run_torch.py"),
                        *BENCH_SECTIONS, "--device", CARD], capture_output=True,
                       text=True, timeout=BENCH_TIMEOUT, cwd=str(ROOT), env=env)
    run_s = time.perf_counter() - t0
    (BENCH_OUT / "run.log").write_text(r.stdout + r.stderr)
    print("\n".join("  " + line for line in r.stdout.splitlines()))
    _check(r.returncode == 0, f"run_torch.py exited {r.returncode}: {r.stderr[-1500:]}")
    csv = {}
    for line in r.stdout.splitlines():
        parts = line.split(",", 2)
        if len(parts) == 3 and not line.startswith("#"):
            csv[parts[0]] = (float(parts[1]), parts[2])
    card, rows, failed = _card_name_and_limit(), [], []
    for twin, (fname, _, flag) in BENCH_FILES.items():
        data = json.loads((BENCH_OUT / fname).read_text())
        gate = _gate(flag, BENCH_OUT / fname)
        (BENCH_OUT / f"gate_{twin}.log").write_text(gate.stdout + gate.stderr)
        fails = [ln for ln in gate.stdout.splitlines() if ln.startswith("FAIL:")]
        row = {"twin": twin, "records": len(data["records"]),
               "gate": "ok" if gate.returncode == 0 else "FAIL", "gate_failures": fails,
               "device": data["device"]}
        recs = data["records"]
        if twin == "serve":
            row["overhead"] = {f"{r['arch']}/{r['profile']}": r["trace_overhead"]
                               for r in recs}
            for rec in recs:
                if rec["profile"] not in BENCH_FULL:
                    continue
                full = {k: rec[k] for k in ("requests", "completed", "slots", "steps",
                                            "max_len", "tokens_per_sec",
                                            "tick_median_off_us", "slot_utilization",
                                            "trace_overhead", "deterministic")}
                full.update(ttft_us_p99=rec["ttft_us"]["p99"],
                            decode_tok_us_p50=rec["decode_tok_us"]["p50"])
                full.update((profiled or {}).get(rec["profile"], {}))
                row[rec["profile"]] = full
                _check(rec["completed"] == rec["requests"],
                       f"serve {rec['profile']}: {rec['completed']}/{rec['requests']} "
                       f"requests completed")
            _check(all(p in row for p in BENCH_FULL), "serve: no full-width records")
        elif twin == "resilience":
            row["overhead"] = {r["profile"]: r["resilience_overhead"] for r in recs
                               if r["campaign"] == "zero_fault"}
            row["goodput_min"] = min(r["goodput"] for r in recs if "goodput" in r)
            row["lost"] = sum(r.get("lost", 0) for r in recs)
        else:
            row["overhead"] = {r["arch"]: r["record_overhead"] for r in recs}
            row["flops_rel_err"] = {r["arch"]: r["crosscheck"]["flops_rel_err"]
                                    for r in recs}
            row["device_peaks"] = data["device_peaks"]
        print(json.dumps({"bench": {**row, "card": card}}))
        rows.append(row)
        if gate.returncode != 0:
            failed.append(f"{twin}: {fails}")
    kernel = {k: v[0] for k, v in csv.items() if k.startswith("kernel_")}
    roof = [k for k in csv if k.startswith("roofline_")]
    for twin, lines in (("kernel", kernel), ("roofline", roof)):
        row = {"twin": twin, "lines": len(lines), "gate": "ok" if lines else "FAIL",
               "gate_by": "the section's own holds (run_torch.py exit 0)"}
        if twin == "kernel":
            row["us_per_call"] = kernel
        print(json.dumps({"bench": {**row, "card": card}}))
        rows.append(row)
    print(json.dumps({"bench_run": {"run_s": run_s, "repeats": int(BENCH_REPEATS),
                                    "out": str(BENCH_OUT.relative_to(ROOT))}}))
    _check(kernel and roof, "the kernel or roofline section printed no line")
    _check(not failed, f"the contract gate failed: {failed}")
    return rows


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
    # the dry run works on the host's CPU beside the last architecture's
    # weight draw (numpy, ~3 min), which times nothing, and is waited for
    # right after it, before any timed phase
    dryrun = []
    try:
        for arch, layers, cpu_groups in SERVE_ARCHS:
            if arch == DRYRUN_BESIDE:
                dryrun = [start_dryrun(tuple(c for c in DRYRUN_CELLS
                                             if c not in DRYRUN_ALONE)),
                          start_dryrun(DRYRUN_ALONE),
                          start_dryrun(DRYRUN_MB_CELLS, DRYRUN_MB_OUT,
                                       DRYRUN_MB)]
            drawn = run(f"{arch} weights",
                        lambda: ServePath(arch, layers, cpu_groups))
            if arch == DRYRUN_BESIDE:
                draw_end = time.time()
                if run("dry run", lambda: phase_dryrun(dryrun, draw_end)):
                    run("dry-run report", phase_dryrun_report)
                for d in (DRYRUN_OUT, DRYRUN_MB_OUT):
                    shutil.rmtree(d, ignore_errors=True)
            if not drawn:
                continue
            sp = results.pop(f"{arch} weights")
            run(f"{arch} decode vs forward", lambda: phase_decode_vs_forward(sp))
            run(f"{arch} serve", lambda: phase_serve(sp))
            if arch == ANALYSIS_ARCH:
                run("op analysis", lambda: phase_op_analysis(sp))
                run("bench profile", lambda: phase_bench_profile(sp))
            run(f"{arch} serve chaos", lambda: phase_serve_chaos(sp))
            # free the weights on the card: the cached sliced step holds
            # views, and the checked engine and its step wrapper form a cycle
            sp.decode.make_profiled_serve_step.cache_clear()
            del sp
            gc.collect()
            torch.cuda.empty_cache()
        run("bench", lambda: phase_bench(results.get("bench profile")))
        run_train_and_tools(run, results, counters)
    finally:
        for proc in dryrun:
            proc.kill()
            proc.wait()
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


def run_train_and_tools(run, results, counters) -> None:
    """The training path, which launches none of the four kernels (every
    count zeroed just before it and read just after: the ``train`` line),
    then the compiler examples and the compiler-side twins."""
    train = {}
    _zero_counts(counters)
    for label, key, fn in (("train card vs cpu", "card_vs_cpu", phase_train_vs_cpu),
                           ("train atomics", "atomics", phase_atomics),
                           ("train restart", "restart", phase_train_restart),
                           ("train timed", "timed", phase_train_timed),
                           ("train example", "example", phase_train_example)):
        if run(label, fn):
            train[key] = results.pop(label)
        gc.collect()
        torch.cuda.empty_cache()
    train["kernel_launches"] = {m.__name__.rsplit(".", 1)[-1]: m.launches
                                for m in counters}
    print(json.dumps({"train": train}))
    run("compiler examples", phase_compiler_examples)
    run("compiler bench", lambda: phase_compiler_bench(counters))


if __name__ == "__main__":
    sys.exit(main())
