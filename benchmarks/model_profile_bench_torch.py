"""Model-operator profiling harness of the PyTorch port -> BENCH_model_torch.json.

The twin of ``benchmarks/model_profile_bench.py``, over ``repro_torch``
(it imports nothing of ``repro`` and no ``jax``).  Per architecture (dense
transformer, RWKV6, MoE), on the reduced configs, it replays the
reference's seeded trace through the *profiled* engine
(``Engine(layers=LayerProfiler())``, the sliced per-operator step of
``repro_torch.models.decode.ProfiledServeStep``) and writes one record per
arch with the reference's keys:

* **flame**: mean wall per (operator, group);
* **record overhead** (gated <= 5%): a ``LayerProfiler(record=False)``
  engine and a recording one in lockstep (one tick each, alternating who
  goes first), both on the sliced step, so the pair isolates the cost of
  recording;
* **slice overhead** (informational): the fused engine against the sliced
  ``record=False`` one in the same lockstep;
* **join**: a spans + layers run must close the three-level trace
  (``modelprof.validate`` and ``join_mismatches`` empty); ``coverage``
  (summed segment walls / step wall) as p50/min/max;
* **determinism**: two same-seed recording runs serialize byte-identically
  in the layer exporter's stable mode;
* **crosscheck**: the analytic per-op cost model against the port's
  ``modelprof.crosscheck``, which counts one fused decode step at the
  engine's shapes with ``launch.op_analysis`` (FLOPs within
  ``FLOPS_RTOL``, bytes within ``BYTES_FACTOR``).  The record keeps the
  keys the gate reads (``flops_rel_err``, ``bytes_ratio``,
  ``analytic_flops``, ``analytic_bytes``) and carries ``counted_flops``
  and ``counted_bytes`` where the reference, which reads XLA's HLO cost
  analysis, has ``hlo_flops`` and ``hlo_bytes``; ``collective_bytes`` is
  the counter's, 0 on one device;
* **offload**: ``modelprof.offload_report``: operators ranked by measured
  share, with analytic FLOPs, bytes and intensity at the full config and a
  4096-position cache.  Its ``bound`` classes are taken against
  ``device_peaks()``, the H100's datasheet peaks (989 TFLOP/s bf16, 3.35
  TB/s), where the reference's are a TPU's: the file's ``device_peaks`` and
  the ``bound`` column therefore differ from ``BENCH_model.json``'s, while
  FLOPs, bytes and intensity are the same numbers.

Environment overrides, as the reference's: ``MODEL_BENCH_ARCHS``,
``MODEL_BENCH_OUT`` (default ``BENCH_model_torch.json``),
``MODEL_BENCH_REPEATS``, ``MODEL_BENCH_LAYERS_DIR``.  The file's top-level
``device`` names the card (``nvidia-smi``'s name and power limit) or
``"cpu"``.

    PYTHONPATH=src:. python benchmarks/model_profile_bench_torch.py --device cpu
"""
from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from benchmarks import torch_device
from repro_torch.device import resolve_device
from repro_torch.launch.serve import Engine, ReplayDriver, Request
from repro_torch.models import get_config
from repro_torch.models import params as MP
from repro_torch.models.decode import profile_ops
from repro_torch.obs import SpanTracer, traffic
from repro_torch.obs import modelprof as MPF
from repro_torch.obs.modelprof import LayerProfiler

SEED = 0

# three model families: dense transformer, RWKV6 SSM, MoE
ARCHS = ("qwen2-0.5b", "rwkv6-7b", "olmoe-1b-7b")

PROFILE = dict(requests=6, slots=2, mean_interarrival=0.5,
               prompt_lens=(4, 8), gen_lens=(8, 12))

# deployment shape for the analytic offload columns: the full (unreduced)
# config serving one stream against a production cache span
FULL_BATCH = 1
FULL_CACHE_LEN = 4096


def _build_arrivals(cfg, trace, seed: int) -> List[Tuple[int, Request]]:
    rng = np.random.default_rng(seed + 1)
    return [(t.arrival_step,
             Request(t.rid,
                     rng.integers(1, cfg.vocab_size,
                                  size=t.prompt_len).astype(np.int32),
                     t.gen_len))
            for t in trace]


def _max_len(trace) -> int:
    return traffic.total_tokens(trace) \
        + max((t.prompt_len + t.gen_len for t in trace), default=0) + 8


def _make_driver(cfg, params, trace, seed: int, dev,
                 spans: Optional[SpanTracer] = None,
                 layers: Optional[LayerProfiler] = None) -> ReplayDriver:
    eng = Engine(cfg, params, PROFILE["slots"], _max_len(trace),
                 spans=spans, layers=layers, device=dev)
    return ReplayDriver(eng, _build_arrivals(cfg, trace, seed))


def _lockstep(mk_a, mk_b) -> Tuple[Engine, Engine, List[float], List[float]]:
    """Drive two engine factories through the identical schedule one tick
    at a time, alternating who goes first; returns per-tick walls."""
    a, b = mk_a(), mk_b()
    walls_a: List[float] = []
    walls_b: List[float] = []
    k = 0
    while a.active or b.active:
        first, second = (a, b) if k % 2 == 0 else (b, a)
        for drv in (first, second):
            t0 = time.perf_counter()
            ticked = drv.tick()
            wall = time.perf_counter() - t0
            if ticked:
                (walls_a if drv is a else walls_b).append(wall)
        k += 1
    n = min(len(walls_a), len(walls_b))
    return a.eng, b.eng, walls_a[:n], walls_b[:n]


def _overhead(ticks_base: List[float], ticks_inst: List[float]) -> float:
    """median(paired deltas) / median(base ticks) — load drift cancels."""
    if not ticks_base:
        return 0.0
    med = float(np.median(ticks_base))
    deltas = np.asarray(ticks_inst) - np.asarray(ticks_base)
    return float(np.median(deltas)) / med if med else 0.0


def run(emit, out_path: Optional[str] = None, device=None) -> None:
    dev = resolve_device(device)
    archs = [a.strip() for a in
             os.environ.get("MODEL_BENCH_ARCHS", "").split(",")
             if a.strip()] or list(ARCHS)
    repeats = max(2, int(os.environ.get("MODEL_BENCH_REPEATS", "3")))
    layers_dir = os.environ.get("MODEL_BENCH_LAYERS_DIR", "")
    if layers_dir:
        os.makedirs(layers_dir, exist_ok=True)
    peaks = MPF.device_peaks()
    records = []
    failures = []
    for arch in archs:
        tag = f"model_profile_{arch}"
        t_section = time.perf_counter()
        full_cfg = get_config(arch)
        cfg = full_cfg.reduced()
        params = MP.init_params(cfg, seed=SEED, device=dev)
        trace = traffic.synth_trace(SEED, PROFILE["requests"],
                                    PROFILE["mean_interarrival"],
                                    PROFILE["prompt_lens"],
                                    PROFILE["gen_lens"])
        max_len = _max_len(trace)

        def driver(spans=None, layers=None):
            return _make_driver(cfg, params, trace, SEED, dev,
                                spans=spans, layers=layers)

        # warm both execution modes before any timed tick
        warm = traffic.synth_trace(SEED, 2, 0.0, (2,), (2,))
        for layers in (None, LayerProfiler(record=False)):
            drv = _make_driver(cfg, params, warm, SEED, dev, layers=layers)
            while drv.active:
                drv.tick()

        # -- record overhead (gated): sliced+off vs sliced+recording --------
        ticks_off: List[float] = []
        ticks_on: List[float] = []
        stable_streams: List[str] = []
        last_prof: Optional[LayerProfiler] = None
        for _ in range(repeats):
            prof = LayerProfiler()
            e_off, e_on, w_off, w_on = _lockstep(
                lambda: driver(layers=LayerProfiler(record=False)),
                lambda: driver(layers=prof))
            ticks_off.extend(w_off)
            ticks_on.extend(w_on)
            last_prof = prof
            if e_off.steps != e_on.steps:
                failures.append(f"{tag}: recording run took {e_on.steps} "
                                f"steps, baseline {e_off.steps}")
            if len(stable_streams) < 2:
                stable_streams.append(MPF.to_jsonl(prof.records,
                                                   stable=True))
        assert last_prof is not None
        record_overhead = _overhead(ticks_off, ticks_on)
        deterministic = stable_streams[0] == stable_streams[1]
        if not deterministic:
            failures.append(f"{tag}: stable layer streams of two "
                            f"same-seed runs differ")

        # -- slice overhead (informational): fused vs sliced+off ------------
        _, _, w_fused, w_sliced = _lockstep(
            lambda: driver(), lambda: driver(layers=LayerProfiler(record=False)))
        slice_overhead = _overhead(w_fused, w_sliced)

        # -- three-level join: spans + layers in one run --------------------
        tr = SpanTracer()
        join_prof = LayerProfiler()
        drv = driver(spans=tr, layers=join_prof)
        while drv.active:
            drv.tick()
        problems = MPF.validate(join_prof.records, cfg=cfg,
                                engine_steps=drv.eng.steps)
        problems += MPF.join_mismatches(join_prof.records, tr.events,
                                        cfg=cfg)
        if problems:
            failures.append(f"{tag}: three-level join broken "
                            f"(first: {problems[0]})")
        rows = MPF.join_steps(join_prof.records, tr.events)
        coverages = [r.coverage for r in rows.values()
                     if r.step_wall_us > 0]
        cov = {"p50": round(float(np.median(coverages)), 4),
               "min": round(min(coverages), 4),
               "max": round(max(coverages), 4)} if coverages else {}

        # -- analytic vs counted at the engine's exact shapes ---------------
        crosscheck, cc_problems = MPF.crosscheck(
            cfg, batch=PROFILE["slots"], cache_len=max_len, device=dev,
            params=params)
        failures.extend(f"{tag}: {p}" for p in cc_problems)

        # -- flame + offload ranking ----------------------------------------
        recs = last_prof.records
        summary = MPF.summarize(recs)
        flame = [{"op": op, "group": g,
                  "wall_us_mean": round(s.mean_us, 1),
                  "calls": s.calls}
                 for (op, g), s in sorted(summary.items(),
                                          key=lambda kv: (kv[0][1],
                                                          kv[0][0]))]
        full_costs = MPF.analytic_op_costs(full_cfg, FULL_BATCH,
                                           FULL_CACHE_LEN)
        offload = MPF.offload_report(full_cfg, recs, full_costs,
                                     peaks=peaks)

        rec = {
            "arch": arch,
            "family": cfg.family,
            "seed": SEED,
            "requests": PROFILE["requests"],
            "slots": PROFILE["slots"],
            "cache_len": max_len,
            "steps": drv.eng.steps,
            "layer_records": len(recs),
            "ops_per_step": len(profile_ops(cfg)),
            "tick_median_fused_us": round(float(np.median(w_fused)) * 1e6,
                                          1) if w_fused else 0.0,
            "tick_median_off_us": round(float(np.median(ticks_off)) * 1e6,
                                        1) if ticks_off else 0.0,
            "tick_pairs": len(ticks_off),
            "record_overhead": round(record_overhead, 4),
            "slice_overhead": round(slice_overhead, 4),
            "deterministic": deterministic,
            "coverage": cov,
            "crosscheck": {k: (round(v, 6) if isinstance(v, float) else v)
                           for k, v in crosscheck.items()},
            "full_shape": {"batch": FULL_BATCH,
                           "cache_len": FULL_CACHE_LEN},
            "flame": flame,
            "offload": offload,
            "repeats": repeats,
        }
        records.append(rec)
        if layers_dir:
            with open(os.path.join(layers_dir, f"{tag}.layers.jsonl"),
                      "w") as f:
                f.write(MPF.to_jsonl(join_prof.records, stable=True))
        top = offload[0] if offload else {"op": "?", "share": 0.0}
        emit(tag, (time.perf_counter() - t_section) * 1e6,
             f"top={top['op']}@{top['share']:.0%}"
             f"|rec_ovh={record_overhead:+.1%}"
             f"|slice_ovh={slice_overhead:+.1%}"
             f"|cov_p50={cov.get('p50', 0):.2f}"
             f"|flops_err={crosscheck['flops_rel_err']:.4f}"
             f"|det={deterministic}")
        del params, driver
    out_path = out_path or os.environ.get("MODEL_BENCH_OUT",
                                          "BENCH_model_torch.json")
    # write before failing: the artifact is the diagnostic
    with open(out_path, "w") as f:
        json.dump({"schema": 1,
                   "generator": "benchmarks/model_profile_bench_torch.py",
                   "seed": SEED,
                   "device": torch_device.label(dev),
                   "device_peaks": {"flops_per_s": peaks[0],
                                    "hbm_bytes_per_s": peaks[1]},
                   "records": records}, f, indent=2)
        f.write("\n")
    emit("model_profile_json", 0.0, f"{len(records)} records -> {out_path}")
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    torch_device.main(run, __doc__, out_help="output JSON path (default "
                      "BENCH_model_torch.json or $MODEL_BENCH_OUT)")
