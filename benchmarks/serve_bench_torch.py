"""Serving load harness of the PyTorch port -> BENCH_serve_torch.json.

The twin of ``benchmarks/serve_bench.py``, over ``repro_torch`` (it imports
nothing of ``repro`` and no ``jax``).  It replays the reference's seeded
traffic (``repro_torch.obs.traffic``, the same ``SEED``, arrivals, prompts
and ``_max_len``) through the port's continuous-batching engine
(``repro_torch.launch.serve.Engine``) and writes one record per
(arch, profile) with the reference's keys:

* **latency**: TTFT p50/p99 and per-token decode latency p50/p99, as the
  metrics registry's bucket-interpolated quantiles and as exact numpy
  quantiles over the span stream;
* **throughput**: generated tokens/sec over the *uninstrumented* wall
  clock, engine steps and slot utilization;
* **overhead**: ``trace_overhead``, an uninstrumented and an instrumented
  engine driven through the identical schedule in lockstep (one tick each,
  alternating who goes first; every engine step copies its tokens to the
  host, so a tick's wall ends after the device's work), as
  ``median(paired deltas) / median(off ticks)`` pooled over the repeats;
  ``scripts/check_perf_regression.py`` gates it at <=5%;
* **determinism**: two traced runs of the same seed must serialize
  byte-identically in the span exporter's stable mode; a mismatch, a span
  violation, or an unfinished request fails the section.

Profiles: the reference's ``smoke`` and ``heavy`` on
``get_config(arch).reduced()`` (float32), for both ``ARCHS``; and two of
the port's own that run only ``qwen2-0.5b`` at full width
(``get_config("qwen2-0.5b")``, its registered bfloat16), and only on the
card:

* ``full``: the ``heavy`` traffic as it is (32 requests, mean
  interarrival 0.5 steps, prompts 4/8/16, generations 8/16/32) on 4
  slots; ``_max_len`` gives a cache of 1,012 positions;
* ``full_wide``: 128 requests at a mean interarrival of 0.125 steps, the
  same lengths, on 32 slots; ``_max_len`` gives 3,816 positions, a cache
  of 24 layers x 2 kv heads x 64 x (k, v) x 2 B x 3,816 x 32 = 1.5 GB.

rwkv6-7b keeps only the reduced profiles: a 7B numpy draw would cost
minutes of the run.  A full-width profile asked for on the CPU raises.

Environment overrides, as the reference's: ``SERVE_BENCH_ARCHS`` /
``SERVE_BENCH_PROFILES`` restrict the matrix (a full-width profile applies
to ``qwen2-0.5b`` only; with no override the CPU runs the reduced
profiles, the card all four), ``SERVE_BENCH_OUT`` moves the JSON (default
``BENCH_serve_torch.json``), ``SERVE_BENCH_REPEATS`` sets the paired-run
count, ``SERVE_BENCH_SPANS_DIR`` writes the stable span JSONL and the
Prometheus text per point.  The file's top-level ``device`` names the card
(``nvidia-smi``'s name and power limit) or ``"cpu"``.

    PYTHONPATH=src:. python benchmarks/serve_bench_torch.py --device cpu
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmarks import torch_device
from repro_torch.device import resolve_device
from repro_torch.launch.serve import Engine, ReplayDriver, Request
from repro_torch.models import get_config
from repro_torch.models import params as MP
from repro_torch.obs import MetricsRegistry, SpanTracer, spans as SP, traffic

SEED = 0

# smallest arch first; rwkv6 covers the non-transformer (ssm) family
ARCHS = ("qwen2-0.5b", "rwkv6-7b")

# the reference's two profiles, then the port's full-width ones: ``arch``
# names the one architecture a profile serves, at its registered width
PROFILES: Dict[str, Dict] = {
    "smoke": dict(requests=8, slots=2, mean_interarrival=1.0,
                  prompt_lens=(4, 8), gen_lens=(4, 8)),
    "heavy": dict(requests=32, slots=4, mean_interarrival=0.5,
                  prompt_lens=(4, 8, 16), gen_lens=(8, 16, 32)),
    "full": dict(requests=32, slots=4, mean_interarrival=0.5,
                 prompt_lens=(4, 8, 16), gen_lens=(8, 16, 32),
                 arch="qwen2-0.5b"),
    "full_wide": dict(requests=128, slots=32, mean_interarrival=0.125,
                      prompt_lens=(4, 8, 16), gen_lens=(8, 16, 32),
                      arch="qwen2-0.5b"),
}
REDUCED_PROFILES = ("smoke", "heavy")


def _build_arrivals(cfg, trace, seed: int) -> List[Tuple[int, Request]]:
    """Fresh Request objects (they are mutated by the engine) with
    seed-deterministic prompt token content."""
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


def profile_trace(prof: Dict):
    return traffic.synth_trace(SEED, prof["requests"],
                               prof["mean_interarrival"],
                               prof["prompt_lens"], prof["gen_lens"])


def make_driver(cfg, params, prof: Dict, trace, seed: int, device,
                metrics: Optional[MetricsRegistry] = None,
                spans: Optional[SpanTracer] = None) -> ReplayDriver:
    eng = Engine(cfg, params, prof["slots"], _max_len(trace),
                 metrics=metrics, spans=spans, device=device)
    return ReplayDriver(eng, _build_arrivals(cfg, trace, seed))


def _lockstep_replay(cfg, params, prof: Dict, trace, seed: int, device,
                     reg: MetricsRegistry, tr: SpanTracer
                     ) -> Tuple[Engine, Engine, List[float], List[float]]:
    """Drive an uninstrumented and an instrumented engine through the
    identical arrival schedule one tick at a time, alternating which side
    runs first; returns both drained engines and the per-tick wall seconds
    of every paired tick."""
    off = make_driver(cfg, params, prof, trace, seed, device)
    on = make_driver(cfg, params, prof, trace, seed, device,
                     metrics=reg, spans=tr)
    walls_off: List[float] = []
    walls_on: List[float] = []
    k = 0
    while off.active or on.active:
        first, second = (off, on) if k % 2 == 0 else (on, off)
        for drv in (first, second):
            t0 = time.perf_counter()
            ticked = drv.tick()
            wall = time.perf_counter() - t0
            if ticked:
                (walls_off if drv is off else walls_on).append(wall)
        k += 1
    n = min(len(walls_off), len(walls_on))
    return off.eng, on.eng, walls_off[:n], walls_on[:n]


def _quantiles(values: List[float]) -> Dict[str, float]:
    if not values:
        return {"p50": 0.0, "p99": 0.0}
    arr = np.asarray(values, np.float64)
    return {"p50": round(float(np.quantile(arr, 0.5)), 1),
            "p99": round(float(np.quantile(arr, 0.99)), 1)}


def _env_list(name: str) -> List[str]:
    return [a.strip() for a in os.environ.get(name, "").split(",")
            if a.strip()]


def matrix(dev: torch.device) -> List[Tuple[str, str]]:
    """The (arch, profile) points to run: the overrides' matrix, where a
    full-width profile serves only its own architecture and only on the
    card."""
    archs = _env_list("SERVE_BENCH_ARCHS") or list(ARCHS)
    asked = _env_list("SERVE_BENCH_PROFILES")
    profiles = asked or (list(PROFILES) if dev.type == "cuda"
                         else list(REDUCED_PROFILES))
    points = []
    for profile in profiles:
        if profile not in PROFILES:
            raise ValueError(f"unknown serve profile {profile!r} "
                             f"(known: {sorted(PROFILES)})")
        if "arch" in PROFILES[profile] and dev.type != "cuda":
            raise ValueError(f"serve profile {profile!r} runs "
                             f"{PROFILES[profile]['arch']} at full width, "
                             f"only on the card (device {dev})")
    for arch in archs:
        for profile in profiles:
            if PROFILES[profile].get("arch", arch) == arch:
                points.append((arch, profile))
    return points


def point_config(arch: str, profile: str):
    """The registered config for a full-width profile, else the reduced."""
    cfg = get_config(arch)
    return cfg if "arch" in PROFILES[profile] else cfg.reduced()


def _warm(cfg, params, dev) -> None:
    """One tiny replay before any timed run, so both timed sides find the
    allocator, the libraries' handles and the step's caches warm."""
    warm = traffic.synth_trace(SEED, 2, 0.0, (2,), (2,))
    drv = make_driver(cfg, params, dict(slots=2), warm, SEED, dev)
    while drv.active:
        drv.tick()


def run(emit, out_path: Optional[str] = None, device=None) -> None:
    dev = resolve_device(device)
    points = matrix(dev)
    repeats = max(1, int(os.environ.get("SERVE_BENCH_REPEATS", "3")))
    spans_dir = os.environ.get("SERVE_BENCH_SPANS_DIR", "")
    if spans_dir:
        os.makedirs(spans_dir, exist_ok=True)
    records = []
    failures = []
    loaded: Dict[Tuple[str, bool], Tuple] = {}
    for arch, profile in points:
        prof = PROFILES[profile]
        key = (arch, "arch" in prof)
        if key not in loaded:
            loaded.clear()                  # one model on the card at a time
            cfg = point_config(arch, profile)
            params = MP.init_params(cfg, seed=SEED, device=dev)
            _warm(cfg, params, dev)
            loaded[key] = (cfg, params)
        cfg, params = loaded[key]
        trace = profile_trace(prof)
        tag = f"serve_{arch}_{profile}"
        t_section = time.perf_counter()
        # lockstep repeats; pooled paired per-tick walls give the
        # noise-robust overhead estimate, min total wall the throughput one
        wall_off = wall_on = float("inf")
        ticks_off: List[float] = []
        ticks_on: List[float] = []
        last: Optional[Tuple[Engine, MetricsRegistry, SpanTracer]] = None
        stable_streams = []
        for _ in range(max(repeats, 2)):
            reg = MetricsRegistry()
            tr = SpanTracer()
            eng_off, eng_on, w_off, w_on = _lockstep_replay(
                cfg, params, prof, trace, SEED, dev, reg, tr)
            ticks_off.extend(w_off)
            ticks_on.extend(w_on)
            wall_off = min(wall_off, sum(w_off))
            wall_on = min(wall_on, sum(w_on))
            last = (eng_on, reg, tr)
            if len(stable_streams) < 2:
                stable_streams.append(SP.to_jsonl(tr.events, stable=True))
            if eng_off.steps != eng_on.steps:
                failures.append(
                    f"{tag}: instrumented run took {eng_on.steps} "
                    f"steps, uninstrumented {eng_off.steps}")
        assert last is not None
        eng, reg, tr = last
        deterministic = stable_streams[0] == stable_streams[1]
        if not deterministic:
            failures.append(f"{tag}: stable span streams of two "
                            f"same-seed runs differ")
        problems = SP.validate(tr.events, slots=prof["slots"],
                               engine_steps=eng.steps)
        if problems:
            failures.append(f"{tag}: span invariants violated "
                            f"(first: {problems[0]})")
        summaries = SP.summarize(tr.events)
        finished = [s for s in summaries.values()
                    if s.reason == SP.FINISHED]
        truncated = [s for s in summaries.values()
                     if s.reason.startswith(SP.TRUNCATED_PREFIX)]
        if len(finished) != prof["requests"]:
            failures.append(
                f"{tag}: {len(finished)}/{prof['requests']} finished "
                f"({len(truncated)} truncated) — size max_len up")
        ttfts = [float(s.ttft_us) for s in finished if s.ttft_us >= 0]
        dtoks = [s.decode_us_per_token for s in finished if s.tokens >= 2]
        gen_tokens = int(reg.get("serve_tokens_generated_total").value)
        med_off = float(np.median(ticks_off)) if ticks_off else 0.0
        deltas = np.asarray(ticks_on) - np.asarray(ticks_off)
        overhead = float(np.median(deltas)) / med_off if med_off else 0.0
        overhead_total = (wall_on - wall_off) / wall_off if wall_off else 0.0
        ttft_h = reg.get("serve_ttft_us")
        dtok_h = reg.get("serve_decode_token_us")
        rec = {
            "arch": arch,
            "family": cfg.family,
            "profile": profile,
            "seed": SEED,
            "requests": prof["requests"],
            "slots": prof["slots"],
            "steps": eng.steps,
            "completed": len(finished),
            "truncated": len(truncated),
            "tokens_generated": gen_tokens,
            "tokens_prefill":
                int(reg.get("serve_tokens_prefill_total").value),
            "wall_off_us": round(wall_off * 1e6, 1),
            "wall_on_us": round(wall_on * 1e6, 1),
            "tick_median_off_us": round(med_off * 1e6, 1),
            "tick_median_delta_us": round(float(np.median(deltas)) * 1e6, 2),
            "tick_pairs": len(ticks_off),
            "trace_overhead": round(overhead, 4),
            "trace_overhead_total": round(overhead_total, 4),
            "tokens_per_sec": round(gen_tokens / wall_off, 1),
            "ttft_us": {"p50": round(ttft_h.quantile(0.5), 1),
                        "p99": round(ttft_h.quantile(0.99), 1),
                        **{f"{k}_exact": v
                           for k, v in _quantiles(ttfts).items()}},
            "decode_tok_us": {"p50": round(dtok_h.quantile(0.5), 1),
                              "p99": round(dtok_h.quantile(0.99), 1),
                              **{f"{k}_exact": v
                                 for k, v in _quantiles(dtoks).items()}},
            "slot_utilization":
                round(SP.slot_utilization(tr.events, prof["slots"]), 4),
            "span_events": len(tr.events),
            "deterministic": deterministic,
            "repeats": max(repeats, 2),
            "dtype": cfg.dtype,
            "max_len": _max_len(trace),
        }
        records.append(rec)
        if spans_dir:
            base = os.path.join(spans_dir, f"{tag}")
            with open(base + ".spans.jsonl", "w") as f:
                f.write(SP.to_jsonl(tr.events, stable=True))
            with open(base + ".prom", "w") as f:
                f.write(reg.to_prometheus())
        emit(tag, (time.perf_counter() - t_section) * 1e6,
             f"ttft_p99={rec['ttft_us']['p99']:.0f}us"
             f"|tok/s={rec['tokens_per_sec']:.0f}"
             f"|util={rec['slot_utilization']:.2f}"
             f"|ovh={overhead:+.1%}"
             f"|det={deterministic}")
    loaded.clear()
    out_path = out_path or os.environ.get("SERVE_BENCH_OUT",
                                          "BENCH_serve_torch.json")
    # write before failing: the artifact is the diagnostic
    with open(out_path, "w") as f:
        json.dump({"schema": 1,
                   "generator": "benchmarks/serve_bench_torch.py",
                   "seed": SEED,
                   "device": torch_device.label(dev),
                   "records": records}, f, indent=2)
        f.write("\n")
    emit("serve_bench_json", 0.0, f"{len(records)} records -> {out_path}")
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    torch_device.main(run, __doc__, out_help="output JSON path (default "
                      "BENCH_serve_torch.json or $SERVE_BENCH_OUT)")
