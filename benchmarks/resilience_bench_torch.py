"""Chaos/goodput harness of the PyTorch port -> BENCH_resilience_torch.json.

The twin of ``benchmarks/resilience_bench.py``, over ``repro_torch`` (it
imports nothing of ``repro`` and no ``jax``).  It replays the reference's
seeded traffic through the port's engine (``repro_torch.launch.serve``)
under the reference's seeded fault campaigns
(``repro_torch.launch.faults.FaultPlan``) with the resilience layer armed
(``repro_torch.launch.resilience.ResilienceConfig``), on reduced
qwen2-0.5b, and writes one record per (profile, campaign) with the
reference's keys:

* **zero_fault**: a plain engine and one with the resilience layer armed
  (finite guard on, no deadlines, no queue bound) in lockstep, one tick
  each alternately; ``resilience_overhead`` is
  ``median(paired deltas) / median(plain ticks)``, gated at <=5% by
  ``scripts/check_perf_regression.py``; the two engines' token streams
  must be equal;
* **fault campaigns**: the reference's rate x shed-policy grid, each run
  twice with the instrumented engine: byte-identical stable span streams,
  no request lost, ``goodput`` gated at >=90%.

The deadlines count engine ticks, not wall time, so every campaign's
counts (steps, faults, retries, completions, sheds) are the reference's.

Environment overrides, as the reference's: ``RESILIENCE_BENCH_PROFILES``,
``RESILIENCE_BENCH_OUT`` (default ``BENCH_resilience_torch.json``),
``RESILIENCE_BENCH_RATES``.  The file's top-level ``device`` names the card
(``nvidia-smi``'s name and power limit) or ``"cpu"``.

    PYTHONPATH=src:. python benchmarks/resilience_bench_torch.py --smoke --device cpu
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmarks import torch_device
from repro_torch.device import resolve_device
from repro_torch.launch import faults as FLT, resilience as RES
from repro_torch.launch.serve import Engine, ReplayDriver, Request
from repro_torch.models import get_config
from repro_torch.models import params as MP
from repro_torch.obs import MetricsRegistry, SpanTracer, spans as SP, traffic

SEED = 0
ARCH = "qwen2-0.5b"

# mirrors serve_bench's profiles; the heavy profile saturates the slots
PROFILES: Dict[str, Dict] = {
    "smoke": dict(requests=8, slots=2, mean_interarrival=1.0,
                  prompt_lens=(4, 8), gen_lens=(4, 8)),
    "heavy": dict(requests=32, slots=4, mean_interarrival=0.5,
                  prompt_lens=(4, 8, 16), gen_lens=(8, 16, 32)),
}

RATES = (0.02, 0.05)
POLICIES = (RES.POLICY_REJECT_NEWEST, RES.POLICY_SHED_OLDEST,
            RES.POLICY_TOKEN_BUDGET)

# all five fault kinds: logit poisoning (detected same step), lockstep
# aborts, latency spikes (burn deadline ticks), silent cache corruption
# (detected only when the poison reaches the logits)
CAMPAIGN_KINDS = FLT.KINDS
SPIKE_TICKS = 2
SPIKE_US = 500

# generous per-request completion deadline (ticks); the campaigns gate
# goodput, so the deadline is a backstop against pathological queueing,
# not a latency SLO
DEADLINE_TICKS = 600
CLIENT_RETRIES = 8


def _arrivals(cfg, trace, seed: int,
              deadline_ticks: int = 0) -> List[Tuple[int, Request]]:
    rng = np.random.default_rng(seed + 1)
    return [(t.arrival_step,
             Request(t.rid,
                     rng.integers(1, cfg.vocab_size,
                                  size=t.prompt_len).astype(np.int32),
                     t.gen_len, deadline_ticks=deadline_ticks))
            for t in trace]


def _max_len(trace) -> int:
    # chaos headroom: retries replay whole requests and exception faults
    # freeze pos, so the step budget is ~4x the clean-path bound
    return 4 * (traffic.total_tokens(trace)
                + max((t.prompt_len + t.gen_len for t in trace),
                      default=0)) + 64


def _campaign_res(prof: Dict, policy: str) -> RES.ResilienceConfig:
    total = prof["requests"] * (max(prof["prompt_lens"])
                                + max(prof["gen_lens"]))
    # reject_newest bounces the newcomer back to the client (which retries
    # with backoff), so its cap can bind hard; shed_oldest terminally drops
    # committed work, so its cap only absorbs the tail of the arrival burst
    if policy == RES.POLICY_SHED_OLDEST:
        cap = max(prof["requests"] - prof["slots"] - 2,
                  prof["requests"] // 2 + prof["slots"])
    else:
        cap = prof["requests"] // 2 + prof["slots"]
    return RES.ResilienceConfig(
        max_attempts=3, seed=SEED,
        deadline_ticks=DEADLINE_TICKS,
        queue_cap=cap if policy != RES.POLICY_TOKEN_BUDGET else 0,
        shed_policy=policy,
        token_budget=(total // 2
                      if policy == RES.POLICY_TOKEN_BUDGET else 0))


def _replay(cfg, params, prof: Dict, trace, dev,
            plan: Optional[FLT.FaultPlan],
            res: Optional[RES.ResilienceConfig],
            reg: Optional[MetricsRegistry] = None,
            tr: Optional[SpanTracer] = None) -> Engine:
    eng = Engine(cfg, params, prof["slots"], _max_len(trace),
                 metrics=reg, spans=tr, faults=plan, resilience=res,
                 device=dev)
    drv = ReplayDriver(eng, _arrivals(
        cfg, trace, SEED,
        deadline_ticks=DEADLINE_TICKS if res is not None else 0),
        client_retries=CLIENT_RETRIES)
    while drv.active:
        drv.tick()
    return eng


def _lockstep_overhead(cfg, params, prof: Dict, trace, dev
                       ) -> Tuple[Engine, Engine, float]:
    """Plain vs resilience-armed engines on the identical schedule, one
    tick each alternately; returns both engines and the median paired
    per-tick overhead of the armed side."""
    res = RES.ResilienceConfig()  # guard only: no deadlines, no bounds
    off_eng = Engine(cfg, params, prof["slots"], _max_len(trace), device=dev)
    on_eng = Engine(cfg, params, prof["slots"], _max_len(trace),
                    resilience=res, device=dev)
    off = ReplayDriver(off_eng, _arrivals(cfg, trace, SEED))
    on = ReplayDriver(on_eng, _arrivals(cfg, trace, SEED))
    walls: Dict[int, List[float]] = {0: [], 1: []}
    k = 0
    while off.active or on.active:
        order = (off, on) if k % 2 == 0 else (on, off)
        for drv in order:
            t0 = time.perf_counter()
            ticked = drv.tick()
            if ticked:
                walls[0 if drv is off else 1].append(
                    time.perf_counter() - t0)
        k += 1
    n = min(len(walls[0]), len(walls[1]))
    w_off = np.asarray(walls[0][:n])
    w_on = np.asarray(walls[1][:n])
    med_off = float(np.median(w_off)) if n else 0.0
    overhead = float(np.median(w_on - w_off)) / med_off if med_off else 0.0
    return off_eng, on_eng, overhead


def _tokens_by_rid(eng: Engine) -> Dict[int, list]:
    return {r.rid: list(r.out) for r in eng.done}


def run(emit, out_path: Optional[str] = None,
        profiles: Optional[List[str]] = None, device=None) -> None:
    dev = resolve_device(device)
    profiles = profiles or [p.strip() for p in os.environ.get(
        "RESILIENCE_BENCH_PROFILES", "").split(",") if p.strip()] \
        or list(PROFILES)
    rates = [float(r) for r in os.environ.get(
        "RESILIENCE_BENCH_RATES", "").split(",") if r.strip()] \
        or list(RATES)
    cfg = get_config(ARCH).reduced()
    params = MP.init_params(cfg, seed=SEED, device=dev)
    # warm the plain and the guarded step before any timing
    warm = traffic.synth_trace(SEED, 2, 0.0, (2,), (2,))
    for res in (None, RES.ResilienceConfig()):
        _replay(cfg, params, dict(slots=2), warm, dev, None, res)
    records = []
    failures = []
    for profile in profiles:
        prof = PROFILES[profile]
        trace = traffic.synth_trace(SEED, prof["requests"],
                                    prof["mean_interarrival"],
                                    prof["prompt_lens"],
                                    prof["gen_lens"])
        offered = prof["requests"]

        # -- zero-fault lockstep: armed-but-idle must cost nothing ----------
        tag = f"resilience_{ARCH}_{profile}_zero_fault"
        t_section = time.perf_counter()
        off_eng, on_eng, overhead = _lockstep_overhead(
            cfg, params, prof, trace, dev)
        equivalent = _tokens_by_rid(off_eng) == _tokens_by_rid(on_eng)
        if not equivalent:
            failures.append(f"{tag}: armed zero-fault run diverged from "
                            f"the plain engine")
        records.append({
            "arch": ARCH, "profile": profile, "campaign": "zero_fault",
            "seed": SEED, "requests": offered,
            "steps": on_eng.steps,
            "resilience_overhead": round(overhead, 4),
            "equivalent": equivalent,
        })
        emit(tag, (time.perf_counter() - t_section) * 1e6,
             f"ovh={overhead:+.1%}|equiv={equivalent}")

        # -- fault campaigns: rate x shed policy ----------------------------
        # plan horizon covers the worst-case chaotic run length
        horizon = _max_len(trace)
        for rate in rates:
            plan = FLT.FaultPlan.generate(
                SEED, horizon, rate, prof["slots"],
                kinds=CAMPAIGN_KINDS, spike_ticks=SPIKE_TICKS,
                spike_us=SPIKE_US)
            for policy in POLICIES:
                tag = (f"resilience_{ARCH}_{profile}"
                       f"_r{int(rate * 100):02d}_{policy}")
                t_section = time.perf_counter()
                res = _campaign_res(prof, policy)
                streams = []
                last = None
                for _ in range(2):
                    reg = MetricsRegistry()
                    tr = SpanTracer()
                    eng = _replay(cfg, params, prof, trace, dev, plan, res,
                                  reg, tr)
                    streams.append(SP.to_jsonl(tr.events, stable=True))
                    last = (eng, reg, tr)
                eng, reg, tr = last
                deterministic = streams[0] == streams[1]
                if not deterministic:
                    failures.append(f"{tag}: stable span streams of two "
                                    f"same-seed chaos runs differ")
                problems = SP.validate(tr.events, slots=prof["slots"],
                                       engine_steps=eng.steps)
                if problems:
                    failures.append(f"{tag}: span invariants violated "
                                    f"(first: {problems[0]})")
                lost = offered - len(eng.done)
                if lost:
                    failures.append(f"{tag}: {lost} request(s) lost — "
                                    f"no terminal state")
                finished = sum(
                    1 for r in eng.done if r.reason == SP.FINISHED)
                by_reason = {
                    reason: int(reg.get(
                        f"serve_requests_truncated_{reason}_total").value)
                    for reason in RES.REASONS}
                shed = by_reason[RES.REASON_SHED]
                goodput = finished / offered if offered else 0.0
                ticks = sum(eng.health_ticks.values())
                avail = (eng.health_ticks.get(RES.HEALTHY, 0) / ticks
                         if ticks else 1.0)
                faulted_steps = len({s for s in range(eng.steps)
                                     if plan.at(s)})
                records.append({
                    "arch": ARCH, "profile": profile,
                    "campaign": "faults", "policy": policy,
                    "fault_rate": rate, "seed": SEED,
                    "requests": offered, "steps": eng.steps,
                    "faulted_step_frac":
                        round(faulted_steps / eng.steps, 4)
                        if eng.steps else 0.0,
                    "faults_injected": eng.faults_injected,
                    "faults_detected": eng.faults_detected,
                    "retries": eng.retries,
                    "completed": finished,
                    "truncated": by_reason,
                    "lost": lost,
                    "goodput": round(goodput, 4),
                    "availability": round(avail, 4),
                    "retry_amplification":
                        round((offered + eng.retries) / offered, 4)
                        if offered else 1.0,
                    "shed_rate": round(shed / offered, 4)
                    if offered else 0.0,
                    "deterministic": deterministic,
                })
                emit(tag, (time.perf_counter() - t_section) * 1e6,
                     f"goodput={goodput:.2f}|retries={eng.retries}"
                     f"|shed={shed}|avail={avail:.2f}"
                     f"|det={deterministic}")
    out_path = out_path or os.environ.get("RESILIENCE_BENCH_OUT",
                                          "BENCH_resilience_torch.json")
    # write before failing: the artifact is the diagnostic
    with open(out_path, "w") as f:
        json.dump({"schema": 1,
                   "generator": "benchmarks/resilience_bench_torch.py",
                   "seed": SEED,
                   "device": torch_device.label(dev),
                   "records": records}, f, indent=2)
        f.write("\n")
    emit("resilience_bench_json", 0.0,
         f"{len(records)} records -> {out_path}")
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    torch_device.main(run, __doc__, out_help="output JSON path (default "
                      "BENCH_resilience_torch.json or "
                      "$RESILIENCE_BENCH_OUT)", smoke=True)
