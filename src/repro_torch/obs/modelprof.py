"""Per-layer / per-operator profiling for the port's model zoo.

The port of ``repro.obs.modelprof``: the middle tier of the observability
stack, between serving spans (``obs.spans``: one wall time per engine step)
and the hardware path's cycle counters (``core.profiler``).  One record per
*model operator* per engine step, produced by the sliced decode step
(``models.decode.ProfiledServeStep``: embed / per-group attn · mlp, attn ·
moe, RWKV time_mix · channel_mix or zamba2 scan · attn · mlp / head, each
synchronized and wall-stamped).

Three joined views per config:

* **measured** — :class:`LayerRecord` streams from :class:`LayerProfiler`,
  byte-stable JSONL with the span exporter's conventions (byte-identical to
  the reference's in stable mode);
* **analytic** — :func:`analytic_op_costs`: a dot-FLOPs/bytes/arithmetic-
  intensity cost model per operator derived from ``ModelConfig``,
  cross-checked against ``launch.op_analysis`` over the port's decode step
  (:func:`crosscheck`: FLOPs within ``FLOPS_RTOL``, bytes within a factor
  ``BYTES_FACTOR``, the reference's constants);
* **joined** — layer records link to engine-step span events by step
  provenance (record prov ``("engine", "s<step>", "<op>[.g<G>]")`` extends
  span prov ``("engine", "s<step>")``); :func:`join_steps` /
  :func:`join_mismatches` close the request-span -> engine-step ->
  layer-op chain.

Record schema (JSON keys, fixed order -> byte-stable serialization)
-------------------------------------------------------------------

==  =======================================================================
t   ``ts_us`` — wall-clock stamp (tracer epoch); ordinal in stable mode
k   ``kind`` — always ``"layer"``
p   provenance tuple ``["engine", "s<step>", "<op>[.g<group>]"]``
s   engine step index
o   operator name (``embed``/``attn``/``mlp``/``attn_local``/``moe``/
    ``time_mix``/``scan``/ ... /``head``)
g   group index (-1 for embed/head)
n   ``dur_us`` — segment wall microseconds, stamped after the segment's
    device work finished; 0 in stable mode
==  =======================================================================

The roofline classes (:func:`device_peaks`, :func:`roofline_class`,
:func:`offload_report`) are the reference's, over the H100's datasheet
peaks of ``launch.op_stats``.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

KIND = "layer"

# sum(segment walls)/step_wall must land in [JOIN_COVERAGE_MIN, 1]: the
# segments are timed inside the engine-step window, so they can never sum
# past it.  The residual is host-side driver work that is O(1) per step
# regardless of model size — token marshalling, the eager per-step argmax
# dispatch + host transfer, span/metric emission.  On the reduced CPU
# smoke configs that residual is ~0.7-0.8 of a ~1ms step (measured
# coverage band 0.19-0.35 typical for qwen2-0.5b reduced, with isolated
# slow steps — admission bursts, allocator/GC pauses — dipping to ~0.10),
# so the gate floor is deliberately low: it exists to catch a *broken*
# join (records from another run, misattributed steps, lost segments —
# those drive coverage to ~0), not to assert the reduced configs are
# compute-dominated.  The bench reports ``coverage_p50`` per config so
# drift stays visible.
JOIN_COVERAGE_MIN = 0.05

# analytic-vs-counted tolerances, the reference's.  The analytic model
# counts exactly the dot ops the decode step runs (the reference calibrated
# it against the HLO of its step: rel err 0.0 on qwen2-0.5b reduced); here
# it is held against ``launch.op_analysis``, which counts the same products
# (``mm``, ``bmm``) of the port's step.  The bytes band is a factor wide:
# the analytic model counts weights + state + activation I/O once (a
# roofline denominator), the op counter every eager kernel's operands and
# result.
FLOPS_RTOL = 0.02
BYTES_FACTOR = 5.0


def layer_prov(step: int, op: str, group: int) -> Tuple[str, ...]:
    """Extends ``spans.step_prov(step)`` by one level — the op label."""
    label = op if group < 0 else f"{op}.g{group}"
    return ("engine", f"s{step}", label)


@dataclasses.dataclass(frozen=True)
class LayerRecord:
    """One operator execution inside one engine step.  Only ``ts_us`` and
    ``dur_us`` are wall-clock; everything else is deterministic under a
    fixed seed."""
    ts_us: int
    op: str
    group: int
    step: int
    dur_us: int
    prov: Tuple[str, ...] = ()

    def to_json(self, stable_ts: Optional[int] = None) -> str:
        ts = self.ts_us if stable_ts is None else stable_ts
        dur = self.dur_us if stable_ts is None else 0
        return json.dumps({"t": ts, "k": KIND, "p": list(self.prov),
                           "s": self.step, "o": self.op, "g": self.group,
                           "n": dur}, separators=(",", ":"))

    @staticmethod
    def from_json(line: str) -> "LayerRecord":
        o = json.loads(line)
        if o.get("k") != KIND:
            raise ValueError(f"not a layer record: kind={o.get('k')!r}")
        return LayerRecord(o["t"], o["o"], o["g"], o["s"], o["n"],
                           tuple(o["p"]))


class LayerProfiler:
    """Record sink for the profiled engine.

    The engine accepts ``layers=None`` (default) and pays nothing; passing
    a profiler switches the engine to the sliced step.  ``record=False``
    keeps the sliced execution but drops every record — the lockstep
    baseline that isolates recording cost from slicing cost in the
    overhead contract (see module docstring).
    """

    __slots__ = ("records", "record", "_clock", "_t0")

    def __init__(self, record: bool = True, clock=time.perf_counter):
        self.records: List[LayerRecord] = []
        self.record = record
        self._clock = clock
        self._t0 = clock()

    def now_us(self) -> int:
        return int((self._clock() - self._t0) * 1e6)

    def on_step(self, step: int, ops: Sequence[Tuple[str, int]],
                walls_us: Sequence[float],
                ts_us: Optional[int] = None) -> None:
        """Append one record per ``(op, group)`` with its measured wall.
        ``ts_us``: the engine's post-step stamp (its clock when a span
        tracer is attached — the one-clock rule)."""
        if not self.record:
            return
        if ts_us is None:
            ts_us = self.now_us()
        for (op, g), w in zip(ops, walls_us):
            self.records.append(
                LayerRecord(ts_us, op, g, step, int(w),
                            layer_prov(step, op, g)))


# -- serialization -----------------------------------------------------------


def to_jsonl(records: Iterable[LayerRecord], stable: bool = False) -> str:
    """One record per line in emission order; ``stable=True`` normalizes
    the wall-clock fields (``ts_us`` -> ordinal, ``dur_us`` -> 0) exactly
    like the span exporter, so same-seed runs serialize byte-identically."""
    if stable:
        return "".join(r.to_json(stable_ts=i) + "\n"
                       for i, r in enumerate(records))
    return "".join(r.to_json() + "\n" for r in records)


def from_jsonl(text: str) -> List[LayerRecord]:
    return [LayerRecord.from_json(line)
            for line in text.splitlines() if line.strip()]


# -- invariants --------------------------------------------------------------


def validate(records: Sequence[LayerRecord], cfg=None,
             engine_steps: int = -1) -> List[str]:
    """Layer-record invariants; returns violation strings (empty = ok).

    * provenance matches the record's (step, op, group);
    * durations are non-negative, groups are >= -1;
    * steps are contiguous from 0 and, when ``engine_steps`` is given,
      count exactly that many;
    * with ``cfg``: every step carries exactly ``profile_ops(cfg)`` — the
      complete op set, in execution order (the completeness half of the
      three-level join).
    """
    out: List[str] = []
    per_step: Dict[int, List[LayerRecord]] = {}
    for i, r in enumerate(records):
        if r.prov != layer_prov(r.step, r.op, r.group):
            out.append(f"record {i}: prov {r.prov} != "
                       f"{layer_prov(r.step, r.op, r.group)}")
        if r.dur_us < 0:
            out.append(f"record {i}: negative dur_us {r.dur_us}")
        if r.group < -1:
            out.append(f"record {i}: group {r.group} < -1")
        per_step.setdefault(r.step, []).append(r)
    steps = sorted(per_step)
    if steps != list(range(len(steps))):
        out.append(f"steps not contiguous from 0: {steps[:10]}")
    if engine_steps >= 0 and len(steps) != engine_steps:
        out.append(f"{len(steps)} profiled steps but engine ran "
                   f"{engine_steps}")
    if cfg is not None:
        from repro_torch.models.decode import profile_ops
        want = list(profile_ops(cfg))
        for s in steps:
            got = [(r.op, r.group) for r in per_step[s]]
            if got != want:
                out.append(f"step {s}: ops {got} != expected {want}")
    return out


# -- aggregation -------------------------------------------------------------


@dataclasses.dataclass
class OpSummary:
    op: str
    group: int
    calls: int = 0
    wall_us: int = 0

    @property
    def mean_us(self) -> float:
        return self.wall_us / self.calls if self.calls else 0.0


def summarize(records: Sequence[LayerRecord]
              ) -> Dict[Tuple[str, int], OpSummary]:
    """Aggregate wall time per (op, group) across all steps."""
    out: Dict[Tuple[str, int], OpSummary] = {}
    for r in records:
        s = out.setdefault((r.op, r.group), OpSummary(r.op, r.group))
        s.calls += 1
        s.wall_us += r.dur_us
    return out


def op_shares(records: Sequence[LayerRecord]) -> Dict[str, float]:
    """Fraction of total profiled wall per operator *kind* (groups
    summed) — the flame-table column and the offload ranking key."""
    by_op: Dict[str, int] = {}
    for r in records:
        by_op[r.op] = by_op.get(r.op, 0) + r.dur_us
    total = sum(by_op.values())
    if not total:
        return {op: 0.0 for op in by_op}
    return {op: w / total for op, w in by_op.items()}


# -- the three-level join ----------------------------------------------------


@dataclasses.dataclass
class JoinRow:
    """One engine step's span event joined to its layer records."""
    step: int
    step_wall_us: int          # span event dur_us
    layers_wall_us: int        # sum of segment walls
    layer_count: int

    @property
    def coverage(self) -> float:
        """Fraction of the step wall attributed to model operators; the
        remainder is host-side driver residual."""
        if self.step_wall_us <= 0:
            return 0.0
        return self.layers_wall_us / self.step_wall_us


def join_steps(records: Sequence[LayerRecord],
               events: Sequence[Any]) -> Dict[int, JoinRow]:
    """Join layer records to engine-step span events by step provenance.
    ``events`` is the span stream (``obs.spans.SpanEvent``); only ``step``
    events participate."""
    from . import spans as SP
    walls: Dict[int, int] = {}
    counts: Dict[int, int] = {}
    for r in records:
        walls[r.step] = walls.get(r.step, 0) + r.dur_us
        counts[r.step] = counts.get(r.step, 0) + 1
    out: Dict[int, JoinRow] = {}
    for ev in events:
        if ev.kind != SP.STEP:
            continue
        if ev.prov != SP.step_prov(ev.step):
            continue
        out[ev.step] = JoinRow(ev.step, ev.dur_us,
                               walls.get(ev.step, 0),
                               counts.get(ev.step, 0))
    return out


def join_mismatches(records: Sequence[LayerRecord], events: Sequence[Any],
                    cfg=None, coverage_min: float = JOIN_COVERAGE_MIN
                    ) -> List[str]:
    """Violations of the three-level join (empty = the join closes):
    every step span has a complete record set (when ``cfg`` given), and
    summed segment walls land in ``[coverage_min, 1] * step_wall``."""
    out = list(validate(records, cfg=cfg))
    rows = join_steps(records, events)
    profiled_steps = {r.step for r in records}
    if profiled_steps - set(rows):
        out.append(f"layer records for steps without a step span: "
                   f"{sorted(profiled_steps - set(rows))[:10]}")
    for step, row in sorted(rows.items()):
        if row.layer_count == 0:
            out.append(f"step {step}: span event has no layer records")
            continue
        if row.step_wall_us > 0 and row.layers_wall_us > row.step_wall_us:
            out.append(f"step {step}: layer walls {row.layers_wall_us}us "
                       f"exceed step wall {row.step_wall_us}us "
                       f"(segments must nest inside the step)")
        if row.step_wall_us > 0 and row.coverage < coverage_min:
            out.append(f"step {step}: coverage {row.coverage:.2f} < "
                       f"{coverage_min} (layers {row.layers_wall_us}us of "
                       f"step {row.step_wall_us}us)")
    return out


# -- analytic cost model -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Analytic per-call cost of one operator: dot-FLOPs (the dot-only
    convention ``FlopCounterMode`` shares) and HBM bytes (weights +
    state/cache + activation I/O — the roofline denominator)."""
    op: str
    group: int
    flops: float
    bytes_rw: float

    @property
    def intensity(self) -> float:
        """Arithmetic intensity in FLOPs/byte."""
        return self.flops / self.bytes_rw if self.bytes_rw else 0.0


def _dtype_bytes(name: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}.get(name, 4)


def analytic_op_costs(cfg, batch: int, cache_len: int) -> List[OpCost]:
    """Per-operator cost list aligned 1:1 with
    ``models.decode.profile_ops(cfg)`` for a single decode step.

    FLOPs count exactly the matmul-like (``dot``) terms — projections,
    attention scores/PV over the full static cache span (the decode path
    computes masked attention over all ``cache_len`` positions), MLP and
    expert products (every expert at its capacity), the router, RWKV mixing
    matrices, Mamba's projections and conv window dot, the decay-scan
    output dot, and the head — because that is what a FLOP counter counts.
    Elementwise work (softmax, norms, gates, rotary, state outer products)
    and gathers are 0 dot-FLOPs by that convention.  The families
    ``profile_ops`` decomposes (it raises for audio and vlm).
    """
    from repro_torch.models.decode import profile_ops
    from repro_torch.models.moe import capacity
    from repro_torch.models.params import gated_mlp

    B, S = batch, cache_len
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    es = _dtype_bytes(cfg.dtype)
    n_mat = 3 if gated_mlp(cfg) else 2

    def attn_cost(op: str, g: int) -> OpCost:
        flops = 2 * B * (d * h * dh + 2 * d * hkv * dh   # q, k, v proj
                         + 2 * h * dh * S                # scores + PV
                         + h * dh * d)                   # out proj
        w = (d * h * dh + 2 * d * hkv * dh + h * dh * d) * es
        if cfg.qkv_bias:
            w += (h + 2 * hkv) * dh * es
        kv = 2 * B * hkv * S * dh * es      # cache read
        kv += 2 * 2 * B * hkv * dh * es     # update slice (r+w convention)
        return OpCost(op, g, flops, w + kv + 2 * B * d * es)

    def mlp_cost(op: str, g: int) -> OpCost:
        flops = n_mat * 2 * B * d * f
        byts = n_mat * d * f * es + 2 * B * d * es + 2 * B * f * es
        return OpCost(op, g, flops, byts)

    def moe_cost(g: int) -> OpCost:
        E, cap = cfg.num_experts, capacity(cfg, B)
        flops = 2 * B * d * E + n_mat * 2 * E * cap * d * f
        byts = (d * E * 4 + n_mat * E * d * f * es
                + 2 * E * cap * d * es + 2 * B * d * es)
        return OpCost("moe", g, flops, byts)

    def time_mix_cost(g: int) -> OpCost:
        lora_w, lora_mix = 64, 32
        flops = 2 * B * (d * 5 * lora_mix          # ddlerp mix_A
                         + 5 * d * lora_mix        # ddlerp mix_B
                         + 4 * d * h * dh          # wr/wk/wv/wg
                         + d * lora_w + lora_w * d  # decay lora
                         + h * dh * dh             # decay-scan output dot
                         + h * dh * d)             # wo
        w = (d * 5 * lora_mix + 5 * lora_mix * d + 4 * d * h * dh
             + d * lora_w + lora_w * d + h * dh * d + 5 * d) * es
        state = 2 * B * h * dh * dh * 4            # wkv state r/w (f32)
        state += 2 * B * d * es                    # shift state r/w
        return OpCost("time_mix", g, flops, w + state + 2 * B * d * es)

    def channel_mix_cost(g: int) -> OpCost:
        flops = 2 * B * (d * f + f * d + d * d)
        byts = ((2 * d * f + d * d) * es + 2 * B * d * es  # shift r/w
                + 2 * B * d * es)
        return OpCost("channel_mix", g, flops, byts)

    def scan_cost(g: int) -> OpCost:
        n_mamba = cfg.hybrid_attn_every - 1
        d_inner = 2 * d
        nh = d_inner // cfg.ssm_head_dim
        st = cfg.ssm_state
        ch = d_inner + 2 * st
        proj = 2 * d_inner + 2 * st + nh
        per = 2 * B * (d * proj                    # in_proj
                       + ch * cfg.ssm_conv_width   # conv window dot
                       + nh * st * cfg.ssm_head_dim  # decay-scan output
                       + d_inner * d)              # out_proj
        w = (d * proj + cfg.ssm_conv_width * ch + d_inner * d) * es
        state = 2 * B * nh * st * cfg.ssm_head_dim * 4  # h state r/w
        state += 2 * B * (cfg.ssm_conv_width - 1) * ch * es  # conv window
        per_bytes = w + state + 2 * B * d * es
        return OpCost("scan", g, n_mamba * per, n_mamba * per_bytes)

    costs: List[OpCost] = []
    for op, g in profile_ops(cfg):
        if op == "embed":
            costs.append(OpCost(op, g, 0.0, 2 * B * d * es + 4 * B))
        elif op == "head":
            costs.append(OpCost(op, g, 2 * B * d * V,
                                d * V * es + B * V * 4 + B * d * es))
        elif op in ("attn", "attn_local", "attn_global"):
            costs.append(attn_cost(op, g))
        elif op in ("mlp", "mlp_local", "mlp_global"):
            costs.append(mlp_cost(op, g))
        elif op == "moe":
            costs.append(moe_cost(g))
        elif op == "time_mix":
            costs.append(time_mix_cost(g))
        elif op == "channel_mix":
            costs.append(channel_mix_cost(g))
        elif op == "scan":
            costs.append(scan_cost(g))
        else:
            raise ValueError(op)
    return costs


def analytic_totals(cfg, batch: int, cache_len: int) -> Tuple[float, float]:
    """(total dot-FLOPs, total bytes) of one decode step."""
    costs = analytic_op_costs(cfg, batch, cache_len)
    return (sum(c.flops for c in costs), sum(c.bytes_rw for c in costs))


# -- analytic-vs-counted cross-check -----------------------------------------


def crosscheck(cfg, batch: int, cache_len: int, device=None, params=None,
               flops_rtol: float = FLOPS_RTOL,
               bytes_factor: float = BYTES_FACTOR
               ) -> Tuple[Dict[str, float], List[str]]:
    """Compare the analytic model with ``launch.op_analysis``'s count of one
    fused :func:`~repro_torch.models.decode.serve_step` at (batch,
    cache_len) on ``device`` (``cuda`` unless named), with seed-0 weights
    or ``params``.  Returns (report dict, violations)."""
    import torch
    from repro_torch.launch import op_analysis
    from repro_torch.models import decode
    from repro_torch.models import params as MP
    if params is None:
        params = MP.init_params(cfg, seed=0, device=device)
    cache = decode.init_cache(cfg, params, batch, cache_len)
    toks = torch.zeros((batch, 1), dtype=torch.long,
                       device=params["embed"].device)
    counted = op_analysis.analyze(decode.serve_step, cfg, params, cache,
                                  toks, 0)
    a_flops, a_bytes = analytic_totals(cfg, batch, cache_len)
    rel = abs(a_flops - counted.flops) / max(counted.flops, 1.0)
    ratio = (a_bytes / counted.traffic_bytes if counted.traffic_bytes
             else float("inf"))
    report = {"analytic_flops": a_flops, "counted_flops": counted.flops,
              "flops_rel_err": rel, "analytic_bytes": a_bytes,
              "counted_bytes": counted.traffic_bytes, "bytes_ratio": ratio,
              "collective_bytes": counted.total_collective_bytes}
    problems: List[str] = []
    if rel > flops_rtol:
        problems.append(
            f"{cfg.name}: analytic flops {a_flops:.3e} vs counted "
            f"{counted.flops:.3e} (rel err {rel:.3f} > {flops_rtol})")
    if not (1.0 / bytes_factor <= ratio <= bytes_factor):
        problems.append(
            f"{cfg.name}: analytic bytes {a_bytes:.3e} vs counted "
            f"{counted.traffic_bytes:.3e} (ratio {ratio:.2f} outside "
            f"[1/{bytes_factor}, {bytes_factor}])")
    return report, problems


# -- roofline classification + offload candidates ----------------------------


def device_peaks() -> Tuple[float, float]:
    """(peak FLOPs/s, HBM bytes/s) of the modeled accelerator: the H100's
    datasheet figures (``launch.op_stats``)."""
    from repro_torch.launch import op_stats
    return float(op_stats.PEAK_FLOPS_BF16), float(op_stats.HBM_BW)


def roofline_class(intensity: float,
                   peaks: Optional[Tuple[float, float]] = None) -> str:
    """``compute``- vs ``memory``-bound against the device ridge point."""
    peak_flops, bw = peaks or device_peaks()
    ridge = peak_flops / bw
    return "compute" if intensity >= ridge else "memory"


def offload_report(cfg, records: Sequence[LayerRecord],
                   costs: Sequence[OpCost],
                   peaks: Optional[Tuple[float, float]] = None
                   ) -> List[Dict[str, Any]]:
    """Ranked Calyx-lowering candidates: one row per operator *kind*,
    ordered by measured share of decode-step time, annotated with the
    analytic per-step FLOPs/bytes/intensity and roofline class.

    ``costs`` should be the analytic costs at the *deployment* shape (the
    full config / production cache length), while ``records`` carry the
    measured walls — the measured ranking tells us where the step time
    goes, the analytic columns tell us what an accelerator would have to
    beat at scale.
    """
    shares = op_shares(records)
    summary = summarize(records)
    by_op: Dict[str, Dict[str, float]] = {}
    for c in costs:
        row = by_op.setdefault(c.op, {"flops": 0.0, "bytes": 0.0})
        row["flops"] += c.flops
        row["bytes"] += c.bytes_rw
    rows: List[Dict[str, Any]] = []
    for op, share in shares.items():
        cost = by_op.get(op, {"flops": 0.0, "bytes": 0.0})
        intensity = (cost["flops"] / cost["bytes"]
                     if cost["bytes"] else 0.0)
        wall = sum(s.wall_us for (o, _), s in summary.items() if o == op)
        calls = sum(s.calls for (o, _), s in summary.items() if o == op)
        rows.append({
            "op": op,
            "share": round(share, 4),
            "wall_us_mean": round(wall / calls, 1) if calls else 0.0,
            "flops_per_step": cost["flops"],
            "bytes_per_step": cost["bytes"],
            "intensity": round(intensity, 3),
            "bound": roofline_class(intensity, peaks),
        })
    rows.sort(key=lambda r: -r["share"])
    for rank, r in enumerate(rows, 1):
        r["rank"] = rank
    return rows
