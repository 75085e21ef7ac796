"""Per-layer / per-operator profiling for the port's model zoo.

The port of ``repro.obs.modelprof``: the middle tier of the observability
stack, between serving spans (``obs.spans``: one wall time per engine step)
and the hardware path's cycle counters (``core.profiler``).  One record per
*model operator* per engine step, produced by the sliced decode step
(``models.decode.ProfiledServeStep``: embed / per-group attn · mlp / head,
each synchronized and wall-stamped).

Three joined views per config:

* **measured** — :class:`LayerRecord` streams from :class:`LayerProfiler`,
  byte-stable JSONL with the span exporter's conventions (byte-identical to
  the reference's in stable mode);
* **analytic** — :func:`analytic_op_costs`: a dot-FLOPs/bytes/arithmetic-
  intensity cost model per operator derived from ``ModelConfig``,
  cross-checked against ``torch.utils.flop_counter.FlopCounterMode`` over
  the port's decode step (:func:`crosscheck_flops`);
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
o   operator name (``embed``/``attn``/``mlp``/``attn_local``/... /``head``)
g   group index (-1 for embed/head)
n   ``dur_us`` — segment wall microseconds, stamped after the segment's
    device work finished; 0 in stable mode
==  =======================================================================

The reference's roofline classes (``device_peaks``, ``roofline_class``,
``offload_report``) read TPU peaks and wait for the H100's
(``ROADMAP.md`` item 19).
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

# analytic-vs-counted tolerance.  The analytic model counts exactly the dot
# ops the decode step runs (the reference calibrated it against the HLO of
# its step: rel err 0.0 on qwen2-0.5b reduced); here it is held against
# ``torch.utils.flop_counter.FlopCounterMode``, which counts the same
# products (``mm``, ``bmm``) of the port's step.
FLOPS_RTOL = 0.02


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
    the head — because that is what a FLOP counter counts.  Elementwise
    work (softmax, norms, gates, rotary) and gathers are 0 dot-FLOPs by
    that convention.  Dense family (``profile_ops`` raises for the others).
    """
    from repro_torch.models.decode import profile_ops
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
        else:
            raise ValueError(op)
    return costs


def analytic_totals(cfg, batch: int, cache_len: int) -> Tuple[float, float]:
    """(total dot-FLOPs, total bytes) of one decode step."""
    costs = analytic_op_costs(cfg, batch, cache_len)
    return (sum(c.flops for c in costs), sum(c.bytes_rw for c in costs))


# -- analytic-vs-counted cross-check -----------------------------------------


def crosscheck_flops(cfg, batch: int, cache_len: int, device=None,
                     flops_rtol: float = FLOPS_RTOL
                     ) -> Tuple[Dict[str, float], List[str]]:
    """Compare the analytic dot-FLOPs with ``FlopCounterMode``'s count over
    one fused :func:`~repro_torch.models.decode.serve_step` at
    (batch, cache_len), on ``device`` (``cuda`` unless named).  Returns
    (report dict, violations)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import decode
    from repro_torch.models import params as MP
    params = MP.init_params(cfg, seed=0, device=device)
    cache = decode.init_cache(cfg, params, batch, cache_len)
    toks = torch.zeros((batch, 1), dtype=torch.long,
                       device=params["embed"].device)
    with FlopCounterMode(display=False) as counter:
        decode.serve_step(cfg, params, cache, toks, 0)
    counted = float(counter.get_total_flops())
    a_flops, _ = analytic_totals(cfg, batch, cache_len)
    rel = abs(a_flops - counted) / max(counted, 1.0)
    report = {"analytic_flops": a_flops, "counted_flops": counted,
              "flops_rel_err": rel}
    problems: List[str] = []
    if rel > flops_rtol:
        problems.append(
            f"{cfg.name}: analytic flops {a_flops:.3e} vs counted "
            f"{counted:.3e} (rel err {rel:.3f} > {flops_rtol})")
    return report, problems
