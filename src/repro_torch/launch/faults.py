"""Seeded, replayable fault injection for the continuous-batching engine.

    PYTHONPATH=src python -m repro.launch.faults --seed 7 --steps 64 \
        --rate 0.05 --slots 4 --out /tmp/plan.json

A :class:`FaultPlan` is a deterministic schedule of step-level faults the
engine (``repro.launch.serve.Engine``) applies while it runs.  Plans are a
pure function of their generation arguments (``generate`` draws from one
``numpy`` PRNG stream), serialize to JSON (``save``/``load``), and replay
byte-identically: two engines driven by the same seed, trace, and plan
produce the same span stream in the exporter's ``--stable`` mode — every
chaos run is reproducible, which is what makes the resilience benchmark
(``benchmarks/resilience_bench.py``) gateable in CI.

Fault taxonomy
--------------

==================  ========================================================
kind                effect on the engine step it fires at
==================  ========================================================
``nan_logits``      the target slot's sampled logits row becomes NaN —
                    models an overflowed accumulation / bad kernel output
``inf_logits``      same, with +Inf — a saturated activation
``exception``       the step computation raises :class:`InjectedFault` —
                    models a device/runtime error for the whole lockstep
                    batch (no tokens, no cache advance)
``latency_spike``   the step stalls (``spike_us`` of real sleep) and the
                    deadline clock jumps ``spike_ticks`` — models GC /
                    preemption / a slow collective
``cache_corrupt``   the target slot's cache entries are silently set to
                    NaN *after* the step — undetectable until the poison
                    reaches the logits on a later step
==================  ========================================================

Slot-targeted faults (``nan_logits``/``inf_logits``/``cache_corrupt``) hit
whatever request occupies the slot when they fire — including none; a
corruption planted in a free slot ambushes the next request admitted there,
which is exactly the nastiest real-world variant.

The engine injects faults regardless of whether resilience is enabled:
injection without ``ResilienceConfig`` is the negative control showing the
finite-guard is load-bearing (``tests/test_serve_faults.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

NAN_LOGITS = "nan_logits"
INF_LOGITS = "inf_logits"
EXCEPTION = "exception"
LATENCY_SPIKE = "latency_spike"
CACHE_CORRUPT = "cache_corrupt"

KINDS = (NAN_LOGITS, INF_LOGITS, EXCEPTION, LATENCY_SPIKE, CACHE_CORRUPT)
SLOT_KINDS = (NAN_LOGITS, INF_LOGITS, CACHE_CORRUPT)


class InjectedFault(RuntimeError):
    """Raised by an ``exception`` fault inside the engine step."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault firing at one engine step."""
    step: int                  # engine step index the fault fires at
    kind: str                  # one of KINDS
    slot: int = -1             # target slot for SLOT_KINDS (-1 otherwise)
    spike_ticks: int = 0       # latency_spike: deadline-clock penalty
    spike_us: int = 0          # latency_spike: real wall-clock stall

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {KINDS})")
        if self.kind in SLOT_KINDS and self.slot < 0:
            raise ValueError(f"{self.kind} fault needs a slot >= 0")

    def to_json(self) -> Dict[str, int]:
        return {"step": self.step, "kind": self.kind, "slot": self.slot,
                "spike_ticks": self.spike_ticks, "spike_us": self.spike_us}

    @staticmethod
    def from_json(o: Dict) -> "FaultSpec":
        return FaultSpec(int(o["step"]), str(o["kind"]),
                         int(o.get("slot", -1)),
                         int(o.get("spike_ticks", 0)),
                         int(o.get("spike_us", 0)))


class FaultPlan:
    """An ordered, replayable schedule of :class:`FaultSpec`."""

    __slots__ = ("specs", "meta", "_by_step")

    def __init__(self, specs: Sequence[FaultSpec],
                 meta: Dict[str, object] | None = None) -> None:
        self.specs: Tuple[FaultSpec, ...] = tuple(
            sorted(specs, key=lambda s: (s.step, s.kind, s.slot)))
        self.meta: Dict[str, object] = dict(meta or {})
        by_step: Dict[int, List[FaultSpec]] = {}
        for s in self.specs:
            by_step.setdefault(s.step, []).append(s)
        self._by_step = {k: tuple(v) for k, v in by_step.items()}

    def __len__(self) -> int:
        return len(self.specs)

    def at(self, step: int) -> Tuple[FaultSpec, ...]:
        """Faults firing at engine step ``step`` (deterministic order)."""
        return self._by_step.get(step, ())

    # -- generation ----------------------------------------------------------

    @classmethod
    def generate(cls, seed: int, steps: int, rate: float,
                 slots: int, kinds: Sequence[str] = KINDS,
                 spike_ticks: int = 4, spike_us: int = 2000) -> "FaultPlan":
        """Draw a seeded campaign: each of ``steps`` engine steps faults
        independently with probability ``rate``; the kind is uniform over
        ``kinds`` and slot-targeted kinds pick a uniform slot.  One PRNG
        stream, consumed in step order — the plan is a pure function of
        its arguments."""
        for k in kinds:
            if k not in KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = np.random.default_rng(seed)
        specs: List[FaultSpec] = []
        for step in range(steps):
            if rng.random() >= rate:
                continue
            kind = kinds[int(rng.integers(len(kinds)))]
            slot = int(rng.integers(slots)) if kind in SLOT_KINDS else -1
            specs.append(FaultSpec(
                step, kind, slot,
                spike_ticks=spike_ticks if kind == LATENCY_SPIKE else 0,
                spike_us=spike_us if kind == LATENCY_SPIKE else 0))
        return cls(specs, meta={"seed": seed, "steps": steps, "rate": rate,
                                "slots": slots, "kinds": list(kinds)})

    # -- serialization -------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({"schema": 1, "meta": self.meta,
                           "faults": [s.to_json() for s in self.specs]},
                          indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        o = json.loads(text)
        return cls([FaultSpec.from_json(f) for f in o.get("faults", [])],
                   meta=o.get("meta", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.specs:
            out[s.kind] = out.get(s.kind, 0) + 1
        return out


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Generate a seeded, replayable fault plan")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=64,
                    help="engine-step horizon the plan covers")
    ap.add_argument("--rate", type=float, default=0.05,
                    help="per-step fault probability")
    ap.add_argument("--slots", type=int, default=4,
                    help="engine slot count (targets of slot faults)")
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help="comma-separated fault kinds to draw from")
    ap.add_argument("--spike-ticks", type=int, default=4)
    ap.add_argument("--spike-us", type=int, default=2000)
    ap.add_argument("--out", required=True, help="write the plan JSON here")
    args = ap.parse_args()
    kinds = tuple(k.strip() for k in args.kinds.split(",") if k.strip())
    plan = FaultPlan.generate(args.seed, args.steps, args.rate, args.slots,
                              kinds=kinds, spike_ticks=args.spike_ticks,
                              spike_us=args.spike_us)
    plan.save(args.out)
    print(f"[faults] {len(plan)} faults over {args.steps} steps "
          f"({plan.counts()}) -> {args.out}")


if __name__ == "__main__":
    main()
