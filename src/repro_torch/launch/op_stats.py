"""Collective statistics and roofline terms; the twin of
``repro.launch.hlo_stats``.

The reference sums collective bytes out of HLO text and models a TPU v5e.
The port's collective counts come from ``launch.op_analysis`` (the ops
DTensor issues), so :class:`CollectiveStats` is built from an
:class:`~repro_torch.launch.op_analysis.OpCounter` (:meth:`from_counter`);
the HLO-text helper ``collective_stats`` has no torch input and is not
ported.  ``count_op``'s counterpart is ``OpCounter.op_counts`` (aten op name
-> calls), which ``benchmarks/banking_ablation_torch.py`` reads.

The roofline models one NVIDIA H100 SXM5 (80GB HBM3, 700 W), the card the
port runs on.  Every constant is the datasheet's, none is measured:

  * ``PEAK_FLOPS_BF16`` 989.4e12 FLOP/s: dense bf16 on the tensor cores;
  * ``HBM_BW`` 3.35e12 B/s;
  * ``LINK_BW`` 25e9 B/s per NVLink 4 link and direction, ``LINKS`` 18;
  * ``HBM_BYTES`` 80e9 B of HBM3 a card, against which the dry run's
    ``peak_live_bytes`` is read (``scripts/gen_experiments_torch.py``).

The collective term charges a device's collective bytes against its 18
links.  A 256- or 512-GPU mesh spans many NVLink domains (8 GPUs a
server), where traffic between servers runs over far slower networks, so
there the collective term is a lower bound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS_BF16 = 989.4e12      # per card, dense bf16 (datasheet)
HBM_BW = 3.35e12                # bytes/s per card (datasheet)
LINK_BW = 25e9                  # bytes/s per NVLink 4 link, one direction (datasheet)
LINKS = 18                      # NVLink 4 links per card (datasheet)
HBM_BYTES = 80e9                # bytes of HBM3 per card (datasheet)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @classmethod
    def from_counter(cls, counter) -> "CollectiveStats":
        """The collective bytes and op counts an ``OpCounter`` saw."""
        return cls({k: int(v) for k, v in counter.collective_bytes.items()},
                   dict(counter.collective_count))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def as_dict(self):
        return {"bytes_by_kind": self.bytes_by_kind,
                "count_by_kind": self.count_by_kind,
                "total_bytes": self.total_bytes,
                "total_count": self.total_count}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float                # per-device counted flops
    bytes_accessed: float       # per-device counted bytes
    collective_bytes: float     # per-device collective bytes
    model_flops: float = 0.0    # 6*N*D (useful work, global)
    chips: int = 1

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (counted FLOPs * chips): remat/redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the cards' peak that USEFUL work achieves at the
        modeled step time (an MFU bound)."""
        t = self.step_time_s
        if not t or not self.model_flops:
            return 0.0
        return self.model_flops / (t * self.chips * PEAK_FLOPS_BF16)

    def as_dict(self):
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
            "step_time_s": self.step_time_s,
            "chips": self.chips,
        }


def roofline_terms(cost: Dict, coll: CollectiveStats, chips: int,
                   model_flops: float, links: int = LINKS) -> Roofline:
    """cost: ``{"flops", "bytes accessed"}`` per device."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll.total_bytes)
    return Roofline(
        compute_s=flops / PEAK_FLOPS_BF16,
        memory_s=byts / HBM_BW,
        collective_s=cbytes / (LINK_BW * links),
        flops=flops, bytes_accessed=byts, collective_bytes=cbytes,
        model_flops=model_flops, chips=chips,
    )
