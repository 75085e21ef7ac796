"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

Dependency-free (stdlib only).  Instruments are created through a
:class:`MetricsRegistry` (get-or-create by name, type conflicts raise) and
exported either as Prometheus text exposition format
(:meth:`MetricsRegistry.to_prometheus`) or as a JSON document
(:meth:`MetricsRegistry.to_json`); both iterate names in sorted order so
the output is deterministic.

Histogram quantiles
-------------------

:class:`Histogram` stores only fixed-bucket counts (plus sum/count/min/max)
and estimates quantiles by linear interpolation inside the selected bucket,
Prometheus ``histogram_quantile`` style: the target rank is ``q * count``,
the first bucket whose cumulative count reaches the rank is selected, and
the result interpolates between the bucket's lower and upper bound by the
rank's position among the bucket's samples.  Two exactness properties are
unit-tested against numpy (``tests/test_obs_metrics.py``):

* **value-aligned buckets are exact** — when every distinct observation
  equals a bucket upper bound and ``q * count`` is an integer (p50/p90/p99
  over 100 samples), the estimate equals
  ``numpy.quantile(data, q, method="inverted_cdf")`` exactly;
* **coarse buckets are off by less than one bucket width** — for arbitrary
  data the estimate is within the selected bucket, so it differs from the
  exact (linear-interpolation) numpy quantile by strictly less than that
  bucket's width.

The first bucket's lower bound is clamped to the observed minimum and the
overflow bucket's upper bound to the observed maximum, so estimates never
leave the observed value range.
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Dict, List, Sequence, Tuple, Union

Number = Union[int, float]

# log-spaced microsecond buckets, 100us .. 10s — the default for the
# serving latency histograms (TTFT, per-step, per-token)
DEFAULT_TIME_BUCKETS_US: Tuple[float, ...] = (
    100, 200, 500,
    1_000, 2_000, 5_000,
    10_000, 20_000, 50_000,
    100_000, 200_000, 500_000,
    1_000_000, 2_000_000, 5_000_000, 10_000_000,
)


def _fmt(v: Number) -> str:
    """Exposition-format number: integral values print without a dot."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonically increasing value."""

    kind = "counter"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.value: Number = 0

    def inc(self, v: Number = 1) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        self.value += v

    def as_json(self) -> Dict[str, object]:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-set value."""

    kind = "gauge"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v

    def inc(self, v: Number = 1) -> None:
        self.value += v

    def dec(self, v: Number = 1) -> None:
        self.value -= v

    def as_json(self) -> Dict[str, object]:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles (see module
    docstring for the exactness contract)."""

    kind = "histogram"
    __slots__ = ("name", "help", "bounds", "bucket_counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[Number] = DEFAULT_TIME_BUCKETS_US) -> None:
        if not buckets:
            raise ValueError(f"histogram {name}: empty bucket list")
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name}: buckets must be strictly "
                             f"increasing, got {buckets}")
        self.name = name
        self.help = help
        self.bounds: List[float] = bounds       # finite upper bounds
        self.bucket_counts: List[int] = [0] * (len(bounds) + 1)  # +overflow
        self.count = 0
        self.sum: float = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: Number) -> None:
        v = float(v)
        # first bucket with bound >= v (Prometheus `le` semantics)
        self.bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (0 <= q <= 1); nan when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        rank = q * self.count
        cum = 0
        for i, n in enumerate(self.bucket_counts):
            if n == 0:
                continue
            if cum + n >= rank:
                lo = self.min if i == 0 else self.bounds[i - 1]
                hi = self.max if i == len(self.bounds) else self.bounds[i]
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (rank - cum) / n
                return lo + (hi - lo) * frac
            cum += n
        return self.max

    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def as_json(self) -> Dict[str, object]:
        return {
            "kind": self.kind,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "buckets": {_fmt(b): c
                        for b, c in zip(self.bounds, self.bucket_counts)},
            "overflow": self.bucket_counts[-1],
            "p50": self.quantile(0.5) if self.count else None,
            "p90": self.quantile(0.9) if self.count else None,
            "p99": self.quantile(0.99) if self.count else None,
        }


Instrument = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Get-or-create instrument registry with deterministic exporters."""

    __slots__ = ("_instruments",)

    def __init__(self) -> None:
        self._instruments: Dict[str, Instrument] = {}

    def _get(self, cls, name: str, help: str, **kw) -> Instrument:
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, help, **kw)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name} already registered as "
                            f"{inst.kind}, requested {cls.kind}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[Number] = DEFAULT_TIME_BUCKETS_US
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Instrument:
        return self._instruments[name]

    def names(self) -> List[str]:
        return sorted(self._instruments)

    # -- exporters -----------------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, names in sorted order."""
        lines: List[str] = []
        for name in self.names():
            inst = self._instruments[name]
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            if isinstance(inst, Histogram):
                cum = 0
                for b, n in zip(inst.bounds, inst.bucket_counts):
                    cum += n
                    lines.append(f'{name}_bucket{{le="{_fmt(b)}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {inst.count}')
                lines.append(f"{name}_sum {_fmt(inst.sum)}")
                lines.append(f"{name}_count {inst.count}")
            else:
                lines.append(f"{name} {_fmt(inst.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> Dict[str, object]:
        return {"schema": 1,
                "metrics": {name: self._instruments[name].as_json()
                            for name in self.names()}}

    def dump_json(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True) + "\n"
