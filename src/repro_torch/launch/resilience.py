"""Resilience policy for the continuous-batching engine.

Everything here is pure configuration + deterministic arithmetic; the
mechanisms live in ``repro.launch.serve.Engine`` and are zero-cost when no
:class:`ResilienceConfig` is passed (same ``if x is not None`` hook
convention as ``repro.obs``).

Three policy surfaces:

* **Detection / degradation** — ``finite_guard`` screens sampled logits
  every step; a non-finite row quarantines the slot (cache reset, slot
  released) and requeues the victim with capped exponential backoff +
  deterministic jitter (:func:`backoff_ticks`).  Engine health walks
  ``healthy -> degraded -> draining``: degraded while faults are recent,
  back to healthy after ``recovery_ticks`` clean ticks, draining (stop
  admitting, shed new work) when ``drain_faults`` faults land within a
  ``drain_window``-tick sliding window.

* **Deadlines** — per-request TTFT and completion deadlines measured on
  the engine's *tick* clock (steps + latency-spike penalties), so
  enforcement is structurally deterministic; wall-clock variants exist as
  per-request fields for interactive callers.  Expired requests release
  their slot with the distinct ``deadline`` reason.

* **Admission control** — ``queue_cap`` bounds the queue; on overflow one
  of three shedding policies runs: ``reject_newest`` (bounce the
  arrival — retryable), ``shed_oldest`` (evict the stalest queued request
  to admit the new one), ``token_budget`` (reject arrivals whose
  estimated token footprint exceeds a per-queue budget derived from
  ``decode.step_stats``).

All knobs are frozen-dataclass fields so a config hashes/compares cleanly
and campaign grids in ``benchmarks/resilience_bench.py`` can sweep it.
"""
from __future__ import annotations

import dataclasses

HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
HEALTH_CODE = {HEALTHY: 0, DEGRADED: 1, DRAINING: 2}

POLICY_REJECT_NEWEST = "reject_newest"
POLICY_SHED_OLDEST = "shed_oldest"
POLICY_TOKEN_BUDGET = "token_budget"
SHED_POLICIES = (POLICY_REJECT_NEWEST, POLICY_SHED_OLDEST,
                 POLICY_TOKEN_BUDGET)

# Termination reasons carried in ``truncated:<reason>`` span details and
# the per-reason serve_requests_truncated_* counters.
REASON_MAX_LEN = "max_len"
REASON_DEADLINE = "deadline"
REASON_SHED = "shed"
REASON_FAULT = "fault"
REASON_RETRY_EXHAUSTED = "quarantine_retry_exhausted"
REASONS = (REASON_MAX_LEN, REASON_DEADLINE, REASON_SHED, REASON_FAULT,
           REASON_RETRY_EXHAUSTED)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs for detection, retry, deadlines, and admission control.

    A zero value disables the corresponding limit (``queue_cap=0`` means
    unbounded, ``deadline_ticks=0`` means no deadline, ``drain_faults=0``
    means the engine never drains).
    """
    # detection + quarantine
    finite_guard: bool = True       # screen sampled logits for NaN/Inf
    max_attempts: int = 3           # total tries incl. the first
    backoff_base: int = 2           # ticks before retry, attempt 1
    backoff_cap: int = 32           # ceiling on the exponential term
    backoff_jitter: int = 2         # jitter span in ticks (deterministic)
    seed: int = 0                   # jitter hash seed
    # admission control
    queue_cap: int = 0              # max queued requests (0 = unbounded)
    shed_policy: str = POLICY_REJECT_NEWEST
    token_budget: int = 0           # token_budget policy: max estimated
    #                                 queued tokens (0 = derive 4x cap)
    # deadlines (engine ticks; 0 disables)
    ttft_deadline_ticks: int = 0    # enqueue -> first token
    deadline_ticks: int = 0         # enqueue -> completion
    # health state machine
    recovery_ticks: int = 8         # clean ticks: degraded -> healthy
    drain_faults: int = 0           # faults in window -> draining (0=off)
    drain_window: int = 16          # sliding window, ticks

    def __post_init__(self):
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed policy {self.shed_policy!r} "
                             f"(known: {SHED_POLICIES})")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")


def _mix(h: int, v: int) -> int:
    # splitmix64-style integer hash step: deterministic, platform-stable.
    h = (h + 0x9E3779B97F4A7C15 + v) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return h ^ (h >> 31)


def backoff_ticks(cfg: ResilienceConfig, rid: int, attempt: int) -> int:
    """Retry delay (engine ticks) before attempt ``attempt+1`` of ``rid``:
    capped exponential plus a deterministic per-(seed, rid, attempt)
    jitter, so two runs of the same campaign back off identically."""
    base = min(cfg.backoff_cap, cfg.backoff_base * (2 ** (attempt - 1)))
    if cfg.backoff_jitter <= 0:
        return base
    jitter = _mix(_mix(cfg.seed, rid), attempt) % (cfg.backoff_jitter + 1)
    return base + jitter
