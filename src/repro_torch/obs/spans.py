"""Request-span tracing for the serving runtime.

One span per request — the phase chain
``enqueue -> admit -> prefill -> decode(first_token) -> complete`` — plus
one event per engine step carrying slot occupancy, queue depth, and tokens
emitted.  The schema follows the ``kind``/provenance conventions of the
hardware path's ``core.trace`` (namespaced ``kind`` strings, a ``prov``
tuple naming the event's position in the runtime "control tree", explicit
JSON key order so serialization is byte-stable), so a future compiled-kernel
serve step can nest a hardware profile inside a request span by extending
the same stream.

Event kinds
-----------

==================  =========================================================
kind                meaning
==================  =========================================================
``req:enqueue``     request submitted to the engine queue
``req:admit``       request claimed a slot (``slot`` set from here on)
``req:prefill``     first prompt token fed — prefill phase begins
``req:first_token`` first generated token emitted (TTFT stamp)
``req:complete``    slot released; ``detail`` = ``finished`` or
                    ``truncated:<reason>``; ``data`` = (tokens_generated,)
``req:retry``       slot quarantined and the request requeued for another
                    attempt; ``detail`` = ``quarantine:<cause>``;
                    ``data`` = (attempt_just_failed, backoff_ticks).
                    Splits the request span into attempts — phases after
                    a retry restart from ``admit``
``step``            one engine step; ``data`` = (slots_occupied,
                    queue_depth, tokens_emitted, prompt_tokens_fed);
                    ``dur_us`` = step wall time, stamped only after
                    ``jax.block_until_ready`` on the step outputs; a
                    step lost to an injected exception carries
                    ``detail`` = ``fault:exception``
``engine:health``   engine health transition; ``detail`` = the new state
                    (``healthy``/``degraded``/``draining``), ``data`` =
                    (state_code,)
==================  =========================================================

Provenance: request events carry ``("req<rid>",)``; step events carry
``("engine", "s<step>")`` — the serving analogue of ``core.trace``'s
control-tree paths.

Determinism
-----------

Under a fixed seed the event *structure* (kinds, order, rids, slots,
counts) is fully deterministic; only the wall-clock fields ``ts_us`` and
``dur_us`` vary run-to-run.  ``to_jsonl(events, stable=True)`` — the
exporters' ``--stable`` mode — normalizes exactly those two fields
(``ts_us`` becomes the event's ordinal in the stream, ``dur_us`` becomes
0), making the serialized stream byte-identical across runs; the
determinism tests and the CI artifact diff rely on this.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# -- event kinds -------------------------------------------------------------
REQ_ENQUEUE = "req:enqueue"
REQ_ADMIT = "req:admit"
REQ_PREFILL = "req:prefill"
REQ_FIRST_TOKEN = "req:first_token"
REQ_COMPLETE = "req:complete"
REQ_RETRY = "req:retry"
STEP = "step"
HEALTH = "engine:health"

REQ_KINDS = (REQ_ENQUEUE, REQ_ADMIT, REQ_PREFILL, REQ_FIRST_TOKEN,
             REQ_COMPLETE)
# the phase order every request must respect within one attempt (missing
# phases are allowed for truncated requests, but present ones must appear
# in this order); a REQ_RETRY marker ends an attempt and the next one
# restarts from REQ_ADMIT
PHASE_ORDER = {k: i for i, k in enumerate(REQ_KINDS)}

FINISHED = "finished"
TRUNCATED_PREFIX = "truncated:"
QUARANTINE_PREFIX = "quarantine:"


def req_prov(rid: int) -> Tuple[str, ...]:
    return (f"req{rid}",)


def step_prov(step: int) -> Tuple[str, ...]:
    return ("engine", f"s{step}")


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One serving event.  Only ``ts_us``/``dur_us`` are wall-clock; every
    other field is deterministic under a fixed seed."""
    ts_us: int                      # microseconds since tracer epoch
    kind: str
    prov: Tuple[str, ...] = ()
    step: int = -1                  # engine step index (-1 = pre-engine)
    rid: int = -1
    slot: int = -1
    detail: str = ""
    dur_us: int = 0
    data: Tuple[int, ...] = ()

    def to_json(self, stable_ts: Optional[int] = None) -> str:
        # explicit key order -> byte-stable serialization (cf. core.trace)
        ts = self.ts_us if stable_ts is None else stable_ts
        dur = self.dur_us if stable_ts is None else 0
        return json.dumps({"t": ts, "k": self.kind, "p": list(self.prov),
                           "s": self.step, "r": self.rid, "l": self.slot,
                           "d": self.detail, "n": dur,
                           "a": list(self.data)}, separators=(",", ":"))

    @staticmethod
    def from_json(line: str) -> "SpanEvent":
        o = json.loads(line)
        return SpanEvent(o["t"], o["k"], tuple(o["p"]), o["s"], o["r"],
                         o["l"], o["d"], o["n"],
                         tuple(int(v) for v in o["a"]))


class SpanTracer:
    """Event sink.  The engine accepts ``spans=None`` (the default) and
    guards every emission site with ``if spans is not None`` — the same
    zero-cost-when-off contract as ``core.trace.Tracer``."""

    __slots__ = ("events", "_clock", "_t0")

    def __init__(self, clock=time.perf_counter) -> None:
        self.events: List[SpanEvent] = []
        self._clock = clock
        self._t0 = clock()

    def now_us(self) -> int:
        return int((self._clock() - self._t0) * 1e6)

    def emit(self, kind: str, *, ts_us: Optional[int] = None,
             prov: Tuple[str, ...] = (), step: int = -1, rid: int = -1,
             slot: int = -1, detail: str = "", dur_us: int = 0,
             data: Tuple[int, ...] = ()) -> None:
        if ts_us is None:
            ts_us = self.now_us()
        self.events.append(SpanEvent(ts_us, kind, prov, step, rid, slot,
                                     detail, dur_us, data))


# -- serialization -----------------------------------------------------------


def to_jsonl(events: Iterable[SpanEvent], stable: bool = False) -> str:
    """One event per line, in emission order.  ``stable=True`` normalizes
    the wall-clock fields (``ts_us`` -> event ordinal, ``dur_us`` -> 0) so
    two same-seed runs serialize byte-identically."""
    if stable:
        return "".join(ev.to_json(stable_ts=i) + "\n"
                       for i, ev in enumerate(events))
    return "".join(ev.to_json() + "\n" for ev in events)


def from_jsonl(text: str) -> List[SpanEvent]:
    return [SpanEvent.from_json(line)
            for line in text.splitlines() if line.strip()]


# -- span assembly -----------------------------------------------------------


@dataclasses.dataclass
class RequestSummary:
    """The per-request span, assembled from the event stream."""
    rid: int
    enqueue_us: int = -1
    admit_us: int = -1
    prefill_us: int = -1
    first_token_us: int = -1
    complete_us: int = -1
    reason: str = ""
    tokens: int = 0
    slot: int = -1
    attempts: int = 1

    @property
    def ttft_us(self) -> int:
        """Enqueue-to-first-token (queueing + prefill included)."""
        if self.first_token_us < 0 or self.enqueue_us < 0:
            return -1
        return self.first_token_us - self.enqueue_us

    @property
    def decode_us_per_token(self) -> float:
        """Steady-state decode latency: first-token-to-complete over the
        tokens emitted after the first (undefined below 2 tokens)."""
        if self.tokens < 2 or self.first_token_us < 0:
            return float("nan")
        return (self.complete_us - self.first_token_us) / (self.tokens - 1)


_PHASE_FIELD = {REQ_ENQUEUE: "enqueue_us", REQ_ADMIT: "admit_us",
                REQ_PREFILL: "prefill_us", REQ_FIRST_TOKEN: "first_token_us",
                REQ_COMPLETE: "complete_us"}


def summarize(events: Sequence[SpanEvent]) -> Dict[int, RequestSummary]:
    """Assemble one :class:`RequestSummary` per request id."""
    spans: Dict[int, RequestSummary] = {}
    for ev in events:
        if ev.kind not in _PHASE_FIELD:
            continue
        s = spans.setdefault(ev.rid, RequestSummary(ev.rid))
        setattr(s, _PHASE_FIELD[ev.kind], ev.ts_us)
        if ev.slot >= 0:
            s.slot = ev.slot
        if ev.kind == REQ_COMPLETE:
            s.reason = ev.detail
            s.tokens = ev.data[0] if ev.data else 0
    for ev in events:
        if ev.kind == REQ_RETRY and ev.rid in spans:
            spans[ev.rid].attempts += 1
    return spans


# -- invariants --------------------------------------------------------------


def validate(events: Sequence[SpanEvent], slots: int = 0,
             engine_steps: int = -1) -> List[str]:
    """Span lifecycle invariants; returns violation strings (empty = ok).

    * every enqueued request completes (``finished``) or is truncated with
      a reason — exactly one complete, as the request's final event;
    * exactly one enqueue per request, as the request's first event (a
      retry re-admits, it never re-enqueues);
    * ``req:retry`` markers split the span into attempts; within each
      attempt present phases appear in ``PHASE_ORDER``, and timestamps are
      monotone non-decreasing across the whole request stream;
    * step events are contiguous (0..n-1) and, when ``engine_steps`` is
      given, count exactly ``engine_steps``;
    * slot occupancy never exceeds ``slots`` (when given) and the
      occupancy recorded on each step event matches the reconstructed
      in-flight count — a request occupies a slot over each
      [admit_step, release_step] interval, where release is the step of
      the attempt's ``req:retry`` or the final ``req:complete``.
    """
    out: List[str] = []
    per_req: Dict[int, List[SpanEvent]] = {}
    step_events: List[SpanEvent] = []
    for ev in events:
        if ev.kind == STEP:
            step_events.append(ev)
        elif ev.kind in PHASE_ORDER or ev.kind == REQ_RETRY:
            per_req.setdefault(ev.rid, []).append(ev)
        elif ev.kind != HEALTH:
            out.append(f"unknown event kind {ev.kind!r}")
    for rid, evs in sorted(per_req.items()):
        kinds = [e.kind for e in evs]
        n_enq = kinds.count(REQ_ENQUEUE)
        if n_enq == 0:
            out.append(f"req{rid}: no enqueue event")
        elif n_enq > 1:
            out.append(f"req{rid}: {n_enq} enqueue events (want exactly 1)")
        elif kinds[0] != REQ_ENQUEUE:
            out.append(f"req{rid}: enqueue is not the first event")
        if kinds.count(REQ_COMPLETE) != 1:
            out.append(f"req{rid}: {kinds.count(REQ_COMPLETE)} complete "
                       f"events (want exactly 1)")
        else:
            comp = evs[kinds.index(REQ_COMPLETE)]
            if comp.detail != FINISHED and \
                    not comp.detail.startswith(TRUNCATED_PREFIX):
                out.append(f"req{rid}: complete reason {comp.detail!r} is "
                           f"neither finished nor truncated:*")
            if kinds[-1] != REQ_COMPLETE:
                out.append(f"req{rid}: events after complete: "
                           f"{kinds[kinds.index(REQ_COMPLETE) + 1:]}")
        # split the span into attempts at retry markers; each attempt's
        # phases must independently respect PHASE_ORDER
        attempts: List[List[SpanEvent]] = [[]]
        for e in evs:
            attempts[-1].append(e)
            if e.kind == REQ_RETRY:
                attempts.append([])
        if not attempts[-1]:
            attempts.pop()
        for i, att in enumerate(attempts):
            order = [PHASE_ORDER[e.kind] for e in att
                     if e.kind in PHASE_ORDER]
            if order != sorted(order):
                out.append(f"req{rid} attempt {i + 1}: phases out of "
                           f"order: {[e.kind for e in att]}")
        ts = [e.ts_us for e in evs]
        if ts != sorted(ts):
            out.append(f"req{rid}: phase timestamps not monotone: {ts}")
    steps_seen = [e.step for e in step_events]
    if steps_seen != list(range(len(steps_seen))):
        out.append(f"step events not contiguous from 0: {steps_seen[:10]}")
    if engine_steps >= 0 and len(step_events) != engine_steps:
        out.append(f"{len(step_events)} step events but engine ran "
                   f"{engine_steps} steps")
    # reconstruct occupancy from the request lifecycle and check each step:
    # each admit opens a slot interval, closed (inclusive) by the step of
    # the attempt's retry marker or the final complete
    intervals: List[Tuple[int, int]] = []
    for rid, evs in per_req.items():
        opened = -1
        for e in evs:
            if e.kind == REQ_ADMIT:
                opened = e.step
            elif e.kind in (REQ_RETRY, REQ_COMPLETE) and opened >= 0:
                intervals.append((opened, e.step))
                opened = -1
        if opened >= 0:                     # admitted, never released
            intervals.append((opened, 1 << 62))
    for ev in step_events:
        occ = ev.data[0] if ev.data else 0
        if slots and occ > slots:
            out.append(f"step {ev.step}: occupancy {occ} > {slots} slots")
        expect = sum(1 for lo, hi in intervals if lo <= ev.step <= hi)
        if ev.data and occ != expect:
            out.append(f"step {ev.step}: occupancy {occ} but "
                       f"{expect} requests in flight")
    return out


def slot_utilization(events: Sequence[SpanEvent], slots: int) -> float:
    """Mean fraction of slots occupied over all engine steps."""
    occ = [ev.data[0] for ev in events if ev.kind == STEP and ev.data]
    if not occ or slots <= 0:
        return 0.0
    return sum(occ) / (len(occ) * slots)
