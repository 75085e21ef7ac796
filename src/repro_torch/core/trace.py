"""Canonical cycle-attribution event trace shared by both simulators.

The Calyx-level simulator (``core.sim``) and the netlist-level simulator
(``core.rtl_sim``) execute the *same static schedule* at two different
granularities.  This module defines the one event schema both emit so
their traces are join-able event-for-event, the provenance discipline
that makes the join keys line up, and the aggregation that turns a trace
back into the counter values the synthesized perf-counter bank measures
(``rtl.lower_component(profile=True)``).

Event kinds
-----------

======================  =====================================================
kind                    meaning (dur = duration in cycles)
======================  =====================================================
``group:start``         a group's go rises; ``dur`` = group latency
``group:stop``          the matching done (``dur`` = 0)
``fsm:state``           controller state entry — netlist granularity only
``uop``                 one micro-op issues (``detail`` = op descriptor)
``port:grant``          a memory bank port is granted for one cycle
``pool:grant``          a shared-unit grant for a group's whole window
``pipe:launch``         a pipelined loop launches iteration ``data``
``stall:port``          a par arm serialized behind port-conflicting siblings
``stall:pool``          a grant wait on a shared pool (never occurs: binding
                        keeps pools inside one serialized component)
``stall:ii``            cycles lost to an initiation interval > 1
``stall:fsm``           control overhead (setup/iter/cond/pad/join states)
======================  =====================================================

Every kind except ``fsm:state`` is emitted by *both* simulators with
identical (cycle, prov, detail, dur, data) tuples — asserted by
:func:`join_mismatches`.  ``fsm:state`` exists only at netlist
granularity (one event per controller state entry) and is excluded from
the join.

Provenance
----------

``prov`` is the control-tree path of the event as a tuple of labels:
``s<k>`` for the k-th child of a ``seq``, ``loop_<var>`` for a repeat,
``if``/``then``/``else`` for conditionals, ``par``/``arm<i>`` for a
fork's i-th arm, and the group name as the leaf of group-level events.
``core.sim`` builds the path while walking the control tree;
``core.rtl`` stamps the identical path onto every ``FsmState`` at
lowering time (``FsmState.prov``) so ``core.rtl_sim`` replays it — the
two simulators never exchange information, yet their events carry equal
keys.  The path doubles as the flame-graph axis of
``profiler.flame_table``.

Determinism: events carry only ints, strings, and int tuples (never
floats), so a serialized trace is byte-stable across runs and machines —
the golden-trace tests commit one and diff it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# -- event kinds -------------------------------------------------------------
GROUP_START = "group:start"
GROUP_STOP = "group:stop"
FSM_STATE = "fsm:state"
UOP = "uop"
PORT_GRANT = "port:grant"
POOL_GRANT = "pool:grant"
PIPE_LAUNCH = "pipe:launch"
STALL_PORT = "stall:port"
STALL_POOL = "stall:pool"
STALL_II = "stall:ii"
STALL_FSM = "stall:fsm"

STALL_KINDS = (STALL_PORT, STALL_POOL, STALL_II, STALL_FSM)

# kinds both simulators must emit identically (fsm:state is netlist-only)
JOIN_KINDS = frozenset({GROUP_START, GROUP_STOP, UOP, PORT_GRANT,
                        POOL_GRANT, PIPE_LAUNCH, *STALL_KINDS})


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One schedule event.  All fields are ints/strings/int-tuples so a
    trace serializes deterministically."""
    cycle: int                      # absolute cycle the event begins
    kind: str
    prov: Tuple[str, ...] = ()      # control-tree provenance chain
    group: str = ""                 # group the event belongs to ("" = none)
    detail: str = ""                # kind-specific descriptor
    dur: int = 0                    # duration in cycles (0 = instantaneous)
    data: Tuple[int, ...] = ()      # kind-specific ints (address, iteration)

    @property
    def end(self) -> int:
        return self.cycle + self.dur

    def sort_key(self) -> tuple:
        return (self.cycle, self.kind, self.prov, self.group, self.detail,
                self.dur, self.data)

    def to_json(self) -> str:
        # explicit key order -> byte-stable serialization
        return json.dumps({"c": self.cycle, "k": self.kind,
                           "p": list(self.prov), "g": self.group,
                           "d": self.detail, "n": self.dur,
                           "a": list(self.data)}, separators=(",", ":"))

    @staticmethod
    def from_json(line: str) -> "TraceEvent":
        o = json.loads(line)
        return TraceEvent(o["c"], o["k"], tuple(o["p"]), o["g"], o["d"],
                          o["n"], tuple(int(v) for v in o["a"]))


class Tracer:
    """Event sink.  Both simulators accept ``tracer=None`` (the default)
    and guard every emission site with ``if tracer is not None`` — the
    zero-cost-when-off hook contract (no event objects, no path tuples,
    no callbacks are ever built when tracing is off)."""

    __slots__ = ("events",)

    def __init__(self) -> None:
        self.events: List[TraceEvent] = []

    def emit(self, cycle: int, kind: str, prov: Tuple[str, ...] = (),
             group: str = "", detail: str = "", dur: int = 0,
             data: Tuple[int, ...] = ()) -> None:
        self.events.append(TraceEvent(cycle, kind, prov, group, detail,
                                      dur, data))

    def sorted_events(self) -> List[TraceEvent]:
        return sorted(self.events, key=TraceEvent.sort_key)


# -- provenance helpers (the single source of the path discipline) -----------


def seq_label(k: int) -> str:
    return f"s{k}"


def loop_label(var: str) -> str:
    return f"loop_{var}" if var else "loop"


def arm_label(i: int) -> str:
    return f"arm{i}"


IF_LABEL = "if"
THEN_LABEL = "then"
ELSE_LABEL = "else"
PAR_LABEL = "par"


# -- serialization -----------------------------------------------------------


def to_jsonl(events: Iterable[TraceEvent]) -> str:
    """One event per line, in emission order; byte-stable."""
    return "".join(ev.to_json() + "\n" for ev in events)


def from_jsonl(text: str) -> List[TraceEvent]:
    return [TraceEvent.from_json(line)
            for line in text.splitlines() if line.strip()]


# -- join --------------------------------------------------------------------


def join_mismatches(a: Sequence[TraceEvent], b: Sequence[TraceEvent],
                    limit: int = 8) -> List[str]:
    """Compare the join-able projection of two traces event-for-event.

    Both traces are filtered to :data:`JOIN_KINDS` and sorted by the full
    event key; any difference is a divergence between the Calyx-level and
    netlist-level execution of the same schedule.  Returns human-readable
    mismatch descriptions (empty = the traces join exactly).
    """
    sa = sorted((ev for ev in a if ev.kind in JOIN_KINDS),
                key=TraceEvent.sort_key)
    sb = sorted((ev for ev in b if ev.kind in JOIN_KINDS),
                key=TraceEvent.sort_key)
    out: List[str] = []
    if len(sa) != len(sb):
        out.append(f"event count differs: {len(sa)} vs {len(sb)}")
    for ea, eb in zip(sa, sb):
        if ea != eb:
            out.append(f"{ea} != {eb}")
            if len(out) >= limit:
                out.append("... (truncated)")
                break
    return out


# -- aggregation (trace -> counter values) -----------------------------------


def _union_cycles(intervals: List[Tuple[int, int]]) -> int:
    """Total length of the union of [start, end) intervals — a pipelined
    group's overlapping launch windows count each busy cycle once, which
    is exactly what the hardware ``g_<group>_go`` active-cycle counter
    measures."""
    total = 0
    hi = None
    for s, e in sorted(intervals):
        if hi is None or s > hi:
            total += e - s
            hi = e
        elif e > hi:
            total += e - hi
            hi = e
    return total


def aggregate(events: Sequence[TraceEvent]) -> Dict[str, object]:
    """Reduce a trace to the counter values the perf-counter bank holds.

    The returned dict carries the same keys/values as the counter fields
    on ``sim.SimStats`` / ``rtl_sim.RtlStats`` and (modulo the
    software-only ``pipe_launches``) the synthesized counter bank — the
    four-way observability differential compares them for exact equality.
    """
    groups: Dict[str, List[Tuple[int, int]]] = {}
    stalls = {k: 0 for k in STALL_KINDS}
    launches = 0
    total = 0
    for ev in events:
        total = max(total, ev.end)
        if ev.kind == GROUP_START:
            groups.setdefault(ev.group, []).append((ev.cycle, ev.end))
        elif ev.kind in stalls:
            stalls[ev.kind] += ev.dur
        elif ev.kind == PIPE_LAUNCH:
            launches += 1
    return {
        "total": total,
        "group_cycles": {g: _union_cycles(iv)
                         for g, iv in sorted(groups.items())},
        "stall_port_cycles": stalls[STALL_PORT],
        "stall_pool_cycles": stalls[STALL_POOL],
        "stall_ii_cycles": stalls[STALL_II],
        "fsm_overhead_cycles": stalls[STALL_FSM],
        "pipe_launches": launches,
    }


def counters_of_stats(stats) -> Dict[str, object]:
    """The counter view of a ``SimStats``/``RtlStats`` object — the same
    shape :func:`aggregate` produces from a trace."""
    return {
        "total": stats.cycles,
        "group_cycles": dict(sorted(stats.group_cycles.items())),
        "stall_port_cycles": stats.stall_port_cycles,
        "stall_pool_cycles": stats.stall_pool_cycles,
        "stall_ii_cycles": stats.stall_ii_cycles,
        "fsm_overhead_cycles": stats.fsm_overhead_cycles,
        "pipe_launches": stats.pipe_launches,
    }
