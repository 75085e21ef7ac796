"""Cycle-attribution profiler over the canonical event trace.

``core.trace`` defines the event schema both simulators emit; this
module turns a trace into the artifacts a performance engineer reads:

* :func:`flame_table` — per control-tree node self/total cycles, keyed
  by the provenance paths the events carry (``s<k>``, ``loop_<var>``,
  ``par``/``arm<i>``, ``if``/``then``/``else``, group name).  *Self*
  cycles at a node are group-busy cycles (interval union, so a
  pipelined group's overlapping launch windows count once) plus stall
  durations attributed there; *total* adds every descendant.  Totals
  are attribution mass, not wall-clock: concurrent ``par`` arms each
  contribute their own cycles.
* :func:`occupancy` — per memory-bank port and per functional unit:
  how many distinct cycles carried a grant/issue, as a fraction of the
  run.
* :func:`stall_breakdown` — cycles lost per cause: port-conflict
  serialization, shared-pool waits, initiation-interval recurrence, and
  FSM overhead split by control state (setup/iter/cond/pad/join).
* :func:`to_vcd` — a deterministic VCD waveform from the netlist-level
  trace (group enables, FSM state registers, bank-port en/we), openable
  in GTKWave or Surfer.
* :func:`profile_design` / :class:`Profile` — run both simulators with
  tracing plus the analytic attribution (``estimator.attribute``) and
  the synthesized-counter model (``RtlStats.counters``), cross-check
  all levels for exact equality, and render the report.

The cross-check (:func:`counter_mismatches`) is the observability
differential: Calyx-sim stats == RTL-sim stats == both trace aggregates
== hardware counter values, and — for if-free designs — == the
closed-form attribution, field for field with zero tolerance.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from . import estimator
from . import trace as T

# ---------------------------------------------------------------------------
# Flame table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlameRow:
    """One control-tree node of the attribution flame table."""
    path: Tuple[str, ...]
    self_cycles: int
    total_cycles: int


def _nat(label: str) -> tuple:
    """Natural sort key: ``s2`` before ``s10``."""
    return tuple(int(p) if p.isdigit() else p
                 for p in re.split(r"(\d+)", label))


def _path_key(path: Tuple[str, ...]) -> tuple:
    return tuple(_nat(p) for p in path)


def flame_table(events: Sequence[T.TraceEvent]) -> List[FlameRow]:
    """Per-provenance-path cycle attribution, depth-first order.

    Group windows contribute interval-union busy cycles at the group's
    full path (control path + group leaf); stall events contribute their
    durations at the path they were emitted with.  Ancestors absent from
    the trace appear with ``self == 0`` so the tree renders complete.
    """
    self_c: Dict[Tuple[str, ...], int] = {}
    group_iv: Dict[Tuple[str, ...], List[Tuple[int, int]]] = {}
    for ev in events:
        if ev.kind == T.GROUP_START:
            group_iv.setdefault(ev.prov, []).append((ev.cycle, ev.end))
        elif ev.kind in T.STALL_KINDS:
            self_c[ev.prov] = self_c.get(ev.prov, 0) + ev.dur
    for p, iv in group_iv.items():
        self_c[p] = self_c.get(p, 0) + T._union_cycles(iv)
    paths = set(self_c)
    for p in list(paths):
        for i in range(len(p)):
            paths.add(p[:i])
    paths.add(())
    total_c = {p: self_c.get(p, 0) for p in paths}
    for p in sorted(paths, key=len, reverse=True):
        if p:
            total_c[p[:-1]] += total_c[p]
    return [FlameRow(p, self_c.get(p, 0), total_c[p])
            for p in sorted(paths, key=_path_key)]


def render_flame(rows: Sequence[FlameRow]) -> str:
    """The flame table as fixed-width text (indent = tree depth)."""
    lines = [f"{'node':<44} {'self':>8} {'total':>8}"]
    for r in rows:
        name = r.path[-1] if r.path else "(root)"
        label = "  " * max(0, len(r.path) - 1) + name
        lines.append(f"{label:<44} {r.self_cycles:>8} {r.total_cycles:>8}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Occupancy and stall breakdown
# ---------------------------------------------------------------------------


def occupancy(events: Sequence[T.TraceEvent],
              total: int) -> Dict[str, Dict[str, Dict[str, object]]]:
    """Port and unit utilization over a run of ``total`` cycles.

    ``ports`` maps ``<mem>:b<k>`` to the number of distinct cycles the
    bank's single port was granted (``busy``), the grant count
    (``events`` — broadcast reads grant several loads in one cycle), and
    the busy percentage.  ``units`` maps each functional unit (the
    post-binding pool cell of shared units) to its issue cycles.
    """
    ports: Dict[str, set] = {}
    port_n: Dict[str, int] = {}
    units: Dict[str, set] = {}
    unit_n: Dict[str, int] = {}
    for ev in events:
        if ev.kind == T.PORT_GRANT:
            _rw, mem, bank = ev.detail.split(":")
            key = f"{mem}:{bank}"
            ports.setdefault(key, set()).add(ev.cycle)
            port_n[key] = port_n.get(key, 0) + 1
        elif ev.kind == T.UOP and ev.detail.startswith("alu:"):
            cell = ev.detail.split(":")[2]
            units.setdefault(cell, set()).add(ev.cycle)
            unit_n[cell] = unit_n.get(cell, 0) + 1

    def row(busy: set, n: int) -> Dict[str, object]:
        pct = round(100.0 * len(busy) / total, 2) if total else 0.0
        return {"busy": len(busy), "events": n, "pct": pct}

    return {"ports": {k: row(ports[k], port_n[k])
                      for k in sorted(ports, key=_nat)},
            "units": {k: row(units[k], unit_n[k])
                      for k in sorted(units, key=_nat)}}


def stall_breakdown(events: Sequence[T.TraceEvent]) -> Dict[str, object]:
    """Cycles lost per stall cause; ``fsm_detail`` splits control
    overhead by state flavor (setup/iter/cond/pad/join)."""
    out: Dict[str, object] = {"port": 0, "pool": 0, "ii": 0, "fsm": 0}
    detail: Dict[str, int] = {}
    for ev in events:
        if ev.kind == T.STALL_PORT:
            out["port"] += ev.dur
        elif ev.kind == T.STALL_POOL:
            out["pool"] += ev.dur
        elif ev.kind == T.STALL_II:
            out["ii"] += ev.dur
        elif ev.kind == T.STALL_FSM:
            out["fsm"] += ev.dur
            key = ev.detail or "other"
            detail[key] = detail.get(key, 0) + ev.dur
    out["fsm_detail"] = dict(sorted(detail.items()))
    out["total"] = out["port"] + out["pool"] + out["ii"] + out["fsm"]
    return out


# ---------------------------------------------------------------------------
# VCD waveforms
# ---------------------------------------------------------------------------


def _vcd_id(i: int) -> str:
    """Unique printable VCD identifier (bijective base-94)."""
    s = ""
    i += 1
    while i:
        i -= 1
        s = chr(33 + (i % 94)) + s
        i //= 94
    return s


def _vcd_val(val: int, width: int, ident: str) -> str:
    if width == 1:
        return f"{val}{ident}"
    return f"b{val:b} {ident}"


def to_vcd(events: Sequence[T.TraceEvent], name: str = "design") -> str:
    """Render a netlist-level trace as a VCD waveform (1 cycle = 1ns).

    Signals: one 1-bit enable per group (high while any activation is in
    flight — overlapped pipeline launches OR together, like the hardware
    ``g_<g>_go``), one 32-bit state value per controller (from
    ``fsm:state`` events, so Calyx-level traces yield no state signals),
    and per bank-port ``en``/``we`` pulses from the grant events.
    Deterministic byte-for-byte: fixed header, no timestamps.
    """
    groups = sorted({ev.group for ev in events
                     if ev.kind == T.GROUP_START}, key=_nat)
    fsm_events = [ev for ev in events if ev.kind == T.FSM_STATE]
    fsms = sorted({ev.detail.split(".", 1)[0] for ev in fsm_events},
                  key=_nat)
    grants = [ev for ev in events if ev.kind == T.PORT_GRANT]
    port_names: List[str] = []
    for ev in grants:
        _rw, mem, bank = ev.detail.split(":")
        p = f"{mem}_{bank}"
        if p not in port_names:
            port_names.append(p)
    port_names.sort(key=_nat)

    vars_: List[Tuple[str, int, str]] = []     # (ident, width, name)

    def add(vname: str, width: int) -> None:
        vars_.append((_vcd_id(len(vars_)), width, vname))

    for g in groups:
        add(f"g_{g}_go", 1)
    for f in fsms:
        add(f"{f}_state", 32)
    for p in port_names:
        add(f"{p}_en", 1)
        add(f"{p}_we", 1)

    delta: Dict[int, Dict[str, int]] = {}

    def set_at(t: int, vname: str, val: int) -> None:
        delta.setdefault(t, {})[vname] = val

    # group enables: active-count edges over the activation intervals
    edges: Dict[str, Dict[int, int]] = {}
    for ev in events:
        if ev.kind == T.GROUP_START:
            em = edges.setdefault(ev.group, {})
            em[ev.cycle] = em.get(ev.cycle, 0) + 1
            em[ev.end] = em.get(ev.end, 0) - 1
    for g, em in edges.items():
        active = 0
        for t in sorted(em):
            prev = active
            active += em[t]
            if prev == 0 and active > 0:
                set_at(t, f"g_{g}_go", 1)
            elif prev > 0 and active == 0:
                set_at(t, f"g_{g}_go", 0)
    # controller state values
    for ev in fsm_events:
        fsm, rest = ev.detail.split(".", 1)
        idx = int(rest.split(":", 1)[0])
        set_at(ev.cycle, f"{fsm}_state", idx)
    # bank-port pulses
    pulses: Dict[str, Dict[int, Tuple[int, int]]] = {}
    for ev in grants:
        rw, mem, bank = ev.detail.split(":")
        p = f"{mem}_{bank}"
        cur = pulses.setdefault(p, {})
        we = 1 if rw == "W" else 0
        old = cur.get(ev.cycle, (0, 0))
        cur[ev.cycle] = (1, max(we, old[1]))
    for p, cyc in pulses.items():
        for t in sorted(cyc):
            _en, we = cyc[t]
            set_at(t, f"{p}_en", 1)
            set_at(t, f"{p}_we", we)
            if t + 1 not in cyc:
                set_at(t + 1, f"{p}_en", 0)
                set_at(t + 1, f"{p}_we", 0)

    out = ["$comment repro.core.profiler cycle trace $end",
           "$timescale 1ns $end",
           f"$scope module {name} $end"]
    for ident, width, vname in vars_:
        kind = "wire" if width == 1 else "reg"
        out.append(f"$var {kind} {width} {ident} {vname} $end")
    out.append("$upscope $end")
    out.append("$enddefinitions $end")
    out.append("#0")
    out.append("$dumpvars")
    init = delta.pop(0, {})
    for ident, width, vname in vars_:
        out.append(_vcd_val(init.get(vname, 0), width, ident))
    out.append("$end")
    for t in sorted(delta):
        ch = delta[t]
        out.append(f"#{t}")
        for ident, width, vname in vars_:
            if vname in ch:
                out.append(_vcd_val(ch[vname], width, ident))
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# The four-way counter cross-check
# ---------------------------------------------------------------------------


def _diff_keys(a: Dict[str, object], b: Dict[str, object]) -> str:
    bad = [k for k in a if a[k] != b.get(k)]
    return ", ".join(f"{k}: {a[k]!r} vs {b.get(k)!r}" for k in bad)


def hw_counter_mismatches(hw: Dict[str, int],
                          counters: Dict[str, object]) -> List[str]:
    """Compare the synthesized counter-bank values (``RtlStats.counters``,
    keys ``total``/``group:<g>``/``stall_*``/``fsm_overhead``) against an
    aggregate-shaped counter dict.  A group counter of a never-fired
    group (an untaken ``if`` arm) must read zero."""
    out: List[str] = []
    for key in sorted(hw):
        val = hw[key]
        if key.startswith("group:"):
            want = counters["group_cycles"].get(key[len("group:"):], 0)
        elif key == "total":
            want = counters["total"]
        else:
            want = counters[f"{key}_cycles"]
        if val != want:
            out.append(f"hw counter {key} = {val}, trace/stats say {want}")
    return out


def counter_mismatches(sim_stats, rtl_stats,
                       sim_events: Sequence[T.TraceEvent],
                       rtl_events: Sequence[T.TraceEvent],
                       attribution:
                       Optional[estimator.CycleAttribution] = None,
                       hw_counters: Optional[Dict[str, int]] = None,
                       limit: int = 8) -> List[str]:
    """The full observability differential; empty list = all levels agree.

    Checks, all exact: Calyx-sim counter fields == RTL-sim counter
    fields; each trace aggregates back to its own simulator's stats; the
    two traces join event-for-event; the hardware counter bank reads the
    same values; and the analytic attribution matches (fully for if-free
    designs, ``total`` always).
    """
    out: List[str] = []
    cs = T.counters_of_stats(sim_stats)
    cr = T.counters_of_stats(rtl_stats)
    if cs != cr:
        out.append(f"sim stats != rtl stats: {_diff_keys(cs, cr)}")
    agg_s = T.aggregate(sim_events)
    if agg_s != cs:
        out.append(f"sim trace aggregate != sim stats: "
                   f"{_diff_keys(agg_s, cs)}")
    agg_r = T.aggregate(rtl_events)
    if agg_r != cr:
        out.append(f"rtl trace aggregate != rtl stats: "
                   f"{_diff_keys(agg_r, cr)}")
    out.extend(T.join_mismatches(sim_events, rtl_events, limit))
    if hw_counters is not None:
        out.extend(hw_counter_mismatches(hw_counters, cr))
    if attribution is not None:
        ac = attribution.counters()
        if attribution.exact:
            if ac != cs:
                out.append(f"analytic attribution != measured: "
                           f"{_diff_keys(ac, cs)}")
        elif ac["total"] != cs["total"]:
            out.append(f"analytic total != measured total: "
                       f"{ac['total']} vs {cs['total']}")
    return out


# ---------------------------------------------------------------------------
# Whole-design profiling
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Profile:
    """Everything one profiling run produced, pre-joined."""
    name: str
    sim_stats: object
    rtl_stats: object
    sim_events: List[T.TraceEvent]
    rtl_events: List[T.TraceEvent]
    attribution: estimator.CycleAttribution
    flame: List[FlameRow]
    occupancy: Dict[str, Dict[str, Dict[str, object]]]
    stalls: Dict[str, object]
    hw_counters: Optional[Dict[str, int]]
    mismatches: List[str]

    @property
    def cycles(self) -> int:
        return self.sim_stats.cycles

    def to_vcd(self) -> str:
        return to_vcd(self.rtl_events, name=self.name)

    def report(self) -> str:
        """The attribution report as text (the ``--profile`` output)."""
        lines = [f"design {self.name}: {self.cycles} cycles "
                 f"(attribution {'exact' if self.attribution.exact else 'bounds an input-dependent if'})"]
        if self.mismatches:
            lines.append(f"COUNTER MISMATCHES ({len(self.mismatches)}):")
            lines.extend(f"  {m}" for m in self.mismatches)
        else:
            lines.append("counters agree across sim / rtl_sim / traces / "
                         "hardware bank"
                         + ("" if self.attribution.exact
                            else " (analytic: total only)"))
        lines.append("")
        lines.append(render_flame(self.flame))
        lines.append("")
        lines.append("stalls: " + ", ".join(
            f"{k}={self.stalls[k]}"
            for k in ("port", "pool", "ii", "fsm", "total")))
        fd = self.stalls["fsm_detail"]
        if fd:
            lines.append("  fsm: " + ", ".join(f"{k}={v}"
                                               for k, v in fd.items()))
        lines.append("occupancy:")
        for section in ("ports", "units"):
            for key, row in self.occupancy[section].items():
                lines.append(f"  {section[:-1]} {key}: {row['pct']}% busy "
                             f"({row['busy']} cycles, "
                             f"{row['events']} events)")
        return "\n".join(lines)


def profile_design(design, inputs) -> Profile:
    """Profile a ``pipeline.CompiledDesign``: both simulators traced, the
    profiled netlist's counter bank, the analytic attribution, and the
    cross-check of all of them (``Profile.mismatches`` empty on a
    healthy toolchain — asserted by the benchmark matrix)."""
    tr_sim = T.Tracer()
    _, sim_stats = design.simulate(inputs, tracer=tr_sim)
    tr_rtl = T.Tracer()
    _, rtl_stats = design.simulate_rtl(inputs, tracer=tr_rtl, profile=True)
    att = estimator.attribute(design.component)
    mism = counter_mismatches(sim_stats, rtl_stats, tr_sim.events,
                              tr_rtl.events, attribution=att,
                              hw_counters=rtl_stats.counters)
    return Profile(
        name=design.component.name,
        sim_stats=sim_stats,
        rtl_stats=rtl_stats,
        sim_events=tr_sim.events,
        rtl_events=tr_rtl.events,
        attribution=att,
        flame=flame_table(tr_rtl.events),
        occupancy=occupancy(tr_rtl.events, rtl_stats.cycles),
        stalls=stall_breakdown(tr_rtl.events),
        hw_counters=rtl_stats.counters,
        mismatches=mism,
    )
