"""Cycle-count, resource, and timing estimation over the Calyx-like IR.

Latency model:
  * ``seq``     — sum of children.
  * ``repeat``  — setup + extent * (body + per-iteration overhead).
  * ``if``      — cond + max(arms) + select overhead (both arms exist in
                  hardware; only one executes).  The control FSM is
                  *statically timed*: the ``if`` state always reserves the
                  worst-case arm latency, so every subtree's latency is
                  input-independent.  This is why the cycle-accurate
                  simulator (``core.sim``), which executes only the taken
                  arm but charges the worst case, measures *exactly* this
                  closed-form count — the differential tests in
                  ``tests/test_core_sim.py`` assert equality with no
                  tolerance, and there is no intentional divergence.
  * ``par``     — memory-port conflict model: arms that touch the same
                  (memory, bank) with non-shareable addresses must serialize
                  (Calyx memories accept one access per cycle).  We build a
                  conflict graph over the arms; each connected component runs
                  sequentially, components run concurrently:
                  ``latency = max over components(sum of arm latencies)``.
                  Identical-address *loads* broadcast from one port and do
                  not conflict.  This is what makes unbanked `par` worthless
                  and layout-banked `par` near-linear — the paper's story.

Resource model: sum of cell costs (float_lib) + BRAM/LUTRAM per bank +
FSM fabric per control state + a constant top-level overhead.

Timing: first-order achievable period grows with FSM state count and bank
select-chain depth; wall-clock latency = cycles * period.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set, Tuple

from . import float_lib as F
from .affine import AExpr, ModAtom
from .calyx import (CIf, CNode, CPar, CRepeat, CSeq, Component, GEnable,
                    PortAccess)


class BankingEfficiencyWarning(UserWarning):
    """A ``par`` block's arms conflict-serialize on memory banks — the
    banking factor bought hardware but not cycles (e.g. the conv2d
    banks=4 regression this warning was introduced to surface)."""


# ---------------------------------------------------------------------------
# Port collection (for the par conflict model)
# ---------------------------------------------------------------------------


def _collect_ports(comp: Component, node: CNode,
                   bound: Set[str]) -> List[PortAccess]:
    """All port accesses under ``node``; addresses depending on loop vars
    bound *inside* this subtree are marked unshareable (key -> None)."""
    out: List[PortAccess] = []
    if isinstance(node, GEnable):
        for p in comp.groups[node.group].ports:
            if p.free_vars & bound:
                # the address depends on a loop var bound inside this
                # subtree: neither the broadcast key nor the bank-affinity
                # proof may assume a common environment
                out.append(dataclasses.replace(p, key=None, bank_expr=None))
            else:
                out.append(p)
    elif isinstance(node, CSeq) or isinstance(node, CPar):
        for ch in node.children:
            out += _collect_ports(comp, ch, bound)
    elif isinstance(node, CRepeat):
        out += _collect_ports(comp, node.body, bound | {node.var})
    elif isinstance(node, CIf):
        out += _collect_ports(comp, node.then, bound)
        out += _collect_ports(comp, node.els, bound)
    return out


def banks_provably_distinct(a: PortAccess, b: PortAccess) -> bool:
    """True iff the two accesses provably hit different physical banks.

    Constant banks compare directly.  Runtime-selected banks (layout mode
    where the cyclic fold did not reach a constant, e.g. ``(2*i + a) % 4``
    after strip-mining by a factor that does not divide the banking
    factor) are compared *digit-wise*: the bank index is a mixed-radix
    sum of ``(expr_d mod f_d) * stride_d`` digits, and two digit vectors
    provably differ when

    * the whole bank-expression difference folds to a nonzero constant
      (e.g. one digit folded to distinct constants in both arms), or
    * some matched digit pair ``(e1 mod f)``/``(e2 mod f)`` on the same
      stride has ``e1 - e2`` a constant not divisible by ``f`` — residues
      of values a fixed non-multiple-of-``f`` apart always differ.

    This is what lets strip-mined arms whose strides are bank-affine (the
    unroll offset lands each arm on its own bank) run concurrently even
    when no digit is a compile-time constant.
    """
    if a.bank is not None and b.bank is not None:
        return a.bank != b.bank
    ea, eb = a.bank_expr, b.bank_expr
    if ea is None or eb is None:
        return False              # one side constant/invalidated: unknown
    diff = ea - eb
    if diff.is_const():
        return diff.const_value() != 0
    by_coeff = {}
    for atom, co in eb.coeffs.items():
        if isinstance(atom, ModAtom):
            by_coeff.setdefault(co, []).append(atom)
    for atom, co in ea.coeffs.items():
        if not isinstance(atom, ModAtom):
            continue
        for other in by_coeff.get(co, ()):
            if other.c != atom.c:
                continue
            d = atom.inner - other.inner
            if d.is_const() and d.const_value() % atom.c != 0:
                return True       # this digit always differs
    return False


def _arms_conflict(pa: List[PortAccess], pb: List[PortAccess]) -> bool:
    for a in pa:
        for b in pb:
            if a.mem != b.mem:
                continue
            if banks_provably_distinct(a, b):
                continue
            if (not a.is_store and not b.is_store
                    and a.key is not None and a.key == b.key):
                # identical intra-bank address: either the banks coincide
                # (one read port broadcasts to both) or they differ (no
                # port is contended) — never a conflict for loads
                continue
            return True
    return False


def ports_conflict(pa: List[PortAccess], pb: List[PortAccess]) -> bool:
    """Public face of the pairwise port-conflict test — used by the
    chaining pass to decide which ``par`` arms may fuse into one group."""
    return _arms_conflict(pa, pb)


def par_conflict_components(comp: Component, node: CPar) -> List[List[int]]:
    """Partition a ``par``'s arm indices into port-conflict components.

    Arms in one component must serialize (they touch the same single-ported
    (memory, bank) with non-broadcastable addresses); distinct components
    run concurrently.  Shared by the closed-form latency model below and by
    the cycle-accurate scheduler (``core.sim``) — the two agreeing on this
    partition is what makes measured and estimated cycles identical.
    """
    arms = node.children
    n = len(arms)
    ports = [_collect_ports(comp, a, set()) for a in arms]
    # union-find over conflict graph
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(n):
        for j in range(i + 1, n):
            if _arms_conflict(ports[i], ports[j]):
                parent[find(i)] = find(j)
    comps: Dict[int, List[int]] = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    return list(comps.values())


def par_join_cycles(n_arms: int) -> int:
    """Join handshake: a done-signal reduction tree over the arms."""
    return F.PAR_JOIN_CYCLES + max(0, math.ceil(math.log2(max(n_arms, 1))))


def par_serializations(comp: Component) -> List[Tuple[CPar, int, int]]:
    """Every ``par`` whose conflict partition collapses arms.

    Returns ``(node, n_arms, n_components)`` for each multi-arm par where
    ``n_components < n_arms`` — i.e. some arms the schedule *placed* in
    parallel will run sequentially on the hardware because they contend
    for a single-ported bank.  Compile-time visibility for regressions
    like conv2d banks=4, without running a benchmark.
    """
    out: List[Tuple[CPar, int, int]] = []

    def walk(node: CNode) -> None:
        if isinstance(node, (CSeq, CPar)):
            if isinstance(node, CPar) and len(node.children) > 1:
                comps = par_conflict_components(comp, node)
                if len(comps) < len(node.children):
                    out.append((node, len(node.children), len(comps)))
            for ch in node.children:
                walk(ch)
        elif isinstance(node, CRepeat):
            walk(node.body)
        elif isinstance(node, CIf):
            walk(node.then)
            walk(node.els)

    walk(comp.control)
    return out


def banking_efficiency(comp: Component) -> float:
    """Worst-case concurrency retention across all ``par`` blocks.

    1.0 = every par's arms run fully concurrently; ``k/n`` = the worst
    par keeps only ``k`` of its ``n`` arms concurrent (its conflict
    partition has ``k`` components).  Exposed on ``Estimate`` and warned
    about at compile time so banked-but-serialized designs are visible.
    """
    worst = 1.0
    for _, n_arms, n_comps in par_serializations(comp):
        worst = min(worst, n_comps / n_arms)
    return worst


# ---------------------------------------------------------------------------
# Cycles
# ---------------------------------------------------------------------------


def cycles(comp: Component, node: Optional[CNode] = None) -> int:
    node = comp.control if node is None else node
    if isinstance(node, GEnable):
        return comp.groups[node.group].latency
    if isinstance(node, CSeq):
        return sum(cycles(comp, ch) for ch in node.children)
    if isinstance(node, CRepeat):
        body = cycles(comp, node.body)
        if node.ii and node.extent > 0:
            # pipelined loop: a new iteration launches every ii cycles and
            # the last one drains its full body latency (core.pipelining)
            return F.LOOP_SETUP_CYCLES + (node.extent - 1) * node.ii + body
        return F.LOOP_SETUP_CYCLES + node.extent * (body + F.LOOP_ITER_OVERHEAD)
    if isinstance(node, CIf):
        t = cycles(comp, node.then)
        e = cycles(comp, node.els)
        return node.cond_latency + F.IF_SELECT_CYCLES + max(t, e)
    if isinstance(node, CPar):
        arms = node.children
        if not arms:
            return 0
        lats = [cycles(comp, a) for a in arms]
        comps = par_conflict_components(comp, node)
        return (max(sum(lats[i] for i in c) for c in comps)
                + par_join_cycles(len(arms)))
    raise TypeError(node)


# ---------------------------------------------------------------------------
# Cycle attribution (the analytic level of the observability differential)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CycleAttribution:
    """Closed-form counterpart of the perf-counter bank.

    Predicts, without executing anything, the exact values the
    synthesized hardware counters / both simulators' stats will measure:
    per-group busy cycles, cycles lost to each stall cause, and control
    overhead.  ``exact`` is False when the control tree contains an
    ``if`` — the analysis charges the worst-case arm (the statically
    timed FSM always *reserves* it, so ``total`` stays exact), but which
    groups actually fire is input-dependent, so the per-group split is a
    bound rather than an identity there.
    """
    total: int = 0
    group_cycles: Dict[str, int] = dataclasses.field(default_factory=dict)
    stall_port_cycles: int = 0       # par arms serialized behind siblings
    stall_pool_cycles: int = 0       # waits on shared-unit pools (always 0:
    #                                  binding keeps pools in one component)
    stall_ii_cycles: int = 0         # (extent-1)*(ii-1) per pipelined loop
    fsm_overhead_cycles: int = 0     # setup/iter/cond/pad/join states
    pipe_launches: int = 0
    exact: bool = True

    def as_dict(self):
        return dataclasses.asdict(self)

    def counters(self) -> Dict[str, object]:
        """Same shape as ``trace.aggregate`` / ``trace.counters_of_stats``
        so the four-way differential compares dicts directly."""
        return {
            "total": self.total,
            "group_cycles": dict(sorted(self.group_cycles.items())),
            "stall_port_cycles": self.stall_port_cycles,
            "stall_pool_cycles": self.stall_pool_cycles,
            "stall_ii_cycles": self.stall_ii_cycles,
            "fsm_overhead_cycles": self.fsm_overhead_cycles,
            "pipe_launches": self.pipe_launches,
        }


def attribute(comp: Component,
              node: Optional[CNode] = None) -> CycleAttribution:
    """Attribute every cycle of :func:`cycles`'s total to a cause.

    The invariant (asserted across the benchmark matrix): for if-free
    designs the returned counters equal the Calyx-level ``SimStats``,
    the netlist-level ``RtlStats``, and the synthesized counter bank,
    field for field.
    """
    att = CycleAttribution()
    att.total = cycles(comp, node)

    def walk(n: CNode, mult: int) -> None:
        if isinstance(n, GEnable):
            g = comp.groups[n.group]
            att.group_cycles[g.name] = \
                att.group_cycles.get(g.name, 0) + g.latency * mult
            return
        if isinstance(n, CSeq):
            for ch in n.children:
                walk(ch, mult)
            return
        if isinstance(n, CRepeat):
            if n.ii and n.extent > 0:
                # pipelined loop (body is a single group, see
                # pipelining.pipeline_loops): overlapped launch windows
                # keep the group busy (extent-1)*ii + latency cycles
                g = comp.groups[n.body.group]   # type: ignore[union-attr]
                busy = (n.extent - 1) * n.ii + g.latency
                att.group_cycles[g.name] = \
                    att.group_cycles.get(g.name, 0) + busy * mult
                att.fsm_overhead_cycles += F.LOOP_SETUP_CYCLES * mult
                att.stall_ii_cycles += (n.extent - 1) * (n.ii - 1) * mult
                att.pipe_launches += n.extent * mult
                return
            att.fsm_overhead_cycles += (
                F.LOOP_SETUP_CYCLES
                + n.extent * F.LOOP_ITER_OVERHEAD) * mult
            walk(n.body, mult * n.extent)
            return
        if isinstance(n, CIf):
            # statically timed: the FSM reserves max(arms), so charge the
            # worst arm's groups — but which arm *fires* is runtime data
            att.exact = False
            att.fsm_overhead_cycles += \
                (n.cond_latency + F.IF_SELECT_CYCLES) * mult
            t, e = cycles(comp, n.then), cycles(comp, n.els)
            walk(n.then if t >= e else n.els, mult)
            return
        if isinstance(n, CPar):
            arms = n.children
            if not arms:
                return
            att.fsm_overhead_cycles += par_join_cycles(len(arms)) * mult
            for members in par_conflict_components(comp, n):
                wait = 0
                for i in members:
                    att.stall_port_cycles += wait * mult
                    wait += cycles(comp, arms[i])
            for ch in arms:
                walk(ch, mult)
            return
        raise TypeError(n)

    walk(comp.control if node is None else node, 1)
    return att


# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Resources:
    lut: int = 0
    ff: int = 0
    bram: int = 0
    dsp: int = 0

    def add(self, c: F.OpCost, n: int = 1):
        self.lut += c.lut * n
        self.ff += c.ff * n
        self.dsp += c.dsp * n

    def as_dict(self) -> Dict[str, int]:
        return {"LUT": self.lut, "FF": self.ff, "BRAM": self.bram,
                "DSP": self.dsp}


def fsm_states(node: CNode) -> int:
    if isinstance(node, GEnable):
        return 1
    if isinstance(node, CSeq):
        return sum(fsm_states(ch) for ch in node.children)
    if isinstance(node, CPar):
        return 1 + sum(fsm_states(ch) for ch in node.children)
    if isinstance(node, CRepeat):
        return 1 + fsm_states(node.body)
    if isinstance(node, CIf):
        return 1 + fsm_states(node.then) + fsm_states(node.els)
    raise TypeError(node)


def max_select_depth(comp: Component, node: Optional[CNode] = None) -> int:
    """Depth of the deepest bank-selection chain (branchy mode blow-up)."""
    node = comp.control if node is None else node
    if isinstance(node, GEnable):
        return 0
    if isinstance(node, (CSeq, CPar)):
        return max((max_select_depth(comp, ch) for ch in node.children),
                   default=0)
    if isinstance(node, CRepeat):
        return max_select_depth(comp, node.body)
    if isinstance(node, CIf):
        inner = max(max_select_depth(comp, node.then),
                    max_select_depth(comp, node.els))
        return 1 + inner
    raise TypeError(node)


def resources(comp: Component) -> Resources:
    res = Resources()
    for cell in comp.cells.values():
        if cell.kind == "mem_bank":
            res.add(F.memory_cost(cell.words))
            res.bram += F.memory_brams(cell.words)
        elif cell.kind in F.FLOAT_COSTS:
            res.add(F.FLOAT_COSTS[cell.kind])
        elif cell.kind == "int_mul":
            res.add(F.int_mul_cost(cell.const))
        elif cell.kind == "int_divmod":
            res.add(F.int_divmod_cost(cell.const))
        elif cell.kind in F.INT_COSTS:
            res.add(F.INT_COSTS[cell.kind])
        else:
            raise KeyError(cell.kind)
        if cell.users > 1:   # pooled by the sharing pass: operand steering
            res.add(F.sharing_mux_cost(cell.kind, cell.users))
    states = fsm_states(comp.control)
    res.lut += F.FSM_LUT_PER_STATE * states
    res.lut += F.GROUP_FABRIC_LUT * len(comp.groups)
    res.ff += F.FSM_FF_PER_STATE_BIT * max(1, math.ceil(math.log2(states + 1)))
    res.ff += states
    res.lut += F.TOP_OVERHEAD["lut"]
    res.ff += F.TOP_OVERHEAD["ff"]
    res.dsp += F.TOP_OVERHEAD["dsp"]
    res.bram += F.TOP_OVERHEAD["bram"]
    return res


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Estimate:
    cycles: int
    resources: Dict[str, int]
    fsm_states: int
    period_ns: float
    fmax_mhz: float
    wall_us: float
    banking_efficiency: float = 1.0   # worst par concurrency retention

    def as_dict(self):
        return dataclasses.asdict(self)


def estimate(comp: Component) -> Estimate:
    cyc = cycles(comp)
    res = resources(comp)
    states = fsm_states(comp.control)
    depth = max_select_depth(comp)
    period = F.achievable_period_ns(states, depth)
    return Estimate(
        cycles=cyc,
        resources=res.as_dict(),
        fsm_states=states,
        period_ns=round(period, 3),
        fmax_mhz=round(1000.0 / period, 1),
        wall_us=round(cyc * period / 1000.0, 3),
        banking_efficiency=round(banking_efficiency(comp), 4),
    )
