"""Cycle-accurate FSM simulator for the Calyx-like IR.

Where ``affine.interpret`` executes the *source* of the lowering and
``estimator.cycles`` predicts the schedule of its *result* from a closed
form, this module executes the lowered component itself: it walks the
control tree as an FSM scheduler, fires each group's recorded micro-ops
(``Group.uops``, see ``core.dataflow``) against real register/memory
state, and advances a cycle clock — so both the output tensors *and* the
cycle count are measured, not modeled.

Scheduling semantics (the constructive twin of the estimator's model):

* ``seq``     — children run back to back.
* ``repeat``  — loop setup, then each iteration runs the body plus the
                per-iteration overhead; the body's iteration variable is
                bound in the environment the micro-ops evaluate addresses
                against.
* ``if``      — the condition is evaluated and only the taken arm
                *executes*, but the control FSM is statically timed: the
                state reserves the worst-case arm latency (the non-taken
                arm's static cycles), matching real Calyx static control
                and the estimator's ``max(arms)`` term.
* ``par``     — arms are partitioned with the estimator's own
                :func:`estimator.par_conflict_components`: arms that hit a
                common single-ported (memory, bank) serialize inside their
                component, components run concurrently, and the join
                handshake closes the block.  The simulator additionally
                enforces the constraint the partition is meant to uphold —
                every memory access is stamped into a per-(memory, bank,
                cycle) port table, and two same-cycle accesses raise
                :class:`SimError` unless they are identical-address loads
                (a broadcast from one read port).

Shared functional units (``Cell.users > 1``, produced by
``sharing.share_cells``) are arbitrated for single ownership: concurrent
``par`` components must not both invoke the same pool cell, otherwise the
design would need to serialize — exactly the invariant the binding pass
promises.  Violations raise :class:`SimError` rather than silently
mis-simulating.

Because every control construct's duration is input-independent (see the
``if`` rule), measured cycles structurally equal ``estimator.cycles``; the
differential tests assert the equality exactly, making every compiled
design an end-to-end hardware-semantics test.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from . import dataflow as D
from . import estimator
from . import float_lib as F
from . import trace as T
from .affine import Program, pack_banked
from .calyx import CIf, CNode, CPar, CRepeat, CSeq, Component, GEnable


class SimError(RuntimeError):
    """A dynamic hardware-semantics violation (port clash, FU contention)."""


@dataclasses.dataclass
class SimStats:
    """Measured facts about one simulation run."""
    cycles: int = 0                  # measured end-to-end latency
    group_activations: int = 0
    uops: int = 0
    mem_reads: int = 0
    mem_writes: int = 0
    broadcast_reads: int = 0         # same-cycle identical-address loads
    par_blocks: int = 0              # par nodes executed (dynamic count)
    serialized_arms: int = 0         # arms forced behind a sibling by ports
    fu_grants: Dict[str, int] = dataclasses.field(default_factory=dict)
    # cycle-attribution counters — same fields as rtl_sim.RtlStats and
    # the synthesized perf-counter bank; the observability differential
    # asserts all of them equal across levels
    group_cycles: Dict[str, int] = dataclasses.field(default_factory=dict)
    stall_port_cycles: int = 0       # par arms serialized behind siblings
    stall_pool_cycles: int = 0       # shared-pool waits (0 by construction)
    stall_ii_cycles: int = 0         # initiation-interval recurrence loss
    fsm_overhead_cycles: int = 0     # setup/iter/cond/pad/join states
    pipe_launches: int = 0

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class _Sim:
    def __init__(self, comp: Component, prog: Program,
                 tracer: Optional[T.Tracer] = None):
        self.comp = comp
        self.prog = prog
        self.stats = SimStats()
        self.regs: Dict[str, float] = {}
        self.mems: Dict[str, np.ndarray] = {}
        self._env: Dict[str, int] = {}
        self._gstart = 0                       # active group's start cycle
        self._par_depth = 0                    # live par nesting depth
        self._pipe_depth = 0                   # live pipelined-loop depth
        # trace hook — None unless tracing; every emission site is guarded
        # so the off path allocates no events and no provenance tuples
        self._tr = tracer
        self._gprov: Tuple[str, ...] = ()      # active group's provenance
        self._ggroup = ""                      # active group's name
        self._pooled: Dict[str, List[str]] = {}
        # (mem, bank, cycle) -> (is_store, address-tuple).  Clashes can only
        # happen between accesses whose windows overlap — i.e. inside one
        # group or under a live par — so the table is cleared whenever the
        # schedule is provably past all stamped cycles (see run/_run_par),
        # bounding it to the widest concurrent window instead of the run.
        self._ports: Dict[Tuple[str, int, int], Tuple[bool, tuple]] = {}
        # memoization keyed by control-node identity (the tree is static)
        self._static: Dict[int, int] = {}
        self._components: Dict[int, List[List[int]]] = {}
        self._shared: Dict[int, FrozenSet[str]] = {}
        self._par_checked: Set[int] = set()

    # -- memory state ---------------------------------------------------------
    def init_mems(self, inputs: Dict[str, np.ndarray],
                  params: Dict[str, np.ndarray]) -> None:
        orig_shapes = self.prog.meta.get("orig_shapes", {})
        for name, decl in self.prog.mems.items():
            if decl.role in ("input", "param"):
                src = inputs[name] if decl.role == "input" else params[name]
                arr = np.asarray(src, dtype=np.float64)
                if decl.banks:
                    arr = pack_banked(arr.reshape(orig_shapes[name]),
                                      decl.banks)
                else:
                    arr = arr.reshape(decl.shape)
            else:
                arr = np.zeros(decl.shape, dtype=np.float64)
            self.mems[name] = arr.copy()

    def _locate(self, mem: str, idxs) -> Tuple[tuple, int]:
        vals = tuple(ix.evaluate(self._env) for ix in idxs)
        if self.prog.mems[mem].banks:
            return vals, int(vals[0])
        return vals, 0

    def _claim_port(self, mem: str, bank: int, cycle: int,
                    is_store: bool, addr: tuple) -> None:
        key = (mem, bank, cycle)
        prev = self._ports.get(key)
        if prev is None:
            self._ports[key] = (is_store, addr)
            return
        pstore, paddr = prev
        if not is_store and not pstore and paddr == addr:
            self.stats.broadcast_reads += 1   # one read port feeds both
            return
        # same stable codes the static verifier reports: RV022 when the
        # clash comes from overlapped pipelined iterations (an unsound II),
        # RV020 for a plain same-cycle port conflict
        code = "RV022" if self._pipe_depth > 0 else "RV020"
        raise SimError(
            f"[{code}] memory port violation on {mem} bank {bank} at cycle "
            f"{cycle}: {'write' if is_store else 'read'}@{addr} clashes with "
            f"{'write' if pstore else 'read'}@{paddr} — Calyx memories "
            f"accept one access per cycle")

    def _read_mem(self, u: D.UMemRead) -> float:
        vals, bank = self._locate(u.mem, u.idxs)
        self._claim_port(u.mem, bank, self._gstart + u.off, False, vals)
        self.stats.mem_reads += 1
        if self._tr is not None:
            self._tr.emit(self._gstart + u.off, T.PORT_GRANT, self._gprov,
                          self._ggroup, f"R:{u.mem}:b{bank}", data=vals)
        return float(self.mems[u.mem][vals])

    def _write_mem(self, u: D.UMemWrite, value: float) -> None:
        vals, bank = self._locate(u.mem, u.idxs)
        self._claim_port(u.mem, bank, self._gstart + u.off, True, vals)
        self.stats.mem_writes += 1
        if self._tr is not None:
            self._tr.emit(self._gstart + u.off, T.PORT_GRANT, self._gprov,
                          self._ggroup, f"W:{u.mem}:b{bank}", data=vals)
        self.mems[u.mem][vals] = value

    def _on_alu(self, u: D.UAlu) -> None:
        cell = self.comp.cells.get(u.cell)
        if cell is not None and cell.users > 1:
            self.stats.fu_grants[u.cell] = \
                self.stats.fu_grants.get(u.cell, 0) + 1

    def _on_uop(self, u: D.UOp) -> None:
        # trace hook (installed only when tracing): one event per issue
        self._tr.emit(self._gstart + D.uop_off(u), T.UOP, self._gprov,
                      self._ggroup, D.uop_detail(u))

    def _pooled_units(self, g) -> List[str]:
        """Shared pool cells the group invokes, in micro-op first-use
        order — the same order ``rtl.lower_component`` records in
        ``DpBlock.pooled_units``, so both simulators' ``pool:grant``
        events line up."""
        got = self._pooled.get(g.name)
        if got is None:
            got = []
            for u in g.uops:
                if isinstance(u, D.UAlu) and u.cell not in got:
                    cell = self.comp.cells.get(u.cell)
                    if cell is not None and cell.users > 1:
                        got.append(u.cell)
            self._pooled[g.name] = got
        return got

    # -- FSM scheduler --------------------------------------------------------
    def run(self, node: CNode, start: int,
            path: Tuple[str, ...] = ()) -> int:
        """Execute ``node`` beginning at absolute cycle ``start``; return
        the cycle at which its done signal rises.  ``path`` is the
        control-tree provenance chain (see ``core.trace``); it is only
        extended while tracing, so the off path allocates nothing."""
        tr = self._tr
        if isinstance(node, GEnable):
            g = self.comp.groups[node.group]
            if not g.uops:
                raise SimError(
                    f"[RV007] group {g.name} carries no micro-ops — the "
                    f"component was built without datapath semantics "
                    f"(re-lower with calyx.lower_program)")
            self.stats.group_activations += 1
            if self._par_depth == 0 and self._pipe_depth == 0:
                # sequential flow: earlier windows are strictly in the past
                self._ports.clear()
            self._gstart = start
            if self._pipe_depth == 0:
                # pipelined launches overlap; the loop accounts the union
                self.stats.group_cycles[g.name] = \
                    self.stats.group_cycles.get(g.name, 0) + g.latency
            on_uop = None
            if tr is not None:
                self._gprov = path + (g.name,)
                self._ggroup = g.name
                tr.emit(start, T.GROUP_START, self._gprov, g.name,
                        dur=g.latency)
                tr.emit(start + g.latency, T.GROUP_STOP, self._gprov,
                        g.name)
                for unit in self._pooled_units(g):
                    tr.emit(start, T.POOL_GRANT, self._gprov, g.name,
                            detail=unit, dur=g.latency)
                on_uop = self._on_uop
            self.stats.uops += D.execute(g.uops, self._env, self.regs,
                                         self._read_mem, self._write_mem,
                                         self._on_alu, on_uop)
            return start + g.latency
        if isinstance(node, CSeq):
            t = start
            if tr is None:
                for ch in node.children:
                    t = self.run(ch, t, path)
            else:
                for k, ch in enumerate(node.children):
                    t = self.run(ch, t, path + (T.seq_label(k),))
            return t
        if isinstance(node, CRepeat):
            lpath = path if tr is None else path + (T.loop_label(node.var),)
            if node.ii and node.extent > 0:
                # pipelined loop: iteration i launches at setup + i*ii and
                # its port claims are stamped at those absolute cycles —
                # overlapped windows coexist in the port table, so an
                # unsound initiation interval raises SimError instead of
                # silently mis-simulating the hardware
                g = self.comp.groups[node.body.group]  # body is one group
                self.stats.fsm_overhead_cycles += F.LOOP_SETUP_CYCLES
                self.stats.group_cycles[g.name] = \
                    self.stats.group_cycles.get(g.name, 0) \
                    + (node.extent - 1) * node.ii + g.latency
                self.stats.stall_ii_cycles += \
                    (node.extent - 1) * (node.ii - 1)
                self.stats.pipe_launches += node.extent
                if tr is not None:
                    tr.emit(start, T.STALL_FSM, lpath, detail="setup",
                            dur=F.LOOP_SETUP_CYCLES)
                t = start + F.LOOP_SETUP_CYCLES
                end = t
                self._pipe_depth += 1
                for i in range(node.extent):
                    if node.var:
                        self._env[node.var] = i
                    if tr is not None:
                        tr.emit(t, T.PIPE_LAUNCH, lpath, data=(i,))
                        if i and node.ii > 1:
                            tr.emit(t, T.STALL_II, lpath, dur=node.ii - 1,
                                    data=(i,))
                    end = max(end, self.run(node.body, t, lpath))
                    t += node.ii
                self._pipe_depth -= 1
                if self._par_depth == 0 and self._pipe_depth == 0:
                    self._ports.clear()    # drained: windows are past
                return end
            self.stats.fsm_overhead_cycles += \
                F.LOOP_SETUP_CYCLES + node.extent * F.LOOP_ITER_OVERHEAD
            if tr is not None:
                tr.emit(start, T.STALL_FSM, lpath, detail="setup",
                        dur=F.LOOP_SETUP_CYCLES)
            t = start + F.LOOP_SETUP_CYCLES
            for i in range(node.extent):
                if node.var:
                    self._env[node.var] = i
                t = self.run(node.body, t, lpath)
                if tr is not None:
                    tr.emit(t, T.STALL_FSM, lpath, detail="iter",
                            dur=F.LOOP_ITER_OVERHEAD)
                t += F.LOOP_ITER_OVERHEAD
            return t
        if isinstance(node, CIf):
            if node.cond is None:
                raise SimError("[RV005] if-node carries no condition — "
                           "component predates the executable lowering")
            body_start = start + node.cond_latency + F.IF_SELECT_CYCLES
            self.stats.fsm_overhead_cycles += \
                node.cond_latency + F.IF_SELECT_CYCLES
            taken_then = bool(node.cond.evaluate(self._env))
            taken = node.then if taken_then else node.els
            other = node.els if taken is node.then else node.then
            apath = path
            if tr is not None:
                ipath = path + (T.IF_LABEL,)
                tr.emit(start, T.STALL_FSM, ipath, detail="cond",
                        dur=node.cond_latency + F.IF_SELECT_CYCLES)
                apath = ipath + \
                    (T.THEN_LABEL if taken_then else T.ELSE_LABEL,)
            end = self.run(taken, body_start, apath)
            # statically-timed if: the FSM reserves the worst-case arm;
            # a shorter taken arm pads out the difference
            pad = body_start + self._static_cycles(other) - end
            if pad > 0:
                self.stats.fsm_overhead_cycles += pad
                if tr is not None:
                    tr.emit(end, T.STALL_FSM, apath, detail="pad", dur=pad)
                end += pad
            return end
        if isinstance(node, CPar):
            return self._run_par(node, start, path)
        raise TypeError(node)

    def _static_cycles(self, node: CNode) -> int:
        key = id(node)
        if key not in self._static:
            self._static[key] = estimator.cycles(self.comp, node)
        return self._static[key]

    def _run_par(self, node: CPar, start: int,
                 path: Tuple[str, ...] = ()) -> int:
        arms = node.children
        if not arms:
            return start
        self.stats.par_blocks += 1
        comps = self._components.get(id(node))
        if comps is None:
            comps = estimator.par_conflict_components(self.comp, node)
            self._components[id(node)] = comps
        self._check_fu_arbitration(node, comps)
        self._par_depth += 1
        tr = self._tr
        ppath = path if tr is None else path + (T.PAR_LABEL,)
        ends = []
        for members in comps:
            t = start                      # components start concurrently
            for p, i in enumerate(members):  # conflicting arms serialize
                apath = ppath if tr is None \
                    else ppath + (T.arm_label(i),)
                if p:
                    # this arm waited behind its port-conflicting siblings
                    wait = t - start
                    self.stats.stall_port_cycles += wait
                    if tr is not None and wait > 0:
                        tr.emit(start, T.STALL_PORT, apath, dur=wait,
                                data=(p,))
                t = self.run(arms[i], t, apath)
            self.stats.serialized_arms += len(members) - 1
            ends.append(t)
        self._par_depth -= 1
        if self._par_depth == 0 and self._pipe_depth == 0:
            self._ports.clear()            # everything stamped is now past
        join = estimator.par_join_cycles(len(arms))
        self.stats.fsm_overhead_cycles += join
        if tr is not None:
            tr.emit(max(ends), T.STALL_FSM, ppath, detail="join", dur=join)
        return max(ends) + join

    # -- shared-FU arbitration ------------------------------------------------
    def _subtree_shared_cells(self, node: CNode) -> FrozenSet[str]:
        key = id(node)
        got = self._shared.get(key)
        if got is not None:
            return got
        if isinstance(node, GEnable):
            out = frozenset(
                c for c in self.comp.groups[node.group].cells
                if c in self.comp.cells and self.comp.cells[c].users > 1)
        elif isinstance(node, (CSeq, CPar)):
            out = frozenset().union(
                *[self._subtree_shared_cells(ch) for ch in node.children]) \
                if node.children else frozenset()
        elif isinstance(node, CRepeat):
            out = self._subtree_shared_cells(node.body)
        elif isinstance(node, CIf):
            out = (self._subtree_shared_cells(node.then)
                   | self._subtree_shared_cells(node.els))
        else:
            raise TypeError(node)
        self._shared[key] = out
        return out

    def _check_fu_arbitration(self, node: CPar,
                              comps: List[List[int]]) -> None:
        """Concurrent components must not both own a shared pool cell.

        Arms inside one conflict component serialize, so they may reuse a
        pool cell across their (disjoint) windows; arms in *different*
        components overlap in time, and a pool cell reachable from two of
        them would need a second owner in the same cycle.  The structure
        is static, so each par node is checked once per run.
        """
        if id(node) in self._par_checked or len(comps) <= 1:
            self._par_checked.add(id(node))
            return
        self._par_checked.add(id(node))
        sets = [frozenset().union(
            *[self._subtree_shared_cells(node.children[i]) for i in members])
            for members in comps]
        for i in range(len(sets)):
            for j in range(i + 1, len(sets)):
                both = sets[i] & sets[j]
                if both:
                    raise SimError(
                        f"[RV021] shared cell(s) {sorted(both)} invoked "
                        f"from two concurrent par components — single-owner "
                        f"arbitration of shared functional units failed")


def simulate(comp: Component, prog: Program,
             inputs: Dict[str, np.ndarray],
             params: Dict[str, np.ndarray],
             tracer: Optional[T.Tracer] = None
             ) -> Tuple[Dict[str, np.ndarray], SimStats]:
    """Cycle-accurately execute ``comp`` (lowered from ``prog``).

    Returns the final memory state (banked layout, as declared by the
    program) and the measured :class:`SimStats`.  ``prog`` supplies the
    memory declarations/roles and the banked packing of inputs and params —
    the same staging a host performs before launching the accelerator.
    Pass a :class:`trace.Tracer` to record the canonical event trace
    (``core.trace``) at micro-op granularity; the default leaves every
    trace hook cold.
    """
    sim = _Sim(comp, prog, tracer)
    sim.init_mems(inputs, params)
    end = sim.run(comp.control, 0)
    sim.stats.cycles = end
    return sim.mems, sim.stats
