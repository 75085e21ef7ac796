"""Cycle-driven two-state simulator for the structural RTL netlist.

Where ``sim.simulate`` walks the *Calyx control tree* as a scheduler,
this module executes the :class:`rtl.Netlist` itself — the artifact that
``verilog.emit`` prints — one clock cycle at a time: every FSM instance
(root controller plus the child controllers ``par`` states fork) owns a
state register and a down-counter; on each rising edge every live FSM
ticks once, counters decrement, expiring states perform their exit
actions (index increments, loop back-edges, condition branches) and the
successor state's entry actions fire.  Signals are two-state (every wire
carries a definite value — no X/Z propagation), which is the level real
four-state RTL settles to after reset on this design (all state-holding
elements are reset or host-loaded before ``go``).

When a ``group`` state is entered, its datapath block (``rtl.DpBlock``)
executes against the *physical* state: per-bank flat word arrays (never
the logical tensors), the 64-bit data registers, and the controller's
index counters.  Hardware discipline is enforced at netlist granularity:

* every memory access claims its bank's single port at the absolute
  cycle ``group_start + offset``; two same-cycle accesses raise
  :class:`RtlSimError` unless they are identical-address loads (one read
  port broadcasting);
* a group holding a *grant* on a shared unit claims that unit for its
  whole activation window — an overlapping claim by another group means
  the operand muxes would need two selects at once, the single-owner
  invariant ``sharing.share_cells`` promises.

Because the controller's schedule is static (see ``rtl.py``), the
measured cycle count structurally equals ``estimator.cycles`` — the
four-way differential tests assert the equality exactly, alongside
bit-equality of the outputs against ``sim.simulate`` and
``affine.interpret``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import dataflow as D
from . import trace as T
from .affine import pack_banked
from .rtl import (DpBlock, DpConst, DpMemRead, DpMemWrite, DpRegRead,
                  DpRegWrite, DpSelect, DpUnit, Fsm, FsmState, Netlist)


class RtlSimError(RuntimeError):
    """A hardware-discipline violation observed at the netlist level."""


@dataclasses.dataclass
class RtlStats:
    """Measured facts about one netlist execution."""
    cycles: int = 0
    fsm_transitions: int = 0          # state-register updates across FSMs
    group_fires: int = 0
    dp_ops: int = 0
    mem_reads: int = 0
    mem_writes: int = 0
    broadcast_reads: int = 0
    par_forks: int = 0                # par states entered (dynamic)
    child_activations: int = 0        # child FSMs launched
    unit_grants: Dict[str, int] = dataclasses.field(default_factory=dict)
    # cycle-attribution counters — same fields as sim.SimStats; the
    # observability differential asserts them equal level-for-level
    group_cycles: Dict[str, int] = dataclasses.field(default_factory=dict)
    stall_port_cycles: int = 0
    stall_pool_cycles: int = 0
    stall_ii_cycles: int = 0
    fsm_overhead_cycles: int = 0
    pipe_launches: int = 0
    # profiled netlists only (net.profile): the per-cycle counter model
    # that mirrors the synthesized Verilog counter conditions exactly —
    # keys "total", "group:<g>", "stall_port", "stall_pool", "stall_ii",
    # "fsm_overhead"
    counters: Optional[Dict[str, int]] = None

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class _Scope:
    """Chained index-register file: each live controller owns its loop
    counters; lookups for outer loop variables walk up to the forking
    controller — mirroring ``rtl.Netlist.resolve_index``.  Two concurrent
    par arms looping over the same source-level variable therefore count
    on physically distinct registers, exactly as the emitted RTL does.
    """

    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["_Scope"]):
        self.vars: Dict[str, int] = {}
        self.parent = parent

    def __getitem__(self, key: str) -> int:
        s: Optional[_Scope] = self
        while s is not None:
            if key in s.vars:
                return s.vars[key]
            s = s.parent
        raise KeyError(key)

    def get(self, key: str, default=None):
        try:
            return self[key]
        except KeyError:
            return default


class _FsmExec:
    """One live controller instance: state register + down-counter."""

    __slots__ = ("sim", "fsm", "scope", "state", "counter", "done", "phase",
                 "children", "pipe_launched", "pipe_cd", "t0")

    def __init__(self, sim: "_RtlSim", fsm: Fsm, parent: Optional[_Scope]):
        self.sim = sim
        self.fsm = fsm
        self.scope = _Scope(parent)
        self.state: Optional[FsmState] = None
        self.counter = 0
        self.done = False
        self.phase = 0                      # par: 0 = run, 1 = join
        self.children: List["_FsmExec"] = []
        self.pipe_launched = 0              # pipe: iterations launched
        self.pipe_cd = 0                    # pipe: cycles to next launch
        self.t0 = 0                         # activation cycle (stall base)

    # -- state entry ---------------------------------------------------------
    def activate(self, at_cycle: int) -> None:
        self.t0 = at_cycle
        self._enter(self.fsm.states[self.fsm.start], at_cycle)

    def _enter(self, st: FsmState, at_cycle: int) -> None:
        stats = self.sim.stats
        stats.fsm_transitions += 1
        self.state = st
        tr = self.sim._tr
        if tr is not None:
            tr.emit(at_cycle, T.FSM_STATE, st.prov, st.group or "",
                    f"{self.fsm.name}.{st.index}:{st.kind}", dur=st.cycles)
        if st.stall_arm is not None:
            # entry of a serialized par-chain member: everything since
            # this controller's activation was waiting behind its
            # port-conflicting siblings
            wait = at_cycle - self.t0
            stats.stall_port_cycles += wait
            if tr is not None and wait > 0:
                tr.emit(self.t0, T.STALL_PORT, st.stall_arm[0], dur=wait,
                        data=(st.stall_arm[1],))
        if st.kind == "done":
            self.done = True
            return
        if st.set_idx is not None:
            self.scope.vars[st.set_idx] = 0
        if st.kind == "par":
            self.phase = 0
            self.children = [
                _FsmExec(self.sim, self.sim.net.fsms[fid], self.scope)
                for fid in st.children]
            stats.par_forks += 1
            stats.child_activations += len(self.children)
            self.sim.par_depth += 1
            for ch in self.children:
                ch.activate(at_cycle)
            if all(ch.done for ch in self.children):   # all-empty fork
                self.sim.par_exit()
                self.phase = 1
                self.counter = st.join_cycles
                stats.fsm_overhead_cycles += st.join_cycles
                if tr is not None:
                    tr.emit(at_cycle, T.STALL_FSM, st.prov, detail="join",
                            dur=st.join_cycles)
            return
        if st.kind == "pipe":
            # pipelined repeat: launch iteration 0 now (the setup state
            # zeroed the index), then one more every ii cycles in tick()
            var, extent, ii, _lat = st.pipe
            stats.group_cycles[st.group] = \
                stats.group_cycles.get(st.group, 0) + st.cycles
            stats.stall_ii_cycles += (extent - 1) * (ii - 1)
            stats.pipe_launches += 1
            if tr is not None:
                tr.emit(at_cycle, T.PIPE_LAUNCH, st.prov, data=(0,))
            self.sim.pipe_depth += 1
            self.sim.fire_group(st.group, at_cycle, self.scope, st.prov)
            self.pipe_launched = 1
            self.pipe_cd = ii
            self.counter = st.cycles
            return
        if st.kind == "group":
            stats.group_cycles[st.group] = \
                stats.group_cycles.get(st.group, 0) + st.cycles
            self.sim.fire_group(st.group, at_cycle, self.scope, st.prov)
        elif st.kind in ("delay", "cond"):
            # control overhead: loop setup/iterate, if cond/pad
            stats.fsm_overhead_cycles += st.cycles
            if tr is not None:
                tr.emit(at_cycle, T.STALL_FSM, st.prov, detail=st.label,
                        dur=st.cycles)
        self.counter = st.cycles

    # -- one clock edge ------------------------------------------------------
    def tick(self, cycle: int) -> None:
        st = self.state
        if self.done or st is None:
            return
        if st.kind == "par":
            if self.phase == 0:
                for ch in self.children:
                    ch.tick(cycle)
                if all(ch.done for ch in self.children):
                    self.sim.par_exit()
                    self.phase = 1
                    self.counter = st.join_cycles
                    self.sim.stats.fsm_overhead_cycles += st.join_cycles
                    if self.sim._tr is not None:
                        self.sim._tr.emit(cycle + 1, T.STALL_FSM, st.prov,
                                          detail="join", dur=st.join_cycles)
                return
            self.counter -= 1
            if self.counter <= 0:
                self._enter(self.fsm.states[st.next], cycle + 1)
            return
        if st.kind == "pipe":
            var, extent, ii, _lat = st.pipe
            self.counter -= 1
            if self.pipe_launched < extent:
                self.pipe_cd -= 1
                if self.pipe_cd <= 0:
                    i = self.pipe_launched
                    self.scope.vars[var] = i
                    self.sim.stats.pipe_launches += 1
                    if self.sim._tr is not None:
                        self.sim._tr.emit(cycle + 1, T.PIPE_LAUNCH, st.prov,
                                          data=(i,))
                        if ii > 1:
                            self.sim._tr.emit(cycle + 1, T.STALL_II,
                                              st.prov, dur=ii - 1, data=(i,))
                    self.sim.fire_group(st.group, cycle + 1, self.scope,
                                        st.prov)
                    self.pipe_launched += 1
                    self.pipe_cd = ii
            if self.counter <= 0:
                self.sim.pipe_exit()
                self._enter(self.fsm.states[st.next], cycle + 1)
            return
        self.counter -= 1
        if self.counter > 0:
            return
        # state expiry: exit actions decide the successor
        target = st.next
        if st.inc_idx is not None:
            self.scope.vars[st.inc_idx] = \
                self.scope.vars.get(st.inc_idx, 0) + 1
        if st.loop is not None:
            var, extent, head = st.loop
            if self.scope.vars.get(var, 0) < extent:
                target = head
        if st.kind == "cond":
            taken = st.cond.evaluate(self.scope)
            target = st.then_state if taken else st.else_state
        self._enter(self.fsm.states[target], cycle + 1)


class _RtlSim:
    def __init__(self, net: Netlist, tracer: Optional[T.Tracer] = None):
        self.net = net
        self.stats = RtlStats()
        self._tr = tracer                          # trace hook (None = off)
        self.banks: Dict[str, np.ndarray] = {}     # flat f64 word arrays
        self.regs: Dict[str, float] = {}
        self.par_depth = 0
        self.pipe_depth = 0                        # live pipelined loops
        # (bank, cycle) -> (is_store, full address tuple)
        self._ports: Dict[Tuple[str, int], Tuple[bool, tuple]] = {}
        # (unit, cycle) -> owning group
        self._unit_owner: Dict[Tuple[str, int], str] = {}
        # in-bank row strides, precomputed per logical memory
        self._strides: Dict[str, Tuple[int, ...]] = {
            spec.name: spec.row_strides() for spec in net.mems.values()}

    # -- host loading ---------------------------------------------------------
    def load(self, inputs: Dict[str, np.ndarray],
             params: Dict[str, np.ndarray]) -> None:
        """Stage tensors into the physical banks — the writes a host would
        push through the module's host port while the FSM is idle."""
        for spec in self.net.mems.values():
            if spec.role in ("input", "param"):
                src = inputs[spec.name] if spec.role == "input" \
                    else params[spec.name]
                arr = np.asarray(src, dtype=np.float64)
                if spec.banks:
                    arr = pack_banked(arr.reshape(spec.orig_shape),
                                      spec.banks)
                else:
                    arr = arr.reshape(spec.shape)
            else:
                arr = np.zeros(spec.shape, dtype=np.float64)
            if spec.banks:
                for b, bn in enumerate(spec.bank_names):
                    self.banks[bn] = arr[b].reshape(-1).copy()
            else:
                self.banks[spec.bank_names[0]] = arr.reshape(-1).copy()

    def unload(self) -> Dict[str, np.ndarray]:
        """Reassemble every logical memory from its banks (banked layout,
        as declared — identical to what ``sim.simulate`` returns)."""
        out: Dict[str, np.ndarray] = {}
        for spec in self.net.mems.values():
            parts = [self.banks[bn].reshape(spec.intra)
                     for bn in spec.bank_names]
            if spec.banks:
                out[spec.name] = np.stack(parts)
            else:
                out[spec.name] = parts[0].reshape(spec.shape)
        return out

    # -- memory port discipline -----------------------------------------------
    def _locate(self, mem: str, idxs, env: _Scope) -> Tuple[str, int, tuple]:
        spec = self.net.mems[mem]
        vals = tuple(ix.evaluate(env) for ix in idxs)
        if spec.banks:
            bank, addr_dims = int(vals[0]), vals[1:]
        else:
            bank, addr_dims = 0, vals
        flat = sum(int(v) * s for v, s in zip(addr_dims, self._strides[mem]))
        return spec.bank_names[bank], flat, vals

    def _claim_port(self, bank: str, cycle: int, is_store: bool,
                    addr: tuple) -> None:
        key = (bank, cycle)
        prev = self._ports.get(key)
        if prev is None:
            self._ports[key] = (is_store, addr)
            return
        pstore, paddr = prev
        if not is_store and not pstore and paddr == addr:
            self.stats.broadcast_reads += 1
            return
        raise RtlSimError(
            f"[RV020] bank {bank} port double-driven at cycle {cycle}: "
            f"{'write' if is_store else 'read'}@{addr} vs "
            f"{'write' if pstore else 'read'}@{paddr} — the bank has one "
            f"port, one access per cycle")

    def _claim_unit(self, unit: str, group: str, start: int,
                    latency: int) -> None:
        for c in range(start, start + latency):
            owner = self._unit_owner.setdefault((unit, c), group)
            if owner != group:
                raise RtlSimError(
                    f"[RV021] shared unit {unit} granted to {group} while "
                    f"owned by "
                    f"{owner} at cycle {c} — operand muxes need two selects "
                    f"in one cycle")

    def par_exit(self) -> None:
        """A fork completed; once no par is live every stamped window is
        strictly in the past — drop the claim tables so they stay bounded
        by the widest concurrent window, not the whole run (mirrors the
        Calyx simulator's post-par port-table clear)."""
        self.par_depth -= 1
        if self.par_depth == 0 and self.pipe_depth == 0:
            self._ports.clear()
            self._unit_owner.clear()

    def pipe_exit(self) -> None:
        """A pipelined loop drained its last iteration — same bounding
        rule as :meth:`par_exit`."""
        self.pipe_depth -= 1
        if self.par_depth == 0 and self.pipe_depth == 0:
            self._ports.clear()
            self._unit_owner.clear()

    # -- datapath execution ----------------------------------------------------
    def fire_group(self, gname: str, start: int, env: _Scope,
                   prov: Tuple[str, ...] = ()) -> None:
        if self.par_depth == 0 and self.pipe_depth == 0:
            # sequential flow: all stamped windows are strictly past
            self._ports.clear()
            self._unit_owner.clear()
        self.stats.group_fires += 1
        blk: DpBlock = self.net.blocks[gname]
        tr = self._tr
        gprov: Tuple[str, ...] = ()
        if tr is not None:
            gprov = prov + (gname,)
            tr.emit(start, T.GROUP_START, gprov, gname, dur=blk.latency)
            tr.emit(start + blk.latency, T.GROUP_STOP, gprov, gname)
        for uname in blk.pooled_units:
            self._claim_unit(uname, gname, start, blk.latency)
            self.stats.unit_grants[uname] = \
                self.stats.unit_grants.get(uname, 0) + 1
            if tr is not None:
                tr.emit(start, T.POOL_GRANT, gprov, gname, detail=uname,
                        dur=blk.latency)
        wires: Dict[int, float] = {}
        for op in blk.ops:
            self.stats.dp_ops += 1
            if isinstance(op, DpConst):
                if tr is not None:
                    tr.emit(start, T.UOP, gprov, gname, "const")
                wires[op.dst] = op.value
            elif isinstance(op, DpRegRead):
                if tr is not None:
                    tr.emit(start, T.UOP, gprov, gname, f"regrd:{op.reg}")
                wires[op.dst] = self.regs[op.reg]
            elif isinstance(op, DpMemRead):
                bank, flat, vals = self._locate(op.mem, op.idxs, env)
                self._claim_port(bank, start + op.off, False, vals)
                self.stats.mem_reads += 1
                if tr is not None:
                    tr.emit(start + op.off, T.UOP, gprov, gname,
                            f"memrd:{op.mem}")
                    tr.emit(start + op.off, T.PORT_GRANT, gprov, gname,
                            f"R:{op.mem}:b{self.net.banks[bank].index}",
                            data=vals)
                wires[op.dst] = float(self.banks[bank][flat])
            elif isinstance(op, DpUnit):
                if tr is not None:
                    tr.emit(start + op.off, T.UOP, gprov, gname,
                            f"alu:{op.op}:{op.unit}")
                b = None if op.b is None else wires[op.b]
                wires[op.dst] = D.alu(op.op, wires[op.a], b)
            elif isinstance(op, DpSelect):
                if tr is not None:
                    tr.emit(start + op.off, T.UOP, gprov, gname, "select")
                wires[op.dst] = wires[op.a] if op.cond.evaluate(env) \
                    else wires[op.b]
            elif isinstance(op, DpRegWrite):
                if tr is not None:
                    tr.emit(start + op.off, T.UOP, gprov, gname,
                            f"regwr:{op.reg}")
                self.regs[op.reg] = wires[op.src]
            elif isinstance(op, DpMemWrite):
                bank, flat, vals = self._locate(op.mem, op.idxs, env)
                self._claim_port(bank, start + op.off, True, vals)
                self.stats.mem_writes += 1
                if tr is not None:
                    tr.emit(start + op.off, T.UOP, gprov, gname,
                            f"memwr:{op.mem}")
                    tr.emit(start + op.off, T.PORT_GRANT, gprov, gname,
                            f"W:{op.mem}:b{self.net.banks[bank].index}",
                            data=vals)
                self.banks[bank][flat] = wires[op.src]
            else:
                raise TypeError(op)

    # -- clock loop ------------------------------------------------------------
    def run(self) -> int:
        root = _FsmExec(self, self.net.fsms[0], None)
        counters: Optional[Dict[str, int]] = None
        if self.net.profile:
            counters = {_counter_key(c): 0 for c in self.net.counters}
        root.activate(0)                     # go handshake: launch at cycle 0
        cycle = 0
        while not root.done:
            if counters is not None:
                # evaluate the hardware counter-increment conditions on
                # the settled pre-edge state — exactly what each
                # synthesized always_ff samples at this rising edge
                self._count_cycle(root, counters)
            root.tick(cycle)
            cycle += 1
        if counters is not None:
            self.stats.counters = counters
        return cycle                         # done rose after `cycle` cycles

    # -- per-cycle counter model (mirrors verilog._emit_perf_counters) ---------
    def _count_cycle(self, root: "_FsmExec", counters: Dict[str, int]) -> None:
        counters["total"] += 1               # busy && !done: every run cycle
        stack = [root]
        while stack:
            ex = stack.pop()
            st = ex.state
            if ex.done or st is None:
                continue
            if st.kind in ("group", "pipe"):
                counters[f"group:{st.group}"] += 1      # g_<g>_go high
                if st.kind == "pipe":
                    var, extent, ii, _lat = st.pipe
                    if ex.pipe_launched < extent and ex.pipe_cd > 1:
                        counters["stall_ii"] += 1        # inter-launch wait
            elif st.kind in ("delay", "cond"):
                counters["fsm_overhead"] += 1
            elif st.kind == "par":
                if ex.phase == 1:
                    counters["fsm_overhead"] += 1        # join reduction
                else:
                    stack.extend(ex.children)
            if st.stall_weight:
                # each resident cycle of this chain member delays
                # stall_weight later siblings by one cycle
                counters["stall_port"] += st.stall_weight
        # stall_pool stays 0: binding keeps each shared pool inside one
        # serialized chain, so the two-owners condition never fires


def _counter_key(c) -> str:
    return f"group:{c.group}" if c.kind == "group" else c.kind


def simulate(net: Netlist, inputs: Dict[str, np.ndarray],
             params: Dict[str, np.ndarray],
             tracer: Optional[T.Tracer] = None
             ) -> Tuple[Dict[str, np.ndarray], RtlStats]:
    """Execute the netlist cycle-by-cycle; return (logical memories in
    their declared banked layout, measured :class:`RtlStats`)."""
    sim = _RtlSim(net, tracer)
    sim.load(inputs, params)
    sim.stats.cycles = sim.run()
    return sim.unload(), sim.stats
