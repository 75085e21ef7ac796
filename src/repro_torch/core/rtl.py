"""Calyx IR -> structural netlist: the "last mile" the paper is named for.

``calyx.Component`` is still a *control-tree* artifact: groups carry
latencies and micro-ops, but nothing is yet a state machine or a wire.
This module lowers a component (plus the affine program's memory
declarations) to a :class:`Netlist` — the FSM + datapath netlist a real
Calyx/CIRCT backend would hand to SystemVerilog emission:

* **Controllers** — the control tree is compiled into explicit FSMs
  (:class:`Fsm` / :class:`FsmState`) the way Calyx's top-down control
  compilation does: ``seq`` chains states, ``repeat`` becomes a setup
  state, the body chain, and an iterate state with an index counter and a
  back-edge, ``if`` becomes a condition-evaluation state that branches
  into two arms padded to the worst-case arm latency (the statically
  timed ``if`` the estimator and simulator agree on), and ``par`` becomes
  a fork/join state that activates one *child FSM per port-conflict
  component* (`estimator.par_conflict_components` — arms that fight over
  a single-ported bank are chained inside one child, conflict-free
  components run concurrently) followed by a join-handshake wait.
  Because every state's duration is a compile-time constant, the whole
  controller's schedule is static — RTL-measured cycles provably equal
  ``estimator.cycles``.

* **Datapath blocks** — each group's micro-ops (``Group.uops``) become a
  :class:`DpBlock` of netlist operations over group-local wires: unit
  invocations resolved to physical :class:`UnitInst` instances (with a
  *grant slot* when the unit is a shared pool produced by
  ``sharing.share_cells`` — the slot indexes the operand muxes recorded
  as :class:`OperandMux`), register reads/writes, and memory port
  accesses with their in-group cycle offsets.

* **Memories** — every logical memory becomes one single-ported
  :class:`BankInst` per bank (:class:`MemSpec` keeps the logical->bank
  mapping), preserving the one-access-per-cycle port discipline that the
  banking story rests on.

The netlist is what ``verilog.emit`` prints as synthesizable SystemVerilog
and what ``rtl_sim.simulate`` executes cycle-by-cycle — closing the
four-way differential harness (RTL ≡ Calyx-sim ≡ affine interp ≡ jnp
oracle, RTL cycles ≡ estimate).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from . import dataflow as D
from . import estimator
from . import float_lib as F
from . import trace as T
from .affine import Cond, Program
from .calyx import (CIf, CNode, CPar, CRepeat, CSeq, Component, GEnable)

# Host-bus bank id that selects the synthesized perf-counter bank
# (profile=True netlists only).  Data banks are numbered 0..n-1, so the
# top of the 16-bit bank space can never collide with one.
PROFILE_HOST_BANK = 0xFFFF

# Operand count per shareable/datapath unit kind — sizes the operand-mux
# trees a pooled unit needs (one mux tree per operand).
UNIT_OPERANDS: Dict[str, int] = {
    "fp_add": 2, "fp_sub": 2, "fp_mul": 2, "fp_div": 2,
    "fp_max": 2, "fp_min": 2,
    "fp_exp": 1, "fp_relu": 1, "fp_neg": 1,
    "int_mul": 1, "int_divmod": 1,
}


def unit_latency(kind: str, const: int = 0) -> int:
    """Pipeline depth of one datapath unit — mirrors float_lib exactly."""
    if kind in F.FLOAT_COSTS:
        return F.FLOAT_COSTS[kind].cycles
    if kind == "int_mul":
        return F.int_mul_cost(const).cycles
    if kind == "int_divmod":
        return F.int_divmod_cost(const).cycles
    if kind in F.INT_COSTS:
        return F.INT_COSTS[kind].cycles
    raise KeyError(kind)


# ---------------------------------------------------------------------------
# Structure: memories, registers, units, muxes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BankInst:
    """One physical single-ported memory bank (1 access / cycle)."""
    name: str
    mem: str                  # logical memory this bank belongs to
    index: int                # bank number within the logical memory
    words: int


@dataclasses.dataclass
class MemSpec:
    """Logical memory -> physical bank mapping."""
    name: str
    shape: Tuple[int, ...]    # declared (banked) shape
    banks: Tuple[int, ...]    # cyclic factors; () = unbanked
    role: str                 # input | param | temp | output
    orig_shape: Optional[Tuple[int, ...]]
    bank_names: List[str]
    intra: Tuple[int, ...]    # per-bank logical shape

    @property
    def words(self) -> int:
        out = 1
        for s in self.intra:
            out *= s
        return out

    def row_strides(self) -> Tuple[int, ...]:
        """Word strides flattening one bank's ``intra`` shape — the single
        source of the bank layout for both the RTL simulator and the
        Verilog address expressions."""
        strides: List[int] = []
        s = 1
        for d in reversed(self.intra):
            strides.insert(0, s)
            s *= d
        return tuple(strides)


@dataclasses.dataclass
class RegInst:
    """64-bit data register (reg32 cell widened to the sim's f64 datapath)."""
    name: str                 # signal name (reg_<x>)
    reg: str                  # micro-op-level register key


@dataclasses.dataclass
class IndexReg:
    """Loop index counter owned by one FSM controller.

    Index registers are *per controller*, not global: two concurrent
    ``par`` arms may each run a repeat over the same source-level loop
    variable (the scheduler clones arm bodies without renaming), and in
    hardware each arm's controller owns its own physical counter.  Name
    resolution for datapath address expressions walks the controller
    parent chain (see :meth:`Netlist.resolve_index`).
    """
    name: str                 # unique signal name
    var: str                  # loop variable it implements
    extent: int               # max value + 1 (sizes the counter)
    fid: int                  # owning controller


@dataclasses.dataclass
class UnitInst:
    """A physical datapath unit instance (possibly a shared pool cell)."""
    name: str
    kind: str
    latency: int
    const: int = 0
    users: int = 1            # grant slots (1 = private)


@dataclasses.dataclass
class OperandMux:
    """Steering mux tree feeding one operand of a shared unit."""
    unit: str
    operand: int              # 0 = a, 1 = b
    fan_in: int               # = unit.users

    @property
    def mux2_count(self) -> int:
        """Equivalent 2:1 muxes (chain depth of the steering tree)."""
        return max(0, self.fan_in - 1)


# ---------------------------------------------------------------------------
# Datapath blocks (per group)
# ---------------------------------------------------------------------------


class DpOp:
    """Base class for netlist datapath operations (SSA over group wires)."""


@dataclasses.dataclass
class DpConst(DpOp):
    dst: int
    value: float


@dataclasses.dataclass
class DpRegRead(DpOp):
    dst: int
    reg: str


@dataclasses.dataclass
class DpMemRead(DpOp):
    dst: int
    mem: str
    idxs: list                # AExpr per dimension (bank dim first if banked)
    off: int                  # cycle offset of the port access in the group


@dataclasses.dataclass
class DpUnit(DpOp):
    dst: int
    unit: str                 # UnitInst name
    op: str
    a: int
    b: Optional[int]
    grant: int = -1           # slot in the unit's operand muxes; -1 = private
    off: int = 0              # cycle offset at which the unit starts


@dataclasses.dataclass
class DpSelect(DpOp):
    dst: int
    cond: Cond
    a: int
    b: int
    off: int = 0              # cycle offset at which the mux selects


@dataclasses.dataclass
class DpRegWrite(DpOp):
    reg: str
    src: int
    off: int = 0              # cycle offset at which the register latches


@dataclasses.dataclass
class DpMemWrite(DpOp):
    mem: str
    idxs: list
    src: int
    off: int


@dataclasses.dataclass
class DpBlock:
    """One group's datapath as netlist operations."""
    group: str
    latency: int
    ops: List[DpOp]
    pooled_units: List[str]   # shared UnitInsts this block takes a grant on


# ---------------------------------------------------------------------------
# Controllers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FsmState:
    """One explicit controller state.

    ``kind``:
      * ``group`` — assert the group's go for ``cycles`` cycles.
      * ``delay`` — pure wait (loop setup/iterate, if-arm padding).
      * ``cond``  — evaluate ``cond`` over the index registers during
        ``cycles`` cycles, then branch to ``then_state``/``else_state``.
      * ``par``   — fork the child FSMs in ``children``, wait for all
        their dones, then wait ``join_cycles`` for the join reduction.
      * ``pipe``  — pipelined repeat (``CRepeat.ii > 0``): re-launch the
        body group every ``ii`` cycles, incrementing the loop index at
        each launch; the state lasts ``(extent-1)*ii + latency`` cycles
        (``cycles``) so the last iteration fully drains.  ``pipe`` holds
        ``(var, extent, ii, body_latency)``.
      * ``done``  — terminal; raises the FSM's done signal.

    Entry/exit actions: ``set_idx`` zeroes an index register at entry;
    ``inc_idx`` increments one at exit; ``loop`` is the repeat back-edge
    (index, extent, head-state) taken while ``index < extent``.
    """
    index: int
    kind: str
    cycles: int = 0
    label: str = ""
    group: Optional[str] = None
    next: Optional[int] = None
    set_idx: Optional[str] = None
    inc_idx: Optional[str] = None
    loop: Optional[Tuple[str, int, int]] = None
    cond: Optional[Cond] = None
    then_state: Optional[int] = None
    else_state: Optional[int] = None
    children: List[int] = dataclasses.field(default_factory=list)
    join_cycles: int = 0
    pipe: Optional[Tuple[str, int, int, int]] = None  # var, extent, ii, lat
    # observability metadata (core.trace provenance discipline) — stamped
    # at lowering time so the netlist simulator emits join-able events and
    # the Verilog emitter can synthesize the stall counters:
    prov: Tuple[str, ...] = ()
    # entry state of a serialized par-chain member p>0: (arm path, p);
    # the member waited behind its port-conflicting siblings
    stall_arm: Optional[Tuple[Tuple[str, ...], int]] = None
    # per-cycle port-stall weight: a chain member followed by w siblings
    # delays each of them one cycle per cycle it occupies — summing
    # w * residence over all states equals the serialization loss
    stall_weight: int = 0


@dataclasses.dataclass
class Fsm:
    fid: int
    name: str
    states: List[FsmState]
    start: int
    parent: Optional[int] = None       # forking controller (None = root)
    binds: Dict[str, int] = dataclasses.field(default_factory=dict)
    # loop vars this controller owns -> extent (sizes the index counter)


@dataclasses.dataclass
class PerfCounter:
    """One synthesized 64-bit hardware performance counter.

    Counters live in their own host-bus bank (:data:`PROFILE_HOST_BANK`)
    and are addressed by ``index`` over the existing handshake.  ``kind``:

      * ``total``         — cycles with busy high and done low
      * ``group``         — cycles the named ``group``'s go is high
      * ``stall_port``    — par arms' serialization behind port conflicts
      * ``stall_pool``    — shared-pool grant waits (0 by construction:
        binding keeps a pool inside one serialized chain; the counter
        exists so silicon can falsify that invariant)
      * ``stall_ii``      — pipelined loops' inter-launch wait cycles
      * ``fsm_overhead``  — control states (setup/iter/cond/pad/join)
    """
    index: int
    name: str
    kind: str
    group: Optional[str] = None


@dataclasses.dataclass
class Netlist:
    """Structural FSM + datapath netlist for one component."""
    name: str
    mems: Dict[str, MemSpec]
    banks: Dict[str, BankInst]
    regs: Dict[str, RegInst]
    index_regs: Dict[Tuple[int, str], IndexReg]   # (fid, var) -> counter
    units: Dict[str, UnitInst]
    muxes: List[OperandMux]
    blocks: Dict[str, DpBlock]
    fsms: List[Fsm]            # fsms[0] is the root controller
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)
    counters: List[PerfCounter] = dataclasses.field(default_factory=list)
    profile: bool = False      # synthesize the counter bank + host readout

    def stats(self) -> Dict[str, int]:
        """Netlist-size summary tracked by the benchmark across PRs."""
        return {
            "fsms": len(self.fsms),
            "fsm_states": sum(len(f.states) for f in self.fsms),
            "mux2": sum(m.mux2_count for m in self.muxes),
            "units": len(self.units),
            "banks": len(self.banks),
            "regs": len(self.regs),
            "index_regs": len(self.index_regs),
            "dp_ops": sum(len(b.ops) for b in self.blocks.values()),
        }

    def group_fids(self) -> Dict[str, int]:
        """group -> fid of the controller whose state enables it."""
        out: Dict[str, int] = {}
        for f in self.fsms:
            for st in f.states:
                if st.kind in ("group", "pipe"):
                    out[st.group] = f.fid
        return out

    def resolve_index(self, fid: int, var: str) -> IndexReg:
        """Resolve a loop variable from controller ``fid`` by walking the
        parent chain — the scope discipline both the RTL simulator and
        the Verilog emitter use for address/condition expressions."""
        cur: Optional[int] = fid
        while cur is not None:
            f = self.fsms[cur]
            if var in f.binds:
                return self.index_regs[(cur, var)]
            cur = f.parent
        raise KeyError(f"loop var {var!r} not bound on the controller "
                       f"chain of fsm{fid}")


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------

# patch targets: (state_index, field) pairs whose branch target is filled
# in once the continuation state exists
_Exit = Tuple[int, str]


class _FsmBuilder:
    """Compiles one control (sub)tree into one Fsm."""

    def __init__(self, lower: "_RtlLower", parent: Optional[int]):
        self.lower = lower
        self.fid = lower.alloc_fid()
        self.parent = parent
        self.binds: Dict[str, int] = {}
        self.states: List[FsmState] = []

    def add(self, kind: str, **kw) -> int:
        st = FsmState(index=len(self.states), kind=kind, **kw)
        self.states.append(st)
        return st.index

    def patch(self, exits: List[_Exit], target: int) -> None:
        for idx, field in exits:
            setattr(self.states[idx], field, target)

    # -- control-tree compilation -------------------------------------------
    def build(self, node: CNode,
              path: Tuple[str, ...] = ()) -> Tuple[Optional[int],
                                                   List[_Exit]]:
        """Compile ``node``; return (entry state or None-if-empty, exits).

        ``path`` is the node's control-tree provenance chain, stamped onto
        every created state (``FsmState.prov``) with exactly the labels
        the Calyx-level simulator builds at run time (``core.trace``) —
        the key discipline that makes the two simulators' traces join.
        A state's prov excludes its group leaf: group-level events append
        ``state.group`` themselves.
        """
        comp = self.lower.comp
        if isinstance(node, GEnable):
            g = comp.groups[node.group]
            s = self.add("group", cycles=g.latency, group=g.name,
                         label=g.name, prov=path)
            return s, [(s, "next")]
        if isinstance(node, CSeq):
            entry: Optional[int] = None
            exits: List[_Exit] = []
            for k, ch in enumerate(node.children):
                e, x = self.build(ch, path + (T.seq_label(k),))
                if e is None:
                    continue
                if entry is None:
                    entry = e
                else:
                    self.patch(exits, e)
                exits = x
            return entry, exits
        if isinstance(node, CRepeat):
            var = node.var or self.lower.fresh_counter()
            # the trace label keeps the *source* loop var (empty-var loops
            # share the generic label), never the fresh counter name — the
            # Calyx simulator has no access to lowering-time gensyms
            lpath = path + (T.loop_label(node.var),)
            self.binds[var] = max(self.binds.get(var, 0), node.extent)
            setup = self.add("delay", cycles=F.LOOP_SETUP_CYCLES,
                             label="setup", set_idx=var, prov=lpath)
            if node.extent <= 0:
                return setup, [(setup, "next")]
            if node.ii and not isinstance(node.body, GEnable):
                raise ValueError(
                    "pipelined repeat body must be a single group "
                    "(run chaining before pipelining)")
            if node.ii:
                # pipelined repeat: one state re-launches the body group
                # every ii cycles; residence covers the last drain
                g = comp.groups[node.body.group]
                total = (node.extent - 1) * node.ii + g.latency
                ps = self.add("pipe", cycles=total, group=g.name,
                              label=f"pipe ii={node.ii}", prov=lpath,
                              pipe=(var, node.extent, node.ii, g.latency))
                self.patch([(setup, "next")], ps)
                return setup, [(ps, "next")]
            body_e, body_x = self.build(node.body, lpath)
            it = self.add("delay", cycles=F.LOOP_ITER_OVERHEAD, label="iter",
                          inc_idx=var, prov=lpath)
            head = body_e if body_e is not None else it
            self.states[it].loop = (var, node.extent, head)
            self.patch([(setup, "next")], head)
            if body_e is not None:
                self.patch(body_x, it)
            return setup, [(it, "next")]
        if isinstance(node, CIf):
            worst = max(estimator.cycles(comp, node.then),
                        estimator.cycles(comp, node.els))
            ipath = path + (T.IF_LABEL,)
            cs = self.add("cond",
                          cycles=node.cond_latency + F.IF_SELECT_CYCLES,
                          label="cond", cond=node.cond, prov=ipath)
            exits: List[_Exit] = []
            for arm, field, albl in ((node.then, "then_state", T.THEN_LABEL),
                                     (node.els, "else_state", T.ELSE_LABEL)):
                apath = ipath + (albl,)
                pad = worst - estimator.cycles(comp, arm)
                a_entry, a_exits = self.build(arm, apath)
                if pad > 0:
                    p = self.add("delay", cycles=pad, label="pad",
                                 prov=apath)
                    if a_entry is None:
                        a_entry = p
                    else:
                        self.patch(a_exits, p)
                    a_exits = [(p, "next")]
                if a_entry is None:
                    exits.append((cs, field))      # empty zero-pad arm
                else:
                    setattr(self.states[cs], field, a_entry)
                    exits += a_exits
            return cs, exits
        if isinstance(node, CPar):
            arms = node.children
            if not arms:
                return None, []
            ppath = path + (T.PAR_LABEL,)
            comps = estimator.par_conflict_components(comp, node)
            children: List[int] = []
            for members in comps:
                chain = [(arms[i], ppath + (T.arm_label(i),))
                         for i in members]
                children.append(self.lower.child_fsm_chain(chain, self.fid))
            ps = self.add("par", label="par", children=children,
                          join_cycles=estimator.par_join_cycles(len(arms)),
                          prov=ppath)
            return ps, [(ps, "next")]
        raise TypeError(node)

    def build_chain(self, chain: List[Tuple[CNode, Tuple[str, ...]]]
                    ) -> Tuple[Optional[int], List[_Exit]]:
        """Compile one par conflict component: the member arms serialize
        back to back, each keeping its own arm provenance.

        Stall bookkeeping for the port-conflict serialization: member p's
        states carry ``stall_weight = members_after_p`` (each of its
        residence cycles delays that many siblings — summed over the run
        this equals the cumulative-wait loss), and the entry state of
        each delayed member records ``stall_arm = (arm_path, p)`` so the
        netlist simulator can emit the event the Calyx simulator emits.
        Nested controllers forked from inside a member are intentionally
        left unstamped: the member's own (weighted) par state stays
        resident while they run.
        """
        n = len(chain)
        entry: Optional[int] = None
        exits: List[_Exit] = []
        for p, (node, apath) in enumerate(chain):
            lo = len(self.states)
            e, x = self.build(node, apath)
            weight = n - 1 - p
            if weight > 0:
                for st in self.states[lo:]:
                    st.stall_weight = weight
            if e is None:
                continue
            if p > 0:
                self.states[e].stall_arm = (apath, p)
            if entry is None:
                entry = e
            else:
                self.patch(exits, e)
            exits = x
        return entry, exits

    def finish(self, node: CNode, path: Tuple[str, ...] = ()) -> Fsm:
        entry, exits = self.build(node, path)
        return self._seal(entry, exits)

    def finish_chain(self,
                     chain: List[Tuple[CNode, Tuple[str, ...]]]) -> Fsm:
        entry, exits = self.build_chain(chain)
        return self._seal(entry, exits)

    def _seal(self, entry: Optional[int], exits: List[_Exit]) -> Fsm:
        dn = self.add("done", label="done")
        if entry is None:
            entry = dn
        else:
            self.patch(exits, dn)
        return Fsm(fid=self.fid, name=f"fsm{self.fid}", states=self.states,
                   start=entry, parent=self.parent, binds=self.binds)


class _RtlLower:
    def __init__(self, comp: Component, prog: Program,
                 profile: bool = False):
        self.comp = comp
        self.prog = prog
        self.profile = profile
        self.fsms: List[Optional[Fsm]] = []
        self._counter = 0
        # pooled unit -> group -> grant slot (first-use order)
        self.grants: Dict[str, Dict[str, int]] = {}

    # -- FSM bookkeeping ----------------------------------------------------
    def alloc_fid(self) -> int:
        self.fsms.append(None)
        return len(self.fsms) - 1

    def child_fsm(self, node: CNode, parent: int,
                  path: Tuple[str, ...] = ()) -> int:
        builder = _FsmBuilder(self, parent)
        self.fsms[builder.fid] = builder.finish(node, path)
        return builder.fid

    def child_fsm_chain(self, chain: List[Tuple[CNode, Tuple[str, ...]]],
                        parent: int) -> int:
        builder = _FsmBuilder(self, parent)
        self.fsms[builder.fid] = builder.finish_chain(chain)
        return builder.fid

    def fresh_counter(self) -> str:
        self._counter += 1
        return f"_rpt{self._counter}"

    # -- datapath ------------------------------------------------------------
    def grant_slot(self, unit: str, group: str) -> int:
        slots = self.grants.setdefault(unit, {})
        return slots.setdefault(group, len(slots))

    def lower_block(self, gname: str) -> DpBlock:
        g = self.comp.groups[gname]
        ops: List[DpOp] = []
        pooled: List[str] = []
        for u in g.uops:
            if isinstance(u, D.UConst):
                ops.append(DpConst(u.dst, u.value))
            elif isinstance(u, D.URegRead):
                ops.append(DpRegRead(u.dst, u.reg))
            elif isinstance(u, D.UMemRead):
                ops.append(DpMemRead(u.dst, u.mem, list(u.idxs), u.off))
            elif isinstance(u, D.UAlu):
                cell = self.comp.cells.get(u.cell)
                grant = -1
                if cell is not None and cell.users > 1:
                    grant = self.grant_slot(u.cell, gname)
                    if u.cell not in pooled:
                        pooled.append(u.cell)
                ops.append(DpUnit(u.dst, u.cell, u.op, u.a, u.b, grant,
                                  u.off))
            elif isinstance(u, D.USelect):
                ops.append(DpSelect(u.dst, u.cond, u.a, u.b, u.off))
            elif isinstance(u, D.URegWrite):
                ops.append(DpRegWrite(u.reg, u.src, u.off))
            elif isinstance(u, D.UMemWrite):
                ops.append(DpMemWrite(u.mem, list(u.idxs), u.src, u.off))
            else:
                raise TypeError(u)
        return DpBlock(gname, g.latency, ops, pooled)

    # -- top-level -----------------------------------------------------------
    def run(self) -> Netlist:
        # memories -> banks
        mems: Dict[str, MemSpec] = {}
        banks: Dict[str, BankInst] = {}
        orig_shapes = self.prog.meta.get("orig_shapes", {})
        for name, decl in self.prog.mems.items():
            if decl.banks:
                nbanks = decl.shape[0]
                intra = tuple(decl.shape[1:])
                bank_names = [f"mem_{name}_b{b}" for b in range(nbanks)]
            else:
                intra = tuple(decl.shape)
                bank_names = [f"mem_{name}"]
            spec = MemSpec(name, tuple(decl.shape), tuple(decl.banks),
                           decl.role, tuple(orig_shapes.get(name, ())) or None,
                           bank_names, intra)
            mems[name] = spec
            for b, bn in enumerate(bank_names):
                banks[bn] = BankInst(bn, name, b, spec.words)

        # cells -> registers and datapath units
        regs: Dict[str, RegInst] = {}
        units: Dict[str, UnitInst] = {}
        for cell in self.comp.cells.values():
            if cell.kind == "mem_bank":
                continue                      # already built from the decls
            if cell.kind == "reg32":
                key = cell.name[len("reg_"):] if \
                    cell.name.startswith("reg_") else cell.name
                regs[key] = RegInst(cell.name, key)
            elif cell.kind == "idx_reg":
                continue                      # controller-owned (note_index)
            else:
                units[cell.name] = UnitInst(
                    cell.name, cell.kind,
                    unit_latency(cell.kind, cell.const),
                    cell.const, cell.users)

        # datapath blocks (also populates the grant tables)
        blocks = {g: self.lower_block(g) for g in self.comp.groups}

        # controllers: the root builder allocates fid 0 before any par
        # state forks a child, so fsms[0] is the root by construction
        root_builder = _FsmBuilder(self, None)
        self.fsms[root_builder.fid] = root_builder.finish(self.comp.control)

        # per-controller index counters; signal names carry the fsm suffix
        # only when the same loop var is bound by more than one controller
        index_regs: Dict[Tuple[int, str], IndexReg] = {}
        var_owners: Dict[str, int] = {}
        for f in self.fsms:
            for var in f.binds:
                var_owners[var] = var_owners.get(var, 0) + 1
        for f in self.fsms:
            for var, extent in f.binds.items():
                name = f"idx_{var}" if var_owners[var] == 1 \
                    else f"idx_{var}_f{f.fid}"
                index_regs[(f.fid, var)] = IndexReg(name, var, extent, f.fid)

        muxes: List[OperandMux] = []
        for uname, unit in units.items():
            if unit.users > 1:
                for op_i in range(UNIT_OPERANDS.get(unit.kind, 2)):
                    muxes.append(OperandMux(uname, op_i, unit.users))

        meta = dict(self.comp.meta)
        meta["component"] = self.comp.name
        counters: List[PerfCounter] = []
        if self.profile:
            counters = perf_counter_bank(blocks)
        return Netlist(self.comp.name, mems, banks, regs, index_regs,
                       units, muxes, blocks,
                       [f for f in self.fsms if f is not None], meta,
                       counters, self.profile)


def perf_counter_bank(blocks: Dict[str, DpBlock]) -> List[PerfCounter]:
    """The canonical counter layout for a profiled netlist: index 0 is
    the total-cycle counter, then one per group in block order, then the
    four stall/overhead counters.  The layout is a function of the group
    set alone so hosts can derive the address map from the design."""
    counters = [PerfCounter(0, "perf_total", "total")]
    for g in blocks:
        counters.append(PerfCounter(len(counters), f"perf_g_{g}", "group",
                                    group=g))
    for kind in ("stall_port", "stall_pool", "stall_ii", "fsm_overhead"):
        counters.append(PerfCounter(len(counters), f"perf_{kind}", kind))
    return counters


def lower_component(comp: Component, prog: Program,
                    profile: bool = False) -> Netlist:
    """Lower a Calyx component (plus its program's memory declarations)
    to the structural FSM + datapath netlist.  ``profile=True`` also
    synthesizes the hardware perf-counter bank (read over the host bus
    at bank :data:`PROFILE_HOST_BANK`); the observability metadata on
    the FSM states (provenance, stall weights) is stamped either way —
    only the counter hardware is gated.
    """
    for g in comp.groups.values():
        if not g.uops:
            raise ValueError(
                f"[RV007] group {g.name} carries no micro-ops — re-lower "
                f"with calyx.lower_program before the RTL backend")
    return _RtlLower(comp, prog, profile).run()
