"""Calyx-like structural hardware IR and the Affine -> Calyx lowering.

Mirrors Calyx's split between *structure* (cells: registers, single-ported
memories, HardFloat units, address arithmetic) and *control* (seq / par /
if / repeat trees over group enables).  The lowering itself instantiates a
fresh cell per static operation — the paper's choice, and what makes
par-unrolled designs grow superlinearly; the downstream binding stage
(``sharing.share_cells``) then rebinds expensive units used by mutually
exclusive groups onto shared pools, so the emitted design pays for peak
concurrency rather than statement count.  ``Cell.users`` records how many
group-level uses a pooled cell serves (1 = private), which the estimator
turns into operand-mux overhead.

The lowering records, per group, the memory *port accesses* it performs;
the estimator uses those to model Calyx's one-access-per-cycle memory
constraint (conflicting parallel arms serialize — the behaviour that makes
unbanked parallelism worthless and banked parallelism near-linear).

Beyond the latency/cells/ports summary, every group now also carries its
executable datapath semantics as a micro-op list (``Group.uops``, see
``core.dataflow``): cell invocations with explicit operand routing,
register reads/writes, and memory accesses with concrete address
expressions and their in-group cycle offsets.  ``CIf`` keeps the lowered
affine condition.  Together these make the component *runnable* — the
cycle-accurate simulator (``core.sim``) executes exactly what was lowered
instead of re-interpreting the affine program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import dataflow as D
from . import float_lib as F
from .affine import (AExpr, Bin, Cond, ConstF, DivAtom, If, Load, Loop,
                     MemDecl, ModAtom, Par, Program, ReadReg, SelectC, SetReg,
                     Stmt, Store, Un, VExpr)

# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    kind: str                 # fp_add, fp_mul, ..., int_mul, int_divmod,
    words: int = 0            # mem_bank: capacity
    const: int = 0            # int_mul / int_divmod constant operand
    users: int = 1            # group-level uses bound to this cell (sharing)


@dataclasses.dataclass
class PortAccess:
    mem: str
    bank: Optional[int]       # None = runtime-selected bank
    key: Optional[tuple]      # structural address key; None = never shareable
    free_vars: frozenset      # loop vars the address depends on
    is_store: bool
    # Symbolic bank index for runtime-selected banks (layout mode where the
    # cyclic fold did not reach a constant).  The conflict model proves two
    # such accesses land on distinct physical banks when the per-digit
    # difference is a nonzero constant modulo the banking factor — the
    # "bank-affine" par analysis.  None when the bank is constant or the
    # expression depends on loop vars bound inside the subtree under test.
    bank_expr: Optional[AExpr] = None


@dataclasses.dataclass
class Group:
    name: str
    latency: int
    cells: List[str]
    ports: List[PortAccess]
    uops: List[D.UOp] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# Control
# ---------------------------------------------------------------------------


class CNode:
    pass


@dataclasses.dataclass
class GEnable(CNode):
    group: str


@dataclasses.dataclass
class CSeq(CNode):
    children: List[CNode]


@dataclasses.dataclass
class CPar(CNode):
    children: List[CNode]


@dataclasses.dataclass
class CRepeat(CNode):
    extent: int
    body: CNode
    var: str = ""
    # Initiation interval set by the pipelining pass (core.pipelining).
    # 0 = not pipelined (iterations run back to back with the per-iteration
    # overhead); ii > 0 = a new iteration launches every ``ii`` cycles and
    # iterations overlap:  cycles = setup + (extent-1)*ii + body_latency.
    # The estimator, the Calyx simulator, the RTL lowering, and the RTL
    # simulator all price/execute exactly this overlapped schedule.
    ii: int = 0


@dataclasses.dataclass
class CIf(CNode):
    cond_latency: int
    then: CNode
    els: CNode
    cond_cells: List[str] = dataclasses.field(default_factory=list)
    cond: Optional[Cond] = None   # lowered affine condition (simulation)


@dataclasses.dataclass
class Component:
    name: str
    cells: Dict[str, Cell]
    groups: Dict[str, Group]
    control: CNode
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------


class _Lower:
    def __init__(self, prog: Program):
        self.prog = prog
        self.cells: Dict[str, Cell] = {}
        self.groups: Dict[str, Group] = {}
        self._n = 0
        self._tmp = 0            # per-group micro-op temporary counter

    def fresh(self, stem: str) -> str:
        self._n += 1
        return f"{stem}{self._n}"

    def tmp(self) -> int:
        t = self._tmp
        self._tmp += 1
        return t

    def add_cell(self, kind: str, words: int = 0, const: int = 0,
                 name: Optional[str] = None) -> str:
        name = name or self.fresh(kind)
        if name not in self.cells:
            self.cells[name] = Cell(name, kind, words, const)
        return name

    # -- address arithmetic ---------------------------------------------------
    def addr_cells_cycles(self, e: AExpr, cells: List[str]) -> int:
        """Instantiate const-mul / divmod units for one index expression.
        Returns extra cycles (iterative divmod only)."""
        cycles = 0
        nterms = len(e.coeffs)
        for atom, coeff in e.coeffs.items():
            mc = F.int_mul_cost(coeff)
            if mc.lut or mc.dsp:
                cells.append(self.add_cell("int_mul", const=coeff))
            if isinstance(atom, (DivAtom, ModAtom)):
                dc = F.int_divmod_cost(atom.c)
                if dc.cycles or dc.lut:
                    cells.append(self.add_cell("int_divmod", const=atom.c))
                    cycles += dc.cycles
                cycles += self.addr_cells_cycles(atom.inner, cells)
        if nterms > 1:
            for _ in range(nterms - 1):
                cells.append(self.add_cell("int_add"))
        return cycles

    # -- value expressions -----------------------------------------------------
    def vexpr(self, e: VExpr, cells: List[str], ports: List[PortAccess],
              uops: List[D.UOp], off: int) -> Tuple[int, int]:
        """Instantiate cells and record micro-ops; return (latency, temp).

        ``off`` is the cycle offset (within the enclosing group's window)
        at which this expression starts evaluating — memory micro-ops are
        stamped with the offset their port is actually busy, mirroring the
        latency arithmetic below.
        """
        if isinstance(e, ConstF):
            t = self.tmp()
            uops.append(D.UConst(t, e.value))
            return 0, t
        if isinstance(e, ReadReg):
            self.add_cell("reg32", name=f"reg_{e.name}")
            cells.append(f"reg_{e.name}")
            t = self.tmp()
            uops.append(D.URegRead(t, e.name))
            return 0, t
        if isinstance(e, Load):
            addr_cyc = self._access(e.mem, e.idxs, False, cells, ports)
            t = self.tmp()
            uops.append(D.UMemRead(t, e.mem, list(e.idxs), off + addr_cyc))
            return F.MEM_READ_CYCLES + addr_cyc, t
        if isinstance(e, Bin):
            kind = {"add": "fp_add", "sub": "fp_sub", "mul": "fp_mul",
                    "div": "fp_div", "max": "fp_max", "min": "fp_min"}[e.op]
            cname = self.add_cell(kind)
            cells.append(cname)
            a, ta = self.vexpr(e.a, cells, ports, uops, off)
            b, tb = self.vexpr(e.b, cells, ports, uops, off)
            t = self.tmp()
            uops.append(D.UAlu(t, e.op, ta, tb, cell=cname,
                               off=off + max(a, b)))
            return F.FLOAT_COSTS[kind].cycles + max(a, b), t
        if isinstance(e, Un):
            kind = {"exp": "fp_exp", "relu": "fp_relu", "neg": "fp_neg"}[e.op]
            cname = self.add_cell(kind)
            cells.append(cname)
            a, ta = self.vexpr(e.a, cells, ports, uops, off)
            t = self.tmp()
            uops.append(D.UAlu(t, e.op, ta, None, cell=cname, off=off + a))
            return F.FLOAT_COSTS[kind].cycles + a, t
        if isinstance(e, SelectC):
            cells.append(self.add_cell("mux"))
            cells.append(self.add_cell("cmp"))
            cond_cyc = self.addr_cells_cycles(e.cond.expr, cells)
            a, ta = self.vexpr(e.a, cells, ports, uops, off)
            b, tb = self.vexpr(e.b, cells, ports, uops, off)
            t = self.tmp()
            uops.append(D.USelect(t, e.cond, ta, tb,
                                  off=off + cond_cyc + max(a, b)))
            return F.IF_SELECT_CYCLES + cond_cyc + max(a, b), t
        raise TypeError(e)

    def _access(self, mem: str, idxs: Sequence[AExpr], is_store: bool,
                cells: List[str], ports: List[PortAccess]) -> int:
        decl = self.prog.mems[mem]
        cyc = 0
        for ix in idxs:
            cyc += self.addr_cells_cycles(ix, cells)
        if decl.banks:
            bank_e = idxs[0]
            bank = bank_e.const_value() if bank_e.is_const() else None
            key_exprs = idxs[1:]
        else:
            bank = 0
            key_exprs = idxs
        free = set()
        for ke in key_exprs:
            free |= ke.free_vars()
        bank_expr = None
        if decl.banks and not idxs[0].is_const():
            # runtime-selected bank: keep the intra-bank address key *and*
            # the symbolic bank expression so the conflict model can still
            # prove distinct-bank / same-bank facts (bank-affine par)
            bank_expr = idxs[0]
            free |= idxs[0].free_vars()
        key = tuple(ke.key() for ke in key_exprs)
        ports.append(PortAccess(mem, bank, key, frozenset(free), is_store,
                                bank_expr=bank_expr))
        return cyc

    # -- statements -------------------------------------------------------------
    def stmt(self, s: Stmt) -> CNode:
        if isinstance(s, Store):
            cells: List[str] = []
            ports: List[PortAccess] = []
            uops: List[D.UOp] = []
            self._tmp = 0
            lat, t = self.vexpr(s.value, cells, ports, uops, 0)
            waddr = self._access(s.mem, s.idxs, True, cells, ports)
            uops.append(D.UMemWrite(s.mem, list(s.idxs), t, off=lat + waddr))
            lat += waddr + F.MEM_WRITE_CYCLES
            g = self.fresh("st_")
            self.groups[g] = Group(g, lat, cells, ports, uops)
            return GEnable(g)
        if isinstance(s, SetReg):
            cells = []
            ports = []
            uops = []
            self._tmp = 0
            self.add_cell("reg32", name=f"reg_{s.name}")
            cells.append(f"reg_{s.name}")
            vlat, t = self.vexpr(s.value, cells, ports, uops, 0)
            uops.append(D.URegWrite(s.name, t, off=vlat))
            lat = max(1, vlat)
            g = self.fresh("sr_")
            self.groups[g] = Group(g, lat, cells, ports, uops)
            return GEnable(g)
        if isinstance(s, Loop):
            self.add_cell("idx_reg", name=f"idx_{s.var}")
            body = self.block(s.body)
            return CRepeat(s.extent, body, var=s.var)
        if isinstance(s, Par):
            return CPar([self.block(a) for a in s.arms])
        if isinstance(s, If):
            cells = []
            cond_cyc = self.addr_cells_cycles(s.cond.expr, cells)
            cells.append(self.add_cell("cmp"))
            return CIf(cond_cyc, self.block(s.then),
                       self.block(s.els), cond_cells=cells, cond=s.cond)
        raise TypeError(s)

    def block(self, stmts: List[Stmt]) -> CNode:
        nodes = [self.stmt(s) for s in stmts]
        if len(nodes) == 1:
            return nodes[0]
        return CSeq(nodes)

    def run(self) -> Component:
        # memory banks as cells
        for name, decl in self.prog.mems.items():
            if decl.banks:
                nbanks = decl.shape[0]
                words = 1
                for s in decl.shape[1:]:
                    words *= s
                for b in range(nbanks):
                    self.add_cell("mem_bank", words=words,
                                  name=f"mem_{name}_b{b}")
            else:
                self.add_cell("mem_bank", words=decl.size, name=f"mem_{name}")
        control = self.block(self.prog.body)
        meta = dict(self.prog.meta)
        # banking factors per logical memory — the conflict model and the
        # scheduling passes consult these for bank-affinity proofs
        meta["bank_factors"] = {name: tuple(decl.banks)
                                for name, decl in self.prog.mems.items()}
        comp = Component(self.prog.name, self.cells, self.groups, control,
                         meta=meta)
        return comp


def lower_program(prog: Program) -> Component:
    return _Lower(prog).run()


def referenced_groups(node: CNode) -> Set[str]:
    """Names of every group reachable from ``node`` — the liveness set the
    chaining pass filters to and the verifier's dead-group analysis uses."""
    out: Set[str] = set()

    def walk(n: CNode) -> None:
        if isinstance(n, GEnable):
            out.add(n.group)
        elif isinstance(n, (CSeq, CPar)):
            for ch in n.children:
                walk(ch)
        elif isinstance(n, CRepeat):
            walk(n.body)
        elif isinstance(n, CIf):
            walk(n.then)
            walk(n.els)

    walk(node)
    return out


# ---------------------------------------------------------------------------
# Text emission (futil-like) for debuggability
# ---------------------------------------------------------------------------


def emit_text(comp: Component) -> str:
    out: List[str] = [f"component {comp.name}() -> () {{", "  cells {"]
    for c in comp.cells.values():
        extra = f", words={c.words}" if c.kind == "mem_bank" else (
            f", const={c.const}" if c.const else "")
        shared = f"  // shared x{c.users}" if c.users > 1 else ""
        out.append(f"    {c.name} = {c.kind}(){extra};{shared}")
    out.append("  }")
    out.append("  groups {")
    for g in comp.groups.values():
        ports = " ".join(
            f"{'W' if p.is_store else 'R'}:{p.mem}[b={p.bank}]" for p in g.ports)
        bound = [c for c in g.cells
                 if c in comp.cells and comp.cells[c].users > 1]
        uses = f" uses {', '.join(bound)}" if bound else ""
        out.append(f"    group {g.name}<{g.latency}>{uses} {{ {ports} }}")
    out.append("  }")
    out.append("  control {")

    def emit(node: CNode, ind: int):
        pad = "  " * ind
        if isinstance(node, GEnable):
            out.append(f"{pad}{node.group};")
        elif isinstance(node, CSeq):
            out.append(f"{pad}seq {{")
            for ch in node.children:
                emit(ch, ind + 1)
            out.append(f"{pad}}}")
        elif isinstance(node, CPar):
            out.append(f"{pad}par {{")
            for ch in node.children:
                emit(ch, ind + 1)
            out.append(f"{pad}}}")
        elif isinstance(node, CRepeat):
            pipe = f" pipeline ii={node.ii}" if node.ii else ""
            out.append(f"{pad}repeat {node.extent}{pipe} "
                       f"/* {node.var} */ {{")
            emit(node.body, ind + 1)
            out.append(f"{pad}}}")
        elif isinstance(node, CIf):
            cond_cells = (f" with [{', '.join(node.cond_cells)}]"
                          if node.cond_cells else "")
            out.append(f"{pad}if <cond:{node.cond_latency}>{cond_cells} {{")
            emit(node.then, ind + 1)
            out.append(f"{pad}}} else {{")
            emit(node.els, ind + 1)
            out.append(f"{pad}}}")

    emit(comp.control, 2)
    out.append("  }")
    out.append("}")
    return "\n".join(out)
