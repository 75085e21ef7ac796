"""Stage-boundary static verifier for the Calyx path.

The compile pipeline used to enforce its invariants *dynamically*: an
unsound initiation interval or a bank-port conflict surfaced as a runtime
raise deep inside ``core.sim``/``core.rtl_sim``, and the only static check
was the text-level ``verilog.lint``.  This module re-proves those
properties *statically* on every lowered artifact, at every stage boundary
of ``pipeline.compile_graph`` (post-lower, post-chaining, post-pipelining,
post-sharing, post-RTL), reporting structured :class:`~.diagnostics.
Diagnostic` findings with stable ``RV0xx`` codes and provenance chains
(control path -> group -> micro-op, or fsm -> state / block -> wire).

Check families (see ``diagnostics.CODES`` for the full table):

* **IR well-formedness** — dangling cell/group references, groups never
  reached from the control tree, ``CIf``/``CRepeat`` structural
  invariants, groups without micro-ops, unknown memories, loop variables
  used outside any binding ``repeat``.

* **Micro-op dataflow** — SSA temp discipline (use-before-def,
  redefinition), register def-use over the control tree (a read on some
  path with no prior write on that path), dead register writes, and
  write-write races (same register latched twice in one cycle).

* **Static hardware-discipline proofs** — the properties the simulators
  enforce per-cycle, proven over the stamped schedules instead: one
  access per cycle on every single-ported bank (within a group's
  activation window, under the same bank-affine proof the estimator's
  ``par`` conflict model uses), single-owner arbitration of shared pools
  across ``par`` arms, and modulo-II reservation soundness of every
  pipelined loop (recomputed from the body's offsets, not trusted from
  the annotation).

* **Netlist structure** — multi-driven wires and registers (including
  registers written from two provably-concurrent controllers),
  combinational loops in a block's dataflow order, unreachable FSM
  states, dangling FSM transitions, and loop-variable resolution along
  the controller parent chain.

The liveness side of the analysis is load-bearing, not advisory:
:func:`eliminate_dead` consumes exactly the unreachable-group/unused-cell
findings (``RV004``/``RV002``) to strip dead structure, and is provably
cycle-neutral — it never touches the control tree or any live group, and
``estimator.cycles`` only consults groups reachable from control.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from . import dataflow as D
from . import estimator, pipelining
from .affine import Program
from .calyx import (CIf, CNode, CPar, CRepeat, CSeq, Component, GEnable,
                    Group, PortAccess, referenced_groups)
from .diagnostics import DiagnosticReport, diag, timed_report
from .rtl import (DpBlock, DpMemRead, DpMemWrite, DpRegRead, DpRegWrite,
                  DpSelect, DpUnit, Netlist)

_EMPTY_SET: frozenset = frozenset()


class GroupCache:
    """Identity-keyed per-group summaries reused across stage boundaries.

    Successive boundaries of one compile mostly re-see the same
    :class:`Group` objects — chaining keeps unfused groups, pipelining
    rewrites only control nodes, and sharing rebuilds only groups that
    drive a pool — so their uop-level summaries (referenced cells, free
    loop vars, register reads/writes) and a clean :func:`_check_group`
    verdict carry over verbatim.  Entries hold a strong reference to
    the group, so a recycled ``id()`` can never produce a false hit.
    Scope a cache to ONE ``compile_graph`` run: summaries are
    environment-independent, but the clean verdict bakes in that run's
    program/banking context.
    """

    def __init__(self) -> None:
        self._entries: Dict[int, list] = {}
        # (component, live groups, used cells) of the last verified
        # boundary — lets eliminate_dead reuse the liveness the verifier
        # just computed instead of re-walking the same component
        self.liveness: Optional[tuple] = None
        # carry-over state of the last CLEAN boundary's control-tree
        # analyses: (control, summaries, live, pipe_nodes, cond_cells,
        # bound_vars, used, cells).  A later boundary whose control tree
        # is the same object and whose summaries' control-relevant
        # components are the same objects (pass-through groups, or
        # sharing's verified rebind) re-proves only the cell-table-
        # dependent checks.  Never stored after a dirty boundary, so
        # findings are always re-derived where they fired.
        self.flow_state: Optional[tuple] = None

    def _entry(self, g: Group) -> list:
        e = self._entries.get(id(g))
        if e is None or e[0] is not g:
            # group, summary, clean-refs, clean pipelined-IIs
            e = [g, None, None, set()]
            self._entries[id(g)] = e
        return e

    def summary(self, g: Group) -> tuple:
        """(used_cells, free_vars, first_uncovered_read, writes, reads)
        for one group, computed on first sight and reused afterwards.
        The sets are plain (not frozen) to keep the per-group cost at
        the allocation floor; consumers treat them as read-only."""
        e = self._entries.get(id(g))
        if e is not None and e[0] is g:
            s = e[1]
            if s is not None:
                return s
        e = self._entry(g)
        if e[1] is None:
            used: Set[str] = set(g.cells)
            free: Set[str] = set()
            first_read: Dict[str, int] = {}
            writes: Set[str] = set()
            reads: Set[str] = set()
            for i, u in enumerate(g.uops):
                if isinstance(u, D.UAlu):
                    if u.cell:
                        used.add(u.cell)
                elif isinstance(u, D.URegRead):
                    used.add(f"reg_{u.reg}")
                    reads.add(u.reg)
                    if u.reg not in writes and u.reg not in first_read:
                        first_read[u.reg] = i
                elif isinstance(u, D.URegWrite):
                    used.add(f"reg_{u.reg}")
                    writes.add(u.reg)
                elif isinstance(u, (D.UMemRead, D.UMemWrite)):
                    for ix in u.idxs:
                        free |= ix.free_vars()
                elif isinstance(u, D.USelect):
                    free |= u.cond.expr.free_vars()
            e[1] = (used, free, first_read, writes, reads)
        return e[1]

    def clean_refs(self, g: Group) -> Optional[tuple]:
        """The (cell_refs, alu_refs) a previously-clean group must still
        resolve against the current cell table, or None if unchecked."""
        return self._entry(g)[2]

    def mark_clean(self, g: Group, refs: tuple) -> None:
        self._entry(g)[2] = refs

    def pipe_clean(self, g: Group, ii: int) -> bool:
        """Whether this group body already passed the modulo-II re-proof
        at this initiation interval."""
        return ii in self._entry(g)[3]

    def mark_pipe_clean(self, g: Group, ii: int) -> None:
        self._entry(g)[3].add(ii)

    def transfer_rebound(self, old_groups: Dict[str, Group],
                         new_groups: Dict[str, Group],
                         bound: Dict[str, str]) -> None:
        """Carry summaries and clean verdicts across the sharing rebind.

        ``share_cells`` rebuilds exactly the groups that drive a pool,
        changing nothing but cell bindings (``Group.cells`` entries and
        ``UAlu.cell``, both through ``bound``).  This *verifies* that
        claim micro-op by micro-op — identical objects for non-ALU uops,
        field-equal-modulo-``bound`` for ALU uops — and only then
        transfers the old group's summary (with its used-cell set
        rebound) and clean verdict (with its ALU refs rebound; the
        post-sharing boundary still re-resolves them against the pooled
        cell table).  A group that fails the equivalence check simply
        stays uncached and pays the full re-check — never unsound, just
        slower.  Pipelined-II verdicts do not transfer: pooling changes
        the unit population the modulo reservation argues about."""
        for name, ng in new_groups.items():
            og = old_groups.get(name)
            if og is None or ng is og:
                continue
            e_old = self._entries.get(id(og))
            if e_old is None or e_old[0] is not og:
                continue
            s, refs = e_old[1], e_old[2]
            if s is None and refs is None:
                continue
            if (len(ng.uops) != len(og.uops)
                    or len(ng.cells) != len(og.cells)
                    or any(nc != bound.get(oc, oc)
                           for nc, oc in zip(ng.cells, og.cells))):
                continue
            ok = True
            for nu, ou in zip(ng.uops, og.uops):
                if nu is ou:
                    continue
                if not (type(nu) is D.UAlu and type(ou) is D.UAlu
                        and nu.cell == bound.get(ou.cell, ou.cell)
                        and nu.dst == ou.dst and nu.op == ou.op
                        and nu.a == ou.a and nu.b == ou.b
                        and nu.off == ou.off):
                    ok = False
                    break
            if not ok:
                continue
            e = self._entry(ng)
            if s is not None and e[1] is None:
                e[1] = ({bound.get(c, c) for c in s[0]},
                        s[1], s[2], s[3], s[4])
            if refs is not None and e[2] is None:
                alu_s = {bound.get(c, c) for c in refs[1]}
                union_s = set(ng.cells)
                union_s.update(alu_s)
                e[2] = (ng.cells, alu_s, union_s)


# ---------------------------------------------------------------------------
# Control-tree walking with provenance paths
# ---------------------------------------------------------------------------


def _walk(node: CNode, path: Tuple[str, ...]):
    """Yield every control node with its provenance path, depth-first in
    document order.  Iterative: nested ``yield from`` chains would make
    deep control trees quadratic in yield count."""
    stack = [(node, path)]
    while stack:
        node, path = stack.pop()
        yield node, path
        if isinstance(node, (CSeq, CPar)):
            tag = "seq" if isinstance(node, CSeq) else "par"
            for i in range(len(node.children) - 1, -1, -1):
                stack.append((node.children[i], path + (f"{tag}[{i}]",)))
        elif isinstance(node, CRepeat):
            stack.append((node.body,
                          path + (f"repeat({node.var or '_'})",)))
        elif isinstance(node, CIf):
            stack.append((node.els, path + ("if.else",)))
            stack.append((node.then, path + ("if.then",)))


def _walk_nodes(node: CNode):
    """Yield every control node depth-first in document order, without
    materializing provenance paths — the clean-path walker.  Checks that
    need a path for a finding collect the offending nodes and rebuild
    their paths afterwards with one :func:`_walk` (findings are rare;
    per-node path tuples on every boundary of every compile are not)."""
    stack = [node]
    while stack:
        node = stack.pop()
        yield node
        t = type(node)
        if t is CSeq or t is CPar:
            stack.extend(reversed(node.children))
        elif t is CRepeat:
            stack.append(node.body)
        elif t is CIf:
            stack.append(node.els)
            stack.append(node.then)


def _paths_of(control: CNode, nodes) -> Dict[int, Tuple[str, ...]]:
    """id(node) -> provenance path of its first occurrence, for exactly
    the nodes a deferred finding needs."""
    want = {id(n) for n in nodes}
    out: Dict[int, Tuple[str, ...]] = {}
    for node, path in _walk(control, ()):
        i = id(node)
        if i in want and i not in out:
            out[i] = path
            if len(out) == len(want):
                break
    return out


def _groups_under(node: CNode) -> Set[str]:
    return referenced_groups(node)


# ---------------------------------------------------------------------------
# Liveness: reachable groups and the cells they keep alive
# ---------------------------------------------------------------------------


def _cond_cells(control: CNode) -> Set[str]:
    out: Set[str] = set()
    for node, _ in _walk(control, ()):
        if isinstance(node, CIf):
            out.update(node.cond_cells)
    return out


def _bound_vars(control: CNode) -> Set[str]:
    out: Set[str] = set()
    for node, _ in _walk(control, ()):
        if isinstance(node, CRepeat) and node.var:
            out.add(node.var)
    return out


def _used_cells(comp: Component, live: Set[str],
                summaries: Dict[str, tuple],
                cond_cells: Optional[Set[str]] = None,
                bound_vars: Optional[Set[str]] = None) -> Set[str]:
    """Cells a live design actually needs: everything referenced from a
    reachable group (cell lists, FU invocations, registers), if-condition
    hardware, index counters of bound loop vars, and every memory bank
    (part of the host interface regardless of reachability).  Callers
    that already walked the control tree pass the condition cells and
    bound loop vars they collected; others pay for the two walks here."""
    used: Set[str] = set()
    for name in live:
        s = summaries.get(name)
        if s is None:
            continue
        used |= s[0]
    used |= (_cond_cells(comp.control) if cond_cells is None
             else cond_cells)
    for var in (_bound_vars(comp.control) if bound_vars is None
                else bound_vars):
        used.add(f"idx_{var}")
    for cell in comp.cells.values():
        if cell.kind == "mem_bank":
            used.add(cell.name)
    return used


# ---------------------------------------------------------------------------
# IR well-formedness (RV00x)
# ---------------------------------------------------------------------------


def _check_structure(comp: Component, rep: DiagnosticReport,
                     summaries: Dict[str, tuple]) -> tuple:
    """Control-tree invariants; returns ``(live, pipe_nodes, used,
    cond_cells, bound_vars)`` — the reachable group set, every pipelined
    ``repeat`` node (for :func:`_check_pipelined`, which then needs no
    walk of its own), the used-cell set (for :func:`eliminate_dead` to
    reuse), and the walk's condition-cell / bound-loop-var collections
    (for the carry-over skip at a later boundary).  One path-free walk collects
    everything the liveness computation needs (reached groups, condition
    cells, bound loop vars) alongside the checks; provenance paths are
    rebuilt only for the nodes findings actually landed on."""
    live: Set[str] = set()
    cond_cells: Set[str] = set()
    bound: Set[str] = set()
    pipe_nodes: List[CRepeat] = []
    deferred: List[tuple] = []      # (code, message, node, path suffix)
    for node in _walk_nodes(comp.control):
        t = type(node)
        if t is GEnable:
            if node.group not in comp.groups:
                deferred.append(("RV003",
                                 f"control enables undefined group "
                                 f"{node.group!r}", node, ()))
            else:
                live.add(node.group)
        elif t is CIf:
            if node.cond is None:
                deferred.append(("RV005",
                                 "if-node carries no lowered condition",
                                 node, ()))
            cond_cells.update(node.cond_cells)
            for c in node.cond_cells:
                if c not in comp.cells:
                    deferred.append(("RV001",
                                     f"if condition references undefined "
                                     f"cell {c!r}", node, (f"cell:{c}",)))
        elif t is CRepeat:
            if node.var:
                bound.add(node.var)
            if node.extent < 0 or node.ii < 0:
                deferred.append(("RV006",
                                 f"repeat has negative extent/ii "
                                 f"({node.extent}/{node.ii})", node, ()))
            elif node.ii > 0 and not isinstance(node.body, GEnable):
                deferred.append(("RV006",
                                 f"pipelined repeat (ii={node.ii}) body "
                                 f"must be a single group", node, ()))
            if node.ii > 0 and isinstance(node.body, GEnable):
                pipe_nodes.append(node)
    if deferred:
        paths = _paths_of(comp.control, [n for _, _, n, _ in deferred])
        for code, msg, node, suffix in deferred:
            rep.add(diag(code, msg,
                         provenance=paths.get(id(node), ()) + suffix))
    for name in comp.groups:
        if name not in live:
            rep.add(diag("RV004",
                         f"group {name!r} is never enabled from the "
                         f"control tree", provenance=(f"group:{name}",)))
    used = _used_cells(comp, live, summaries, cond_cells, bound)
    for name, cell in comp.cells.items():
        if name not in used:
            rep.add(diag("RV002",
                         f"cell {name!r} ({cell.kind}) is referenced by no "
                         f"reachable group or condition",
                         provenance=(f"cell:{name}",)))
    return live, pipe_nodes, used, cond_cells, bound


def _check_bound_vars(comp: Component, rep: DiagnosticReport,
                      summaries: Dict[str, tuple]) -> None:
    """Every loop var a group's addresses/conditions read must be bound by
    an enclosing ``repeat`` (RV009).  Path-free recursion; provenance is
    rebuilt only for nodes with findings."""
    findings: List[tuple] = []      # (node, group name or None, var)

    def walk(node: CNode, bound: Set[str]) -> None:
        t = type(node)
        if t is GEnable:
            s = summaries.get(node.group)
            if s is None:
                return
            free = s[1]
            if free <= bound:
                return
            for var in sorted(free - bound):
                findings.append((node, node.group, var))
        elif t is CSeq or t is CPar:
            for ch in node.children:
                walk(ch, bound)
        elif t is CRepeat:
            inner = bound | {node.var} if node.var else bound
            walk(node.body, inner)
        elif t is CIf:
            if node.cond is not None:
                fv = node.cond.expr.free_vars()
                if not fv <= bound:
                    for var in sorted(fv - bound):
                        findings.append((node, None, var))
            walk(node.then, bound)
            walk(node.els, bound)

    walk(comp.control, set())
    if findings:
        paths = _paths_of(comp.control, [n for n, _, _ in findings])
        for node, gname, var in findings:
            path = paths.get(id(node), ())
            if gname is not None:
                rep.add(diag("RV009",
                             f"group {gname!r} addresses loop var {var!r} "
                             f"but no enclosing repeat binds it",
                             provenance=path + (f"group:{gname}",
                                                f"var:{var}")))
            else:
                rep.add(diag("RV009",
                             f"if condition reads loop var {var!r} "
                             f"outside any binding repeat",
                             provenance=path + (f"var:{var}",)))


# ---------------------------------------------------------------------------
# Per-group micro-op dataflow + port discipline (RV01x, RV020)
# ---------------------------------------------------------------------------


def _uop_port(mem: str, idxs, is_store: bool,
              factors: Dict[str, tuple]) -> PortAccess:
    """Rebuild the PortAccess of one memory micro-op — the same bank/key
    split ``calyx._Lower._access`` records, so the static conflict test
    below matches the estimator's bank-affine model exactly."""
    if factors.get(mem):
        bank_e = idxs[0]
        bank = bank_e.const_value() if bank_e.is_const() else None
        key_exprs = idxs[1:]
        bank_expr = None if bank is not None else bank_e
    else:
        bank, key_exprs, bank_expr = 0, list(idxs), None
    free: Set[str] = set()
    for ke in key_exprs:
        free |= ke.free_vars()
    if bank_expr is not None:
        free |= bank_expr.free_vars()
    return PortAccess(mem, bank, tuple(ke.key() for ke in key_exprs),
                      frozenset(free), is_store, bank_expr=bank_expr)


def _use_before_def(rep, g, i, u, t):
    rep.add(diag("RV010", f"temp t{t} read before definition",
                 provenance=(f"group:{g.name}",
                             f"uop[{i}]:{type(u).__name__}")))


def _redefined(rep, g, i, u, t):
    rep.add(diag("RV014", f"temp t{t} defined more than once",
                 provenance=(f"group:{g.name}",
                             f"uop[{i}]:{type(u).__name__}")))


def _check_mem_bounds(rep, prog, factors, g, i, u):
    """RV008 on one memory micro-op; returns False when the memory is
    undeclared (the access then never enters the port-conflict table)."""
    if u.mem not in prog.mems:
        rep.add(diag("RV008",
                     f"access to undeclared memory {u.mem!r}",
                     provenance=(f"group:{g.name}",
                                 f"uop[{i}]:{type(u).__name__}")))
        return False
    if factors.get(u.mem):
        be = u.idxs[0]
        if be.is_const():
            bank = be.const_value()
            nbanks = prog.mems[u.mem].shape[0]
            if not 0 <= bank < nbanks:
                rep.add(diag(
                    "RV008",
                    f"bank index {bank} out of range for "
                    f"memory {u.mem!r} ({nbanks} banks)",
                    provenance=(f"group:{g.name}",
                                f"uop[{i}]:{type(u).__name__}")))
    return True


def _check_group(comp: Component, prog: Optional[Program], g: Group,
                 rep: DiagnosticReport,
                 distinct_cache: Optional[dict] = None,
                 cache: Optional[GroupCache] = None,
                 entry: Optional[list] = None) -> tuple:
    """Check one group; returns ``(cell_refs, alu_refs, all_refs)`` — the
    names a clean verdict assumed present in ``comp.cells`` (what a cache
    hit at a later boundary must re-resolve against the then-current
    table; ``cell_refs`` is the group's own cell list, ``all_refs`` the
    precomputed union a hit tests with one subset comparison).  The same micro-op pass also computes the group's
    :meth:`GroupCache.summary` and stores it on ``cache`` — the summary
    is purely descriptive, so it is valid even when findings fire."""
    if distinct_cache is None:
        distinct_cache = {}
    alu_refs: Set[str] = set()
    free: Set[str] = set()
    first_read: Dict[str, int] = {}
    writes: Set[str] = set()
    reads: Set[str] = set()
    if not g.uops:
        rep.add(diag("RV007",
                     f"group {g.name!r} carries no micro-ops — the "
                     f"component has no executable datapath semantics",
                     provenance=(f"group:{g.name}",)))
    cells = comp.cells
    for c in g.cells:
        if c not in cells:
            rep.add(diag("RV001",
                         f"group {g.name!r} references undefined cell "
                         f"{c!r}", provenance=(f"group:{g.name}",
                                               f"cell:{c}")))
    factors: Dict[str, tuple] = comp.meta.get("bank_factors", {})
    defined: Set[int] = set()
    reg_write_offs: Dict[Tuple[str, int], int] = {}
    busy: Dict[Tuple[int, str], list] = {}
    # direct type dispatch ordered by measured frequency (reg reads and
    # writes dominate lowered groups; selects are rare), provenance built
    # only on a finding — this loop runs over every micro-op of every
    # group at every boundary and must stay cheap on the (overwhelmingly
    # common) clean path
    for i, u in enumerate(g.uops):
        tu = type(u)
        if tu is D.URegRead:
            if u.dst in defined:
                _redefined(rep, g, i, u, u.dst)
            defined.add(u.dst)
            reads.add(u.reg)
            if u.reg not in writes and u.reg not in first_read:
                first_read[u.reg] = i
        elif tu is D.URegWrite:
            if u.src not in defined:
                _use_before_def(rep, g, i, u, u.src)
            writes.add(u.reg)
            key = (u.reg, u.off)
            if key in reg_write_offs:
                rep.add(diag(
                    "RV013",
                    f"register {u.reg!r} latched twice at cycle offset "
                    f"{u.off} (also uop[{reg_write_offs[key]}])",
                    provenance=(f"group:{g.name}", f"uop[{i}]:URegWrite")))
            reg_write_offs[key] = i
        elif tu is D.UAlu:
            if u.a not in defined:
                _use_before_def(rep, g, i, u, u.a)
            if u.b is not None and u.b not in defined:
                _use_before_def(rep, g, i, u, u.b)
            if u.dst in defined:
                _redefined(rep, g, i, u, u.dst)
            defined.add(u.dst)
            if u.cell:
                alu_refs.add(u.cell)
                if u.cell not in cells:
                    rep.add(diag(
                        "RV001",
                        f"micro-op invokes undefined unit {u.cell!r}",
                        provenance=(f"group:{g.name}", f"uop[{i}]:UAlu")))
        elif tu is D.UMemRead:
            if u.dst in defined:
                _redefined(rep, g, i, u, u.dst)
            defined.add(u.dst)
            for ix in u.idxs:
                free.update(ix.free_vars())
            if (prog is None
                    or _check_mem_bounds(rep, prog, factors, g, i, u)):
                busy.setdefault((u.off, u.mem), []).append((i, u, False))
        elif tu is D.UConst:
            if u.dst in defined:
                _redefined(rep, g, i, u, u.dst)
            defined.add(u.dst)
        elif tu is D.UMemWrite:
            if u.src not in defined:
                _use_before_def(rep, g, i, u, u.src)
            for ix in u.idxs:
                free.update(ix.free_vars())
            if (prog is None
                    or _check_mem_bounds(rep, prog, factors, g, i, u)):
                busy.setdefault((u.off, u.mem), []).append((i, u, True))
        elif tu is D.USelect:
            if u.a not in defined:
                _use_before_def(rep, g, i, u, u.a)
            if u.b not in defined:
                _use_before_def(rep, g, i, u, u.b)
            if u.dst in defined:
                _redefined(rep, g, i, u, u.dst)
            defined.add(u.dst)
            free.update(u.cond.expr.free_vars())
    # one access per (memory, bank) per cycle within the activation window;
    # all accesses in one group share an environment, so structural key
    # equality means address equality and the estimator's pairwise test
    # (distinct banks / broadcast loads) applies verbatim.  Structurally
    # equal bank signatures short-circuit to "same bank"; only genuinely
    # different runtime bank expressions pay for the mod-residue
    # distinctness proof, memoized across the component's groups.  Port
    # accesses (and their structural keys) are materialized only for the
    # rare (cycle, memory) buckets holding more than one access.
    multi = ([kv for kv in busy.items() if len(kv[1]) > 1]
             if busy else None)
    if multi:
        multi.sort()
    for (off, _mem), raw in multi or ():
        accs = []
        for i, u, is_store in raw:
            pa = _uop_port(u.mem, u.idxs, is_store, factors)
            sig = pa.bank if pa.bank is not None else (
                pa.bank_expr.key() if pa.bank_expr is not None else None)
            accs.append((pa, i, sig))
        for x in range(len(accs)):
            pa, i, sa = accs[x]
            for y in range(x + 1, len(accs)):
                pb, j, sb = accs[y]
                if sa == sb and sa is not None:
                    distinct = False       # same bank under the shared env
                elif pa.bank is not None and pb.bank is not None:
                    distinct = True        # two different constant banks
                else:
                    ck = (sa, sb)
                    distinct = distinct_cache.get(ck)
                    if distinct is None:
                        distinct = estimator.banks_provably_distinct(pa, pb)
                        distinct_cache[ck] = distinct
                if distinct:
                    continue
                if (not pa.is_store and not pb.is_store
                        and pa.key is not None and pa.key == pb.key):
                    continue               # broadcast-equal loads
                rep.add(diag(
                    "RV020",
                    f"memory {pa.mem!r} port contended at cycle offset "
                    f"{off}: uop[{i}] vs uop[{j}] (one access per "
                    f"cycle)", provenance=(f"group:{g.name}",
                                           f"uop[{i}]+uop[{j}]")))
    refs_u = set(g.cells)
    if alu_refs:
        refs_u.update(alu_refs)
    e = entry if entry is not None else (
        cache._entry(g) if cache is not None else None)
    if e is not None and e[1] is None:
        # the used-cell set is the ref union plus the register cells the
        # group touches — assembled once here, not per micro-op
        used = set(refs_u)
        for r in writes:
            used.add(f"reg_{r}")
        for r in reads:
            used.add(f"reg_{r}")
        e[1] = (used, free, first_read, writes, reads)
    return (g.cells, alu_refs, refs_u)


# ---------------------------------------------------------------------------
# Register def-use over the control tree (RV011 / RV012)
# ---------------------------------------------------------------------------


def _check_reg_flow(comp: Component, rep: DiagnosticReport,
                    summaries: Dict[str, tuple]) -> None:
    """Forward must-write analysis: a register read is clean only when a
    write dominates it on every path.  ``par`` arms see only writes from
    before the fork (arms are concurrent); ``if`` joins intersect; a
    ``repeat`` body is flowed once — iteration 0 is the binding case."""
    reported: Set[Tuple[str, str]] = set()
    findings: List[Tuple[str, str, int]] = []

    # ``flow(node, layers)`` returns the set of registers node must-writes
    # (its delta); ``layers`` is the read-only chain of ancestor write
    # sets a read resolves against.  Deltas stay small and layers are
    # shared, never copied — forking a ``par``/``if`` arm costs nothing,
    # and a linear ``seq`` chain appends one accumulator layer instead of
    # rebuilding a growing union per group (quadratic in chain length).
    # Provenance paths are reconstructed only if something actually fired.
    def flow(node: CNode, layers: tuple) -> Set[str]:
        t = type(node)
        if t is GEnable:
            s = summaries.get(node.group)
            if s is None:
                return _EMPTY_SET
            first_read, writes = s[2], s[3]
            if first_read:
                for reg in first_read:
                    for have in layers:
                        if reg in have:
                            break
                    else:
                        if (node.group, reg) not in reported:
                            reported.add((node.group, reg))
                            findings.append(
                                (node.group, reg, first_read[reg]))
            # callers only union the returned delta, never mutate it,
            # so the summary's own write set is safe to hand back
            return writes
        if t is CSeq:
            acc: Set[str] = set()
            inner = layers + (acc,)
            for ch in node.children:
                acc |= flow(ch, inner)
            return acc
        if t is CPar:
            # arms are concurrent: each sees only pre-fork writes
            out: Set[str] = set()
            for ch in node.children:
                out |= flow(ch, layers)
            return out
        if t is CIf:
            return flow(node.then, layers) & flow(node.els, layers)
        if t is CRepeat:
            if node.extent <= 0:
                return _EMPTY_SET
            return flow(node.body, layers)
        return _EMPTY_SET

    flow(comp.control, ())
    if findings:
        first_path: Dict[str, Tuple[str, ...]] = {}
        for node, path in _walk(comp.control, ()):
            if isinstance(node, GEnable) and node.group not in first_path:
                first_path[node.group] = path
        for gname, reg, i in findings:
            rep.add(diag(
                "RV011",
                f"register {reg!r} read with no prior write on this path",
                provenance=first_path.get(gname, ())
                + (f"group:{gname}", f"uop[{i}]:URegRead")))


def _check_dead_writes(comp: Component, live: Set[str],
                       rep: DiagnosticReport,
                       summaries: Dict[str, tuple]) -> None:
    """A register no reachable group ever reads makes every write to it
    dead (RV012, warning) — the liveness input to dead-cell elimination."""
    read: Set[str] = set()
    for name in live:
        s = summaries.get(name)
        if s is not None:
            read |= s[4]
    for name in sorted(live):
        g = comp.groups.get(name)
        s = summaries.get(name)
        if g is None or s is None or s[3] <= read:
            continue                       # every written reg is read
        for i, u in enumerate(g.uops):
            if isinstance(u, D.URegWrite) and u.reg not in read:
                rep.add(diag(
                    "RV012",
                    f"register {u.reg!r} is written but never read by any "
                    f"reachable group",
                    provenance=(f"group:{g.name}",
                                f"uop[{i}]:URegWrite")))


# ---------------------------------------------------------------------------
# Static hardware-discipline proofs (RV021 / RV022 / RV023)
# ---------------------------------------------------------------------------


def _check_pools(comp: Component, rep: DiagnosticReport,
                 summaries: Dict[str, tuple]) -> None:
    """Static twin of the simulators' single-owner arbitration: no shared
    pool cell may be reachable from two arms of one ``par``.  Skipped
    entirely pre-binding (no pooled cells exist).  One bottom-up pass:
    each subtree reports the pool cells reachable under it (a group's
    used-cell summary intersected with the pool names — uop-level FU
    invocations count, matching what the simulators arbitrate), and
    every ``par`` node checks its arms' sets pairwise on the way up."""
    pooled_names = {n for n, c in comp.cells.items() if c.users > 1}
    if not pooled_names:
        return
    empty: frozenset = frozenset()
    findings: List[tuple] = []      # (par node, arm i, arm j, overlap)

    def gather(node: CNode) -> Set[str]:
        t = type(node)
        if t is GEnable:
            s = summaries.get(node.group)
            return s[0] & pooled_names if s is not None else empty
        if t is CSeq:
            out: Set[str] = set()
            for ch in node.children:
                out |= gather(ch)
            return out
        if t is CPar:
            arm_pools = [gather(ch) for ch in node.children]
            busy = [a for a in arm_pools if a]
            if len(busy) > 1:
                for i in range(len(arm_pools)):
                    for j in range(i + 1, len(arm_pools)):
                        both = arm_pools[i] & arm_pools[j]
                        if both:
                            findings.append((node, i, j, both))
            out = set()
            for a in arm_pools:
                out |= a
            return out
        if t is CRepeat:
            return gather(node.body)
        if t is CIf:
            return gather(node.then) | gather(node.els)
        return empty

    gather(comp.control)
    if findings:
        paths = _paths_of(comp.control, [n for n, _, _, _ in findings])
        for node, i, j, both in findings:
            rep.add(diag(
                "RV021",
                f"shared cell(s) {sorted(both)} reachable from par arms "
                f"{i} and {j} — single-owner arbitration cannot hold",
                provenance=paths.get(id(node), ())
                + (f"par[{i}]+par[{j}]",)))


def _check_pipelined(comp: Component, rep: DiagnosticReport,
                     cache: GroupCache,
                     pipe_nodes: List[CRepeat]) -> None:
    """Re-prove every annotated II from the body's stamped offsets — the
    modulo reservation table, register recurrence floor, and iterative-
    unit floor the pipelining pass claims to have honored.  A (group,
    ii) pair that already passed at an earlier boundary is not re-proven
    (the proof reads only the group's own stamped schedule).  Works off
    the pipelined-repeat list :func:`_check_structure` collected, so no
    extra control walk on the clean path."""
    findings: List[tuple] = []      # (node, group, code, message)
    for node in pipe_nodes:
        g = comp.groups.get(node.body.group)
        if g is None or not g.uops:
            continue
        if cache.pipe_clean(g, node.ii):
            continue
        rows = pipelining.port_offsets(comp, g)
        if rows is None:
            findings.append((node, g, "RV023",
                             f"loop over {node.var or '_'!r} is pipelined "
                             f"(ii={node.ii}) but its body both reads and "
                             f"writes one memory — a loop-carried "
                             f"dependence pipelining does not analyze"))
            continue
        floor = max(pipelining.register_floor(g),
                    pipelining.unit_floor(comp, g))
        if node.ii < floor:
            findings.append((node, g, "RV022",
                             f"ii={node.ii} is below the loop-carried "
                             f"recurrence / iterative-unit floor {floor}"))
        elif not pipelining.rows_admit(rows, node.ii):
            findings.append((node, g, "RV022",
                             f"ii={node.ii} violates the body's modulo "
                             f"port reservation (same-bank offsets collide "
                             f"mod ii)"))
        else:
            cache.mark_pipe_clean(g, node.ii)
    if findings:
        paths = _paths_of(comp.control, [n for n, _, _, _ in findings])
        for node, g, code, msg in findings:
            rep.add(diag(code, msg,
                         provenance=paths.get(id(node), ())
                         + (f"group:{g.name}",)))


# ---------------------------------------------------------------------------
# Component entry point
# ---------------------------------------------------------------------------


def _flow_identical(old: Dict[str, tuple], new: Dict[str, tuple]) -> bool:
    """Whether two boundaries' summaries agree on every control-relevant
    component (free vars, first reads, writes, reads) — by object
    identity, so pass-through groups and sharing's verified rebind (which
    reuses those components) hit, while any recomputed summary
    conservatively misses.  ``s[0]`` (used cells) is deliberately not
    compared: the checks that read it re-run at every boundary."""
    if len(old) != len(new):
        return False
    for name, a in new.items():
        b = old.get(name)
        if b is None:
            return False
        if a is b:
            continue
        if not (a[1] is b[1] and a[2] is b[2]
                and a[3] is b[3] and a[4] is b[4]):
            return False
    return True


def verify_component(comp: Component, prog: Optional[Program] = None, *,
                     stage: str = "post-lower",
                     cache: Optional[GroupCache] = None
                     ) -> DiagnosticReport:
    """Statically verify one lowered component; never raises — callers
    decide via :meth:`DiagnosticReport.raise_if_errors`.

    Pass one :class:`GroupCache` across the successive boundaries of a
    single compile: group objects a pass carried over unchanged skip
    straight to re-resolving their cell references against the current
    cell table instead of re-proving the whole per-group check suite.
    """
    if cache is None:
        cache = GroupCache()
    with timed_report(stage) as rep:
        # group-local checks first: a cache hit is one set-subset test
        # against the current cell table; a miss runs the full check and
        # computes the group's summary in the same micro-op pass.  The
        # summaries dict the control walkers below consume is filled here
        # too — one cache access per group, not two.
        ckeys = set(comp.cells)
        distinct_cache: dict = {}
        summaries: Dict[str, tuple] = {}
        for name, g in comp.groups.items():
            e = cache._entry(g)
            refs = e[2]
            if refs is None:
                before = len(rep)
                refs = _check_group(comp, prog, g, rep,
                                    distinct_cache, cache, e)
                if len(rep) == before:
                    e[2] = refs
            elif not refs[2] <= ckeys:
                for c in sorted(set(refs[0]) - ckeys):
                    rep.add(diag("RV001",
                                 f"group {g.name!r} references undefined "
                                 f"cell {c!r}",
                                 provenance=(f"group:{g.name}",
                                             f"cell:{c}")))
                for c in sorted(refs[1] - ckeys):
                    rep.add(diag("RV001",
                                 f"micro-op invokes undefined unit {c!r}",
                                 provenance=(f"group:{g.name}",)))
            s = e[1]
            summaries[name] = s if s is not None else cache.summary(g)
        # control-tree analyses: skipped when this boundary's control is
        # the same object the last clean boundary walked and the
        # summaries' control-relevant parts carried over — then only the
        # cell-table-dependent checks (RV001 above, RV002 here, pools,
        # pipelined floors) can change verdicts
        fs = cache.flow_state
        carried = False
        if (fs is not None and fs[0] is comp.control
                and _flow_identical(fs[1], summaries)):
            live, pipe_nodes, cond_cells, bvars = fs[2], fs[3], fs[4], fs[5]
            if fs[7] is comp.cells:
                used = fs[6]          # same cell table too: nothing to redo
                carried = True
            elif fs[4] <= ckeys:
                used = _used_cells(comp, live, summaries, cond_cells, bvars)
                for name, cell in comp.cells.items():
                    if name not in used:
                        rep.add(diag(
                            "RV002",
                            f"cell {name!r} ({cell.kind}) is referenced "
                            f"by no reachable group or condition",
                            provenance=(f"cell:{name}",)))
                carried = True
        if not carried:
            (live, pipe_nodes, used,
             cond_cells, bvars) = _check_structure(comp, rep, summaries)
            _check_bound_vars(comp, rep, summaries)
            _check_reg_flow(comp, rep, summaries)
            _check_dead_writes(comp, live, rep, summaries)
        _check_pools(comp, rep, summaries)
        _check_pipelined(comp, rep, cache, pipe_nodes)
    cache.liveness = (comp, live, used)
    cache.flow_state = ((comp.control, summaries, live, pipe_nodes,
                         cond_cells, bvars, used, comp.cells)
                        if not rep else None)
    return rep


# ---------------------------------------------------------------------------
# Dead-cell / dead-group elimination (consumes RV002/RV004 liveness)
# ---------------------------------------------------------------------------


def eliminate_dead(comp: Component, cache: Optional[GroupCache] = None
                   ) -> Tuple[Component, Dict[str, List[str]]]:
    """Strip groups unreachable from control and cells nothing live
    references.  Cycle-neutral by construction: the control tree and every
    live group are reused untouched, and ``estimator.cycles`` only ever
    consults groups reachable from control.  Memory banks and the index
    counters of bound loop vars always survive (host interface /
    controller state).  Returns ``(component, removed)`` where ``removed``
    maps ``"groups"``/``"cells"`` to the stripped names (both empty on a
    clean design — the pass then returns the input component unchanged).
    """
    cache = cache or GroupCache()
    lv = cache.liveness
    if lv is not None and lv[0] is comp:
        # the verifier just walked this exact component: reuse its
        # liveness instead of recomputing the same reachability + use set
        live, used = lv[1], lv[2]
    else:
        live = referenced_groups(comp.control)
        used = _used_cells(comp, live, {name: cache.summary(g)
                                        for name, g in comp.groups.items()})
    dead_groups = sorted(set(comp.groups) - live)
    dead_cells = sorted(c for c in comp.cells if c not in used)
    removed = {"groups": dead_groups, "cells": dead_cells}
    if not dead_groups and not dead_cells:
        return comp, removed
    out = Component(
        comp.name,
        {n: c for n, c in comp.cells.items() if n in used},
        {n: g for n, g in comp.groups.items() if n in live},
        comp.control, meta=dict(comp.meta))
    out.meta["dead_eliminated"] = removed
    return out, removed


# ---------------------------------------------------------------------------
# Netlist checks (RV03x)
# ---------------------------------------------------------------------------


def _fsm_paths(net: Netlist) -> Dict[int, List[Tuple[int, int, int]]]:
    """fid -> fork-edge path from the root: [(parent_fid, par_state, fid)].

    Two controllers are concurrent iff their paths first diverge at the
    *same* par state into *different* children; diverging at different
    states of one FSM means they run at different times, and an
    ancestor/descendant pair never overlaps on group states (the parent
    sits in its par state while the child runs).
    """
    edge: Dict[int, Tuple[int, int]] = {}
    for f in net.fsms:
        for st in f.states:
            if st.kind == "par":
                for ch in st.children:
                    if 0 <= ch < len(net.fsms):
                        edge[ch] = (f.fid, st.index)
    paths: Dict[int, List[Tuple[int, int, int]]] = {}
    for f in net.fsms:
        p: List[Tuple[int, int, int]] = []
        cur, seen = f.fid, set()
        while cur in edge and cur not in seen:
            seen.add(cur)
            pf, si = edge[cur]
            p.append((pf, si, cur))
            cur = pf
        paths[f.fid] = list(reversed(p))
    return paths


def _fsms_concurrent(pa: List[Tuple[int, int, int]],
                     pb: List[Tuple[int, int, int]]) -> bool:
    for ea, eb in zip(pa, pb):
        if ea == eb:
            continue
        return ea[0] == eb[0] and ea[1] == eb[1]
    return False


def _state_prov(f, st) -> Tuple[str, str]:
    """Provenance of one FSM state — built only next to a finding; the
    state loop visits every controller state of every design."""
    return (f"fsm{f.fid}", f"state[{st.index}]:{st.kind}")


def _check_fsms(net: Netlist, rep: DiagnosticReport) -> None:
    nfsms = len(net.fsms)
    for f in net.fsms:
        nstates = len(f.states)
        succ: Dict[int, List[int]] = {}
        for st in f.states:
            nexts: List[int] = []
            v = st.next
            if v is not None:
                if 0 <= v < nstates:
                    nexts.append(v)
                else:
                    rep.add(diag("RV033",
                                 f"next -> state {v} out of range "
                                 f"(fsm has {nstates} states)",
                                 provenance=_state_prov(f, st)))
            v = st.then_state
            if v is not None:
                if 0 <= v < nstates:
                    nexts.append(v)
                else:
                    rep.add(diag("RV033",
                                 f"then_state -> state {v} out of range "
                                 f"(fsm has {nstates} states)",
                                 provenance=_state_prov(f, st)))
            v = st.else_state
            if v is not None:
                if 0 <= v < nstates:
                    nexts.append(v)
                else:
                    rep.add(diag("RV033",
                                 f"else_state -> state {v} out of range "
                                 f"(fsm has {nstates} states)",
                                 provenance=_state_prov(f, st)))
            if st.loop is not None:
                var, _extent, head = st.loop
                if not 0 <= head < nstates:
                    rep.add(diag("RV033",
                                 f"loop back-edge -> state {head} out of "
                                 f"range", provenance=_state_prov(f, st)))
                else:
                    nexts.append(head)
                if var not in f.binds:
                    rep.add(diag("RV033",
                                 f"loop back-edge counts unbound index "
                                 f"{var!r}",
                                 provenance=_state_prov(f, st)))
            for ch in st.children:
                if not 0 <= ch < nfsms:
                    rep.add(diag("RV033",
                                 f"par child fsm{ch} does not exist",
                                 provenance=_state_prov(f, st)))
                elif net.fsms[ch].parent != f.fid:
                    rep.add(diag("RV033",
                                 f"par child fsm{ch} names fsm"
                                 f"{net.fsms[ch].parent} as its parent",
                                 provenance=_state_prov(f, st)))
            kind = st.kind
            if kind == "group" or kind == "pipe":
                if st.group not in net.blocks:
                    rep.add(diag("RV033",
                                 f"state enables unknown datapath block "
                                 f"{st.group!r}",
                                 provenance=_state_prov(f, st)))
            elif kind == "cond":
                if st.cond is None:
                    rep.add(diag("RV005",
                                 "cond state carries no condition",
                                 provenance=_state_prov(f, st)))
                else:
                    for var in st.cond.expr.free_vars():
                        try:
                            net.resolve_index(f.fid, var)
                        except KeyError:
                            rep.add(diag(
                                "RV034",
                                f"condition reads loop var {var!r} not "
                                f"bound on the controller chain",
                                provenance=_state_prov(f, st)
                                + (f"var:{var}",)))
            succ[st.index] = nexts
        # reachability over intra-fsm transitions
        if not 0 <= f.start < nstates:
            rep.add(diag("RV033", f"start state {f.start} out of range",
                         provenance=(f"fsm{f.fid}",)))
            continue
        seen = {f.start}
        stack = [f.start]
        while stack:
            s = stack.pop()
            for nxt in succ.get(s, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        for st in f.states:
            if st.index not in seen:
                rep.add(diag("RV032",
                             f"state never reached from the start state",
                             provenance=(f"fsm{f.fid}",
                                         f"state[{st.index}]:{st.kind}")))


def _check_block(net: Netlist, b: DpBlock, fid: Optional[int],
                 rep: DiagnosticReport,
                 resolved: Optional[dict] = None) -> None:
    """One datapath block.  Direct type dispatch, provenance tuples built
    only next to a finding, and loop-var resolution memoized per
    ``(fid, var)`` across the netlist's blocks (``resolved``) — this
    runs over every op of every block on every compile."""
    defined: Set[int] = set()
    reg_write_offs: Set[Tuple[str, int]] = set()
    if resolved is None:
        resolved = {}
    units, regs, mems = net.units, net.regs, net.mems

    def prov_at(i, op):
        return (f"block:{b.group}", f"op[{i}]:{type(op).__name__}")

    def resolvable(var: str, i, op) -> None:
        # memo-hit fast path is inlined at the call sites; this body only
        # runs on a first sighting of (fid, var) or a known-bad one
        key = (fid, var)
        ok = resolved.get(key)
        if ok is None:
            try:
                net.resolve_index(fid, var)
                ok = True
            except KeyError:
                ok = False
            resolved[key] = ok
        if not ok:
            rep.add(diag("RV034",
                         f"loop var {var!r} not bound on the controller "
                         f"chain of fsm{fid}",
                         provenance=prov_at(i, op) + (f"var:{var}",)))

    def undriven(t, i, op, dst) -> None:
        kind = ("self-reference" if t == dst
                else "forward reference")
        rep.add(diag("RV031",
                     f"wire w{t} read before it is driven "
                     f"({kind} in the block's dataflow order)",
                     provenance=prov_at(i, op) + (f"wire:w{t}",)))

    def multi_driven(dst, i, op) -> None:
        rep.add(diag("RV030",
                     f"wire w{dst} driven by more than one "
                     f"datapath op",
                     provenance=prov_at(i, op) + (f"wire:w{dst}",)))

    for i, op in enumerate(b.ops):
        t = type(op)
        if t is DpUnit:
            dst = op.dst
            if op.a not in defined:
                undriven(op.a, i, op, dst)
            b2 = op.b
            if b2 is not None and b2 not in defined:
                undriven(b2, i, op, dst)
            if op.unit not in units:
                rep.add(diag("RV001",
                             f"block drives undefined unit {op.unit!r}",
                             provenance=prov_at(i, op)))
            if dst in defined:
                multi_driven(dst, i, op)
            defined.add(dst)
        elif t is DpSelect:
            dst = op.dst
            if op.a not in defined:
                undriven(op.a, i, op, dst)
            if op.b not in defined:
                undriven(op.b, i, op, dst)
            if fid is not None:
                for var in op.cond.expr.free_vars():
                    if not resolved.get((fid, var), False):
                        resolvable(var, i, op)
            if dst in defined:
                multi_driven(dst, i, op)
            defined.add(dst)
        elif t is DpRegWrite:
            if op.src not in defined:
                undriven(op.src, i, op, None)
            if op.reg not in regs:
                rep.add(diag("RV001",
                             f"block writes undefined register {op.reg!r}",
                             provenance=prov_at(i, op)))
            key = (op.reg, op.off)
            if key in reg_write_offs:
                rep.add(diag("RV030",
                             f"register {op.reg!r} driven twice at cycle "
                             f"offset {op.off}", provenance=prov_at(i, op)))
            reg_write_offs.add(key)
        elif t is DpMemWrite:
            if op.src not in defined:
                undriven(op.src, i, op, None)
            if op.mem not in mems:
                rep.add(diag("RV008",
                             f"access to undeclared memory {op.mem!r}",
                             provenance=prov_at(i, op)))
            if fid is not None:
                for ix in op.idxs:
                    for var in ix.free_vars():
                        if not resolved.get((fid, var), False):
                            resolvable(var, i, op)
        elif t is DpMemRead:
            if op.mem not in mems:
                rep.add(diag("RV008",
                             f"access to undeclared memory {op.mem!r}",
                             provenance=prov_at(i, op)))
            if fid is not None:
                for ix in op.idxs:
                    for var in ix.free_vars():
                        if not resolved.get((fid, var), False):
                            resolvable(var, i, op)
            dst = op.dst
            if dst in defined:
                multi_driven(dst, i, op)
            defined.add(dst)
        elif t is DpRegRead:
            if op.reg not in regs:
                rep.add(diag("RV001",
                             f"block reads undefined register {op.reg!r}",
                             provenance=prov_at(i, op)))
            dst = op.dst
            if dst in defined:
                multi_driven(dst, i, op)
            defined.add(dst)
        else:
            dst = getattr(op, "dst", None)
            if dst is not None:
                if dst in defined:
                    multi_driven(dst, i, op)
                defined.add(dst)


def _check_reg_drivers(net: Netlist, rep: DiagnosticReport) -> None:
    """Registers written from two provably-concurrent controllers would be
    multi-driven in hardware (RV030) — the netlist twin of the IR-level
    write-race check."""
    gfids = net.group_fids()
    writes_by_fid: Dict[int, Dict[str, str]] = {}
    for name, b in net.blocks.items():
        fid = gfids.get(name)
        if fid is None:
            continue
        table = writes_by_fid.setdefault(fid, {})
        for op in b.ops:
            if isinstance(op, DpRegWrite):
                table.setdefault(op.reg, name)
    fids = sorted(writes_by_fid)
    if len(fids) < 2:
        return
    paths = _fsm_paths(net)
    for x in range(len(fids)):
        for y in range(x + 1, len(fids)):
            fa, fb = fids[x], fids[y]
            both = set(writes_by_fid[fa]) & set(writes_by_fid[fb])
            if not both:
                continue
            if _fsms_concurrent(paths[fa], paths[fb]):
                for reg in sorted(both):
                    rep.add(diag(
                        "RV030",
                        f"register {reg!r} written from concurrent "
                        f"controllers fsm{fa} (block "
                        f"{writes_by_fid[fa][reg]!r}) and fsm{fb} (block "
                        f"{writes_by_fid[fb][reg]!r})",
                        provenance=(f"fsm{fa}+fsm{fb}", f"reg:{reg}")))


_COUNTER_KINDS = ("total", "stall_port", "stall_pool", "stall_ii",
                  "fsm_overhead")


def _check_counters(net: Netlist, rep: DiagnosticReport) -> None:
    """Verify the profiled netlist's perf-counter bank (RV05x).

    The host derives the counter address map from the design alone
    (``rtl.perf_counter_bank``), so the bank must be structurally exact:
    indices dense from zero, every group counter naming a real datapath
    block, one ``total``, one counter per group, and each stall family
    present exactly once.
    """
    counters = net.counters
    idxs = [c.index for c in counters]
    if idxs != list(range(len(counters))):
        rep.add(diag("RV051",
                     f"counter indices must be dense from 0 "
                     f"(got {idxs})", provenance=("counters",)))
    names = [c.name for c in counters]
    if len(set(names)) != len(names):
        dup = sorted({n for n in names if names.count(n) > 1})
        rep.add(diag("RV051", f"duplicate counter names {dup}",
                     provenance=("counters",)))
    by_kind: Dict[str, int] = {}
    for c in counters:
        if c.kind not in _COUNTER_KINDS + ("group",):
            rep.add(diag("RV051",
                         f"counter {c.name!r} has unknown kind "
                         f"{c.kind!r}", provenance=(f"counter:{c.name}",)))
            continue
        by_kind[c.kind] = by_kind.get(c.kind, 0) + 1
        if c.kind == "group" and c.group not in net.blocks:
            rep.add(diag("RV050",
                         f"counter {c.name!r} references unknown group "
                         f"{c.group!r}", provenance=(f"counter:{c.name}",)))
    counted = {c.group for c in counters if c.kind == "group"}
    missing = [g for g in net.blocks if g not in counted]
    if missing:
        rep.add(diag("RV052",
                     f"groups without a counter: {missing}",
                     provenance=("counters",)))
    for kind in _COUNTER_KINDS:
        if by_kind.get(kind, 0) != 1:
            rep.add(diag("RV052",
                         f"expected exactly one {kind!r} counter "
                         f"(got {by_kind.get(kind, 0)})",
                         provenance=("counters",)))


def verify_netlist(net: Netlist, *,
                   stage: str = "post-rtl") -> DiagnosticReport:
    """Statically verify the FSM + datapath netlist (``core.rtl``) — the
    graph, not the emitted text (``verilog.lint_diagnostics`` covers
    that).  Profiled netlists additionally get their perf-counter bank
    checked against the canonical address map (RV05x)."""
    with timed_report(stage) as rep:
        _check_fsms(net, rep)
        if net.profile:
            _check_counters(net, rep)
        gfids = net.group_fids()
        resolved: dict = {}
        # net.blocks is insertion-ordered by construction, so iteration
        # (and therefore finding order) is already deterministic
        for name, b in net.blocks.items():
            fid = gfids.get(name)
            if fid is None:
                rep.add(diag("RV004",
                             f"datapath block {name!r} is enabled by no "
                             f"controller state",
                             provenance=(f"block:{name}",)))
            _check_block(net, b, fid, rep, resolved)
    return rep


# ---------------------------------------------------------------------------
# Whole-design convenience (CLI, benchmarks)
# ---------------------------------------------------------------------------


def verify_design(design) -> List[DiagnosticReport]:
    """Verify a ``pipeline.CompiledDesign`` end to end: the final
    component and its RTL netlist.  Pure re-analysis — compiles nothing,
    simulates nothing; used by ``scripts/lint_design.py`` and the
    benchmark's verifier-overhead timing."""
    return [verify_component(design.component, design.program,
                             stage="post-sharing"),
            verify_netlist(design.to_rtl())]
