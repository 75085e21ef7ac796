"""Memory banking & partitioning — the paper's core contribution (§3.3).

Two modes, matching the paper's narrative exactly:

* ``layout``  — the paper's technique: raise each banked memory's
  dimensionality and bake the bank index into the leading dimension.  After
  par-unrolling, ``(c*ii + a) % c`` folds to the constant ``a``: every
  parallel arm addresses a statically-known bank, accesses are provably
  disjoint, and no selection hardware is emitted.

* ``branchy`` — the naive scheme the paper argues against: every access is
  guarded by a bank-selection chain (`if`/select over all banks).  The bank
  expression is deliberately kept symbolic (ModAtom/DivAtom), modeling a
  compiler that cannot fold the predicate; all ``prod(factors)`` arms are
  instantiated in hardware, giving the c^d control blow-up.

``check_par_hazards`` implements the static safety analysis: store/store and
store/load pairs across par arms must be *provably disjoint* (some index
dimension differs by a nonzero constant).  In layout mode this proof succeeds
by construction; in branchy mode it cannot, which is the paper's motivation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .affine import (AExpr, Bin, Cond, ConstF, DivAtom, If, Load, Loop,
                     MemDecl, ModAtom, Par, Program, ReadReg, SelectC, SetReg,
                     Stmt, Store, Un, VExpr, stmt_accesses, walk_statements)


@dataclasses.dataclass
class BankingSpec:
    factor: int = 1                 # cyclic partition factor per dimension
    mode: str = "layout"            # 'layout' | 'branchy'
    mems: Optional[Set[str]] = None  # None = every non-scalar memory

    def factors_for(self, decl: MemDecl) -> Tuple[int, ...]:
        return tuple(min(self.factor, s) for s in decl.shape)


class BankConflictError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Access rewriting
# ---------------------------------------------------------------------------


def _bank_and_intra(idxs: Sequence[AExpr], factors: Sequence[int],
                    fold: bool) -> Tuple[AExpr, List[AExpr]]:
    """bank = mixed-radix of (idx_d mod f_d); intra_d = idx_d // f_d."""
    bank = AExpr.const_(0)
    intra: List[AExpr] = []
    strides = []
    s = 1
    for f in reversed(factors):
        strides.insert(0, s)
        s *= f
    for d, (e, f) in enumerate(zip(idxs, factors)):
        if f == 1:
            intra.append(e)
            continue
        if fold:
            m = e.mod(f)
            q = e.floordiv(f)
        else:  # branchy: keep symbolic even when foldable
            m = AExpr({ModAtom(e, f): 1})
            q = AExpr({DivAtom(e, f): 1})
        bank = bank + m * strides[d]
        intra.append(q)
    return bank, intra


def _rewrite_vexpr(e: VExpr, spec: BankingSpec, decls: Dict[str, MemDecl]) -> VExpr:
    if isinstance(e, Load):
        decl = decls.get(e.mem)
        if decl is None or not decl.banks:
            return Load(e.mem, list(e.idxs))
        factors = decl.banks
        nbanks = _prod(factors)
        bank, intra = _bank_and_intra(e.idxs, factors, fold=spec.mode == "layout")
        if spec.mode == "layout":
            return Load(e.mem, [bank] + intra)
        # branchy: select-chain across all banks (all sides instantiated)
        out: VExpr = Load(e.mem, [AExpr.const_(nbanks - 1)] + intra)
        for b in reversed(range(nbanks - 1)):
            out = SelectC(Cond.cmp(bank, "eq", b),
                          Load(e.mem, [AExpr.const_(b)] + intra), out)
        return out
    if isinstance(e, Bin):
        return Bin(e.op, _rewrite_vexpr(e.a, spec, decls),
                   _rewrite_vexpr(e.b, spec, decls))
    if isinstance(e, Un):
        return Un(e.op, _rewrite_vexpr(e.a, spec, decls))
    if isinstance(e, SelectC):
        return SelectC(e.cond, _rewrite_vexpr(e.a, spec, decls),
                       _rewrite_vexpr(e.b, spec, decls))
    return e


def _rewrite_stmts(stmts: List[Stmt], spec: BankingSpec,
                   decls: Dict[str, MemDecl]) -> List[Stmt]:
    out: List[Stmt] = []
    for s in stmts:
        if isinstance(s, Store):
            decl = decls.get(s.mem)
            value = _rewrite_vexpr(s.value, spec, decls)
            if decl is None or not decl.banks:
                out.append(Store(s.mem, list(s.idxs), value))
                continue
            factors = decl.banks
            nbanks = _prod(factors)
            bank, intra = _bank_and_intra(s.idxs, factors,
                                          fold=spec.mode == "layout")
            if spec.mode == "layout":
                out.append(Store(s.mem, [bank] + intra, value))
            else:
                chain: Stmt = Store(s.mem, [AExpr.const_(nbanks - 1)] + intra,
                                    value)
                stmt_chain: List[Stmt] = [chain]
                for b in reversed(range(nbanks - 1)):
                    stmt_chain = [If(Cond.cmp(bank, "eq", b),
                                     [Store(s.mem, [AExpr.const_(b)] + intra,
                                            value)],
                                     stmt_chain)]
                out.extend(stmt_chain)
        elif isinstance(s, SetReg):
            out.append(SetReg(s.name, _rewrite_vexpr(s.value, spec, decls)))
        elif isinstance(s, Loop):
            out.append(Loop(s.var, s.extent, _rewrite_stmts(s.body, spec, decls),
                            kind=s.kind))
        elif isinstance(s, Par):
            out.append(Par([_rewrite_stmts(a, spec, decls) for a in s.arms]))
        elif isinstance(s, If):
            out.append(If(s.cond, _rewrite_stmts(s.then, spec, decls),
                          _rewrite_stmts(s.els, spec, decls)))
        else:
            raise TypeError(s)
    return out


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def apply_banking(prog: Program, spec: BankingSpec) -> Program:
    """Rewrite memory declarations and every access for the chosen scheme."""
    if spec.factor <= 1:
        return prog
    decls: Dict[str, MemDecl] = {}
    for name, d in prog.mems.items():
        if spec.mems is not None and name not in spec.mems:
            decls[name] = dataclasses.replace(d, banks=())
            continue
        factors = spec.factors_for(d)
        if _prod(factors) <= 1 or d.size <= 1:
            decls[name] = dataclasses.replace(d, banks=())
            continue
        banked_shape = (_prod(factors),) + tuple(
            _ceildiv(s, f) for s, f in zip(d.shape, factors))
        decls[name] = MemDecl(name, banked_shape, d.role, banks=factors)
    body = _rewrite_stmts(prog.body, spec, decls)
    meta = dict(prog.meta)
    meta["banking"] = {"factor": spec.factor, "mode": spec.mode}
    meta["orig_shapes"] = {n: d.shape for n, d in prog.mems.items()}
    return Program(prog.name, decls, body, meta)


# ---------------------------------------------------------------------------
# Static safety analysis (hazards across par arms)
# ---------------------------------------------------------------------------


def _arm_accesses(stmts: List[Stmt]):
    """All (mem, idxs, is_store) pairs reachable in an arm (incl. nested)."""
    for s in walk_statements(stmts):
        yield from stmt_accesses(s)


def _arm_regs(stmts: List[Stmt]) -> Tuple[Set[str], Set[str]]:
    writes: Set[str] = set()
    reads: Set[str] = set()

    def scan_v(e: VExpr):
        if isinstance(e, ReadReg):
            reads.add(e.name)
        elif isinstance(e, Bin):
            scan_v(e.a)
            scan_v(e.b)
        elif isinstance(e, Un):
            scan_v(e.a)
        elif isinstance(e, SelectC):
            scan_v(e.a)
            scan_v(e.b)

    for s in walk_statements(stmts):
        if isinstance(s, SetReg):
            writes.add(s.name)
            scan_v(s.value)
        elif isinstance(s, Store):
            scan_v(s.value)
    return writes, reads


def provably_disjoint(idxs_a: Sequence[AExpr], idxs_b: Sequence[AExpr]) -> bool:
    """True if for some dimension the difference is a nonzero constant."""
    for ea, eb in zip(idxs_a, idxs_b):
        diff = ea - eb
        if diff.is_const() and diff.const_value() != 0:
            return True
    return False


def structurally_equal(idxs_a: Sequence[AExpr], idxs_b: Sequence[AExpr]) -> bool:
    return (len(idxs_a) == len(idxs_b)
            and all(a.key() == b.key() for a, b in zip(idxs_a, idxs_b)))


def check_par_hazards(prog: Program, raise_on_conflict: bool = True) -> List[str]:
    """Pairwise may-alias analysis over every Par block's arms."""
    conflicts: List[str] = []

    def visit(stmts: List[Stmt]):
        for s in stmts:
            if isinstance(s, Par):
                arms = s.arms
                infos = [(list(_arm_accesses(a)), _arm_regs(a)) for a in arms]
                for i in range(len(arms)):
                    for j in range(i + 1, len(arms)):
                        acc_i, (w_i, r_i) = infos[i]
                        acc_j, (w_j, r_j) = infos[j]
                        if w_i & w_j:
                            conflicts.append(
                                f"reg write/write {sorted(w_i & w_j)}")
                        if (w_i & r_j) or (w_j & r_i):
                            conflicts.append(
                                f"reg cross-read {sorted((w_i & r_j) | (w_j & r_i))}")
                        for (m1, x1, st1) in acc_i:
                            for (m2, x2, st2) in acc_j:
                                if m1 != m2 or not (st1 or st2):
                                    continue
                                if provably_disjoint(x1, x2):
                                    continue
                                conflicts.append(
                                    f"mem {m1}: {x1} vs {x2} "
                                    f"({'WW' if st1 and st2 else 'RW'})")
                for a in arms:
                    visit(a)
            elif isinstance(s, Loop):
                visit(s.body)
            elif isinstance(s, If):
                visit(s.then)
                visit(s.els)

    visit(prog.body)
    # dedupe, keep order
    seen = set()
    uniq = [c for c in conflicts if not (c in seen or seen.add(c))]
    if uniq and raise_on_conflict:
        raise BankConflictError("; ".join(uniq[:8]))
    return uniq


# ---------------------------------------------------------------------------
# Metrics for the ablation study
# ---------------------------------------------------------------------------


def count_branch_arms(prog: Program) -> int:
    """Instantiated bank-selection branches (the paper's c^d blow-up)."""
    n = 0

    def scan_v(e: VExpr):
        nonlocal n
        if isinstance(e, SelectC):
            n += 2
            scan_v(e.a)
            scan_v(e.b)
        elif isinstance(e, Bin):
            scan_v(e.a)
            scan_v(e.b)
        elif isinstance(e, Un):
            scan_v(e.a)

    for s in walk_statements(prog.body):
        if isinstance(s, If) and any(isinstance(a, (ModAtom, DivAtom))
                                     for a in s.cond.expr.coeffs):
            n += 2
        if isinstance(s, Store):
            scan_v(s.value)
        elif isinstance(s, SetReg):
            scan_v(s.value)
    return n


def count_divmod_hardware(prog: Program) -> int:
    """Surviving div/mod units (folded away entirely in layout mode)."""
    n = 0
    for s in walk_statements(prog.body):
        for (_, idxs, _) in stmt_accesses(s):
            for e in idxs:
                n += e.divmod_count()
        if isinstance(s, If):
            n += s.cond.expr.divmod_count()
    return n
