"""Loop scheduling passes: strip-mine + unroll `par`, and the paper's
par(seq) -> seq(par) restructuring.

The paper (§3.3) makes two scheduling contributions we reproduce exactly:

1. Parallelization is materialized by strip-mining a loop by the banking
   factor and *fully unrolling* the inner strip into `par` arms, so every
   arm sees statically-known indices (``i = c*ii + a`` with constant ``a``).

2. ``par(j){ seq(i){...} }`` duplicates one sequential controller per arm;
   the pass rewrites it to ``seq(i){ par(j){...} }`` which shares a single
   controller — semantically equal in software, much cheaper in hardware.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .affine import (AExpr, Bin, Cond, ConstF, If, Load, Loop, Par, Program,
                     ReadReg, SelectC, SetReg, Stmt, Store, Un, VExpr)

# ---------------------------------------------------------------------------
# Cloning with substitution (loop-var -> expr, reg renaming)
# ---------------------------------------------------------------------------


def clone_vexpr(e: VExpr, env: Dict[str, AExpr], regmap: Dict[str, str]) -> VExpr:
    if isinstance(e, ConstF):
        return ConstF(e.value)
    if isinstance(e, Load):
        return Load(e.mem, [ix.substitute(env) for ix in e.idxs])
    if isinstance(e, ReadReg):
        return ReadReg(regmap.get(e.name, e.name))
    if isinstance(e, Bin):
        return Bin(e.op, clone_vexpr(e.a, env, regmap), clone_vexpr(e.b, env, regmap))
    if isinstance(e, Un):
        return Un(e.op, clone_vexpr(e.a, env, regmap))
    if isinstance(e, SelectC):
        return SelectC(e.cond.substitute(env),
                       clone_vexpr(e.a, env, regmap),
                       clone_vexpr(e.b, env, regmap))
    raise TypeError(e)


def clone_stmts(stmts: List[Stmt], env: Dict[str, AExpr],
                regmap: Dict[str, str]) -> List[Stmt]:
    out: List[Stmt] = []
    for s in stmts:
        if isinstance(s, Store):
            out.append(Store(s.mem, [ix.substitute(env) for ix in s.idxs],
                             clone_vexpr(s.value, env, regmap)))
        elif isinstance(s, SetReg):
            out.append(SetReg(regmap.get(s.name, s.name),
                              clone_vexpr(s.value, env, regmap)))
        elif isinstance(s, Loop):
            out.append(Loop(s.var, s.extent, clone_stmts(s.body, env, regmap),
                            kind=s.kind))
        elif isinstance(s, Par):
            out.append(Par([clone_stmts(a, env, regmap) for a in s.arms]))
        elif isinstance(s, If):
            cond = s.cond.substitute(env)
            const = cond.try_const()
            if const is True:
                out.extend(clone_stmts(s.then, env, regmap))
            elif const is False:
                out.extend(clone_stmts(s.els, env, regmap))
            else:
                out.append(If(cond, clone_stmts(s.then, env, regmap),
                              clone_stmts(s.els, env, regmap)))
        else:
            raise TypeError(s)
    return out


def assigned_regs(stmts: List[Stmt]) -> List[str]:
    regs: List[str] = []
    for s in stmts:
        if isinstance(s, SetReg) and s.name not in regs:
            regs.append(s.name)
        elif isinstance(s, Loop):
            regs += [r for r in assigned_regs(s.body) if r not in regs]
        elif isinstance(s, Par):
            for a in s.arms:
                regs += [r for r in assigned_regs(a) if r not in regs]
        elif isinstance(s, If):
            regs += [r for r in assigned_regs(s.then) + assigned_regs(s.els)
                     if r not in regs]
    return regs


# ---------------------------------------------------------------------------
# Strip-mine + unroll
# ---------------------------------------------------------------------------


def strip_count(extent: int, factor: int) -> int:
    """Bank-affine strip factor: how many arms to unroll a loop into.

    The arm count must divide ``extent`` (arms stay balanced) and must not
    exceed ``factor`` (the banking factor — more arms than banks can never
    all hit distinct banks).  Among the candidates we prefer divisors of
    ``factor``: with ``c | factor`` the unroll offsets ``0..c-1`` keep the
    *combined* offset span of nested strip-mines within one bank period,
    so every arm's accesses provably land on distinct banks (either the
    cyclic fold reaches a constant digit, or the bank-affine difference
    proof in ``estimator.banks_provably_distinct`` closes it).  When no
    nontrivial divisor of ``factor`` divides ``extent`` (e.g. extent 3,
    factor 4) we fall back to the largest divisor of ``extent`` itself —
    arms then span ``c <= factor`` consecutive offsets, still pairwise
    distinct modulo the banking factor.

    ``gcd(extent, factor)`` — the previous policy — is always a
    candidate, but it is not always the best one: gcd(6, 4) = 2 wastes
    half the banks where 3 arms are provably conflict-free.
    """
    best = 1
    for c in range(2, min(extent, factor) + 1):
        if extent % c:
            continue
        if factor % c == 0:
            best = max(best, c)
    if best == 1 and extent >= factor:
        # No divisor of the factor divides the extent: fall back to the
        # largest divisor of the extent itself (e.g. extent 6, factor 4
        # -> 3 arms at offsets {0,1,2}, pairwise distinct mod 4).  Only
        # when the extent covers the factor — stripping a short loop
        # (extent < factor) adds arms without adding distinct banks and
        # its offsets stack onto sibling strips until they wrap the bank
        # period, conflict-serializing the combined par.
        for c in range(2, min(extent, factor) + 1):
            if extent % c == 0:
                best = max(best, c)
    return best


def _is_simple_reduce(loop: Loop) -> bool:
    """Reduction loops of the form ``acc = acc (+|max|min) f(k)``."""
    if loop.kind != "reduce" or len(loop.body) != 1:
        return False
    s = loop.body[0]
    return (isinstance(s, SetReg) and isinstance(s.value, Bin)
            and s.value.op in ("add", "max", "min")
            and isinstance(s.value.a, ReadReg) and s.value.a.name == s.name)


def strip_mine_par(loop: Loop, factor: int) -> List[Stmt]:
    """Loop(j,N) -> Loop(j_o, N/c){ Par[ body[j := c*j_o + a] ] }.

    ``c`` is the bank-affine :func:`strip_count` — chosen so the unroll
    arms' address strides provably land on distinct banks of a
    factor-``factor`` cyclic partitioning (``banking.BankingSpec``).
    """
    c = strip_count(loop.extent, factor)
    if c <= 1:
        return [loop]
    outer = loop.var + "_o"
    arms: List[List[Stmt]] = []
    regs = assigned_regs(loop.body)
    for a in range(c):
        env = {loop.var: AExpr.var(outer) * c + a}
        regmap = {r: f"{r}__{loop.var}{a}" for r in regs}
        arms.append(clone_stmts(loop.body, env, regmap))
    return [Loop(outer, loop.extent // c, [Par(arms)], kind="seq")]


def strip_mine_reduce(loop: Loop, factor: int) -> List[Stmt]:
    """Cyclic reduction split with per-arm accumulators and a combine tail.

    ``for k: acc = acc + f(k)``  becomes::

        par { acc_a = 0  for each arm }
        for k_o: par { acc_a = acc_a + f(c*k_o + a) }
        acc = acc + acc_0 + ... + acc_{c-1}     (sequential combine)
    """
    c = strip_count(loop.extent, factor)
    if c <= 1 or not _is_simple_reduce(loop):
        return [loop]
    s: SetReg = loop.body[0]  # type: ignore[assignment]
    op = s.value.op  # type: ignore[union-attr]
    acc = s.name
    outer = loop.var + "_o"
    init = ConstF(0.0) if op == "add" else ConstF(-1e30 if op == "max" else 1e30)
    inits: List[List[Stmt]] = []
    arms: List[List[Stmt]] = []
    combines: List[Stmt] = []
    for a in range(c):
        arm_acc = f"{acc}__{loop.var}{a}"
        env = {loop.var: AExpr.var(outer) * c + a}
        regmap = {acc: arm_acc}
        inits.append([SetReg(arm_acc, init)])
        arms.append(clone_stmts(loop.body, env, regmap))
        combines.append(SetReg(acc, Bin(op, ReadReg(acc), ReadReg(arm_acc))))
    return [Par(inits),
            Loop(outer, loop.extent // c, [Par(arms)], kind="seq"),
            *combines]


def parallelize(prog: Program, factor: int) -> Program:
    """Strip-mine the deepest data-parallel loop and the deepest simple
    reduction loop of every nest by ``factor`` (bottom-up, so a matmul nest
    yields c^2 MAC arms after restructuring)."""
    if factor <= 1:
        return prog

    def rewrite(stmts: List[Stmt], par_budget: int) -> List[Stmt]:
        out: List[Stmt] = []
        for s in stmts:
            if isinstance(s, Loop):
                inner_has_par = any(isinstance(x, Loop) and x.kind == "par_data"
                                    for x in _descend(s.body))
                body = rewrite(s.body, par_budget)
                s = Loop(s.var, s.extent, body, kind=s.kind)
                if _is_simple_reduce_shape(s):
                    out.extend(strip_mine_reduce(s, factor))
                elif s.kind == "par_data" and not inner_has_par and par_budget > 0:
                    out.extend(strip_mine_par(s, factor))
                else:
                    out.append(s)
            elif isinstance(s, If):
                out.append(If(s.cond, rewrite(s.then, par_budget),
                              rewrite(s.els, par_budget)))
            elif isinstance(s, Par):
                out.append(Par([rewrite(a, par_budget) for a in s.arms]))
            else:
                out.append(s)
        return out

    prog = dataclasses.replace(prog, body=rewrite(prog.body, 1))
    prog.meta["parallel_factor"] = factor
    return prog


def _descend(stmts: List[Stmt]):
    for s in stmts:
        yield s
        if isinstance(s, Loop):
            yield from _descend(s.body)
        elif isinstance(s, If):
            yield from _descend(s.then)
            yield from _descend(s.els)
        elif isinstance(s, Par):
            for a in s.arms:
                yield from _descend(a)


def _is_simple_reduce_shape(loop: Loop) -> bool:
    return _is_simple_reduce(loop)


# ---------------------------------------------------------------------------
# par(seq) -> seq(par) restructuring  (paper §3.3, second transformation)
# ---------------------------------------------------------------------------


def restructure_par(par: Par,
                    _counter: Optional[List[int]] = None) -> List[Stmt]:
    """Hoist shared sequential structure out of parallel arms.

    If every arm has the same statement count and position-wise compatible
    structure (equal-extent loops at matching positions), rewrite stepwise:
    ``Par[A1;A2 | B1;B2]`` -> ``Par[A1|B1]; Par[A2|B2]`` and
    ``Par[Loop(e){a} | Loop(e){b}]`` -> ``Loop(e){ Par[a|b] }``.

    ``_counter`` numbers the fused loop variables.  It is *per invocation*
    (a fresh one is allocated when omitted, and :func:`restructure`
    threads a single counter through one whole program rewrite): a
    module-global counter would make repeated compiles in one process
    emit different ``_fuseN`` names, i.e. non-reproducible text.
    """
    counter = [0] if _counter is None else _counter
    arms = par.arms
    if len(arms) <= 1:
        return [par]
    n = len(arms[0])
    if any(len(a) != n for a in arms):
        return [par]
    out: List[Stmt] = []
    for pos in range(n):
        col = [a[pos] for a in arms]
        if all(isinstance(s, Loop) for s in col):
            loops: List[Loop] = col  # type: ignore[assignment]
            if len({(l.extent,) for l in loops}) == 1:
                counter[0] += 1
                var = f"_fuse{counter[0]}"
                bodies = []
                for l in loops:
                    env = {l.var: AExpr.var(var)}
                    bodies.append(clone_stmts(l.body, env, {}))
                inner = restructure_par(Par(bodies), counter)
                out.append(Loop(var, loops[0].extent, inner, kind="seq"))
                continue
        out.append(Par([[s] for s in col]) if len(col) > 1 else col[0])
    return out


def restructure(prog: Program, enable: bool = True) -> Program:
    """Apply the par/seq rewrite everywhere (ablatable via ``enable``)."""
    if not enable:
        return prog
    counter = [0]                 # per-invocation: reproducible _fuseN names

    def rewrite(stmts: List[Stmt]) -> List[Stmt]:
        out: List[Stmt] = []
        for s in stmts:
            if isinstance(s, Loop):
                out.append(Loop(s.var, s.extent, rewrite(s.body), kind=s.kind))
            elif isinstance(s, Par):
                arms = [rewrite(a) for a in s.arms]
                out.extend(restructure_par(Par(arms), counter))
            elif isinstance(s, If):
                out.append(If(s.cond, rewrite(s.then), rewrite(s.els)))
            else:
                out.append(s)
        return out

    return dataclasses.replace(prog, body=rewrite(prog.body))
