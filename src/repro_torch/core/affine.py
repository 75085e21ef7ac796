"""Affine loop-nest IR — the "Linalg → Affine/SCF/Memref" stage.

The IR models what the paper lowers through MLIR: perfect/imperfect loop
nests over multi-dimensional memories with affine accesses, scalar registers
for reductions, structured `if` (the paper's added SCF support), and explicit
`par` blocks (Calyx's first-class parallel control).

The affine-expression engine is the heart of the banking pass: expressions
are kept in a canonical linear form over *atoms* (loop variables or opaque
``div``/``mod`` terms) so that after par-unrolling substitutes constants,
``(c*ii + j) % c`` folds to ``j`` and ``(c*ii + j) // c`` folds to ``ii`` —
exactly the compile-time-constant bank index the paper relies on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# Affine expressions (integer domain)
# ---------------------------------------------------------------------------


class Atom:
    """Base for linear-combination atoms."""

    def key(self) -> tuple:  # pragma: no cover - abstract
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Var(Atom):
    name: str

    def key(self):
        return ("var", self.name)

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class DivAtom(Atom):
    """floor(inner / c) that did not fold."""
    inner: "AExpr"
    c: int

    def key(self):
        return ("div", self.inner.key(), self.c)

    def __repr__(self):
        return f"({self.inner} // {self.c})"


@dataclasses.dataclass(frozen=True)
class ModAtom(Atom):
    """inner mod c that did not fold."""
    inner: "AExpr"
    c: int

    def key(self):
        return ("mod", self.inner.key(), self.c)

    def __repr__(self):
        return f"({self.inner} % {self.c})"


class AExpr:
    """Canonical affine expression: sum(coeff * atom) + const.

    Structurally hashable so that identical div/mod atoms built in different
    par-arm clones merge during algebra (required for the disjointness proof:
    ``(bank+1) - bank`` must fold to the constant 1).
    """

    __slots__ = ("coeffs", "const", "_key", "_free")

    def __init__(self, coeffs: Optional[Dict[Atom, int]] = None, const: int = 0):
        self.coeffs = {a: c for a, c in (coeffs or {}).items() if c != 0}
        self.const = int(const)
        self._key = None
        self._free = None

    def __eq__(self, other):
        return isinstance(other, AExpr) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    # -- constructors --------------------------------------------------------
    @staticmethod
    def const_(v: int) -> "AExpr":
        return AExpr({}, v)

    @staticmethod
    def var(name: str) -> "AExpr":
        return AExpr({Var(name): 1}, 0)

    # -- algebra ---------------------------------------------------------------
    def __add__(self, other: Union["AExpr", int]) -> "AExpr":
        other = _as_aexpr(other)
        coeffs = dict(self.coeffs)
        for a, c in other.coeffs.items():
            coeffs[a] = coeffs.get(a, 0) + c
        return AExpr(coeffs, self.const + other.const)

    def __sub__(self, other: Union["AExpr", int]) -> "AExpr":
        return self + (_as_aexpr(other) * -1)

    def __mul__(self, k: int) -> "AExpr":
        return AExpr({a: c * k for a, c in self.coeffs.items()}, self.const * k)

    def floordiv(self, c: int) -> "AExpr":
        assert c > 0
        if c == 1:
            return self
        if not self.coeffs:
            return AExpr.const_(self.const // c)
        if all(co % c == 0 for co in self.coeffs.values()):
            # c*L + k  -->  L + k//c   (exact because c*L is divisible)
            return AExpr({a: co // c for a, co in self.coeffs.items()},
                         self.const // c)
        return AExpr({DivAtom(self, c): 1}, 0)

    def mod(self, c: int) -> "AExpr":
        assert c > 0
        if c == 1:
            return AExpr.const_(0)
        if not self.coeffs:
            return AExpr.const_(self.const % c)
        if all(co % c == 0 for co in self.coeffs.values()):
            return AExpr.const_(self.const % c)
        return AExpr({ModAtom(self, c): 1}, 0)

    # -- queries ---------------------------------------------------------------
    def is_const(self) -> bool:
        return not self.coeffs

    def const_value(self) -> int:
        assert self.is_const(), f"{self} is not constant"
        return self.const

    def atoms(self) -> List[Atom]:
        return list(self.coeffs)

    def has_divmod(self) -> bool:
        """True if any non-folded div/mod survives anywhere inside."""
        for a in self.coeffs:
            if isinstance(a, (DivAtom, ModAtom)):
                return True
            # Vars are leaves.
        return False

    def free_vars(self) -> frozenset:
        if self._free is None:
            out = set()
            for a in self.coeffs:
                if isinstance(a, Var):
                    out.add(a.name)
                else:
                    out |= a.inner.free_vars()
            self._free = frozenset(out)
        return self._free

    def key(self) -> tuple:
        if self._key is None:
            self._key = (tuple(sorted((a.key(), c)
                                      for a, c in self.coeffs.items())),
                         self.const)
        return self._key

    def substitute(self, env: Dict[str, "AExpr"]) -> "AExpr":
        """Substitute vars and re-canonicalize (refolds div/mod)."""
        out = AExpr.const_(self.const)
        for a, co in self.coeffs.items():
            if isinstance(a, Var):
                repl = env.get(a.name)
                term = (repl if repl is not None else AExpr({a: 1})) * co
            elif isinstance(a, DivAtom):
                term = a.inner.substitute(env).floordiv(a.c) * co
            else:
                term = a.inner.substitute(env).mod(a.c) * co
            out = out + term
        return out

    def evaluate(self, env: Dict[str, int]) -> int:
        total = self.const
        for a, co in self.coeffs.items():
            if isinstance(a, Var):
                total += co * env[a.name]
            elif isinstance(a, DivAtom):
                total += co * (a.inner.evaluate(env) // a.c)
            else:
                total += co * (a.inner.evaluate(env) % a.c)
        return total

    def divmod_count(self) -> int:
        """Number of surviving div/mod operations (each costs hardware)."""
        n = 0
        for a in self.coeffs:
            if isinstance(a, (DivAtom, ModAtom)):
                n += 1 + a.inner.divmod_count()
        return n

    def mul_count(self) -> int:
        """Number of non-trivial integer multiplies to materialize this."""
        n = sum(1 for a, co in self.coeffs.items() if co not in (1, -1))
        for a in self.coeffs:
            if isinstance(a, (DivAtom, ModAtom)):
                n += a.inner.mul_count()
        return n

    def __repr__(self):
        parts = [f"{c}*{a}" if c != 1 else f"{a}" for a, c in self.coeffs.items()]
        if self.const or not parts:
            parts.append(str(self.const))
        return " + ".join(parts)


def _as_aexpr(v: Union[AExpr, int]) -> AExpr:
    return v if isinstance(v, AExpr) else AExpr.const_(v)


@dataclasses.dataclass
class Cond:
    """Affine condition  lhs <op> 0  (canonicalized)."""
    op: str            # 'le', 'lt', 'eq', 'ge', 'gt'
    expr: AExpr        # compare expr against 0

    @staticmethod
    def cmp(lhs: AExpr, op: str, rhs: Union[AExpr, int]) -> "Cond":
        return Cond(op, lhs - _as_aexpr(rhs))

    def evaluate(self, env: Dict[str, int]) -> bool:
        v = self.expr.evaluate(env)
        return {"le": v <= 0, "lt": v < 0, "eq": v == 0,
                "ge": v >= 0, "gt": v > 0}[self.op]

    def substitute(self, env: Dict[str, AExpr]) -> "Cond":
        return Cond(self.op, self.expr.substitute(env))

    def try_const(self) -> Optional[bool]:
        if self.expr.is_const():
            return self.evaluate({})
        return None

    def __repr__(self):
        sym = {"le": "<=", "lt": "<", "eq": "==", "ge": ">=", "gt": ">"}[self.op]
        return f"({self.expr} {sym} 0)"


# ---------------------------------------------------------------------------
# Value (float-domain) expressions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VExpr:
    pass


@dataclasses.dataclass
class ConstF(VExpr):
    value: float


@dataclasses.dataclass
class Load(VExpr):
    mem: str
    idxs: List[AExpr]


@dataclasses.dataclass
class ReadReg(VExpr):
    name: str


@dataclasses.dataclass
class Bin(VExpr):
    op: str   # add sub mul div max min
    a: VExpr
    b: VExpr


@dataclasses.dataclass
class Un(VExpr):
    op: str   # exp relu neg
    a: VExpr


@dataclasses.dataclass
class SelectC(VExpr):
    """cond ? a : b — hardware instantiates both sides plus a mux."""
    cond: Cond
    a: VExpr
    b: VExpr


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Stmt:
    pass


@dataclasses.dataclass
class Store(Stmt):
    mem: str
    idxs: List[AExpr]
    value: VExpr


@dataclasses.dataclass
class SetReg(Stmt):
    name: str
    value: VExpr


@dataclasses.dataclass
class Loop(Stmt):
    var: str
    extent: int
    body: List[Stmt]
    kind: str = "seq"    # 'seq' | 'par_data' | 'reduce'


@dataclasses.dataclass
class Par(Stmt):
    """Explicit parallel arms (Calyx `par`). Arms must be hazard-free."""
    arms: List[List[Stmt]]


@dataclasses.dataclass
class If(Stmt):
    cond: Cond
    then: List[Stmt]
    els: List[Stmt] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MemDecl:
    name: str
    shape: Tuple[int, ...]
    role: str = "temp"         # input | param | temp | output
    banks: Tuple[int, ...] = ()  # set by the banking pass; () = unbanked

    @property
    def size(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out


@dataclasses.dataclass
class Program:
    name: str
    mems: Dict[str, MemDecl]
    body: List[Stmt]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def mem(self, name: str) -> MemDecl:
        return self.mems[name]


# ---------------------------------------------------------------------------
# Lowering: tensor Graph -> affine Program
# ---------------------------------------------------------------------------

from . import tensor_ir as T  # noqa: E402  (cycle-free: tensor_ir has no deps)


class _Lowerer:
    def __init__(self, graph: T.Graph):
        self.g = graph
        self.prog = Program(graph.name, {}, [])
        self._reg = 0

    def fresh_reg(self, stem="r") -> str:
        self._reg += 1
        return f"{stem}{self._reg}"

    def declare(self, name: str, shape, role: str):
        self.prog.mems[name] = MemDecl(name, tuple(shape), role)

    def run(self) -> Program:
        out_set = set(self.g.outputs)
        for op in self.g.ops:
            role = ("input" if op.kind == "input" else
                    "param" if op.kind == "param" else
                    "output" if op.name in out_set else "temp")
            self.declare(op.name, op.shape, role)
            fn = getattr(self, f"lower_{op.kind}", None)
            if fn is None:
                raise NotImplementedError(op.kind)
            fn(op)
        self.prog.meta["useful_flops"] = self.g.flops()
        return self.prog

    # -- per-op lowerings ------------------------------------------------------
    def lower_input(self, op):
        pass

    def lower_param(self, op):
        pass

    def _loopvars(self, op, dims: int) -> List[str]:
        return [f"{op.name}_i{d}" for d in range(dims)]

    def lower_matmul(self, op):
        a, b = op.inputs
        m, k = self.g.shape(a)
        _, n = self.g.shape(b)
        i, j, kk = self._loopvars(op, 3)
        acc = self.fresh_reg("acc")
        iv, jv, kv = AExpr.var(i), AExpr.var(j), AExpr.var(kk)
        inner = [SetReg(acc, Bin("add", ReadReg(acc),
                                 Bin("mul", Load(a, [iv, kv]), Load(b, [kv, jv]))))]
        body_j = [SetReg(acc, ConstF(0.0)),
                  Loop(kk, k, inner, kind="reduce"),
                  Store(op.name, [iv, jv], ReadReg(acc))]
        self.prog.body.append(
            Loop(i, m, [Loop(j, n, body_j, kind="par_data")], kind="par_data"))

    def lower_add(self, op):
        a, b = op.inputs
        sa, sb = self.g.shape(a), self.g.shape(b)
        vs = self._loopvars(op, len(sa))
        idx = [AExpr.var(v) for v in vs]
        bidx = idx[len(sa) - len(sb):] if sa != sb else idx
        body = [Store(op.name, idx, Bin("add", Load(a, idx), Load(b, bidx)))]
        self.prog.body.append(_nest(vs, sa, body, inner_par=True))

    def lower_mul(self, op):
        a, b = op.inputs
        sa = self.g.shape(a)
        vs = self._loopvars(op, len(sa))
        idx = [AExpr.var(v) for v in vs]
        body = [Store(op.name, idx, Bin("mul", Load(a, idx), Load(b, idx)))]
        self.prog.body.append(_nest(vs, sa, body, inner_par=True))

    def lower_scale(self, op):
        a = op.inputs[0]
        sa = self.g.shape(a)
        vs = self._loopvars(op, len(sa))
        idx = [AExpr.var(v) for v in vs]
        body = [Store(op.name, idx,
                      Bin("mul", Load(a, idx), ConstF(op.attrs["value"])))]
        self.prog.body.append(_nest(vs, sa, body, inner_par=True))

    def lower_relu(self, op):
        a = op.inputs[0]
        sa = self.g.shape(a)
        vs = self._loopvars(op, len(sa))
        idx = [AExpr.var(v) for v in vs]
        body = [Store(op.name, idx, Un("relu", Load(a, idx)))]
        self.prog.body.append(_nest(vs, sa, body, inner_par=True))

    def lower_conv2d(self, op):
        x, w = op.inputs
        cout, oh, ow = op.shape
        cin, kh, kw = op.attrs["cin"], op.attrs["kh"], op.attrs["kw"]
        co, oy, ox, ci, ky, kx = self._loopvars(op, 6)
        acc = self.fresh_reg("cacc")
        cov, oyv, oxv = AExpr.var(co), AExpr.var(oy), AExpr.var(ox)
        civ, kyv, kxv = AExpr.var(ci), AExpr.var(ky), AExpr.var(kx)
        mac = [SetReg(acc, Bin("add", ReadReg(acc),
                               Bin("mul",
                                   Load(x, [civ, oyv + kyv, oxv + kxv]),
                                   Load(w, [cov, civ, kyv, kxv]))))]
        red = Loop(ci, cin, [Loop(ky, kh, [Loop(kx, kw, mac, kind="reduce")])])
        body = [SetReg(acc, ConstF(0.0)), red,
                Store(op.name, [cov, oyv, oxv], ReadReg(acc))]
        self.prog.body.append(
            Loop(co, cout,
                 [Loop(oy, oh, [Loop(ox, ow, body, kind="par_data")])],
                 kind="par_data"))

    def lower_maxpool2d(self, op):
        x = op.inputs[0]
        c, oh, ow = op.shape
        ph, pw = op.attrs["ph"], op.attrs["pw"]
        cv_, yv_, xv_, py_, px_ = self._loopvars(op, 5)
        m = self.fresh_reg("mx")
        cv, yv, xv = AExpr.var(cv_), AExpr.var(yv_), AExpr.var(xv_)
        pyv, pxv = AExpr.var(py_), AExpr.var(px_)
        mac = [SetReg(m, Bin("max", ReadReg(m),
                             Load(x, [cv, yv * ph + pyv, xv * pw + pxv])))]
        red = Loop(py_, ph, [Loop(px_, pw, mac, kind="reduce")])
        body = [SetReg(m, ConstF(-1e30)), red,
                Store(op.name, [cv, yv, xv], ReadReg(m))]
        self.prog.body.append(
            Loop(cv_, c, [Loop(yv_, oh, [Loop(xv_, ow, body, kind="par_data")])],
                 kind="par_data"))

    def lower_flatten(self, op):
        x = op.inputs[0]
        sx = self.g.shape(x)
        vs = self._loopvars(op, len(sx))
        idx = [AExpr.var(v) for v in vs]
        # linearize: exercises the address arithmetic the paper highlights
        lin = AExpr.const_(0)
        stride = 1
        for d in reversed(range(len(sx))):
            lin = lin + idx[d] * stride
            stride *= sx[d]
        body = [Store(op.name, [lin], Load(x, idx))]
        self.prog.body.append(_nest(vs, sx, body, inner_par=True))

    def lower_reshape(self, op):
        x = op.inputs[0]
        sx, so = self.g.shape(x), op.shape
        vs = self._loopvars(op, len(sx))
        idx = [AExpr.var(v) for v in vs]
        lin = AExpr.const_(0)
        stride = 1
        for d in reversed(range(len(sx))):
            lin = lin + idx[d] * stride
            stride *= sx[d]
        oidx = []
        rem = lin
        strides_o = []
        s = 1
        for d in reversed(range(len(so))):
            strides_o.insert(0, s)
            s *= so[d]
        for d in range(len(so)):
            oidx.append(rem.floordiv(strides_o[d]).mod(so[d]) if d > 0
                        else rem.floordiv(strides_o[d]))
        body = [Store(op.name, oidx, Load(x, idx))]
        self.prog.body.append(_nest(vs, sx, body, inner_par=True))

    def lower_transpose(self, op):
        x = op.inputs[0]
        m, n = self.g.shape(x)
        i, j = self._loopvars(op, 2)
        iv, jv = AExpr.var(i), AExpr.var(j)
        body = [Store(op.name, [jv, iv], Load(x, [iv, jv]))]
        self.prog.body.append(
            Loop(i, m, [Loop(j, n, body, kind="par_data")], kind="par_data"))

    def lower_softmax(self, op):
        x = op.inputs[0]
        m, n = self.g.shape(x)
        etmp = op.name + "_e"
        self.declare(etmp, (m, n), "temp")
        i, j1, j2, j3 = self._loopvars(op, 4)
        iv = AExpr.var(i)
        mx, s, e = self.fresh_reg("smax"), self.fresh_reg("ssum"), self.fresh_reg("se")
        body_i = [
            SetReg(mx, ConstF(-1e30)),
            Loop(j1, n, [SetReg(mx, Bin("max", ReadReg(mx),
                                        Load(x, [iv, AExpr.var(j1)])))],
                 kind="reduce"),
            SetReg(s, ConstF(0.0)),
            Loop(j2, n, [SetReg(e, Un("exp", Bin("sub", Load(x, [iv, AExpr.var(j2)]),
                                                 ReadReg(mx)))),
                         Store(etmp, [iv, AExpr.var(j2)], ReadReg(e)),
                         SetReg(s, Bin("add", ReadReg(s), ReadReg(e)))],
                 kind="reduce"),
            Loop(j3, n, [Store(op.name, [iv, AExpr.var(j3)],
                               Bin("div", Load(etmp, [iv, AExpr.var(j3)]),
                                   ReadReg(s)))],
                 kind="par_data"),
        ]
        self.prog.body.append(Loop(i, m, body_i, kind="par_data"))

    def lower_causal_mask(self, op):
        x = op.inputs[0]
        s1, _ = self.g.shape(x)
        i, j = self._loopvars(op, 2)
        iv, jv = AExpr.var(i), AExpr.var(j)
        # if j <= i: y = x else: y = -1e30   (exercises the SCF `if` support)
        body = [If(Cond.cmp(jv, "le", iv),
                   [Store(op.name, [iv, jv], Load(x, [iv, jv]))],
                   [Store(op.name, [iv, jv], ConstF(-1e30))])]
        self.prog.body.append(
            Loop(i, s1, [Loop(j, s1, body, kind="par_data")], kind="par_data"))


def _nest(vars_: Sequence[str], extents: Sequence[int], body: List[Stmt],
          inner_par: bool = False) -> Stmt:
    """Build a loop nest; innermost loop optionally data-parallel."""
    stmt: List[Stmt] = body
    out: Optional[Loop] = None
    for d in reversed(range(len(vars_))):
        kind = "par_data" if (inner_par and d == len(vars_) - 1) else "par_data"
        out = Loop(vars_[d], int(extents[d]), stmt, kind=kind)
        stmt = [out]
    return out if out is not None else Loop("_z", 1, body)


def lower_graph(graph: T.Graph) -> Program:
    return _Lowerer(graph).run()


# ---------------------------------------------------------------------------
# Cyclic-banked layout pack/unpack (numpy) — the data movement a host would
# perform when staging tensors into banked accelerator memories.
# ---------------------------------------------------------------------------


def pack_banked(arr: np.ndarray, factors: Sequence[int]) -> np.ndarray:
    """(s0,…) -> (prod(f), ceil(s0/f0),…) with cyclic interleave per dim."""
    shape = arr.shape
    intra = tuple(-(-s // f) for s, f in zip(shape, factors))
    nbanks = 1
    for f in factors:
        nbanks *= f
    out = np.zeros((nbanks,) + intra, dtype=arr.dtype)
    strides = []
    s = 1
    for f in reversed(factors):
        strides.insert(0, s)
        s *= f
    import itertools
    for combo in itertools.product(*[range(f) for f in factors]):
        bank = sum(b * st for b, st in zip(combo, strides))
        sl = tuple(slice(b, None, f) for b, f in zip(combo, factors))
        piece = arr[sl]
        dst = tuple(slice(0, piece.shape[d]) for d in range(len(shape)))
        out[(bank,) + dst] = piece
    return out


def unpack_banked(banked: np.ndarray, orig_shape: Sequence[int],
                  factors: Sequence[int]) -> np.ndarray:
    out = np.zeros(tuple(orig_shape), dtype=banked.dtype)
    strides = []
    s = 1
    for f in reversed(factors):
        strides.insert(0, s)
        s *= f
    import itertools
    for combo in itertools.product(*[range(f) for f in factors]):
        bank = sum(b * st for b, st in zip(combo, strides))
        sl = tuple(slice(b, None, f) for b, f in zip(combo, factors))
        out[sl] = banked[(bank,) + tuple(
            slice(0, out[sl].shape[d]) for d in range(len(orig_shape)))]
    return out


# ---------------------------------------------------------------------------
# Reference interpreter (numpy) — the oracle for every downstream pass.
# ---------------------------------------------------------------------------


def interpret(prog: Program, inputs: Dict[str, np.ndarray],
              params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    orig_shapes = prog.meta.get("orig_shapes", {})
    mems: Dict[str, np.ndarray] = {}
    for name, decl in prog.mems.items():
        if decl.role in ("input", "param"):
            src = inputs[name] if decl.role == "input" else params[name]
            arr = np.asarray(src, dtype=np.float64)
            if decl.banks:
                arr = pack_banked(arr.reshape(orig_shapes[name]), decl.banks)
            else:
                arr = arr.reshape(decl.shape)
        else:
            arr = np.zeros(decl.shape, dtype=np.float64)
        mems[name] = arr.copy()
    regs: Dict[str, float] = {}

    def veval(e: VExpr, env: Dict[str, int]) -> float:
        if isinstance(e, ConstF):
            return e.value
        if isinstance(e, Load):
            idx = tuple(ix.evaluate(env) for ix in e.idxs)
            return float(mems[e.mem][idx])
        if isinstance(e, ReadReg):
            return regs[e.name]
        if isinstance(e, Bin):
            a, b = veval(e.a, env), veval(e.b, env)
            if e.op == "add":
                return a + b
            if e.op == "sub":
                return a - b
            if e.op == "mul":
                return a * b
            if e.op == "div":
                return a / b
            if e.op == "max":
                return max(a, b)
            return min(a, b)
        if isinstance(e, Un):
            a = veval(e.a, env)
            return {"exp": math.exp(min(a, 700.0)), "relu": max(a, 0.0),
                    "neg": -a}[e.op]
        if isinstance(e, SelectC):
            return veval(e.a, env) if e.cond.evaluate(env) else veval(e.b, env)
        raise TypeError(e)

    def run(stmts: List[Stmt], env: Dict[str, int]):
        for s in stmts:
            if isinstance(s, Store):
                idx = tuple(ix.evaluate(env) for ix in s.idxs)
                mems[s.mem][idx] = veval(s.value, env)
            elif isinstance(s, SetReg):
                regs[s.name] = veval(s.value, env)
            elif isinstance(s, Loop):
                for v in range(s.extent):
                    env2 = dict(env)
                    env2[s.var] = v
                    run(s.body, env2)
            elif isinstance(s, Par):
                for arm in s.arms:   # sequential emulation of par is safe
                    run(arm, env)    # iff arms are hazard-free (checked by pass)
            elif isinstance(s, If):
                run(s.then if s.cond.evaluate(env) else s.els, env)
            else:
                raise TypeError(s)

    run(prog.body, {})
    return mems


# ---------------------------------------------------------------------------
# Structural helpers shared by the passes
# ---------------------------------------------------------------------------


def walk_statements(stmts: List[Stmt]):
    for s in stmts:
        yield s
        if isinstance(s, Loop):
            yield from walk_statements(s.body)
        elif isinstance(s, Par):
            for arm in s.arms:
                yield from walk_statements(arm)
        elif isinstance(s, If):
            yield from walk_statements(s.then)
            yield from walk_statements(s.els)


def value_loads(e: VExpr):
    if isinstance(e, Load):
        yield e
    elif isinstance(e, Bin):
        yield from value_loads(e.a)
        yield from value_loads(e.b)
    elif isinstance(e, Un):
        yield from value_loads(e.a)
    elif isinstance(e, SelectC):
        yield from value_loads(e.a)
        yield from value_loads(e.b)


def stmt_accesses(s: Stmt):
    """Yield (mem, idxs, is_store) for a single non-compound statement."""
    if isinstance(s, Store):
        yield (s.mem, s.idxs, True)
        for ld in value_loads(s.value):
            yield (ld.mem, ld.idxs, False)
    elif isinstance(s, SetReg):
        for ld in value_loads(s.value):
            yield (ld.mem, ld.idxs, False)
