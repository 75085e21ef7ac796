"""Linalg-like tensor operation graph — the entry IR of the compiler.

This mirrors the role of the MLIR Linalg dialect in the paper's pipeline
(PyTorch --Allo--> Linalg).  A ``Graph`` is a list of ``TensorOp`` nodes in
topological order over named values.  Every op has a pure-jnp reference
semantics (see ``jax_backend.execute_graph``) and an affine lowering
(see ``affine.lower_graph``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

Shape = Tuple[int, ...]

# Op kinds understood by the whole pipeline.  Keep this list closed: each
# kind must have (a) a jnp reference, (b) an affine lowering.
OP_KINDS = (
    "input",      # graph input placeholder
    "param",      # trained parameter (weights/bias)
    "matmul",     # (M,K) @ (K,N) -> (M,N)
    "add",        # elementwise / broadcast-last-dim bias add
    "mul",        # elementwise multiply
    "scale",      # multiply by scalar constant
    "relu",
    "conv2d",     # (Cin,H,W) * (Cout,Cin,kh,kw) -> (Cout,H',W') unit stride
    "maxpool2d",  # (C,H,W) -> (C,H//ph,W//pw) window (ph,pw)
    "flatten",    # (…) -> (prod,)
    "reshape",
    "transpose",  # 2-D transpose
    "softmax",    # row-wise softmax over last dim of 2-D operand
    "causal_mask",# (S,S) scores -> masked scores (j<=i kept, else -inf)
)


@dataclasses.dataclass
class TensorOp:
    name: str                   # SSA value name this op defines
    kind: str
    inputs: List[str]           # names of operand values
    shape: Shape
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dtype: str = "float32"

    def __post_init__(self):
        if self.kind not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.kind!r}")


@dataclasses.dataclass
class Graph:
    """A straight-line tensor program."""

    ops: List[TensorOp] = dataclasses.field(default_factory=list)
    inputs: List[str] = dataclasses.field(default_factory=list)
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)  # name -> np.ndarray
    outputs: List[str] = dataclasses.field(default_factory=list)
    name: str = "main"

    # ---- construction helpers -------------------------------------------------
    _counter: int = 0

    def _fresh(self, stem: str) -> str:
        self._counter += 1
        return f"{stem}_{self._counter}"

    def add_op(self, kind: str, inputs: Sequence[str], shape: Shape,
               attrs: Optional[Dict[str, Any]] = None, name: Optional[str] = None) -> str:
        name = name or self._fresh(kind)
        self.ops.append(TensorOp(name=name, kind=kind, inputs=list(inputs),
                                 shape=tuple(shape), attrs=dict(attrs or {})))
        return name

    def add_input(self, name: str, shape: Shape) -> str:
        self.ops.append(TensorOp(name=name, kind="input", inputs=[], shape=tuple(shape)))
        self.inputs.append(name)
        return name

    def add_param(self, name: str, value) -> str:
        self.ops.append(TensorOp(name=name, kind="param", inputs=[], shape=tuple(value.shape)))
        self.params[name] = value
        return name

    # ---- queries ---------------------------------------------------------------
    def op(self, name: str) -> TensorOp:
        for o in self.ops:
            if o.name == name:
                return o
        raise KeyError(name)

    def shape(self, name: str) -> Shape:
        return self.op(name).shape

    def topo_check(self) -> None:
        defined = set()
        for o in self.ops:
            for i in o.inputs:
                if i not in defined:
                    raise ValueError(f"op {o.name} uses {i} before definition")
            defined.add(o.name)

    def flops(self) -> int:
        """Useful-work FLOP count (the MODEL_FLOPS analogue for §Roofline)."""
        total = 0
        for o in self.ops:
            if o.kind == "matmul":
                m, k = self.shape(o.inputs[0])
                _, n = self.shape(o.inputs[1])
                total += 2 * m * k * n
            elif o.kind == "conv2d":
                cout, h, w = o.shape
                cin, kh, kw = o.attrs["cin"], o.attrs["kh"], o.attrs["kw"]
                total += 2 * cout * h * w * cin * kh * kw
            elif o.kind in ("add", "mul", "relu", "scale"):
                total += int(prod(o.shape))
            elif o.kind == "softmax":
                total += 4 * int(prod(o.shape))
            elif o.kind == "maxpool2d":
                total += int(prod(self.shape(o.inputs[0])))
        return total


def prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


# ---------------------------------------------------------------------------
# Graph-building API used by the frontend tracer and by tests directly.
# ---------------------------------------------------------------------------

def matmul(g: Graph, a: str, b: str, name: Optional[str] = None) -> str:
    (m, k), (k2, n) = g.shape(a), g.shape(b)
    assert k == k2, f"matmul shape mismatch {g.shape(a)} @ {g.shape(b)}"
    return g.add_op("matmul", [a, b], (m, n), name=name)


def add(g: Graph, a: str, b: str) -> str:
    sa, sb = g.shape(a), g.shape(b)
    # broadcast bias over leading dims
    assert sa[-len(sb):] == sb or sa == sb, (sa, sb)
    return g.add_op("add", [a, b], sa)


def mul(g: Graph, a: str, b: str) -> str:
    assert g.shape(a) == g.shape(b)
    return g.add_op("mul", [a, b], g.shape(a))


def scale(g: Graph, a: str, c: float) -> str:
    return g.add_op("scale", [a], g.shape(a), attrs={"value": float(c)})


def relu(g: Graph, a: str) -> str:
    return g.add_op("relu", [a], g.shape(a))


def conv2d(g: Graph, x: str, w: str) -> str:
    cin, h, wd = g.shape(x)
    cout, cin2, kh, kw = g.shape(w)
    assert cin == cin2
    out = (cout, h - kh + 1, wd - kw + 1)
    return g.add_op("conv2d", [x, w], out, attrs={"cin": cin, "kh": kh, "kw": kw})


def maxpool2d(g: Graph, x: str, ph: int, pw: int) -> str:
    c, h, w = g.shape(x)
    return g.add_op("maxpool2d", [x], (c, h // ph, w // pw), attrs={"ph": ph, "pw": pw})


def flatten(g: Graph, x: str) -> str:
    return g.add_op("flatten", [x], (prod(g.shape(x)),))


def reshape(g: Graph, x: str, shape: Shape) -> str:
    assert prod(shape) == prod(g.shape(x))
    return g.add_op("reshape", [x], tuple(shape))


def transpose(g: Graph, x: str) -> str:
    m, n = g.shape(x)
    return g.add_op("transpose", [x], (n, m))


def softmax(g: Graph, x: str) -> str:
    assert len(g.shape(x)) == 2
    return g.add_op("softmax", [x], g.shape(x))


def causal_mask(g: Graph, x: str) -> str:
    s1, s2 = g.shape(x)
    assert s1 == s2
    return g.add_op("causal_mask", [x], g.shape(x))
