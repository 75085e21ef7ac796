"""Torch-like module frontend — the "PyTorch → Allo" stage of the pipeline.

Users define models with ``nn``-style modules; ``trace`` runs the module
symbolically against an input spec and records a ``tensor_ir.Graph``.  This is
deliberately a small, faithful analogue of what Allo does for PyTorch: it
preserves tensor semantics, parameter identity, and module structure (each
module becomes a named region; function calls become graph sub-regions, the
analogue of the paper's "functions become Calyx components").
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import tensor_ir as T


class Value:
    """Symbolic tensor value flowing through the tracer."""

    def __init__(self, graph: T.Graph, name: str):
        self.graph = graph
        self.name = name

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.graph.shape(self.name)

    def __matmul__(self, other: "Value") -> "Value":
        return Value(self.graph, T.matmul(self.graph, self.name, other.name))

    def __add__(self, other: "Value") -> "Value":
        return Value(self.graph, T.add(self.graph, self.name, other.name))

    def __mul__(self, other) -> "Value":
        if isinstance(other, (int, float)):
            return Value(self.graph, T.scale(self.graph, self.name, other))
        return Value(self.graph, T.mul(self.graph, self.name, other.name))

    def t(self) -> "Value":
        return Value(self.graph, T.transpose(self.graph, self.name))


class Module:
    """Base class.  Subclasses define ``forward`` over ``Value``s."""

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):  # pragma: no cover - abstract
        raise NotImplementedError

    def named_parameters(self, prefix: str = ""):
        for k, v in vars(self).items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, np.ndarray):
                yield path, v
            elif isinstance(v, Module):
                yield from v.named_parameters(path)
            elif isinstance(v, (list, tuple)):
                for i, item in enumerate(v):
                    if isinstance(item, Module):
                        yield from item.named_parameters(f"{path}.{i}")


def _kaiming(rng: np.random.Generator, fan_in: int, shape) -> np.ndarray:
    bound = math.sqrt(1.0 / max(fan_in, 1))
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


class Linear(Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(0)
        self.weight = _kaiming(rng, in_features, (in_features, out_features))
        self.bias = _kaiming(rng, in_features, (out_features,)) if bias else None

    def forward(self, x: Value) -> Value:
        g = x.graph
        w = Value(g, g.add_param(g._fresh("w"), self.weight))
        out = x @ w
        if self.bias is not None:
            b = Value(g, g.add_param(g._fresh("b"), self.bias))
            out = out + b
        return out


class ReLU(Module):
    def forward(self, x: Value) -> Value:
        return Value(x.graph, T.relu(x.graph, x.name))


class Conv2d(Module):
    """Unit-stride valid conv over (Cin,H,W) inputs."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int,
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(0)
        self.weight = _kaiming(rng, cin * kh * kw, (cout, cin, kh, kw))

    def forward(self, x: Value) -> Value:
        g = x.graph
        w = Value(g, g.add_param(g._fresh("convw"), self.weight))
        return Value(g, T.conv2d(g, x.name, w.name))


class MaxPool2d(Module):
    def __init__(self, ph: int, pw: int):
        self.ph, self.pw = ph, pw

    def forward(self, x: Value) -> Value:
        return Value(x.graph, T.maxpool2d(x.graph, x.name, self.ph, self.pw))


class Flatten(Module):
    def forward(self, x: Value) -> Value:
        return Value(x.graph, T.flatten(x.graph, x.name))


class Softmax(Module):
    def forward(self, x: Value) -> Value:
        return Value(x.graph, T.softmax(x.graph, x.name))


class Sequential(Module):
    def __init__(self, *mods: Module):
        self.mods = list(mods)

    def forward(self, x: Value) -> Value:
        for m in self.mods:
            x = m(x)
        return x


class MultiheadAttention(Module):
    """Causal MHA over a (S, D) sequence — the paper's MHA benchmark shape.

    ``heads`` heads each over a D/heads subspace, with causal masking.
    """

    def __init__(self, embed_dim: int, num_heads: int,
                 rng: Optional[np.random.Generator] = None):
        assert embed_dim % num_heads == 0
        rng = rng or np.random.default_rng(0)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.wq = Linear(embed_dim, embed_dim, bias=False, rng=rng)
        self.wk = Linear(embed_dim, embed_dim, bias=False, rng=rng)
        self.wv = Linear(embed_dim, embed_dim, bias=False, rng=rng)
        self.wo = Linear(embed_dim, embed_dim, bias=False, rng=rng)

    def forward(self, x: Value) -> Value:
        g = x.graph
        s, d = x.shape
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        head_outs: List[Value] = []
        hd = self.head_dim
        for h in range(self.num_heads):
            # slice head h: implemented as matmul with a selector param so the
            # whole program stays inside the closed op set (as Allo would
            # materialize a view).
            sel = np.zeros((d, hd), dtype=np.float32)
            sel[h * hd:(h + 1) * hd, :] = np.eye(hd, dtype=np.float32)
            selv = Value(g, g.add_param(g._fresh(f"sel{h}"), sel))
            qh, kh, vh = q @ selv, k @ selv, v @ selv
            scores = qh @ kh.t()
            scores = scores * (1.0 / math.sqrt(hd))
            masked = Value(g, T.causal_mask(g, scores.name))
            probs = Value(g, T.softmax(g, masked.name))
            head_outs.append(probs @ vh)
        # concat heads via selector transposes: out = sum_h head_h @ sel_h^T
        acc = None
        for h, ho in enumerate(head_outs):
            sel = np.zeros((hd, d), dtype=np.float32)
            sel[:, h * hd:(h + 1) * hd] = np.eye(hd, dtype=np.float32)
            selv = Value(g, g.add_param(g._fresh(f"cat{h}"), sel))
            part = ho @ selv
            acc = part if acc is None else acc + part
        return self.wo(acc)


def trace(module: Module, input_shapes: Sequence[Tuple[int, ...]],
          name: str = "main") -> T.Graph:
    """Run ``module`` symbolically and return the recorded Graph."""
    g = T.Graph(name=name)
    vals = []
    for i, shp in enumerate(input_shapes):
        nm = g.add_input(f"arg{i}", shp)
        vals.append(Value(g, nm))
    out = module(*vals)
    outs = out if isinstance(out, (list, tuple)) else [out]
    g.outputs = [o.name for o in outs]
    g.topo_check()
    return g


# ---------------------------------------------------------------------------
# The paper's three benchmark models (§4.1), exactly as specified.
# ---------------------------------------------------------------------------

def paper_ffnn(rng_seed: int = 0) -> Module:
    """64 features -> FC 64x48 -> ReLU -> FC 48x4."""
    rng = np.random.default_rng(rng_seed)
    return Sequential(Linear(64, 48, rng=rng), ReLU(), Linear(48, 4, rng=rng))


def paper_cnn(rng_seed: int = 0) -> Module:
    """80x60x3 image -> conv 5x5 (3->8) -> ReLU -> maxpool 2x3 -> FC -> 2."""
    rng = np.random.default_rng(rng_seed)
    h, w = 80 - 5 + 1, 60 - 5 + 1          # 76 x 56 valid conv
    flat = 8 * (h // 2) * (w // 3)         # pool 2x3
    return Sequential(Conv2d(3, 8, 5, 5, rng=rng), ReLU(), MaxPool2d(2, 3),
                      Flatten(), _RowVec(), Linear(flat, 2, rng=rng))


class _RowVec(Module):
    """(N,) -> (1, N) so flattened features can feed a Linear."""

    def forward(self, x: Value) -> Value:
        n = x.shape[0]
        return Value(x.graph, T.reshape(x.graph, x.name, (1, n)))


def paper_mha(rng_seed: int = 0, seq_len: int = 8) -> Module:
    """2 heads over 21-dim subspaces of a 42-dim embedding, causal."""
    rng = np.random.default_rng(rng_seed)
    return MultiheadAttention(42, 2, rng=rng)
