"""Pure-torch reference executor for tensor graphs — the correctness oracle.

Port of ``repro.core.jax_backend``: the same twelve op kinds with the same
semantics (VALID NCHW/OIHW convolution, floor-cropped max pooling, causal
fill of ``-1e30``).  Every downstream stage (affine lowering, banking,
scheduling) must agree with this executor up to float tolerance.  Runs on
``cuda`` unless ``device="cpu"`` is passed; float32 convolutions and
products run in full float32 (no TF32) on the card.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import tensor_ir as T
from ..device import DeviceLike, full_f32, resolve_device


def _op_fn(op: T.TensorOp, env: Dict[str, torch.Tensor],
           graph: T.Graph) -> torch.Tensor:
    ins = [env[i] for i in op.inputs]
    k = op.kind
    if k == "matmul":
        return ins[0] @ ins[1]
    if k == "add":
        return ins[0] + ins[1]
    if k == "mul":
        return ins[0] * ins[1]
    if k == "scale":
        return ins[0] * op.attrs["value"]
    if k == "relu":
        return torch.clamp_min(ins[0], 0.0)
    if k == "conv2d":
        x, w = ins  # (Cin,H,W), (Cout,Cin,kh,kw)
        return F.conv2d(x[None], w, stride=1, padding=0)[0]
    if k == "maxpool2d":
        ph, pw = op.attrs["ph"], op.attrs["pw"]
        x = ins[0]
        c, h, w = x.shape
        x = x[:, : (h // ph) * ph, : (w // pw) * pw]
        x = x.reshape(c, h // ph, ph, w // pw, pw)
        return x.amax(dim=(2, 4))
    if k == "flatten":
        return ins[0].reshape(-1)
    if k == "reshape":
        return ins[0].reshape(op.shape)
    if k == "transpose":
        return ins[0].t()
    if k == "softmax":
        return torch.softmax(ins[0], dim=-1)
    if k == "causal_mask":
        s = ins[0].shape[0]
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=ins[0].device))
        return torch.where(mask, ins[0], -1e30)
    raise NotImplementedError(k)


def to_tensor(x, device: torch.device) -> torch.Tensor:
    """An input or weight as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def params_to_torch(params: Mapping[str, np.ndarray], device: DeviceLike,
                    graph: T.Graph) -> Dict[str, torch.Tensor]:
    """Carry weights (name -> array), e.g. the reference graph's ``params``,
    onto ``device`` as float32 for ``graph``.

    The names must be exactly the graph's ``param`` ops and each shape must
    match its op; a mismatch raises ``ValueError``.
    """
    dev = resolve_device(device)
    want = {op.name: tuple(op.shape) for op in graph.ops if op.kind == "param"}
    if set(want) != set(params):
        raise ValueError(f"graph {graph.name!r} takes params {sorted(want)}; "
                         f"got {sorted(params)}")
    for name, shape in want.items():
        got = tuple(np.shape(params[name]))
        if got != shape:
            raise ValueError(f"param {name!r} has shape {got}, expected {shape}")
    return {name: to_tensor(v, dev) for name, v in params.items()}


class GraphModule(torch.nn.Module):
    """A traced graph as an ``nn.Module``; its params are buffers."""

    def __init__(self, graph: T.Graph, params: Dict[str, torch.Tensor],
                 device: torch.device):
        super().__init__()
        self.graph, self.device = graph, device
        for name, value in params.items():
            self.register_buffer(name, value)

    def forward(self, inputs: Mapping[str, object]) -> List[torch.Tensor]:
        env: Dict[str, torch.Tensor] = {}
        with full_f32():
            for op in self.graph.ops:
                if op.kind == "input":
                    env[op.name] = to_tensor(inputs[op.name], self.device)
                elif op.kind == "param":
                    env[op.name] = self._buffers[op.name]
                else:
                    env[op.name] = _op_fn(op, env, self.graph)
        return [env[o] for o in self.graph.outputs]


def as_torch_fn(graph: T.Graph, device: DeviceLike = None,
                params: Optional[Mapping[str, np.ndarray]] = None
                ) -> GraphModule:
    """Return an ``nn.Module`` computing ``graph``: module(inputs) -> outputs.

    The weights are ``graph.params`` unless ``params`` (e.g. the reference
    graph's) is given; they are checked against the graph's param ops.
    """
    dev = resolve_device(device)
    weights = params_to_torch(graph.params if params is None else params,
                              dev, graph)
    return GraphModule(graph, weights, dev)


def execute_graph(graph: T.Graph, inputs: Mapping[str, np.ndarray],
                  device: DeviceLike = None) -> List[np.ndarray]:
    mod = as_torch_fn(graph, device)
    return [o.cpu().numpy() for o in mod(inputs)]
