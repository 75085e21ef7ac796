"""Banking -> CUDA bridge: execute a tensor graph with banked kernels.

Port of ``repro.core.pallas_backend``.  The same ``BankingSpec`` that drives
the Calyx flow selects the kernel's tile partition: factor c on each matmul
dimension becomes (c, c, c) banks.  Matmuls go to ``kernels.ops.matmul``
(the hand-written Hopper kernel on the card, its plain version for
``device="cpu"``); every other op runs through the torch oracle, as the
reference runs them through the jnp oracle.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from . import tensor_ir as T
from . import torch_backend
from .banking import BankingSpec
from ..device import DeviceLike, full_f32, resolve_device
from ..kernels import ops as kops


def execute_graph_cuda(graph: T.Graph, inputs: Mapping[str, np.ndarray],
                       spec: BankingSpec, device: DeviceLike = None
                       ) -> List[np.ndarray]:
    dev = resolve_device(device)
    banks = (spec.factor, spec.factor, spec.factor)
    env: Dict[str, torch.Tensor] = {}
    with full_f32():
        for op in graph.ops:
            if op.kind == "input":
                env[op.name] = torch_backend.to_tensor(inputs[op.name], dev)
            elif op.kind == "param":
                env[op.name] = torch_backend.to_tensor(graph.params[op.name], dev)
            elif op.kind == "matmul":
                a, b = env[op.inputs[0]], env[op.inputs[1]]
                env[op.name] = kops.matmul(a, b, banks=banks)
            else:
                env[op.name] = torch_backend._op_fn(op, env, graph)
    return [env[o].cpu().numpy() for o in graph.outputs]
