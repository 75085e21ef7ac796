"""Step functions (train / prefill / decode); the port of
``repro.launch.steps``.

The steps run eagerly on whatever their arguments are: plain tensors on
one device, or DTensors on a mesh under the rules :func:`install_rules`
sets (the dry run's fake mesh).  :func:`step_and_args` gives the step and
its ordered arguments for a cell of ``launch/shapes.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.profiler import record_function

from ..models import decode as D
from ..models import transformer as TF
from ..models.common import set_sharding_rules
from ..models.config import ModelConfig
from ..optim import adamw
from ..sharding.rules import ShardingStrategy, logical_rules


def install_rules(cfg: ModelConfig, mesh, st: ShardingStrategy,
                  shard_heads: bool = False) -> None:
    set_sharding_rules(mesh, logical_rules(st, shard_heads=shard_heads))


def grad_of(cfg: ModelConfig, params, batch: Dict
            ) -> Tuple[Dict, List[torch.Tensor]]:
    """(the loss's metrics, the gradient of each parameter leaf, in
    ``adamw.leaves`` order and the parameter's dtype)."""
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = TF.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return {k: v.detach() for k, v in metrics.items()}, list(grads)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1):
    """Train step with optional gradient accumulation: the global batch is
    split into ``microbatches`` sequential slices, so live activations
    shrink by that factor.

    ``train_step(state, batch) -> (state, metrics)``, ``state`` being
    ``{"params", "opt": adamw.OptState}``.  The update is written into the
    state's tensors (``adamw.apply_updates_``, the values of the
    reference's functional update), in the profiler ranges
    ``train_step.grads`` and ``train_step.optimizer``.  With microbatches
    the gradients are summed in float32 in microbatch order and divided by
    their count, and the metrics are the last microbatch's, as the
    reference returns them (its mean of the microbatch losses is computed
    and not returned)."""

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        with record_function("train_step.grads"):
            if microbatches <= 1:
                metrics, grads = grad_of(cfg, params, batch)
            else:
                mbs = {k: v.reshape((microbatches, -1) + tuple(v.shape[1:]))
                       for k, v in batch.items()}
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                         for p in adamw.leaves(params)]
                for i in range(microbatches):
                    metrics, g = grad_of(cfg, params,
                                         {k: v[i] for k, v in mbs.items()})
                    grads = [a + b.float() for a, b in zip(grads, g)]
                    del g
                grads = [g / microbatches for g in grads]
        it = iter(grads)
        grads = adamw.tree_map(lambda _: next(it), params)
        with record_function("train_step.optimizer"):
            opt, om = adamw.apply_updates_(opt_cfg, params, grads, state["opt"])
        return {"params": params, "opt": opt}, {**metrics, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch: Dict) -> torch.Tensor:
        logits, _ = TF.forward(cfg, params, batch["tokens"],
                               modality=batch.get("modality"))
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens, pos):
        return D.serve_step(cfg, params, cache, tokens, pos)

    return serve_step


def step_and_args(cfg: ModelConfig, shape_kind: str,
                  specs: Dict[str, Any],
                  opt_cfg: adamw.AdamWConfig = None,
                  microbatches: int = 1):
    """(callable, ordered example args) for running a given cell.  The
    decode step ignores the value of ``specs["pos"]`` (the reference traces
    it; the eager step needs a number) and writes at position 0: a step's
    cost does not depend on it, every step attending over the whole cache
    under a mask."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if shape_kind == "train":
        return (make_train_step(cfg, opt_cfg, microbatches=microbatches),
                (specs["state"], specs["batch"]))
    if shape_kind == "prefill":
        return make_prefill_step(cfg), (specs["params"], specs["batch"])
    serve = make_serve_step(cfg)

    def serve_step(params, cache, tokens, pos):
        return serve(params, cache, tokens, 0)

    return serve_step, (specs["params"], specs["cache"], specs["tokens"],
                        specs["pos"])
