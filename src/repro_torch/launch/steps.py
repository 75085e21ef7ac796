"""Step functions (train / prefill / decode); the port of
``repro.launch.steps``.

The reference's ``install_rules`` and ``step_and_args`` place the steps on
a device mesh through ``sharding/rules.py`` and ``launch/shapes.py``; they
wait for those modules (``ROADMAP.md`` A, item 20), and the steps here run
on one device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

from ..models import decode as D
from ..models import transformer as TF
from ..models.config import ModelConfig
from ..optim import adamw


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
