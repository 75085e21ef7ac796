"""AdamW with global-norm clipping and schedules; the port of
``repro.optim.adamw``.

The optimizer state mirrors the parameter tree leaf for leaf (m, v, in
float32 whatever the parameter dtype).  Every scalar of the update (the
schedule's cosine, the bias corrections ``1 - beta**step``, the clip scale)
is a float32 tensor, as jnp computes it: a Python float would carry them
in float64 and move parameters by an ulp.  A bfloat16 parameter has no
float32 master copy: it is updated in float32 and rounded back, as the
reference does.  ``apply_updates`` returns new trees; ``apply_updates_``
writes the same values into the given ones, one leaf at a time, so a step
holds one leaf's temporaries beside the state (tested bit-equal).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any                   # like params, float32
    v: Any                   # like params, float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def leaves(tree) -> List[torch.Tensor]:
    """The leaves of a tree of dicts in sorted-key order (jax's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of dict trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac (float32)."""
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(params: Any) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return OptState(step=step, m=tree_map(zeros, params),
                    v=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted-key order) of each leaf's
    float32 sum of squares."""
    total = 0
    for g in leaves(tree):
        total = total + torch.sum(g.float() ** 2)
    return torch.sqrt(total)


def _scalars(cfg: AdamWConfig, grads: Any, state: OptState):
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    bc1 = 1 - cfg.beta1 ** step.float()
    bc2 = 1 - cfg.beta2 ** step.float()
    return gnorm, scale, step, lr, bc1, bc2


def _update(cfg: AdamWConfig, p, g, m, v, scale, lr, bc1, bc2):
    """One leaf's (p_new, m_new, v_new), in the reference's order of
    operations."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float() * scale
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    mhat = m_new / bc1
    vhat = v_new / bc2
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    delta = delta + cfg.weight_decay * p.float()
    p_new = p.float() - lr * delta
    return p_new.to(p.dtype), m_new, v_new


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: OptState) -> Tuple[Any, OptState, Dict]:
    """(new params, new state, {"grad_norm", "lr"}); the inputs are left
    as they were."""
    gnorm, scale, step, lr, bc1, bc2 = _scalars(cfg, grads, state)
    out = tree_map(lambda p, g, m, v: _update(cfg, p, g, m, v, scale, lr,
                                              bc1, bc2),
                   params, grads, state.m, state.v)
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def apply_updates_(cfg: AdamWConfig, params: Any, grads: Any,
                   state: OptState) -> Tuple[OptState, Dict]:
    """:func:`apply_updates` in place: the same values written into
    ``params``, ``state.m`` and ``state.v`` leaf by leaf (each leaf's
    temporaries freed before the next).  Returns the state with its new
    step, and the metrics."""
    gnorm, scale, step, lr, bc1, bc2 = _scalars(cfg, grads, state)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        p_new, m_new, v_new = _update(cfg, p, g, m, v, scale, lr, bc1, bc2)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
        del p_new, m_new, v_new
    return OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
