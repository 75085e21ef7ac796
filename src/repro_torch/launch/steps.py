"""Step functions (train / prefill / decode); the port of
``repro.launch.steps``.

The steps run eagerly on whatever their arguments are: plain tensors on
one device, or DTensors on a mesh under the rules :func:`install_rules`
sets (the dry run's fake mesh).  :func:`step_and_args` gives the step and
its ordered arguments for a cell of ``launch/shapes.py``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from ..models import decode as D
from ..models import moe as MOE
from ..models import transformer as TF
from ..models.common import set_sharding_rules
from ..models.config import ModelConfig
from ..obs.metrics import Counter, MetricsRegistry
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


def split_rows(v: torch.Tensor, m: int):
    """``v``'s rows in ``m`` contiguous microbatches, the reference's
    ``reshape((m, -1) + shape[1:])``: microbatch ``i`` holds rows
    ``[i*B/m, (i+1)*B/m)``.

    A plain tensor is reshaped.  A DTensor sharded on its rows cannot be:
    ``m`` rows of microbatches do not divide over the data axes, where
    GSPMD re-shards and DTensor refuses.  So its rows move to its last
    dimension's shards (an all-to-all per sharded mesh axis), the rows are
    split locally, and each microbatch goes back to ``v``'s placements (an
    all-to-all of ``B/m`` rows each): every microbatch is sharded over the
    data axes as the batch is, and no rank holds more than its share."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(v, DTensor):
        return v.reshape((m, -1) + tuple(v.shape[1:]))
    mesh, placements = v.device_mesh, v.placements
    across = [Shard(v.ndim - 1) if p == Shard(0) else p for p in placements]
    parts = v.redistribute(mesh, across).reshape(
        (m, -1) + tuple(v.shape[1:]))
    return [parts[i].redistribute(mesh, placements) for i in range(m)]


# the caching allocator's counts (``torch.cuda.memory_stats``) that the
# train step adds to its registry, a step's change at a time
ALLOC_COUNTERS = (
    ("train_alloc_retries_total", "num_alloc_retries",
     "allocations that freed the allocator's cache and retried"),
    ("train_device_mallocs_total", "num_device_alloc", "cudaMalloc calls"),
    ("train_device_frees_total", "num_device_free", "cudaFree calls"),
    ("train_sync_all_streams_total", "num_sync_all_streams",
     "synchronisations of every stream by the allocator"),
)


class _TallyCounter(Counter):
    """A counter whose value is its ``source()``, a running total read
    when the registry reads the counter (``get`` or an exporter)."""

    __slots__ = ("source",)

    def __init__(self, name: str, help: str = "") -> None:
        self.source = lambda: 0
        super().__init__(name, help)

    value = property(lambda self: self.source(), lambda self, v: None)


class TrainCounters:
    """The train step's counters in a :class:`MetricsRegistry`: steps and
    tokens; on a CUDA device the allocator's counts and reserved bytes,
    read once a step from its host-side statistics; the MoE assignments,
    drops and assignments to experts held elsewhere, tallied on the device
    (``moe.DropTally``) and read back only when the registry reads them, so
    the step waits for nothing."""

    def __init__(self, reg: MetricsRegistry) -> None:
        self.reg = reg
        self.steps = reg.counter("train_steps_total", "train steps run")
        self.tokens = reg.counter("train_tokens_total",
                                  "tokens of the steps' batches")
        self.drops = MOE.DropTally()
        reg._get(_TallyCounter, "moe_assignments_total",
                 "token-to-expert assignments of the forwards").source = \
            lambda: self.drops.assigned
        reg._get(_TallyCounter, "moe_dropped_assignments_total",
                 "assignments past an expert's capacity").source = \
            lambda: self.drops.dropped()
        reg._get(_TallyCounter, "moe_remote_assignments_total",
                 "assignments to experts held on other devices").source = \
            lambda: self.drops.remote()
        self.alloc: Optional[Dict[str, int]] = None   # last statistics read

    def _alloc_stats(self, device: torch.device) -> Optional[Dict[str, int]]:
        return (torch.cuda.memory_stats(device) if device.type == "cuda"
                else None)

    def start(self, device: torch.device) -> None:
        if self.alloc is None:
            self.alloc = self._alloc_stats(device)

    def end(self, device: torch.device, tokens: int) -> None:
        self.steps.inc()
        self.tokens.inc(tokens)
        now = self._alloc_stats(device)
        if now is None:
            return
        for name, key, help in ALLOC_COUNTERS:
            self.reg.counter(name, help).inc(
                now.get(key, 0) - self.alloc.get(key, 0))
        self.reg.gauge("train_reserved_bytes",
                       "bytes the caching allocator holds").set(
            now.get("reserved_bytes.all.current", 0))
        self.alloc = now


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1,
                    metrics: Optional[MetricsRegistry] = None):
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
    and not returned).

    With a ``metrics`` registry each step adds to the counters of
    :class:`TrainCounters`; with ``None`` nothing is recorded."""
    counters = TrainCounters(metrics) if metrics is not None else None

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        tokens = batch["tokens"]
        tally = contextlib.nullcontext()
        if counters is not None:
            counters.start(tokens.device)
            tally = MOE.counting(counters.drops)
        with record_function("train_step.grads"), tally:
            if microbatches <= 1:
                metrics, grads = grad_of(cfg, params, batch)
            else:
                mbs = {k: split_rows(v, microbatches)
                       for k, v in batch.items()}
                grads = [torch.zeros_like(p, dtype=torch.float32)
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
        if counters is not None:
            counters.end(tokens.device, tokens.numel())
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
