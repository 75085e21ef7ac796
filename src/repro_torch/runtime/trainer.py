"""Fault-tolerant training runtime; the port of ``repro.runtime.trainer``,
on ``cuda`` unless the caller names another device.

  * checkpoint/restart: ``run_with_restarts`` supervises the train loop;
    any ``WorkerFailure`` (injected in tests) triggers restore-from-latest
    and continuation.  The data pipeline is counter-based, so a recovered
    trajectory replays the batches an unfailed run sees.
  * straggler mitigation: per-step wall times feed an EMA outlier
    detector; flagged hosts are reported.
  * elastic rescale: checkpoints are device-agnostic; ``rescale`` restores
    the same state onto the devices and dtypes of another state skeleton.

A step's ``step_time_s`` is stamped after its loss is read back, so it
holds the device's work; the reference stamps it before reading the loss
(``ROADMAP.md`` C, the trait of ``step_time_s``).

``state_from_numpy`` carries the reference's train state (given as numpy
arrays) over, and ``state_to_numpy`` is its inverse: the state-carrying
functions of the training path, beside ``params.params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import DeviceLike, resolve_device
from ..launch.steps import make_train_step
from ..models import params as MP
from ..models.config import ModelConfig
from ..optim import adamw


class WorkerFailure(RuntimeError):
    """A (simulated) node failure."""


@dataclasses.dataclass
class StragglerDetector:
    """EMA-based per-host step-time outlier detection."""
    alpha: float = 0.2
    threshold: float = 2.0          # x median-of-hosts
    _ema: Dict[int, float] = dataclasses.field(default_factory=dict)

    def record(self, host: int, step_time: float) -> None:
        prev = self._ema.get(host, step_time)
        self._ema[host] = (1 - self.alpha) * prev + self.alpha * step_time

    def stragglers(self) -> List[int]:
        if len(self._ema) < 2:
            return []
        med = float(np.median(list(self._ema.values())))
        return [h for h, t in self._ema.items()
                if t > self.threshold * med]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt"))
    max_restarts: int = 3
    seed: int = 0


def state_from_numpy(tree: Dict, device: DeviceLike, param_dtype) -> Dict:
    """The reference's train state ``{"params", "opt": (step, m, v)}`` as
    numpy arrays -> the port's, on ``device`` (``cuda`` if None): params
    cast to ``param_dtype`` (bfloat16 ones given by their float32 values,
    which the cast keeps), ``step`` int32, ``m`` and ``v`` float32."""
    dev = resolve_device(device)
    step, m, v = tree["opt"]
    return {"params": MP.params_from_numpy(tree["params"], dev, param_dtype),
            "opt": adamw.OptState(
                torch.tensor(np.asarray(step), dtype=torch.int32, device=dev),
                MP.params_from_numpy(m, dev, torch.float32),
                MP.params_from_numpy(v, dev, torch.float32))}


def state_to_numpy(state: Dict) -> Dict:
    """The inverse of :func:`state_from_numpy`: numpy arrays on the host,
    params in float32 (a bfloat16 value is exact there)."""
    def host(t):
        return t.detach().float().cpu().numpy()
    opt = state["opt"]
    return {"params": adamw.tree_map(host, state["params"]),
            "opt": adamw.OptState(np.asarray(int(opt.step), np.int32),
                                  adamw.tree_map(host, opt.m),
                                  adamw.tree_map(host, opt.v))}


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            total_steps=tcfg.total_steps)
        self.data_cfg = data_cfg or DataConfig(
            vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
            seed=tcfg.seed)
        self.data = SyntheticLM(self.data_cfg, model_cfg=cfg)
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir)
        self.failure_hook = failure_hook
        self.detector = StragglerDetector()
        self.history: List[Dict] = []
        self.step_fn = make_train_step(cfg, self.opt_cfg)

    # -- state ------------------------------------------------------------------
    def init_state(self) -> Dict:
        params = MP.init_params(self.cfg, seed=self.tcfg.seed,
                                device=self.device)
        return {"params": params, "opt": adamw.init_state(params)}

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The data pipeline's batch for ``step``, on the trainer's device."""
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in self.data.batch(step).items()}

    # -- training ---------------------------------------------------------------
    def _loop(self, state: Dict, start_step: int) -> Dict:
        for step in range(start_step, self.tcfg.total_steps):
            if self.failure_hook is not None:
                self.failure_hook(step)     # may raise WorkerFailure
            t0 = time.time()
            state, metrics = self.step_fn(state, self.batch(step))
            rec = {"step": step, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"])}
            dt = time.time() - t0           # after the loss's read-back
            self.detector.record(0, dt)
            rec["step_time_s"] = dt
            self.history.append(rec)
            if (step + 1) % self.tcfg.checkpoint_every == 0 \
                    or step + 1 == self.tcfg.total_steps:
                self.ckpt.save(step + 1, state)
        self.ckpt.wait()
        return state

    def run_with_restarts(self) -> Dict:
        """Supervised loop: restore-from-latest on failure, bounded retries.
        Each restart draws the initial state again before restoring into
        it, as the reference does."""
        restarts = 0
        state = self.init_state()
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, start = self.ckpt.restore(state)
        while True:
            try:
                return self._loop(state, start)
            except WorkerFailure as e:
                restarts += 1
                if restarts > self.tcfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.tcfg.max_restarts}") \
                        from e
                self.ckpt.wait()
                del state
                state = self.init_state()
                latest = self.ckpt.latest_step()
                start = 0
                if latest is not None:
                    state, start = self.ckpt.restore(state)
                self.history.append({"restart": restarts,
                                     "resume_step": start})

    # -- elasticity ---------------------------------------------------------------
    def rescale(self, like_state: Any) -> Any:
        """Restore the latest checkpoint into another state skeleton (other
        devices or dtypes): elastic scaling."""
        state, step = self.ckpt.restore(like_state)
        return state, step
