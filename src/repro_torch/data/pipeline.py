"""Deterministic synthetic LM data pipeline, host-sharded.

The port of ``repro.data.pipeline``, a copy of its numpy draw: every
(step, host) batch is derived from a counter-based RNG, so the pipeline is
stateless and restart-safe: after a failure, resuming at step k reproduces
exactly the batches a non-failed run would have seen, and every batch is
the reference's, bit for bit.

The token stream is structured (zipf-distributed unigrams + planted bigram
dependencies) so that a model can actually reduce loss on it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    bigram_frac: float = 0.5      # fraction of positions forced to planted
                                  # bigram successors (learnable structure)


class SyntheticLM:
    """Host-sharded iterator of {'tokens': (B_local, S) int32} batches."""

    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 host_count: int = 1, model_cfg: Optional[ModelConfig] = None):
        assert cfg.global_batch % host_count == 0, (cfg.global_batch,
                                                    host_count)
        self.cfg = cfg
        self.host_id = host_id
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        self.model_cfg = model_cfg
        # planted bigram table: token t -> deterministic successor
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(0, cfg.vocab_size, size=cfg.vocab_size,
                                  dtype=np.int32)
        # zipf-ish unigram distribution over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def batch(self, step: int) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
        """Deterministic batch for (step, host).

        ``tokens`` is an int32 numpy array.  A vlm or audio model config
        adds ``modality`` (patch or frame embeddings, (B_local, n, d_model)):
        a float32 numpy array for a float32 model, and for a bfloat16 model
        a CPU ``torch.bfloat16`` tensor, since numpy has no bfloat16 of its
        own.  Both are drawn in float32 and rounded to nearest even, as the
        reference rounds them through ``ml_dtypes``, so the bits are the
        reference's."""
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed * 1_000_003 + step) * 65_537 + self.host_id)
        toks = rng.choice(c.vocab_size, p=self._p,
                          size=(self.local_batch, c.seq_len)).astype(np.int32)
        # plant bigrams sequentially so chains survive:
        # with prob bigram_frac, position i = succ(position i-1)
        mask = rng.random((self.local_batch, c.seq_len - 1)) < c.bigram_frac
        for i in range(1, c.seq_len):
            toks[:, i] = np.where(mask[:, i - 1],
                                  self._succ[toks[:, i - 1]], toks[:, i])
        out: Dict[str, Union[np.ndarray, torch.Tensor]] = {"tokens": toks}
        mc = self.model_cfg
        if mc is not None and mc.family in ("vlm", "audio"):
            n = mc.num_patches if mc.family == "vlm" else mc.encoder_seq
            mod = rng.normal(size=(self.local_batch, n, mc.d_model)).astype(
                np.float32)
            out["modality"] = (mod if mc.dtype == "float32" else
                               torch.from_numpy(mod).to(getattr(torch, mc.dtype)))
        return out

    def __iter__(self) -> Iterator[Dict[str, Union[np.ndarray, torch.Tensor]]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
