"""The one generator of every traffic mix.

A mix is a data file, ``perfbench/traffic/<mix>.json``; its ``kind`` says
which of the generators below reads it.  Everything is drawn with numpy on
the host.  Lengths come from a fixed grid of quantiles of a clipped
lognormal and arrive at the same steps for every seed; the seed changes
only the order of the clients and the token ids, so the work a run does
does not move with the seed.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np

_SEED_MIX = 0x5EED_7AFF


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), _SEED_MIX, stream])


def length_grid(spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 1/2) / n of a lognormal with the
    spec's ``median`` and ``sigma``, rounded and clipped to [min, max]."""
    nd = statistics.NormalDist()
    mu = math.log(spec["median"])
    out = [round(math.exp(mu + spec["sigma"] * nd.inv_cdf((i + 0.5) / n)))
           for i in range(n)]
    return np.clip(np.array(out, dtype=np.int64), spec["min"], spec["max"])


# ---------------------------------------------------------------------------
# Serving: closed-loop clients
# ---------------------------------------------------------------------------

def serve_requests(spec: Dict, seed: int, vocab: int
                   ) -> List[Tuple[int, List[Tuple[np.ndarray, int]]]]:
    """Per client, in the seed's order: the index of its sequence of
    lengths and its requests, (prompt tokens, output length).  The
    sequences of lengths are the same for every seed (a fixed shuffle of
    the grid, cut into one sequence a client), and so are their start
    steps (``client_start_steps`` by sequence index); the seed decides the
    order in which the clients submit within a step, and the token ids."""
    clients, per = spec["clients"], spec["requests_per_client"]
    n = clients * per
    fixed = _rng(0, 0)
    plen = fixed.permutation(length_grid(spec["prompt"], n)).reshape(clients, per)
    olen = fixed.permutation(length_grid(spec["output"], n)).reshape(clients, per)
    rng = _rng(seed, 1)
    order = rng.permutation(clients)
    out = []
    for j in order:
        toks = rng.integers(0, vocab, size=int(plen[j].sum()), dtype=np.int64)
        prompts = np.split(toks, np.cumsum(plen[j])[:-1])
        out.append((int(j), [(prompts[i], int(olen[j, i])) for i in range(per)]))
    return out


def mean_request_steps(spec: Dict) -> int:
    """Engine steps of a mean request: its prompt fed a token a step, then
    its output a token a step."""
    n = spec["clients"] * spec["requests_per_client"]
    return int(round(length_grid(spec["prompt"], n).mean()
                     + length_grid(spec["output"], n).mean()))


def client_start_steps(spec: Dict) -> List[int]:
    """The step at which each sequence's client sends its first request:
    the clients start staggered over one mean request."""
    r, k = mean_request_steps(spec), spec["clients"]
    return [(j * r) // k for j in range(k)]


# ---------------------------------------------------------------------------
# Training: packed documents
# ---------------------------------------------------------------------------

def train_batches(spec: Dict, seed: int, vocab: int) -> np.ndarray:
    """(pool, batch, seq_len) int64 token rows.  Each row is documents
    packed end to end, each ending in the separator token; a document's
    tokens are Zipf unigrams where a fraction of positions are forced to a
    planted successor of the token before (the rule of the port's
    synthetic pipeline, ``data/pipeline.py``), so a model can learn."""
    pool, b, s = spec["pool"], spec["batch"], spec["seq_len"]
    rows = pool * b
    rng = _rng(seed, 2)
    succ = rng.integers(0, vocab, size=vocab, dtype=np.int64)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-spec["zipf_a"])
    toks = rng.choice(vocab, p=p / p.sum(), size=(rows, s)).astype(np.int64)
    mask = rng.random((rows, s - 1)) < spec["bigram_frac"]
    for i in range(1, s):
        toks[:, i] = np.where(mask[:, i - 1], succ[toks[:, i - 1]], toks[:, i])
    grid = length_grid(spec["doc_len"], 64)
    for r in range(rows):
        end = -1
        while True:
            end += int(grid[rng.integers(0, len(grid))])
            if end >= s:
                break
            toks[r, end] = spec["separator"]
    return toks.reshape(pool, b, s)
