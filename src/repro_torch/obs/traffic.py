"""Seeded synthetic heavy-traffic traces for the serving load harness.

Arrivals are Poisson in *engine-step* time — inter-arrival gaps are drawn
from an exponential distribution and accumulated, then floored to the step
grid — so a trace is a deterministic function of its seed (wall-clock
arrival times would not be).  Prompt and generation lengths are sampled
independently per request from the given mixes, modelling the mixed
short-chat / long-generation traffic the continuous-batching scheduler
(ROADMAP item 5) must eventually handle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One synthetic request: joins the engine queue once the engine has
    executed ``arrival_step`` steps."""
    rid: int
    arrival_step: int
    prompt_len: int
    gen_len: int


def synth_trace(seed: int, requests: int, mean_interarrival: float,
                prompt_lens: Sequence[int], gen_lens: Sequence[int]
                ) -> List[TraceRequest]:
    """Draw a seeded trace of ``requests`` requests.

    ``mean_interarrival`` is the mean gap between arrivals in engine
    steps; 0 makes every request arrive at step 0 (closed-loop burst).
    """
    if requests <= 0:
        return []
    rng = np.random.default_rng(seed)
    if mean_interarrival > 0:
        gaps = rng.exponential(mean_interarrival, size=requests)
        arrivals = np.floor(np.cumsum(gaps) - gaps[0]).astype(int)
    else:
        arrivals = np.zeros(requests, dtype=int)
    plens = rng.choice(np.asarray(prompt_lens, dtype=int), size=requests)
    glens = rng.choice(np.asarray(gen_lens, dtype=int), size=requests)
    return [TraceRequest(i, int(arrivals[i]), int(plens[i]), int(glens[i]))
            for i in range(requests)]


def total_tokens(trace: Sequence[TraceRequest]) -> int:
    """Prompt + generation tokens over the whole trace — an upper bound on
    the engine steps (and cache positions) a serial replay needs."""
    return sum(r.prompt_len + r.gen_len for r in trace)
