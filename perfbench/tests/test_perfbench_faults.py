"""A run with the timed path broken underneath must come out not correct:
the harness's look for a card skipped, the rest of a run driven on the CPU
at a small size, against the cell's own limits.

Each run is a fresh interpreter that applies its fault (``FAULTS``) and
calls ``run.main``: a run refuses to print a result in a process that holds
JAX or the JAX package, which other test files load into the pytest
process."""
import json
import os
import subprocess
import sys

import pytest

from conftest import SERVE_LIMITS, SERVE_WORKLOAD as SERVE, tiny, with_serve_cell
from perfbench import cells, run

TRAIN = "granite-moe-1b-a400m.train-4k"
HERE = os.path.dirname(os.path.abspath(__file__))


def _serve_step_wrapped(after):
    """``decode.make_serve_step`` with ``after(logits, cache, saved)``
    applied to each step's output; ``saved`` is a copy of the cache from
    before the step."""
    from repro_torch.models import decode
    orig = decode.make_serve_step

    def make(cfg):
        step = orig(cfg)

        def run_step(params, cache, tokens, pos):
            saved = [t.clone() for t in decode._leaves(cache)]
            logits, cache = step(params, cache, tokens, pos)
            after(logits, cache, saved)
            return logits, cache
        return run_step

    decode.make_serve_step = make


def _alter_tokens(share):
    """The first ``share`` of the slots serve the next token id, with a
    logit of 1e4."""
    def after(logits, cache, saved):
        last = logits[:, -1]
        n = int(last.shape[0] * share)
        nxt = (last[:n].argmax(-1) + 1) % last.shape[-1]
        logits[:n, -1].scatter_(1, nxt[:, None], 1e4)
    _serve_step_wrapped(after)


def _serve_state_unchanged():
    from repro_torch.models import decode

    def after(logits, cache, saved):
        for t, s in zip(decode._leaves(cache), saved):
            t.copy_(s)
    _serve_step_wrapped(after)


def _train_state_unchanged():
    from repro_torch.optim import adamw
    adamw.apply_updates_ = lambda cfg, params, grads, state: (state, {})


def _train_half_batch():
    from repro_torch.launch import steps
    orig = steps.grad_of

    def half(cfg, params, batch):
        t = batch["tokens"]
        return orig(cfg, params, {"tokens": t[: t.shape[0] // 2]})

    steps.grad_of = half


FAULTS = {
    "none": lambda: None,
    # half of the slots serve a wrong token and wrong logits, the other half
    # is sound: a statistic that a quarter of the tokens decides (the first
    # quartile of the error) would not see it
    "serve_half_altered": lambda: _alter_tokens(0.5),
    "serve_token_altered": lambda: _alter_tokens(1.0),
    "serve_state_unchanged": _serve_state_unchanged,
    "train_state_unchanged": _train_state_unchanged,
    "train_half_batch": _train_half_batch,
}


def child(workload: str, fault: str, traffic: dict) -> int:
    """One run in this interpreter with ``fault`` applied: the body of the
    fresh interpreter that ``_correct`` starts."""
    if workload == SERVE:
        bench = with_serve_cell(cells.benchmark())
        cells.benchmark = lambda: bench
    FAULTS[fault]()
    limits = SERVE_LIMITS if workload == SERVE else cells.run_limits(workload)
    ov = tiny(workload, limits)
    ov["traffic"].update(traffic)
    return run.main(["--workload", workload, "--seed", str(2**31 + 11),
                     "--seconds", "0.5"], device="cpu", overrides=ov)


def _correct(workload, fault="none", **traffic) -> bool:
    code = (
        "import json, sys; sys.path[:0] = [%r, %r, %r]\n"
        "import test_perfbench_faults as T\n"
        "sys.exit(T.child(%r, %r, json.loads(%r)))\n"
        % (HERE, cells.ROOT, os.path.join(cells.ROOT, "src"), workload, fault,
           json.dumps(traffic)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
def test_sound_run_is_correct(workload):
    assert _correct(workload) is True


def test_serve_half_of_the_slots_altered():
    assert _correct(SERVE, "serve_half_altered", check_tokens=120) is False


def test_serve_token_altered():
    assert _correct(SERVE, "serve_token_altered") is False


def test_serve_step_returns_its_state_unchanged():
    assert _correct(SERVE, "serve_state_unchanged") is False


def test_train_step_returns_its_state_unchanged():
    assert _correct(TRAIN, "train_state_unchanged") is False


def test_train_half_of_the_batch():
    assert _correct(TRAIN, "train_half_batch") is False
