"""A run with the timed path broken underneath must come out not correct:
the harness's look for a card skipped, the rest of a run driven on the CPU
at a small size, against the cell's own limits."""
import json

import pytest

from conftest import SERVE_LIMITS, SERVE_WORKLOAD as SERVE, tiny
from perfbench import cells, run

TRAIN = "granite-moe-1b-a400m.train-4k"


def _correct(workload, capsys, **traffic) -> bool:
    limits = SERVE_LIMITS if workload == SERVE else cells.run_limits(workload)
    ov = tiny(workload, limits)
    ov["traffic"].update(traffic)
    rc = run.main(["--workload", workload, "--seed", str(2**31 + 11),
                   "--seconds", "0.5"], device="cpu", overrides=ov)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"]


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
def test_sound_run_is_correct(workload, serve_cell, capsys):
    assert _correct(workload, capsys) is True


def test_serve_half_of_the_slots_altered(monkeypatch, serve_cell, capsys):
    """Half of the slots served a wrong token and wrong logits; the other
    half is sound.  A statistic that a quarter of the tokens decides (the
    first quartile of the error) would not see it."""
    from repro_torch.models import decode
    orig = decode.make_serve_step

    def altered(cfg):
        step = orig(cfg)

        def run_step(params, cache, tokens, pos):
            logits, cache = step(params, cache, tokens, pos)
            last = logits[:, -1]
            half = last.shape[0] // 2
            nxt = (last[:half].argmax(-1) + 1) % last.shape[-1]
            logits[:half, -1].scatter_(1, nxt[:, None], 1e4)
            return logits, cache
        return run_step

    monkeypatch.setattr(decode, "make_serve_step", altered)
    assert _correct(SERVE, capsys, check_tokens=120) is False


def test_serve_token_altered(monkeypatch, serve_cell, capsys):
    from repro_torch.models import decode
    orig = decode.make_serve_step

    def altered(cfg):
        step = orig(cfg)

        def run_step(params, cache, tokens, pos):
            logits, cache = step(params, cache, tokens, pos)
            last = logits[:, -1]
            nxt = (last.argmax(-1) + 1) % last.shape[-1]
            logits[:, -1].scatter_(1, nxt[:, None], 1e4)
            return logits, cache
        return run_step

    monkeypatch.setattr(decode, "make_serve_step", altered)
    assert _correct(SERVE, capsys) is False


def test_serve_step_returns_its_state_unchanged(monkeypatch, serve_cell, capsys):
    from repro_torch.models import decode
    orig = decode.make_serve_step

    def frozen(cfg):
        step = orig(cfg)

        def run_step(params, cache, tokens, pos):
            leaves = decode._leaves(cache)
            saved = [t.clone() for t in leaves]
            logits, cache = step(params, cache, tokens, pos)
            for t, s in zip(decode._leaves(cache), saved):
                t.copy_(s)
            return logits, cache
        return run_step

    monkeypatch.setattr(decode, "make_serve_step", frozen)
    assert _correct(SERVE, capsys) is False


def test_train_step_returns_its_state_unchanged(monkeypatch, capsys):
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "apply_updates_",
                        lambda cfg, params, grads, state: (state, {}))
    assert _correct(TRAIN, capsys) is False


def test_train_half_of_the_batch(monkeypatch, capsys):
    from repro_torch.launch import steps
    orig = steps.grad_of

    def half(cfg, params, batch):
        t = batch["tokens"]
        return orig(cfg, params, {"tokens": t[: t.shape[0] // 2]})

    monkeypatch.setattr(steps, "grad_of", half)
    assert _correct(TRAIN, capsys) is False
