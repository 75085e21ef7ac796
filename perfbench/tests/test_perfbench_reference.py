"""The plain reference against the port at a small size in float32: every
logit the serving engine produced, over slots that earlier requests and
empty steps left entries in, with experts past their capacity; and the
training loss and gradients.  A fault in the reference's reading of the
model would show here before it reached a chip run."""
import numpy as np
import pytest
import torch

from conftest import TINY, tiny
from perfbench import cells, counts, serve_driver, weights as W
from perfbench.reference import moe_lm as REF

DEV = torch.device("cpu")


def _cfg(**kw):
    c = dict(cells.config("olmoe-1b-7b"), **TINY)
    c.update(kw)
    return c


def _port(c):
    import dataclasses
    from repro_torch.models import get_config
    port = get_config(c["port_config"])
    return dataclasses.replace(port, **{k: c[k] for k in cells.port_keys(c, port)})


def _skewed(c, seed):
    """Weights whose router sends most tokens to the same experts, so that
    capacity drops assignments."""
    w = W.make(c, seed, DEV, torch.float32)
    w["blocks"]["lyr"]["moe"]["router"].mul_(30.0)
    return w


def test_serve_logits_equal_the_reference(monkeypatch):
    from repro_torch.models import decode
    c = _cfg(num_experts=4, experts_per_token=2)
    spec = dict(cells.traffic("decode-c128"), **tiny("decode")["traffic"])
    spec.update(clients=32, slots=32, max_len=32)     # turnovers every ~30 steps
    w = _skewed(c, 11)
    logits = []
    orig = decode.make_serve_step

    def recording(cfg):
        step = orig(cfg)

        def run(params, cache, tokens, pos):
            out, cache = step(params, cache, tokens, pos)
            logits.append(out[:, -1].clone())
            return out, cache
        return run

    monkeypatch.setattr(decode, "make_serve_step", recording)
    routes = []
    from repro_torch.models import moe
    orig_router = moe._router

    def router(*a, **k):
        out = orig_router(*a, **k)
        routes.append(out[1].clone())
        return out
    monkeypatch.setattr(moe, "_router", router)
    rec = serve_driver.run(c, _port(c), spec, w, 4, 5.0, False, DEV, 0.0,
                           lambda m: None)
    assert len(rec["sessions"]) >= 2          # a turnover: a second engine
    steps0 = len(rec["sessions"][0])
    kept = [counts.moe_routing(c, r.numpy(), 32)["kept"] for r in routes]
    assert min(kept) < 64                     # capacity dropped some
    streams = torch.from_numpy(np.stack(rec["sessions"][0], axis=1))
    rows = [(s, t) for t in range(steps0) for s in range(32)]
    ref = REF.stream_logits(c, w, streams, rows)
    got = torch.stack(logits[:steps0]).reshape(-1, c["vocab_size"])
    assert torch.allclose(got, ref, atol=2e-4, rtol=1e-4), \
        (got - ref).abs().max()


def test_train_loss_and_grads_equal_the_reference():
    from repro_torch.launch import steps
    c = _cfg(num_experts=4, experts_per_token=2, tie_embeddings=True,
             embed_std=0.02)
    w = _skewed(c, 12)
    port_w = {k: v for k, v in w.items() if k != "lm_head"}
    ref_w = {k: v for k, v in W.make(c, 12, DEV, torch.float32).items()}
    ref_w["blocks"]["lyr"]["moe"]["router"].mul_(30.0)
    tokens = torch.randint(0, c["vocab_size"], (2, 64), generator=torch.Generator().manual_seed(3))
    metrics, grads = steps.grad_of(_port(c), port_w, {"tokens": tokens})
    named = list(W.leaf_paths(ref_w))
    for _, p in named:
        p.requires_grad_(True)
    loss = REF.loss(c, ref_w, tokens)
    ref_grads = torch.autograd.grad(loss, [p for _, p in named])
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()), rel=1e-5)
    from repro_torch.optim import adamw
    port_named = dict(zip((p for p, _ in W.leaf_paths(port_w)), grads))
    for (path, _), g in zip(named, ref_grads):
        assert torch.allclose(port_named[path], g, atol=1e-5, rtol=1e-3), path
    assert len(port_named) == len(adamw.leaves(port_w))


def test_capacity_drops_in_dispatch_order():
    """Within one group the first assignments in token order keep their
    slots: with everything sent to expert 0 and capacity 8, tokens 0-7
    keep it."""
    c = _cfg(num_experts=4, experts_per_token=1)
    d = c["d_model"]
    p = {"router": torch.zeros(d, 4), "w1": torch.ones(4, d, c["d_ff"]),
         "wg": torch.ones(4, d, c["d_ff"]), "w2": torch.ones(4, c["d_ff"], d)}
    p["router"][:, 0] = 1.0
    x = torch.ones(12, d)
    with torch.no_grad():
        y, _, _ = REF.moe(c, p, x, torch.zeros(12, dtype=torch.long), 12, None)
    assert counts.capacity(c, 12) == 8
    assert (y[:8].abs().sum(1) > 0).all() and (y[8:] == 0).all()
