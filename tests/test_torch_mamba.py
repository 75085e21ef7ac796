"""The port's Mamba2 block (zamba2's layer) against the reference's, on the CPU.

``repro_torch.models.mamba`` against ``repro.models.mamba`` on the reduced
zamba2-7b config and the same weights, with ``conv_b`` and ``D`` redrawn
away from their constant init (zeros and ones), so the comparisons hold the
conv bias and the skip term.  float32 at 1e-5 relative to the output's
scale (max |want|, at least 1), as ``tests/test_torch_decode.py``: with the
blocks drawn at std 1/sqrt(num_groups) (``ROADMAP.md`` C.6) a layer's
output reaches ~1e6 at the reduced config.  Over 64 tokens and more (a
full scan chunk and beyond), both packages' outputs sit 1.9e-5-3.1e-5 of
the scale from a float64 evaluation of the same block, and the port is
held at 2e-4 (``LONG``, gemma2's tolerance in ``tests/test_torch_decode.py``).
bf16 at 2e-2 of the scale, with
the reference's dtypes term by term (the state float32, the output in the
model dtype).  Also: the conv cache holds the pre-conv, pre-SiLU inputs
(C.11), a sequence of 96 raises (C.9), and teacher-forced decode against
the block.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro.models import mamba as RM  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

NAME = "zamba2-7b"
F32, LONG, BF16 = 1e-5, 2e-4, 2e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=F32):
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


def _layer(dtype="float32"):
    """(port cfg, reference cfg, port layer params, reference layer params):
    group 0's first Mamba layer of the seeded draw, ``conv_b`` and ``D``
    redrawn, the same values in both packages."""
    cfg = dataclasses.replace(get_config(NAME).reduced(), dtype=dtype)
    rcfg = dataclasses.replace(ref_config(NAME).reduced(), dtype=dtype)
    tree = jax.tree.map(_np, RP.init_params(rcfg, seed=0))
    lp = jax.tree.map(lambda a: a[0, 0], tree["blocks"]["mamba"])
    rng = np.random.default_rng(5)
    lp["conv_b"] = rng.normal(0, 0.5, lp["conv_b"].shape).astype(np.float32)
    lp["D"] = rng.uniform(0.5, 1.5, lp["D"].shape).astype(np.float32)
    rlp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.dtype(dtype)), lp)
    return cfg, rcfg, P.params_from_numpy(lp, "cpu", dtype), rlp


def _x(cfg, s, dtype="float32", seed=4):
    x = np.random.default_rng(seed).normal(size=(2, s, cfg.d_model))
    x = x.astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(jnp.dtype(dtype)))


def test_split_dims_match_reference():
    cfg, rcfg, _, _ = _layer()
    assert M._dims(cfg) == RM._dims(rcfg)
    assert M.mamba_cache_shape(cfg, 3) == RM.mamba_cache_shape(rcfg, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 5, 12])
def test_causal_conv_matches_reference(s, dtype):
    cfg, rcfg, p, rp = _layer(dtype)
    ch = p["conv_w"].shape[1]
    x = np.random.default_rng(s).normal(size=(2, s, ch)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = M._causal_conv(xt, p["conv_w"], p["conv_b"])
    want = RM._causal_conv(jnp.asarray(x).astype(jnp.dtype(dtype)),
                           rp["conv_w"], rp["conv_b"])
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got, want, F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("s", [12, 64, 128])
def test_mamba_block_matches_reference(s):
    """At 128 tokens the scan runs two chunks of 64."""
    cfg, rcfg, p, rp = _layer()
    x, jx = _x(cfg, s)
    got = M.mamba_block(cfg, p, x)
    want = RM.mamba_block(rcfg, rp, jx)
    assert got.shape == (2, s, cfg.d_model) and got.dtype == torch.float32
    _close(got, want, F32 if s < 64 else LONG)


def test_mamba_block_bf16_matches_reference():
    cfg, rcfg, p, rp = _layer("bfloat16")
    x, jx = _x(cfg, 12, "bfloat16")
    got = M.mamba_block(cfg, p, x)
    assert got.dtype == torch.bfloat16
    _close(got, RM.mamba_block(rcfg, rp, jx), BF16)


def test_a_sequence_the_chunk_does_not_divide_raises():
    """C.9: the forward's scan runs at chunk 64, so 96 tokens fail in the
    reference (its assert) and in the port (``ValueError``)."""
    cfg, rcfg, p, rp = _layer()
    x, jx = _x(cfg, 96)
    with pytest.raises(AssertionError):
        RM.mamba_block(rcfg, rp, jx)
    with pytest.raises(ValueError, match="divide"):
        M.mamba_block(cfg, p, x)


def _zero_cache(cfg, rcfg, dtype):
    shapes = M.mamba_cache_shape(cfg, 2)
    cache = {k: torch.zeros(s, dtype=getattr(torch, dtype))
             for k, s in shapes.items()}
    rcache = {k: jnp.zeros(s, jnp.dtype(dtype)) for k, s in shapes.items()}
    return cache, rcache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    """Eight steps, each fed the step's new cache entries: the outputs, the
    state and the conv window in each package's dtypes (the state comes back
    float32 in both, the window and the output in the model dtype)."""
    cfg, rcfg, p, rp = _layer(dtype)
    tol = F32 if dtype == "float32" else BF16
    x, jx = _x(cfg, 8, dtype)
    cache, rcache = _zero_cache(cfg, rcfg, dtype)
    for i in range(8):
        out, cache = M.mamba_decode_step(cfg, p, x[:, i:i + 1], cache)
        rout, rcache = RM.mamba_decode_step(rcfg, rp, jx[:, i:i + 1], rcache)
        assert out.dtype == x.dtype and out.shape == (2, 1, cfg.d_model)
        _close(out, rout, tol)
        for key in ("h", "conv"):
            assert str(cache[key].dtype).replace("torch.", "") \
                == str(rcache[key].dtype), key
            _close(cache[key], rcache[key], tol)
    assert cache["h"].dtype == torch.float32


def test_conv_cache_holds_the_pre_activation_inputs():
    """C.11: after each step the conv cache holds the last K-1 conv inputs
    (in_proj's x, B, C of the normed input), before the conv and the SiLU;
    the window starts from zeros."""
    cfg, _, p, _ = _layer()
    d_inner, _, st = M._dims(cfg)
    k = cfg.ssm_conv_width
    x, _ = _x(cfg, 6)
    conv_in = torch.cat([                   # each token's, as decode forms it
        (C.norm(cfg, p["ln"], x[:, i:i + 1]) @ p["in_proj"])
        [..., d_inner:2 * d_inner + 2 * st] for i in range(6)], dim=1)
    cache, _ = _zero_cache(cfg, None, "float32")
    for i in range(6):
        _, cache = M.mamba_decode_step(cfg, p, x[:, i:i + 1], cache)
        lo = i + 1 - (k - 1)
        want = conv_in[:, max(lo, 0):i + 1]
        if lo < 0:
            want = torch.cat([torch.zeros_like(conv_in[:, :-lo]), want], dim=1)
        torch.testing.assert_close(cache["conv"], want, rtol=0, atol=0)


def test_decode_matches_the_block():
    """Teacher-forced decode reproduces the block's output at every position
    (the recurrence against the chunked scan) within 1e-5 of the scale."""
    cfg, _, p, _ = _layer()
    x, _ = _x(cfg, 12)
    full = M.mamba_block(cfg, p, x)
    cache, _ = _zero_cache(cfg, None, "float32")
    outs = []
    for i in range(12):
        out, cache = M.mamba_decode_step(cfg, p, x[:, i:i + 1], cache)
        outs.append(out)
    _close(torch.cat(outs, dim=1), full)


def test_the_hybrid_forward_applies_one_shared_block():
    """The hybrid group runs its two Mamba layers and then the one top-level
    ``shared_block``: a change to it moves every group's output."""
    cfg = get_config(NAME).reduced()
    prm = P.init_params(cfg, seed=0, device="cpu")
    assert "shared_block" in prm and "shared_block" not in prm["blocks"]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 8)))
    base, aux = T.forward(cfg, prm, tokens)
    assert aux == {}
    prm["shared_block"]["mlp"]["wo"].mul_(2.0)
    moved, _ = T.forward(cfg, prm, tokens)
    assert float((moved - base).abs().max()) > 1e-3
