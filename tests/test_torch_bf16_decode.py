"""bf16 decode held against the reference (``ROADMAP.md`` C.0), on the CPU.

The port serves in bf16 on the card, while ``tests/test_torch_decode.py``
holds its decode in float32.  A flat 2e-2 would not hold the reference
itself in bf16, whose logits sit 0.03-0.25 from a float32 evaluation of the
same bf16-rounded weights at the reduced configs.  So each package's bf16
``serve_step`` logits, teacher-forced over 12 steps on 2 sequences, are
measured against the reference's float32 evaluation of the same
bf16-rounded weights, and the port may sit no further from it than the
reference does, plus a margin of a quarter of the reference's own distance
(``MARGIN``).  The dense family (qwen2-0.5b; gemma2-27b with its ring and
softcaps), the moe family (olmoe-1b-7b) and the recurrent ones, RWKV6 and
zamba2, whose wkv and Mamba ``h`` states the reference returns in float32
whatever the cache's dtype: after the first step the port's states are
float32 too, and its cache bytes are the reference's at every step (C.13,
C.14), in the fused cache and in the sliced step's per-group list form.
whisper and the VLM decode with a modality drawn from numpy and rounded to
bf16 (the same values in all three evaluations), their cross K/V stored in
bf16 (C.18), the VLM's cross gates set non-zero (C.15).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import decode as RD  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import params as P  # noqa: E402

STEPS, BATCH = 12, 2
MARGIN = 0.25            # of the reference's own bf16-to-f32 distance


def _step(rcfg):
    return jax.jit(lambda p, c, t, pos: RD.serve_step(rcfg, p, c, t, pos))


def _modality(cfg):
    """bf16-rounded frame or patch embeddings as float32 numpy, or None."""
    if cfg.family not in ("audio", "vlm"):
        return None
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.num_patches
    a = np.random.default_rng(7).normal(size=(BATCH, n, cfg.d_model))
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("name", ["qwen2-0.5b", "gemma2-27b", "rwkv6-7b",
                                  "zamba2-7b", "olmoe-1b-7b",
                                  "whisper-large-v3", "llama-3.2-vision-11b"])
def test_bf16_decode_no_further_from_f32_than_the_reference(name):
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16")
    rcfg = dataclasses.replace(ref_config(name).reduced(), dtype="bfloat16")
    rcfg32 = ref_config(name).reduced()
    rprm = RP.init_params(rcfg, seed=0)
    if cfg.family == "vlm":          # C.15: non-zero cross gates
        g = np.random.default_rng(15).uniform(0.5, 1.5, (2, cfg.num_groups))
        rprm["blocks"]["cross"]["gate_attn"] = jnp.asarray(g[0], jnp.bfloat16)
        rprm["blocks"]["cross"]["gate_mlp"] = jnp.asarray(-g[1], jnp.bfloat16)
    rounded = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), rprm)
    rprm32 = jax.tree.map(jnp.asarray, rounded)
    prm = P.params_from_numpy(rounded, "cpu", "bfloat16")
    n = STEPS + 2
    m = _modality(cfg)
    cache = D.init_cache(cfg, prm, BATCH, n, modality=None if m is None
                         else torch.from_numpy(m).to(torch.bfloat16))
    rcache = RD.init_cache(rcfg, rprm, BATCH, n, modality=None if m is None
                           else jnp.asarray(m, jnp.bfloat16))
    rcache32 = RD.init_cache(rcfg32, rprm32, BATCH, n, modality=None
                             if m is None else jnp.asarray(m))
    step, step32 = _step(rcfg), _step(rcfg32)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (BATCH, STEPS))
    port_d = ref_d = 0.0
    for i in range(STEPS):
        tok, pos = tokens[:, i:i + 1], jnp.asarray(i, jnp.int32)
        logits, cache = D.serve_step(cfg, prm, cache, torch.from_numpy(tok), i)
        rlogits, rcache = step(rprm, rcache, jnp.asarray(tok), pos)
        f32, rcache32 = step32(rprm32, rcache32, jnp.asarray(tok), pos)
        f32 = np.asarray(f32)
        assert logits.dtype == torch.float32 and bool(logits.isfinite().all())
        port_d = max(port_d, float(np.abs(logits.numpy() - f32).max()))
        ref_d = max(ref_d, float(np.abs(np.asarray(rlogits) - f32).max()))
        assert D.cache_num_bytes(cache) == RD.cache_num_bytes(rcache), i
        if cfg.family == "ssm":
            assert cache["lyr"]["wkv"].dtype == torch.float32
            assert str(rcache["lyr"]["wkv"].dtype) == "float32"
            assert cache["lyr"]["shift_tm"].dtype == torch.bfloat16
        if m is not None:
            cross = cache["lyr"]["cross"] if cfg.family == "audio" \
                else cache["cross"]
            assert cross["k"].dtype == cross["v"].dtype == torch.bfloat16
        if cfg.family == "hybrid":
            assert cache["mamba"]["h"].dtype == torch.float32
            assert str(rcache["mamba"]["h"].dtype) == "float32"
            assert cache["mamba"]["conv"].dtype == torch.bfloat16
            assert cache["attn"]["k"].dtype == torch.bfloat16
    assert ref_d > 0.0
    assert port_d <= ref_d * (1 + MARGIN), \
        f"{name}: port bf16 {port_d:.4f} from f32, reference {ref_d:.4f}"


def test_rwkv_state_is_created_in_the_model_dtype():
    """Before any step the reference's wkv state is bf16, as the port's; the
    cache bytes grow at the first step in both (C.13)."""
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(), dtype="bfloat16")
    rcfg = dataclasses.replace(ref_config("rwkv6-7b").reduced(),
                               dtype="bfloat16")
    prm = P.init_params(cfg, seed=0, device="cpu")
    rprm = RP.init_params(rcfg, seed=0)
    cache, rcache = D.init_cache(cfg, prm, 4, 8), RD.init_cache(rcfg, rprm, 4, 8)
    assert cache["lyr"]["wkv"].dtype == torch.bfloat16
    assert str(rcache["lyr"]["wkv"].dtype) == "bfloat16"
    before = D.cache_num_bytes(cache)
    assert before == RD.cache_num_bytes(rcache)
    D.serve_step(cfg, prm, cache, torch.ones((4, 1), dtype=torch.long), 0)
    wkv = cache["lyr"]["wkv"]
    assert D.cache_num_bytes(cache) == before + wkv.numel() * 2


@pytest.mark.parametrize("form", ["fused", "per-group list"])
def test_mamba_state_turns_f32_after_the_first_step(form):
    """C.14: the reference's ``init_cache`` makes the Mamba ``h`` leaves in
    bf16, and its step returns them in float32 (``decay_scan_step``), while
    the conv window and the shared block's k/v stay bf16.  The port binds
    float32 states before its first step, in the fused cache and in the
    sliced step's list form, so its cache bytes are the reference's at init
    and after every step."""
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                              dtype="bfloat16")
    rcfg = dataclasses.replace(ref_config("zamba2-7b").reduced(),
                               dtype="bfloat16")
    prm = P.init_params(cfg, seed=0, device="cpu")
    rprm = RP.init_params(rcfg, seed=0)
    if form == "fused":
        cache, rcache = D.init_cache(cfg, prm, 4, 8), RD.init_cache(rcfg, rprm, 4, 8)
        step, rstep = D.make_serve_step(cfg), _step(rcfg)
        hs = lambda c: [c["mamba"]["h"]]                     # noqa: E731
    else:
        cache = D.ProfiledServeStep.init_cache(cfg, prm, 4, 8)
        rcache = RD.ProfiledServeStep.init_cache(rcfg, rprm, 4, 8)
        prof, rprof = D.make_profiled_serve_step(cfg), RD.ProfiledServeStep(rcfg)
        step = lambda *a: prof(*a)[:2]                        # noqa: E731
        rstep = lambda *a: rprof(*a)[:2]                      # noqa: E731
        hs = lambda c: [g["mamba"]["h"] for g in c]           # noqa: E731
    assert all(h.dtype == torch.bfloat16 for h in hs(cache))
    assert all(str(h.dtype) == "bfloat16" for h in hs(rcache))
    before = D.cache_num_bytes(cache)
    assert before == RD.cache_num_bytes(rcache)
    tok = np.ones((4, 1), np.int64)
    for i in range(2):
        _, cache = step(prm, cache, torch.from_numpy(tok), i)
        _, rcache = rstep(rprm, rcache, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(i, jnp.int32))
        assert all(h.dtype == torch.float32 for h in hs(cache))
        assert all(str(h.dtype) == "float32" for h in hs(rcache))
        assert D.cache_num_bytes(cache) == RD.cache_num_bytes(rcache) \
            == before + sum(h.numel() * 2 for h in hs(cache))
