"""The port's decode path against the reference's, on the CPU.

``repro_torch.models.decode`` (every family) against
``repro.models.decode`` on the same weights and tokens: the serve step's
logits step by step at 1e-5 in float32 (plain, ring and int8 caches,
RWKV6's O(1) state, zamba2's Mamba states beside its shared block's KV
cache, olmoe's banked experts, whisper's self and cross caches over its
encoder's output, the VLM's four self caches a group and its cross caches
over the patches), the cache's contents, the teacher-forced twin of
``tests/test_decode_consistency.py`` at its 2e-2 over all seven of its
``ARCHS``, the slot surgery, the traps ``ROADMAP.md`` C.7 and C.8 pin, the
sliced step bit for bit against the fused one, and the analytic FLOPs
against ``FlopCounterMode``.  whisper and the VLM decode with a modality
drawn from numpy, filled into the cross caches by ``init_cache``, and the
VLM's cross gates set non-zero in both packages (C.15: they are drawn as
zeros, which would hide the cross layer).
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
from repro.obs import modelprof as RMPF  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import modelprof as MPF  # noqa: E402

F32 = 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _both(name, kv="", **over):
    """The reduced configs and the reference's seeded weights in both
    packages; the VLM's cross gates set to the same non-zero values."""
    cfg = dataclasses.replace(get_config(name).reduced(), kv_cache_dtype=kv,
                              **over)
    rcfg = dataclasses.replace(ref_config(name).reduced(), kv_cache_dtype=kv,
                               **over)
    rprm = RP.init_params(rcfg, seed=0)
    if cfg.family == "vlm":
        g = np.random.default_rng(15).uniform(0.5, 1.5, (2, cfg.num_groups))
        rprm["blocks"]["cross"]["gate_attn"] = jnp.asarray(g[0], jnp.float32)
        rprm["blocks"]["cross"]["gate_mlp"] = jnp.asarray(-g[1], jnp.float32)
    prm = P.params_from_numpy(jax.tree.map(_np, rprm), "cpu", cfg.dtype)
    return cfg, rcfg, prm, rprm


def _modality(cfg, b):
    """(port, reference) frame or patch embeddings from numpy, as
    ``tests/test_decode_consistency.py`` draws them; (None, None) for the
    families without one."""
    if cfg.family not in ("audio", "vlm"):
        return None, None
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.num_patches
    a = np.random.default_rng(7).normal(size=(b, n, cfg.d_model))
    a = a.astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _close(got, want, tol=F32):
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


def _ref_step(rcfg):
    return jax.jit(lambda p, c, t, pos: RD.serve_step(rcfg, p, c, t, pos))


# (arch, kv cache, steps, config overrides, tolerance).  The ring runs past
# its window: qwen2 with gemma2's local/global pair at window 8, and gemma2
# itself (window 16) at 2e-4, where both packages' logits sit ~5e-5 from a
# float64 evaluation (tests/test_torch_models.py); whisper and the VLM at
# 2e-4 too, where both sit 1e-5-9e-5 from one (tests/test_torch_crossmodal.py).
CASES = {"qwen2-0.5b": ("qwen2-0.5b", "", 12, {}, F32),
         "qwen2-7b": ("qwen2-7b", "", 12, {}, F32),
         "starcoder2-7b": ("starcoder2-7b", "", 12, {}, F32),
         "qwen2 ring": ("qwen2-0.5b", "", 14,
                        dict(local_global=True, sliding_window=8,
                             num_layers=4), F32),
         "gemma2 ring": ("gemma2-27b", "", 20, {}, 2e-4),
         "qwen2-0.5b int8": ("qwen2-0.5b", "int8", 12, {}, F32),
         "qwen2 ring int8": ("qwen2-0.5b", "int8", 14,
                             dict(local_global=True, sliding_window=8,
                                  num_layers=4), F32),
         "rwkv6-7b": ("rwkv6-7b", "", 12, {}, F32),
         "zamba2-7b": ("zamba2-7b", "", 12, {}, F32),
         "olmoe-1b-7b": ("olmoe-1b-7b", "", 12, {}, F32),
         "whisper-large-v3": ("whisper-large-v3", "", 12, {}, 2e-4),
         "whisper int8": ("whisper-large-v3", "int8", 12, {}, 2e-4),
         "llama-3.2-vision-11b": ("llama-3.2-vision-11b", "", 12, {}, 2e-4)}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_step_matches_reference(case):
    """Logits every step, and the caches after the last step."""
    name, kv, steps, over, tol = CASES[case]
    cfg, rcfg, prm, rprm = _both(name, kv, **over)
    b = 2
    m, jm = _modality(cfg, b)
    cache = D.init_cache(cfg, prm, b, steps + 2, modality=m)
    rcache = RD.init_cache(rcfg, rprm, b, steps + 2, modality=jm)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, steps))
    rstep = _ref_step(rcfg)
    for i in range(steps):
        logits, cache = D.serve_step(cfg, prm, cache, torch.from_numpy(
            tokens[:, i:i + 1]), i)
        rlogits, rcache = rstep(rprm, rcache, jnp.asarray(tokens[:, i:i + 1]),
                                jnp.asarray(i, jnp.int32))
        assert logits.shape == (b, 1, cfg.vocab_size)
        assert logits.dtype == torch.float32
        _close(logits, rlogits, tol)
    got, want = dict(_leaves(cache)), dict(_leaves(rcache))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert leaf.shape == want[path].shape, path
        assert str(leaf.dtype).replace("torch.", "") == str(want[path].dtype)
        if leaf.dtype == torch.int8:      # a rounding tie may land one off
            assert np.abs(_np(leaf) - _np(want[path])).max() <= 1, path
        else:
            _close(leaf, want[path], tol)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "gemma2-27b", "rwkv6-7b",
                                  "zamba2-7b", "olmoe-1b-7b",
                                  "whisper-large-v3", "llama-3.2-vision-11b"])
def test_decode_matches_forward(name):
    """Port twin of tests/test_decode_consistency.py over all seven of its
    ``ARCHS``: teacher-forced decode reproduces the port's own forward at
    every position within 2e-2, whisper and the VLM with a modality.  MoE at
    capacity factor 8.0, as there: the full-sequence forward may drop
    tokens at a tight capacity, per-token decode never does."""
    over = dict(moe_capacity_factor=8.0) if name == "olmoe-1b-7b" else {}
    cfg, _, prm, _ = _both(name, **over)
    b, s = 2, 24 if cfg.local_global else 12
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)))
    m, _ = _modality(cfg, b)
    full, _ = T.forward(cfg, prm, tokens, modality=m)
    cache = D.init_cache(cfg, prm, b, max_len=s + 4, modality=m)
    step = D.make_serve_step(cfg)
    errs = []
    for i in range(s):
        logits_i, cache = step(prm, cache, tokens[:, i:i + 1], i)
        errs.append(float((logits_i[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 2e-2, f"{name}: max logit divergence {max(errs):.4f}"


def test_int8_kv_cache_close_to_forward():
    cfg, _, prm, _ = _both("qwen2-0.5b")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    full, _ = T.forward(cfg, prm, tokens)
    cache = D.init_cache(cfg8, prm, 2, max_len=16)
    assert cache["lyr"]["k"].dtype == torch.int8
    assert cache["lyr"]["k_scale"].dtype == torch.float32
    errs = []
    for i in range(12):
        li, cache = D.serve_step(cfg8, prm, cache, tokens[:, i:i + 1], i)
        errs.append(float((li[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 0.35, f"int8 cache divergence {max(errs):.3f}"


@pytest.mark.parametrize("max_len", [8, 40])
@pytest.mark.parametrize("name,kv", [("qwen2-0.5b", ""), ("qwen2-0.5b", "int8"),
                                     ("gemma2-27b", ""), ("rwkv6-7b", ""),
                                     ("zamba2-7b", ""), ("olmoe-1b-7b", ""),
                                     ("whisper-large-v3", ""),
                                     ("whisper-large-v3", "int8"),
                                     ("llama-3.2-vision-11b", "")])
def test_cache_layout_and_stats_match_reference(name, kv, max_len):
    """``cache_max_len`` is the largest ``shape[-2]`` of a leaf with four
    axes or more, in the reference and in the port.  RWKV6's cache has no
    length axis: it reads the wkv state's ``head_dim``.  zamba2's also reads
    the Mamba ``h`` leaf's ``ssm_state`` (16 reduced, 64 at full width), so
    it is ``max(max_len, ssm_state)``: 16 for a cache of 8.  The VLM's reads
    the cross K/V's patch axis (9 reduced), and whisper's is its self
    cache's length whatever ``encoder_seq`` is (C.17)."""
    cfg, rcfg, prm, rprm = _both(name, kv)
    assert D.cache_shapes(cfg, 3, max_len) == RD.cache_shapes(rcfg, 3, max_len)
    assert D.cache_batch_axes(cfg) == RD.cache_batch_axes(rcfg)
    cache = D.init_cache(cfg, prm, 3, max_len)
    rcache = RD.init_cache(rcfg, rprm, 3, max_len)
    assert D.step_stats(cfg, cache) == RD.step_stats(rcfg, rcache)
    want = {"ssm": cfg.head_dim, "hybrid": max(max_len, cfg.ssm_state),
            "vlm": max(max_len, cfg.num_patches)}
    assert D.cache_max_len(cfg, cache) == RD.cache_max_len(rcfg, rcache) \
        == want.get(cfg.family, max_len)
    assert all(not leaf.any() for _, leaf in _leaves(cache))


@pytest.mark.parametrize("name,kv", [("qwen2-0.5b", ""), ("qwen2-0.5b", "int8"),
                                     ("gemma2-27b", ""), ("rwkv6-7b", ""),
                                     ("zamba2-7b", ""), ("olmoe-1b-7b", ""),
                                     ("whisper-large-v3", ""),
                                     ("whisper-large-v3", "int8"),
                                     ("llama-3.2-vision-11b", "")])
@pytest.mark.parametrize("form", ["fused", "per-group list"])
def test_cache_slot_reset_and_corrupt(name, kv, form):
    """Port twin of tests/test_serve_faults.py's slot surgery, on the fused
    cache and on the sliced step's per-group list form, which are views of
    one stacked cache: the surgery reaches the stacked tensors, the cross
    K/V at their batch axes too (1 behind the group axis; the VLM's self
    caches at 2, behind their layer axis)."""
    cfg = dataclasses.replace(get_config(name).reduced(), kv_cache_dtype=kv)
    prm = P.init_params(cfg, seed=0, device="cpu")
    fused = D.init_cache(cfg, prm, 3, 8)
    for _, leaf in _leaves(fused):
        leaf.fill_(1)
    cache = fused if form == "fused" else \
        [T.group_params(fused, g) for g in range(cfg.num_groups)]
    assert D.corrupt_cache_slot(cfg, cache, 1) is cache
    axes = dict(_leaves(D.cache_batch_axes(cfg)))
    for path, leaf in _leaves(fused):
        rows = leaf.movedim(axes[path], 0)
        assert rows.shape[0] == 3
        if leaf.is_floating_point():
            assert bool(rows[1].isnan().all()), path
        else:
            assert bool((rows[1] == 1).all()), path  # int8 holds no NaN
        assert bool(rows[0].float().isfinite().all())
        assert bool(rows[2].float().isfinite().all())
    assert D.reset_cache_slot(cfg, cache, 1) is cache
    for path, leaf in _leaves(fused):
        rows = leaf.movedim(axes[path], 0)
        assert bool((rows[1] == 0).all())
        assert bool((rows[0] == 1).all()) and bool((rows[2] == 1).all())


def test_stale_slot_entries_are_attended():
    """C.7: one global ``pos``.  A request admitted at step P writes at P and
    attends to its slot's entries 0..P-1 too (zeros, or an earlier
    request's keys); both packages give the same logits either way."""
    cfg, rcfg, prm, rprm = _both("qwen2-0.5b")
    rng = np.random.default_rng(2)
    earlier = rng.integers(0, cfg.vocab_size, (2, 3))
    new = rng.integers(0, cfg.vocab_size, (2, 1))
    rstep = _ref_step(rcfg)
    results = []
    for stale in (False, True):
        cache = D.init_cache(cfg, prm, 2, 8)
        rcache = RD.init_cache(rcfg, rprm, 2, 8)
        if stale:                     # an earlier request left positions 0..2
            for i in range(3):
                _, cache = D.serve_step(cfg, prm, cache, torch.from_numpy(
                    earlier[:, i:i + 1]), i)
                _, rcache = rstep(rprm, rcache, jnp.asarray(earlier[:, i:i + 1]),
                                  jnp.asarray(i, jnp.int32))
        logits, _ = D.serve_step(cfg, prm, cache, torch.from_numpy(new), 3)
        rlogits, _ = rstep(rprm, rcache, jnp.asarray(new), jnp.asarray(3, jnp.int32))
        _close(logits, rlogits)
        results.append(_np(logits))
    assert np.abs(results[0] - results[1]).max() > 1e-3


def test_write_past_the_cache_end_clamps():
    """C.8: a write position past ``max_len - 1`` writes the last slot, as
    ``dynamic_update_slice`` clamps, rather than failing."""
    cfg, rcfg, prm, rprm = _both("qwen2-0.5b")
    cache, rcache = D.init_cache(cfg, prm, 2, 4), RD.init_cache(rcfg, rprm, 2, 4)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 1))
    logits, cache = D.serve_step(cfg, prm, cache, torch.from_numpy(tok), 6)
    rlogits, rcache = _ref_step(rcfg)(rprm, rcache, jnp.asarray(tok),
                                      jnp.asarray(6, jnp.int32))
    _close(logits, rlogits)
    k = cache["lyr"]["k"]
    assert bool(k[:, :, :, 3].abs().sum() > 0)
    assert not k[:, :, :, :3].any()
    _close(k, rcache["lyr"]["k"])


def test_ring_slots_use_floor_mod():
    """C.4: before the ring fills, the slots ahead of ``pos`` are empty: with
    C's remainder (``fmod``) their absolute positions would come out
    non-negative and count as valid; ``torch.remainder`` keeps them out."""
    pos, smax = 2, 16
    k_pos = torch.arange(smax)
    floor = pos - torch.remainder(pos - k_pos, smax)
    trunc = pos - torch.fmod(pos - k_pos, smax)
    assert int((floor >= 0).sum()) == pos + 1
    assert int((trunc >= 0).sum()) == smax


@pytest.mark.parametrize("name,kv", [("qwen2-0.5b", ""), ("gemma2-27b", ""),
                                     ("qwen2-0.5b", "int8"), ("rwkv6-7b", ""),
                                     ("zamba2-7b", ""), ("olmoe-1b-7b", "")])
def test_profiled_step_equals_fused(name, kv):
    """The sliced step gives the fused step's logits and cache bit for bit,
    through a slot corruption and quarantine on both forms."""
    cfg = dataclasses.replace(get_config(name).reduced(), kv_cache_dtype=kv)
    prm = P.init_params(cfg, seed=0, device="cpu")
    fused, prof = D.make_serve_step(cfg), D.make_profiled_serve_step(cfg)
    assert D.make_serve_step(cfg) is fused
    assert D.make_profiled_serve_step(cfg) is prof
    cache_f = D.init_cache(cfg, prm, 2, 20)
    cache_p = D.ProfiledServeStep.init_cache(cfg, prm, 2, 20)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 1)))
    for i in range(6):
        if i == 3:
            for c in (cache_f, cache_p):
                D.corrupt_cache_slot(cfg, c, 0)
                D.reset_cache_slot(cfg, c, 0)
        lf, cache_f = fused(prm, cache_f, tok, i)
        lp, cache_p, walls = prof(prm, cache_p, tok, i)
        assert len(walls) == len(prof.ops) == len(D.profile_ops(cfg))
        assert all(w >= 0 for w in walls)
        assert torch.equal(lf, lp)
        tok = lf[:, -1].argmax(-1)[:, None]
    stacked = D.ProfiledServeStep.stack_cache(cache_p)
    for (pa, a), (pb, b) in zip(_leaves(cache_f), _leaves(stacked)):
        assert pa == pb and torch.equal(a, b)


def test_profile_ops_match_reference():
    for name in ("qwen2-0.5b", "gemma2-27b", "starcoder2-7b", "rwkv6-7b",
                 "olmoe-1b-7b", "zamba2-7b"):
        assert D.profile_ops(get_config(name).reduced()) \
            == RD.profile_ops(ref_config(name).reduced())
    for name in ("whisper-large-v3", "llama-3.2-vision-11b"):
        with pytest.raises(NotImplementedError) as got:
            D.profile_ops(get_config(name).reduced())
        with pytest.raises(NotImplementedError) as want:
            RD.profile_ops(ref_config(name).reduced())
        assert str(got.value) == str(want.value)
        with pytest.raises(NotImplementedError):
            D.make_profiled_serve_step(get_config(name).reduced())


@pytest.mark.parametrize("name,cache_len", [("qwen2-0.5b", 32),
                                            ("starcoder2-7b", 32),
                                            ("gemma2-27b", 16),
                                            ("rwkv6-7b", 32),
                                            ("zamba2-7b", 32),
                                            ("olmoe-1b-7b", 32),
                                            ("granite-moe-1b-a400m", 32)])
def test_analytic_costs_and_flop_counter(name, cache_len):
    """The analytic cost model equals the reference's, and its summed
    dot-FLOPs agree with FlopCounterMode over the port's serve step within
    the reference's FLOPS_RTOL.  gemma2 at a cache no longer than its window
    of 16: the model counts a local layer's scores over the whole cache,
    while its ring holds only the window (at 32: 2.3% over)."""
    cfg, rcfg = get_config(name).reduced(), ref_config(name).reduced()
    assert MPF.analytic_op_costs(cfg, 2, cache_len) \
        == [MPF.OpCost(c.op, c.group, c.flops, c.bytes_rw)
            for c in RMPF.analytic_op_costs(rcfg, 2, cache_len)]
    report, problems = MPF.crosscheck_flops(cfg, batch=2, cache_len=cache_len,
                                            device="cpu")
    assert problems == [], report
    assert report["flops_rel_err"] <= MPF.FLOPS_RTOL == RMPF.FLOPS_RTOL
    assert report["counted_flops"] > 0
