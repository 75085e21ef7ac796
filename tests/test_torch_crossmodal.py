"""The port's audio (whisper) and vlm (Llama-3.2-vision) families against the
reference's, on the CPU.

``repro_torch.models.{common,transformer,decode}``'s modality paths against
``repro.models.*`` on the same numpy-seeded weights and inputs: the
sinusoid table, the whisper encoder and decoder layers, the VLM's gated
cross layer, ``encode_audio``, ``forward`` and ``loss_fn`` with a modality,
``init_cache``'s cross K/V and ``_cross_decode``, at the reduced configs
(12 frames, 9 patches) and at 1500 frames / 1601 patches with the reduced
width, where the non-causal chunked attention pads to 1536 / 2048 keys and
masks the padding (``ROADMAP.md`` C.18).

Tolerances, each as rtol and as atol relative to the output's scale (max
|want|, at least 1).  The layers, ``_cross_decode`` and the reduced cross
caches hold ``tests/test_torch_models.py``'s F32 (1e-5) and BF16 (2e-2).
The whole models hold 2e-4 in float32 (``DEEP``, as that file holds
gemma2 and zamba2): the seeded weights (blocks drawn at std
1/sqrt(num_groups), C.6; the VLM's gates at up to 1.5) make both packages
sit 1e-5-1e-4 from a float64 evaluation of the same weights, measured on
the CPU: whisper port / reference 1.6e-5 / 9.5e-6 (scale 0.65), at 1500
frames both 1.5e-3 (the float32 table at angles up to 1499 rad) and 2.6e-4
from each other; VLM 8.9e-5 / 6.8e-5 (scale 4.0), at 1601 patches 7.8e-5 /
7.5e-5.  Whisper at 1500 frames is held at 5e-4 (``ENC1500``): 1.5e-3
from float64 in both packages is 7.5 times ``DEEP``.  In bf16 the reference's own logits sit further from a float32
evaluation of the same bf16-rounded weights than 2e-2 of their scale, so a
whole model in bf16 is held as ``tests/test_torch_bf16_decode.py`` holds
decode (C.0): the port no further from that float32 evaluation than the
reference, plus a quarter of the reference's distance (``_no_further``).

The VLM's cross gates are zeros at init (C.15), so ``tanh(0) = 0`` hides
the whole cross layer: every comparison of the cross path sets the same
non-zero gates in both packages from the same numpy values (``_gates``),
and ``test_vlm_cross_gates_are_zero_at_init`` holds the drawn zeros.  C.16
(the audio position table clamps), C.17 (``cache_max_len`` by family) and
C.18 are each pinned by a test of that name.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.models import decode as RD  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import all_names, get_config  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DEEP = dict(rtol=2e-4, atol=2e-4)
ENC1500 = dict(rtol=5e-4, atol=5e-4)
MARGIN = 0.25            # of the reference's own bf16-to-f32 distance
NAMES = ["whisper-large-v3", "llama-3.2-vision-11b"]
# the modality's length at the reduced config, and at full length (C.18)
LONG = {"audio": dict(encoder_seq=1500), "vlm": dict(num_patches=1601)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=F32):
    """|got - want| <= tol * (|want| + max(1, max |want|)), elementwise."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _gates(groups: int) -> dict:
    """Seeded non-zero cross gates, one a group, of both signs (C.15)."""
    rng = np.random.default_rng(15)
    sign = (-1.0) ** np.arange(groups)
    return {k: (rng.uniform(0.5, 1.5, groups) * sign).astype(np.float32)
            for k in ("gate_attn", "gate_mlp")}


def _both(name, dtype="float32", gated=True, **over):
    """(port cfg, reference cfg, port params, reference params) at the
    reduced config: the reference's seeded weights, the VLM's cross gates
    set to ``_gates`` when ``gated``, the same values in both packages."""
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype, **over)
    rcfg = dataclasses.replace(ref_config(name).reduced(), dtype=dtype, **over)
    tree = jax.tree.map(_np, RP.init_params(rcfg, seed=0))
    if gated and cfg.family == "vlm":
        tree["blocks"]["cross"].update(_gates(cfg.num_groups))
    rprm = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.dtype(dtype)), tree)
    return cfg, rcfg, P.params_from_numpy(tree, "cpu", dtype), rprm


def _f32(rcfg, rprm):
    """The reference in float32 on the same (rounded) weights."""
    return (dataclasses.replace(rcfg, dtype="float32"),
            jax.tree.map(lambda a: a.astype(jnp.float32), rprm))


def _no_further(got, want, f32):
    """C.0's criterion: ``got`` (the port's bf16) no further from ``f32``
    (the reference's float32 evaluation of the same bf16-rounded values)
    than ``want`` (the reference's bf16), plus ``MARGIN`` of that."""
    f32 = _np(f32)
    port_d = float(np.abs(_np(got) - f32).max())
    ref_d = float(np.abs(_np(want) - f32).max())
    assert ref_d > 0.0
    assert port_d <= ref_d * (1 + MARGIN), \
        f"port bf16 {port_d:.4g} from f32, reference {ref_d:.4g}"


def _modality(cfg, b=2, seed=5):
    """Frame (audio) or patch (vlm) embeddings from numpy, for both."""
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.num_patches
    a = np.random.default_rng(seed).normal(size=(b, n, cfg.d_model))
    a = a.astype(np.float32)
    return (torch.from_numpy(a).to(getattr(torch, cfg.dtype)),
            jnp.asarray(a).astype(jnp.dtype(cfg.dtype)))


def _x(cfg, s, seed=4):
    x = np.random.default_rng(seed).normal(size=(2, s, cfg.d_model))
    x = x.astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, cfg.dtype)),
            jnp.asarray(x).astype(jnp.dtype(cfg.dtype)))


def _group0(prm, rprm):
    return (T.group_params(prm["blocks"], 0),
            jax.tree.map(lambda a: a[0], rprm["blocks"]))


def _ref_step(rcfg):
    return jax.jit(lambda p, c, t, pos: RD.serve_step(rcfg, p, c, t, pos))


def test_every_registered_family_is_ported():
    """No family is refused any more: the ten configs' six families are
    ``PORTED_FAMILIES``."""
    assert {get_config(n).family for n in all_names()} \
        == set(T.PORTED_FAMILIES)


# == the sinusoid table =======================================================


@pytest.mark.parametrize("seq,dim,offset", [(12, 64, 0), (1500, 1280, 0),
                                            (200, 1280, 0), (1, 1280, 199),
                                            (40, 64, 3)])
def test_sinusoid_pos_matches_reference(seq, dim, offset):
    """float32, sin in the even columns and cos in the odd ones, the
    reference's values to within two ulps of the angle (plus one of the
    value): XLA's float32 ``exp`` and ``sin``/``cos`` differ from torch's by
    one ulp in some entries (55 of the 640 ``div`` entries at d 1280), and
    an angle of up to 1499 radians, ``pos`` times that ``div`` rounded once
    more, carries it as up to two ulps of itself (2.4e-4)."""
    got = C.sinusoid_pos(seq, dim, offset)
    want = np.asarray(RC.sinusoid_pos(seq, dim, offset))
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, dim)
    angle = np.arange(offset, offset + seq, dtype=np.float32)[:, None] \
        * np.exp(-np.log(10000.0) * np.arange(0, dim, 2) / dim)
    ulp = 2 * np.spacing(np.abs(angle).astype(np.float32)) \
        + np.spacing(np.float32(1))
    err = np.abs(got.numpy() - want)
    assert (err[:, 0::2] <= ulp).all() and (err[:, 1::2] <= ulp).all()


def test_sinusoid_rows_are_the_table_rows():
    """``serve_step`` takes row ``pos`` as a table of one row at that offset:
    the same bits as that row of the whole table."""
    table = C.sinusoid_pos(200, 1280)
    for pos in (0, 1, 63, 150, 199):
        assert torch.equal(C.sinusoid_pos(1, 1280, offset=pos)[0], table[pos])


# == the layers ===============================================================


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_whisper_layers_match_reference(dtype, tol):
    """The encoder layer (non-causal self attention, LayerNorm with bias,
    tanh-approximate gelu, an ungated MLP) and the decoder layer (causal
    self attention, cross attention over the encoder's output, no rope)."""
    cfg, rcfg, prm, rprm = _both("whisper-large-v3", dtype)
    x, jx = _x(cfg, 9)
    enc, jenc = _x(cfg, 12, seed=6)
    ep = T.group_params(prm["encoder"], 1)
    rep = jax.tree.map(lambda a: a[1], rprm["encoder"])
    got = T.whisper_enc_layer(cfg, ep, enc)
    assert got.dtype == getattr(torch, dtype)
    _close(got, RT.whisper_enc_layer(rcfg, rep, jenc), tol)
    gp, rgp = _group0(prm, rprm)
    got = T.whisper_dec_layer(cfg, gp["lyr"], x, enc)
    _close(got, RT.whisper_dec_layer(rcfg, rgp["lyr"], jx, jenc), tol)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_gated_cross_dense_layer_matches_reference(dtype, tol, gated):
    """The VLM's cross layer: attention over the patches (no rope, no causal
    mask), its attention and MLP outputs scaled by ``tanh`` of the gates,
    non-zero, and at the drawn zeros (C.15)."""
    cfg, rcfg, prm, rprm = _both("llama-3.2-vision-11b", dtype, gated=gated)
    gp, rgp = _group0(prm, rprm)
    x, jx = _x(cfg, 9)
    m, jm = _modality(cfg)
    rope = C.rope_freqs(cfg.head_dim, cfg.rope_theta, torch.arange(9))
    rrope = RC.rope_freqs(rcfg.head_dim, rcfg.rope_theta, jnp.arange(9))
    got = T.dense_layer(cfg, gp["cross"], x, rope, kv_x=m, gated=True)
    assert got.dtype == getattr(torch, dtype)
    _close(got, RT.dense_layer(rcfg, rgp["cross"], jx, rrope, kv_x=jm,
                               gated=True), tol)
    assert bool((got != x).any()) == gated


@pytest.mark.parametrize("frames", [12, 1500])
def test_encode_audio_matches_reference(frames):
    """The encoder over the frames plus their sinusoid table, then
    ``enc_norm``; at 1500 frames the chunked attention pads to 1536 keys
    (C.18)."""
    over = LONG["audio"] if frames == 1500 else {}
    cfg, rcfg, prm, rprm = _both("whisper-large-v3", **over)
    m, jm = _modality(cfg)
    got = T.encode_audio(cfg, prm, m)
    assert tuple(got.shape) == (2, frames, cfg.d_model)
    _close(got, RT.encode_audio(rcfg, rprm, jm), F32 if frames == 12 else DEEP)


# == forward and loss ===========================================================


def _forward_and_loss(name, size, dtype):
    """Logits and loss (with and without a mask) of the port and the
    reference; in bf16 also the reference's float32 evaluation."""
    cfg, rcfg, prm, rprm = _both(name, dtype,
                                 **(LONG[get_config(name).family]
                                    if size == "long" else {}))
    m, jm = _modality(cfg)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12))
    mask = (np.arange(12) % 5 != 0)[None].repeat(2, 0).astype(np.int32)
    runs = [(T, cfg, prm, torch.from_numpy, m), (RT, rcfg, rprm, jnp.asarray, jm)]
    if dtype != "float32":
        rcfg32, rprm32 = _f32(rcfg, rprm)
        runs.append((RT, rcfg32, rprm32, jnp.asarray, jm.astype(jnp.float32)))
    out = []
    for mod, c, p, arr, modality in runs:
        logits, aux = mod.forward(c, p, arr(tokens), modality=modality)
        assert not aux and tuple(logits.shape) == (2, 12, cfg.vocab_size)
        losses = []
        for extra in ({}, {"mask": mask}):
            batch = {k: arr(v) for k, v in {"tokens": tokens, **extra}.items()}
            loss, metrics = mod.loss_fn(c, p, {**batch, "modality": modality})
            assert sorted(metrics) == ["ce_loss", "loss"]
            losses.append(_np(loss))
        out.append((logits, np.stack(losses)))
    assert out[0][0].dtype == torch.float32
    return out


@pytest.mark.parametrize("size", ["reduced", "long"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_match_reference(name, size):
    """float32 at ``DEEP``; "long" is 1500 frames / 1601 patches at the
    reduced width, where the encoder's and the cross layer's attention pad
    and mask (C.18)."""
    (logits, loss), (rlogits, rloss) = _forward_and_loss(name, size, "float32")
    tol = ENC1500 if size == "long" and name.startswith("whisper") else DEEP
    _close(logits, rlogits, tol)
    _close(loss, rloss, tol)


@pytest.mark.parametrize("size", ["reduced", "long"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_in_bf16_match_reference(name, size):
    """bf16, held by ``_no_further`` (C.0's criterion)."""
    (logits, loss), (rlogits, rloss), (f32, f32_loss) = \
        _forward_and_loss(name, size, "bfloat16")
    _no_further(logits, rlogits, f32)
    _no_further(loss, rloss, f32_loss)


@pytest.mark.parametrize("name", NAMES)
def test_missing_modality_is_refused(name):
    """As the reference's asserts refuse it."""
    cfg, rcfg, prm, rprm = _both(name)
    tokens = np.zeros((1, 3), np.int64)
    with pytest.raises(AssertionError, match="embeddings"):
        T.forward(cfg, prm, torch.from_numpy(tokens))
    with pytest.raises(AssertionError, match="embeddings"):
        RT.forward(rcfg, rprm, jnp.asarray(tokens))


# == the cross caches ===========================================================


@pytest.mark.parametrize("size", ["reduced", "long"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_init_cache_cross_kv_matches_reference(name, dtype, size):
    """Each group's cross K/V are its projections of the patches (vlm) or
    of the encoder's output (audio), in the model dtype; every other leaf
    is zero, and without a modality the cross K/V are zero too.  float32 at
    F32 (``DEEP`` through whisper's encoder over 1500 frames); bf16 at BF16
    for the VLM's one projection, by ``_no_further`` through the encoder."""
    cfg, rcfg, prm, rprm = _both(name, dtype,
                                 **(LONG[get_config(name).family]
                                    if size == "long" else {}))
    m, jm = _modality(cfg)
    cache = D.init_cache(cfg, prm, 2, 8, modality=m)
    rcache = RD.init_cache(rcfg, rprm, 2, 8, modality=jm)
    rcfg32, rprm32 = _f32(rcfg, rprm)
    f32 = dict(_leaves(RD.init_cache(rcfg32, rprm32, 2, 8,
                                     modality=jm.astype(jnp.float32))))
    got, want = dict(_leaves(cache)), dict(_leaves(rcache))
    assert sorted(got) == sorted(want)
    deep = cfg.family == "audio" and size == "long"
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).replace("torch.", "") == str(want[path].dtype)
        if "/cross/" not in path:
            assert not leaf.any(), path
        elif dtype == "float32":
            assert bool(leaf.any()), path
            _close(leaf, want[path], DEEP if deep else F32)
        elif cfg.family == "vlm":
            _close(leaf, want[path], BF16)
        else:
            _no_further(leaf, want[path], f32[path])
    empty = D.init_cache(cfg, prm, 2, 8)
    assert all(not leaf.any() for _, leaf in _leaves(empty))


@pytest.mark.parametrize("name", NAMES)
def test_cross_decode_matches_reference(name):
    """One token against a filled cross cache: float32 scores over the raw
    K/V, no rope, no mask, the output cast back before ``wo``."""
    cfg, rcfg, prm, rprm = _both(name)
    m, jm = _modality(cfg)
    cache = D.init_cache(cfg, prm, 2, 8, modality=m)
    rcache = RD.init_cache(rcfg, rprm, 2, 8, modality=jm)
    gp, rgp = _group0(prm, rprm)
    if cfg.family == "audio":
        p, rp = gp["lyr"]["cross"], rgp["lyr"]["cross"]
        c, rc = cache["lyr"]["cross"], rcache["lyr"]["cross"]
    else:
        p, rp = gp["cross"]["attn"], rgp["cross"]["attn"]
        c, rc = cache["cross"], rcache["cross"]
    x, jx = _x(cfg, 1)
    got = D._cross_decode(cfg, p, x, c["k"][0], c["v"][0])
    assert tuple(got.shape) == (2, 1, cfg.d_model)
    _close(got, RD._cross_decode(rcfg, rp, jx, rc["k"][0], rc["v"][0]))


# == the traps ==================================================================


def test_vlm_cross_gates_are_zero_at_init():
    """C.15: both packages draw ``gate_attn`` and ``gate_mlp`` as zeros, so
    the drawn cross layer is the identity, bit for bit, whatever the
    patches; with the same non-zero gates it is not, and both packages'
    decode then depends on the cross cache."""
    cfg, rcfg, prm, rprm = _both("llama-3.2-vision-11b", gated=False)
    for k in ("gate_attn", "gate_mlp"):
        assert not prm["blocks"]["cross"][k].any()
        assert not np.asarray(rprm["blocks"]["cross"][k]).any()
    gp, _ = _group0(prm, rprm)
    x, _ = _x(cfg, 5)
    m, _ = _modality(cfg)
    rope = C.rope_freqs(cfg.head_dim, cfg.rope_theta, torch.arange(5))
    assert torch.equal(T.dense_layer(cfg, gp["cross"], x, rope, kv_x=m,
                                     gated=True), x)
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 1)))
    for gated, moves in ((False, False), (True, True)):
        cfg, rcfg, prm, rprm = _both("llama-3.2-vision-11b", gated=gated)
        with_m = D.serve_step(cfg, prm, D.init_cache(cfg, prm, 2, 8,
                                                     modality=m), tok, 0)[0]
        without = D.serve_step(cfg, prm, D.init_cache(cfg, prm, 2, 8), tok, 0)[0]
        assert (not torch.equal(with_m, without)) == moves


def test_vlm_decode_at_the_drawn_zero_gates_matches_reference():
    """C.15's other side: at the drawn zero gates, 8 teacher-forced steps
    with a modality give the reference's logits."""
    cfg, rcfg, prm, rprm = _both("llama-3.2-vision-11b", gated=False)
    m, jm = _modality(cfg)
    cache = D.init_cache(cfg, prm, 2, 10, modality=m)
    rcache = RD.init_cache(rcfg, rprm, 2, 10, modality=jm)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    rstep = _ref_step(rcfg)
    for i in range(8):
        logits, cache = D.serve_step(cfg, prm, cache,
                                     torch.from_numpy(tokens[:, i:i + 1]), i)
        rlogits, rcache = rstep(rprm, rcache, jnp.asarray(tokens[:, i:i + 1]),
                                jnp.asarray(i, jnp.int32))
        _close(logits, rlogits)


def test_audio_position_table_clamps():
    """C.16: ``serve_step`` adds row ``pos`` of a table of ``cache_max_len``
    rows, the start clamped as ``dynamic_slice_in_dim``'s is; with C.8 the
    write clamps too.  So on a cache of 4, a step at position 6 is the step
    at position 3, bit for bit (the same row, the same slot, every slot
    unmasked), not the one at 2; both match the reference, cache included."""
    cfg, rcfg, prm, rprm = _both("whisper-large-v3")
    m, jm = _modality(cfg)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 1))
    logits = {}
    for pos in (2, 3, 6):
        cache = D.init_cache(cfg, prm, 2, 4, modality=m)
        logits[pos], cache = D.serve_step(cfg, prm, cache,
                                          torch.from_numpy(tok), pos)
        rcache = RD.init_cache(rcfg, rprm, 2, 4, modality=jm)
        rlogits, rcache = _ref_step(rcfg)(rprm, rcache, jnp.asarray(tok),
                                          jnp.asarray(pos, jnp.int32))
        _close(logits[pos], rlogits)
        for (path, leaf), (_, want) in zip(_leaves(cache), _leaves(rcache)):
            _close(leaf, want)
        if pos == 6:
            k = cache["lyr"]["self"]["k"]
            assert bool(k[..., 3, :].abs().sum() > 0)
            assert not k[..., :3, :].any()
    assert torch.equal(logits[6], logits[3])
    assert not torch.equal(logits[6], logits[2])


@pytest.mark.parametrize("max_len", [8, 40])
def test_cache_max_len_differs_by_family(max_len):
    """C.17: audio reports its self cache's length (not ``encoder_seq``, 12
    reduced); the VLM goes through the generic rule, which reads the cross
    K/V's patch axis: ``max(max_len, num_patches)``, 9 reduced.  The layout,
    the batch axes and the step's gauges are the reference's."""
    for name, want in (("whisper-large-v3", max_len),
                       ("llama-3.2-vision-11b", max(max_len, 9))):
        cfg, rcfg, prm, rprm = _both(name)
        assert D.cache_shapes(cfg, 3, max_len) == RD.cache_shapes(rcfg, 3, max_len)
        assert D.cache_batch_axes(cfg) == RD.cache_batch_axes(rcfg)
        cache = D.init_cache(cfg, prm, 3, max_len)
        rcache = RD.init_cache(rcfg, rprm, 3, max_len)
        assert D.cache_max_len(cfg, cache) == RD.cache_max_len(rcfg, rcache) \
            == want
        assert D.step_stats(cfg, cache) == RD.step_stats(rcfg, rcache)


def test_cache_max_len_at_full_width():
    """C.17 at full width, 4 slots, cache 200 (the serving settings): 200
    for whisper-large-v3, 1601 for llama-3.2-vision-11b, and the bytes of
    the reference's layout."""
    meta = {"embed": torch.empty(0, device="meta")}
    for name, want, nbytes in (("whisper-large-v3", 200, 1_114_112_000),
                               ("llama-3.2-vision-11b", 1601, 314_703_872)):
        cfg, rcfg = get_config(name), ref_config(name)
        cache = D.init_cache(cfg, meta, 4, 200)
        specs = RD.cache_specs(rcfg, 4, 200)
        assert D.cache_max_len(cfg, cache) == RD.cache_max_len(rcfg, specs) \
            == want
        assert D.cache_num_bytes(cache) == nbytes == sum(
            s.size * s.dtype.itemsize for s in jax.tree.leaves(specs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_cross_kv_stored_in_model_dtype_and_read_raw(name, kv, dtype):
    """C.18: the cross K/V are stored in ``cfg.dtype`` (bf16 when serving),
    never int8, and read raw; the self caches take int8 where asked.  Four
    steps' logits hold at F32 in float32 (int8 self caches included) and by
    ``_no_further`` in bf16; the cross K/V leave each step as they came."""
    cfg, rcfg, prm, rprm = _both(name, dtype, kv_cache_dtype=kv)
    rcfg32, rprm32 = _f32(rcfg, rprm)
    m, jm = _modality(cfg)
    cache = D.init_cache(cfg, prm, 2, 6, modality=m)
    rcache = RD.init_cache(rcfg, rprm, 2, 6, modality=jm)
    rcache32 = RD.init_cache(rcfg32, rprm32, 2, 6,
                             modality=jm.astype(jnp.float32))
    want_dtypes = {p: str(a.dtype) for p, a in _leaves(rcache)}
    assert {p: str(a.dtype).replace("torch.", "")
            for p, a in _leaves(cache)} == want_dtypes
    for path, dt in want_dtypes.items():
        if "/cross/" in path:
            assert dt == dtype, path
        elif path.endswith(("/k", "/v")):
            assert dt == ("int8" if kv else dtype), path
    cross = {p: a.clone() for p, a in _leaves(cache) if "/cross/" in p}
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 4))
    rstep, rstep32 = _ref_step(rcfg), _ref_step(rcfg32)
    got, want, f32 = [], [], []
    for i in range(4):
        tok, pos = tokens[:, i:i + 1], jnp.asarray(i, jnp.int32)
        logits, cache = D.serve_step(cfg, prm, cache, torch.from_numpy(tok), i)
        rlogits, rcache = rstep(rprm, rcache, jnp.asarray(tok), pos)
        rlogits32, rcache32 = rstep32(rprm32, rcache32, jnp.asarray(tok), pos)
        got.append(_np(logits))
        want.append(_np(rlogits))
        f32.append(_np(rlogits32))
    if dtype == "float32":
        _close(np.stack(got), np.stack(want), F32)
    else:
        _no_further(np.stack(got), np.stack(want), np.stack(f32))
    assert all(torch.equal(a, cross[p]) for p, a in _leaves(cache)
               if "/cross/" in p)
