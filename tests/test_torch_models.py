"""The port's dense-model modules against the reference's, on the CPU.

``repro_torch.models.{config,common,params,mlp,attention,transformer}``
against ``repro.models.*`` on the same numpy-seeded inputs: float32 at
1e-5 (reduced configs), single layers in bf16 at 2e-2, each as rtol and as
atol relative to the output's scale (max |want|, at least 1: with blocks
drawn at std 1/sqrt(num_groups), C.6, attention outputs reach ~90, and
both packages then sit ~2e-4 from a float64 evaluation); the
seeded weights bit for bit (``ROADMAP.md`` C.3, C.6); ``param_shapes`` and
``count_params`` for all ten registered configs at full width.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro.models import mlp as RM  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.models import all_names, get_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import mlp as M  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DENSE = ["qwen2-0.5b", "qwen2-7b", "starcoder2-7b", "gemma2-27b"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values for both packages: float32 first, then the dtype."""
    a = np.asarray(a, np.float32)
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(jnp.dtype(dtype)))


def _both(name: str, dtype: str = "float32", seed: int = 0):
    """(port cfg, reference cfg, port params, reference params) at the
    reduced config, the port's weights carried over from the reference's."""
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
    rcfg = dataclasses.replace(ref_config(name).reduced(), dtype=dtype)
    rprm = RP.init_params(rcfg, seed=seed)
    prm = P.params_from_numpy(jax.tree.map(_np, rprm), "cpu", dtype)
    return cfg, rcfg, prm, rprm


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _close(got, want, tol):
    """|got - want| <= tol * (|want| + max(1, max |want|)), elementwise."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


# -- configs, shapes, counts ---------------------------------------------------


def test_registry_matches_reference():
    from repro.models import all_names as ref_names
    assert all_names() == ref_names()
    for name in all_names():
        assert dataclasses.asdict(get_config(name)) \
            == dataclasses.asdict(ref_config(name))
        assert dataclasses.asdict(get_config(name).reduced()) \
            == dataclasses.asdict(ref_config(name).reduced())


@pytest.mark.parametrize("name", sorted(
    ["olmoe-1b-7b", "granite-moe-1b-a400m", "llama-3.2-vision-11b",
     "gemma2-27b", "qwen2-0.5b", "starcoder2-7b", "qwen2-7b", "zamba2-7b",
     "whisper-large-v3", "rwkv6-7b"]))
def test_param_shapes_and_counts_at_full_width(name):
    cfg, rcfg = get_config(name), ref_config(name)
    assert P.param_shapes(cfg) == RP.param_shapes(rcfg)
    for active in (False, True):
        assert P.count_params(cfg, active_only=active) \
            == RP.count_params(rcfg, active_only=active)


def test_qwen2_0_5b_size():
    """About 494 M parameters, every block weight drawn at 1/sqrt(24)."""
    cfg = get_config("qwen2-0.5b")
    assert 490e6 < P.count_params(cfg) < 500e6
    assert P.param_shapes(cfg)["blocks"]["lyr"]["attn"]["wq"] \
        == ((24, 896, 896), "normal")


# -- init_params: the same weights, bit for bit ---------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(
    ["olmoe-1b-7b", "granite-moe-1b-a400m", "llama-3.2-vision-11b",
     "gemma2-27b", "qwen2-0.5b", "starcoder2-7b", "qwen2-7b", "zamba2-7b",
     "whisper-large-v3", "rwkv6-7b"]))
def test_init_params_bit_identical(name, dtype):
    """``init_params`` equals the reference's draw, and the carried-over
    reference parameters, bit for bit (every family's draw kinds)."""
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
    rcfg = dataclasses.replace(ref_config(name).reduced(), dtype=dtype)
    mine = P.init_params(cfg, seed=3, device="cpu")
    ref = RP.init_params(rcfg, seed=3)
    carried = P.params_from_numpy(jax.tree.map(_np, ref), "cpu", dtype)
    got, want = dict(_leaves(mine)), dict(_leaves(ref))
    assert sorted(got) == sorted(want) == sorted(dict(_leaves(carried)))
    for path, leaf in got.items():
        assert leaf.dtype == getattr(torch, dtype), path
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        np.testing.assert_array_equal(_np(leaf), _np(want[path]), err_msg=path)
        assert torch.equal(leaf, dict(_leaves(carried))[path]), path


def test_draw_order_sorted_and_scale_reads_the_group_axis():
    """C.3: the first normal drawn is ``blocks/lyr/attn/wk`` (sorted keys:
    blocks before embed; bk, bq, bv are zeros), not ``embed``.  C.6: it is
    drawn at std 1/sqrt(num_groups), the stacked axis, not 1/sqrt(d_model)."""
    cfg = get_config("qwen2-0.5b").reduced()
    prm = P.init_params(cfg, seed=5, device="cpu")
    wk = prm["blocks"]["lyr"]["attn"]["wk"]
    rng = np.random.default_rng(5)
    want = rng.normal(0.0, 1.0 / np.sqrt(cfg.num_groups),
                      tuple(wk.shape)).astype(np.float32)
    np.testing.assert_array_equal(wk.numpy(), want)
    assert not np.array_equal(
        prm["embed"].numpy(),
        np.random.default_rng(5).normal(0.0, 0.02, tuple(prm["embed"].shape))
        .astype(np.float32))


def test_init_params_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        P.init_params(get_config("qwen2-0.5b").reduced())


# -- common -------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_norms_activations_softcap(dtype, tol):
    rng = np.random.default_rng(0)
    x, jx = _pair(rng.normal(size=(2, 5, 64)), dtype)
    w, jw = _pair(rng.normal(size=(64,)), dtype)
    b, jb = _pair(rng.normal(size=(64,)), dtype)
    for plus_one in (False, True):
        _close(C.rms_norm(x, w, plus_one=plus_one),
               RC.rms_norm(jx, jw, plus_one=plus_one), tol)
    _close(C.layer_norm(x, w, b), RC.layer_norm(jx, jw, jb), tol)
    for name in ("qwen2-0.5b", "gemma2-27b", "rwkv6-7b", "whisper-large-v3"):
        cfg, rcfg = get_config(name), ref_config(name)
        _close(C.norm(cfg, {"w": w, "b": b}, x),
               RC.norm(rcfg, {"w": jw, "b": jb}, jx), tol)
    for name in ("qwen2-0.5b", "starcoder2-7b", "rwkv6-7b"):   # silu, gelu, relu
        _close(C.activation(get_config(name), x),
               RC.activation(ref_config(name), jx), tol)
    _close(C.softcap(x * 40, 30.0), RC.softcap(jx * 40, 30.0), tol)
    assert C.softcap(x, 0.0) is x


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_rope(dtype, tol):
    rng = np.random.default_rng(1)
    for theta, pos in ((1e6, np.arange(12)), (1e4, np.array([[7], [30]]))):
        cos, sin = C.rope_freqs(16, theta, torch.from_numpy(pos))
        rcos, rsin = RC.rope_freqs(16, theta, jnp.asarray(pos))
        _close(cos, rcos, F32)
        _close(sin, rsin, F32)
        b = 1 if pos.ndim == 1 else pos.shape[0]
        x, jx = _pair(rng.normal(size=(b, 3, pos.shape[-1], 16)), dtype)
        got = C.apply_rope(x, cos, sin)
        assert got.dtype == x.dtype
        _close(got, RC.apply_rope(jx, rcos, rsin), tol)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "gemma2-27b", "qwen2-7b"])
def test_embed_and_head(name):
    cfg, rcfg, prm, rprm = _both(name)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7))
    x = C.embed(cfg, prm, torch.from_numpy(tokens))
    jx = RC.embed(rcfg, rprm, jnp.asarray(tokens))
    _close(x, jx, F32)
    logits = C.lm_logits(cfg, prm, x)
    assert logits.dtype == torch.float32
    _close(logits, RC.lm_logits(rcfg, rprm, jx), F32)


# -- mlp, attention -------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen2-0.5b", "starcoder2-7b"])
def test_mlp_and_qkv_and_attn_block(name):
    cfg, rcfg, prm, rprm = _both(name)
    lp = T.group_params(prm["blocks"], 1)["lyr"]
    rlp = jax.tree.map(lambda a: a[1], rprm["blocks"])["lyr"]
    x, jx = _pair(np.random.default_rng(3).normal(size=(2, 9, cfg.d_model)))
    _close(M.mlp_block(cfg, lp["mlp"], x), RM.mlp_block(rcfg, rlp["mlp"], jx),
           F32)
    for got, want in zip(A.qkv_proj(cfg, lp["attn"], x),
                         RA.qkv_proj(rcfg, rlp["attn"], jx)):
        _close(got, want, F32)
    rope = C.rope_freqs(cfg.head_dim, cfg.rope_theta, torch.arange(9))
    rrope = RC.rope_freqs(rcfg.head_dim, rcfg.rope_theta, jnp.arange(9))
    _close(A.attn_block(cfg, lp["attn"], x, rope=rope),
           RA.attn_block(rcfg, rlp["attn"], jx, rope=rrope), F32)
    # cross attention: keys and values from another sequence, no rope
    kv, jkv = _pair(np.random.default_rng(8).normal(size=(2, 13, cfg.d_model)))
    _close(A.attn_block(cfg, lp["attn"], x, rope=rope, kv_x=kv),
           RA.attn_block(rcfg, rlp["attn"], jx, rope=rrope, kv_x=jkv), F32)


@pytest.mark.parametrize("name", DENSE)
def test_dense_layer_in_bf16(name):
    """One layer in bf16 (the model dtype of every registered config)."""
    cfg, rcfg, prm, rprm = _both(name, "bfloat16")
    gp = T.group_params(prm["blocks"], 0)
    rgp = jax.tree.map(lambda a: a[0], rprm["blocks"])
    key = "local" if cfg.local_global else "lyr"
    x, jx = _pair(np.random.default_rng(4).normal(size=(2, 20, cfg.d_model)),
                  "bfloat16")
    rope = C.rope_freqs(cfg.head_dim, cfg.rope_theta, torch.arange(20))
    rrope = RC.rope_freqs(rcfg.head_dim, rcfg.rope_theta, jnp.arange(20))
    window = cfg.sliding_window if cfg.local_global else 0
    got = T.dense_layer(cfg, gp[key], x, rope, window=window)
    assert got.dtype == torch.bfloat16
    _close(got, RT.dense_layer(rcfg, rgp[key], jx, rrope, window=window), BF16)


CHUNKED = {
    "causal": dict(causal=True),
    "not causal": dict(causal=False),
    "window": dict(causal=True, window=6),
    "softcap": dict(causal=True, attn_softcap=5.0),
    "padded": dict(causal=True, sq=13, sk=13),
    "padded not causal": dict(causal=False, sq=11, sk=21),
    "q_offset": dict(causal=True, sq=8, sk=24, q_offset=16),
    "window softcap q_offset": dict(causal=True, window=5, attn_softcap=3.0,
                                    sq=8, sk=24, q_offset=16),
}


@pytest.mark.parametrize("case", list(CHUNKED))
@pytest.mark.parametrize("chunks", [(4, 4), (8, 4), (512, 512)])
def test_chunked_attention(case, chunks):
    kw = dict(CHUNKED[case])
    sq, sk = kw.pop("sq", 16), kw.pop("sk", 16)
    rng = np.random.default_rng(len(case) * 7 + chunks[0])
    q, jq = _pair(rng.normal(size=(2, 4, sq, 8)))
    k, jk = _pair(rng.normal(size=(2, 2, sk, 8)))
    v, jv = _pair(rng.normal(size=(2, 2, sk, 8)))
    qc, kc = chunks
    got = A.chunked_attention(q, k, v, scale=8 ** -0.5, q_chunk=qc,
                              kv_chunk=kc, **kw)
    want = RA.chunked_attention(jq, jk, jv, scale=8 ** -0.5, q_chunk=qc,
                                kv_chunk=kc, **kw)
    assert got.shape == (2, 4, sq, 8)
    _close(got, want, F32)


def test_chunked_attention_bf16_accumulates_in_f32():
    rng = np.random.default_rng(9)
    q, jq = _pair(rng.normal(size=(1, 4, 32, 16)), "bfloat16")
    k, jk = _pair(rng.normal(size=(1, 1, 32, 16)), "bfloat16")
    v, jv = _pair(rng.normal(size=(1, 1, 32, 16)), "bfloat16")
    got = A.chunked_attention(q, k, v, scale=0.25, q_chunk=8, kv_chunk=8)
    assert got.dtype == torch.bfloat16
    _close(got, RA.chunked_attention(jq, jk, jv, scale=0.25, q_chunk=8,
                                     kv_chunk=8), BF16)


# -- forward, loss --------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE + ["olmoe-1b-7b", "granite-moe-1b-a400m",
                                          "zamba2-7b"])
def test_forward_and_loss_match_reference(name):
    """At 1e-5; gemma2 and zamba2 at 2e-4, where both packages' logits sit
    ~5e-5 (gemma2: the x8 embedding scale and both softcaps) and 7e-5-8e-5
    (zamba2: Mamba layers whose outputs reach ~1e6 at the reduced config)
    from a float64 evaluation.  The MoE auxiliary losses, summed over
    groups, are the reference's, and so are ``loss_fn``'s MoE terms."""
    tol = dict(rtol=2e-4, atol=2e-4) \
        if name.startswith(("gemma", "zamba")) else F32
    cfg, rcfg, prm, rprm = _both(name)
    s = 24 if cfg.local_global else 12        # past gemma2's window of 16
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, s))
    logits, aux = T.forward(cfg, prm, torch.from_numpy(tokens))
    rlogits, raux = RT.forward(rcfg, rprm, jnp.asarray(tokens))
    assert sorted(aux) == sorted(raux) and logits.dtype == torch.float32
    assert bool(aux) == (cfg.family == "moe")
    for k in aux:
        _close(aux[k], raux[k], tol)
    _close(logits, rlogits, tol)
    mask = (np.arange(s) % 5 != 0)[None].repeat(2, 0).astype(np.int32)
    for batch in ({"tokens": tokens}, {"tokens": tokens, "mask": mask}):
        loss, metrics = T.loss_fn(cfg, prm, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
        rloss, rmetrics = RT.loss_fn(rcfg, rprm, {k: jnp.asarray(v)
                                                 for k, v in batch.items()})
        assert sorted(metrics) == sorted(rmetrics)
        _close(loss, rloss, tol)
        for k in metrics:
            _close(metrics[k], rmetrics[k], tol)


def test_chunked_ce_over_several_chunks():
    cfg, rcfg, prm, rprm = _both("qwen2-0.5b")
    rng = np.random.default_rng(7)
    x, jx = _pair(rng.normal(size=(2, 16, cfg.d_model)))
    tokens = rng.integers(0, cfg.vocab_size, (2, 16))
    for chunk in (4, 5, 16):
        _close(T.chunked_ce(cfg, prm, x, torch.from_numpy(tokens), chunk=chunk),
               RT.chunked_ce(rcfg, rprm, jx, jnp.asarray(tokens), chunk=chunk),
               F32)
