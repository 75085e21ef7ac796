"""The port's attention against the reference's Pallas flash attention.

On the CPU ``ops.attention`` takes the plain version; it is held against
the reference's ``ops.attention`` in interpret mode on every case of
``tests/test_kernels.py::TestFlashAttention``, at that file's tolerances.
The CUDA kernel itself runs only on the card (``tests/test_torch_card.py``
and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, dict(rtol=2e-5, atol=2e-5)),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, dict(rtol=2e-2, atol=2e-2))}


def _pair(x: np.ndarray, dtype: str = "float32"):
    """The same values for both packages: float32 first, then the dtype."""
    t, j, _ = DTYPES[dtype]
    x = x.astype(np.float32)
    return torch.from_numpy(x).to(t), jnp.asarray(x).astype(j)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(rng, q_shape, kv_shape, dtype="float32"):
    q = _pair(rng.normal(size=q_shape), dtype)
    k = _pair(rng.normal(size=kv_shape), dtype)
    v = _pair(rng.normal(size=kv_shape), dtype)
    return [t for t, _ in (q, k, v)], [j for _, j in (q, k, v)]


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_and_masking_match_reference(hq, hkv, causal):
    rng = np.random.default_rng(hq * 10 + hkv)
    (q, k, v), (jq, jk, jv) = _qkv(rng, (2, hq, 64, 16), (2, hkv, 64, 16))
    out = ops.attention(q, k, v, causal=causal, block_q=16, block_k=16)
    assert out.shape == q.shape and out.dtype == q.dtype
    want = ref_ops.attention(jq, jk, jv, causal=causal, block_q=16, block_k=16)
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,bq,bk", [(32, 8, 8), (64, 32, 16), (128, 128, 128)])
def test_block_shapes_match_reference(dtype, s, bq, bk):
    rng = np.random.default_rng(s)
    (q, k, v), (jq, jk, jv) = _qkv(rng, (1, 2, s, 8), (1, 2, s, 8), dtype)
    out = ops.attention(q, k, v, causal=True, block_q=bq, block_k=bk)
    assert out.dtype == DTYPES[dtype][0]
    want = ref_ops.attention(jq, jk, jv, causal=True, block_q=bq, block_k=bk)
    np.testing.assert_allclose(_f32(out), _f32(want), **DTYPES[dtype][2])


def test_long_context_numerics_match_reference():
    """Scores scaled x8: online softmax must stay finite and agree."""
    rng = np.random.default_rng(0)
    q, jq = _pair(rng.normal(size=(1, 1, 64, 8)) * 8)
    k, jk = _pair(rng.normal(size=(1, 1, 64, 8)) * 8)
    v, jv = _pair(rng.normal(size=(1, 1, 64, 8)))
    out = ops.attention(q, k, v, causal=True, block_q=16, block_k=16)
    assert bool(torch.isfinite(out).all())
    want = ref_ops.attention(jq, jk, jv, causal=True, block_q=16, block_k=16)
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=1e-4, atol=1e-4)


def test_scale_and_non_square_match_reference():
    """An explicit scale, and S != Sk without the causal mask."""
    rng = np.random.default_rng(3)
    (q, k, v), (jq, jk, jv) = _qkv(rng, (1, 4, 16, 8), (1, 2, 32, 8))
    out = ops.attention(q, k, v, causal=False, scale=0.3, block_q=8, block_k=16)
    want = ref_ops.attention(jq, jk, jv, causal=False, scale=0.3, block_q=8,
                             block_k=16)
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=2e-5, atol=2e-5)


def test_causal_alignment_is_pinned():
    """At causal S=16, Sk=32 the reference's kernel masks top-left and its
    oracle bottom-right, so the two disagree; the port refuses the case."""
    rng = np.random.default_rng(16)
    (q, k, v), (jq, jk, jv) = _qkv(rng, (1, 2, 16, 8), (1, 2, 32, 8))
    kernel = _f32(ref_ops.attention(jq, jk, jv, causal=True, block_q=16, block_k=16))
    oracle = _f32(ref_ref.attention_ref(jq, jk, jv, causal=True))
    assert np.abs(kernel - oracle).max() > 0.1
    with pytest.raises(ValueError, match="S == Sk"):
        ops.attention(q, k, v, causal=True, block_q=16, block_k=16)
    with pytest.raises(ValueError, match="S == Sk"):
        fa.check_operands(q, k, v, True, 16, 16)


@pytest.mark.parametrize("q_shape,kv_shape,kw", [
    ((1, 2, 16, 8), (1, 2, 16, 4), {}),                     # head dims differ
    ((1, 3, 16, 8), (1, 2, 16, 8), {}),                     # Hq % Hkv != 0
    ((2, 2, 16, 8), (1, 2, 16, 8), {}),                     # batch differs
    ((2, 16, 8), (2, 16, 8), {}),                           # not 4-D
    ((1, 2, 24, 8), (1, 2, 24, 8), {"block_q": 16}),        # S % bq != 0
    ((1, 2, 16, 8), (1, 2, 24, 8), {"causal": False, "block_k": 16}),
    ((1, 2, 16, 8), (1, 2, 16, 8), {"block_q": 0}),
])
def test_operands_are_checked(q_shape, kv_shape, kw):
    with pytest.raises(ValueError):
        ops.attention(torch.ones(q_shape), torch.ones(kv_shape),
                      torch.ones(kv_shape), **kw)


def test_dtypes_are_checked():
    x = torch.ones(1, 1, 8, 8)
    with pytest.raises(TypeError):
        ops.attention(x.half(), x.half(), x.half())
    with pytest.raises(TypeError):
        ops.attention(x, x.bfloat16(), x)


def test_cuda_request_raises_here():
    """No fallback: the kernel refuses tensors that are not on the card, a
    device that is neither CPU nor CUDA raises, and without a card no CUDA
    tensor can be made."""
    x = torch.ones(1, 1, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(x, x, x)
    m = torch.ones(1, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.attention(m, m, m)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ops.attention(x.cuda(), x.cuda(), x.cuda())


def test_cpu_path_counts_no_launch():
    before = fa.launches
    x = torch.ones(1, 2, 8, 8)
    ops.attention(x, x, x)
    ops.attention(x, x[:, :1], x[:, :1], causal=False)
    assert fa.launches == before == 0
