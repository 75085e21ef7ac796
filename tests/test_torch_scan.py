"""The port's decay scan against the reference's Pallas chunked scan.

On the CPU ``ops.decay_scan`` takes the plain version (the step-by-step
recurrence); it is held against the reference's ``ops.decay_scan`` in
interpret mode on every case of ``tests/test_kernels.py::TestDecayScan``,
at that file's tolerances.  The CUDA kernel itself runs only on the card
(``tests/test_torch_card.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

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


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (64, 64)])
def test_modes_and_chunks_match_reference(mode, s, chunk):
    rng = np.random.default_rng(s + chunk)
    q, jq = _pair(rng.normal(size=(1, 2, s, 8)))
    k, jk = _pair(rng.normal(size=(1, 2, s, 8)))
    v, jv = _pair(rng.normal(size=(1, 2, s, 12)))
    w, jw = _pair(-np.abs(rng.normal(size=(1, 2, s, 8))) * 0.3)
    u, ju = _pair(rng.normal(size=(2, 8)))
    out = ops.decay_scan(q, k, v, w, u=u, chunk=chunk, diag_mode=mode)
    assert out.shape == (1, 2, s, 12) and out.dtype == torch.float32
    want = ref_ops.decay_scan(jq, jk, jv, jw, u=ju, chunk=chunk, diag_mode=mode)
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dtypes_match_reference(dtype):
    rng = np.random.default_rng(5)
    q, jq = _pair(rng.normal(size=(2, 2, 32, 8)), dtype)
    k, jk = _pair(rng.normal(size=(2, 2, 32, 8)), dtype)
    v, jv = _pair(rng.normal(size=(2, 2, 32, 8)), dtype)
    w, jw = _pair(-np.abs(rng.normal(size=(2, 2, 32, 8))) * 0.2, dtype)
    out = ops.decay_scan(q, k, v, w, chunk=8)
    assert out.dtype == DTYPES[dtype][0]
    want = ref_ops.decay_scan(jq, jk, jv, jw, chunk=8)
    np.testing.assert_allclose(_f32(out), _f32(want), **DTYPES[dtype][2])


def test_chunking_invariance_matches_reference():
    """Chunk 8 and chunk 32 agree, here and in the reference, to 1e-5."""
    rng = np.random.default_rng(9)
    q, jq = _pair(rng.normal(size=(1, 1, 64, 8)))
    k, jk = _pair(rng.normal(size=(1, 1, 64, 8)))
    v, jv = _pair(rng.normal(size=(1, 1, 64, 8)))
    w, jw = _pair(-np.abs(rng.normal(size=(1, 1, 64, 8))))
    o1, o2 = (ops.decay_scan(q, k, v, w, chunk=c) for c in (8, 32))
    np.testing.assert_allclose(_f32(o1), _f32(o2), rtol=1e-5, atol=1e-5)
    for got, c in ((o1, 8), (o2, 32)):
        np.testing.assert_allclose(_f32(got), _f32(ref_ops.decay_scan(jq, jk, jv, jw, chunk=c)),
                                   rtol=1e-5, atol=1e-5)


def test_state_carries_across_chunks_as_in_reference():
    """An impulse at t=0 must influence outputs in later chunks."""
    s, dk = 32, 4
    q = np.ones((1, 1, s, dk))
    k = np.zeros((1, 1, s, dk))
    k[0, 0, 0] = 1.0
    v = np.zeros((1, 1, s, 4))
    v[0, 0, 0] = 1.0
    w = np.full((1, 1, s, dk), -0.1)
    (tq, jq), (tk, jk), (tv, jv), (tw, jw) = (_pair(a) for a in (q, k, v, w))
    out = ops.decay_scan(tq, tk, tv, tw, chunk=8)
    assert float(out[0, 0, -1, 0]) > 0      # decayed impulse still visible
    np.testing.assert_allclose(_f32(out), _f32(ref_ops.decay_scan(jq, jk, jv, jw, chunk=8)),
                               rtol=1e-5, atol=1e-5)


def test_u_defaults_to_zeros():
    rng = np.random.default_rng(2)
    q, k, w = (torch.from_numpy(rng.normal(size=(1, 2, 16, 4)).astype(np.float32))
               for _ in range(3))
    v = torch.from_numpy(rng.normal(size=(1, 2, 16, 4)).astype(np.float32))
    w = -w.abs()
    np.testing.assert_array_equal(
        ops.decay_scan(q, k, v, w, chunk=8, diag_mode="bonus").numpy(),
        ref.ssm_scan_ref(q, k, v, w, u=torch.zeros(2, 4), diag_mode="bonus").numpy())


@pytest.mark.parametrize("shapes,kw,err", [
    (((1, 2, 32, 8), (1, 2, 32, 8), (1, 2, 32, 8), (1, 2, 32, 8)),
     {"chunk": 12}, ValueError),                                    # S % chunk
    (((1, 2, 32, 8), (1, 2, 32, 8), (1, 2, 32, 8), (1, 2, 32, 8)),
     {"diag_mode": "exclusive"}, ValueError),
    (((1, 2, 32, 8), (1, 2, 32, 4), (1, 2, 32, 8), (1, 2, 32, 8)),
     {}, ValueError),                                               # k != q
    (((1, 2, 32, 8), (1, 2, 32, 8), (1, 2, 16, 8), (1, 2, 32, 8)),
     {}, ValueError),                                               # v's S
    (((2, 32, 8), (2, 32, 8), (2, 32, 8), (2, 32, 8)), {}, ValueError),
    (((1, 2, 32, 8), (1, 2, 32, 8), (1, 2, 32, 8), (1, 2, 32, 8)),
     {"u": torch.zeros(3, 8)}, ValueError),                         # u's shape
    (((1, 2, 32, 8), (1, 2, 32, 8), (1, 2, 32, 8), (1, 2, 32, 8)),
     {"chunk": 0}, ValueError),
])
def test_operands_are_checked(shapes, kw, err):
    with pytest.raises(err):
        ops.decay_scan(*(torch.zeros(s) for s in shapes), **kw)


def test_dtypes_are_checked():
    x = torch.zeros(1, 1, 8, 4)
    with pytest.raises(TypeError):
        ops.decay_scan(x.half(), x.half(), x.half(), x.half(), chunk=8)
    with pytest.raises(TypeError):
        ops.decay_scan(x, x, x.bfloat16(), x, chunk=8)


def test_cuda_request_raises_here():
    """No fallback: the kernel refuses tensors that are not on the card, a
    device that is neither CPU nor CUDA raises, and without a card no CUDA
    tensor can be made."""
    x = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.ssm_scan(x, x, x, x, chunk=8)
    m = torch.zeros(1, 1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.decay_scan(m, m, m, m, chunk=8)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ops.decay_scan(x.cuda(), x.cuda(), x.cuda(), x.cuda(), chunk=8)


def test_cpu_path_counts_no_launch():
    before = ss.launches
    x = torch.zeros(1, 2, 8, 4)
    ops.decay_scan(x, x, x, x, chunk=4)
    ops.decay_scan(x, x, x, x, u=torch.zeros(2, 4), chunk=8, diag_mode="bonus")
    assert ss.launches == before == 0


# ---------------------------------------------------------------------------
# The card's three-pass decomposition (csrc/ssm_scan.cu), emulated in plain
# torch: each chunk's own state contribution and decay for all chunks at
# once, then the state pass over the chunks in order, then each chunk's
# output from the state it enters with.  The same sums as the kernel: window
# decays as running sums over their own windows (cumsum of the gated w, never
# W_t - W_s), the suffix decays as the last row of that table, the full-chunk
# decay as a plain sum.

def _three_pass(q, k, v, w, u=None, chunk=32, diag_mode="inclusive"):
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    n, c = s // chunk, chunk
    q, k, w = (x.float().reshape(b, h, n, c, dk) for x in (q, k, w))
    v = v.float().reshape(b, h, n, c, dv)
    # win[..., t, s, d] = sum_{s<i<=t} w_i, a running sum per window
    later = torch.arange(c)[None, :] > torch.arange(c)[:, None]        # (s, i): i > s
    gated = torch.where(later[:, :, None], w[..., None, :, :], torch.zeros(()))
    win = torch.cumsum(gated, dim=-2).transpose(-3, -2)               # (t, s, d)
    # 1. chunk_state: Delta_c = (k exp(win[C-1, s]))^T v, e_c = exp(sum_t w_t)
    delta = torch.einsum("bhnsd,bhnse->bhnde", k * torch.exp(win[..., -1, :, :]), v)
    decay = torch.exp(w.sum(dim=-2))                                   # (b,h,n,dk)
    # 2. state_pass: the state entering each chunk, in order from zero
    states, state = [], torch.zeros(b, h, dk, dv)
    for i in range(n):
        states.append(state)
        state = decay[:, :, i, :, None] * state + delta[:, :, i]
    hc = torch.stack(states, dim=2)                                    # (b,h,n,dk,dv)
    # 3. chunk_out: o = q exp(W or Wprev) @ h_c + scores @ v (+ bonus v)
    W = torch.cumsum(w, dim=-2)
    t_idx, s_idx = torch.arange(c)[:, None], torch.arange(c)[None, :]
    if diag_mode == "inclusive":
        qw, mask, expo = q * torch.exp(W), s_idx <= t_idx, win
    else:
        wprev = torch.cat([torch.zeros_like(W[..., :1, :]), W[..., :-1, :]], dim=-2)
        shifted = torch.cat([torch.zeros_like(win[..., :1, :, :]), win[..., :-1, :, :]],
                            dim=-3)
        qw, mask, expo = q * torch.exp(wprev), s_idx < t_idx, shifted
    rel = torch.exp(torch.where(mask[:, :, None], expo, torch.full((), -1e30)))
    scores = torch.einsum("bhntd,bhntsd,bhnsd->bhnts", q, rel, k)
    o = (torch.einsum("bhntd,bhnde->bhnte", qw, hc)
         + torch.einsum("bhnts,bhnse->bhnte", scores, v))
    if diag_mode == "bonus":
        uf = (torch.zeros(h, dk) if u is None else u.float())[None, :, None, None, :]
        o = o + (q * uf * k).sum(dim=-1, keepdim=True) * v
    return o.reshape(b, h, s, dv)


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 16), (64, 8), (64, 16), (64, 64)])
def test_three_pass_decomposition_matches_reference(mode, s, chunk):
    """TestDecayScan's shapes at chunks 8, 16 and 64, both modes: the
    decomposition the card runs agrees with the reference's chunked scan."""
    rng = np.random.default_rng(s + chunk)
    q, jq = _pair(rng.normal(size=(1, 2, s, 8)))
    k, jk = _pair(rng.normal(size=(1, 2, s, 8)))
    v, jv = _pair(rng.normal(size=(1, 2, s, 12)))
    w, jw = _pair(-np.abs(rng.normal(size=(1, 2, s, 8))) * 0.3)
    u, ju = _pair(rng.normal(size=(2, 8)))
    got = _three_pass(q, k, v, w, u=u, chunk=chunk, diag_mode=mode)
    want = ref_ops.decay_scan(jq, jk, jv, jw, u=ju, chunk=chunk, diag_mode=mode)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)


def test_three_pass_chunking_invariance():
    """Chunk 8 and chunk 32 of the decomposition agree to 1e-5, and each
    with the reference at its chunk."""
    rng = np.random.default_rng(9)
    q, jq = _pair(rng.normal(size=(1, 1, 64, 8)))
    k, jk = _pair(rng.normal(size=(1, 1, 64, 8)))
    v, jv = _pair(rng.normal(size=(1, 1, 64, 8)))
    w, jw = _pair(-np.abs(rng.normal(size=(1, 1, 64, 8))))
    o1, o2 = (_three_pass(q, k, v, w, chunk=c) for c in (8, 32))
    np.testing.assert_allclose(_f32(o1), _f32(o2), rtol=1e-5, atol=1e-5)
    for got, c in ((o1, 8), (o2, 32)):
        np.testing.assert_allclose(
            _f32(got), _f32(ref_ops.decay_scan(jq, jk, jv, jw, chunk=c)),
            rtol=1e-4, atol=1e-4)


def test_three_pass_state_carry():
    """The impulse at t = 0 crosses three chunk boundaries through the state
    pass alone (1e-5 of the reference)."""
    s, dk = 32, 4
    q = np.ones((1, 1, s, dk))
    k = np.zeros((1, 1, s, dk))
    k[0, 0, 0] = 1.0
    v = np.zeros((1, 1, s, 4))
    v[0, 0, 0] = 1.0
    w = np.full((1, 1, s, dk), -0.1)
    (tq, jq), (tk, jk), (tv, jv), (tw, jw) = (_pair(a) for a in (q, k, v, w))
    out = _three_pass(tq, tk, tv, tw, chunk=8)
    assert float(out[0, 0, -1, 0]) > 0
    np.testing.assert_allclose(_f32(out), _f32(ref_ops.decay_scan(jq, jk, jv, jw, chunk=8)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,s,dk,dv,chunk", [
    (1, 64, 4096, 64, 64, 64),      # rwkv6-7b, one layer at 4096 tokens
    (1, 112, 4096, 64, 64, 64),     # zamba2-7b
    (1, 4, 4096, 8, 8, 8),          # the card test whose state pass walks 512 chunks
    (2, 2, 32, 8, 12, 8),
    (1, 1, 33, 3, 5, 11),
])
def test_grids_and_workspace(b, h, s, dk, dv, chunk):
    """One block per (b*H, chunk) for the two chunk kernels, one thread per
    (b*H, state element) for the state pass, and a workspace of Delta (dk*dv)
    and e (dk) per (b*H, chunk)."""
    n = s // chunk
    first, state, last = ss.grids(b, h, s, dk, dv, chunk)
    assert first == last == b * h * n
    assert (state - 1) * ss.THREADS < b * h * dk * dv <= state * ss.THREADS
    assert ss.workspace_floats(b, h, s, dk, dv, chunk) == b * h * n * (dk * dv + dk)


def test_full_width_workspace_bytes():
    """68 MB (rwkv6-7b) and 119 MB (zamba2-7b) of f32 at 4096 tokens, chunk 64."""
    assert ss.workspace_floats(1, 64, 4096, 64, 64, 64) * 4 == 68_157_440
    assert ss.workspace_floats(1, 112, 4096, 64, 64, 64) * 4 == 119_275_520
    assert ss.grids(1, 64, 4096, 64, 64, 64)[0] == 4096
    assert ss.grids(1, 112, 4096, 64, 64, 64)[0] == 7168
