"""The port's model-side decay scan against the reference's, on the CPU.

``repro_torch.models.ssm_ops`` against ``repro.models.ssm_ops`` and the
reference's plain recurrence (``repro.kernels.ref.ssm_scan_ref``) on the
same numpy-seeded inputs.  ``tests/test_property_models.py`` draws these
cases with hypothesis and skips where hypothesis is not installed; its
properties run here on a fixed grid of its draws, in both packages, at its
tolerances: the chunked scan at 2e-4
(scalar and per-channel decay, inclusive and bonus, every chunk of the
grid), the decode step composing to the scan at 2e-4, and the ``h0`` /
``return_state`` handoff at 1e-5.  bf16 inputs at 2e-2
(``tests/test_kernels.py``'s bf16 tolerance), the absolute part relative
to the output's scale (max |want|, at least 1): outputs reach ~25, where
one bf16 ulp is 0.125, and an f32 difference of 1e-6 can round an output
to the neighbouring value.  Trap ``ROADMAP.md`` C.9: a chunk that does
not divide the sequence fails in both packages.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as KREF  # noqa: E402
from repro.models import ssm_ops as RS  # noqa: E402
from repro_torch.models import ssm_ops as S  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)       # tests/test_property_models.py
HANDOFF = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype="float32"):
    a = np.asarray(a, np.float32)
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(jnp.dtype(dtype)))


def _draw(seed, s, dk, scalar, mode, b=1, h=2, dv=4, wscale=0.4):
    """``test_matches_stepwise_reference``'s draw."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, dk))
    k = rng.normal(size=(b, h, s, dk))
    v = rng.normal(size=(b, h, s, dv))
    w_full = -np.abs(rng.normal(size=(b, h, s, dk))) * wscale
    u = rng.normal(size=(h, dk)) if mode == "bonus" else None
    w = w_full[..., 0] if scalar else w_full
    return q, k, v, w, u


# the property test's sample space: s, chunk, dk, then each decay form and
# mode (its draws pair scalar decay with inclusive only; the scalar bonus
# scan runs in both packages, so it is held against the reference's)
GRID = [(s, chunk, dk, scalar, mode)
        for s, chunk, dk in itertools.product((16, 32, 48), (4, 8, 16), (4, 8))
        for scalar, mode in ((True, "inclusive"), (False, "inclusive"),
                             (False, "bonus"), (True, "bonus"))]


@pytest.mark.parametrize("case", range(len(GRID)))
def test_chunked_scan_matches_reference(case):
    s, chunk, dk, scalar, mode = GRID[case]
    q, k, v, w, u = _draw(case, s, dk, scalar, mode)
    (tq, jq), (tk, jk), (tv, jv), (tw, jw) = (_pair(a) for a in (q, k, v, w))
    tu, ju = _pair(u) if u is not None else (None, None)
    got = S.chunked_decay_scan(tq, tk, tv, tw, u=tu, chunk=chunk,
                               diag_mode=mode)
    want = RS.chunked_decay_scan(jq, jk, jv, jw, u=ju, chunk=chunk,
                                 diag_mode=mode)
    assert got.shape == (1, 2, s, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    if not (scalar and mode == "bonus"):
        w_ref = np.broadcast_to(w[..., None], q.shape) if scalar else w
        expect = KREF.ssm_scan_ref(jq, jk, jv, jnp.asarray(w_ref, jnp.float32),
                                   u=ju, diag_mode=mode)
        np.testing.assert_allclose(_np(got), _np(expect), **TOL)


@pytest.mark.parametrize("scalar,mode", [(True, "inclusive"),
                                         (False, "inclusive"),
                                         (False, "bonus"), (True, "bonus")])
def test_bf16_scan_matches_reference(scalar, mode):
    """q/k/v in bf16 (RWKV6's model path in a bf16 config): both packages
    round the same intermediates to bf16 and accumulate in float32."""
    q, k, v, w, u = _draw(3, 64, 8, scalar, mode, b=2, h=2, dv=8)
    (tq, jq), (tk, jk), (tv, jv) = (_pair(a, "bfloat16") for a in (q, k, v))
    (tw, jw) = _pair(w)
    tu, ju = _pair(u) if u is not None else (None, None)
    got = S.chunked_decay_scan(tq, tk, tv, tw, u=tu, chunk=16, diag_mode=mode)
    want = RS.chunked_decay_scan(jq, jk, jv, jw, u=ju, chunk=16,
                                 diag_mode=mode)
    assert got.dtype == torch.bfloat16
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=BF16["rtol"],
                               atol=BF16["atol"] * scale)


@pytest.mark.parametrize("seed,steps,mode", [(0, 2, "inclusive"),
                                             (1, 5, "inclusive"),
                                             (2, 12, "inclusive"),
                                             (3, 7, "bonus"),
                                             (4, 12, "bonus")])
def test_decode_step_composes_to_the_scan(seed, steps, mode):
    """Repeated ``decay_scan_step`` == the recurrence over the sequence
    (``test_decode_step_composes``), in both packages; the bonus mode too."""
    q, k, v, w, u = _draw(seed, steps, 4, False, mode, wscale=0.3)
    (tq, jq), (tk, jk), (tv, jv), (tw, jw) = (_pair(a) for a in (q, k, v, w))
    tu, ju = _pair(u) if u is not None else (None, None)
    full = KREF.ssm_scan_ref(jq, jk, jv, jw, u=ju, diag_mode=mode)
    h = torch.zeros((1, 2, 4, 4))
    rh = jnp.zeros((1, 2, 4, 4), jnp.float32)
    for t in range(steps):
        o, h = S.decay_scan_step(h, tq[:, :, t], tk[:, :, t], tv[:, :, t],
                                 tw[:, :, t], u=tu, diag_mode=mode)
        ro, rh = RS.decay_scan_step(rh, jq[:, :, t], jk[:, :, t], jv[:, :, t],
                                    jw[:, :, t], u=ju, diag_mode=mode)
        np.testing.assert_allclose(_np(o), _np(full[:, :, t]), **TOL)
        np.testing.assert_allclose(_np(o), _np(ro), **TOL)
    np.testing.assert_allclose(_np(h), _np(rh), **TOL)


def test_decode_step_scalar_decay_and_bf16_state():
    """A scalar decay (B,H) broadcasts over the state; a bf16 state comes
    back float32, as the reference's does (``ROADMAP.md`` C.13)."""
    rng = np.random.default_rng(5)
    (tq, jq), (tk, jk), (tv, jv) = (_pair(rng.normal(size=(2, 3, 4)))
                                    for _ in range(3))
    tw, jw = _pair(-np.abs(rng.normal(size=(2, 3))))
    th, jh = _pair(rng.normal(size=(2, 3, 4, 4)), "bfloat16")
    o, h = S.decay_scan_step(th, tq, tk, tv, tw)
    ro, rh = RS.decay_scan_step(jh, jq, jk, jv, jw)
    assert h.dtype == o.dtype == torch.float32
    assert str(rh.dtype) == "float32"
    np.testing.assert_allclose(_np(o), _np(ro), **HANDOFF)
    np.testing.assert_allclose(_np(h), _np(rh), **HANDOFF)


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
def test_state_handoff_equals_monolithic(mode):
    """Two halves with ``return_state``/``h0`` == one scan, at 1e-5, and
    the handed-over state is the reference's."""
    q, k, v, w, u = _draw(0, 32, 4, False, mode, wscale=0.2)
    (tq, jq), (tk, jk), (tv, jv), (tw, jw) = (_pair(a) for a in (q, k, v, w))
    tu, ju = _pair(u) if u is not None else (None, None)
    half = lambda t, lo, hi: t[:, :, lo:hi]               # noqa: E731
    full = S.chunked_decay_scan(tq, tk, tv, tw, u=tu, chunk=8, diag_mode=mode)
    o1, hmid = S.chunked_decay_scan(*(half(t, 0, 16) for t in (tq, tk, tv, tw)),
                                    u=tu, chunk=8, diag_mode=mode,
                                    return_state=True)
    o2 = S.chunked_decay_scan(*(half(t, 16, 32) for t in (tq, tk, tv, tw)),
                              u=tu, chunk=8, diag_mode=mode, h0=hmid)
    np.testing.assert_allclose(_np(torch.cat([o1, o2], dim=2)), _np(full),
                               **HANDOFF)
    _, rhmid = RS.chunked_decay_scan(*(half(t, 0, 16) for t in (jq, jk, jv, jw)),
                                     u=ju, chunk=8, diag_mode=mode,
                                     return_state=True)
    assert hmid.dtype == torch.float32 and hmid.shape == (1, 2, 4, 4)
    np.testing.assert_allclose(_np(hmid), _np(rhmid), **HANDOFF)


@pytest.mark.parametrize("s,chunk", [(80, 64), (12, 8)])
def test_chunk_must_divide_the_sequence(s, chunk):
    """C.9: the reference asserts ``s % chunk == 0`` after
    ``chunk = min(chunk, s)``; the port raises too, and pads nothing."""
    q, k, v, w, _ = _draw(0, s, 4, False, "inclusive")
    (tq, jq), (tk, jk), (tv, jv), (tw, jw) = (_pair(a) for a in (q, k, v, w))
    with pytest.raises(AssertionError):
        RS.chunked_decay_scan(jq, jk, jv, jw, chunk=chunk)
    with pytest.raises(ValueError, match="divide"):
        S.chunked_decay_scan(tq, tk, tv, tw, chunk=chunk)


def test_a_chunk_longer_than_the_sequence_is_cut_to_it():
    q, k, v, w, _ = _draw(1, 48, 4, False, "inclusive")
    (tq, jq), (tk, jk), (tv, jv), (tw, jw) = (_pair(a) for a in (q, k, v, w))
    got = S.chunked_decay_scan(tq, tk, tv, tw, chunk=64)
    want = RS.chunked_decay_scan(jq, jk, jv, jw, chunk=64)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
