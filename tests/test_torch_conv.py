"""The port's banked conv2d against the reference's Pallas kernel.

On the CPU ``ops.conv2d`` takes the plain version; it is held against the
reference's ``ops.conv2d`` in interpret mode on every case of
``tests/test_kernels.py::TestBankedConv2d``, at that file's tolerances, and
against the paper's CNN layer as the port compiles it.  The CUDA kernel
itself runs only on the card (``tests/test_torch_card.py`` and
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import frontend, pipeline  # noqa: E402
from repro_torch.kernels import banked_conv2d as bc  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, dict(rtol=2e-5, atol=2e-5)),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, dict(rtol=2e-2, atol=2e-2))}
SHAPES = [(3, 8, 16, 12, 5, 5), (2, 4, 9, 9, 3, 3), (1, 2, 7, 5, 3, 2),
          (3, 8, 80, 60, 5, 5)]                # the last: the paper's CNN layer
BANKS = [(1, 1), (2, 2), (4, 2)]


def _pair(x: np.ndarray, dtype: str = "float32"):
    """The same values for both packages: float32 first, then the dtype."""
    t, j, _ = DTYPES[dtype]
    x = x.astype(np.float32)
    return torch.from_numpy(x).to(t), jnp.asarray(x).astype(j)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("cin,cout,h,w,kh,kw", SHAPES)
@pytest.mark.parametrize("banks", BANKS)
def test_shapes_and_banks_match_reference(cin, cout, h, w, kh, kw, banks):
    rng = np.random.default_rng(cin * 100 + h)
    x, jx = _pair(rng.normal(size=(cin, h, w)))
    wt, jwt = _pair(rng.normal(size=(cout, cin, kh, kw)))
    out = ops.conv2d(x, wt, banks=banks)
    want = ref_ops.conv2d(jx, jwt, banks=banks)
    assert tuple(out.shape) == want.shape == (cout, h - kh + 1, w - kw + 1)
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dtypes_match_reference(dtype):
    rng = np.random.default_rng(0)
    x, jx = _pair(rng.normal(size=(2, 10, 10)), dtype)
    wt, jwt = _pair(rng.normal(size=(4, 2, 3, 3)), dtype)
    out = ops.conv2d(x, wt, banks=(2, 2))
    assert out.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(_f32(out), _f32(ref_ops.conv2d(jx, jwt, banks=(2, 2))),
                               **DTYPES[dtype][2])


def test_paper_cnn_layer_matches_the_oracle():
    """The paper's CNN as the port compiles it: its conv weight and input
    through ``ops.conv2d`` equal the torch oracle's conv output."""
    from repro_torch.core import torch_backend
    d = pipeline.compile_model(frontend.paper_cnn(), [(3, 80, 60)], factor=1)
    conv = next(op for op in d.graph.ops if op.kind == "conv2d")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 80, 60))
                         .astype(np.float32))
    w = torch.from_numpy(np.asarray(d.graph.params[conv.inputs[1]], np.float32))
    env = {conv.inputs[0]: x, conv.inputs[1]: w}
    want = torch_backend._op_fn(conv, env, d.graph)
    for banks in BANKS:
        np.testing.assert_allclose(ops.conv2d(x, w, banks=banks).numpy(),
                                   want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cout,hout,banks", [(8, 76, (1, 1)), (8, 76, (2, 2)),
                                             (8, 76, (4, 2)), (2, 5, (4, 2)),
                                             (3, 7, (2, 3)), (1, 1, (8, 8))])
def test_bank_tiles_cover_the_output(cout, hout, banks):
    """The reference's tiles: ceil(Cout/banks[0]) x ceil(H'/banks[1])."""
    tc, th = bc.bank_tiles(cout, hout, banks)
    assert (tc, th) == (max(1, -(-cout // banks[0])), max(1, -(-hout // banks[1])))
    assert tc * banks[0] >= cout and th * banks[1] >= hout


@pytest.mark.parametrize("x_shape,w_shape,kw", [
    ((3, 8, 8), (4, 2, 3, 3), {}),                 # Cin differs
    ((3, 8), (4, 3, 3, 3), {}),                    # x not 3-D
    ((3, 8, 8), (4, 3, 3), {}),                    # w not 4-D
    ((3, 4, 8), (4, 3, 5, 3), {}),                 # kernel taller than x
    ((3, 8, 8), (4, 3, 3, 3), {"banks": (0, 1)}),
    ((3, 8, 8), (4, 3, 3, 3), {"banks": (1, 1, 1)}),
])
def test_operands_are_checked(x_shape, w_shape, kw):
    with pytest.raises(ValueError):
        ops.conv2d(torch.ones(x_shape), torch.ones(w_shape), **kw)


def test_dtypes_are_checked():
    with pytest.raises(TypeError):
        ops.conv2d(torch.ones(2, 6, 6).half(), torch.ones(2, 2, 3, 3).half())
    with pytest.raises(TypeError):
        ops.conv2d(torch.ones(2, 6, 6), torch.ones(2, 2, 3, 3).bfloat16())


def test_cuda_request_raises_here():
    """No fallback: the kernel refuses tensors that are not on the card, a
    device that is neither CPU nor CUDA raises, and without a card no CUDA
    tensor can be made."""
    x, w = torch.ones(2, 6, 6), torch.ones(2, 2, 3, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bc.banked_conv2d(x, w)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.conv2d(x.to("meta"), w.to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ops.conv2d(x.cuda(), w.cuda())


def test_cpu_path_counts_no_launch():
    before = bc.launches
    ops.conv2d(torch.ones(2, 6, 6), torch.ones(2, 2, 3, 3), banks=(2, 2))
    assert bc.launches == before == 0


H100_SMEM = 232448     # the H100's opt-in shared memory a block, bytes


def _assert_plan_covers(cin, cout, h, w, kh, kw, banks):
    """Every output once; no block crosses a bank tile's bounds; the
    block's window fits in the card's shared memory."""
    hout, wout = h - kh + 1, w - kw + 1
    p = bc.plan(cout, hout, wout, banks, cin, kh, kw, H100_SMEM)
    assert (p.rows, p.bw) in bc.BLOCKS and p.threads == p.rows * p.bw // bc.ROWS
    assert bc.smem_bytes(cin, kh, kw, p.rows, p.bw) <= H100_SMEM
    count = np.zeros((cout, hout, wout), np.int32)
    for o0, o1, r0, r1, c0, c1 in bc.block_tiles(p, cout, hout, wout):
        assert o1 - o0 == 1 and r1 - r0 <= p.rows and c1 - c0 <= p.bw
        assert o0 // p.bc == (o1 - 1) // p.bc, (o0, o1)     # one channel bank
        assert r0 // p.bh == (r1 - 1) // p.bh, (r0, r1)     # one row bank
        count[o0:o1, r0:r1, c0:c1] += 1
    assert (count == 1).all()
    return p


@pytest.mark.parametrize("cin,cout,h,w,kh,kw", SHAPES)
@pytest.mark.parametrize("banks", BANKS)
def test_block_plan_covers_each_output_once(cin, cout, h, w, kh, kw, banks):
    """TestBankedConv2d's shapes x bank plans: the kernel's blocks cover
    each output once and stay inside one bank tile."""
    p = _assert_plan_covers(cin, cout, h, w, kh, kw, banks)
    assert (p.bc, p.bh) == bc.bank_tiles(cout, h - kh + 1, banks)


@pytest.mark.parametrize("case", range(len(checks.CONV_VARIANTS)))
def test_block_plan_of_the_kernels_variants(case):
    """The variants the card checks (``checks.CONV_VARIANTS``) cover their
    outputs once and take the block size their label names."""
    label, (cin, cout, h, w, kh, kw), banks, _ = checks.CONV_VARIANTS[case]
    p = _assert_plan_covers(cin, cout, h, w, kh, kw, banks)
    assert f"{p.threads}-thread" in label, (label, p)


def test_wide_input_halves_the_block_until_its_window_fits():
    """At 3x3 taps the block shrinks as the input widens; it never shrinks
    while the larger block fits; past the smallest block the plan raises.
    The 8 x 64 block takes up to 86 channels, the 2 x 32 one 400."""
    seen = []
    for cin in (3, 64, 86, 87, 128, 200, 240, 400):
        p = bc.plan(8, 38, 38, (1, 1), cin, 3, 3, H100_SMEM)
        i = bc.BLOCKS.index((p.rows, p.bw))
        assert all(bc.smem_bytes(cin, 3, 3, *b) > H100_SMEM for b in bc.BLOCKS[:i])
        seen.append(p.threads)
    assert seen == sorted(seen, reverse=True) and seen[0] == 256 and seen[-1] == 32
    assert seen[2:4] == [256, 128]                          # 86 fits, 87 does not
    with pytest.raises(ValueError, match="shared memory"):
        bc.plan(8, 38, 38, (1, 1), 401, 3, 3, H100_SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        bc.plan(8, 36, 36, (1, 1), 242, 5, 5, H100_SMEM)


def test_paper_layer_spreads_over_the_card():
    """The paper's layer (3 -> 8 channels, 8 x 76 x 56 outputs) at every
    bank plan: 80 blocks of one channel, 8 x 64 outputs, 256 threads."""
    for banks in BANKS:
        p = bc.plan(8, 76, 56, banks, 3, 5, 5, H100_SMEM)
        assert (p.rows, p.bw, p.threads) == (8, 64, 256)
        assert len(list(bc.block_tiles(p, 8, 76, 56))) == 80
