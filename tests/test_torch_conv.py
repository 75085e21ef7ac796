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
