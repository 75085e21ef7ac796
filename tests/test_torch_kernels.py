"""The port's banked matmul against the reference's Pallas kernel.

On the CPU ``ops.matmul`` takes the plain version; it is held against the
reference's ``ops.matmul`` in interpret mode on every case of
``tests/test_kernels.py::TestBankedMatmul``, at that file's tolerances.  The
CUDA kernel itself runs only on the card (``tests/test_torch_card.py``, and
``chip_smoke.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.banked_matmul import derive_block as ref_derive_block  # noqa: E402
from repro_torch.core import cuda_backend, frontend  # noqa: E402
from repro_torch.core.banking import BankingSpec  # noqa: E402
from repro_torch.kernels import banked_matmul as bm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, dict(rtol=2e-5, atol=2e-5)),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, dict(rtol=2e-2, atol=2e-2))}
SHAPES = [(8, 16, 8), (32, 64, 48), (48, 64, 40), (1, 64, 48), (17, 33, 9),
          (128, 128, 128)]
BANKS = [(1, 1, 1), (2, 2, 2), (4, 2, 1), (1, 4, 4)]


def _pair(x: np.ndarray, dtype: str):
    """The same values for both packages: float32 first, then the dtype."""
    t, j, _ = DTYPES[dtype]
    x = x.astype(np.float32)
    return torch.from_numpy(x).to(t), jnp.asarray(x).astype(j)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_shapes_dtypes_match_reference(m, k, n, dtype):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a, ja = _pair(rng.normal(size=(m, k)), dtype)
    b, jb = _pair(rng.normal(size=(k, n)), dtype)
    out = ops.matmul(a, b, banks=(2, 2, 2))
    assert out.dtype == DTYPES[dtype][0] and out.shape == (m, n)
    np.testing.assert_allclose(_f32(out), _f32(ref_ops.matmul(ja, jb, banks=(2, 2, 2))),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("banks", BANKS)
def test_bank_partitions_match_reference(banks):
    rng = np.random.default_rng(7)
    a, ja = _pair(rng.normal(size=(64, 96)), "float32")
    b, jb = _pair(rng.normal(size=(96, 64)), "float32")
    np.testing.assert_allclose(_f32(ops.matmul(a, b, banks=banks)),
                               _f32(ref_ops.matmul(ja, jb, banks=banks)),
                               rtol=2e-5, atol=2e-5)


def test_transposed_view_operand():
    """``kh.t()`` in the paper's MHA reaches the matmul as a strided view."""
    rng = np.random.default_rng(11)
    a, ja = _pair(rng.normal(size=(8, 21)), "float32")
    bt, jbt = _pair(rng.normal(size=(8, 21)), "float32")
    np.testing.assert_allclose(_f32(ops.matmul(a, bt.t())),
                               _f32(ref_ops.matmul(ja, jbt.T)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("banks", BANKS + [(2, 4, 8), (3, 5, 7), (8, 8, 8)])
def test_derive_block_matches_reference(banks):
    dims = (1, 7, 8, 17, 42, 64, 127, 128, 129, 300, 1024, 5472)
    for m, n, k in itertools.product(dims, repeat=3):
        assert bm.derive_block(m, n, k, banks) == ref_derive_block(m, n, k, banks)


def test_f32_accumulation_for_bf16():
    out = ops.matmul(torch.ones(8, 512, dtype=torch.bfloat16),
                     torch.ones(512, 8, dtype=torch.bfloat16),
                     out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert bool((out == 512.0).all())


def test_cpu_path_counts_no_launch():
    before = bm.launches
    ops.matmul(torch.ones(4, 4), torch.ones(4, 4), banks=(2, 2, 2))
    g = frontend.trace(frontend.paper_ffnn(), [(1, 64)])
    cuda_backend.execute_graph_cuda(g, {"arg0": np.zeros((1, 64), np.float32)},
                                    BankingSpec(factor=2), device="cpu")
    assert bm.launches == before == 0


def test_cuda_request_raises_here(monkeypatch):
    """No fallback: without a card a CUDA request raises, and the kernel
    refuses tensors that are not on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = frontend.trace(frontend.paper_ffnn(), [(1, 64)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_backend.execute_graph_cuda(g, {"arg0": np.zeros((1, 64), np.float32)},
                                        BankingSpec(factor=1), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_backend.execute_graph_cuda(g, {"arg0": np.zeros((1, 64), np.float32)},
                                        BankingSpec(factor=1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bm.banked_matmul(torch.ones(4, 4), torch.ones(4, 4))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.matmul(torch.ones(4, 4, device="meta"), torch.ones(4, 4, device="meta"))


@pytest.mark.parametrize("a_shape,b_shape,kw,err", [
    ((4, 5), (4, 5), {}, ValueError),                               # K mismatch
    ((4,), (4, 5), {}, ValueError),                                 # not 2-D
    ((0, 5), (5, 3), {}, ValueError),                               # empty
    ((4, 5), (5, 3), {"banks": (0, 1, 1)}, ValueError),
    ((4, 5), (5, 3), {"block": (8, 8)}, ValueError),
    ((4, 5), (5, 3), {"out_dtype": torch.float16}, TypeError),
])
def test_operands_are_checked(a_shape, b_shape, kw, err):
    with pytest.raises(err):
        ops.matmul(torch.ones(a_shape), torch.ones(b_shape), **kw)


def test_dtypes_are_checked():
    with pytest.raises(TypeError):
        ops.matmul(torch.ones(4, 5, dtype=torch.float16),
                   torch.ones(5, 3, dtype=torch.float16))
    with pytest.raises(TypeError):
        ops.matmul(torch.ones(4, 5), torch.ones(5, 3, dtype=torch.bfloat16))
