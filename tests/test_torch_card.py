"""The port's CUDA kernels on the card (``-m cuda``; they skip without one).

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card.py

Imports neither JAX nor ``repro``, so it runs where only the port is
installed.  ``chip_smoke.py`` makes the same checks and more.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import banked_matmul as bm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
SHAPES = [(8, 16, 8), (32, 64, 48), (48, 64, 40), (1, 64, 48), (17, 33, 9),
          (128, 128, 128)]
BANKS = [(1, 1, 1), (2, 2, 2), (4, 2, 1), (1, 4, 4)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_the_card(dtype):
    """Every shape and bank plan of the CPU tests, B as a transposed view."""
    _card()
    before = bm.launches
    for (m, k, n), banks in itertools.product(SHAPES, BANKS):
        rng = np.random.default_rng(m * 1000 + k * 10 + n)
        a = torch.tensor(rng.normal(size=(m, k)), dtype=dtype, device="cuda")
        b = torch.tensor(rng.normal(size=(n, k)), dtype=dtype, device="cuda").t()
        out = ops.matmul(a, b, banks=banks)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.matmul_ref(a, b).float().cpu().numpy(),
                                   **TOL[dtype])
    torch.cuda.synchronize()
    assert bm.launches - before == len(SHAPES) * len(BANKS)


@pytest.mark.cuda
def test_bf16_accumulates_in_f32_on_the_card():
    _card()
    out = ops.matmul(torch.ones(8, 512, dtype=torch.bfloat16, device="cuda"),
                     torch.ones(512, 8, dtype=torch.bfloat16, device="cuda"),
                     out_dtype=torch.float32)
    assert bool((out == 512.0).all())
