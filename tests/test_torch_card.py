"""The port's CUDA kernels on the card (``-m cuda``; they skip without one).

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card.py

Imports neither JAX nor ``repro``, so it runs where only the port is
installed.  ``chip_smoke.py`` makes the same checks and more; both take the
attention, scan and conv cases from ``repro_torch.kernels.checks``, whose
tables are also run through the plain versions on the CPU here.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import banked_conv2d as bc  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels import banked_matmul as bm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

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


def _hold_all(checks, module):
    """Each check's wrapper call steps ``module.launches`` once and agrees
    with its plain version at the check's tolerance."""
    for c in checks:
        before = module.launches
        out = c.got()
        torch.cuda.synchronize()
        assert module.launches - before == 1, c.label
        want = c.want()
        assert out.shape == want.shape and out.dtype == want.dtype, c.label
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=c.rtol, atol=c.atol, err_msg=c.label)


@pytest.mark.cuda
def test_attention_matches_plain_on_the_card():
    """Every case of TestFlashAttention and kernel_bench.py's GQA 4:2."""
    _card()
    _hold_all(checks.attention("cuda"), fa)


@pytest.mark.cuda
def test_decay_scan_matches_plain_on_the_card():
    """Every case of TestDecayScan (chunk 8 against chunk 32 to 1e-5) and
    kernel_bench.py's two scans."""
    _card()
    _hold_all(checks.decay_scan("cuda"), ss)


@pytest.mark.cuda
def test_decay_scan_state_carries_on_the_card():
    _card()
    carry = next(c for c in checks.decay_scan("cuda") if c.label.endswith("state carry"))
    out = carry.got()
    assert float(out[0, 0, -1, 0]) > 0
    _hold_all([carry], ss)


@pytest.mark.cuda
def test_conv2d_matches_plain_on_the_card():
    """Every case of TestBankedConv2d."""
    _card()
    _hold_all(checks.conv2d("cuda"), bc)


@pytest.mark.parametrize("table", ["attention", "decay_scan", "conv2d"])
def test_check_tables_hold_on_the_cpu(table):
    """The shared check tables are well formed: on CPU tensors every wrapper
    takes its plain version, launches nothing, and meets ``want``."""
    counters = (fa, ss, bc)
    before = [m.launches for m in counters]
    cases = getattr(checks, table)("cpu")
    assert len({c.label for c in cases}) == len(cases)
    for c in cases:
        out, want = c.got(), c.want()
        assert out.device.type == "cpu" and out.dtype == want.dtype, c.label
        np.testing.assert_allclose(out.float().numpy(), want.float().numpy(),
                                   rtol=c.rtol, atol=c.atol, err_msg=c.label)
    assert [m.launches for m in counters] == before
