"""The port on the card (``-m cuda``; these tests skip without one): its CUDA
kernels, and the serve step of the decode path.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card.py

Imports neither JAX nor ``repro``, so it runs where only the port is
installed.  ``chip_smoke.py`` makes the same checks and more; both take the
matmul, attention, scan and conv cases and the determinism calls from
``repro_torch.kernels.checks``, whose tables are also run through the plain
versions on the CPU here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import banked_conv2d as bc  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels import banked_matmul as bm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")


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
def test_kernel_matches_plain_on_the_card():
    """Every case of ``checks.matmul``: TestBankedMatmul's shapes and bank
    plans (B as a transposed view too), every matmul of the main path, and
    both variants at their boundaries (split-K included)."""
    _card()
    _hold_all(checks.matmul("cuda"), bm)


@pytest.mark.cuda
def test_main_path_products_take_the_skinny_variant_on_the_card():
    """The main path's products run the skinny variant and agree with the
    plain version; the plan's choice is the one the CPU tests hold."""
    _card()
    cases = [c for c in checks.matmul("cuda") if c.label.startswith("main path")]
    assert len(cases) == len(checks.MAIN_PATH_MATMULS)
    for m, k, n, f, _ in checks.MAIN_PATH_MATMULS:
        assert bm.plan(m, n, k, bm.derive_block(m, n, k, (f, f, f))).skinny
    _hold_all(cases, bm)


@pytest.mark.cuda
def test_redesigned_kernels_are_deterministic_on_the_card():
    """Two calls with the same inputs give the same bits: the CNN's product,
    a split-K product, full-width attention in f32 and bf16, both full-width
    scans and the paper's conv."""
    _card()
    for label, call in checks.deterministic("cuda"):
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second), label


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
@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
def test_decay_scan_state_pass_over_many_chunks_on_the_card(mode):
    """S 4096 at chunk 8: the state pass carries the state over 512 chunks
    (a slow decay keeps each token's trace alive across dozens of them);
    the kernel agrees with the step recurrence at the scan's 1e-4."""
    _card()
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(4096 + 8)
    q, k = (torch.tensor(rng.normal(size=(1, 2, 4096, 8)), dtype=torch.float32,
                         device="cuda") for _ in range(2))
    v = torch.tensor(rng.normal(size=(1, 2, 4096, 8)), dtype=torch.float32,
                     device="cuda")
    w = torch.tensor(-np.abs(rng.normal(size=(1, 2, 4096, 8))) * 0.02,
                     dtype=torch.float32, device="cuda")
    u = torch.tensor(rng.normal(size=(2, 8)), dtype=torch.float32, device="cuda")
    before = ss.launches
    out = ops.decay_scan(q, k, v, w, u=u, chunk=8, diag_mode=mode)
    torch.cuda.synchronize()
    assert ss.launches - before == 1
    want = ref.ssm_scan_ref(q, k, v, w, u=u, diag_mode=mode)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_conv2d_matches_plain_on_the_card():
    """Every case of TestBankedConv2d and the kernel's own variants."""
    _card()
    _hold_all(checks.conv2d("cuda"), bc)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["", "int8"])
def test_serve_step_on_the_card_matches_the_cpu(kv):
    """qwen2-0.5b reduced, float32: twelve teacher-forced serve steps on the
    card give the CPU's logits at 1e-5 (of the logits' scale, at least 1),
    a plain and an int8 KV cache; the cache stays on the card."""
    _card()
    import dataclasses
    from repro_torch.models import decode, get_config, params
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), kv_cache_dtype=kv)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    runs = {}
    for dev in ("cpu", "cuda"):
        prm = params.init_params(cfg, seed=0, device=dev)
        cache = decode.init_cache(cfg, prm, 2, 16)
        assert all(t.device.type == dev for t in decode._leaves(cache))
        out = []
        for i in range(12):
            logits, cache = decode.serve_step(cfg, prm, cache,
                                              tokens[:, i:i + 1].to(dev), i)
            out.append(logits.cpu().numpy())
        runs[dev] = np.stack(out)
    scale = max(1.0, float(np.abs(runs["cpu"]).max()))
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("table", ["matmul", "attention", "decay_scan", "conv2d"])
def test_check_tables_hold_on_the_cpu(table):
    """The shared check tables are well formed: on CPU tensors every wrapper
    takes its plain version, launches nothing, and meets ``want``."""
    counters = (bm, fa, ss, bc)
    before = [m.launches for m in counters]
    cases = getattr(checks, table)("cpu")
    assert len({c.label for c in cases}) == len(cases)
    for c in cases:
        out, want = c.got(), c.want()
        assert out.device.type == "cpu" and out.dtype == want.dtype, c.label
        np.testing.assert_allclose(out.float().numpy(), want.float().numpy(),
                                   rtol=c.rtol, atol=c.atol, err_msg=c.label)
    assert [m.launches for m in counters] == before
