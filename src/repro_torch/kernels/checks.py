"""The kernels' check cases, defined once.

Every case of the reference's ``tests/test_kernels.py`` classes
``TestFlashAttention``, ``TestDecayScan`` and ``TestBankedConv2d`` (labelled
``tests: ...``) and the shapes of ``benchmarks/kernel_bench.py`` (labelled
``bench: ...``), with the same numpy seeds, draws and tolerances.  Each
``Check`` holds one call of a wrapper in ``ops`` (``got``) and what it must
agree with (``want``: the plain version in ``ref``, or for the scan's chunk
test the same wrapper at another chunk).  ``chip_smoke.py`` and the card
tests in ``tests/test_torch_card.py`` iterate over these lists; on CPU
tensors ``got`` takes the plain version, as every wrapper does.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple

import numpy as np
import torch

from . import ops, ref


class Check(NamedTuple):
    label: str
    got: Callable[[], torch.Tensor]       # one wrapper call: one launch on a card
    want: Callable[[], torch.Tensor]
    rtol: float
    atol: float


TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py


def _on(device, x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """numpy -> float32 on ``device`` -> ``dtype`` (both sides see the same values)."""
    return torch.tensor(x, dtype=torch.float32, device=device).to(dtype)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def attention(device) -> List[Check]:
    """Every case of TestFlashAttention, then kernel_bench.py's GQA 4:2."""
    out = []
    for hq, hkv in ((4, 4), (4, 2), (8, 1)):
        for causal in (True, False):
            rng = np.random.default_rng(hq * 10 + hkv)
            q = _on(device, rng.normal(size=(2, hq, 64, 16)))
            k = _on(device, rng.normal(size=(2, hkv, 64, 16)))
            v = _on(device, rng.normal(size=(2, hkv, 64, 16)))
            out.append(Check(
                f"tests: gqa {hq}:{hkv} causal {causal}",
                lambda q=q, k=k, v=v, c=causal: ops.attention(
                    q, k, v, causal=c, block_q=16, block_k=16),
                lambda q=q, k=k, v=v, c=causal: ref.attention_ref(q, k, v, causal=c),
                2e-5, 2e-5))
    for dtype in (torch.float32, torch.bfloat16):
        for s, bq, bk in ((32, 8, 8), (64, 32, 16), (128, 128, 128)):
            rng = np.random.default_rng(s)
            q, k, v = (_on(device, rng.normal(size=(1, 2, s, 8)), dtype)
                       for _ in range(3))
            out.append(Check(
                f"tests: S {s} blocks {bq}x{bk} {_dtype_name(dtype)}",
                lambda q=q, k=k, v=v, bq=bq, bk=bk: ops.attention(
                    q, k, v, causal=True, block_q=bq, block_k=bk),
                lambda q=q, k=k, v=v: ref.attention_ref(q, k, v, causal=True),
                TOL[dtype], TOL[dtype]))
    rng = np.random.default_rng(0)
    q = _on(device, rng.normal(size=(1, 1, 64, 8)) * 8)
    k = _on(device, rng.normal(size=(1, 1, 64, 8)) * 8)
    v = _on(device, rng.normal(size=(1, 1, 64, 8)))
    out.append(Check(
        "tests: scores x8",
        lambda: ops.attention(q, k, v, causal=True, block_q=16, block_k=16),
        lambda: ref.attention_ref(q, k, v), 1e-4, 1e-4))
    rng = np.random.default_rng(0)                  # kernel_bench.py:40-44
    bq_, bk_, bv_ = (_on(device, rng.normal(size=(1, h, 256, 64))) for h in (4, 2, 2))
    out.append(Check(
        "bench: gqa 4:2 S 256 D 64",
        lambda: ops.attention(bq_, bk_, bv_, causal=True, block_q=64, block_k=64),
        lambda: ref.attention_ref(bq_, bk_, bv_, causal=True), 2e-5, 2e-5))
    return out


def decay_scan(device) -> List[Check]:
    """Every case of TestDecayScan (chunk 8 against chunk 32 and the state
    carried across chunks included), then kernel_bench.py's two scans."""
    out = []
    for mode in ("inclusive", "bonus"):
        for s, chunk in ((32, 8), (64, 16), (64, 64)):
            rng = np.random.default_rng(s + chunk)
            q = _on(device, rng.normal(size=(1, 2, s, 8)))
            k = _on(device, rng.normal(size=(1, 2, s, 8)))
            v = _on(device, rng.normal(size=(1, 2, s, 12)))
            w = _on(device, -np.abs(rng.normal(size=(1, 2, s, 8))) * 0.3)
            u = _on(device, rng.normal(size=(2, 8)))
            out.append(Check(
                f"tests: {mode} S {s} chunk {chunk}",
                lambda q=q, k=k, v=v, w=w, u=u, c=chunk, m=mode: ops.decay_scan(
                    q, k, v, w, u=u, chunk=c, diag_mode=m),
                lambda q=q, k=k, v=v, w=w, u=u, m=mode: ref.ssm_scan_ref(
                    q, k, v, w, u=u, diag_mode=m),
                1e-4, 1e-4))
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(5)
        q, k, v = (_on(device, rng.normal(size=(2, 2, 32, 8)), dtype) for _ in range(3))
        w = _on(device, -np.abs(rng.normal(size=(2, 2, 32, 8))) * 0.2, dtype)
        out.append(Check(
            f"tests: {_dtype_name(dtype)}",
            lambda q=q, k=k, v=v, w=w: ops.decay_scan(q, k, v, w, chunk=8),
            lambda q=q, k=k, v=v, w=w: ref.ssm_scan_ref(q, k, v, w),
            TOL[dtype], TOL[dtype]))
    rng = np.random.default_rng(9)
    q9, k9, v9 = (_on(device, rng.normal(size=(1, 1, 64, 8))) for _ in range(3))
    w9 = _on(device, -np.abs(rng.normal(size=(1, 1, 64, 8))))
    out.append(Check(
        "tests: chunk 8 vs chunk 32",
        lambda: ops.decay_scan(q9, k9, v9, w9, chunk=8),
        lambda: ops.decay_scan(q9, k9, v9, w9, chunk=32), 1e-5, 1e-5))
    s, dk = 32, 4                                   # an impulse at t = 0 decays
    q1 = torch.ones((1, 1, s, dk), device=device)   # but reaches the last step
    k1 = torch.zeros((1, 1, s, dk), device=device)
    k1[0, 0, 0] = 1.0
    v1 = torch.zeros((1, 1, s, 4), device=device)
    v1[0, 0, 0] = 1.0
    w1 = torch.full((1, 1, s, dk), -0.1, device=device)
    out.append(Check(
        "tests: state carry",
        lambda: ops.decay_scan(q1, k1, v1, w1, chunk=8),
        lambda: ref.ssm_scan_ref(q1, k1, v1, w1), 1e-5, 1e-5))
    rng = np.random.default_rng(0)                  # kernel_bench.py:50-62
    q2, k2, v2 = (_on(device, rng.normal(size=(1, 4, 256, 32))) for _ in range(3))
    w2 = _on(device, -np.abs(rng.normal(size=(1, 4, 256, 32))) * 0.2)
    u2 = _on(device, rng.normal(size=(4, 32)))
    out.append(Check(
        "bench: inclusive 1x4x256x32",
        lambda: ops.decay_scan(q2, k2, v2, w2, chunk=32),
        lambda: ref.ssm_scan_ref(q2, k2, v2, w2), 1e-4, 1e-4))
    out.append(Check(
        "bench: bonus 1x4x256x32",
        lambda: ops.decay_scan(q2, k2, v2, w2, u=u2, chunk=32, diag_mode="bonus"),
        lambda: ref.ssm_scan_ref(q2, k2, v2, w2, u=u2, diag_mode="bonus"),
        1e-4, 1e-4))
    return out


CONV_BANKS = [(1, 1), (2, 2), (4, 2)]


def conv2d(device) -> List[Check]:
    """Every case of TestBankedConv2d."""
    out = []
    for cin, cout, h, wd, kh, kw in ((3, 8, 16, 12, 5, 5), (2, 4, 9, 9, 3, 3),
                                     (1, 2, 7, 5, 3, 2), (3, 8, 80, 60, 5, 5)):
        for banks in CONV_BANKS:
            rng = np.random.default_rng(cin * 100 + h)
            x = _on(device, rng.normal(size=(cin, h, wd)))
            w = _on(device, rng.normal(size=(cout, cin, kh, kw)))
            out.append(Check(
                f"tests: {cin}->{cout} {h}x{wd} k{kh}x{kw} banks {banks}",
                lambda x=x, w=w, b=banks: ops.conv2d(x, w, banks=b),
                lambda x=x, w=w: ref.conv2d_ref(x, w), 2e-5, 2e-5))
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(0)
        x = _on(device, rng.normal(size=(2, 10, 10)), dtype)
        w = _on(device, rng.normal(size=(4, 2, 3, 3)), dtype)
        out.append(Check(
            f"tests: {_dtype_name(dtype)}",
            lambda x=x, w=w: ops.conv2d(x, w, banks=(2, 2)),
            lambda x=x, w=w: ref.conv2d_ref(x, w), TOL[dtype], TOL[dtype]))
    return out
