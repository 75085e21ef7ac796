"""The kernels' check cases, defined once.

Every case of the reference's ``tests/test_kernels.py`` classes
``TestBankedMatmul``, ``TestFlashAttention``, ``TestDecayScan`` and
``TestBankedConv2d`` (labelled ``tests: ...``) and the shapes of
``benchmarks/kernel_bench.py`` (labelled ``bench: ...``), with the same
numpy seeds, draws and tolerances; then the cases that cover the kernels'
own variants and their boundaries (labelled by what they cover).  Each
``Check`` holds one call of a wrapper in ``ops`` (``got``) and what it must
agree with (``want``: the plain version in ``ref``, or for the scan's chunk
test the same wrapper at another chunk).  ``chip_smoke.py`` and the card
tests in ``tests/test_torch_card.py`` iterate over these lists; on CPU
tensors ``got`` takes the plain version, as every wrapper does.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from . import banked_matmul as _bm
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


MATMUL_SHAPES = [(8, 16, 8), (32, 64, 48), (48, 64, 40), (1, 64, 48), (17, 33, 9),
                 (128, 128, 128)]                    # (M, K, N), tests/test_kernels.py
MATMUL_BANKS = [(1, 1, 1), (2, 2, 2), (4, 2, 1), (1, 4, 4)]

# Every distinct matmul of the paper's designs as the port compiles them (FFNN
# f1/f2/f4, MHA f1/f2, CNN f1): (M, K, N, factor, B a transposed view).
# tests/test_torch_kernels.py holds this list against the compiled graphs.
MAIN_PATH_MATMULS = [
    (1, 48, 4, 1, False), (1, 48, 4, 2, False), (1, 48, 4, 4, False),
    (1, 64, 48, 1, False), (1, 64, 48, 2, False), (1, 64, 48, 4, False),
    (1, 5472, 2, 1, False),
    (8, 8, 21, 1, False), (8, 8, 21, 2, False),
    (8, 21, 8, 1, True), (8, 21, 8, 2, True),
    (8, 21, 42, 1, False), (8, 21, 42, 2, False),
    (8, 42, 21, 1, False), (8, 42, 21, 2, False),
    (8, 42, 42, 1, False), (8, 42, 42, 2, False),
]

# qwen2-0.5b's attention heads (src/repro/configs/qwen2_0_5b.py) at 4096 tokens
QWEN2_0_5B_ATTENTION = dict(b=1, hq=14, hkv=2, s=4096, d=64)

# one layer's scan at a 4096-token prefill, at the heads of the configurations
# the repo registers (src/repro/configs/rwkv6_7b.py, zamba2_7b.py): rwkv6-7b's
# bonus scan (64 heads of 64, chunk 64 as rwkv.py:77) and zamba2-7b's
# inclusive one (112 heads of 64, state 64, chunk 64 as mamba.py:66)
RWKV6_7B_SCAN = dict(b=1, h=64, s=4096, dk=64, dv=64, chunk=64, mode="bonus")
ZAMBA2_7B_SCAN = dict(b=1, h=112, s=4096, dk=64, dv=64, chunk=64, mode="inclusive")

# the paper's CNN conv (3 -> 8 channels, 80 x 60, 5 x 5)
PAPER_CNN_CONV = dict(cin=3, cout=8, h=80, w=60, kh=5, kw=5)


def full_width_scan(device, cfg: dict):
    """(q, k, v, w, u) of a full-width scan, drawn as kernel_bench.py:50-55
    draws them: a per-channel decay and a bonus ``u`` in bonus mode (RWKV6);
    one decay per head and step broadcast over dk, and no ``u``, in
    inclusive mode (Mamba2, as mamba.py:59-65)."""
    b, h, s, dk, dv = (cfg[x] for x in ("b", "h", "s", "dk", "dv"))
    rng = np.random.default_rng(s + h)
    q = _on(device, rng.normal(size=(b, h, s, dk)))
    k = _on(device, rng.normal(size=(b, h, s, dk)))
    v = _on(device, rng.normal(size=(b, h, s, dv)))
    if cfg["mode"] == "bonus":
        w = _on(device, -np.abs(rng.normal(size=(b, h, s, dk))) * 0.2)
        u = _on(device, rng.normal(size=(h, dk)))
    else:
        w1 = -np.abs(rng.normal(size=(b, h, s, 1))) * 0.2
        w = _on(device, np.ascontiguousarray(np.broadcast_to(w1, (b, h, s, dk))))
        u = None
    return q, k, v, w, u


def linear_weight(rng, k: int, n: int) -> np.ndarray:
    """A (K, N) weight drawn as ``frontend.Linear`` draws it (fan-in scaled).

    With unit-variance B the f32 rounding of a K = 1024 sum alone is about
    2e-5 rms, the tolerance itself; a Linear's weights keep the products'
    sum at unit scale.
    """
    bound = (1.0 / max(k, 1)) ** 0.5
    return rng.uniform(-bound, bound, size=(k, n)).astype(np.float32)


def _matmul_check(label, a, b, banks, out_dtype=None) -> Check:
    tol = TOL[a.dtype]
    return Check(label,
                 lambda: ops.matmul(a, b, banks=banks, out_dtype=out_dtype),
                 lambda: ref.matmul_ref(a, b, out_dtype), tol, tol)


def matmul(device) -> List[Check]:
    """TestBankedMatmul's shapes at every bank plan with B as a transposed
    view (``kh.t()`` in the MHA reaches the kernel so) and at banks (2,2,2)
    contiguous, its bank partitions and its f32 accumulation of bf16; every
    matmul of the main path, with B a view where the path has one; then the
    skinny variant's boundaries (the dispatch threshold M = 16 and one above
    it, split-K, K a multiple of no tile, bf16) and the tiled variant at
    256^3 and 1024^3."""
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in MATMUL_SHAPES:
            rng = np.random.default_rng(m * 1000 + k * 10 + n)
            a = _on(device, rng.normal(size=(m, k)), dtype)
            bt = _on(device, rng.normal(size=(n, k)), dtype).t()
            b = _on(device, rng.normal(size=(k, n)), dtype)
            for banks in MATMUL_BANKS:
                out.append(_matmul_check(
                    f"tests: {m}x{k}x{n} banks {banks} B view {_dtype_name(dtype)}",
                    a, bt, banks))
            out.append(_matmul_check(
                f"tests: {m}x{k}x{n} banks (2, 2, 2) {_dtype_name(dtype)}",
                a, b, (2, 2, 2)))
    rng = np.random.default_rng(7)
    a = _on(device, rng.normal(size=(64, 96)))
    b = _on(device, rng.normal(size=(96, 64)))
    for banks in MATMUL_BANKS:
        out.append(_matmul_check(f"tests: 64x96x64 banks {banks}", a, b, banks))
    ones = torch.ones(8, 512, dtype=torch.bfloat16, device=device)
    out.append(Check(
        "tests: bf16 ones K 512 accumulate in f32 (exact)",
        lambda: ops.matmul(ones, ones.t(), out_dtype=torch.float32),
        lambda: torch.full((8, 8), 512.0, device=device), 0.0, 0.0))

    rng = np.random.default_rng(1)
    for m, k, n, f, view in MAIN_PATH_MATMULS:
        a = _on(device, rng.normal(size=(m, k)))
        w = linear_weight(rng, k, n)
        b = _on(device, w.T).t() if view else _on(device, w)
        out.append(_matmul_check(
            f"main path: {m}x{k}x{n} f{f}{' B view' if view else ''}", a, b, (f, f, f)))

    boundary = [  # (label, m, k, n, banks, dtype, out_dtype)
        ("M at the skinny threshold", _bm.SKINNY_MAX_M, 300, 40, (1, 1, 1),
         torch.float32, None),
        ("M one above it (tiled)", _bm.SKINNY_MAX_M + 1, 300, 40, (1, 1, 1),
         torch.float32, None),
        ("split-K", 1, 65536, 8, (1, 1, 1), torch.float32, None),
        ("split-K bf16", 1, 65536, 8, (1, 1, 1), torch.bfloat16, None),
        ("split-K, rows and banks", 12, 40000, 24, (2, 2, 2), torch.float32, None),
        ("K a multiple of no tile", 5, 1001, 13, (2, 2, 2), torch.float32, None),
        ("skinny bf16", 8, 5472, 24, (1, 1, 1), torch.bfloat16, None),
        ("skinny bf16 -> f32", 3, 777, 50, (1, 2, 1), torch.bfloat16, torch.float32),
        ("tiled bf16, tensor cores, ragged K and N", 200, 1000, 136, (2, 2, 2),
         torch.bfloat16, torch.float32),
    ]
    for label, m, k, n, banks, dtype, out_dtype in boundary:
        rng = np.random.default_rng(m * 7 + k + n)
        a = _on(device, rng.normal(size=(m, k)), dtype)
        b = _on(device, linear_weight(rng, k, n), dtype)
        out.append(_matmul_check(f"{label}: {m}x{k}x{n} banks {banks} "
                                 f"{_dtype_name(dtype)}", a, b, banks, out_dtype))
    rng = np.random.default_rng(24)                 # B a transposed view, K-major
    a = _on(device, rng.normal(size=(136, 520)), torch.bfloat16)
    bt = _on(device, linear_weight(rng, 520, 264).T, torch.bfloat16).t()
    out.append(_matmul_check("tiled bf16, tensor cores, B view: 136x520x264 banks "
                             "(1, 1, 1)", a, bt, (1, 1, 1)))

    rng = np.random.default_rng(0)
    for s, factors in ((256, (1, 2, 4)), (1024, (1,))):
        a = _on(device, rng.normal(size=(s, s)))
        b = _on(device, linear_weight(rng, s, s))
        for f in factors:
            out.append(_matmul_check(f"tiled: {s}^3 banks {(f, f, f)}", a, b, (f, f, f)))
    a = _on(device, rng.normal(size=(1024, 1024)), torch.bfloat16)
    b = _on(device, rng.normal(size=(1024, 1024)), torch.bfloat16)
    out.append(_matmul_check("tiled: 1024^3 bf16 -> f32", a, b, (1, 1, 1),
                             torch.float32))
    return out


def deterministic(device) -> List[Tuple[str, Callable[[], torch.Tensor]]]:
    """Calls of the redesigned kernels that must give the same bits twice:
    the CNN's product, a split-K product, full-width attention at
    qwen2-0.5b's heads in each dtype, both full-width scans and the paper's
    conv at banks (1, 1)."""
    rng = np.random.default_rng(3)
    a1 = _on(device, rng.normal(size=(1, 5472)))
    b1 = _on(device, linear_weight(rng, 5472, 2))
    a2 = _on(device, rng.normal(size=(1, 65536)))
    b2 = _on(device, linear_weight(rng, 65536, 8))
    cfg = QWEN2_0_5B_ATTENTION
    q, k, v = (_on(device, rng.normal(size=(cfg["b"], h, cfg["s"], cfg["d"])))
               for h in (cfg["hq"], cfg["hkv"], cfg["hkv"]))
    q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
    return [("matmul 1x5472x2 (the CNN's)", lambda: ops.matmul(a1, b1)),
            ("matmul 1x65536x8 (split-K)", lambda: ops.matmul(a2, b2)),
            ("attention qwen2-0.5b causal f32", lambda: ops.attention(q, k, v)),
            ("attention qwen2-0.5b causal bf16", lambda: ops.attention(q16, k16, v16))
            ] + [(f"scan {name} {cfg['mode']}", _full_scan_call(device, cfg))
                 for name, cfg in (("rwkv6-7b", RWKV6_7B_SCAN),
                                   ("zamba2-7b", ZAMBA2_7B_SCAN))] + [
            ("conv paper_cnn banks (1, 1)", _paper_conv_call(device, rng))]


def _full_scan_call(device, cfg: dict) -> Callable[[], torch.Tensor]:
    q, k, v, w, u = full_width_scan(device, cfg)
    return lambda: ops.decay_scan(q, k, v, w, u=u, chunk=cfg["chunk"],
                                  diag_mode=cfg["mode"])


def _paper_conv_call(device, rng) -> Callable[[], torch.Tensor]:
    c = PAPER_CNN_CONV
    x = _on(device, rng.normal(size=(c["cin"], c["h"], c["w"])))
    w = _on(device, rng.normal(size=(c["cout"], c["cin"], c["kh"], c["kw"])))
    return lambda: ops.conv2d(x, w, banks=(1, 1))


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
    # the kernel's own boundaries: head dims padded to its tiles (the bf16
    # tensor-core path pads to 16, the f32 path to 32), a sequence that is a
    # multiple of no tile, and a causal grid whose q tiles run heaviest first
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(f"head dim {d}", 128, d, True, 128) for d in (32, 64, 128)]
        cases += [("S 100 non-causal", 100, 64, False, 128),
                  ("causal S 192", 192, 64, True, 64)]
        for label, s, d, causal, blk in cases:
            rng = np.random.default_rng(s * 1000 + d)
            qkv = [_on(device, rng.normal(size=(1, h, s, d)), dtype) for h in (4, 2, 2)]
            out.append(Check(
                f"{label}: gqa 4:2 S {s} D {d} {_dtype_name(dtype)}",
                lambda qkv=qkv, c=causal, blk=blk: ops.attention(
                    *qkv, causal=c, block_q=blk, block_k=blk),
                lambda qkv=qkv, c=causal: ref.attention_ref(*qkv, causal=c),
                TOL[dtype], TOL[dtype]))
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
    """Every case of TestBankedConv2d; then the kernel's own variants: many
    blocks, inputs wide enough that ``plan`` halves the block to fit its
    window in shared memory (down to 32 threads of 2 x 32 outputs), taps at
    run time (4x4, 1x1, 7x3), bf16."""
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
    for label, (cin, cout, h, wd, kh, kw), banks, dtype in CONV_VARIANTS:
        rng = np.random.default_rng(cout * 1000 + h + kh)
        x = _on(device, rng.normal(size=(cin, h, wd)), dtype)
        w = _on(device, rng.normal(size=(cout, cin, kh, kw)) / (cin * kh * kw) ** 0.5,
                dtype)
        out.append(Check(
            f"{label}: {cin}->{cout} {h}x{wd} k{kh}x{kw} banks {banks} "
            f"{_dtype_name(dtype)}",
            lambda x=x, w=w, b=banks: ops.conv2d(x, w, banks=b),
            lambda x=x, w=w: ref.conv2d_ref(x, w), TOL[dtype], TOL[dtype]))
    return out


# (label, (Cin, Cout, H, W, kh, kw), banks, dtype): the conv kernel's own
# variants; ``tests/test_torch_conv.py`` holds each plan's block size, named
# in the label, at the H100's 232,448 bytes of shared memory a block
CONV_VARIANTS = [
    ("many blocks, 256-thread", (8, 64, 130, 130, 3, 3), (1, 1), torch.float32),
    ("many blocks, banks, 256-thread", (8, 64, 130, 130, 3, 3), (4, 2), torch.float32),
    ("wide input, 256-thread", (64, 8, 40, 40, 5, 5), (1, 1), torch.float32),
    ("wide input, 128-thread", (128, 8, 40, 40, 3, 3), (1, 1), torch.float32),
    ("wide input, 64-thread", (128, 4, 24, 24, 5, 5), (2, 2), torch.float32),
    ("wide input, 32-thread", (240, 4, 20, 20, 3, 3), (2, 2), torch.float32),
    ("taps at run time, 256-thread", (2, 3, 20, 20, 4, 4), (1, 1), torch.float32),
    ("taps at run time, 1x1, 256-thread", (3, 5, 9, 7, 1, 1), (2, 2), torch.float32),
    ("taps at run time, 7x3, 256-thread", (8, 64, 100, 40, 7, 3), (1, 1), torch.float32),
    ("taps at run time, wide input, 128-thread", (100, 6, 30, 30, 4, 4), (1, 1),
     torch.float32),
    ("many blocks, 256-thread", (8, 64, 130, 130, 5, 5), (1, 1), torch.bfloat16),
    ("wide input, 128-thread", (128, 8, 40, 40, 3, 3), (1, 1), torch.bfloat16),
]
