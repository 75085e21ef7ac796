"""Kernel microbenches of the PyTorch port: the Hopper kernels against their
plain versions.

The twin of ``benchmarks/kernel_bench.py`` (it imports nothing of
``repro`` and no ``jax``), with its shapes, seeds and line names: the
banked matmul at 256^3 over banks 1/2/4 (``derive_block``'s block in the
line), GQA attention 4:2 x 256 x 64, the Mamba2 (inclusive) and RWKV6
(bonus) decay scans at 1 x 4 x 256 x 32, and each plain version
(``repro_torch.kernels.ref``).  The conv kernel is not in it, as it is not
in the reference's.

Each kernel line holds ``repro_torch.kernels.ops``' output against the
plain version and fails the section past its tolerance (``err=`` in the
line): 2e-5 for attention and 1e-4 for the scans (the kernels' test
tolerances, ``repro_torch.kernels.checks``), 2e-5 * sqrt(K) for the
products of unit-normal 256 x 256 operands (the f32 rounding of a K-term
sum).

On the card a wrapper launches its kernel; a call is timed with CUDA events
over back-to-back calls after a warm call.  On the CPU the wrappers route to
the plain versions, so the section's times there only show that it runs.

    PYTHONPATH=src:. python benchmarks/kernel_bench_torch.py --device cpu
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks import torch_device
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.banked_matmul import derive_block

ATTN_TOL = 2e-5
SCAN_TOL = 1e-4


def _time(fn, *args, dev: torch.device, iters: int = 3) -> float:
    """Microseconds a call: CUDA events over ``iters`` back-to-back calls on
    the card, the host clock on the CPU; a warm call first."""
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters * 1e6


def _held(label: str, got: torch.Tensor, want: torch.Tensor,
          tol: float) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise RuntimeError(f"{label}: max |kernel - plain| {err:.3g} over "
                           f"rtol = atol = {tol:g}")
    return err


def run(emit, device=None) -> None:
    dev = resolve_device(device)
    iters = 20 if dev.type == "cuda" else 3
    rng = np.random.default_rng(0)

    def on(shape, scale=1.0, negative=False):
        x = rng.normal(size=shape)
        x = -np.abs(x) * scale if negative else x * scale
        return torch.tensor(x, dtype=torch.float32, device=dev)

    # banked matmul: factor sweep mirrors the paper's partition sweep
    a, b = on((256, 256)), on((256, 256))
    want = ref.matmul_ref(a, b)
    for banks in ((1, 1, 1), (2, 2, 2), (4, 4, 4)):
        call = lambda x, y, banks=banks: ops.matmul(x, y, banks=banks)
        err = _held(f"matmul banks {banks}", call(a, b), want,
                    2e-5 * 256 ** 0.5)
        us = _time(call, a, b, dev=dev, iters=iters)
        blk = derive_block(256, 256, 256, banks)
        emit(f"kernel_matmul_banks{banks[0]}", us,
             f"block={blk}|err={err:.2g}")
    emit("kernel_matmul_ref", _time(ref.matmul_ref, a, b, dev=dev,
                                    iters=iters), "plain_torch")

    # flash attention
    q, k, v = on((1, 4, 256, 64)), on((1, 2, 256, 64)), on((1, 2, 256, 64))

    def attn(*t):
        return ops.attention(*t, causal=True, block_q=64, block_k=64)

    def attn_ref(*t):
        return ref.attention_ref(*t, causal=True)
    err = _held("attention", attn(q, k, v), attn_ref(q, k, v), ATTN_TOL)
    emit("kernel_flash_attention", _time(attn, q, k, v, dev=dev, iters=iters),
         f"gqa4:2_s256_d64|err={err:.2g}")
    emit("kernel_attention_ref", _time(attn_ref, q, k, v, dev=dev,
                                       iters=iters), "plain_torch")

    # decay scan (Mamba2 + RWKV modes)
    q2, k2, v2 = on((1, 4, 256, 32)), on((1, 4, 256, 32)), on((1, 4, 256, 32))
    w2 = on((1, 4, 256, 32), scale=0.2, negative=True)
    u2 = on((4, 32))
    scans = (
        ("kernel_ssm_scan_inclusive", "mamba2_mode",
         lambda *t: ops.decay_scan(*t, chunk=32),
         lambda *t: ref.ssm_scan_ref(*t)),
        ("kernel_ssm_scan_bonus", "rwkv6_mode",
         lambda *t: ops.decay_scan(*t, u=u2, chunk=32, diag_mode="bonus"),
         lambda *t: ref.ssm_scan_ref(*t, u=u2, diag_mode="bonus")))
    for name, note, call, plain in scans:
        err = _held(name, call(q2, k2, v2, w2), plain(q2, k2, v2, w2),
                    SCAN_TOL)
        emit(name, _time(call, q2, k2, v2, w2, dev=dev, iters=iters),
             f"{note}|err={err:.2g}")
    emit("kernel_ssm_scan_ref", _time(
        lambda *t: ref.ssm_scan_ref(*t), q2, k2, v2, w2, dev=dev,
        iters=1 if dev.type == "cuda" else iters), "plain_torch")


if __name__ == "__main__":
    torch_device.main(run, __doc__)
