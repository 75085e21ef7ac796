#!/usr/bin/env python3
"""Split the port's redesigned kernels' time by phase on the card.

    python3 scripts/torch_phase_clocks.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  Builds ``csrc/banked_matmul.cu`` and ``csrc/flash_attention.cu``
with ``-DPHASE_CLOCKS`` (libraries of their own under ``build/kernels``),
whose kernels read ``clock64()`` at the end of each phase
(``csrc/phase_clocks.cuh``).  For each call below it runs the call once,
zeroes the counts, runs it ``REPS`` times and prints one JSON line: the
warp cycles summed per phase, each phase's share, and the mean cycles a
warp spends from its first mark to its last.  The marks perturb the
compiler's scheduling a little, so the split says where a kernel's time
goes; its times come from ``chip_smoke.py``.

Calls: every matmul of the main path (``checks.MAIN_PATH_MATMULS``) and
attention at qwen2-0.5b's heads over 4096 tokens, causal and not, in f32
and bf16.  Prints the card's name, power limit and SM clocks first.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
REPS = {"banked_matmul": 200, "flash_attention": 5}
PHASES = {
    "banked_matmul": ["loads and FMAs", "warp reduce-scatter", "tree over K slices",
                      "store"],
    "flash_attention": ["prologue", "wait for a tile", "issue next copies",
                        "S = q k^T", "softmax", "P.V", "normalise and store"],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_phase_clocks: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    os.environ["REPRO_TORCH_CUDA_DEFINES"] = "PHASE_CLOCKS"
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, checks, ops
    from repro_torch.kernels import banked_matmul as bm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    _build.build(PHASES)
    read = {name: _build.function(name, f"{name}_phase_cycles", [ctypes.c_void_p])
            for name in PHASES}
    buf = (ctypes.c_uint64 * 8)()

    def split(name: str, label: str, call, warps: int) -> None:
        call()
        torch.cuda.synchronize()
        _check(read[name](ctypes.addressof(buf)))
        for _ in range(REPS[name]):
            call()
        torch.cuda.synchronize()
        _check(read[name](ctypes.addressof(buf)))
        cycles = list(buf)[:len(PHASES[name])]
        total = sum(cycles)
        print(json.dumps({
            "kernel": name, "call": label, "reps": REPS[name],
            "cycles_per_warp": total / (warps * REPS[name]),
            "share": {p: c / total for p, c in zip(PHASES[name], cycles)},
            "cycles": dict(zip(PHASES[name], cycles))}))

    rng = np.random.default_rng(1)
    for m, k, n, f, view in checks.MAIN_PATH_MATMULS:
        a = torch.tensor(rng.normal(size=(m, k)), dtype=torch.float32, device="cuda")
        w = torch.tensor(checks.linear_weight(rng, k, n), device="cuda")
        b = w.t().contiguous().t() if view else w
        p = bm.plan(m, n, k, bm.derive_block(m, n, k, (f, f, f)))
        warps = p.grid[0] * p.grid[1] * p.grid[2] * p.threads // 32
        split("banked_matmul", f"{m}x{k}x{n} f{f}",
              lambda a=a, b=b, f=f: ops.matmul(a, b, banks=(f, f, f)), warps)

    cfg = checks.QWEN2_0_5B_ATTENTION
    warps = cfg["b"] * cfg["hq"] * (-(-cfg["s"] // 64)) * 4
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.tensor(rng.normal(size=(cfg["b"], h, cfg["s"], cfg["d"])),
                                dtype=torch.float32, device="cuda").to(dtype)
                   for h in (cfg["hq"], cfg["hkv"], cfg["hkv"]))
        for causal in (True, False):
            split("flash_attention",
                  f"{cfg['hq']}:{cfg['hkv']}x{cfg['s']}x{cfg['d']} causal {causal} "
                  f"{str(dtype).replace('torch.', '')}",
                  lambda q=q, k=k, v=v, c=causal: ops.attention(q, k, v, causal=c),
                  warps)
    return 0


def _check(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"reading the phase counts failed: CUDA error {rc}")


if __name__ == "__main__":
    sys.exit(main())
