#!/usr/bin/env python3
"""Split the port's redesigned kernels' time by phase on the card.

    python3 scripts/torch_phase_clocks.py [kernel ...]

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  Builds the named kernels' sources (all four, ``banked_matmul``,
``flash_attention``, ``ssm_scan`` and ``banked_conv2d``, by default) with
``-DPHASE_CLOCKS`` (libraries of their own under ``build/kernels``),
whose kernels read ``clock64()`` at the end of each phase
(``csrc/phase_clocks.cuh``).  For each call below it runs the call once,
zeroes the counts, runs it ``REPS`` times and prints one JSON line: the
warp cycles summed per phase, each phase's share, and the mean cycles a
warp spends from its first mark to its last.  The marks perturb the
compiler's scheduling a little, so the split says where a kernel's time
goes; its times come from ``chip_smoke.py``.

Calls: every matmul of the main path (``checks.MAIN_PATH_MATMULS``);
attention at qwen2-0.5b's heads over 4096 tokens, causal and not, in f32
and bf16; the two full-width scans (``checks.RWKV6_7B_SCAN``,
``checks.ZAMBA2_7B_SCAN``); the paper's CNN conv at banks (1,1), (2,2) and
(4,2).  Prints the card's name, power limit and SM clocks first.
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
REPS = {"banked_matmul": 200, "flash_attention": 5, "ssm_scan": 3,
        "banked_conv2d": 200}
PHASES = {
    "banked_matmul": ["loads and FMAs", "warp reduce-scatter", "tree over K slices",
                      "store"],
    "flash_attention": ["prologue", "wait for a tile", "issue next copies",
                        "S = q k^T", "softmax", "P.V", "normalise and store"],
    "ssm_scan": ["state: stage", "state: suffix decays and e", "state: Delta product",
                 "state pass", "out: stage", "out: score walk and bonus",
                 "out: cumsum and q exp(W)", "out: o product"],
    "banked_conv2d": ["stage window", "stage weights", "taps", "store"],
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
    names = sys.argv[1:] or list(PHASES)
    unknown = sorted(set(names) - set(PHASES))
    if unknown:
        print(f"torch_phase_clocks: no phases for {unknown}; choose from "
              f"{list(PHASES)}", file=sys.stderr)
        return 2
    _build.build(names)
    read = {name: _build.function(name, f"{name}_phase_cycles", [ctypes.c_void_p])
            for name in names}
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
    for m, k, n, f, view in checks.MAIN_PATH_MATMULS if "banked_matmul" in names else ():
        a = torch.tensor(rng.normal(size=(m, k)), dtype=torch.float32, device="cuda")
        w = torch.tensor(checks.linear_weight(rng, k, n), device="cuda")
        b = w.t().contiguous().t() if view else w
        p = bm.plan(m, n, k, bm.derive_block(m, n, k, (f, f, f)))
        warps = p.grid[0] * p.grid[1] * p.grid[2] * p.threads // 32
        split("banked_matmul", f"{m}x{k}x{n} f{f}",
              lambda a=a, b=b, f=f: ops.matmul(a, b, banks=(f, f, f)), warps)

    cfg = checks.QWEN2_0_5B_ATTENTION
    warps = cfg["b"] * cfg["hq"] * (-(-cfg["s"] // 64)) * 4
    for dtype in (torch.float32, torch.bfloat16) if "flash_attention" in names else ():
        q, k, v = (torch.tensor(rng.normal(size=(cfg["b"], h, cfg["s"], cfg["d"])),
                                dtype=torch.float32, device="cuda").to(dtype)
                   for h in (cfg["hq"], cfg["hkv"], cfg["hkv"]))
        for causal in (True, False):
            split("flash_attention",
                  f"{cfg['hq']}:{cfg['hkv']}x{cfg['s']}x{cfg['d']} causal {causal} "
                  f"{str(dtype).replace('torch.', '')}",
                  lambda q=q, k=k, v=v, c=causal: ops.attention(q, k, v, causal=c),
                  warps)

    for name, cfg in (("rwkv6-7b", checks.RWKV6_7B_SCAN),
                      ("zamba2-7b", checks.ZAMBA2_7B_SCAN)) if "ssm_scan" in names else ():
        q, k, v, w, u = checks.full_width_scan("cuda", cfg)
        split("ssm_scan", f"{name} {cfg['mode']} {cfg['b']}x{cfg['h']}x{cfg['s']}x"
                          f"{cfg['dk']}/{cfg['dv']} chunk {cfg['chunk']}",
              lambda q=q, k=k, v=v, w=w, u=u, cfg=cfg: ops.decay_scan(
                  q, k, v, w, u=u, chunk=cfg["chunk"], diag_mode=cfg["mode"]),
              _scan_warps(cfg))

    c = checks.PAPER_CNN_CONV
    x = torch.tensor(rng.normal(size=(c["cin"], c["h"], c["w"])),
                     dtype=torch.float32, device="cuda")
    wt = torch.tensor(rng.normal(size=(c["cout"], c["cin"], c["kh"], c["kw"])),
                      dtype=torch.float32, device="cuda")
    for banks in ((1, 1), (2, 2), (4, 2)) if "banked_conv2d" in names else ():
        split("banked_conv2d", f"paper_cnn {c['cin']}->{c['cout']} {c['h']}x{c['w']} "
                               f"k{c['kh']}x{c['kw']} banks {banks}",
              lambda b=banks: ops.conv2d(x, wt, banks=b), _conv_warps(c, banks))
    return 0


def _scan_warps(cfg: dict) -> int:
    """Warps of one scan call: its three kernels' blocks, 8 warps each."""
    from repro_torch.kernels import ssm_scan as ss
    blocks = ss.grids(*(cfg[x] for x in ("b", "h", "s", "dk", "dv", "chunk")))
    return sum(blocks) * ss.THREADS // 32


def _conv_warps(c: dict, banks) -> int:
    """Warps of one conv call: the plan's blocks that have work."""
    from repro_torch.kernels import banked_conv2d as bc
    ho, wo = c["h"] - c["kh"] + 1, c["w"] - c["kw"] + 1
    p = bc.plan(c["cout"], ho, wo, banks, c["cin"], c["kh"], c["kw"],
                bc.smem_limit(torch.device("cuda")))
    return len(list(bc.block_tiles(p, c["cout"], ho, wo))) * p.threads // 32


def _check(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"reading the phase counts failed: CUDA error {rc}")


if __name__ == "__main__":
    sys.exit(main())
