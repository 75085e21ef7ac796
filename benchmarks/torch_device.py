"""The device of the PyTorch benchmark twins (``benchmarks/*_torch.py``).

A twin runs on ``cuda`` unless ``--device cpu`` is passed, and raises where
no card is present (``repro_torch.device.resolve_device``, which each twin
calls).  Each output file names the device it ran on: ``nvidia-smi``'s name
and power limit of the card, or ``"cpu"``, so that no CPU number reads as a
device number.
"""
from __future__ import annotations

import argparse
import subprocess
from typing import Callable, Optional

import torch


def label(dev: torch.device) -> str:
    """``"cpu"``, or the card as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints it (``torch``'s name where the tool is
    missing)."""
    if dev.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        smi = None
    if smi is not None and smi.returncode == 0 and smi.stdout.strip():
        return smi.stdout.strip().splitlines()[0].strip()
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


def emit_csv(name: str, us: float, derived) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def main(run: Callable, doc: str, out_help: Optional[str] = None,
         smoke: bool = False) -> None:
    """The command line of a twin: ``--device`` (and ``--out``,
    ``--smoke`` where the reference has them), then ``run(emit, ...)``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card unless --device cpu)")
    if out_help:
        ap.add_argument("--out", default=None, help=out_help)
    if smoke:
        ap.add_argument("--smoke", action="store_true",
                        help="run only the short smoke profile (CI)")
    args = ap.parse_args()
    kw = {"device": args.device}
    if out_help:
        kw["out_path"] = args.out
    if smoke and args.smoke:
        kw["profiles"] = ["smoke"]
    run(emit_csv, **kw)
