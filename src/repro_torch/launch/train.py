"""Training launcher; the port of ``repro.launch.train``, on ``cuda`` unless
``--device`` names another device::

    # the reduced config on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen2-0.5b --reduced --steps 6

    # the registered config (bf16) on one card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b

    # the full config's train step on the production meshes, fake tensors:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --dry-run --device cpu

Without a card and without ``--device`` it raises ``RuntimeError``.
``--dry-run`` runs ``python -m repro_torch.launch.dryrun --arch A --shape
train_4k --both --force --device D`` in a process of its own (the dry run
owns its process's fake process group), as the reference's delegates.
"""
import argparse
import sys
import tempfile
from typing import Optional, Sequence

from repro_torch.data.pipeline import DataConfig
from repro_torch.models import get_config
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda; raises "
                         "without a card unless --device cpu)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--dry-run", action="store_true",
                    help="run the full config's train step on the "
                         "production meshes instead of training")
    args = ap.parse_args(argv)

    if args.dry_run:
        # delegate to the dry-run module (it owns its process's fake group)
        import subprocess
        raise SystemExit(subprocess.call(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", args.arch, "--shape", "train_4k", "--both",
             "--force", "--device", args.device or "cuda"]))

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix=f"train_{args.arch}_")
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.checkpoint_every,
                         checkpoint_dir=ckpt)
    opt = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                            total_steps=args.steps)
    tr = Trainer(cfg, tcfg, opt_cfg=opt,
                 data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=args.seq,
                                     global_batch=args.global_batch),
                 device=args.device)
    tr.run_with_restarts()
    losses = [h["loss"] for h in tr.history if "loss" in h]
    print(f"[train] {cfg.name}: {len(losses)} steps, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, ckpt={ckpt}")


if __name__ == "__main__":
    main()
