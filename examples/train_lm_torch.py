"""End-to-end training driver with fault tolerance, on the PyTorch port.

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen2-0.5b \
        --steps 60 [--inject-failure 25]

The twin of ``examples/train_lm.py`` on ``repro_torch``, on ``cuda`` unless
``--device`` names another device (``--device cpu`` runs it on the CPU;
without a card and without ``--device`` it raises ``RuntimeError``).
Trains the reduced config on the synthetic bigram corpus with the full
runtime: AdamW + schedule, periodic checkpoints, restart-on-failure, and
straggler detection.  Loss must drop as the model learns the planted
bigrams.

``--profile-layers PATH`` additionally runs a short greedy decode of the
*trained* parameters through the sliced per-operator step and writes the
layer-record JSONL (``repro_torch.obs.modelprof`` schema), the artifact
the serving drivers emit.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.data.pipeline import DataConfig
from repro_torch.models import get_config
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig, WorkerFailure


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda; raises "
                         "without a card unless --device cpu)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="simulate a node failure at this step")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--profile-layers", default="",
                    help="after training, profile a short greedy decode "
                         "of the trained params and write the per-operator "
                         "layer records here as JSONL")
    ap.add_argument("--profile-steps", type=int, default=8,
                    help="decode steps for --profile-layers")
    ap.add_argument("--stable", action="store_true",
                    help="normalize wall-clock fields in the layer export")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=10,
                         checkpoint_dir=ckpt)
    opt = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                            total_steps=args.steps, weight_decay=0.01)
    fired = {"done": False}

    def maybe_fail(step):
        if step == args.inject_failure and not fired["done"]:
            fired["done"] = True
            print(f"!! injecting WorkerFailure at step {step}")
            raise WorkerFailure("simulated preemption")

    tr = Trainer(cfg, tcfg, opt_cfg=opt,
                 data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=args.seq,
                                     global_batch=args.batch),
                 failure_hook=maybe_fail if args.inject_failure >= 0 else None,
                 device=args.device)
    state = tr.run_with_restarts()

    losses = [h["loss"] for h in tr.history if "loss" in h]
    restarts = [h for h in tr.history if "restart" in h]
    print(f"\narch={cfg.name} steps={args.steps} "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(ln V = {np.log(cfg.vocab_size):.2f}) restarts={len(restarts)}")
    if tr.detector.stragglers():
        print("stragglers:", tr.detector.stragglers())
    assert losses[-1] < losses[0], "loss did not decrease"

    if args.profile_layers:
        from repro_torch.models import decode
        from repro_torch.obs import modelprof as MPF
        if cfg.family not in decode.PROFILED_FAMILIES:
            ap.error(f"--profile-layers supports families "
                     f"{decode.PROFILED_FAMILIES}, not {cfg.family}")
        n, batch = args.profile_steps, 2
        pstep = decode.make_profiled_serve_step(cfg)
        cache = decode.ProfiledServeStep.init_cache(
            cfg, state["params"], batch, n + 1)
        layers = MPF.LayerProfiler()
        tok = torch.ones((batch, 1), dtype=torch.int32, device=tr.device)
        with torch.no_grad():
            for i in range(n):
                logits, cache, walls = pstep(state["params"], cache, tok, i)
                layers.on_step(i, pstep.ops, walls)
                tok = torch.argmax(logits[:, -1], dim=-1).to(
                    torch.int32)[:, None]
        problems = MPF.validate(layers.records, cfg=cfg, engine_steps=n)
        assert not problems, problems
        with open(args.profile_layers, "w") as f:
            f.write(MPF.to_jsonl(layers.records, stable=args.stable))
        print(f"{len(layers.records)} layer records -> "
              f"{args.profile_layers}{' (stable)' if args.stable else ''}")
    print("OK")


if __name__ == "__main__":
    main()
