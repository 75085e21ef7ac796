"""Training cells: the port's train step on packed documents.

Set-up builds one training state (the weights from the seed and AdamW's
moments), drives it through its first steps with the window's own call and
feed, on batches whose rows all differ, and hands that same state to the
window.  Around those steps it reads, for the check, each step's loss, the
first gradient as the optimizer got it (its first moment after one step
over 1 - beta1) and each leaf's change over the checked steps.  A step ends
when its loss has been read back to the host.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from perfbench import cells, traffic as TR
from perfbench.reference.common import leaf_norms, train


def _named(tree, prefix=""):
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _named(tree[k], p)
        else:
            yield p, tree[k]


def run(cfg_file: Dict, port_cfg, spec: Dict, params, seed: int,
        seconds: float, trace: bool, device, t_start: float, log) -> Dict:
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw
    from perfbench import trace as TW

    t_driver = time.perf_counter()
    o = spec["optimizer"]
    step_fn = ST.make_train_step(port_cfg, adamw.AdamWConfig(**o))
    pool = TR.train_batches(spec, seed, cfg_file["vocab_size"])
    batches = torch.from_numpy(pool).to(device)
    state = {"params": params, "opt": adamw.init_state(params)}
    tokens_per_step = spec["batch"] * spec["seq_len"]

    def step(i: int) -> float:
        nonlocal state
        state, m = step_fn(state, {"tokens": batches[i % len(batches)]})
        return float(m["loss"])

    checked = spec["checked_steps"]
    start = [(p, t.detach().clone()) for p, t in _named(params)]
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    t_state = time.perf_counter()
    checked_walls = []
    for i in range(checked):
        a = time.perf_counter()
        losses.append(step(i))
        checked_walls.append(time.perf_counter() - a)
        if i == 0:
            b1 = o["beta1"]
            grad_norms = leaf_norms((p, m / (1 - b1))
                                    for p, m in _named(state["opt"].m))
    change_norms = leaf_norms((p, t.float() - t0.float()) for (p, t0), (_, t)
                              in zip(start, _named(state["params"])))
    del start
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"set-up: {t_driver - t_start:.2f} s to the driver (imports, "
        f"weights), {t_state - t_driver:.2f} s state and pool, checked steps "
        f"{[round(w, 2) for w in checked_walls]} s, then "
        f"{time.perf_counter() - t_state - sum(checked_walls):.2f} s of norms")

    summary = None
    paused = 0.0            # profiled steps and trace reading, in the window
    traced_steps = 0
    t0 = time.perf_counter()
    n, walls, bad = 0, [], 0
    i = checked
    trace_at = spec.get("trace_after_steps", 1)
    while True:
        if trace and n == trace_at:
            for attempt in range(4):
                t_w, n_w = time.perf_counter(), n
                w = TW.Window(device)
                with w:
                    for _ in range(spec.get("trace_steps", 2)):
                        a = time.perf_counter()
                        bad += not math.isfinite(step(i))
                        walls.append(time.perf_counter() - a)
                        i, n = i + 1, n + 1
                summary = w.read(["train_step.grads", "train_step.optimizer"])
                # the profiled steps run slower: leave them and the trace's
                # reading out of what mfu.train reads
                paused += time.perf_counter() - t_w
                traced_steps += n - n_w
                log(f"trace window {attempt}: span/events "
                    f"{summary.get('span_ratio')} trusted {summary.get('trusted')}")
                if summary.get("trusted") or device.type != "cuda":
                    break
            else:
                summary = None
        a = time.perf_counter()
        bad += not math.isfinite(step(i))
        walls.append(time.perf_counter() - a)
        i, n = i + 1, n + 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    return {
        "setup_s": t0 - t_start, "window": (t0, t1), "steps": n,
        "untraced_s": t1 - t0 - paused,
        "tokens": n * tokens_per_step, "walls": walls, "failed": bad,
        "losses": losses, "grad_norms": grad_norms,
        "change_norms": change_norms, "pool": pool, "trace": summary,
        "traced_steps": spec.get("trace_steps", 2) if summary is not None else 0,
        "untraced_steps": n - traced_steps, "state": state,
    }


def end_to_end(rec: Dict, log) -> Dict[str, float]:
    t0, t1 = rec["window"]
    log(f"window {t1 - t0:.3f} s, {rec['steps']} steps, {rec['tokens']} "
        f"tokens, failed steps {rec['failed']}")
    return {"train_tokens_per_s": rec["tokens"] / (t1 - t0),
            "setup_s": rec["setup_s"],
            "_attempted": rec["steps"], "_failed": rec["failed"]}


def to_f32(tree):
    """The weight tree's leaves in float32, in place."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            to_f32(tree[k])
        else:
            tree[k] = tree[k].float()
    return tree


def reference(cfg_file: Dict, spec: Dict, rec: Dict, weights, device,
              precision=None, rows=None) -> Dict:
    """The reference's training over the checked steps' batches (the first
    ``rows`` rows of each, all by default), from ``weights``, its
    parameters stored in the configuration's dtype, on the loss of the
    configuration's reference module."""
    batches = [torch.from_numpy(rec["pool"][i][:rows]).to(device)
               for i in range(spec["checked_steps"])]
    return train(cells.reference(cfg_file).loss, cfg_file, to_f32(weights),
                 batches, spec["optimizer"], precision,
                 getattr(torch, cfg_file["dtype"]))


def check(cfg_file: Dict, spec: Dict, rec: Dict, seed: int, weights, device,
          log, limits=None) -> Dict[str, float]:
    """The numbers compared (``verdict.train_numbers``)."""
    from perfbench import verdict
    ref = reference(cfg_file, spec, rec, weights, device)
    numbers = verdict.train_numbers(rec, ref)
    log(f"losses {rec['losses']} reference {ref['losses']}; worst gradient "
        f"leaf {numbers['_grad_leaf']}, change leaf {numbers['_change_leaf']}; "
        f"leaves left out of the change {numbers['_left_out']} of "
        f"{len(ref['grad_norms'])}")
    return numbers
