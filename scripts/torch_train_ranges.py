"""The benchmark's training cell, read by layer: the first step's set-up
cost, the untraced step, the harness's full traced window and the
ranges-only window, on one card.

    python3 scripts/torch_train_ranges.py [--workload W] [--seed N] \\
        [--untraced 4] [--out build/train_ranges.json]

Builds the cell as ``perfbench/run.py`` does (weights from the seed, the
traffic's batches, AdamW), with a ``MetricsRegistry`` on the train step
(``launch.steps.TrainCounters``), then:

1. the first step, then the second, each in ``obs.ranges.profile``: its
   wall, the device's busy time, the runtime's host time by call
   (``cudaMalloc``, the launches), the idle gaps before the first launch
   of each kernel and elsewhere, the longest gaps with what the host had
   open, and the registry's deltas (the allocator's mallocs and retries);
2. the third step untraced, with its deltas;
3. ``--untraced`` steps untraced: their median wall;
4. two steps in ``perfbench.trace.Window`` (the harness's traced window,
   every operator recorded): the four accepted per-layer readings and the
   steps' walls;
5. two steps in ``perfbench.attribution.RangesWindow``: the table of
   range, device ms and idle ms a step, the readers of the ranges-only
   window (each None where the cell's model has no such range), its
   steps' walls against the untraced median, and whether the charges add
   up to the busy time.

Each window is refused and traced again (up to 4 times) unless its device
work spans 0.97-1.01 of the CUDA events around it.  Prints one JSON line
per phase and writes all of them to ``--out``.  Needs a CUDA card.
"""
import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

NEW = ["attn_device_ms.train", "moe_device_ms.train",
       "moe_assign_device_ms.train", "loss_device_ms.train",
       "step_idle_ms.train", "attn_latent_device_ms.train",
       "moe_shared_device_ms.train", "attn_roofline.train"]
OLD = ["grads_device_ms.train", "optimizer_device_ms.train",
       "device_idle_share.train"]
RUNTIME = ("cuda_runtime", "cuda_driver")


def step_costs(events, busy_s):
    """Where a step's host time goes, from its ranges-only trace: the
    runtime's host time by call, the idle gaps before each kernel's first
    launch and elsewhere, and the longest gaps with the innermost range of
    each thread and the runtime calls inside them."""
    host = defaultdict(float)
    calls = defaultdict(int)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in RUNTIME:
            host[e["name"]] += e["dur"] / 1e6
            calls[e["name"]] += 1
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda e: e["ts"])
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in RUNTIME
                and "correlation" in e.get("args", {})}
    seen, end = set(), None
    first_gap = later_gap = first_launch_host = 0.0
    firsts = 0
    gaps = []
    for e in dev:
        gap = max(0.0, e["ts"] - end) / 1e6 if end is not None else 0.0
        first = e["name"] not in seen
        if gap > 0:
            gaps.append((gap, end, e["ts"], e["name"][:60], first))
        seen.add(e["name"])
        if first:
            firsts += 1
            first_gap += gap
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is not None:
                first_launch_host += launch["dur"] / 1e6
        else:
            later_gap += gap
        end = e["ts"] + e["dur"] if end is None else max(end, e["ts"] + e["dur"])
    top = sorted(host.items(), key=lambda kv: -kv[1])[:12]
    t0 = dev[0]["ts"] if dev else 0.0
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    runtime = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in RUNTIME]
    longest = []
    for gap, a, b, nxt, first in sorted(gaps, reverse=True)[:15]:
        open_ = defaultdict(list)
        for r in ranges:
            if r["ts"] <= a and r["ts"] + r["dur"] >= b:
                open_[r["tid"]].append((r["ts"], r["name"]))
        inner = sorted(max(v)[1] for v in open_.values())
        inside = defaultdict(float)
        for r in runtime:
            if a <= r["ts"] and r["ts"] + r["dur"] <= b:
                inside[r["name"]] += r["dur"] / 1e6
        longest.append({"at_s": round((a - t0) / 1e6, 4), "gap_s": gap,
                        "next_kernel": nxt, "first_launch": first,
                        "innermost": inner,
                        "runtime_inside_s": {k: round(v, 6)
                                             for k, v in inside.items()}})
    return {"busy_s": busy_s, "kernel_names": firsts,
            "idle_before_first_launches_s": first_gap,
            "idle_elsewhere_s": later_gap,
            "first_launch_calls_host_s": first_launch_host,
            "runtime_host_s": {k: [round(v, 6), calls[k]] for k, v in top},
            "longest_gaps": longest}


def main(argv=None, *, device=None, overrides=None) -> int:
    """``device`` and ``overrides`` (``config`` and ``traffic`` entries
    merged over the cell's files) rehearse the script on the CPU at a small
    size."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="granite-moe-1b-a400m.train-4k")
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--untraced", type=int, default=4)
    ap.add_argument("--out", default="build/train_ranges.json")
    args = ap.parse_args(argv)

    import torch
    from perfbench import attribution, cells, trace as TW, traffic as TR
    from perfbench import weights as W
    from repro_torch.launch import steps as ST
    from repro_torch.models import get_config
    from repro_torch.obs import MetricsRegistry, ranges
    from repro_torch.optim import adamw

    if device is None:
        if not torch.cuda.is_available():
            print("needs a CUDA card", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    cell = cells.cell(cells.benchmark(), args.workload)
    cfg_file = cells.config(cell["config"])
    spec = cells.traffic(cell["traffic"])
    port_cfg = get_config(cfg_file["port_config"])
    if overrides:
        cfg_file.update(overrides.get("config", {}))
        spec.update(overrides.get("traffic", {}))
        port_cfg = dataclasses.replace(port_cfg, **{
            k: cfg_file[k] for k in cells.port_keys(cfg_file, port_cfg)})
    out = []

    def emit(phase, **rec):
        rec = {"phase": phase, **rec}
        out.append(rec)
        print(json.dumps(rec), flush=True)

    emit("card", name=torch.cuda.get_device_name(dev)
         if dev.type == "cuda" else "cpu",
         torch=torch.__version__, cuda=torch.version.cuda)
    params = W.make(cfg_file, args.seed, dev, getattr(torch, cfg_file["dtype"]))
    reg = MetricsRegistry()
    step_fn = ST.make_train_step(port_cfg, adamw.AdamWConfig(**spec["optimizer"]),
                                 metrics=reg)
    batches = torch.from_numpy(
        TR.train_batches(spec, args.seed, cfg_file["vocab_size"])).to(dev)
    state = {"params": params, "opt": adamw.init_state(params)}
    i = 0
    last = {}

    def deltas():
        now = {n: reg.get(n).value for n in reg.names()}
        d = {n: v - last.get(n, 0) for n, v in now.items()}
        last.update(now)
        return d

    def step():
        nonlocal state, i
        a = time.perf_counter()
        state, m = step_fn(state, {"tokens": batches[i % len(batches)]})
        float(m["loss"])
        i += 1
        return time.perf_counter() - a

    # 1. the first step and the next, each alone in a ranges-only session
    path = os.path.join(ROOT, "build", "train_ranges_step.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for phase in ("first_step", "second_step"):
        with ranges.profile(dev, path):
            wall = step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        one = attribution.attribute(events, None)
        emit(phase, wall_s=wall, counters=deltas(),
             **step_costs(events, one.get("busy_s", 0.0)),
             table=attribution.table(one, 1))

    # 2. the third step
    emit("third_step", walls_s=[step()], counters=deltas())

    # 3. untraced steps
    walls = [step() for _ in range(args.untraced)]
    median = statistics.median(walls)
    emit("untraced", walls_s=walls, median_s=median, counters=deltas())

    def traced(window, read):
        """(summary, the steps' walls, attempt) of the first trusted
        window."""
        for attempt in range(4):
            w = window(dev)
            with w:
                walls = [step() for _ in range(2)]
            s = read(w)
            if s.get("trusted"):
                break
        return s, walls, attempt

    # 4. the harness's full traced window
    s, walls, attempt = traced(TW.Window, lambda w: w.read(
        ["train_step.grads", "train_step.optimizer"]))
    run = SimpleNamespace(trace=s, rec={"traced_steps": 2}, cfg=cfg_file,
                          spec=spec)
    emit("full_window", attempt=attempt, span_ratio=s.get("span_ratio"),
         walls_s=walls, ratio_to_untraced=statistics.median(walls) / median,
         busy_s=s.get("busy_s"), window_s=s.get("window_s"),
         metrics={n: cells.metric_reader(n)(run) for n in OLD},
         idle_gaps=s.get("idle_gaps"), counters=deltas())

    # 5. the ranges-only window
    s, walls, attempt = traced(attribution.RangesWindow, lambda w: w.read())
    s["steps"] = 2
    run = SimpleNamespace(rec={"ranges": s}, cfg=cfg_file, spec=spec)
    charged = sum(r["device_s"] for r in s.get("ranges", {}).values())
    emit("ranges_window", attempt=attempt, span_ratio=s.get("span_ratio"),
         walls_s=walls, ratio_to_untraced=statistics.median(walls) / median,
         busy_s=s.get("busy_s"), window_s=s.get("window_s"),
         charged_over_busy=charged / s["busy_s"] if s.get("busy_s") else None,
         metrics={n: cells.metric_reader(n)(run) for n in NEW},
         table=attribution.table(s, 2), counters=deltas())
    os.makedirs(os.path.dirname(os.path.join(ROOT, args.out)), exist_ok=True)
    with open(os.path.join(ROOT, args.out), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
