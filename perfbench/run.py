"""Benchmark of the PyTorch and CUDA port (``src/repro_torch``): one run of
one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload granite-moe-1b-a400m.train-4k \\
        --seed 7 --seconds 51 --trace 0

Runs on the machine it is started on and needs as many CUDA cards as the
cell asks for; without them it exits 2 and prints no result.  Set-up makes
the weights on the card from ``--seed``, builds the program's serving
engine or training state, warms every shape the cell uses and ramps the
traffic; then the window measures for ``--seconds``.  After the window the
program's state is freed and the plain reference (``perfbench/reference``)
checks what the timed path produced.  ``--trace 1`` runs the same with the
profiler over a few steps of the window and reports the cell's per-layer
metrics instead of its end-to-end ones; on a card, a per-layer metric the
cell lists that reads nothing fails the run (exit 5, no result).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
the same numbers close standard error.  Progress goes to standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def _set_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(ROOT, "build", "perfbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def _card_and_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=False)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "not read"


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _shape_tree(t, prefix=""):
    out = {}
    for k in sorted(t):
        p = f"{prefix}/{k}" if prefix else k
        v = t[k]
        out.update(_shape_tree(v, p) if isinstance(v, dict) else {p: tuple(v[0])})
    return out


def read_per_layer(cell, run):
    """({name: {value, unit}}, [names that read nothing]) over the cell's
    per-layer metrics."""
    from perfbench import cells
    metrics, missing = {}, []
    for m in cell["per_layer"]:
        v = cells.metric_reader(m["name"])(run)
        if v is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics, missing


def main(argv=None, *, device=None, overrides=None) -> int:
    """Run one cell; returns the exit code.  ``device`` and ``overrides``
    (``config``, ``traffic`` and ``limits`` entries merged over the cell's
    files once the file has been checked against the port) are for the
    tests, which run the harness on the CPU at a small size."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _set_env()

    from perfbench import cells, weights as W, verdict
    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    cfg_file = cells.config(cell["config"])
    spec = cells.traffic(cell["traffic"])
    limits = cells.run_limits(args.workload)

    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)

    from repro_torch.models import get_config
    from repro_torch.models.params import param_shapes
    port_cfg = get_config(cfg_file["port_config"])
    # the file as it is committed against the port's registered config,
    # over every key of the file that is a field of the port's config
    bad = cells.check_port_config(cfg_file, port_cfg)
    if bad:
        log("the configuration file and the port's registered config "
            "differ: " + "; ".join(bad))
        return 3
    if overrides:
        cfg_file.update(overrides.get("config", {}))
        spec.update(overrides.get("traffic", {}))
        limits = overrides.get("limits", limits)
        port_cfg = dataclasses.replace(port_cfg, **{
            k: cfg_file[k] for k in cells.port_keys(cfg_file, port_cfg)})
    try:
        tree = W.shapes(cfg_file)
    except KeyError as e:
        log(str(e))
        return 3
    if _shape_tree(tree) != _shape_tree(param_shapes(port_cfg)):
        log("the harness's weight tree differs from the port's param_shapes")
        return 3

    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    limit = _card_and_limit() if dev.type == "cuda" else "not read"
    log(f"{args.workload} seed {args.seed} on {card} ({limit})")
    dtype = getattr(torch, cfg_file["dtype"])
    params = W.make(cfg_file, args.seed, dev, dtype)
    trace = bool(args.trace)
    kind = spec["kind"]
    try:
        D = cells.driver(kind)
    except KeyError as e:
        log(str(e))
        return 3
    rec = D.run(cfg_file, port_cfg, spec, params, args.seed, args.seconds,
                trace, dev, T_START, log)
    e2e = D.end_to_end(rec, log)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        log(f"memory peak {peak} of the card's {total} bytes "
            f"({100.0 * peak / total:.1f}%)")

    run = SimpleNamespace(cfg=cfg_file, spec=spec, rec=rec,
                          trace=rec["trace"], kind=kind)
    if trace:
        metrics, missing = read_per_layer(cell, run)
        if missing and dev.type == "cuda":
            # a metric the cell lists that reads nothing has lost sight of
            # its code (a range, a call site renamed or fused away)
            log(f"per-layer metrics of {args.workload} that read nothing: "
                f"{missing}; no result")
            return 5
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}

    # the check: the program's state freed, the reference on fresh weights
    rec.pop("engine", None)
    rec.pop("state", None)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_w = W.make(cfg_file, args.seed, dev, dtype)
    numbers = D.check(cfg_file, spec, rec, args.seed, ref_w, dev, log, limits)
    del ref_w
    log(f"reference check {time.perf_counter() - t_ref:.1f} s")
    correct, shown = verdict.judge(numbers, limits)

    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": card, "count": cell["chips"],
                  "memory_peak_bytes": int(peak), "power_limit": limit}
    result = {"correct": correct, "attempted": e2e["_attempted"],
              "failed": e2e["_failed"], "metrics": metrics,
              "device": device_rec}
    if trace and rec["trace"] is not None and "busy_s" in rec["trace"]:
        t = rec["trace"]
        device_rec.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = shown

    loaded = forbidden_loaded()
    if loaded:
        log(f"forbidden modules loaded: {loaded}")
        return 4
    for name, s in shown.items():
        log(f"check {name} = {s['value']!r} (limit {s['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
