"""Readings that set the limits of the check, on the card, many seeds in one
process.

    python3 perfbench/calibrate.py --workload olmoe-1b-7b.decode-c128 \\
        --seeds 11,12,13 --seconds 51 [--control] [--dump DIR]

The workload is ``<config>.<traffic>``, in ``BENCHMARK.json`` or not yet.

Each seed runs what a benchmark run runs (set-up, ramp and a window of
``--seconds`` at the cell's own load, no profiler), then the check's
reference, and prints one JSON line of readings:

- serving: ``program``, the error of the served tokens' logits
  (``serve_driver.reference_errors``: its quantiles, widest and mean, and
  its share over each of a grid of margins); ``gaps``, the gap of
  each served token below the reference's best; ``altered``, the error were
  each served token replaced by the next id (a token altered where it is
  produced); with ``--control`` also ``control``, the error of the
  reference computed in float8 put in the program's place (the control,
  which the check has to refuse);
- training: ``program``, the program's numbers against the reference; with
  ``--control`` also ``control`` (the reference in float8 in the program's
  place) and ``half_batch`` (the reference on half of each batch, the mean
  over the rest); a step that leaves the state unchanged reads 1 in
  ``change_gap`` by its definition and needs no run.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def log(msg: str) -> None:
    print(f"[calibrate] {msg}", file=sys.stderr, flush=True)


MARGINS = (0.06, 0.08, 0.1, 0.12, 0.15, 0.2)


def _stats(gaps) -> dict:
    """Per-token readings' quantiles, widest and mean, and ``over``: the
    share over each margin of ``MARGINS`` (the number compared is the share
    over the margin that the cell's limits give)."""
    import torch
    g = gaps.double()
    q = g.quantile(torch.tensor([0.5, 0.9, 0.99], dtype=g.dtype))
    return {"p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
            "max": float(g.max()), "mean": float(g.mean()),
            "over": {str(m): float((g > m).double().mean()) for m in MARGINS}}


def main(argv=None, *, device=None, overrides=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--dump", default="",
                    help="directory for each seed's per-token readings (.pt)")
    args = ap.parse_args(argv)

    import torch
    from perfbench import cells, verdict, weights as W
    from repro_torch.models import get_config
    import dataclasses

    # a workload not yet in BENCHMARK.json is read as <config>.<traffic>
    config, traffic = args.workload.split(".", 1)
    c = cells.config(config)
    spec = cells.traffic(traffic)
    if overrides:
        c.update(overrides.get("config", {}))
        spec.update(overrides.get("traffic", {}))
    port_cfg = get_config(c["port_config"])
    port_cfg = dataclasses.replace(port_cfg, **{
        k: c[k] for k in cells.port_keys(c, port_cfg)})
    dev = torch.device(device or "cuda")
    dtype = getattr(torch, c["dtype"])
    D = cells.driver(spec["kind"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        params = W.make(c, seed, dev, dtype)
        out = {"workload": args.workload, "seed": seed}
        rec = D.run(c, port_cfg, spec, params, seed, args.seconds, False,
                    dev, t0, log)
        out["metrics"] = {k: v for k, v in D.end_to_end(rec, log).items()
                          if not k.startswith("_")}
        rec.pop("engine", None)
        rec.pop("state", None)
        del params
        gc.collect()
        if spec["kind"] == "serve":
            rids = D.check_sample(rec, seed, spec["check_tokens"])
            got = D.reference_errors(c, W.make(c, seed, dev, dtype), rec, rids,
                                     dev, precision="fp8" if args.control else None)
            out.update(tokens=got["tokens"], program=_stats(got["errors"]),
                       gaps=_stats(got["gaps"]), altered=_stats(got["altered"]))
            if args.control:
                out["control"] = _stats(got["control"])
            if args.dump:
                os.makedirs(args.dump, exist_ok=True)
                torch.save(got, os.path.join(args.dump, f"{args.workload}.{seed}.pt"))
        else:
            def ref_run(**kw):
                return D.reference(c, spec, rec, W.make(c, seed, dev, dtype),
                                   dev, **kw)

            ref = ref_run()
            out["program"] = verdict.train_numbers(rec, ref)
            if args.control:
                out["control"] = verdict.train_numbers(ref_run(precision="fp8"), ref)
                out["half_batch"] = verdict.train_numbers(
                    ref_run(rows=spec["batch"] // 2), ref)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
