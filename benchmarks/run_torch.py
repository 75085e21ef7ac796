"""Benchmark runner of the PyTorch port: the twins' sections.

The twin of ``benchmarks/run.py``: the same ``name,us_per_call,derived``
CSV, failure summary and exit code.  Sections, in the order they run by
default:

  serve_bench          serving load harness -> BENCH_serve_torch.json
  resilience_bench     chaos/goodput harness -> BENCH_resilience_torch.json
  kernel_bench         the Hopper kernels against their plain versions
  model_profile_bench  per-operator decode profiles -> BENCH_model_torch.json
  roofline_report      offload ranking from BENCH_model_torch.json
                       (+ the port's dry-run cells)

``--device`` (default ``cuda``) is passed to every section.  A section of
``run.py`` that has no twin yet (``paper_tables``, ``banking_ablation``,
``calyx_bench``: ``ROADMAP.md`` A.4) fails with ``ValueError``.

    PYTHONPATH=src:. python benchmarks/run_torch.py serve_bench --device cpu
"""
from __future__ import annotations

import argparse
import importlib
import time
import traceback

from benchmarks.torch_device import emit_csv

SECTIONS = ("serve_bench", "resilience_bench", "kernel_bench",
            "model_profile_bench", "roofline_report")
NOT_PORTED = ("paper_tables", "banking_ablation", "calyx_bench")


def run_section(section: str, device=None) -> None:
    if section in NOT_PORTED:
        raise ValueError(f"section {section} has no PyTorch twin yet "
                         f"(ROADMAP.md A.4)")
    if section not in SECTIONS:
        raise ValueError(f"unknown section {section}")
    mod = importlib.import_module(f"benchmarks.{section}_torch")
    mod.run(emit_csv, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sections", nargs="*", default=list(SECTIONS))
    ap.add_argument("--device", default=None,
                    help="torch device for every section (default: cuda; "
                         "raises without a card unless --device cpu)")
    args = ap.parse_args(argv)
    t0 = time.time()
    failures = []
    for section in args.sections:
        print(f"# --- {section} ---", flush=True)
        try:
            run_section(section, args.device)
        except Exception as e:
            failures.append(section)
            print(f"# section {section} FAILED: {e}", flush=True)
            traceback.print_exc()
    print(f"# total {time.time() - t0:.1f}s; failures: {failures or 'none'}")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
