"""Run the stage-boundary verifier over the full benchmark matrix, with the
PyTorch port's compiler.

The twin of ``scripts/verify_matrix.py`` (it imports nothing of ``repro``
and no ``jax``): every point of the 4-design x factor {1,2,4} x share
{on,off} x opt_level {0,2} matrix of ``benchmarks/calyx_bench_torch.py``
is compiled with ``repro_torch.core`` with verification on and lowered to
the RTL netlist, and every boundary report must come back empty — zero
errors *and* zero warnings.  No simulation and no oracle run, so it runs
on the host and takes no device.  Its output is the reference's, line for
line, the final wall time aside.

    PYTHONPATH=src python scripts/verify_matrix_torch.py
    PYTHONPATH=src python scripts/verify_matrix_torch.py --designs matmul,ffnn

Exit status is nonzero if any point fails to compile or any finding
fires anywhere in the matrix.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import warnings

from repro_torch.core import diagnostics, estimator, pipeline

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from benchmarks.calyx_bench_torch import DESIGNS, FACTORS, OPT_LEVELS  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--designs", default=None,
                    help="comma-separated subset (default: all four)")
    args = ap.parse_args()
    selected = ([n.strip() for n in args.designs.split(",") if n.strip()]
                if args.designs else list(DESIGNS))

    bad = []
    points = 0
    stages = 0
    t0 = time.perf_counter()
    for name in selected:
        builder, shape = DESIGNS[name]
        for factor in FACTORS:
            for share in (True, False):
                for opt in OPT_LEVELS:
                    points += 1
                    label = (f"{name} f{factor} "
                             f"{'shared' if share else 'unshared'} o{opt}")
                    try:
                        with warnings.catch_warnings():
                            warnings.simplefilter(
                                "ignore",
                                estimator.BankingEfficiencyWarning)
                            d = pipeline.compile_model(
                                builder(), [shape], factor=factor,
                                share=share, opt_level=opt)
                            d.to_rtl()
                    except diagnostics.VerificationError as exc:
                        bad.append((label, exc.report))
                        print(f"  {label}: VERIFY FAILED at "
                              f"{exc.report.stage}")
                        continue
                    except Exception as exc:
                        bad.append((label, None))
                        print(f"  {label}: compile failed — "
                              f"{type(exc).__name__}: {exc}")
                        continue
                    stages += len(d.verify_reports)
                    findings = [x for r in d.verify_reports for x in r]
                    if findings:
                        bad.append((label, None))
                        print(f"  {label}: {len(findings)} finding(s)")
                        print(diagnostics.render_table(d.verify_reports))
                    else:
                        print(f"  {label}: clean "
                              f"({len(d.verify_reports)} stages)")
    wall = time.perf_counter() - t0
    if bad:
        print(f"\nFAIL: {len(bad)}/{points} matrix point(s) dirty")
        for label, report in bad:
            if report is not None:
                print(diagnostics.render_table([report]))
        return 1
    print(f"\nOK: {points} points x verify, {stages} stage reports, "
          f"all clean ({wall:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
