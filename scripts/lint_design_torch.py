"""Compile one design and run the stage-boundary verifier — lint mode — with
the PyTorch port's compiler.

The twin of ``scripts/lint_design.py`` (it imports nothing of ``repro``
and no ``jax``): the same models, flags, output and exit codes, through
``repro_torch.core``.  The design is compiled through the full flow (lower
-> chaining -> pipelining -> sharing -> RTL netlist) with the verifier at
every stage boundary, and the diagnostic table printed.  Exit status is
nonzero iff any error-severity finding fired — warnings print but pass:

    PYTHONPATH=src python scripts/lint_design_torch.py --model ffnn --factor 2
    PYTHONPATH=src python scripts/lint_design_torch.py --model attention \
        --factor 4 --opt-level 2 --no-share
    PYTHONPATH=src python scripts/lint_design_torch.py --model ffnn \
        --factor 4 --profile   # + traced profiling run with counter cross-check

``--profile`` additionally verifies the profiled netlist (the RV05x
counter-bank checks), runs both simulators with tracing on a fixed random
input, and fails if any level of the observability differential (stats,
trace aggregates, hardware counter bank, analytic attribution) disagrees.
It compiles and simulates on the host and takes no device.

Models: the four benchmark microdesigns (matmul, conv2d, ffnn, attention)
plus the paper's cnn and mha.  A compile whose boundary check raises
``VerificationError`` still prints the offending stage's table before
exiting 1; any other compile error (``--model mha --factor 4`` raises
``BankConflictError``) exits 1 with its traceback, as the reference does.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core import diagnostics, frontend, pipeline

MODELS = {
    "matmul": (lambda: frontend.Linear(8, 8, bias=False), (4, 8)),
    "conv2d": (lambda: frontend.Conv2d(2, 2, 3, 3), (2, 6, 6)),
    "ffnn": (frontend.paper_ffnn, (1, 64)),
    "attention": (lambda: frontend.MultiheadAttention(8, 2), (4, 8)),
    "cnn": (frontend.paper_cnn, (3, 80, 60)),
    "mha": (frontend.paper_mha, (8, 42)),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=list(MODELS), default="ffnn")
    ap.add_argument("--factor", type=int, default=2, choices=(1, 2, 4))
    ap.add_argument("--opt-level", type=int, default=2, choices=(0, 1, 2))
    ap.add_argument("--no-share", action="store_true")
    ap.add_argument("--mode", choices=("layout", "branchy"),
                    default="layout")
    ap.add_argument("--profile", action="store_true",
                    help="also verify the profiled netlist (RV05x) and "
                         "run the traced counter cross-check")
    args = ap.parse_args()

    builder, shape = MODELS[args.model]
    print(f"lint {args.model} factor={args.factor} "
          f"opt_level={args.opt_level} share={not args.no_share} "
          f"mode={args.mode}")
    try:
        d = pipeline.compile_model(builder(), [shape], factor=args.factor,
                                   mode=args.mode,
                                   check_hazards=args.mode == "layout",
                                   share=not args.no_share,
                                   opt_level=args.opt_level)
        d.to_rtl()
        if args.profile:
            d.to_rtl(profile=True)   # RV05x counter-bank checks
        reports = d.verify_reports
    except diagnostics.VerificationError as exc:
        print(diagnostics.render_table([exc.report]))
        print(f"\nFAIL: {len(exc.report.errors())} error(s) at "
              f"{exc.report.stage}")
        return 1
    print(diagnostics.render_table(reports))
    if args.profile:
        import numpy as np
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        prof = d.profile({"arg0": x})
        if prof.mismatches:
            for m in prof.mismatches:
                print(f"  counter mismatch: {m}")
            print(f"\nFAIL: {len(prof.mismatches)} observability "
                  f"mismatch(es)")
            return 1
        print(f"profile: {prof.cycles} cycles, counters agree across "
              f"sim / rtl_sim / traces / hardware bank")
    errors = sum(len(r.errors()) for r in reports)
    warnings = sum(len(r.warnings()) for r in reports)
    if errors:
        print(f"\nFAIL: {errors} error(s), {warnings} warning(s)")
        return 1
    verdict = "clean" if not warnings else f"{warnings} warning(s)"
    print(f"\nOK: {len(reports)} stage(s) checked, {verdict}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
