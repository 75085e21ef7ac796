"""Calyx-level perf tracking of the PyTorch port: the four-way differential
matrix, as JSON -> BENCH_calyx_torch.json.

The twin of ``benchmarks/calyx_bench.py``, over ``repro_torch.core`` (it
imports nothing of ``repro`` and no ``jax``).  The matrix is the
reference's: ``DESIGNS`` (matmul, conv2d, ffnn, attention) x ``FACTORS``
{1,2,4} x share {on,off} x ``OPT_LEVELS`` {0,2}, 48 points, one
``np.random.default_rng(0)`` draw per design in the same order.  Each point
compiles, lowers to the RTL netlist, simulates the Calyx component and the
netlist (each once with tracing off and once on, the netlist with its
counter bank), emits and lints the SystemVerilog, and records the
reference's schema-5 row with the same keys.  The compiler passes are
verbatim copies of the reference's, so every field equals
``BENCH_calyx.json``'s except the host wall clocks (``compile_us``,
``verify_us``, ``sim_wall_us``, ``trace_wall_us``) and
``oracle_max_abs_err``: the oracle is the torch one
(``CompiledDesign.run_oracle(inputs, device)``, float32 without TF32), on
the card unless ``--device cpu`` is given.  ``wall_us`` is the
estimator's cycles over fmax, not a clock, and is equal too.

The failure rules are the reference's: any estimate/measurement mismatch at
either level, any RTL-vs-Calyx output divergence (bit-exact), any oracle
error above ``ORACLE_TOL``, any Verilog lint violation, any observability
differential mismatch or any verifier finding fails the section, after the
JSON is written.  The compile window runs with the garbage collector
paused, so that ``scripts/check_perf_regression.py``'s verifier-overhead
gate (<15% of compile time over the whole matrix) reads the passes, not
the collector.

``CALYX_BENCH_DESIGNS=matmul,conv2d`` restricts the matrix;
``CALYX_BENCH_OUT`` (or ``--out``) moves the JSON.  The file's top-level
``device`` names the card (``nvidia-smi``'s name and power limit) or
``"cpu"``; without a card and without ``--device cpu`` the section raises
before it compiles anything.

    PYTHONPATH=src:. python benchmarks/calyx_bench_torch.py --device cpu
    python scripts/check_perf_regression.py --baseline BENCH_calyx.json \\
        --new BENCH_calyx_torch.json
"""
from __future__ import annotations

import gc
import json
import math
import os
import time
import warnings

import numpy as np

from benchmarks import torch_device
from repro_torch.core import estimator, frontend, pipeline, profiler, trace, \
    verilog
from repro_torch.device import resolve_device

# The reference's matrix, smallest first; scripts/verify_matrix_torch.py
# imports it.
DESIGNS = {
    "matmul": (lambda: frontend.Linear(8, 8, bias=False), (4, 8)),
    "conv2d": (lambda: frontend.Conv2d(2, 2, 3, 3), (2, 6, 6)),
    "ffnn": (frontend.paper_ffnn, (1, 64)),
    "attention": (lambda: frontend.MultiheadAttention(8, 2), (4, 8)),
}

FACTORS = (1, 2, 4)
OPT_LEVELS = (0, 2)          # the scheduling-layer ablation
ORACLE_TOL = 1e-4


def run(emit, out_path: str | None = None, device=None) -> None:
    dev = resolve_device(device)
    names = os.environ.get("CALYX_BENCH_DESIGNS", "")
    selected = [n.strip() for n in names.split(",") if n.strip()] \
        or list(DESIGNS)
    rng = np.random.default_rng(0)
    records = []
    failures = []
    # cycles by (design, factor, share) per opt level, for the geomean
    by_point: dict = {}
    for name in selected:
        builder, shape = DESIGNS[name]
        x = rng.normal(size=shape).astype(np.float32)
        for factor in FACTORS:
            for share in (True, False):
                for opt in OPT_LEVELS:
                    # keep collector pauses out of the compile/verify
                    # timing window, as the reference does
                    gc_was_on = gc.isenabled()
                    gc.collect()
                    gc.disable()
                    t0 = time.perf_counter()
                    try:
                        with warnings.catch_warnings():
                            warnings.simplefilter(
                                "ignore",
                                estimator.BankingEfficiencyWarning)
                            d = pipeline.compile_model(
                                builder(), [shape], factor=factor,
                                share=share, opt_level=opt)
                            d.to_rtl()   # lower (and verify) the netlist
                        compile_us = (time.perf_counter() - t0) * 1e6
                        # the profiled lowering below appends a sixth
                        # verify report outside the compile window
                        compile_reports = list(d.verify_reports)
                        ts = time.perf_counter()
                        outs, stats = d.simulate({"arg0": x})
                        sim_wall_us = (time.perf_counter() - ts) * 1e6
                        tr_sim = trace.Tracer()
                        ts = time.perf_counter()
                        _, stats_tr = d.simulate({"arg0": x},
                                                 tracer=tr_sim)
                        trace_wall_us = (time.perf_counter() - ts) * 1e6
                        if gc_was_on:
                            gc.enable()
                        rtl_outs, rtl_stats = d.simulate_rtl({"arg0": x})
                        tr_rtl = trace.Tracer()
                        _, rtl_tr_stats = d.simulate_rtl(
                            {"arg0": x}, tracer=tr_rtl, profile=True)
                        sv_text = d.emit_verilog()
                        sv_text_prof = d.emit_verilog(profile=True)
                    except Exception as exc:   # keep filling the matrix
                        if gc_was_on:
                            gc.enable()
                        failures.append(
                            f"{name} f{factor} share={share} o{opt}: {exc}")
                        records.append({"design": name, "banks": factor,
                                        "share": share, "opt_level": opt,
                                        "error": str(exc)})
                        emit(f"calyx_{name}_f{factor}_"
                             f"{'shared' if share else 'unshared'}_o{opt}",
                             (time.perf_counter() - t0) * 1e6,
                             f"ERROR {type(exc).__name__}")
                        continue
                    wall_us = (time.perf_counter() - t0) * 1e6
                    oracle = d.run_oracle({"arg0": x}, device=dev)
                    err = max(float(np.max(np.abs(s - o)))
                              for s, o in zip(outs, oracle))
                    rtl_bitexact = all(np.array_equal(a, b)
                                       for a, b in zip(rtl_outs, outs))
                    lint_errors = verilog.lint(sv_text)
                    prof_lint_errors = verilog.lint(sv_text_prof)
                    att = estimator.attribute(d.component)
                    mism = profiler.counter_mismatches(
                        stats_tr, rtl_tr_stats, tr_sim.events,
                        tr_rtl.events, attribution=att,
                        hw_counters=rtl_tr_stats.counters)
                    stl = profiler.stall_breakdown(tr_rtl.events)
                    occ = profiler.occupancy(tr_rtl.events,
                                             rtl_tr_stats.cycles)
                    est = d.estimate
                    netlist = d.to_rtl().stats()
                    verify_us = sum(r.wall_us for r in compile_reports)
                    verify_findings = sum(len(r) for r in d.verify_reports)
                    pipelined = d.component.meta.get("pipelined") or []
                    rec = {
                        "design": name,
                        "banks": factor,
                        "share": share,
                        "opt_level": opt,
                        "cycles": est.cycles,
                        "sim_cycles": stats.cycles,
                        "rtl_cycles": rtl_stats.cycles,
                        "cycles_match": stats.cycles == est.cycles
                                        == rtl_stats.cycles,
                        "rtl_bitexact": rtl_bitexact,
                        "oracle_max_abs_err": err,
                        "banking_efficiency": est.banking_efficiency,
                        "ii": max((p["ii"] for p in pipelined), default=0),
                        "pipelined_loops": len(pipelined),
                        "LUT": est.resources["LUT"],
                        "FF": est.resources["FF"],
                        "DSP": est.resources["DSP"],
                        "BRAM": est.resources["BRAM"],
                        "fsm_states": est.fsm_states,
                        "fmax_mhz": est.fmax_mhz,
                        "wall_us": est.wall_us,
                        "cells": len(d.component.cells),
                        "groups": len(d.component.groups),
                        "netlist": netlist,
                        "sv_modules": sum(
                            1 for ln in sv_text.splitlines()
                            if ln.startswith("module ")),
                        "sv_loc": len(sv_text.splitlines()),
                        "sv_loc_profiled": len(sv_text_prof.splitlines()),
                        "sv_lint_errors": len(lint_errors),
                        "sv_lint_errors_profiled": len(prof_lint_errors),
                        "counters_match": not mism,
                        "attribution_exact": att.exact,
                        "trace_events": len(tr_rtl.events),
                        "sim_wall_us": round(sim_wall_us, 1),
                        "trace_wall_us": round(trace_wall_us, 1),
                        "fu_grants": sum(stats.fu_grants.values()),
                        "serialized_arms": stats.serialized_arms,
                        "broadcast_reads": stats.broadcast_reads,
                        "stalls": stl,
                        "occupancy": occ,
                        "compile_us": round(compile_us, 1),
                        "verify_us": round(verify_us, 1),
                        "verify_stages": len(compile_reports),
                        "verify_findings": verify_findings,
                        "sim": stats.as_dict(),
                        "rtl_sim": rtl_stats.as_dict(),
                    }
                    records.append(rec)
                    by_point.setdefault((name, factor, share), {})[opt] = \
                        est.cycles
                    tag = "shared" if share else "unshared"
                    emit(f"calyx_{name}_f{factor}_{tag}_o{opt}", wall_us,
                         f"cycles={est.cycles}|sim={stats.cycles}"
                         f"|rtl={rtl_stats.cycles}|ii={rec['ii']}"
                         f"|err={err:.1e}")
                    point = f"{name} f{factor} share={share} o{opt}"
                    if stats.cycles != est.cycles:
                        failures.append(
                            f"{point}: simulated {stats.cycles} cycles but "
                            f"estimated {est.cycles}")
                    if rtl_stats.cycles != est.cycles:
                        failures.append(
                            f"{point}: RTL measured {rtl_stats.cycles} "
                            f"cycles but estimated {est.cycles}")
                    if not rtl_bitexact:
                        failures.append(
                            f"{point}: RTL outputs diverge bit-wise from "
                            f"the Calyx simulation")
                    if lint_errors:
                        failures.append(
                            f"{point}: emitted Verilog has "
                            f"{len(lint_errors)} lint violations (first: "
                            f"{lint_errors[0]})")
                    if prof_lint_errors:
                        failures.append(
                            f"{point}: profiled Verilog has "
                            f"{len(prof_lint_errors)} lint violations "
                            f"(first: {prof_lint_errors[0]})")
                    if mism:
                        failures.append(
                            f"{point}: observability differential mismatch "
                            f"(first: {mism[0]})")
                    if verify_findings:
                        first = next(diag for r in d.verify_reports
                                     for diag in r)
                        failures.append(
                            f"{point}: verifier reported {verify_findings} "
                            f"finding(s) (first: {first.format()})")
                    if err > ORACLE_TOL:
                        failures.append(
                            f"{point}: oracle error {err:.2e} exceeds "
                            f"{ORACLE_TOL}")
    # opt_level ablation summary: geomean 0 -> 2 speedup over the matrix
    ratios = [c[0] / c[2] for c in by_point.values()
              if 0 in c and 2 in c and c[2] > 0]
    geomean = (math.exp(sum(math.log(r) for r in ratios) / len(ratios))
               if ratios else 0.0)
    emit("calyx_opt_geomean_speedup", 0.0,
         f"{geomean:.2f}x over {len(ratios)} points (opt 0 -> 2)")
    # the JSON before the failure: its rows are the diagnostic
    out_path = out_path or os.environ.get("CALYX_BENCH_OUT",
                                          "BENCH_calyx_torch.json")
    with open(out_path, "w") as f:
        json.dump({"schema": 5,
                   "generator": "benchmarks/calyx_bench_torch.py",
                   "device": torch_device.label(dev),
                   "opt_geomean_speedup": round(geomean, 3),
                   "records": records}, f, indent=2)
        f.write("\n")
    emit("calyx_bench_json", 0.0, f"{len(records)} records -> {out_path}")
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    torch_device.main(run, __doc__, out_help="output JSON path (default "
                      "BENCH_calyx_torch.json or $CALYX_BENCH_OUT)")
