"""The PyTorch port's twin of ``examples/compile_to_calyx.py``: emit the
Calyx-like IR for any of the paper's models to a .futil-style text file,
through ``repro_torch.core``, with the same flags plus ``--device`` (where
the torch oracle runs: ``cuda`` unless named, raising without a card).

The compile flow (trace -> affine -> parallelize/restructure -> bank ->
Calyx lowering -> resource sharing -> estimate) is the reference's, so the
.futil text, the SystemVerilog, the estimate and both simulators' cycles
are the reference's byte for byte; only the oracle differs (torch in place
of jnp), and with it the ``max|out - oracle|`` figure, within the
reference's tolerance.

    PYTHONPATH=src python examples/compile_to_calyx_torch.py --model ffnn \
        --factor 2 --out /tmp/ffnn_f2.futil --device cpu
    PYTHONPATH=src python examples/compile_to_calyx_torch.py --model ffnn \
        --factor 2 --emit-verilog /tmp/ffnn_f2.sv --simulate-rtl

``--no-share``, ``--opt-level``, ``--simulate``, ``--simulate-rtl``,
``--verify`` / ``--no-verify``, ``--profile``, ``--trace`` and ``--vcd``
mean what they mean in the reference.  Without ``--out`` the text goes to
the temporary directory (``TMPDIR``).
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import diagnostics, frontend, pipeline, profiler, trace

MODELS = {
    "ffnn": (frontend.paper_ffnn, (1, 64)),
    "cnn": (frontend.paper_cnn, (3, 80, 60)),
    "mha": (frontend.paper_mha, (8, 42)),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=list(MODELS), default="ffnn")
    ap.add_argument("--factor", type=int, default=2, choices=(1, 2, 4))
    ap.add_argument("--mode", choices=("layout", "branchy"), default="layout")
    ap.add_argument("--opt-level", type=int, default=0, choices=(0, 1, 2),
                    help="static scheduling layer: 0=paper schedule, "
                         "1=chaining/group fusion, 2=+loop pipelining (II)")
    ap.add_argument("--no-share", action="store_true",
                    help="skip the binding pass (paper's unshared designs)")
    ap.add_argument("--simulate", action="store_true",
                    help="cycle-accurately execute the lowered component "
                         "and check measured cycles against the estimate")
    ap.add_argument("--emit-verilog", metavar="PATH", default=None,
                    help="lower to the RTL netlist and write "
                         "SystemVerilog to PATH")
    ap.add_argument("--simulate-rtl", action="store_true",
                    help="execute the RTL netlist cycle-by-cycle and check "
                         "measured cycles against the estimate")
    ap.add_argument("--verify", dest="verify", action="store_true",
                    default=True,
                    help="run the stage-boundary static verifier and print "
                         "the diagnostic table (default)")
    ap.add_argument("--no-verify", dest="verify", action="store_false",
                    help="skip stage-boundary verification")
    ap.add_argument("--profile", action="store_true",
                    help="trace both simulators, cross-check the counter "
                         "levels, and print the attribution report")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write the netlist-level event trace as JSONL")
    ap.add_argument("--vcd", metavar="PATH", default=None,
                    help="write a VCD waveform of the netlist-level trace")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the torch oracle runs (default cuda; "
                         "raises without a card unless --device cpu)")
    args = ap.parse_args(argv)

    builder, shape = MODELS[args.model]
    d = pipeline.compile_model(builder(), [shape], factor=args.factor,
                               mode=args.mode,
                               check_hazards=args.mode == "layout",
                               share=not args.no_share,
                               opt_level=args.opt_level,
                               verify=args.verify)
    text = d.calyx_text()
    out = args.out or os.path.join(
        tempfile.gettempdir(), f"{args.model}_f{args.factor}_{args.mode}.futil")
    with open(out, "w") as f:
        f.write(text)
    e = d.estimate
    print(f"model={args.model} factor={args.factor} mode={args.mode} "
          f"share={not args.no_share} opt_level={args.opt_level}")
    print(f"  cycles={e.cycles}  fmax={e.fmax_mhz}MHz  wall={e.wall_us}us")
    print(f"  resources={e.resources}  fsm_states={e.fsm_states}  "
          f"banking_efficiency={e.banking_efficiency}")
    print(f"  cells={len(d.component.cells)}  groups={len(d.component.groups)}")
    pipelined = d.component.meta.get("pipelined") or []
    if pipelined:
        loops = " ".join(f"{p['var']}[x{p['extent']} ii={p['ii']} "
                         f"body={p['body_latency']}]" for p in pipelined)
        print(f"  pipelined loops: {loops}")
    if d.sharing is not None:
        print(f"  {d.sharing.summary()}")
    print(f"  wrote {len(text.splitlines())} lines -> {out}")
    if args.simulate:
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        outs, stats = d.simulate({"arg0": x})
        oracle = d.run_oracle({"arg0": x}, device=args.device)
        err = max(float(np.max(np.abs(s - o)))
                  for s, o in zip(outs, oracle))
        verdict = ("matches estimate" if stats.cycles == e.cycles
                   else f"MISMATCH vs estimate {e.cycles}")
        print(f"  simulated cycles={stats.cycles} ({verdict}); "
              f"max|out - oracle|={err:.2e}")
        print(f"  sim: groups={stats.group_activations} uops={stats.uops} "
              f"reads={stats.mem_reads} writes={stats.mem_writes} "
              f"broadcast={stats.broadcast_reads} "
              f"serialized_arms={stats.serialized_arms} "
              f"shared_fu_grants={sum(stats.fu_grants.values())}")
    if args.emit_verilog or args.simulate_rtl:
        net = d.to_rtl()
        ns = net.stats()
        print(f"  netlist: fsms={ns['fsms']} states={ns['fsm_states']} "
              f"units={ns['units']} banks={ns['banks']} mux2={ns['mux2']}")
    if args.emit_verilog:
        text = d.emit_verilog(args.emit_verilog)
        print(f"  wrote {len(text.splitlines())} lines of SystemVerilog "
              f"-> {args.emit_verilog}")
    if args.simulate_rtl:
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        outs, rstats = d.simulate_rtl({"arg0": x})
        oracle = d.run_oracle({"arg0": x}, device=args.device)
        err = max(float(np.max(np.abs(s - o)))
                  for s, o in zip(outs, oracle))
        verdict = ("matches estimate" if rstats.cycles == e.cycles
                   else f"MISMATCH vs estimate {e.cycles}")
        print(f"  rtl cycles={rstats.cycles} ({verdict}); "
              f"max|out - oracle|={err:.2e}")
        print(f"  rtl: transitions={rstats.fsm_transitions} "
              f"groups={rstats.group_fires} reads={rstats.mem_reads} "
              f"writes={rstats.mem_writes} par_forks={rstats.par_forks}")
    if args.profile:
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        prof = d.profile({"arg0": x})
        print()
        print(prof.report())
        if prof.mismatches:
            raise SystemExit(1)
    if args.trace or args.vcd:
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        tracer = trace.Tracer()
        d.simulate_rtl({"arg0": x}, tracer=tracer)
        if args.trace:
            with open(args.trace, "w") as f:
                f.write(trace.to_jsonl(tracer.events))
            print(f"  wrote {len(tracer.events)} events -> {args.trace}")
        if args.vcd:
            text = profiler.to_vcd(tracer.events, name=d.component.name)
            with open(args.vcd, "w") as f:
                f.write(text)
            print(f"  wrote {len(text.splitlines())} VCD lines "
                  f"-> {args.vcd}")
    if args.verify:
        print()
        print(diagnostics.render_table(d.verify_reports))


if __name__ == "__main__":
    main()
