"""End-to-end compile driver: PyTorch-like module -> synthesizable RTL.

``compile_model`` mirrors the paper's full flow plus the binding stage the
paper leaves to future work:

    frontend.trace      (PyTorch -> Allo -> Linalg)
    affine.lower_graph  (Linalg -> Affine/SCF/Memref)
    schedule.parallelize + restructure   (par materialization, FSM sharing)
    banking.apply_banking                (cyclic partitioning)
    banking.check_par_hazards            (static safety analysis)
    calyx.lower_program                  (CIRCT -> Calyx)
    chaining.chain_component             (opt_level>=1: group fusion)
    pipelining.pipeline_loops            (opt_level>=2: loop pipelining, II)
    sharing.share_cells                  (resource binding; ``share=True``)
    estimator.estimate                   (Calyx -> cost report)
    rtl.lower_component                  (Calyx -> FSM+datapath netlist)
    verilog.emit                         (netlist -> SystemVerilog)

The scheduling layer (``opt_level=0/1/2``) sits between lowering and
binding: level 1 fuses seq runs and port-compatible par arms into
multi-op groups (cycle-neutral along seq; removes fork/join handshakes
and most FSM states), level 2 additionally pipelines innermost
single-group repeats with a statically computed initiation interval, so
``cycles = setup + (extent-1)*II + body`` replaces
``setup + extent*(body+overhead)``.  Designs whose par arms still
conflict-serialize get a ``BankingEfficiencyWarning`` and report
``estimate.banking_efficiency < 1``.

The sharing stage rebinds expensive functional units of mutually exclusive
groups onto shared pools; it provably cannot change ``estimate.cycles``
(group latencies, ports, and control are untouched — asserted below) and it
never merges cells across ``par`` arms, so parallel speedups survive intact.
Pass ``share=False`` to reproduce the paper's every-statement-owns-its-unit
resource numbers (Table 2).

The returned ``CompiledDesign`` executes at three levels, forming the
**four-way differential harness** against the torch oracle:

* ``run`` interprets the *banked affine program* on numpy — proving the
  transformed hardware schedule computes the same function as the oracle;
* ``simulate`` cycle-accurately executes the *lowered Calyx component*
  (``core.sim``), measuring a cycle count that must equal
  ``estimate.cycles`` exactly;
* ``simulate_rtl`` executes the *RTL netlist itself* (``core.rtl_sim``) —
  the same artifact ``emit_verilog`` prints — cycle by cycle through its
  explicit FSM controllers, again measuring ``estimate.cycles`` exactly.

RTL-simulated ≡ Calyx-simulated ≡ affine-interpreted outputs bit-for-bit,
all ≡ oracle within float tolerance, and both measured cycle counts ≡ the
closed-form estimate with zero tolerance — asserted by the differential
matrix in ``tests/test_core_rtl.py`` / ``tests/test_core_sim.py``.

Observability hook points (``core.trace`` / ``core.profiler``):

* ``simulate(inputs, tracer=Tracer())`` — canonical event trace at
  micro-op granularity (group windows, uop issues, port grants, stalls);
* ``simulate_rtl(inputs, tracer=Tracer(), profile=True)`` — the same
  schema at netlist granularity (plus ``fsm:state`` events), join-able
  event-for-event against the Calyx-level trace, with
  ``RtlStats.counters`` modeling the synthesized counter bank per cycle;
* ``to_rtl(profile=True)`` / ``emit_verilog(profile=True)`` — the
  netlist/SystemVerilog with the hardware perf-counter bank, read over
  the host bus at bank ``rtl.PROFILE_HOST_BANK``;
* ``profile(inputs)`` — runs everything above plus
  ``estimator.attribute`` and returns the joined ``profiler.Profile``
  (flame table, occupancy, stall breakdown, four-way counter check).

All hooks default off; the untraced paths allocate no event objects and
build no provenance tuples (the <2% overhead contract the perf gate
checks).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import affine, banking, calyx, chaining, estimator, frontend
from . import pipelining, schedule, sharing
from . import profiler
from . import rtl as rtl_ir
from . import rtl_sim
from . import sim as calyx_sim
from . import trace
from . import tensor_ir as T
from . import torch_backend
from . import verify as verify_mod
from . import verilog
from .diagnostics import DiagnosticReport


@dataclasses.dataclass
class CompiledDesign:
    graph: T.Graph
    program: affine.Program          # final (scheduled + banked) program
    component: calyx.Component
    estimate: estimator.Estimate
    hazards: List[str]
    spec: banking.BankingSpec
    sharing: Optional[sharing.SharingReport] = None
    opt_level: int = 0               # scheduling level the design was built at
    # stage-boundary verification (core.verify): one DiagnosticReport per
    # boundary the compile crossed; empty when the design was compiled with
    # verify=False.  to_rtl() appends the post-RTL report lazily.
    verify_reports: List[DiagnosticReport] = dataclasses.field(
        default_factory=list, repr=False, compare=False)
    verify_enabled: bool = True
    # netlist cache, keyed by the profile flag (a profiled netlist adds
    # the perf-counter bank; both variants are deterministic)
    _netlists: Dict[bool, rtl_ir.Netlist] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def _validate_inputs(self, inputs: Dict[str, np.ndarray]) -> None:
        """Check input names and shapes up front with a clear error.

        Without this, a missing or misshaped input surfaces as a deep
        ``KeyError``/``ValueError`` inside the micro-op evaluator, far
        from the call site.
        """
        expected = {op.name: tuple(op.shape) for op in self.graph.ops
                    if op.kind == "input"}
        missing = sorted(set(expected) - set(inputs))
        extra = sorted(set(inputs) - set(expected))
        if missing or extra:
            want = ", ".join(f"{n}{expected[n]}" for n in sorted(expected))
            raise ValueError(
                f"design {self.graph.name!r} takes inputs [{want}]; "
                + (f"missing {missing}" if missing else "")
                + ("; " if missing and extra else "")
                + (f"unexpected {extra}" if extra else ""))
        for name, shape in expected.items():
            got = tuple(np.asarray(inputs[name]).shape)
            if got != shape:
                raise ValueError(
                    f"input {name!r} of design {self.graph.name!r} has "
                    f"shape {got}, expected {shape}")

    def run(self, inputs: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """Execute the banked hardware schedule (numpy interpreter)."""
        self._validate_inputs(inputs)
        mems = affine.interpret(self.program, inputs, self.graph.params)
        return self._extract_outputs(mems)

    def simulate(self, inputs: Dict[str, np.ndarray],
                 tracer: Optional[trace.Tracer] = None
                 ) -> Tuple[List[np.ndarray], "calyx_sim.SimStats"]:
        """Cycle-accurately execute the lowered Calyx component.

        Runs the FSM scheduler over the component's control tree, firing
        each group's micro-ops against real memory/register state, and
        returns ``(outputs, SimStats)`` where ``SimStats.cycles`` is the
        *measured* latency (equal to ``estimate.cycles`` by construction —
        asserted by the differential tests).

        Trace hook: pass a ``trace.Tracer`` to record the canonical event
        trace (group windows, micro-op issues, port grants, stalls) at
        micro-op granularity; ``None`` (the default) keeps the simulator
        on its zero-instrumentation path.
        """
        self._validate_inputs(inputs)
        mems, stats = calyx_sim.simulate(self.component, self.program,
                                         inputs, self.graph.params,
                                         tracer=tracer)
        return self._extract_outputs(mems), stats

    # -- RTL backend ----------------------------------------------------------
    def to_rtl(self, profile: bool = False) -> rtl_ir.Netlist:
        """Lower the Calyx component to the FSM + datapath netlist
        (cached per ``profile`` flag — both variants are deterministic
        for a compiled design).  ``profile=True`` additionally
        synthesizes the hardware perf-counter bank (``rtl.PerfCounter``)
        read over the host bus.  When the design was compiled with
        ``verify=True`` the netlist is statically checked at this
        boundary too (post-RTL: multi-driven nets, combinational loops,
        FSM reachability, and — profiled — the counter address map)."""
        if profile not in self._netlists:
            net = rtl_ir.lower_component(self.component, self.program,
                                         profile=profile)
            if self.verify_enabled:
                rep = verify_mod.verify_netlist(net)
                self.verify_reports.append(rep)
                rep.raise_if_errors()
            self._netlists[profile] = net
        return self._netlists[profile]

    def emit_verilog(self, path: Optional[str] = None,
                     profile: bool = False) -> str:
        """Emit the netlist as SystemVerilog (structurally synthesizable;
        simulation-level FP cores with a HardFloat drop-in point);
        optionally write it to ``path``.  Deterministic byte-for-byte.
        ``profile=True`` includes the synthesized perf-counter bank."""
        text = verilog.emit(self.to_rtl(profile=profile))
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def simulate_rtl(self, inputs: Dict[str, np.ndarray],
                     tracer: Optional[trace.Tracer] = None,
                     profile: bool = False
                     ) -> Tuple[List[np.ndarray], "rtl_sim.RtlStats"]:
        """Execute the RTL netlist cycle-by-cycle (``core.rtl_sim``).

        This drives the *netlist* — explicit FSM controllers, physical
        memory banks, operand-muxed units — not the Calyx IR; outputs are
        bit-equal to ``simulate``/``run`` and ``RtlStats.cycles`` equals
        ``estimate.cycles`` exactly (the four-way differential contract).

        Trace hook: a ``trace.Tracer`` records the same canonical event
        schema ``simulate`` emits (plus netlist-only ``fsm:state``
        events), with provenance keys that join event-for-event against
        the Calyx-level trace.  ``profile=True`` runs the netlist that
        carries the synthesized counter bank and fills
        ``RtlStats.counters`` with the per-cycle hardware counter model.
        """
        self._validate_inputs(inputs)
        mems, stats = rtl_sim.simulate(self.to_rtl(profile=profile),
                                       inputs, self.graph.params,
                                       tracer=tracer)
        return self._extract_outputs(mems), stats

    def profile(self, inputs: Dict[str, np.ndarray]) -> "profiler.Profile":
        """Run both simulators with tracing plus the analytic attribution
        and return the joined :class:`profiler.Profile` (flame table,
        occupancy, stall breakdown, counter cross-check)."""
        return profiler.profile_design(self, inputs)

    def _extract_outputs(self, mems: Dict[str, np.ndarray]
                         ) -> List[np.ndarray]:
        outs = []
        orig_shapes = self.program.meta.get("orig_shapes", {})
        for name in self.graph.outputs:
            decl = self.program.mems[name]
            arr = mems[name]
            if decl.banks:
                arr = affine.unpack_banked(arr, orig_shapes[name], decl.banks)
            outs.append(arr.astype(np.float32))
        return outs

    def run_oracle(self, inputs: Dict[str, np.ndarray],
                   device=None) -> List[np.ndarray]:
        """Execute the traced graph with the torch oracle, on ``cuda``
        unless ``device="cpu"`` is passed."""
        return torch_backend.execute_graph(self.graph, inputs, device=device)

    def calyx_text(self) -> str:
        return calyx.emit_text(self.component)


def compile_graph(graph: T.Graph, factor: int = 1, mode: str = "layout",
                  restructure: bool = True,
                  check_hazards: bool = True,
                  share: bool = True,
                  opt_level: int = 0,
                  verify: bool = True) -> CompiledDesign:
    """Compile a tensor graph to a Calyx component + estimate.

    ``opt_level`` selects the static scheduling layer between lowering
    and binding/estimation:

    * ``0`` — the paper's schedule: one group per statement, loops pay a
      per-iteration overhead, ``par`` pays a fork/join per activation.
    * ``1`` — operation chaining / group fusion (``core.chaining``):
      seq runs and port-compatible par arms fuse into multi-op groups;
      FSM states, go/done fabric, and join handshakes collapse.
    * ``2`` — level 1 plus loop pipelining (``core.pipelining``):
      innermost single-group repeats get an initiation interval from
      memory-port, non-pipelined-unit, and loop-carried register
      constraints, and iterations overlap.

    ``verify`` (default on) runs the stage-boundary static verifier
    (``core.verify``) on every lowered artifact — post-lower,
    post-chaining, post-pipelining, post-sharing, and (lazily, in
    ``to_rtl``) post-RTL — raising
    :class:`~.diagnostics.VerificationError` on any error-severity
    finding, and strips dead groups/cells the liveness analysis proves
    unreachable (cycle-neutral).  The per-stage reports are kept on
    ``CompiledDesign.verify_reports``.

    Every level preserves the end-to-end invariant: estimator cycles ==
    Calyx-sim cycles == RTL-sim cycles exactly, and outputs bit-equal to
    the affine interpreter.
    """
    if opt_level not in (0, 1, 2):
        raise ValueError(f"opt_level must be 0, 1, or 2 (got {opt_level})")
    prog = affine.lower_graph(graph)
    if factor > 1:
        prog = schedule.parallelize(prog, factor)
        if check_hazards and mode == "layout":
            banking.check_par_hazards(prog)
        prog = schedule.restructure(prog, enable=restructure)
    spec = banking.BankingSpec(factor=factor, mode=mode)
    prog = banking.apply_banking(prog, spec)
    hazards = []
    if factor > 1:
        hazards = banking.check_par_hazards(
            prog, raise_on_conflict=(check_hazards and mode == "layout"))
    reports: List[DiagnosticReport] = []
    # one cache across all of this compile's boundaries: groups a pass
    # carries over unchanged skip re-proving their per-group checks
    vcache = verify_mod.GroupCache()

    def checkpoint(stage: str, component: calyx.Component) -> None:
        if not verify:
            return
        rep = verify_mod.verify_component(component, prog, stage=stage,
                                          cache=vcache)
        reports.append(rep)
        rep.raise_if_errors()

    comp = calyx.lower_program(prog)
    checkpoint("post-lower", comp)
    if opt_level >= 1:
        comp = chaining.chain_component(comp)
        checkpoint("post-chaining", comp)
    if opt_level >= 2:
        comp = pipelining.pipeline_loops(comp)
        checkpoint("post-pipelining", comp)
    if verify:
        # liveness-fed cleanup: provably cycle-neutral (control untouched)
        comp, _removed = verify_mod.eliminate_dead(comp, vcache)
    report = None
    pre_cycles = None
    if share:
        pre_cycles = estimator.cycles(comp)
        pre_groups = comp.groups
        comp, report = sharing.share_cells(comp)
        if verify:
            # carry clean verdicts across the rebind after re-proving,
            # uop by uop, that binding changed nothing but cell names
            bound = {orig: pool for pool, origs in report.pools.items()
                     for orig in origs}
            vcache.transfer_rebound(pre_groups, comp.groups, bound)
    checkpoint("post-sharing", comp)
    est = estimator.estimate(comp)
    if pre_cycles is not None and est.cycles != pre_cycles:
        # load-bearing invariant: survives python -O
        raise RuntimeError(
            f"resource sharing changed the schedule "
            f"({pre_cycles} -> {est.cycles} cycles) — binding must "
            f"be latency-neutral")
    if est.banking_efficiency < 1.0:
        serial = estimator.par_serializations(comp)
        detail = "; ".join(f"{n} arms -> {k} concurrent"
                           for _, n, k in serial[:4])
        warnings.warn(
            f"design {graph.name!r} (factor={factor}, mode={mode}, "
            f"opt_level={opt_level}): {len(serial)} par block(s) "
            f"conflict-serialize on memory banks ({detail}) — banking "
            f"efficiency {est.banking_efficiency}",
            estimator.BankingEfficiencyWarning, stacklevel=2)
    return CompiledDesign(graph, prog, comp, est, hazards, spec,
                          sharing=report, opt_level=opt_level,
                          verify_reports=reports, verify_enabled=verify)


def compile_model(module: frontend.Module, input_shapes,
                  factor: int = 1, mode: str = "layout",
                  restructure: bool = True, name: str = "main",
                  check_hazards: bool = True,
                  share: bool = True,
                  opt_level: int = 0,
                  verify: bool = True) -> CompiledDesign:
    graph = frontend.trace(module, input_shapes, name=name)
    return compile_graph(graph, factor=factor, mode=mode,
                         restructure=restructure, check_hazards=check_hazards,
                         share=share, opt_level=opt_level, verify=verify)
