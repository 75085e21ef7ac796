"""SystemVerilog emission from the structural RTL netlist.

``emit`` prints a :class:`rtl.Netlist` as one top-level module per
component plus the parameterized primitive modules it instantiates.  The
output is the contract the paper's toolchain ends on ("targets
synthesizable SystemVerilog"): the netlist level — controllers, muxes,
banks, handshakes — is structurally synthesizable, while the FP
primitive *cores* compute through simulation-only ``real`` arithmetic
(``$bitstoreal``/``$realtobits``/``$exp``) behind synthesizable pipeline
registers; synthesis requires dropping in HardFloat cores at the marked
point, exactly as the paper integrates them.  Everything obeys a strict
structural discipline enforced by :func:`lint` (and by the golden
tests):

* **deterministic** — byte-identical across runs for the same netlist
  (no timestamps, no id()s, insertion-order iteration only);
* **no behavioral shortcuts** — no ``#delay``, no ``initial`` blocks
  outside the memory-bank primitive's zero-init, no multi-ported
  arrays: every memory is a single-ported ``repro_mem_bank`` whose one
  port is arbitrated by a single ``always_comb`` per bank;
* **single-driver nets** — every signal is driven by exactly one
  ``assign``, one ``always`` block, or one instance output.

Structure of the emitted top module:

* a **go/done handshake** — the root FSM leaves idle when ``go`` rises
  and holds ``done`` until ``go`` falls;
* a **host port** — while idle, a word-wide host bus is muxed onto the
  memory banks so the harness can stage inputs/parameters and read
  results back (the staging ``rtl_sim.load``/``unload`` model);
* one ``always_ff`` **controller per FSM** (the root plus one child per
  ``par`` conflict component) with explicit state localparams, a shared
  down-counter, loop index counters, and condition branches;
* per-group **datapath blocks**: constant wires (IEEE-754 bit
  patterns), pipelined primitive instances with per-operand steering
  muxes (the ``rtl.OperandMux`` hardware of shared pool cells),
  synchronous read-capture registers, and write-port scheduling off the
  controller's cycle counter.

The floating-point primitive cores compute through SystemVerilog
``real`` arithmetic behind a pipeline of ``LATENCY`` register stages
mirroring ``float_lib`` exactly — bit-faithful to the f64 datapath the
simulators execute, but not themselves synthesizable; swapping the
cores for HardFloat (as the paper integrates) changes only the
primitive bodies, not the netlist or the controllers.

Pipelined loops (``FsmState.kind == "pipe"``, produced by
``core.pipelining``) emit a single controller state with a modulo-II
launch counter: the loop index increments every II cycles and every
datapath event guard matches ``(elapsed - offset) % II == 0`` within the
event's live window, with loop-index references in address expressions
rewound by ``offset // II`` stages (the index has advanced while the
access's iteration is still in flight).  Like the FP cores, the
*cross-stage value forwarding registers* a fully overlapped datapath
needs (per-stage copies of captured operands when II < body latency) are
part of the HardFloat-style drop-in: the emitted netlist carries the
schedule contract — launch cadence, port cadence, index rewind — that
``rtl_sim`` executes and verifies cycle-exactly.
"""
from __future__ import annotations

import math
import re
import struct
from typing import Dict, List, Optional, Tuple

from . import diagnostics
from .affine import AExpr, Cond, DivAtom, ModAtom, Var
from .rtl import (PROFILE_HOST_BANK, DpBlock, DpConst, DpMemRead,
                  DpMemWrite, DpRegRead, DpRegWrite, DpSelect, DpUnit,
                  Netlist)

DATA_W = 64


# ---------------------------------------------------------------------------
# Small emission helpers
# ---------------------------------------------------------------------------


def _f64_bits(value: float) -> str:
    """IEEE-754 bit pattern of a double as a SV literal."""
    bits = struct.unpack(">Q", struct.pack(">d", float(value)))[0]
    return f"64'h{bits:016x}"


def _sint(v: int) -> str:
    return f"-32'sd{-v}" if v < 0 else f"32'sd{v}"


def _sv_aexpr(e: AExpr, resolve) -> str:
    """Affine expression -> signed SV expression over index counters."""
    terms: List[str] = []
    for atom, co in e.coeffs.items():
        if isinstance(atom, Var):
            base = resolve(atom.name)
        elif isinstance(atom, DivAtom):
            base = f"({_sv_aexpr(atom.inner, resolve)} / {_sint(atom.c)})"
        elif isinstance(atom, ModAtom):
            base = f"({_sv_aexpr(atom.inner, resolve)} % {_sint(atom.c)})"
        else:                                 # pragma: no cover
            raise TypeError(atom)
        terms.append(base if co == 1 else f"({_sint(co)} * {base})")
    if e.const or not terms:
        terms.append(_sint(e.const))
    return "(" + " + ".join(terms) + ")"


_COND_OPS = {"le": "<=", "lt": "<", "eq": "==", "ge": ">=", "gt": ">"}


def _sv_cond(c: Cond, resolve) -> str:
    return f"({_sv_aexpr(c.expr, resolve)} {_COND_OPS[c.op]} 32'sd0)"


def _addr_width(words: int) -> int:
    return max(1, math.ceil(math.log2(max(words, 2))))


# ---------------------------------------------------------------------------
# Primitive modules
# ---------------------------------------------------------------------------

_BIN_CORE = {
    "fp_add": "ra + rb", "fp_sub": "ra - rb", "fp_mul": "ra * rb",
    "fp_div": "ra / rb",
    "fp_max": "(ra > rb) ? ra : rb", "fp_min": "(ra < rb) ? ra : rb",
}
_UN_CORE = {
    "fp_relu": "(ra > 0.0) ? ra : 0.0",
    "fp_neg": "-ra",
    "fp_exp": "$exp((ra > 700.0) ? 700.0 : ra)",
}


def _emit_fp_primitive(kind: str) -> List[str]:
    binary = kind in _BIN_CORE
    core = _BIN_CORE.get(kind) or _UN_CORE[kind]
    ports = ["  input  logic clk,",
             f"  input  logic [{DATA_W - 1}:0] a,"]
    if binary:
        ports.append(f"  input  logic [{DATA_W - 1}:0] b,")
    ports.append(f"  output logic [{DATA_W - 1}:0] y")
    out = [
        f"// {kind}: LATENCY-stage pipeline around a real-arithmetic core",
        f"// (HardFloat drop-in point: replace the core, keep the pipeline).",
        f"module repro_{kind} #(",
        "  parameter int LATENCY = 1",
        ") (",
        *ports,
        ");",
        "  real ra;",
    ]
    if binary:
        out.append("  real rb;")
    out.append(f"  logic [{DATA_W - 1}:0] pipe [0:LATENCY-1];")
    out.append("  always_comb begin")
    out.append("    ra = $bitstoreal(a);")
    if binary:
        out.append("    rb = $bitstoreal(b);")
    out.append("  end")
    out.append("  always_ff @(posedge clk) begin")
    out.append(f"    pipe[0] <= $realtobits({core});")
    out.append("    for (int i = 1; i < LATENCY; i++) begin")
    out.append("      pipe[i] <= pipe[i-1];")
    out.append("    end")
    out.append("  end")
    out.append("  assign y = pipe[LATENCY-1];")
    out.append("endmodule")
    out.append("")
    return out


def _emit_mem_bank() -> List[str]:
    return [
        "// Single-ported memory bank: one access per cycle, sync read.",
        "// The initial block below is memory init — the one behavioral",
        "// construct the lint allows (BRAM init is synthesizable).",
        "module repro_mem_bank #(",
        "  parameter int WORDS = 2,",
        "  parameter int AW = 1",
        ") (",
        "  input  logic clk,",
        "  input  logic en,",
        "  input  logic we,",
        "  input  logic [AW-1:0] addr,",
        f"  input  logic [{DATA_W - 1}:0] wdata,",
        f"  output logic [{DATA_W - 1}:0] rdata",
        ");",
        f"  logic [{DATA_W - 1}:0] store [0:WORDS-1];",
        "  initial begin",
        "    for (int i = 0; i < WORDS; i++) begin",
        f"      store[i] = {DATA_W}'d0;",
        "    end",
        "  end",
        "  always_ff @(posedge clk) begin",
        "    if (en) begin",
        "      if (we) begin",
        "        store[addr] <= wdata;",
        "      end",
        "      rdata <= store[addr];",
        "    end",
        "  end",
        "endmodule",
        "",
    ]


# ---------------------------------------------------------------------------
# Top-level emission
# ---------------------------------------------------------------------------


class _Emitter:
    def __init__(self, net: Netlist):
        self.net = net
        self.lines: List[str] = []
        # group -> owning fsm fid (for index resolution / counters)
        self.group_fid: Dict[str, int] = net.group_fids()
        # pipelined groups: group -> its `pipe` FsmState (launch cadence)
        self.pipe_of: Dict[str, object] = {}
        self.fsm_has_pipe: set = set()
        for f in net.fsms:
            for st in f.states:
                if st.kind == "pipe":
                    self.pipe_of[st.group] = st
                    self.fsm_has_pipe.add(f.fid)
        # unit -> users in grant order: (group, a_wire, b_wire)
        self.unit_users: Dict[str, List[Tuple[str, int, Optional[int]]]] = {}
        for blk in net.blocks.values():
            for op in blk.ops:
                if isinstance(op, DpUnit):
                    self.unit_users.setdefault(op.unit, []).append(
                        (blk.group, op.a, op.b))

    def w(self, line: str = "") -> None:
        self.lines.append(line)

    # -- naming ----------------------------------------------------------------
    def resolver(self, group_or_fid) -> "callable":
        fid = group_or_fid if isinstance(group_or_fid, int) \
            else self.group_fid[group_or_fid]

        def resolve(var: str) -> str:
            return self.net.resolve_index(fid, var).name
        return resolve

    def resolver_at(self, group: str, off: int) -> "callable":
        """Index resolver for a datapath event at in-body offset ``off``.

        For a pipelined group the loop index register free-runs (one
        increment per II) while iterations are still in flight, so an
        event belonging to iteration j observes the register at value
        ``j + off // II`` — references to the pipelined loop var are
        rewound by that stage count.  Other variables (and every
        non-pipelined group) resolve unchanged.
        """
        base = self.resolver(group)
        st = self.pipe_of.get(group)
        if st is None:
            return base
        var, _extent, ii, _lat = st.pipe
        rewind = off // ii
        if rewind == 0:
            return base

        def resolve(v: str) -> str:
            name = base(v)
            if v == var:
                return f"({name} - 32'sd{rewind})"
            return name
        return resolve

    def wire(self, group: str, n: int) -> str:
        return f"w_{group}_{n}"

    def state_lp(self, fid: int, idx: int) -> str:
        return f"F{fid}_S{idx}"

    def idle_lp(self, fid: int) -> str:
        return f"F{fid}_IDLE"

    def go_sig(self, fid: int) -> str:
        return "go" if self.net.fsms[fid].parent is None else f"fsm{fid}_go"

    # -- address plumbing -------------------------------------------------------
    def flat_addr(self, mem: str, idxs: List[AExpr]) -> AExpr:
        spec = self.net.mems[mem]
        addr_idxs = idxs[1:] if spec.banks else idxs
        flat = AExpr.const_(0)
        for ix, s in zip(addr_idxs, spec.row_strides()):
            flat = flat + ix * s
        return flat

    # -- sections ---------------------------------------------------------------
    def emit(self) -> str:
        net = self.net
        self.w("// Generated by repro.core.verilog — structural RTL for the")
        self.w(f"// component '{net.name}' lowered from the Calyx-like IR.")
        self.w("// Address arithmetic (const-multiply / divmod chains) is")
        self.w("// folded into index expressions; datapath FP units are")
        self.w("// pipelined primitives with float_lib latencies.")
        self.w("`default_nettype none")
        self.w()
        kinds = sorted({u.kind for u in net.units.values()
                        if u.kind in _BIN_CORE or u.kind in _UN_CORE})
        for kind in kinds:
            self.lines += _emit_fp_primitive(kind)
        self.lines += _emit_mem_bank()
        self._emit_top(kinds)
        self.w("`default_nettype wire")
        return "\n".join(self.lines) + "\n"

    def _emit_top(self, kinds: List[str]) -> None:
        net = self.net
        self.w(f"module {net.name} (")
        self.w("  input  logic clk,")
        self.w("  input  logic reset,")
        self.w("  input  logic go,")
        self.w("  output logic done,")
        self.w("  // host bus: stages tensors into the banks while idle")
        self.w("  input  logic host_we,")
        self.w("  input  logic [15:0] host_bank,")
        self.w("  input  logic [31:0] host_addr,")
        self.w(f"  input  logic [{DATA_W - 1}:0] host_wdata,")
        self.w(f"  output logic [{DATA_W - 1}:0] host_rdata")
        self.w(");")
        self._emit_state_localparams()
        self._emit_fsm_decls()
        self._emit_index_regs()
        self._emit_group_go()
        self._emit_regs_decl()
        if net.profile:
            self._emit_perf_counters()
        self._emit_units()
        self._emit_banks()
        self._emit_datapath()
        self._emit_reg_writes()
        self._emit_bank_port_mux()
        self._emit_host_rdata()
        self._emit_fsm_processes()
        self.w("endmodule")
        self.w()

    # .. controllers ............................................................
    def _emit_state_localparams(self) -> None:
        self.w()
        self.w("  // controller states (one FSM per par conflict component)")
        for f in self.net.fsms:
            parts = [f"{self.state_lp(f.fid, s.index)} = {s.index}"
                     for s in f.states]
            parts.append(f"{self.idle_lp(f.fid)} = {len(f.states)}")
            self.w(f"  localparam int {', '.join(parts)};")

    def _emit_fsm_decls(self) -> None:
        self.w()
        for f in self.net.fsms:
            self.w(f"  logic [31:0] fsm{f.fid}_state;")
            self.w(f"  logic [31:0] fsm{f.fid}_cnt;")
            if f.fid in self.fsm_has_pipe:
                self.w(f"  logic [31:0] fsm{f.fid}_pipe_cd;")
        for f in self.net.fsms:
            done_idx = next(s.index for s in f.states if s.kind == "done")
            self.w(f"  wire fsm{f.fid}_done = "
                   f"(fsm{f.fid}_state == {self.state_lp(f.fid, done_idx)});")
        # child go: asserted while the parent sits in the forking par state
        for f in self.net.fsms:
            for st in f.states:
                if st.kind == "par":
                    for cid in st.children:
                        self.w(f"  wire fsm{cid}_go = (fsm{f.fid}_state == "
                               f"{self.state_lp(f.fid, st.index)});")
        self.w("  assign done = fsm0_done;")
        self.w(f"  wire busy = (fsm0_state != {self.idle_lp(0)});")

    def _emit_index_regs(self) -> None:
        self.w()
        self.w("  // loop index counters (per controller — par arms that")
        self.w("  // reuse a source loop var own physically distinct regs)")
        for reg in self.net.index_regs.values():
            self.w(f"  logic signed [31:0] {reg.name};")

    def _emit_group_go(self) -> None:
        self.w()
        for f in self.net.fsms:
            for st in f.states:
                if st.kind in ("group", "pipe"):
                    self.w(f"  wire g_{st.group}_go = (fsm{f.fid}_state == "
                           f"{self.state_lp(f.fid, st.index)});")

    def _emit_regs_decl(self) -> None:
        if not self.net.regs:
            return
        self.w()
        self.w("  // data registers")
        for r in self.net.regs.values():
            self.w(f"  logic [{DATA_W - 1}:0] {r.name};")

    # .. perf-counter bank (profile builds) .....................................
    def _emit_perf_counters(self) -> None:
        """Synthesize the cycle-attribution counter bank (``net.profile``).

        One 64-bit counter per :class:`rtl.PerfCounter`, cleared on the
        go edge (idle -> run) and read over the existing host bus at bank
        ``PROFILE_HOST_BANK`` (see ``_emit_host_rdata``).  Every increment
        condition samples exactly the pre-edge state the netlist
        simulator's counter model (``rtl_sim._count_cycle``) evaluates,
        so hardware readings equal trace aggregates cycle-for-cycle:

        * ``total``        — ``busy && !done``;
        * ``group``        — the group's existing ``g_<g>_go`` enable;
        * ``stall_port``   — per-controller stall-weight mux over the
          serialized par-chain states, summed across controllers;
        * ``stall_pool``   — pairwise both-granted indicators over each
          shared pool's user groups (never fires when the binding
          invariant holds — the counter exists so silicon can falsify);
        * ``stall_ii``     — pipe state with launches outstanding while
          the modulo-II countdown is above one;
        * ``fsm_overhead`` — delay/cond-state residence plus par join
          reduction (par state with all child dones high).
        """
        net = self.net
        self.w()
        self.w("  // perf-counter bank (profile build): 64-bit counters,")
        self.w("  // cleared at go, read back at host_bank == "
               f"16'h{PROFILE_HOST_BANK:04x}")
        for c in net.counters:
            self.w(f"  logic [63:0] {c.name};")
        ovh_terms: List[str] = []      # control-state residence indicators
        stallw_terms: List[str] = []   # 32-bit per-controller stall weights
        iis_terms: List[str] = []      # pipe inter-launch wait indicators
        for f in net.fsms:
            def eq(st) -> str:
                return (f"(fsm{f.fid}_state == "
                        f"{self.state_lp(f.fid, st.index)})")
            delay = [eq(st) for st in f.states
                     if st.kind in ("delay", "cond")]
            if delay:
                wn = f"perf_fsm{f.fid}_ovh"
                self.w(f"  wire {wn} = {' || '.join(delay)};")
                ovh_terms.append(f"32'({wn})")
            for st in f.states:
                if st.kind == "par":
                    alldone = " && ".join(f"fsm{c}_done"
                                          for c in st.children)
                    wn = f"perf_fsm{f.fid}_join{st.index}"
                    self.w(f"  wire {wn} = {eq(st)} && {alldone};")
                    ovh_terms.append(f"32'({wn})")
                elif st.kind == "pipe" and st.pipe[2] > 1:
                    var, extent, _ii, _lat = st.pipe
                    reg = net.index_regs[(f.fid, var)]
                    wn = f"perf_fsm{f.fid}_iis{st.index}"
                    self.w(f"  wire {wn} = {eq(st)} && "
                           f"({reg.name} < 32'sd{extent - 1}) && "
                           f"(fsm{f.fid}_pipe_cd > 32'd1);")
                    iis_terms.append(f"32'({wn})")
            weighted = [st for st in f.states if st.stall_weight]
            if weighted:
                expr = "32'd0"
                for st in reversed(weighted):
                    expr = f"{eq(st)} ? 32'd{st.stall_weight} : {expr}"
                wn = f"perf_fsm{f.fid}_stallw"
                self.w(f"  wire [31:0] {wn} = {expr};")
                stallw_terms.append(wn)
        pool_terms: List[str] = []
        for unit, users in self.unit_users.items():
            groups: List[str] = []
            for g, _a, _b in users:
                if g not in groups:
                    groups.append(g)
            for i in range(len(groups)):
                for j in range(i + 1, len(groups)):
                    pool_terms.append(
                        f"32'(g_{groups[i]}_go && g_{groups[j]}_go)")
        for name, terms in (("perf_ovh_inc", ovh_terms),
                            ("perf_stallw_inc", stallw_terms),
                            ("perf_iis_inc", iis_terms),
                            ("perf_pool_inc", pool_terms)):
            if terms:
                self.w(f"  wire [31:0] {name} = {' + '.join(terms)};")
        steps = {"total": ("busy && !done", "64'd1"),
                 "stall_port": ("busy && !done" if stallw_terms else None,
                                "64'(perf_stallw_inc)"),
                 "stall_pool": ("busy && !done" if pool_terms else None,
                                "64'(perf_pool_inc)"),
                 "stall_ii": ("busy && !done" if iis_terms else None,
                              "64'(perf_iis_inc)"),
                 "fsm_overhead": ("busy && !done" if ovh_terms else None,
                                  "64'(perf_ovh_inc)")}
        clear = f"(fsm0_state == {self.idle_lp(0)}) && go"
        for c in net.counters:
            if c.kind == "group":
                cond, step = f"g_{c.group}_go", "64'd1"
            else:
                cond, step = steps[c.kind]
            self.w("  always_ff @(posedge clk) begin")
            self.w("    if (reset) begin")
            self.w(f"      {c.name} <= 64'd0;")
            self.w("    end")
            self.w(f"    else if ({clear}) begin")
            self.w(f"      {c.name} <= 64'd0;")
            self.w("    end")
            if cond is not None:
                self.w(f"    else if ({cond}) begin")
                self.w(f"      {c.name} <= {c.name} + {step};")
                self.w("    end")
            self.w("  end")

    # .. datapath units .........................................................
    def _emit_units(self) -> None:
        net = self.net
        fp_units = [u for u in net.units.values()
                    if u.kind in _BIN_CORE or u.kind in _UN_CORE]
        if not fp_units:
            return
        self.w()
        self.w("  // datapath units (shared pool cells carry operand muxes)")
        for u in fp_units:
            users = self.unit_users.get(u.name, [])
            binary = u.kind in _BIN_CORE
            self.w(f"  logic [{DATA_W - 1}:0] {u.name}_a;")
            if binary:
                self.w(f"  logic [{DATA_W - 1}:0] {u.name}_b;")
            self.w(f"  logic [{DATA_W - 1}:0] {u.name}_y;")
            conns = [f".clk(clk)", f".a({u.name}_a)"]
            if binary:
                conns.append(f".b({u.name}_b)")
            conns.append(f".y({u.name}_y)")
            self.w(f"  repro_{u.kind} #(.LATENCY({max(1, u.latency)})) "
                   f"u_{u.name} ({', '.join(conns)});")
            if not users:
                self.w(f"  always_comb begin")
                self.w(f"    {u.name}_a = {DATA_W}'d0;")
                if binary:
                    self.w(f"    {u.name}_b = {DATA_W}'d0;")
                self.w("  end")
                continue
            # operand steering: priority mux over the granted groups
            self.w("  always_comb begin")
            self.w(f"    {u.name}_a = {DATA_W}'d0;")
            if binary:
                self.w(f"    {u.name}_b = {DATA_W}'d0;")
            kw = "if"
            for group, aw, bw in users:
                self.w(f"    {kw} (g_{group}_go) begin")
                self.w(f"      {u.name}_a = {self.wire(group, aw)};")
                if binary and bw is not None:
                    self.w(f"      {u.name}_b = {self.wire(group, bw)};")
                self.w("    end")
                kw = "else if"
            self.w("  end")

    # .. memory banks ...........................................................
    def _emit_banks(self) -> None:
        self.w()
        self.w("  // single-ported memory banks")
        for bank in self.net.banks.values():
            aw = _addr_width(bank.words)
            for sig, width in (("en", None), ("we", None),
                               ("addr", aw), ("wdata", DATA_W),
                               ("rdata", DATA_W)):
                decl = "logic" if width is None else f"logic [{width - 1}:0]"
                self.w(f"  {decl} {bank.name}_{sig};")
            self.w(f"  repro_mem_bank #(.WORDS({bank.words}), .AW({aw})) "
                   f"u_{bank.name} (.clk(clk), .en({bank.name}_en), "
                   f".we({bank.name}_we), .addr({bank.name}_addr), "
                   f".wdata({bank.name}_wdata), .rdata({bank.name}_rdata));")

    # .. per-group datapath ......................................................
    def _cnt_cond(self, group: str, off: int) -> str:
        """Counter match for the cycle `off` of the group's window.

        Plain groups match one counter value.  Pipelined groups (enabled
        from a ``pipe`` state) fire the event once per launched
        iteration: every II cycles inside the event's live window
        ``[latency - off, residence - off]`` of the down-counter.
        """
        fid = self.group_fid[group]
        blk = self.net.blocks[group]
        off = min(off, blk.latency - 1)
        st = self.pipe_of.get(group)
        if st is None:
            k = max(1, blk.latency - off)
            return f"g_{group}_go && (fsm{fid}_cnt == 32'd{k})"
        _var, _extent, ii, lat = st.pipe
        hi = st.cycles - off              # iteration 0's event
        lo = max(1, lat - off)            # iteration extent-1's event
        return (f"g_{group}_go && (fsm{fid}_cnt <= 32'd{hi})"
                f" && (fsm{fid}_cnt >= 32'd{lo})"
                f" && (((32'd{hi} - fsm{fid}_cnt) % 32'd{ii}) == 32'd0)")

    def _rdata_mux(self, mem: str, idxs: List[AExpr], resolve) -> str:
        spec = self.net.mems[mem]
        if not spec.banks:
            return f"{spec.bank_names[0]}_rdata"
        bank_e = idxs[0]
        if bank_e.is_const():
            return f"{spec.bank_names[bank_e.const_value()]}_rdata"
        sel = _sv_aexpr(bank_e, resolve)
        expr = f"{spec.bank_names[-1]}_rdata"
        for b in range(len(spec.bank_names) - 2, -1, -1):
            expr = (f"(({sel} == {_sint(b)}) ? "
                    f"{spec.bank_names[b]}_rdata : {expr})")
        return expr

    def _emit_datapath(self) -> None:
        self.w()
        self.w("  // group datapath blocks (SSA wires per activation)")
        for blk in self.net.blocks.values():
            resolve = self.resolver(blk.group)
            for op in blk.ops:
                if isinstance(op, DpConst):
                    self.w(f"  wire [{DATA_W - 1}:0] "
                           f"{self.wire(blk.group, op.dst)} = "
                           f"{_f64_bits(op.value)};  // {op.value!r}")
                elif isinstance(op, DpRegRead):
                    self.w(f"  wire [{DATA_W - 1}:0] "
                           f"{self.wire(blk.group, op.dst)} = "
                           f"reg_{op.reg};")
                elif isinstance(op, DpMemRead):
                    # the bank is a sync-read RAM: the address goes out at
                    # in-group cycle `off` (counter == latency - off) and
                    # rdata holds the word one cycle later — capture then,
                    # not at the address edge (which would latch the
                    # previous read).  A read completing at the group's
                    # last cycle has no later edge inside the window, so
                    # it aliases rdata combinationally instead.  Pipelined
                    # groups re-capture once per launched iteration (the
                    # modulo-II guard in _cnt_cond).
                    wn = self.wire(blk.group, op.dst)
                    k = blk.latency - op.off - 1
                    if k >= 1:
                        # the select is evaluated at the *capture* cycle
                        # (off+1), when a pipelined loop's free-running
                        # index has possibly advanced a stage past the
                        # address cycle — rewind for off+1, not off
                        at = self.resolver_at(blk.group, op.off + 1)
                        rdata = self._rdata_mux(op.mem, op.idxs, at)
                        capture = self._cnt_cond(blk.group, op.off + 1)
                        self.w(f"  logic [{DATA_W - 1}:0] {wn};")
                        self.w(f"  always_ff @(posedge clk) begin")
                        self.w(f"    if ({capture}) begin")
                        self.w(f"      {wn} <= {rdata};")
                        self.w("    end")
                        self.w("  end")
                    else:
                        at = self.resolver_at(blk.group, op.off)
                        rdata = self._rdata_mux(op.mem, op.idxs, at)
                        self.w(f"  wire [{DATA_W - 1}:0] {wn} = {rdata};")
                elif isinstance(op, DpUnit):
                    self.w(f"  wire [{DATA_W - 1}:0] "
                           f"{self.wire(blk.group, op.dst)} = "
                           f"{op.unit}_y;")
                elif isinstance(op, DpSelect):
                    at = self.resolver_at(blk.group, op.off)
                    self.w(f"  wire [{DATA_W - 1}:0] "
                           f"{self.wire(blk.group, op.dst)} = "
                           f"{_sv_cond(op.cond, at)} ? "
                           f"{self.wire(blk.group, op.a)} : "
                           f"{self.wire(blk.group, op.b)};")
                # reg/mem writes are emitted by the dedicated muxes below

    def _emit_reg_writes(self) -> None:
        # collect writers per register, in block order
        writers: Dict[str, List[Tuple[str, int, int]]] = {}
        for blk in self.net.blocks.values():
            for op in blk.ops:
                if isinstance(op, DpRegWrite):
                    writers.setdefault(op.reg, []).append(
                        (blk.group, op.src, op.off))
        if not writers:
            return
        self.w()
        self.w("  // register write-back (one driver block per register;")
        self.w("  // each write latches at its scheduled in-group offset)")
        for reg, uses in writers.items():
            self.w("  always_ff @(posedge clk) begin")
            kw = "if"
            # reversed: when clamping lands two same-group writes on one
            # cycle, the priority chain resolves to the later micro-op
            for group, src, off in reversed(uses):
                self.w(f"    {kw} ({self._cnt_cond(group, off)}) begin")
                self.w(f"      reg_{reg} <= {self.wire(group, src)};")
                self.w("    end")
                kw = "else if"
            self.w("  end")

    def _emit_bank_port_mux(self) -> None:
        net = self.net
        # bank -> ordered accesses: (guard, we, addr expr, wdata or None)
        accesses: Dict[str, List[Tuple[str, bool, str, Optional[str]]]] = \
            {bn: [] for bn in net.banks}
        for blk in net.blocks.values():
            for op in blk.ops:
                if not isinstance(op, (DpMemRead, DpMemWrite)):
                    continue
                resolve = self.resolver_at(blk.group, op.off)
                spec = net.mems[op.mem]
                flat = _sv_aexpr(self.flat_addr(op.mem, op.idxs), resolve)
                base_guard = f"({self._cnt_cond(blk.group, op.off)})"
                is_store = isinstance(op, DpMemWrite)
                wdata = self.wire(blk.group, op.src) if is_store else None
                if not spec.banks:
                    targets = [(spec.bank_names[0], base_guard)]
                elif op.idxs[0].is_const():
                    bn = spec.bank_names[op.idxs[0].const_value()]
                    targets = [(bn, base_guard)]
                else:
                    sel = _sv_aexpr(op.idxs[0], resolve)
                    targets = [
                        (bn, f"{base_guard} && ({sel} == {_sint(b)})")
                        for b, bn in enumerate(spec.bank_names)]
                for bn, guard in targets:
                    accesses[bn].append((guard, is_store, flat, wdata))
        self.w()
        self.w("  // bank port arbitration: host while idle, then the one")
        self.w("  // scheduled access per cycle (port discipline)")
        flat_banks = list(net.banks.values())
        for k, bank in enumerate(flat_banks):
            aw = _addr_width(bank.words)
            self.w("  always_comb begin")
            self.w(f"    {bank.name}_en = 1'b0;")
            self.w(f"    {bank.name}_we = 1'b0;")
            self.w(f"    {bank.name}_addr = {aw}'d0;")
            self.w(f"    {bank.name}_wdata = {DATA_W}'d0;")
            self.w(f"    if (!busy && (host_bank == 16'd{k})) begin")
            self.w(f"      {bank.name}_en = 1'b1;")
            self.w(f"      {bank.name}_we = host_we;")
            self.w(f"      {bank.name}_addr = host_addr[{aw - 1}:0];")
            self.w(f"      {bank.name}_wdata = host_wdata;")
            self.w("    end")
            for guard, is_store, addr, wdata in accesses[bank.name]:
                self.w(f"    else if ({guard}) begin")
                self.w(f"      {bank.name}_en = 1'b1;")
                if is_store:
                    self.w(f"      {bank.name}_we = 1'b1;")
                    self.w(f"      {bank.name}_wdata = {wdata};")
                self.w(f"      {bank.name}_addr = {aw}'({addr});")
                self.w("    end")
            self.w("  end")

    def _emit_host_rdata(self) -> None:
        self.w()
        self.w("  always_comb begin")
        self.w(f"    host_rdata = {DATA_W}'d0;")
        kw = "if"
        if self.net.profile:
            # the perf-counter bank answers on a reserved bank id; unlike
            # the memory banks it reads plain registers, so the host may
            # read it at any time (including while busy)
            self.w(f"    if (host_bank == 16'h{PROFILE_HOST_BANK:04x}) "
                   "begin")
            ikw = "if"
            for c in self.net.counters:
                self.w(f"      {ikw} (host_addr == 32'd{c.index}) begin")
                self.w(f"        host_rdata = {c.name};")
                self.w("      end")
                ikw = "else if"
            self.w("    end")
            kw = "else if"
        for k, bank in enumerate(self.net.banks.values()):
            self.w(f"    {kw} (host_bank == 16'd{k}) begin")
            self.w(f"      host_rdata = {bank.name}_rdata;")
            self.w("    end")
            kw = "else if"
        self.w("  end")

    # .. FSM processes ..........................................................
    def _enter(self, f, target: int, pad: str) -> List[str]:
        """Statements entering state ``target`` of fsm ``f``."""
        st = f.states[target]
        out = [f"{pad}fsm{f.fid}_state <= {self.state_lp(f.fid, target)};"]
        if st.kind == "par":
            out.append(f"{pad}fsm{f.fid}_cnt <= 32'd{st.join_cycles};")
        elif st.kind != "done":
            out.append(f"{pad}fsm{f.fid}_cnt <= 32'd{st.cycles};")
        if st.kind == "pipe":
            out.append(f"{pad}fsm{f.fid}_pipe_cd <= 32'd{st.pipe[2]};")
        if st.set_idx is not None:
            reg = self.net.index_regs[(f.fid, st.set_idx)]
            out.append(f"{pad}{reg.name} <= 32'sd0;")
        return out

    def _emit_fsm_processes(self) -> None:
        for f in self.net.fsms:
            go = self.go_sig(f.fid)
            resolve = self.resolver(f.fid)
            self.w()
            self.w(f"  // controller fsm{f.fid}"
                   + (" (root)" if f.parent is None
                      else f" (forked by fsm{f.parent})"))
            self.w("  always_ff @(posedge clk) begin")
            self.w("    if (reset) begin")
            self.w(f"      fsm{f.fid}_state <= {self.idle_lp(f.fid)};")
            self.w(f"      fsm{f.fid}_cnt <= 32'd0;")
            self.w("    end")
            self.w("    else begin")
            self.w(f"      case (fsm{f.fid}_state)")
            self.w(f"        {self.idle_lp(f.fid)}: begin")
            self.w(f"          if ({go}) begin")
            for ln in self._enter(f, f.start, "            "):
                self.w(ln)
            self.w("          end")
            self.w("        end")
            for st in f.states:
                lp = self.state_lp(f.fid, st.index)
                if st.kind == "done":
                    self.w(f"        {lp}: begin")
                    self.w(f"          if (!{go}) begin")
                    self.w(f"            fsm{f.fid}_state <= "
                           f"{self.idle_lp(f.fid)};")
                    self.w("          end")
                    self.w("        end")
                    continue
                if st.kind == "pipe":
                    # pipelined loop: the down-counter spans the whole
                    # residence; a modulo-II launch counter advances the
                    # (free-running) loop index once per initiation
                    # interval — datapath guards rewind it per stage
                    var, _extent, ii, _lat = st.pipe
                    reg = self.net.index_regs[(f.fid, var)]
                    self.w(f"        {lp}: begin")
                    self.w(f"          if (fsm{f.fid}_cnt <= 32'd1) begin")
                    for ln in self._enter(f, st.next, "            "):
                        self.w(ln)
                    self.w("          end")
                    self.w("          else begin")
                    self.w(f"            fsm{f.fid}_cnt <= "
                           f"fsm{f.fid}_cnt - 32'd1;")
                    self.w(f"            if (fsm{f.fid}_pipe_cd <= 32'd1) "
                           f"begin")
                    self.w(f"              {reg.name} <= "
                           f"{reg.name} + 32'sd1;")
                    self.w(f"              fsm{f.fid}_pipe_cd <= 32'd{ii};")
                    self.w("            end")
                    self.w("            else begin")
                    self.w(f"              fsm{f.fid}_pipe_cd <= "
                           f"fsm{f.fid}_pipe_cd - 32'd1;")
                    self.w("            end")
                    self.w("          end")
                    self.w("        end")
                    continue
                self.w(f"        {lp}: begin")
                if st.kind == "par":
                    alldone = " && ".join(f"fsm{c}_done" for c in st.children)
                    self.w(f"          if ({alldone}) begin")
                    self.w(f"            if (fsm{f.fid}_cnt <= 32'd1) begin")
                    for ln in self._enter(f, st.next, "              "):
                        self.w(ln)
                    self.w("            end")
                    self.w("            else begin")
                    self.w(f"              fsm{f.fid}_cnt <= "
                           f"fsm{f.fid}_cnt - 32'd1;")
                    self.w("            end")
                    self.w("          end")
                    self.w("        end")
                    continue
                self.w(f"          if (fsm{f.fid}_cnt <= 32'd1) begin")
                pad = "            "
                if st.inc_idx is not None:
                    reg = self.net.index_regs[(f.fid, st.inc_idx)]
                    self.w(f"{pad}{reg.name} <= {reg.name} + 32'sd1;")
                if st.kind == "cond":
                    self.w(f"{pad}if ({_sv_cond(st.cond, resolve)}) begin")
                    for ln in self._enter(f, st.then_state, pad + "  "):
                        self.w(ln)
                    self.w(f"{pad}end")
                    self.w(f"{pad}else begin")
                    for ln in self._enter(f, st.else_state, pad + "  "):
                        self.w(ln)
                    self.w(f"{pad}end")
                elif st.loop is not None:
                    var, extent, head = st.loop
                    reg = self.net.index_regs[(f.fid, var)]
                    self.w(f"{pad}if ({reg.name} + 32'sd1 < "
                           f"32'sd{extent}) begin")
                    for ln in self._enter(f, head, pad + "  "):
                        self.w(ln)
                    self.w(f"{pad}end")
                    self.w(f"{pad}else begin")
                    for ln in self._enter(f, st.next, pad + "  "):
                        self.w(ln)
                    self.w(f"{pad}end")
                else:
                    for ln in self._enter(f, st.next, pad):
                        self.w(ln)
                self.w("          end")
                self.w("          else begin")
                self.w(f"            fsm{f.fid}_cnt <= "
                       f"fsm{f.fid}_cnt - 32'd1;")
                self.w("          end")
                self.w("        end")
            self.w("        default: begin")
            self.w(f"          fsm{f.fid}_state <= {self.idle_lp(f.fid)};")
            self.w("        end")
            self.w("      endcase")
            self.w("    end")
            self.w("  end")


def emit(net: Netlist) -> str:
    """Emit the netlist as deterministic, synthesizable SystemVerilog."""
    return _Emitter(net).emit()


# ---------------------------------------------------------------------------
# Structural lint — the no-behavioral-shortcuts contract, enforced
# ---------------------------------------------------------------------------

_DELAY_RE = re.compile(r"#\s*\d")
_MODULE_RE = re.compile(r"^\s*module\s+(\w+)")
_ASSIGN_RE = re.compile(r"^\s*assign\s+(\w+)")
_WIRE_ASSIGN_RE = re.compile(r"^\s*wire\s+(?:\[[^\]]*\]\s*)?(\w+)\s*=")
_LHS_RE = re.compile(r"^\s*(\w+)(?:\[[^\]]*\])?\s*(<=|=)\s")
_KEYWORDS = frozenset({
    "if", "else", "case", "endcase", "begin", "end", "for", "always_ff",
    "always_comb", "module", "endmodule", "input", "output", "inout",
    "logic", "wire", "real", "localparam", "parameter", "assign",
    "initial", "default", "int", "typedef",
})

MEM_INIT_MODULE = "repro_mem_bank"


def lint_diagnostics(text: str) -> List["diagnostics.Diagnostic"]:
    """Check the emitted SystemVerilog for behavioral constructs.

    Returns structured :class:`~.diagnostics.Diagnostic` findings (empty =
    clean) with the verifier's stable codes:

    * ``RV040`` — ``#<n>`` delay controls anywhere;
    * ``RV041`` — ``initial`` blocks outside the memory-bank primitive
      (memory init is the one allowed use);
    * ``RV042`` — multi-driver nets: a signal assigned from more than one
      ``assign`` / ``always`` block within a module.

    :func:`lint` is the original plain-string face of the same checks.
    """
    errors: List[diagnostics.Diagnostic] = []

    def err(code: str, message: str, *prov: str) -> None:
        errors.append(diagnostics.diag(code, message, stage="verilog-lint",
                                       provenance=prov))
    module = ""
    always_depth = 0           # begin/end nesting inside an always block
    in_always = False
    in_initial = False         # memory init writes are not drivers
    block_id = 0
    drivers: Dict[Tuple[str, str], set] = {}

    def note(sig: str, driver: str) -> None:
        drivers.setdefault((module, sig), set()).add(driver)

    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.split("//", 1)[0]
        if not line.strip():
            continue
        m = _MODULE_RE.match(line)
        if m:
            module = m.group(1)
            in_always = False
            always_depth = 0
        if _DELAY_RE.search(line):
            err("RV040", f"line {ln}: delay control in {module}: "
                f"{raw.strip()}", f"module:{module}", f"line:{ln}")
        if re.search(r"\binitial\b", line) and module != MEM_INIT_MODULE:
            err("RV041", f"line {ln}: initial block outside memory init "
                f"({module}): {raw.strip()}", f"module:{module}",
                f"line:{ln}")
        stripped = line.strip()
        if stripped.startswith(("always_ff", "always_comb", "initial")):
            in_always = True
            in_initial = stripped.startswith("initial")
            always_depth = 0
            block_id += 1
        if in_always:
            always_depth += len(re.findall(r"\bbegin\b", line))
            always_depth -= len(re.findall(r"\bend\b", line))
            lm = _LHS_RE.match(line)
            if lm and lm.group(1) not in _KEYWORDS and not in_initial:
                note(lm.group(1), f"always#{block_id}")
            if always_depth <= 0 and re.search(r"\bend\b", line):
                in_always = False
                in_initial = False
            continue
        am = _ASSIGN_RE.match(line)
        if am:
            note(am.group(1), f"assign@{ln}")
            continue
        wm = _WIRE_ASSIGN_RE.match(line)
        if wm:
            note(wm.group(1), f"wire@{ln}")
    for (mod, sig), drvs in drivers.items():
        if len(drvs) > 1:
            err("RV042", f"multi-driver net {sig} in {mod}: "
                f"{sorted(drvs)}", f"module:{mod}", f"net:{sig}")
    return errors


def lint(text: str) -> List[str]:
    """Plain-string shim over :func:`lint_diagnostics` (kept for existing
    callers/tests): one message per finding, empty = clean."""
    return [d.message for d in lint_diagnostics(text)]
