"""Loop pipelining over the Calyx-like IR (opt_level 2).

The baseline schedule runs a ``repeat`` body to completion — plus a
per-iteration overhead cycle — before the next iteration starts, so a
loop costs ``setup + extent * (body + overhead)``.  Real HLS control
(HIR's explicitly-scheduled pipelined loops; Vitis' II-based pipelining)
overlaps iterations instead: a new iteration launches every *initiation
interval* (II) cycles and the loop costs

    setup + (extent - 1) * II + body_latency

This pass computes a safe II for every innermost ``repeat`` whose body is
a single group (the form the chaining pass produces) and annotates the
node (``CRepeat.ii``).  Every downstream stage models the same overlapped
schedule: the estimator prices the closed form above, the Calyx simulator
launches iteration *i* at ``setup + i*II`` and stamps its memory-port
claims at real absolute cycles (so an unsound II would be *caught*, not
mis-simulated), and the RTL backend compiles the loop into a pipelined
controller state whose launch counter fires the body every II cycles.

The II is the maximum of three constraint families, mirroring classic
modulo scheduling:

* **loop-carried register recurrences** — for a register both written
  (at stamped offset ``w``) and consumed (at offset ``c``) in the body:
  ``II >= max(W) - min(C)`` (the next iteration may not consume before
  this one produced — e.g. a reduction accumulator whose adder starts at
  cycle 4 and latches at 6 gives II = 2, the adder's depth) and
  ``II >= max(C) - min(W)`` (the next iteration may not overwrite a
  value this one still reads; there is no register renaming).

* **memory-port reservation** — each single-ported bank serves one
  access per cycle, so the body's access offsets into one bank must stay
  pairwise distinct modulo II (the classic modulo reservation table).
  Banks are resolved from constant bank indices; accesses with
  runtime-selected banks conservatively share one reservation row per
  logical memory.  Bodies that both read and write one memory are not
  pipelined at all (a loop-carried memory dependence we do not analyze).

* **non-pipelined units** — iterative units (fp_div, fp_exp,
  int_divmod) accept a new operation only every ``latency`` cycles;
  pipelined HardFloat-style add/mul accept one per cycle and impose
  nothing.

II search starts at the recurrence/unit floor and stops at the body
latency — beyond that, pipelining cannot beat the sequential schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from . import dataflow as D
from . import float_lib as F
from .calyx import (CIf, CNode, CPar, CRepeat, CSeq, Component, GEnable,
                    Group)

# Iterative (non-pipelined) unit kinds: a new op may only issue every
# `latency` cycles.  Everything else is a pipelined primitive (II=1).
NONPIPELINED_KINDS = frozenset({"fp_div", "fp_exp", "int_divmod"})


def _unit_latency(comp: Component, cell_name: str) -> int:
    cell = comp.cells.get(cell_name)
    if cell is None:
        return 0
    if cell.kind in F.FLOAT_COSTS:
        return F.FLOAT_COSTS[cell.kind].cycles
    if cell.kind == "int_divmod":
        return F.int_divmod_cost(cell.const).cycles
    return 0


def _register_floor(g: Group) -> int:
    """Loop-carried register recurrence floor for II."""
    writes: Dict[str, List[int]] = {}
    reads: Dict[int, str] = {}            # temp -> register it carries
    consumes: Dict[str, List[int]] = {}
    for u in g.uops:
        if isinstance(u, D.URegWrite):
            writes.setdefault(u.reg, []).append(u.off)
        elif isinstance(u, D.URegRead):
            reads[u.dst] = u.reg

    def consume(temp: Optional[int], off: int) -> None:
        if temp is not None and temp in reads:
            consumes.setdefault(reads[temp], []).append(off)

    for u in g.uops:
        if isinstance(u, D.UAlu):
            consume(u.a, u.off)
            consume(u.b, u.off)
        elif isinstance(u, D.USelect):
            consume(u.a, u.off)
            consume(u.b, u.off)
        elif isinstance(u, D.URegWrite):
            consume(u.src, u.off)
        elif isinstance(u, D.UMemWrite):
            consume(u.src, u.off)
    floor = 1
    for reg, w_offs in writes.items():
        c_offs = consumes.get(reg)
        if not c_offs:
            continue
        floor = max(floor,
                    max(w_offs) - min(c_offs),    # produce before next use
                    max(c_offs) - min(w_offs))    # read before overwrite
    return floor


def _unit_floor(comp: Component, g: Group) -> int:
    """Non-pipelined (iterative) units must finish before re-issue."""
    per_cell: Dict[str, int] = {}
    for u in g.uops:
        if isinstance(u, D.UAlu):
            cell = comp.cells.get(u.cell)
            if cell is not None and cell.kind in NONPIPELINED_KINDS:
                per_cell[u.cell] = per_cell.get(u.cell, 0) + 1
    floor = 1
    for cell_name, uses in per_cell.items():
        floor = max(floor, uses * _unit_latency(comp, cell_name))
    return floor


def _port_offsets(comp: Component, g: Group
                  ) -> Optional[Dict[Tuple, Set[int]]]:
    """Per-bank reservation rows: bank key -> set of busy offsets.

    Returns None when the body both reads and writes one memory — a
    potential loop-carried memory dependence this pass does not analyze,
    so the loop is left unpipelined.
    """
    factors: Dict[str, tuple] = comp.meta.get("bank_factors", {})
    rw: Dict[str, Set[bool]] = {}
    runtime_bank: Set[str] = set()
    rows: Dict[Tuple, Set[int]] = {}
    accesses: List[Tuple[str, Optional[int], int]] = []
    for u in g.uops:
        if isinstance(u, D.UMemRead):
            is_store = False
        elif isinstance(u, D.UMemWrite):
            is_store = True
        else:
            continue
        rw.setdefault(u.mem, set()).add(is_store)
        bank: Optional[int] = 0
        if factors.get(u.mem):
            bank = (u.idxs[0].const_value() if u.idxs[0].is_const()
                    else None)
        if bank is None:
            runtime_bank.add(u.mem)
        accesses.append((u.mem, bank, u.off))
    if any(len(v) > 1 for v in rw.values()):
        return None
    for mem, bank, off in accesses:
        key: Tuple = (mem,) if mem in runtime_bank else (mem, bank)
        rows.setdefault(key, set()).add(off)
    return rows


def _rows_admit(rows: Dict[Tuple, Set[int]], ii: int) -> bool:
    """True iff every reservation row's offsets stay distinct modulo ii."""
    for offs in rows.values():
        if len({o % ii for o in offs}) != len(offs):
            return False
    return True


# Public faces of the II constraint families — the stage-boundary verifier
# (core.verify) re-proves every annotated II through these same functions,
# so an unsound annotation is caught statically with the exact model the
# pass used to compute it.
register_floor = _register_floor
unit_floor = _unit_floor
port_offsets = _port_offsets
rows_admit = _rows_admit


def compute_ii(comp: Component, g: Group) -> int:
    """Smallest admissible initiation interval for ``g`` as a loop body,
    or 0 when the loop should stay unpipelined."""
    if not g.uops:
        return 0
    rows = _port_offsets(comp, g)
    if rows is None:
        return 0
    floor = max(_register_floor(g), _unit_floor(comp, g))
    for ii in range(max(1, floor), g.latency + 1):
        if _rows_admit(rows, ii):
            return ii
    return 0


def pipeline_loops(comp: Component) -> Component:
    """Annotate innermost single-group repeats with their II.

    Only loops whose body is one group qualify (run chaining first —
    that is what collapses multi-statement bodies); a loop is pipelined
    only when the computed II actually beats the sequential
    ``body + overhead`` per-iteration cost.
    """
    pipelined: List[Dict[str, int]] = []

    def rewrite(node: CNode) -> CNode:
        if isinstance(node, GEnable):
            return node
        if isinstance(node, CSeq):
            return CSeq([rewrite(ch) for ch in node.children])
        if isinstance(node, CPar):
            return CPar([rewrite(ch) for ch in node.children])
        if isinstance(node, CIf):
            return dataclasses.replace(node, then=rewrite(node.then),
                                       els=rewrite(node.els))
        if isinstance(node, CRepeat):
            body = rewrite(node.body)
            node = dataclasses.replace(node, body=body)
            if (node.ii == 0 and node.extent >= 2
                    and isinstance(body, GEnable)):
                g = comp.groups[body.group]
                ii = compute_ii(comp, g)
                if ii and ii < g.latency + F.LOOP_ITER_OVERHEAD:
                    node = dataclasses.replace(node, ii=ii)
                    pipelined.append({"var": node.var,
                                      "extent": node.extent,
                                      "ii": ii,
                                      "body_latency": g.latency})
            return node
        raise TypeError(node)

    control = rewrite(comp.control)
    out = Component(comp.name, comp.cells, comp.groups, control,
                    meta=dict(comp.meta))
    out.meta["pipelined"] = pipelined
    return out
