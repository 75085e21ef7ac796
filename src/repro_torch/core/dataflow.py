"""Executable datapath semantics (micro-ops) for Calyx groups.

The lowering in ``calyx._Lower`` used to record only a *summary* of each
group (latency, cells, port accesses); the computation itself was lost at
lowering time, so the emitted component could be estimated but never
executed.  This module defines the micro-op vocabulary the lowering now
records per group — cell invocations, register reads/writes, and memory
port accesses with concrete address expressions — plus the evaluator the
cycle-accurate simulator (``core.sim``) drives.

A micro-op list is a small SSA program over per-activation temporaries:
temps are dense integers local to one group activation, so re-executing a
group across ``repeat`` iterations never aliases stale state.  Micro-ops
that occupy a memory port carry the cycle *offset* (within the group's
activation window) at which the port is busy, consistent with the latency
arithmetic of the lowering — the hook the simulator uses to enforce
Calyx's one-access-per-cycle memory constraint at per-cycle granularity.
ALU, select, and register-write micro-ops likewise carry the offset at
which they fire: the scheduling layer (``core.pipelining``) reads those
stamps to derive loop-carried recurrence constraints when computing a
pipelined loop's initiation interval.

``UAlu.cell`` names the functional unit that performs the operation.  When
the binding pass (``sharing.share_cells``) rebinds units onto shared pools
the name is rewritten to the pool cell while ``orig_cell`` keeps the
pre-binding identity: every use keeps its own operand temporaries and its
provenance, i.e. the per-user operand routing stays explicit, which is
what lets the simulator arbitrate single ownership of shared units.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

from .affine import AExpr, Cond


class UOp:
    """Base class for group micro-operations."""


@dataclasses.dataclass
class UConst(UOp):
    dst: int
    value: float


@dataclasses.dataclass
class URegRead(UOp):
    dst: int
    reg: str


@dataclasses.dataclass
class UMemRead(UOp):
    dst: int
    mem: str
    idxs: List[AExpr]
    off: int                  # cycle offset of the port access in the group


@dataclasses.dataclass
class UAlu(UOp):
    dst: int
    op: str                   # add sub mul div max min | exp relu neg
    a: int
    b: Optional[int]          # None for unary ops
    cell: str                 # functional unit (pool name after binding)
    orig_cell: str = ""       # pre-binding cell name (set by sharing)
    off: int = 0              # cycle offset at which the unit starts


@dataclasses.dataclass
class USelect(UOp):
    dst: int
    cond: Cond
    a: int
    b: int
    off: int = 0              # cycle offset at which the mux selects


@dataclasses.dataclass
class URegWrite(UOp):
    reg: str
    src: int
    off: int = 0              # cycle offset at which the register latches


@dataclasses.dataclass
class UMemWrite(UOp):
    mem: str
    idxs: List[AExpr]
    src: int
    off: int                  # cycle offset of the write-port access


# Integer-temp fields a micro-op may carry — the single source for passes
# that renumber or analyze the SSA space (chaining, verify).
TEMP_FIELDS = ("dst", "a", "b", "src")


def temp_def(u: UOp) -> Optional[int]:
    """The temp a micro-op defines, or None (writes define no temp)."""
    if isinstance(u, (UConst, URegRead, UMemRead, UAlu, USelect)):
        return u.dst
    return None


def temp_uses(u: UOp) -> List[int]:
    """The temps a micro-op reads, in operand order."""
    if isinstance(u, UAlu):
        return [u.a] if u.b is None else [u.a, u.b]
    if isinstance(u, USelect):
        return [u.a, u.b]
    if isinstance(u, (URegWrite, UMemWrite)):
        return [u.src]
    return []


_BIN = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "max": max,
    "min": min,
}


def alu(op: str, a: float, b: Optional[float] = None) -> float:
    """Reference FU semantics — must agree with ``affine.interpret``."""
    fn = _BIN.get(op)
    if fn is not None:
        return fn(a, b)
    if op == "exp":
        return math.exp(min(a, 700.0))
    if op == "relu":
        return max(a, 0.0)
    if op == "neg":
        return -a
    raise KeyError(op)


def uop_detail(u: UOp) -> str:
    """The trace descriptor of a micro-op (``trace.UOP`` event detail).

    Chosen so the Calyx-level and netlist-level simulators produce equal
    strings for the same operation: ``UAlu.cell`` equals the lowered
    ``DpUnit.unit`` (post-sharing pool name), register and memory names
    survive lowering unchanged.
    """
    if isinstance(u, UAlu):
        return f"alu:{u.op}:{u.cell}"
    if isinstance(u, UConst):
        return "const"
    if isinstance(u, URegRead):
        return f"regrd:{u.reg}"
    if isinstance(u, USelect):
        return "select"
    if isinstance(u, URegWrite):
        return f"regwr:{u.reg}"
    if isinstance(u, UMemRead):
        return f"memrd:{u.mem}"
    if isinstance(u, UMemWrite):
        return f"memwr:{u.mem}"
    raise TypeError(u)


def uop_off(u: UOp) -> int:
    """Cycle offset of a micro-op within its group's activation window
    (0 for ops that carry no stamp: constants and register reads)."""
    return getattr(u, "off", 0)


def execute(uops: Sequence[UOp], env: Dict[str, int], regs: Dict[str, float],
            read_mem: Callable[[UMemRead], float],
            write_mem: Callable[[UMemWrite, float], None],
            on_alu: Optional[Callable[[UAlu], None]] = None,
            on_uop: Optional[Callable[[UOp], None]] = None) -> int:
    """Run one group activation; returns the micro-op count executed.

    ``read_mem`` / ``write_mem`` receive the micro-op itself so the caller
    can evaluate addresses against ``env``, track port occupancy, and touch
    its backing store.  Register state persists across activations through
    ``regs``; temporaries do not.  ``on_uop`` (the trace hook) sees every
    micro-op as it issues; it is None unless tracing is on.
    """
    tmp: Dict[int, float] = {}
    n = 0
    for u in uops:
        n += 1
        if on_uop is not None:
            on_uop(u)
        if isinstance(u, UConst):
            tmp[u.dst] = u.value
        elif isinstance(u, URegRead):
            tmp[u.dst] = regs[u.reg]
        elif isinstance(u, UMemRead):
            tmp[u.dst] = read_mem(u)
        elif isinstance(u, UAlu):
            if on_alu is not None:
                on_alu(u)
            tmp[u.dst] = alu(u.op, tmp[u.a],
                             None if u.b is None else tmp[u.b])
        elif isinstance(u, USelect):
            tmp[u.dst] = tmp[u.a] if u.cond.evaluate(env) else tmp[u.b]
        elif isinstance(u, URegWrite):
            regs[u.reg] = tmp[u.src]
        elif isinstance(u, UMemWrite):
            write_mem(u, tmp[u.src])
        else:
            raise TypeError(u)
    return n
