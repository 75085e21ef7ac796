"""Hardware cost tables — the analogue of the paper's floating-point library.

The paper integrates Berkeley HardFloat into Calyx/CIRCT; synthesizing real
RTL is out of scope here, so each primitive carries a *calibrated* cost tuple
(cycles, LUT, FF, DSP) in the regime of HardFloat units on a Xilinx 7-series
part at ~250 MHz.  Absolute resource numbers are first-order models; the
benchmarks validate *ratios and regimes* against the paper's tables, which is
what the cycle model is calibrated for.

All constants live here so the whole estimator is tunable from one place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass(frozen=True)
class OpCost:
    cycles: int
    lut: int
    ff: int
    dsp: int


# HardFloat-style IEEE-754 single-precision units.
FLOAT_COSTS: Dict[str, OpCost] = {
    "fp_add": OpCost(2, 460, 70, 0),     # addFN (LUT carry chains)
    "fp_sub": OpCost(2, 460, 70, 0),
    "fp_mul": OpCost(3, 140, 55, 2),     # mulFN maps mantissa mul to DSP48
    "fp_div": OpCost(26, 760, 150, 0),    # iterative divSqrtFN
    "fp_max": OpCost(1, 70, 16, 0),
    "fp_min": OpCost(1, 70, 16, 0),
    "fp_relu": OpCost(1, 40, 4, 0),
    "fp_neg": OpCost(1, 6, 0, 0),
    "fp_exp": OpCost(16, 950, 130, 4),    # range-reduced polynomial
    "fp_cmp": OpCost(1, 60, 8, 0),
}

# Integer / address-path units.  Address arithmetic is combinational within a
# group (0 cycles) but costs fabric; div/mod by a non-power-of-2 constant is
# an iterative unit — the "expensive multiplication and modulo" the paper
# blames for flattened-memory indexing cost.
INT_COSTS: Dict[str, OpCost] = {
    "int_mul": OpCost(0, 90, 0, 1),       # const multiply, non-trivial
    "int_divmod": OpCost(6, 260, 70, 0),  # non-power-of-2 divide/modulo
    "int_add": OpCost(0, 18, 0, 0),
    "cmp": OpCost(0, 20, 0, 0),
    "mux": OpCost(0, 18, 0, 0),
    "reg32": OpCost(0, 4, 22, 0),         # 32-bit data register
    "idx_reg": OpCost(0, 3, 10, 0),       # loop index register + incr adder
}


def is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def int_mul_cost(const: int) -> OpCost:
    """Multiply-by-constant: powers of two are wiring; popcount<=2 constants
    become shift-adds; anything else takes a DSP slice."""
    c = abs(int(const))
    if c in (0, 1) or is_pow2(c):
        return OpCost(0, 0, 0, 0)
    if bin(c).count("1") <= 2:
        return OpCost(0, 40, 0, 0)
    return INT_COSTS["int_mul"]


def int_divmod_cost(const: int) -> OpCost:
    if is_pow2(abs(int(const))):
        return OpCost(0, 0, 0, 0)  # shift / mask
    return INT_COSTS["int_divmod"]


# Memory model: Calyx memories are single-ported (1 access/cycle) — the
# constraint that motivates banking.  Small banks become LUTRAM.
BRAM_BITS = 18 * 1024
LUTRAM_MAX_WORDS = 48
WORD_BITS = 32
MEM_READ_CYCLES = 1
MEM_WRITE_CYCLES = 1


def memory_cost(words: int) -> OpCost:
    """Fabric cost of one bank (BRAM count reported via memory_brams)."""
    if words <= LUTRAM_MAX_WORDS:
        # distributed RAM: ~1 LUT per 2 words of 32b + addressing
        return OpCost(0, max(4, words // 2 + 8), 8, 0)
    return OpCost(0, 24, 12, 0)


def memory_brams(words: int) -> int:
    if words <= LUTRAM_MAX_WORDS:
        return 0
    return math.ceil(words * WORD_BITS / BRAM_BITS)


# Resource sharing (binding) steering.  A pooled unit needs a 2:1 32-bit mux
# per operand for every user beyond the first, plus a grant/select register
# bit — so sharing pays off only for units well above mux cost, which is why
# sharing.SHAREABLE_KINDS excludes the cheap fabric.
SHARING_MUX_LUT_PER_EXTRA_USER: Dict[str, int] = {
    "fp_add": 34, "fp_sub": 34, "fp_mul": 34, "fp_div": 34,  # two operands
    "fp_exp": 18,                                             # one operand
    "int_mul": 18, "int_divmod": 34,
}
SHARING_MUX_FF_PER_EXTRA_USER = 2


def sharing_mux_cost(kind: str, users: int) -> OpCost:
    """Steering overhead of one shared cell serving ``users`` groups."""
    extra = max(0, users - 1)
    if not extra:
        return OpCost(0, 0, 0, 0)
    lut = SHARING_MUX_LUT_PER_EXTRA_USER.get(kind, 18) * extra
    return OpCost(0, lut, SHARING_MUX_FF_PER_EXTRA_USER * extra, 0)


# Control / FSM model.
FSM_LUT_PER_STATE = 14
FSM_FF_PER_STATE_BIT = 8
GROUP_FABRIC_LUT = 22          # go/done handshake + assignment fabric
LOOP_ITER_OVERHEAD = 1         # condition check folded with increment
LOOP_SETUP_CYCLES = 2
PAR_JOIN_CYCLES = 1
IF_SELECT_CYCLES = 1

# Per-design constant overhead (top-level interface / AXI-ish shim).
TOP_OVERHEAD = {"lut": 520, "ff": 90, "dsp": 2, "bram": 1}

# Timing model for wall-clock: base period plus pressure terms.
BASE_PERIOD_NS = 4.0
PERIOD_PER_LOG2_STATE_NS = 0.16
PERIOD_PER_SELECT_DEPTH_NS = 0.12


def achievable_period_ns(fsm_states: int, max_select_depth: int) -> float:
    return (BASE_PERIOD_NS
            + PERIOD_PER_LOG2_STATE_NS * math.log2(max(fsm_states, 2))
            + PERIOD_PER_SELECT_DEPTH_NS * max_select_depth)
