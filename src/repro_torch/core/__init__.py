"""Core compiler: the paper's PyTorch -> Calyx pipeline, plus binding.

  frontend  : torch-like tracing        (PyTorch -> Allo)
  tensor_ir : Linalg-like tensor graph  (Allo -> Linalg)
  affine    : loop-nest IR + interpreter(Linalg -> Affine/SCF)
  schedule  : par materialization + par/seq restructuring
  banking   : cyclic memory partitioning (layout-embedded vs branchy)
  calyx     : structural hardware IR    (CIRCT -> Calyx)
  chaining  : operation chaining / group fusion      (opt_level >= 1)
  pipelining: loop pipelining with static IIs        (opt_level >= 2)
  sharing   : resource binding onto shared functional-unit pools
  estimator : cycles / resources / timing
  rtl       : Calyx -> FSM + datapath netlist (structural RTL)
  verilog   : netlist -> synthesizable SystemVerilog
  rtl_sim   : cycle-driven two-state execution of the netlist

The passes are verbatim copies of ``repro.core``'s numpy-only modules;
``torch_backend`` (the oracle) and ``cuda_backend`` (the banked-kernel
backend) take the place of ``jax_backend`` and ``pallas_backend``.
"""
from .pipeline import CompiledDesign, compile_graph, compile_model  # noqa: F401
from .banking import BankingSpec, BankConflictError  # noqa: F401
from .sharing import SharingReport, share_cells  # noqa: F401
from .rtl import Netlist, lower_component  # noqa: F401
