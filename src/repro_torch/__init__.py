"""PyTorch / CUDA port of the PyTorch -> Calyx toolchain, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors it module
for module and is held against it on the same inputs.  Ground rules:

* **The JAX package stays exactly as it is.**  It is the reference that
  every module here is compared with (``tests/test_torch_*.py``).
* **No JAX, nothing of ``repro``.**  This package imports ``torch`` and
  numpy, never ``jax`` and no ``repro.*`` module, not even the numpy-only
  compiler passes: ``core/`` keeps verbatim copies of them, so the Calyx
  text, the Verilog, the cycle counts and the seeded weights are
  byte-identical to the reference's.
* **Entry points run on ``cuda``** unless the caller passes
  ``device="cpu"``, as the CPU tests do.  Where no card is present and
  none was declined they raise ``RuntimeError``; they never carry on
  silently on the CPU.
* **Every TPU kernel becomes a hand-written Hopper kernel** (CUDA C++ for
  ``sm_90a`` under ``csrc/``, built at first use into ``build/``).  A
  kernel's plain PyTorch version serves CPU tensors only; on a CUDA tensor
  the wrapper launches the kernel or raises.

Ported so far: the paper's compile flow (``core``) with its torch oracle
(``core.torch_backend``) and the banked-kernel backend
(``core.cuda_backend``) over ``kernels.banked_matmul``; the other three
kernels of ``repro.kernels`` behind ``kernels.ops``: ``attention``
(``kernels.flash_attention``), ``decay_scan`` (``kernels.ssm_scan``) and
``conv2d`` (``kernels.banked_conv2d``); and dense decode and serving: the
model zoo's configs and dense family (``models``: params with the
reference's seeded weights, ``forward``/``loss_fn``, the decode cache and
``serve_step``), the continuous-batching engine with its faults,
resilience and CLI (``launch.serve``, ``launch.faults``,
``launch.resilience``) and its observability (``obs``: metrics, spans,
traffic, the layer profiler).  The serving path, like the reference's,
runs none of the four kernels: its products are plain ``torch`` matmuls
and einsums, as the reference's are einsums.
"""
