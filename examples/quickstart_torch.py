"""Quickstart on the PyTorch port: compile the paper's FFNN down to Calyx,
check it, and run it on the card through the banked CUDA kernel.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

The twin of ``examples/quickstart.py`` on ``repro_torch``: the same
pipeline (trace -> affine -> parallelize -> bank -> Calyx -> resource
sharing -> estimate) gives the same cycles at factors 1/2/4; the hardware
schedule is validated against the torch oracle, and the banked-kernel
backend runs the design on ``--device`` (the hand-written Hopper kernel on
``cuda``, its plain version on ``cpu``).
"""
import argparse

import numpy as np

from repro_torch.core import cuda_backend, frontend, pipeline


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the oracle and the banked backend run")
    args = ap.parse_args()
    model = frontend.paper_ffnn()
    x = np.random.default_rng(0).normal(size=(1, 64)).astype(np.float32)

    print(f"=== FFNN through the PyTorch->Calyx pipeline (port, "
          f"device={args.device}) ===")
    base = None
    for factor in (1, 2, 4):
        d = pipeline.compile_model(model, [(1, 64)], factor=factor)
        hw = d.run({"arg0": x})[0]
        oracle = d.run_oracle({"arg0": x}, device=args.device)[0]
        ok = np.allclose(hw, oracle, rtol=1e-4, atol=1e-5)
        banked = cuda_backend.execute_graph_cuda(d.graph, {"arg0": x}, d.spec,
                                                 device=args.device)[0]
        banked_ok = np.allclose(banked, oracle, rtol=1e-4, atol=1e-5)
        base = base or d.estimate.cycles
        print(f"factor={factor}: cycles={d.estimate.cycles:6d} "
              f"(speedup {base / d.estimate.cycles:4.2f}x) "
              f"fmax={d.estimate.fmax_mhz}MHz "
              f"resources={d.estimate.resources} correct={ok} "
              f"banked_backend={banked_ok} "
              f"max|banked-oracle|={float(np.abs(banked - oracle).max()):.3g}")

    print("\n=== Calyx IR (factor=2, excerpt) ===")
    d = pipeline.compile_model(model, [(1, 64)], factor=2)
    text = d.calyx_text()
    print("\n".join(text.splitlines()[:25]))
    print(f"... ({len(text.splitlines())} lines total)")


if __name__ == "__main__":
    main()
