"""Reproduction of the paper's evaluation (Figs 2-3, Tables 1-2) with the
PyTorch port's compiler.

The twin of ``benchmarks/paper_tables.py``, over ``repro_torch.core`` (it
imports nothing of ``repro`` and no ``jax``): the same published ``PAPER``
constants, models and lines, every compile with ``share=False`` (the
paper's toolchain has no binding stage).  The passes are verbatim copies of
the reference's, so every line's name and ``derived`` field equal the
reference's; the ``us_per_call`` column is this host's compile time.

It compiles and estimates only, on the host: ``run`` takes the runner's
``device`` argument and uses none.

    PYTHONPATH=src:. python benchmarks/run_torch.py paper_tables --device cpu
"""
from __future__ import annotations

import time
from typing import Dict

from benchmarks import torch_device
from repro_torch.core import frontend, pipeline

# Published numbers (paper §4).  Fig. 3 latencies; Tables 1-2 resources.
PAPER = {
    "ffnn_cycles": {1: 22475, 2: 9378, 4: 3078},
    "ffnn_vitis_cycles": {2: 7908, 4: 6813},
    "speedup_1_2": 2.40,
    "speedup_2_4": 3.05,
    "table1": {  # resource: model: (vitis, calyx)
        "LUTs": {"MHA": (7846, 33312), "CNN": (3136, 4574),
                 "FFNN": (2011, 3730)},
        "FFs": {"MHA": (4017, 5561), "CNN": (1815, 1223),
                "FFNN": (1281, 742)},
        "BRAMs": {"MHA": (194, 71), "CNN": (213, 43), "FFNN": (43, 9)},
        "DSPs": {"MHA": (19, 67), "CNN": (5, 14), "FFNN": (5, 6)},
    },
    "table2_calyx": {  # FFNN resources vs partition factor
        "LUTs": {1: 3730, 2: 13197, 4: 49121},
        "FFs": {1: 742, 2: 3145, 4: 10657},
        "BRAMs": {1: 9, 2: 10, 4: 20},
        "DSPs": {1: 6, 2: 20, 4: 69},
    },
}

_KEY = {"LUT": "LUTs", "FF": "FFs", "BRAM": "BRAMs", "DSP": "DSPs"}


def _models():
    return {
        "FFNN": (frontend.paper_ffnn(), (1, 64)),
        "CNN": (frontend.paper_cnn(), (3, 80, 60)),
        "MHA": (frontend.paper_mha(), (8, 42)),
    }


def fig2_latency(emit) -> Dict[str, Dict]:
    """Baseline (factor 1) latency across the three models."""
    out = {}
    for name, (model, shape) in _models().items():
        t0 = time.time()
        d = pipeline.compile_model(model, [shape], factor=1,
                                   share=False)
        wall = (time.time() - t0) * 1e6
        est = d.estimate
        out[name] = est.as_dict()
        emit(f"fig2_{name.lower()}_cycles", wall, est.cycles)
        emit(f"fig2_{name.lower()}_wall_us", wall, est.wall_us)
    return out


def table1_resources(emit) -> Dict[str, Dict]:
    out = {}
    for name, (model, shape) in _models().items():
        d = pipeline.compile_model(model, [shape], factor=1,
                                   share=False)
        res = d.estimate.resources
        out[name] = res
        for r, ours in res.items():
            vitis, calyx = PAPER["table1"][_KEY[r]][name]
            emit(f"table1_{name.lower()}_{r.lower()}", 0.0,
                 f"{ours}|paper_calyx={calyx}|paper_vitis={vitis}")
    return out


def fig3_partition_sweep(emit) -> Dict[int, Dict]:
    """FFNN latency + resources vs cyclic partition factor (the headline)."""
    model, shape = _models()["FFNN"]
    results = {}
    for f in (1, 2, 4):
        t0 = time.time()
        d = pipeline.compile_model(model, [shape], factor=f,
                                   share=False)
        wall = (time.time() - t0) * 1e6
        results[f] = d.estimate.as_dict()
        emit(f"fig3_ffnn_f{f}_cycles", wall,
             f"{d.estimate.cycles}|paper={PAPER['ffnn_cycles'][f]}")
        for r, v in d.estimate.resources.items():
            emit(f"table2_ffnn_f{f}_{r.lower()}", 0.0,
                 f"{v}|paper={PAPER['table2_calyx'][_KEY[r]][f]}")
    s12 = results[1]["cycles"] / results[2]["cycles"]
    s24 = results[2]["cycles"] / results[4]["cycles"]
    emit("fig3_speedup_1to2", 0.0,
         f"{s12:.2f}|paper={PAPER['speedup_1_2']}")
    emit("fig3_speedup_2to4", 0.0,
         f"{s24:.2f}|paper={PAPER['speedup_2_4']}")
    return results


def run(emit, device=None) -> None:
    """The three tables; ``device`` is the runner's and is not used."""
    fig2_latency(emit)
    table1_resources(emit)
    fig3_partition_sweep(emit)


if __name__ == "__main__":
    torch_device.main(run, __doc__)
