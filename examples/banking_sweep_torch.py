"""The PyTorch port's twin of ``examples/banking_sweep.py``: reproduce the
paper's Fig. 3 / Table 2 (FFNN partition sweep) and the layout-vs-branchy
ablation through ``repro_torch.core``; the output is the reference's, line
for line.  The sweep compiles and estimates on the host only: it runs
nothing on a device, so it takes no ``--device`` and, like the
reference, no flag.

Compiles with ``share=False``: the paper has no binding stage, so its
Table 2 LUT/DSP columns correspond to unshared designs (cycles are
identical either way).  See benchmarks/banking_ablation.py for the
shared-vs-unshared resource comparison.

    PYTHONPATH=src python examples/banking_sweep_torch.py
"""
from repro_torch.core import frontend, pipeline
from repro_torch.core.banking import count_branch_arms, count_divmod_hardware

PAPER_CYCLES = {1: 22475, 2: 9378, 4: 3078}


def main():
    model = frontend.paper_ffnn()
    print(f"{'factor':>6} {'mode':>8} {'cycles':>8} {'paper':>8} "
          f"{'LUT':>7} {'DSP':>4} {'branches':>8} {'divmod':>6}")
    layout = {}
    for factor in (1, 2, 4):
        for mode in ("layout", "branchy"):
            if factor == 1 and mode == "branchy":
                continue
            d = pipeline.compile_model(model, [(1, 64)], factor=factor,
                                       mode=mode, check_hazards=False,
                                       share=False)
            if mode == "layout":
                layout[factor] = d
            print(f"{factor:>6} {mode:>8} {d.estimate.cycles:>8} "
                  f"{PAPER_CYCLES[factor] if mode == 'layout' else '-':>8} "
                  f"{d.estimate.resources['LUT']:>7} "
                  f"{d.estimate.resources['DSP']:>4} "
                  f"{count_branch_arms(d.program):>8} "
                  f"{count_divmod_hardware(d.program):>6}")
    c1, c2, c4 = (layout[f].estimate.cycles for f in (1, 2, 4))
    print(f"\nspeedup 1->2: {c1 / c2:.2f}x (paper 2.40x)")
    print(f"speedup 2->4: {c2 / c4:.2f}x (paper 3.05x)")


if __name__ == "__main__":
    main()
