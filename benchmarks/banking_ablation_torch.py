"""Ablations of the paper's two techniques (§3.3) with the PyTorch port's
compiler, and the device-side analogue on the card.

The twin of ``benchmarks/banking_ablation.py`` (it imports nothing of
``repro`` and no ``jax``).  Sections 1-4 compile and estimate on the host,
over ``repro_torch.core``, whose passes are verbatim copies of the
reference's, so their lines equal the reference's:

1. layout vs branchy banking: cycles, instantiated branch arms (the c^d
   blow-up), surviving div/mod units, unprovable hazards.
2. restructured vs duplicated-FSM schedules (par/seq rewrite).
3. unbanked parallelism: port-conflict serialization (why banking exists).
4. resource sharing: bound vs one-unit-per-statement designs, LUT/DSP
   reduction at identical cycle counts (a difference raises).
5. the device analogue: ``repro_torch.models.moe.moe_block`` on the reduced
   olmoe-1b-7b, layer 0 of the seed-0 draw, a (2, 32, d_model) float32
   input from ``default_rng(0)``, banked (static-capacity scatter) vs gather
   (per-token expert-weight gathers) dispatch, on the device.  The
   reference counts ``gather`` and ``dynamic-slice`` ops in compiled HLO;
   the twin counts the index reads one eager call dispatches
   (``OpCounter.slice_reads``: ``index``, ``gather``, ``index_select``,
   ``embedding``, ``take_along_dim``).  Eager ops are not fused ops, so the
   numbers differ from the reference's; what holds in both is that banked
   reads fewer slices than gather.  A call is timed over 5 calls after a
   warm one, the device synchronized, on this host's clock.

Section 5 runs on the card unless ``--device cpu`` is given, and raises
without one.

    PYTHONPATH=src:. python benchmarks/run_torch.py banking_ablation --device cpu
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmarks import torch_device
from repro_torch.core import affine, banking, calyx, estimator, frontend, \
    pipeline
from repro_torch.core import schedule as SCH
from repro_torch.core.banking import count_branch_arms, count_divmod_hardware
from repro_torch.device import resolve_device
from repro_torch.launch.op_analysis import OpCounter

MOE_CALLS = 5


def banking_modes(emit) -> None:
    m = frontend.paper_ffnn()
    for f in (2, 4):
        dl = pipeline.compile_model(m, [(1, 64)], factor=f, mode="layout")
        db = pipeline.compile_model(m, [(1, 64)], factor=f, mode="branchy",
                                    check_hazards=False)
        emit(f"ablate_f{f}_layout_cycles", 0.0, dl.estimate.cycles)
        emit(f"ablate_f{f}_branchy_cycles", 0.0, db.estimate.cycles)
        emit(f"ablate_f{f}_branchy_slowdown", 0.0,
             f"{db.estimate.cycles / dl.estimate.cycles:.2f}x")
        emit(f"ablate_f{f}_branch_arms", 0.0,
             f"layout={count_branch_arms(dl.program)}"
             f"|branchy={count_branch_arms(db.program)}")
        emit(f"ablate_f{f}_divmod_units", 0.0,
             f"layout={count_divmod_hardware(dl.program)}"
             f"|branchy={count_divmod_hardware(db.program)}")
        emit(f"ablate_f{f}_unprovable_hazards", 0.0,
             f"layout={len(dl.hazards)}|branchy={len(db.hazards)}")


def restructure_ablation(emit) -> None:
    m = frontend.paper_ffnn()
    for f in (2, 4):
        d_on = pipeline.compile_model(m, [(1, 64)], factor=f,
                                      restructure=True)
        d_off = pipeline.compile_model(m, [(1, 64)], factor=f,
                                       restructure=False)
        emit(f"restructure_f{f}_shared_cycles", 0.0, d_on.estimate.cycles)
        emit(f"restructure_f{f}_duplicated_cycles", 0.0, d_off.estimate.cycles)
        emit(f"restructure_f{f}_win", 0.0,
             f"{d_off.estimate.cycles / d_on.estimate.cycles:.2f}x")


def unbanked_parallelism(emit) -> None:
    """Par without banking: single-ported memories serialize the arms."""
    g = frontend.trace(frontend.paper_ffnn(), [(1, 64)])
    prog_seq = affine.lower_graph(g)
    cyc_seq = estimator.cycles(calyx.lower_program(prog_seq))
    par = SCH.restructure(SCH.parallelize(affine.lower_graph(g), 2))
    cyc_par_unbanked = estimator.cycles(calyx.lower_program(par))
    banked = banking.apply_banking(par, banking.BankingSpec(factor=2))
    cyc_banked = estimator.cycles(calyx.lower_program(banked))
    emit("portmodel_sequential_cycles", 0.0, cyc_seq)
    emit("portmodel_par_unbanked_cycles", 0.0, cyc_par_unbanked)
    emit("portmodel_par_banked_cycles", 0.0, cyc_banked)
    emit("portmodel_banking_required", 0.0,
         f"unbanked_speedup={cyc_seq / cyc_par_unbanked:.2f}x"
         f"|banked_speedup={cyc_seq / cyc_banked:.2f}x")


def sharing_ablation(emit) -> None:
    """Shared vs unshared resource column: the binding pass must cut LUT+DSP
    sharply at *identical* cycle counts (it only rebinds exclusive groups)."""
    for name, model, shape in (
            ("ffnn", frontend.paper_ffnn(), (1, 64)),
            ("matmul", frontend.Linear(64, 48, bias=False), (1, 64))):
        for f in (2, 4):
            ds = pipeline.compile_model(model, [shape], factor=f, share=True)
            du = pipeline.compile_model(model, [shape], factor=f, share=False)
            if ds.estimate.cycles != du.estimate.cycles:  # survives python -O
                raise RuntimeError(
                    f"sharing must be latency-neutral: {name} f={f} "
                    f"{ds.estimate.cycles} != {du.estimate.cycles}")
            rs, ru = ds.estimate.resources, du.estimate.resources
            cut = 1.0 - (rs["LUT"] + rs["DSP"]) / (ru["LUT"] + ru["DSP"])
            emit(f"share_{name}_f{f}_cycles", 0.0, ds.estimate.cycles)
            emit(f"share_{name}_f{f}_lut", 0.0,
                 f"unshared={ru['LUT']}|shared={rs['LUT']}")
            emit(f"share_{name}_f{f}_dsp", 0.0,
                 f"unshared={ru['DSP']}|shared={rs['DSP']}")
            emit(f"share_{name}_f{f}_lutdsp_cut", 0.0, f"{cut * 100:.1f}%")
            emit(f"share_{name}_f{f}_pools", 0.0, ds.sharing.summary())


def moe_dispatch_census(emit, dev: torch.device) -> dict:
    """Banked vs gather MoE dispatch on ``dev``: microseconds a call and the
    index reads of one call; returns ``{mode: reads}``."""
    from repro_torch.models import get_config
    from repro_torch.models import params as MP
    from repro_torch.models.moe import moe_block

    cfg = get_config("olmoe-1b-7b").reduced()
    prm = MP.init_params(cfg, seed=0, device=dev)
    layer0 = {k: v[0] for k, v in prm["blocks"]["lyr"]["moe"].items()}
    x = torch.tensor(np.random.default_rng(0).normal(size=(2, 32, cfg.d_model)),
                     dtype=torch.float32, device=dev)
    reads = {}
    with torch.no_grad():
        for mode in ("banked", "gather"):
            c = dataclasses.replace(cfg, moe_dispatch=mode)
            moe_block(c, layer0, x)                  # warm
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(MOE_CALLS):
                moe_block(c, layer0, x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            us = (time.perf_counter() - t0) / MOE_CALLS * 1e6
            with OpCounter() as counter:
                moe_block(c, layer0, x)
            reads[mode] = counter.slice_reads()
            emit(f"moe_{mode}_us_per_call", us, f"gather_ops={reads[mode]}")
    return reads


def run(emit, device=None) -> None:
    dev = resolve_device(device)
    banking_modes(emit)
    restructure_ablation(emit)
    unbanked_parallelism(emit)
    sharing_ablation(emit)
    moe_dispatch_census(emit, dev)


if __name__ == "__main__":
    torch_device.main(run, __doc__)
