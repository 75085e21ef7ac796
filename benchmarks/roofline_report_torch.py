"""Roofline / offload-candidate report of the PyTorch port.

The twin of ``benchmarks/roofline_report.py`` (it imports nothing of
``repro`` and no ``jax``).  Primary source: ``BENCH_model_torch.json``, the
port's per-operator decode profiles
(``benchmarks/model_profile_bench_torch.py``) joined with the analytic
cost model at the deployment shape and classed against the H100's
datasheet peaks.  One line per (arch, operator), ranked by measured share
of step time, then the top candidate per arch: the same lines as the
reference's.

Enrichment: where ``python -m repro_torch.launch.dryrun`` has written
records under ``artifacts/dryrun_torch/`` (keys ``roofline_torch_...``) and
the optimized sweep under ``artifacts/dryrun_torch_opt/``
(``roofline_torch_opt_...``), as the reference reads ``dryrun_baseline`` and
``dryrun_opt``, one line per cell with its whole-model roofline (compute, memory and collective seconds at the H100's
peaks, the dominant resource).  A missing directory is not an error, as in
the reference.

The section reads files only: ``$MODEL_BENCH_OUT`` where it is set (the
file the model-profile twin just wrote in the same runner call), else the
committed ``BENCH_model_torch.json``; ``--device`` is accepted for the
runner and names nothing it computes.

    PYTHONPATH=src:. python benchmarks/roofline_report_torch.py
"""
from __future__ import annotations

import json
import os
import pathlib

from benchmarks import torch_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_MODEL = ROOT / "BENCH_model_torch.json"
ARTIFACTS = ROOT / "artifacts"
# key prefix -> record directory (repro_torch.launch.dryrun.ARTIFACTS, and
# the optimized sweep of scripts/dryrun_sweep_torch.py)
DRYRUN_DIRS = (("roofline_torch_", "dryrun_torch"),
               ("roofline_torch_opt_", "dryrun_torch_opt"))


def load_model_bench(path: pathlib.Path = BENCH_MODEL):
    return json.loads(pathlib.Path(path).read_text())


def load_cells(dirname: str):
    cells = []
    d = ARTIFACTS / dirname
    if not d.exists():
        return cells
    for p in sorted(d.glob("*.json")):
        cells.append(json.loads(p.read_text()))
    return cells


def run(emit, device=None) -> None:
    # -- primary: the port's per-operator profiles --------------------------
    bench = load_model_bench(os.environ.get("MODEL_BENCH_OUT") or BENCH_MODEL)
    for rec in bench["records"]:
        arch = rec["arch"]
        shape = rec["full_shape"]
        for row in rec["offload"]:
            emit(f"roofline_{arch}_{row['op']}", row["wall_us_mean"],
                 f"rank={row['rank']}"
                 f"|share={row['share']:.0%}"
                 f"|flops={row['flops_per_step']:.3e}"
                 f"|bytes={row['bytes_per_step']:.3e}"
                 f"|intensity={row['intensity']:.1f}"
                 f"|bound={row['bound']}"
                 f"@B{shape['batch']}xS{shape['cache_len']}")
        top = rec["offload"][0]
        emit(f"roofline_{arch}_offload_top", 0.0,
             f"{top['op']} ({top['share']:.0%} of step, {top['bound']}"
             f"-bound) -> first Calyx lowering candidate")

    # -- enrichment: the port's dry-run cells when present ------------------
    for prefix, dirname in DRYRUN_DIRS:
        for r in load_cells(dirname):
            key = f"{prefix}{r['arch']}_{r['shape']}_{r['mesh']}"
            if r["status"] == "skipped":
                emit(key, 0.0,
                     f"SKIP:{r.get('reason', 'unsupported cell')[:80]}")
                continue
            if r["status"] != "ok":
                emit(key, 0.0, f"ERROR:{r.get('error', '?')[:80]}")
                continue
            f = r["roofline"]
            emit(key, f["step_time_s"] * 1e6,
                 f"dom={f['dominant']}"
                 f"|compute_s={f['compute_s']:.4f}"
                 f"|memory_s={f['memory_s']:.4f}"
                 f"|collective_s={f['collective_s']:.4f}"
                 f"|useful_frac={f['useful_flops_frac']:.3f}"
                 f"|roofline_frac={f['roofline_frac']:.4f}")

if __name__ == "__main__":
    torch_device.main(run, __doc__)
