"""Recompute model_flops / roofline fields in the port's existing dry-run
records (after a model-flops formula fix) without running anything again;
the twin of ``benchmarks/fix_artifacts.py``.

    PYTHONPATH=src python benchmarks/fix_artifacts_torch.py [dir ...]

Each directory (default ``dryrun_torch`` and ``dryrun_torch_opt`` under
``artifacts/``; an absolute path is taken as it is) has its ``ok`` records'
``model_flops`` recomputed with ``repro_torch.launch.dryrun.model_flops``
and their ``roofline`` with ``op_stats.roofline_terms`` at the H100's
constants, from the record's ``hlo_cost.flops``, ``hlo_cost.traffic_bytes``,
``collectives.bytes_by_kind`` and ``chips``.  Other records are left as
they are.  Prints ``name -> n fixed`` for each directory that exists.
"""
from __future__ import annotations

import json
import pathlib
import sys

from repro_torch.launch import op_stats
from repro_torch.launch.dryrun import model_flops
from repro_torch.launch.shapes import SHAPES
from repro_torch.models import get_config

ROOT = pathlib.Path(__file__).resolve().parents[1] / "artifacts"


def fix_dir(d: pathlib.Path) -> int:
    n = 0
    for p in sorted(d.glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("status") != "ok":
            continue
        cfg = get_config(r["arch"])
        shape = SHAPES[r["shape"]]
        mf = model_flops(cfg, shape)
        coll = op_stats.CollectiveStats(
            bytes_by_kind=r["collectives"]["bytes_by_kind"], count_by_kind={})
        roof = op_stats.roofline_terms(
            {"flops": r["hlo_cost"]["flops"],
             "bytes accessed": r["hlo_cost"]["traffic_bytes"]},
            coll, r["chips"], mf)
        r["model_flops"] = mf
        r["roofline"] = roof.as_dict()
        p.write_text(json.dumps(r, indent=1))
        n += 1
    return n


if __name__ == "__main__":
    for name in sys.argv[1:] or ["dryrun_torch", "dryrun_torch_opt"]:
        d = ROOT / name
        if d.exists():
            print(name, "->", fix_dir(d), "fixed")
