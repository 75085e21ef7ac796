"""Render EXPERIMENTS_torch.md tables from the port's dry-run record
directories; the twin of ``benchmarks/make_report.py``.

    PYTHONPATH=src:. python -m benchmarks.make_report_torch [baseline_dir] [opt_dir]

The directories default to ``dryrun_torch`` and ``dryrun_torch_opt`` under
``artifacts/`` (an absolute path is taken as it is).  The tables are the
reference's, line for line, but for two columns that the port's record
fills otherwise (``repro_torch.launch.dryrun``): "peak live/dev" reads
``memory_analysis.peak_live_bytes``, the op counter's peak of live local
storages, where the reference's "temp/dev" reads XLA's
``temp_size_in_bytes``; "run" reads ``run_s``, the seconds of the one
counted eager run, where the reference's "compile" reads ``compile_s``.
``compare_table``'s memory row reads the peak too.  A record whose status is
``error``, on which the reference raises, gets a row that says so.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(dirname):
    out = {}
    d = ROOT / "artifacts" / dirname
    for p in sorted(d.glob("*.json")):
        r = json.loads(p.read_text())
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def fmt_bytes(b):
    if b >= 1e12:
        return f"{b/1e12:.2f}T"
    if b >= 1e9:
        return f"{b/1e9:.1f}G"
    return f"{b/1e6:.0f}M"


def _peak(r):
    return (r.get("memory_analysis") or {}).get("peak_live_bytes", 0)


def dryrun_table(cells, mesh):
    lines = ["| arch | shape | status | chips | HLO flops/dev | bytes/dev | "
             "coll bytes/dev | peak live/dev | run |",
             "|---|---|---|---:|---:|---:|---:|---:|---:|"]
    for (a, s, m), r in sorted(cells.items()):
        if m != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {a} | {s} | SKIP (full attn @512k) | | | | | | |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {a} | {s} | ERROR: {r.get('error', '?')[:60]} "
                         f"| | | | | | |")
            continue
        f = r["roofline"]
        lines.append(
            f"| {a} | {s} | ok | {r['chips']} | "
            f"{fmt_bytes(f['flops_per_device'])} | "
            f"{fmt_bytes(f['bytes_per_device'])} | "
            f"{fmt_bytes(f['collective_bytes_per_device'])} | "
            f"{fmt_bytes(_peak(r))} | {r['run_s']:.0f}s |")
    return "\n".join(lines)


def roofline_table(cells, mesh="pod16x16"):
    lines = ["| arch | shape | compute_s | memory_s | collective_s | "
             "dominant | useful frac | roofline frac |",
             "|---|---|---:|---:|---:|---|---:|---:|"]
    for (a, s, m), r in sorted(cells.items()):
        if m != mesh or r["status"] != "ok":
            continue
        f = r["roofline"]
        lines.append(
            f"| {a} | {s} | {f['compute_s']:.3f} | {f['memory_s']:.3f} | "
            f"{f['collective_s']:.4f} | **{f['dominant']}** | "
            f"{f['useful_flops_frac']:.2f} | {f['roofline_frac']:.4f} |")
    return "\n".join(lines)


def compare_table(base, opt, cells_of_interest):
    lines = ["| cell | metric | baseline | optimized | delta |",
             "|---|---|---:|---:|---:|"]
    for (a, s) in cells_of_interest:
        b = base.get((a, s, "pod16x16"))
        o = opt.get((a, s, "pod16x16"))
        if not b or not o or b["status"] != "ok" or o["status"] != "ok":
            continue
        for m in ("compute_s", "memory_s", "collective_s"):
            bb, oo = b["roofline"][m], o["roofline"][m]
            lines.append(f"| {a}×{s} | {m} | {bb:.3f} | {oo:.3f} | "
                         f"{(oo/bb-1)*100:+.1f}% |")
        bt, ot = _peak(b), _peak(o)
        lines.append(f"| {a}×{s} | peak live/dev | {fmt_bytes(bt)} | "
                     f"{fmt_bytes(ot)} | {(ot/max(bt,1)-1)*100:+.1f}% |")
        lines.append(f"| {a}×{s} | roofline_frac | "
                     f"{b['roofline']['roofline_frac']:.4f} | "
                     f"{o['roofline']['roofline_frac']:.4f} | "
                     f"{o['roofline']['roofline_frac']/max(b['roofline']['roofline_frac'],1e-9):.2f}x |")
    return "\n".join(lines)


def main():
    base = load(sys.argv[1] if len(sys.argv) > 1 else "dryrun_torch")
    opt_dir = sys.argv[2] if len(sys.argv) > 2 else "dryrun_torch_opt"
    try:
        opt = load(opt_dir)
    except Exception:
        opt = {}
    print("### Dry-run (single pod 16x16, baseline)\n")
    print(dryrun_table(base, "pod16x16"))
    print("\n### Dry-run (multi-pod 2x16x16, baseline)\n")
    print(dryrun_table(base, "pod2x16x16"))
    print("\n### Roofline (single pod, baseline)\n")
    print(roofline_table(base))
    if opt:
        print("\n### Roofline (single pod, optimized)\n")
        print(roofline_table(opt))
        print("\n### Optimized vs baseline (hillclimbed cells)\n")
        print(compare_table(base, opt, [("qwen2-0.5b", "train_4k"),
                                        ("olmoe-1b-7b", "train_4k"),
                                        ("gemma2-27b", "train_4k")]))


if __name__ == "__main__":
    main()
