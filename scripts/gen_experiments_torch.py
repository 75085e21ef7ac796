"""Regenerate EXPERIMENTS_torch.md from the port's dry-run records (run after
the sweeps of ``scripts/dryrun_sweep_torch.py``); the twin of
``scripts/gen_experiments.py``.

    PYTHONPATH=src:. python scripts/gen_experiments_torch.py \
        [--base dryrun_torch] [--opt dryrun_torch_opt] [--out EXPERIMENTS_torch.md]

``--base`` and ``--opt`` name record directories under ``artifacts/`` (an
absolute path is taken as it is); ``--out`` is relative to the repo's root.
Where the document exists it is spliced as the reference splices
EXPERIMENTS.md: the baseline tables replace everything from
``### Dry-run (single pod`` up to ``Baseline observations``, and the
``OPTIMIZED_TABLES_PLACEHOLDER`` and ``SUMMARY_PLACEHOLDER`` lines are
filled where they still stand.  Where it does not exist it is written from
:data:`SKELETON`, which carries those markers, so a second run keeps the
prose written under "Baseline observations".  The spliced block ends with
the line of ``<base>/host.txt`` (the card and torch the sweep ran on, which
the sweep writes), so the records' origin is rewritten with them.

The summary's memory verdict reads ``peak_live_bytes`` against the H100's
HBM (``op_stats.HBM_BYTES``).  A cell missing from either sweep, or not
``ok`` there, is named on one line of standard output and left out of the
summary, where the reference raises ``KeyError``.
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from benchmarks.make_report_torch import (load, dryrun_table,  # noqa: E402
                                          roofline_table, compare_table)
from repro_torch.launch.op_stats import HBM_BYTES  # noqa: E402

CELLS = [("qwen2-0.5b", "train_4k"), ("olmoe-1b-7b", "train_4k"),
         ("gemma2-27b", "train_4k")]

SKELETON = """# EXPERIMENTS (PyTorch port): the dry run's whole sweep

Rendered by `scripts/gen_experiments_torch.py` from the records of the
port's dry run, `python -m repro_torch.launch.dryrun`, run one process a
cell by `scripts/dryrun_sweep_torch.py`: every (arch x shape x mesh) cell's
step runs once on DTensors over a fake 16x16 or 2x16x16 process group under
`FakeTensorMode`, and the op counter (`launch/op_analysis.py`) counts it a
device. The roofline terms are the H100's datasheet peaks
(`launch/op_stats.py`). "peak live/dev" is the peak of the live local
storages the counter tracked; "run" the seconds of the one counted run on
the host. Every run of the script rewrites the baseline tables and the
line naming the card; the observations below them are kept.

### Dry-run (single pod 16x16, baseline)

Baseline observations

(none written yet)

OPTIMIZED_TABLES_PLACEHOLDER

### Summary

SUMMARY_PLACEHOLDER
"""


def summary(base, opt):
    lines = []
    hbm = HBM_BYTES / 1e9
    for a, s in CELLS:
        b, o = base.get((a, s, "pod16x16")), opt.get((a, s, "pod16x16"))
        gone = [name for name, r in (("base", b), ("opt", o))
                if not r or r["status"] != "ok"]
        if gone:
            print(f"left out of the summary: {a} × {s} "
                  f"(missing or not ok in the {' and '.join(gone)} sweep)")
            continue
        bt = (b.get("memory_analysis") or {}).get("peak_live_bytes", 0) / 1e9
        ot = (o.get("memory_analysis") or {}).get("peak_live_bytes", 0) / 1e9
        b, o = b["roofline"], o["roofline"]
        lines.append(
            f"* **{a} × {s}** — step-time bound {b['step_time_s']:.2f}s → "
            f"{o['step_time_s']:.2f}s ({b['step_time_s']/o['step_time_s']:.2f}×), "
            f"roofline fraction {b['roofline_frac']:.4f} → "
            f"{o['roofline_frac']:.4f} "
            f"({o['roofline_frac']/max(b['roofline_frac'],1e-12):.2f}×), "
            f"peak live {bt:.1f} → {ot:.1f} GB/device "
            f"({'fits' if ot <= hbm else 'exceeds'} the H100's {hbm:.0f} GB HBM).")
    return "\n".join(lines)


def _host_line(base_dir: str) -> str:
    p = ROOT / "artifacts" / base_dir / "host.txt"
    text = p.read_text().strip() if p.exists() else "not recorded"
    return f"Records taken on: {text}"


def render(base_dir: str, opt_dir: str, out: pathlib.Path) -> str:
    base, opt = load(base_dir), load(opt_dir)
    tables = "\n\n".join([
        "### Dry-run (single pod 16x16, baseline)\n\n"
        + dryrun_table(base, "pod16x16"),
        "### Dry-run (multi-pod 2x16x16, baseline)\n\n"
        + dryrun_table(base, "pod2x16x16"),
        "### Roofline (single pod, baseline)\n\n" + roofline_table(base),
        _host_line(base_dir),
    ])
    opt_tables = "\n\n".join([
        "### Dry-run + roofline (single pod, OPTIMIZED — microbatch=4 for "
        "train cells)\n\n" + roofline_table(opt),
        "### Optimized vs baseline (hillclimbed cells)\n\n"
        + compare_table(base, opt, CELLS),
    ])
    doc = out.read_text() if out.exists() else SKELETON
    start = doc.index("### Dry-run (single pod")
    end = doc.index("Baseline observations")
    doc = doc[:start] + tables + "\n\n" + doc[end:]
    doc = doc.replace("OPTIMIZED_TABLES_PLACEHOLDER", opt_tables)
    doc = doc.replace("SUMMARY_PLACEHOLDER", summary(base, opt))
    out.write_text(doc)
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", default="dryrun_torch")
    ap.add_argument("--opt", default="dryrun_torch_opt")
    ap.add_argument("--out", default="EXPERIMENTS_torch.md")
    args = ap.parse_args(argv)
    out = ROOT / args.out
    doc = render(args.base, args.opt, out)
    print(f"{out.name} regenerated:", len(doc.splitlines()), "lines")


if __name__ == "__main__":
    main()
