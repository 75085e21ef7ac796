"""The dry run's report tooling: ``benchmarks/make_report_torch.py``,
``benchmarks/fix_artifacts_torch.py`` and ``scripts/gen_experiments_torch.py``
against their references, and the committed ``EXPERIMENTS_torch.md``.

The records come from the port's dry run on the CPU (reduced configs at
shapes shrunk in place, fake 2x2 and 2x2x2 meshes, in a subprocess, as
``tests/test_torch_dryrun.py`` runs them) and are relabelled
``pod16x16`` / ``pod2x16x16``, the meshes the tables select.

* ``make_report_torch``'s tables equal ``benchmarks/make_report.py``'s, line
  for line, on the same records with ``run_s`` mapped to ``compile_s`` and
  ``peak_live_bytes`` to ``temp_size_in_bytes``, save the two headers (and
  the memory row's name in the comparison).  The reference imports nothing
  of ``repro``, so it runs in this process.
* ``fix_artifacts_torch.fix_dir`` restores stale records bit for bit and
  leaves ``skipped`` ones alone; its ``model_flops`` equals the reference's
  ``fix_artifacts.fix_dir`` on a copy of the same records (in a subprocess:
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` on import).
* ``gen_experiments_torch`` writes a document from its skeleton, then
  splices it again, keeping the prose under "Baseline observations"; a cell
  missing from a sweep is named and left out of the summary.
* The committed ``EXPERIMENTS_torch.md``: all 80 cells (64 ``ok``, 16
  ``SKIP``, no error), the three optimized cells, qwen2-0.5b ``train_4k``
  at 4 microbatches with the same dot FLOPs a device (within 1%) and a
  lower peak of live bytes, the card named.
"""
import copy
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from benchmarks import fix_artifacts_torch, make_report  # noqa: E402
from benchmarks import make_report_torch  # noqa: E402
import gen_experiments_torch  # noqa: E402
from repro_torch.launch.shapes import ShapeSpec  # noqa: E402
from repro_torch.models import get_config  # noqa: E402

ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
ENV.pop("REPRO_MICROBATCH", None)
TINY = {"train_4k": (64, 8), "prefill_32k": (128, 4), "decode_32k": (64, 8),
        "long_500k": (256, 1)}
MESHES = {"2x2": "pod16x16", "2x2x2": "pod2x16x16"}
# (arch, shape, mesh, microbatches): the optimized sweep at 2 microbatches
# leaves gemma2-27b out, which the summary must name
CELLS = [("qwen2-0.5b", "train_4k", "2x2", 1),
         ("qwen2-0.5b", "long_500k", "2x2", 1),           # skipped
         ("olmoe-1b-7b", "train_4k", "2x2", 1),
         ("gemma2-27b", "train_4k", "2x2", 1),
         ("rwkv6-7b", "decode_32k", "2x2x2", 1),
         ("qwen2-0.5b", "prefill_32k", "2x2x2", 1),
         ("qwen2-0.5b", "train_4k", "2x2", 2),
         ("olmoe-1b-7b", "train_4k", "2x2", 2)]

_CELLS = r"""
import json, os, pathlib, sys
from repro_torch.launch import dryrun, mesh as ME, shapes
from repro_torch.launch.shapes import ShapeSpec
tiny, cells, meshes, root = (json.loads(sys.argv[1]), json.loads(sys.argv[2]),
                             json.loads(sys.argv[3]), pathlib.Path(sys.argv[4]))
ME.fake_group(8)
for name, (seq, batch) in tiny.items():
    shapes.SHAPES[name] = ShapeSpec(name, seq, batch, shapes.SHAPES[name].kind)
for arch, shape, mesh, m in cells:
    os.environ["REPRO_MICROBATCH"] = str(m)
    outdir = root / ("base" if m == 1 else "opt")
    rec = dryrun.run_cell(arch, shape, False, outdir, force=True, device="cpu",
                          reduced=True,
                          mesh_shape=tuple(int(n) for n in mesh.split("x")))
    assert rec["status"] in ("ok", "skipped"), rec.get("traceback")
    path = outdir / f"{arch}__{shape}__{rec['mesh']}.json"
    rec["mesh"] = meshes[mesh]                 # the label the tables select
    path.unlink()
    (outdir / f"{arch}__{shape}__{rec['mesh']}.json").write_text(
        json.dumps(rec, indent=1))
"""


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    r = subprocess.run(
        [sys.executable, "-c", _CELLS, json.dumps(TINY), json.dumps(CELLS),
         json.dumps(MESHES), str(root)], capture_output=True, text=True,
        timeout=600, cwd=str(ROOT), env=ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    return root


def _as_reference(cells):
    """The port's records under the reference's key names."""
    out = {}
    for key, r in cells.items():
        r = copy.deepcopy(r)
        if r["status"] == "ok":
            r["compile_s"] = r["run_s"]
            r["memory_analysis"]["temp_size_in_bytes"] = \
                r["memory_analysis"]["peak_live_bytes"]
        out[key] = r
    return out


def _tables(mod, base, opt):
    return {"single": mod.dryrun_table(base, "pod16x16"),
            "multi": mod.dryrun_table(base, "pod2x16x16"),
            "roofline": mod.roofline_table(base),
            "roofline_opt": mod.roofline_table(opt),
            "compare": mod.compare_table(base, opt, gen_experiments_torch.CELLS)}


@pytest.mark.parametrize("table", ["single", "multi", "roofline",
                                   "roofline_opt", "compare"])
def test_tables_equal_the_reference(sweep, table):
    base = make_report_torch.load(str(sweep / "base"))
    opt = make_report_torch.load(str(sweep / "opt"))
    got = _tables(make_report_torch, base, opt)[table].splitlines()
    want = _tables(make_report, _as_reference(base),
                   _as_reference(opt))[table].splitlines()
    assert len(got) == len(want) > 2
    if table in ("single", "multi"):
        assert want[0].endswith("| temp/dev | compile |")
        assert got[0] == want[0].replace("| temp/dev | compile |",
                                         "| peak live/dev | run |")
        got, want = got[1:], want[1:]
    if table == "compare":
        want = [w.replace("| temp/dev |", "| peak live/dev |") for w in want]
        assert sum("| peak live/dev |" in g for g in got) == 2
    assert got == want
    if table == "single":
        assert sum("| ok |" in g for g in got) == 3
        assert sum("SKIP" in g for g in got) == 1


def _main(mod, base, opt, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["x", str(base), str(opt)])
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def test_main_prints_the_reference_report(sweep, tmp_path, monkeypatch):
    """``main`` of both on the same records (the reference's under its key
    names: on the port's own it raises ``KeyError: 'compile_s'``)."""
    with pytest.raises(KeyError, match="compile_s"):
        _main(make_report, sweep / "base", sweep / "opt", monkeypatch)
    for part in ("base", "opt"):
        (tmp_path / part).mkdir()
        cells = _as_reference(make_report_torch.load(str(sweep / part)))
        for (a, s, m), r in cells.items():
            (tmp_path / part / f"{a}__{s}__{m}.json").write_text(json.dumps(r))
    want = _main(make_report, tmp_path / "base", tmp_path / "opt", monkeypatch)
    got = _main(make_report_torch, sweep / "base", sweep / "opt", monkeypatch)
    want = want.replace("| temp/dev | compile |", "| peak live/dev | run |")
    assert got == want.replace("| temp/dev |", "| peak live/dev |")
    assert sum(ln.startswith("###") for ln in got.splitlines()) == 5


def test_make_report_imports_nothing_of_repro():
    probe = ("import sys; sys.path.insert(0, '.'); import benchmarks.make_report; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('repro', 'jax', 'repro_torch', 'torch')))")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=60,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def _stale(d: pathlib.Path):
    """Make every ``ok`` record's model_flops and roofline stale; returns
    each record's bytes before."""
    before = {p.name: p.read_bytes() for p in d.glob("*.json")}
    for p in d.glob("*.json"):
        r = json.loads(p.read_text())
        if r["status"] == "ok":
            r["model_flops"] = 1.0
            r["roofline"] = {"stale": True}
            p.write_text(json.dumps(r, indent=1))
    return before


def test_fix_artifacts_restores_stale_records(sweep, tmp_path, monkeypatch):
    d = tmp_path / "base"
    shutil.copytree(sweep / "base", d)
    before = _stale(d)
    skipped = [n for n, b in before.items()
               if json.loads(b)["status"] == "skipped"]
    assert skipped
    stamps = {n: (d / n).stat().st_mtime_ns for n in skipped}
    # the records were made at reduced size: fix_dir reads the same configs
    # and shapes
    monkeypatch.setattr(fix_artifacts_torch, "get_config",
                        lambda a: get_config(a).reduced())
    monkeypatch.setattr(fix_artifacts_torch, "SHAPES", {
        n: ShapeSpec(n, s, b, k) for n, (s, b), k in
        ((n, TINY[n], fix_artifacts_torch.SHAPES[n].kind) for n in TINY)})
    assert fix_artifacts_torch.fix_dir(d) == len(before) - len(skipped)
    for name, b in before.items():
        assert (d / name).read_bytes() == b, name
    for name in skipped:
        assert (d / name).stat().st_mtime_ns == stamps[name]


_REF_FIX = r"""
import json, pathlib, sys
sys.path.insert(0, ".")
from benchmarks import fix_artifacts
d = pathlib.Path(sys.argv[1])
n = fix_artifacts.fix_dir(d)
print(json.dumps({"n": n, "mf": {p.name: json.loads(p.read_text()).get("model_flops")
                                 for p in sorted(d.glob("*.json"))}}))
"""


def test_fix_artifacts_model_flops_equal_the_reference(sweep, tmp_path):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    for d in (ours, ref):
        shutil.copytree(sweep / "base", d)
        _stale(d)
    n = fix_artifacts_torch.fix_dir(ours)
    r = subprocess.run([sys.executable, "-c", _REF_FIX, str(ref)],
                       capture_output=True, text=True, cwd=str(ROOT),
                       timeout=300, env={**ENV, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    assert want["n"] == n == 5
    got = {p.name: json.loads(p.read_text()).get("model_flops")
           for p in sorted(ours.glob("*.json"))}
    assert got == want["mf"]
    assert all(isinstance(v, float) and v > 1 for v in got.values()
               if v is not None)


def test_gen_experiments_writes_and_splices_keeping_prose(sweep, tmp_path):
    base, opt = tmp_path / "base", tmp_path / "opt"
    shutil.copytree(sweep / "base", base)
    shutil.copytree(sweep / "opt", opt)
    (base / "host.txt").write_text("a test host; --device cpu; torch x\n")
    out = tmp_path / "EXP.md"
    argv = ["--base", str(base), "--opt", str(opt), "--out", str(out)]
    buf = io.StringIO()
    with redirect_stdout(buf):
        gen_experiments_torch.main(argv)
    printed = buf.getvalue()
    assert "left out of the summary: gemma2-27b × train_4k" in printed
    doc = out.read_text()
    assert "PLACEHOLDER" not in doc
    for heading in ("### Dry-run (single pod 16x16, baseline)",
                    "### Dry-run (multi-pod 2x16x16, baseline)",
                    "### Roofline (single pod, baseline)",
                    "### Optimized vs baseline (hillclimbed cells)",
                    "Baseline observations", "### Summary"):
        assert heading in doc
    assert "Records taken on: a test host; --device cpu; torch x" in doc
    summary = [ln for ln in doc.splitlines() if ln.startswith("* **")]
    assert [ln.split("**")[1] for ln in summary] == \
        ["qwen2-0.5b × train_4k", "olmoe-1b-7b × train_4k"]
    assert all("the H100's 80 GB HBM" in ln for ln in summary)
    assert "v5e" not in doc
    # hand-written prose stays; the tables follow the records
    doc = doc.replace("(none written yet)", "Hand-written: the train cells.")
    out.write_text(doc)
    p = base / "qwen2-0.5b__train_4k__pod16x16.json"
    r = json.loads(p.read_text())
    r["run_s"] = 12345.0
    p.write_text(json.dumps(r, indent=1))
    with redirect_stdout(io.StringIO()):
        gen_experiments_torch.main(argv)
    again = out.read_text()
    assert "Hand-written: the train cells." in again
    assert "| 12345s |" in again and "| 12345s |" not in doc
    assert again.count("### Dry-run (single pod 16x16, baseline)") == 1
    assert again.count("### Summary") == 1


# -- the committed document ----------------------------------------------------

EXPERIMENTS = ROOT / "EXPERIMENTS_torch.md"


def _section(doc: str, heading: str):
    body = doc.split(heading, 1)[1].split("###", 1)[0]
    return [ln for ln in body.splitlines() if ln.startswith("| ")][1:]


def test_committed_document_lists_the_whole_sweep():
    from repro_torch.launch.shapes import SHAPES, cell_supported
    from repro_torch.models import all_names
    doc = EXPERIMENTS.read_text()
    rows = {}
    for heading, mesh in (("### Dry-run (single pod 16x16, baseline)", "pod16x16"),
                          ("### Dry-run (multi-pod 2x16x16, baseline)",
                           "pod2x16x16")):
        for ln in _section(doc, heading):
            cols = [c.strip() for c in ln.strip("|").split("|")]
            rows[(cols[0], cols[1], mesh)] = cols[2]
    want = {(a, s, m) for a in all_names() for s in SHAPES
            for m in ("pod16x16", "pod2x16x16")}
    assert set(rows) == want and len(rows) == 80
    for (a, s, m), status in rows.items():
        if cell_supported(get_config(a), s)[0]:
            assert status == "ok", (a, s, m, status)
        else:
            assert status.startswith("SKIP"), (a, s, m, status)
    assert sum(v == "ok" for v in rows.values()) == 64
    assert not re.search(r"\bERROR\b", doc)
    opt = {tuple(c.strip() for c in ln.strip("|").split("|")[:2]) for ln in
           _section(doc, "### Dry-run + roofline (single pod, OPTIMIZED")}
    assert opt == set(gen_experiments_torch.CELLS)


def test_committed_document_holds_the_microbatched_cell():
    doc = EXPERIMENTS.read_text()
    cmp = {}
    for ln in _section(doc, "### Optimized vs baseline (hillclimbed cells)"):
        cols = [c.strip() for c in ln.strip("|").split("|")]
        cmp[(cols[0], cols[1])] = float(cols[4].rstrip("%x"))
    for a, s in gen_experiments_torch.CELLS:
        cell = f"{a}×{s}"
        assert abs(cmp[(cell, "compute_s")]) <= 1.0, cell
        assert cmp[(cell, "peak live/dev")] < 0, cell


def test_committed_document_names_the_card():
    doc = EXPERIMENTS.read_text()
    line = [ln for ln in doc.splitlines()
            if ln.startswith("Records taken on: ")]
    assert len(line) == 1
    assert re.match(r"Records taken on: NVIDIA H100[^,]*, \d+\.\d+ W; "
                    r"--device cuda; torch \S+$", line[0]), line[0]
    assert "v5e" not in doc and "TPU" not in doc


def test_roofline_report_reads_both_sweeps(sweep, tmp_path, monkeypatch):
    """``roofline_report_torch`` enriches its lines with both sweeps, as the
    reference reads ``dryrun_baseline`` and ``dryrun_opt``."""
    from benchmarks import roofline_report_torch as RR
    shutil.copytree(sweep / "base", tmp_path / "dryrun_torch")
    shutil.copytree(sweep / "opt", tmp_path / "dryrun_torch_opt")
    monkeypatch.setattr(RR, "ARTIFACTS", tmp_path)
    monkeypatch.delenv("MODEL_BENCH_OUT", raising=False)
    lines = []
    RR.run(lambda name, us, derived: lines.append((name, us, derived)))
    want = {f"{prefix}{a}_{s}_{MESHES[m]}": m_ for a, s, m, m_ in CELLS
            for prefix in (("roofline_torch_",) if m_ == 1
                           else ("roofline_torch_opt_",))}
    got = {n: d for n, _, d in lines if n.startswith("roofline_torch_")}
    assert set(got) == set(want)
    assert got["roofline_torch_qwen2-0.5b_long_500k_pod16x16"].startswith("SKIP:")
    assert all(d.startswith("dom=") for n, d in got.items()
               if "long_500k" not in n)
