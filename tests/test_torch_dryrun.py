"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: every
family and every kind of cell runs on a small fake mesh and writes the
reference's record, resumably; ``launch/train.py --dry-run`` delegates to
it; ``--device cuda`` without a card fails rather than running on the CPU.

The fake process group is one per process, so the cells run in
subprocesses.  There, the reduced configs run at shapes shrunk in place
(the names and kinds of ``launch/shapes.py``, small sequences and
batches): the full shapes' attention loops dispatch millions of ops."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.shapes import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.models import get_config  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
TINY = {"train_4k": (64, 8), "prefill_32k": (128, 4), "decode_32k": (64, 8),
        "long_500k": (256, 1)}
# (arch, shape, mesh): every family, every kind, both mesh ranks
CELLS = [("qwen2-0.5b", "train_4k", "2x2"),
         ("qwen2-0.5b", "long_500k", "2x2"),          # skipped
         ("gemma2-27b", "prefill_32k", "2x2x2"),
         ("olmoe-1b-7b", "train_4k", "2x2"),          # expert parallel
         ("granite-moe-1b-a400m", "decode_32k", "2x2"),
         ("rwkv6-7b", "prefill_32k", "2x2"),
         ("rwkv6-7b", "long_500k", "2x2"),
         ("zamba2-7b", "prefill_32k", "2x2x2"),
         ("zamba2-7b", "long_500k", "2x2"),
         ("whisper-large-v3", "train_4k", "2x2"),
         ("llama-3.2-vision-11b", "prefill_32k", "2x2"),
         ("llama-3.2-vision-11b", "decode_32k", "2x2x2")]
# the reference's record (src/repro/launch/dryrun.py run_cell), with its
# lower_s and compile_s folded into run_s
OK_KEYS = {"arch", "shape", "mesh", "kind", "params", "active_params",
           "microbatches", "status", "run_s", "chips",
           "arg_bytes_per_device", "memory_analysis", "xla_cost", "hlo_cost",
           "collectives", "model_flops", "roofline", "uneven_sharding",
           "hlo_bytes", "wall_s"}

_CELLS = r"""
import json, pathlib, sys, time
from repro_torch.launch import dryrun, mesh as ME, shapes
from repro_torch.launch.shapes import ShapeSpec
tiny, cells, outdir = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
ME.fake_group(8)
for name, (seq, batch) in tiny.items():
    shapes.SHAPES[name] = ShapeSpec(name, seq, batch, shapes.SHAPES[name].kind)
out = {}
for arch, shape, mesh in cells:
    mesh = tuple(int(n) for n in mesh.split("x"))
    rec = dryrun.run_cell(arch, shape, False, pathlib.Path(outdir),
                          force=True, device="cpu", reduced=True,
                          mesh_shape=mesh)
    path = pathlib.Path(outdir) / f"{arch}__{shape}__{rec['mesh']}.json"
    stamp = path.stat().st_mtime_ns
    time.sleep(0.01)
    again = dryrun.run_cell(arch, shape, False, pathlib.Path(outdir),
                            device="cpu", reduced=True, mesh_shape=mesh)
    out[f"{arch}|{shape}"] = {"rec": rec, "resumed": again == rec
                              and path.stat().st_mtime_ns == stamp}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("dryrun")
    r = subprocess.run(
        [sys.executable, "-c", _CELLS, json.dumps(TINY), json.dumps(CELLS),
         str(outdir)], capture_output=True, text=True, timeout=600,
        cwd=str(ROOT), env=ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_cell_runs_and_writes_the_reference_record(records, cell):
    arch, shape, mesh = cell
    got = records[f"{arch}|{shape}"]
    rec = got["rec"]
    assert got["resumed"]
    cfg = get_config(arch).reduced()
    if shape == "long_500k" and not cfg.supports_long_context:
        assert rec["status"] == "skipped" and "quadratic" in rec["reason"]
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == OK_KEYS
    chips = 1
    for n in mesh.split("x"):
        chips *= int(n)
    assert rec["chips"] == rec["roofline"]["chips"] == chips
    seq, batch = TINY[shape]
    spec = ShapeSpec(shape, seq, batch, SHAPES[shape].kind)
    assert rec["model_flops"] == dryrun.model_flops(cfg, spec)
    cost = rec["hlo_cost"]
    assert cost["flops"] > 0 and cost["traffic_bytes"] > 0
    assert rec["xla_cost"] == {"flops": cost["flops"],
                               "bytes accessed": cost["traffic_bytes"]}
    assert rec["memory_analysis"]["peak_live_bytes"] >= \
        rec["arg_bytes_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["collectives"]["total_bytes"] == \
        cost["total_collective_bytes"] > 0
    if cfg.family == "moe":                 # the experts' outputs combined
        assert rec["collectives"]["count_by_kind"]["all-reduce"] > 0


def test_cli_runs_a_cell_and_refuses_a_missing_card(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "long_500k", "--both", "--device", "cpu",
         "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT), env=ENV)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "done: 0 ok, 2 skipped, 0 errors"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "qwen2-0.5b__long_500k__pod16x16.json",
        "qwen2-0.5b__long_500k__pod2x16x16.json"]
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={**ENV, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "done:" not in r.stdout


def test_train_dry_run_delegates(monkeypatch):
    """``launch/train.py --dry-run`` runs the dry run's CLI in a process of
    its own, as the reference's does, with the device passed on."""
    from repro_torch.launch import train
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd: calls.append(cmd) or 0)
    with pytest.raises(SystemExit) as exit_:
        train.main(["--arch", "qwen2-7b", "--dry-run", "--device", "cpu"])
    assert exit_.value.code == 0
    assert calls == [[sys.executable, "-m", "repro_torch.launch.dryrun",
                      "--arch", "qwen2-7b", "--shape", "train_4k", "--both",
                      "--force", "--device", "cpu"]]


def test_op_listing_accounts_for_every_flop(tmp_path):
    """``scripts/torch_dryrun_ops.py`` lists a production cell's products a
    device: the listed FLOPs add up to the cell's count, and the listing
    holds the cell's products (olmoe-1b-7b ``decode_32k``: the router's,
    the experts' batched ones)."""
    out = tmp_path / "ops.json"
    r = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_dryrun_ops.py"),
         "olmoe-1b-7b", "decode_32k", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT), env=ENV)
    assert r.returncode == 0, r.stderr[-2000:]
    row = json.loads(out.read_text())
    assert json.loads(r.stdout.strip().splitlines()[-1]) == row
    assert row["cell"] == "olmoe-1b-7b:decode_32k:pod16x16"
    assert sum(f for _, f in row["dots"].values()) == row["flops"] > 0
    assert sum(n for n, _ in row["dots"].values()) == \
        row["ops"]["aten.mm"] + row["ops"]["aten.bmm"]
    assert any(k.startswith("aten.bmm") for k in row["dots"])
