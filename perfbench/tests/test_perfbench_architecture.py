"""A configuration of an architecture that the benchmark has not run enters
it as new files only: a copy of the harness with a dense decoder's reference
module (``reference/dense_lm.py`` beside this file), its configuration file
(``configs/starcoder2-7b.json``), a train cell and its limits runs on the
CPU at a small size to ``correct`` true with ``mfu.train`` read, and no file
that was there changes.  The same copy whose configuration file differs
from the port's registered config in one port field exits 3."""
import filecmp
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import TRAIN
from perfbench import cells

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "granite-moe-1b-a400m.train-4k"
NEW = "starcoder2-7b.train-4k"
# the dense decoder at widths the CPU holds, float32
DENSE_TINY = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
              "head_dim": 16, "d_ff": 128, "vocab_size": 256, "dtype": "float32"}


def _checkout(tmp_path, **edit):
    """A checkout with the dense architecture added; ``edit`` changes keys
    of its configuration file."""
    bench = cells.benchmark()
    cfg = json.load(open(os.path.join(HERE, "configs", "starcoder2-7b.json")))
    cfg.update(edit)
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": "perfbench/configs/starcoder2-7b.json",
                             "reduced": [], "why": "a dense decoder"})
    bench["workloads"].append({"name": NEW, "config": cfg["name"],
                               "traffic": "train-4k", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(NEW)
    root = tmp_path / "checkout"
    pb = root / "perfbench"
    shutil.copytree(cells.HERE, pb, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    new = {"reference/dense_lm.py": None, "configs/starcoder2-7b.json": cfg,
           f"limits/{NEW}.json": cells.run_limits(CELL)}
    for rel, data in new.items():
        assert not (pb / rel).exists(), rel
        if data is None:
            shutil.copy(os.path.join(HERE, rel), pb / rel)
        else:
            (pb / rel).write_text(json.dumps(data))
    for d, _, files in os.walk(cells.HERE):
        if "__pycache__" in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), cells.HERE)
            assert filecmp.cmp(os.path.join(d, f), pb / rel, shallow=False), rel
    return root


def _run(root, trace: int):
    ov = {"config": dict(DENSE_TINY), "traffic": dict(TRAIN)}
    code = (
        "import json, sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench import run\n"
        "assert run.__file__.startswith(%r)\n"
        "sys.exit(run.main(['--workload', %r, '--seed', str(2**31 + 23),"
        " '--seconds', '0.3', '--trace', '%d'], device='cpu',"
        " overrides=json.loads(%r)))\n"
        % (str(root), os.path.join(cells.ROOT, "src"), str(root), NEW, trace,
           json.dumps(ov)))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(root))


@pytest.mark.parametrize("trace", [0, 1])
def test_dense_architecture_as_new_files(tmp_path, trace):
    out = _run(_checkout(tmp_path), trace)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    if trace:
        assert last["metrics"]["mfu.train"]["value"] > 0
    else:
        assert set(last["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_dense_architecture_with_a_port_field_changed(tmp_path):
    out = _run(_checkout(tmp_path, num_kv_heads=6), 0)
    assert out.returncode == 3, out.stderr[-2000:]
    assert "num_kv_heads: file 6, port 4" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("ref", ["", "perfbench/reference/common", "perfbench/../run.py",
                                 "perfbench/reference/../run.py", "src/repro_torch/models/moe.py",
                                 "perfbench/reference/no_such_module.py"])
def test_reference_is_a_module_of_perfbench_reference(ref):
    with pytest.raises(KeyError):
        cells.reference({"reference": ref})
