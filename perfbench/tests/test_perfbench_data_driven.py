"""A later cell is data: a copy of the harness with one more traffic mix,
its workload entry and its limits runs without a change to any file that
was there; so does a mix of a new kind, whose driver is one new file found
by the kind's name."""
import json
import os
import shutil
import subprocess
import sys

from conftest import SERVE_LIMITS, SERVE_WORKLOAD, tiny, with_serve_cell
from perfbench import cells, run

DUMMY_DRIVER = '''"""A mix of kind ``dummy``: a fixed count of steps, each one matmul."""
import time

import torch


def run(cfg_file, port_cfg, spec, params, seed, seconds, trace, device,
        t_start, log):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(spec["n"], spec["n"], generator=g, device=device)
    t0 = time.perf_counter()
    y = x
    for _ in range(spec["steps"]):
        y = torch.tanh(x @ y)
    t1 = time.perf_counter()
    return {"setup_s": t0 - t_start, "window": (t0, t1), "x": x, "y": y,
            "steps": spec["steps"], "trace": None}


def end_to_end(rec, log):
    t0, t1 = rec["window"]
    return {"dummy_steps_per_s": rec["steps"] / max(t1 - t0, 1e-9),
            "setup_s": rec["setup_s"], "_attempted": rec["steps"],
            "_failed": 0}


def check(cfg_file, spec, rec, seed, weights, device, log, limits=None):
    y = rec["x"]
    for _ in range(spec["steps"]):
        y = torch.tanh(rec["x"].double() @ y.double())
    return {"dummy_gap": float((y - rec["y"]).abs().max())}
'''


def _checkout(tmp_path, bench):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(cells.ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, workload, overrides):
    code = (
        "import json, sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench import run\n"
        "assert run.__file__.startswith(%r)\n"
        "sys.exit(run.main(['--workload', %r, '--seed', '5',"
        " '--seconds', '0.3'], device='cpu', overrides=json.loads(%r)))\n"
        % (str(root), os.path.join(cells.ROOT, "src"), str(root), workload,
           json.dumps(overrides)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(root))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_dummy_mix_from_a_temporary_folder(tmp_path):
    bench = with_serve_cell(cells.benchmark())
    bench["workloads"].append({"name": "olmoe-1b-7b.dummy", "config": "olmoe-1b-7b",
                               "traffic": "dummy", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if SERVE_WORKLOAD in m.get("workloads", []):
            m["workloads"].append("olmoe-1b-7b.dummy")
    root = _checkout(tmp_path, bench)
    mix = dict(cells.traffic("decode-c128"), about="a dummy mix",
               prompt={"median": 3, "sigma": 0.2, "min": 2, "max": 4})
    (root / "perfbench" / "traffic" / "dummy.json").write_text(json.dumps(mix))
    (root / "perfbench" / "limits" / "olmoe-1b-7b.dummy.json").write_text(
        json.dumps(SERVE_LIMITS))
    ov = tiny("decode")
    ov["traffic"].pop("prompt")
    last, err = _run(root, "olmoe-1b-7b.dummy", ov)
    assert last["correct"] is True
    assert set(last["metrics"]) == {"decode_tokens_per_s", "ttft_p95_ms",
                                    "itl_p95_ms", "setup_s"}
    assert "olmoe-1b-7b.dummy" in err


def test_new_kind_is_one_driver_file(tmp_path):
    bench = cells.benchmark()
    w = "granite-moe-1b-a400m.dummy"
    bench["workloads"].append({"name": w, "config": "granite-moe-1b-a400m",
                               "traffic": "dummy", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "dummy_steps_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": [w]})
    root = _checkout(tmp_path, bench)
    (root / "perfbench" / "dummy_driver.py").write_text(DUMMY_DRIVER)
    (root / "perfbench" / "traffic" / "dummy.json").write_text(
        json.dumps({"kind": "dummy", "n": 16, "steps": 5}))
    (root / "perfbench" / "limits" / f"{w}.json").write_text(json.dumps(
        {"dummy_gap": {"lower": 1e-7, "limit": 1e-5, "upper": 1.0}}))
    last, _ = _run(root, w, tiny("train"))
    assert last["correct"] is True
    assert set(last["metrics"]) == {"dummy_steps_per_s", "setup_s"}
    assert last["checks"]["dummy_gap"]["limit"] == 1e-5


def test_a_listed_metric_that_reads_nothing_is_named(monkeypatch):
    """A per-layer metric that finds nothing to read is named, so that a run
    on a card fails where a call site it reads has gone."""
    cell = cells.cell(cells.benchmark(), "granite-moe-1b-a400m.train-4k")
    gone = cell["per_layer"][0]["name"]
    orig = cells.metric_reader
    monkeypatch.setattr(cells, "metric_reader", lambda name: (
        (lambda r: None) if name == gone else (lambda r: 1.0)))
    metrics, missing = run.read_per_layer(cell, None)
    assert missing == [gone] and gone not in metrics
    assert set(metrics) == {m["name"] for m in cell["per_layer"]} - {gone}
    assert callable(orig(gone))
