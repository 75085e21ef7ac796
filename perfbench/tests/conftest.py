"""The harness's CPU tests: the repository root and ``src`` on the path, the
small sizes at which they drive the harness on the CPU, and the serving cell
that ``BENCHMARK.json`` does not hold yet (``serve_cell.json``), added to the
benchmark for the tests that drive it."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# widths small enough for the CPU, float32, every layer kind kept
TINY = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 16, "d_ff": 32, "vocab_size": 256, "num_experts": 8,
        "experts_per_token": 2, "dtype": "float32"}
SERVE = {"clients": 4, "slots": 4, "max_len": 96, "requests_per_client": 8,
         "prompt": {"median": 6, "sigma": 0.5, "min": 2, "max": 12},
         "output": {"median": 8, "sigma": 0.4, "min": 3, "max": 16},
         "trace_steps": 4, "check_tokens": 30}
TRAIN = {"batch": 2, "seq_len": 64, "pool": 4,
         "doc_len": {"median": 16, "sigma": 1.0, "min": 4, "max": 64}}


def tiny(workload: str, limits=None) -> dict:
    ov = {"config": dict(TINY),
          "traffic": dict(TRAIN if "train" in workload else SERVE)}
    if limits is not None:
        ov["limits"] = limits
    return ov


SERVE_WORKLOAD = "olmoe-1b-7b.decode-c128"
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "serve_cell.json")) as _f:
    SERVE_CELL = json.load(_f)
# the serving check at the tiny float32 size: the program's error is round-off
SERVE_LIMITS = {"logit_err_share": {"margin": 0.06, "lower": 0.0,
                                    "limit": 0.1, "upper": 0.75}}


def with_serve_cell(bench: dict) -> dict:
    """``bench`` with the serving cell's configuration, workload and
    metrics added."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in bench.items()}
    for k, entries in SERVE_CELL.items():
        have = {e["name"] for e in out[k]}
        out[k] += [e for e in entries if e["name"] not in have]
    setup = [m for m in out["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    return out


@pytest.fixture
def serve_cell(monkeypatch):
    """``cells.benchmark()`` with the serving cell in it."""
    from perfbench import cells
    bench = with_serve_cell(cells.benchmark())
    monkeypatch.setattr(cells, "benchmark", lambda: bench)
    return bench
