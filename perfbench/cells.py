"""What a cell is made of, found by name from ``BENCHMARK.json``.

A workload names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); the mix's ``kind`` names the driver that
plays it (``<kind>_driver.py``); the comparison's limits are in
``limits/<workload>.json``; each per-layer metric is read by
``metrics/<metric>.py``.  Adding a cell, a mix, a kind of traffic, a
configuration or a metric adds files and entries: nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def config(name: str) -> Dict:
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> Dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def cell(bench: Dict, workload: str) -> Dict:
    """The workload's entry, with its metrics: ``end_to_end`` and
    ``per_layer`` are the entries that this cell reports."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = dict(found[0])

    def mine(m: Dict) -> bool:
        return "workloads" not in m or workload in m["workloads"]

    w["end_to_end"] = [m for m in bench["end_to_end"] if mine(m)]
    w["per_layer"] = [m for m in bench["per_layer"] if mine(m)]
    return w


def metric_reader(name: str) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """The module ``<kind>_driver.py`` beside this file, which plays a mix of
    that kind: ``run``, ``end_to_end`` and ``check``."""
    if not re.fullmatch(r"[a-z][a-z0-9_]{0,63}", kind):
        raise KeyError(f"traffic kind {kind!r} is not a module name")
    if not os.path.exists(os.path.join(HERE, f"{kind}_driver.py")):
        raise KeyError(f"no driver perfbench/{kind}_driver.py")
    return importlib.import_module(f"perfbench.{kind}_driver")


# keys of a configuration file that are the port's ModelConfig fields
PORT_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
             "d_ff", "vocab_size", "num_experts", "experts_per_token",
             "moe_capacity_factor", "rope_theta", "norm_eps", "tie_embeddings",
             "act", "dtype", "family", "moe_dispatch")


def check_port_config(c: Dict, port_cfg) -> List[str]:
    """Where the configuration file and the port's registered config
    differ: (key, file value, port value) lines; empty when they agree."""
    bad = []
    for k in PORT_KEYS:
        if k in c and c[k] != getattr(port_cfg, k):
            bad.append(f"{k}: file {c[k]!r}, port {getattr(port_cfg, k)!r}")
    return bad


def run_limits(workload: str) -> Optional[Dict]:
    path = os.path.join(HERE, "limits", f"{workload}.json")
    return _json(path) if os.path.exists(path) else None
