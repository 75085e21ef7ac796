"""What a cell is made of, found by name from ``BENCHMARK.json``.

A workload names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); the mix's ``kind`` names the driver that
plays it (``<kind>_driver.py``); the comparison's limits are in
``limits/<workload>.json``; each per-layer metric is read by
``metrics/<metric>.py``.  The configuration's ``reference`` key names the
module of ``reference/`` that holds its architecture: its weight tree, its
loss and, for serving, its logits (``reference/common.py``); the FLOP
counts are taken from that tree (``counts.py``).  So a configuration of an
architecture the benchmark has not run is a configuration file and a
reference module.  Adding a cell, a mix, a kind of traffic, a
configuration, an architecture or a metric adds files and entries: nothing
here names one.
"""
from __future__ import annotations

import dataclasses
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


def reference(c: Dict):
    """The module of ``reference/`` that the configuration's ``reference``
    key names (``perfbench/reference/<module>.py``)."""
    m = re.fullmatch(r"perfbench/reference/([a-z][a-z0-9_]{0,63})\.py",
                     c.get("reference", ""))
    if not m or not os.path.exists(os.path.join(HERE, "reference",
                                                m.group(1) + ".py")):
        raise KeyError(f"reference {c.get('reference')!r} is no module of "
                       "perfbench/reference/")
    return importlib.import_module(f"perfbench.reference.{m.group(1)}")


# the port keys that the MoE configuration files hold; the harness compares
# ``port_keys``, a superset, and ``scripts/torch_train_ranges.py`` still
# reads this tuple
PORT_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
             "d_ff", "vocab_size", "num_experts", "experts_per_token",
             "moe_capacity_factor", "rope_theta", "norm_eps", "tie_embeddings",
             "act", "dtype", "family", "moe_dispatch")


def port_keys(c: Dict, port_cfg) -> List[str]:
    """The keys of the configuration file that are fields of the port's
    config ``port_cfg`` (a dataclass), in field order."""
    return [f.name for f in dataclasses.fields(port_cfg) if f.name in c]


def check_port_config(c: Dict, port_cfg) -> List[str]:
    """Where the configuration file and the port's registered config
    differ, over every key of the file that is a field of the port's
    config: (key, file value, port value) lines; empty when they agree."""
    bad = []
    for k in port_keys(c, port_cfg):
        if c[k] != getattr(port_cfg, k):
            bad.append(f"{k}: file {c[k]!r}, port {getattr(port_cfg, k)!r}")
    return bad


def run_limits(workload: str) -> Optional[Dict]:
    path = os.path.join(HERE, "limits", f"{workload}.json")
    return _json(path) if os.path.exists(path) else None
