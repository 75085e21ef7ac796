"""The port stands alone: importing it, or its drivers
(``examples/serve_batched_torch.py``, ``examples/train_lm_torch.py``,
``examples/compile_to_calyx_torch.py``, ``examples/banking_sweep_torch.py``,
the benchmark twins ``benchmarks/*_torch.py``, their runner
``benchmarks/run_torch.py`` and the script twins
``scripts/{verify_matrix,lint_design,gen_experiments,dryrun_sweep}_torch.py``),
loads neither JAX nor ``repro``."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, sys
import repro_torch, repro_torch.core, repro_torch.core.cuda_backend
import repro_torch.kernels.ops, repro_torch.kernels.banked_matmul
import repro_torch.kernels.flash_attention, repro_torch.kernels.ssm_scan
import repro_torch.kernels.banked_conv2d, repro_torch.kernels.ref
import repro_torch.kernels.checks
import repro_torch.core.torch_backend, repro_torch.device
import repro_torch.models, repro_torch.models.config, repro_torch.models.common
import repro_torch.models.params, repro_torch.models.mlp
import repro_torch.models.attention, repro_torch.models.transformer
import repro_torch.models.decode, repro_torch.configs
import repro_torch.models.ssm_ops, repro_torch.models.rwkv
import repro_torch.models.mamba, repro_torch.models.moe
import repro_torch.obs, repro_torch.obs.metrics, repro_torch.obs.spans
import repro_torch.obs.traffic, repro_torch.obs.modelprof
import repro_torch.launch.faults, repro_torch.launch.resilience
import repro_torch.launch.serve
import repro_torch.data.pipeline, repro_torch.optim.adamw
import repro_torch.optim.compression, repro_torch.checkpoint.manager
import repro_torch.runtime.trainer, repro_torch.launch.steps
import repro_torch.launch.train
import repro_torch.sharding, repro_torch.sharding.rules
import repro_torch.launch.mesh, repro_torch.launch.shapes
import repro_torch.launch.dryrun, repro_torch.launch.op_analysis
import repro_torch.launch.op_stats
import importlib.util
for name in ("serve_batched_torch", "train_lm_torch", "compile_to_calyx_torch",
             "banking_sweep_torch"):
    spec = importlib.util.spec_from_file_location(name, f"examples/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for name in ("torch_device", "serve_bench_torch", "resilience_bench_torch",
             "model_profile_bench_torch", "roofline_report_torch",
             "kernel_bench_torch", "paper_tables_torch",
             "banking_ablation_torch", "calyx_bench_torch", "run_torch",
             "make_report_torch", "fix_artifacts_torch"):
    spec = importlib.util.spec_from_file_location(
        f"benchmarks.{name}", f"benchmarks/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
import benchmarks.run_torch as runner
for section in runner.SECTIONS:         # the modules the runner loads
    importlib.import_module(f"benchmarks.{section}_torch")
for name in ("verify_matrix_torch", "lint_design_torch",
             "gen_experiments_torch", "dryrun_sweep_torch"):
    spec = importlib.util.spec_from_file_location(name, f"scripts/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
repro_torch.models.all_names()          # imports the ten config modules
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "repro" or m.startswith("repro."))))
"""


def test_port_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, env=env, cwd=str(ROOT), timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_neither_jax_nor_repro():
    text = (ROOT / "chip_smoke.py").read_text()
    for line in text.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "jaxlib", "repro"), line


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """With no CUDA device, or alone in a directory, it fails and prints no
    result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)], capture_output=True,
                           text=True, cwd=str(script.parent), timeout=120,
                           env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
