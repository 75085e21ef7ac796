"""Nothing the benchmark runs imports JAX or the JAX package, comparing the
top-level name whole (``repro_torch`` is not ``repro``); the reference
modules, the shared one among them, import nothing of the program; no
driver names a reference module: the configuration's ``reference`` key
does."""
import ast
import os
import subprocess
import sys

import pytest

from perfbench import cells

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(HERE) for f in fs
               if f.endswith(".py"))


def _tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_nor_jax_package(path):
    assert not set(_tops(path)) & {"jax", "jaxlib", "flax", "repro"}


REFERENCE = [f for f in FILES if "/reference/" in f]


@pytest.mark.parametrize("path", REFERENCE, ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_tops(path))


def test_every_reference_module_is_checked():
    """The shared module, the MoE decoder's and the dense fixture's."""
    assert {"common.py", "moe_lm.py", "dense_lm.py"} <= \
        {os.path.basename(f) for f in REFERENCE}


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("name", ["run.py", "train_driver.py", "serve_driver.py",
                                  "calibrate.py", "weights.py", "counts.py"])
def test_no_driver_names_a_reference_module(name):
    mods = set(_imported(os.path.join(HERE, name)))
    assert not {m for m in mods if m.startswith("perfbench.reference.")
                and m.split(".")[2] != "common"}, mods


def test_a_run_loads_no_jax():
    """A whole run in a fresh process: nothing of JAX or the JAX package
    is in ``sys.modules`` when the result is printed."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny\n"
        "from perfbench import run\n"
        "rc = run.main(['--workload', 'granite-moe-1b-a400m.train-4k', '--seed',"
        " '3', '--seconds', '0.3'], device='cpu', overrides=tiny('train'))\n"
        "assert rc == 0 and not run.forbidden_loaded(), run.forbidden_loaded()\n"
        % (os.path.join(HERE, "tests"), cells.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]


def test_no_card_no_result():
    """Without a card the benchmark exits with an error and prints nothing."""
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                          "--workload", "granite-moe-1b-a400m.train-4k", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
