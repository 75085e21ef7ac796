"""The port's compiler-side twins against the reference's, live, on the CPU:
``benchmarks/{paper_tables,banking_ablation}_torch.py`` through
``benchmarks/run_torch.py`` against ``benchmarks/run.py``,
``scripts/verify_matrix_torch.py`` against ``scripts/verify_matrix.py`` and
``scripts/lint_design_torch.py`` against ``scripts/lint_design.py``.

Each side runs in a process of its own.  The compiler passes are the same
code in both packages, so the lines' names and ``derived`` fields, the
verifier's report and the linter's output are equal; the ``us_per_call``
column (host compile times) and the verifier's final wall time are not
compared.  The MoE dispatch census is the one line that counts otherwise:
the reference counts gathers in compiled HLO, the port the index reads of
an eager call (``OpCounter.op_counts``); in both, banked reads fewer slices
than gather.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}",
       "JAX_PLATFORMS": "cpu"}


def _py(args, timeout=300):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=str(ROOT), env=ENV, timeout=timeout)


def _lines(stdout: str):
    """(name, derived) of every CSV line."""
    out = []
    for line in stdout.splitlines():
        if line.startswith("#"):
            continue
        name, _, derived = line.split(",", 2)
        out.append((name, derived))
    return out


@pytest.fixture(scope="module")
def sections():
    """{section: (reference lines, port lines)}."""
    got = {}
    for section in ("paper_tables", "banking_ablation"):
        ref = _py(["benchmarks/run.py", section])
        port = _py(["benchmarks/run_torch.py", section, "--device", "cpu"])
        assert ref.returncode == 0, ref.stderr[-3000:]
        assert port.returncode == 0, port.stderr[-3000:]
        got[section] = (_lines(ref.stdout), _lines(port.stdout))
    return got


def test_paper_tables_equal_the_reference(sections):
    ref, port = sections["paper_tables"]
    assert len(port) == 35 and port == ref


def test_paper_tables_headline_numbers(sections):
    _, port = sections["paper_tables"]
    derived = dict(port)
    assert derived["fig3_speedup_1to2"] == "2.38|paper=2.4"
    assert derived["fig3_speedup_2to4"] == "2.95|paper=3.05"
    assert derived["table2_ffnn_f4_lut"] == "44590|paper=49121"


@pytest.mark.parametrize("prefix", ["ablate_", "restructure_", "portmodel_",
                                    "share_"])
def test_banking_ablation_sections_equal_the_reference(sections, prefix):
    ref, port = sections["banking_ablation"]
    want = [ln for ln in ref if ln[0].startswith(prefix)]
    assert want and [ln for ln in port if ln[0].startswith(prefix)] == want


def test_moe_census_reads_fewer_slices_banked(sections):
    ref, port = sections["banking_ablation"]
    names = [n for n, _ in ref if n.startswith("moe_")]
    assert names == ["moe_banked_us_per_call", "moe_gather_us_per_call"]
    assert [n for n, _ in port if n.startswith("moe_")] == names
    for lines in (ref, port):
        d = dict(lines)
        banked, gather = (int(re.fullmatch(r"gather_ops=(\d+)", d[n]).group(1))
                          for n in names)
        assert banked < gather
    assert len(port) == len(ref)


def test_op_counter_counts_ops_by_name():
    from repro_torch.launch.op_analysis import OpCounter
    w = torch.arange(24.0).reshape(6, 4)
    idx = torch.tensor([0, 2, 5])
    with OpCounter() as c:
        a = w[idx]                                  # index
        b = torch.index_select(w, 0, idx)           # index_select
        g = torch.gather(w, 1, torch.zeros(6, 1, dtype=torch.long))
        s = (a + b).sum() + g.sum()                 # add, sum, sum, add
        buf = torch.zeros(6, 4)
        buf.index_put_((idx,), a, accumulate=True)  # index_put_ (a write)
    assert c.op_counts["index"] == 1
    assert c.op_counts["index_select"] == 1
    assert c.op_counts["gather"] == 1
    assert c.op_counts["add"] == 2 and c.op_counts["sum"] == 2
    assert c.op_counts["index_put_"] == 1
    assert c.slice_reads() == 3
    assert sum(c.op_counts.values()) == c.ops
    assert float(s) > 0


def test_verify_matrix_equals_the_reference():
    ref = _py(["scripts/verify_matrix.py"])
    port = _py(["scripts/verify_matrix_torch.py"])
    assert ref.returncode == port.returncode == 0, port.stdout[-2000:]
    wall = re.compile(r" \([0-9.]+s\)$")
    assert [wall.sub("", ln) for ln in port.stdout.splitlines()] == \
        [wall.sub("", ln) for ln in ref.stdout.splitlines()]
    assert "OK: 48 points x verify, 192 stage reports, all clean" in port.stdout


@pytest.mark.parametrize("args", [
    "--model ffnn --factor 2",
    "--model attention --factor 4 --no-share",
    "--model ffnn --factor 2 --mode branchy",
    "--model ffnn --factor 4 --profile",
])
def test_lint_design_equals_the_reference(args):
    ref = _py(["scripts/lint_design.py", *args.split()])
    port = _py(["scripts/lint_design_torch.py", *args.split()])
    assert port.returncode == ref.returncode == 0, port.stderr[-2000:]
    assert port.stdout == ref.stdout
    assert "\nOK: " in port.stdout


def test_lint_design_refuses_mha_at_factor_4():
    """The paper's MHA conflicts on banks at factor 4 (42 rows): both exit 1
    with the same ``BankConflictError`` message."""
    ref = _py(["scripts/lint_design.py", "--model", "mha", "--factor", "4"])
    port = _py(["scripts/lint_design_torch.py", "--model", "mha", "--factor", "4"])
    assert ref.returncode == port.returncode == 1
    assert port.stdout == ref.stdout

    def message(stderr):
        last = stderr.strip().splitlines()[-1]
        cls, _, msg = last.partition(": ")
        return cls.rsplit(".", 1)[-1], msg
    assert message(port.stderr)[0] == "BankConflictError"
    assert message(port.stderr) == message(ref.stderr)
    assert "repro_torch.core.banking.BankConflictError" in port.stderr
