"""The port's Calyx differential matrix (``benchmarks/calyx_bench_torch.py``)
on the CPU against the reference's committed ``BENCH_calyx.json``.

The twin runs the whole 48-point matrix once with ``--device cpu`` into a
temporary directory, in a process of its own (``PYTHONPATH=src:.``, as the
runner), and every field of every record is held equal to the reference's
but the host wall clocks (``compile_us``, ``verify_us``, ``sim_wall_us``,
``trace_wall_us``) and the oracle's error, which must stay within the
matrix's tolerance.  ``scripts/check_perf_regression.py``, unchanged, gates
the output against the committed baseline over the whole matrix (a subset
reads closer to the 15% verifier-overhead limit: ffnn alone is ~14.5%).
That overhead is a ratio of wall clocks: the matrix is run again, three
runs at most, when and only when the gate's one failure is that line.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}",
       "JAX_PLATFORMS": "cpu"}
GATE = ROOT / "scripts" / "check_perf_regression.py"
TRIES = 3
CLOCKS = {"compile_us", "verify_us", "sim_wall_us", "trace_wall_us"}
ORACLE_TOL = 1e-4
VERIFY_OVERHEAD = "FAIL: stage-boundary verifier costs"

REFERENCE = json.loads((ROOT / "BENCH_calyx.json").read_text())
DESIGNS = list(dict.fromkeys(r["design"] for r in REFERENCE["records"]))


def _py(args, env=None, timeout=600):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=str(ROOT), env={**ENV, **(env or {})},
                          timeout=timeout)


def _only_verifier_overhead(gate_stdout: str) -> bool:
    fails = [ln for ln in gate_stdout.splitlines() if ln.startswith("FAIL:")]
    return bool(fails) and all(ln.startswith(VERIFY_OVERHEAD) for ln in fails)


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """(records file, CSV stdout, gate run) of the whole matrix."""
    out = tmp_path_factory.mktemp("calyx") / "calyx.json"
    for attempt in range(1, TRIES + 1):
        r = _py(["benchmarks/calyx_bench_torch.py", "--device", "cpu"],
                {"CALYX_BENCH_OUT": str(out), "CALYX_BENCH_DESIGNS": ""})
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
        gate = _py([str(GATE), "--baseline", str(ROOT / "BENCH_calyx.json"),
                    "--new", str(out)])
        if gate.returncode == 0 or not _only_verifier_overhead(gate.stdout) \
                or attempt == TRIES:
            return json.loads(out.read_text()), r.stdout, gate
    raise AssertionError("unreachable")


def _by_point(records):
    return {(r["design"], r["banks"], r["share"], r["opt_level"]): r
            for r in records}


def test_file_keeps_the_reference_schema(matrix):
    data, _, _ = matrix
    assert data["schema"] == REFERENCE["schema"] == 5
    assert data["generator"] == "benchmarks/calyx_bench_torch.py"
    assert data["device"] == "cpu"
    assert data["opt_geomean_speedup"] == REFERENCE["opt_geomean_speedup"]
    assert len(data["records"]) == len(REFERENCE["records"]) == 48
    assert [list(r) for r in data["records"]] == \
        [list(r) for r in REFERENCE["records"]]


@pytest.mark.parametrize("design", DESIGNS)
def test_records_equal_the_reference(matrix, design):
    """Every framework-free field of the design's 12 points; ``wall_us`` is
    the estimator's cycles over fmax, not a clock, and is equal too."""
    data, _, _ = matrix
    got = _by_point(r for r in data["records"] if r["design"] == design)
    want = _by_point(r for r in REFERENCE["records"] if r["design"] == design)
    assert sorted(got) == sorted(want) and len(got) == 12
    drop = CLOCKS | {"oracle_max_abs_err"}
    for key, ref in want.items():
        rec = got[key]
        assert {k: v for k, v in rec.items() if k not in drop} == \
            {k: v for k, v in ref.items() if k not in drop}, key
        assert rec["wall_us"] == ref["wall_us"]
        assert 0.0 <= rec["oracle_max_abs_err"] <= ORACLE_TOL, key


def test_csv_lines_equal_the_reference(matrix):
    """The emitted names and their ``cycles=|sim=|rtl=|ii=`` parts, in the
    reference's order; then the summary and JSON lines."""
    _, stdout, _ = matrix
    lines = [ln.split(",", 2) for ln in stdout.splitlines()]
    want = [(f"calyx_{r['design']}_f{r['banks']}_"
             f"{'shared' if r['share'] else 'unshared'}_o{r['opt_level']}",
             f"cycles={r['cycles']}|sim={r['sim_cycles']}"
             f"|rtl={r['rtl_cycles']}|ii={r['ii']}")
            for r in REFERENCE["records"]]
    got = [(name, derived.rsplit("|err=", 1)[0]) for name, _, derived in lines[:48]]
    assert got == want
    assert lines[48][0] == "calyx_opt_geomean_speedup"
    assert lines[48][2] == "2.71x over 24 points (opt 0 -> 2)"
    assert lines[49][0] == "calyx_bench_json" and len(lines) == 50


def test_the_gate_passes_over_the_whole_matrix(matrix):
    _, _, gate = matrix
    assert gate.returncode == 0, gate.stdout[-3000:]
    assert "48 points checked" in gate.stdout
    assert "verifier overhead:" in gate.stdout


def test_committed_card_file_equals_the_reference():
    """``BENCH_calyx_torch.json``, the matrix as ``chip_smoke.py`` ran it on
    the card: the same fields as the reference's, the card named, and the
    unchanged gate passing on it."""
    data = json.loads((ROOT / "BENCH_calyx_torch.json").read_text())
    assert "H100" in data["device"] and "W" in data["device"]
    assert data["opt_geomean_speedup"] == REFERENCE["opt_geomean_speedup"]
    drop = CLOCKS | {"oracle_max_abs_err"}
    assert len(data["records"]) == 48
    for rec, ref in zip(data["records"], REFERENCE["records"]):
        assert {k: v for k, v in rec.items() if k not in drop} == \
            {k: v for k, v in ref.items() if k not in drop}
        assert list(rec) == list(ref)
        assert 0.0 <= rec["oracle_max_abs_err"] <= ORACLE_TOL
    gate = _py([str(GATE), "--baseline", str(ROOT / "BENCH_calyx.json"),
                "--new", str(ROOT / "BENCH_calyx_torch.json")])
    assert gate.returncode == 0, gate.stdout[-3000:]


def test_gate_reruns_only_on_the_verifier_overhead():
    assert _only_verifier_overhead(
        "  verifier overhead: 1.0ms of 6.0ms compile = 16.0% (limit 15%) FAIL\n"
        "\nFAIL: stage-boundary verifier costs 16.0% of compile time "
        "(limit 15%)\n")
    assert not _only_verifier_overhead("\nOK: no regressions\n")
    assert not _only_verifier_overhead(
        "\nFAIL: 1 point(s) regressed beyond 2%:\n")
