"""The port's benchmark twins (``benchmarks/*_torch.py``) on the CPU against
the reference's committed records.

Each twin runs its smallest setting with ``--device cpu`` into a temporary
directory, in a process of its own (``PYTHONPATH=src:.``, as the runner),
and its seeded, framework-free fields are held equal to the reference's
committed ``BENCH_serve.json``, ``BENCH_resilience.json`` and
``BENCH_model.json``; no JAX runs, except the one live comparison: the
reference's ``serve_bench`` writes its smoke qwen2-0.5b stable span stream
through ``SERVE_BENCH_SPANS_DIR`` and the twin's must be the same bytes.
``scripts/check_perf_regression.py``, unchanged, gates each output's
contract.  Its overhead checks read wall clocks: a twin is run again, three
runs at most, when and only when every failure the gate reports is such a
wall-clock overhead; any other failure fails at once.  Wall clocks are never
compared across packages.
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

SERVE_FIELDS = ("steps", "completed", "truncated", "tokens_generated",
                "tokens_prefill", "span_events", "slot_utilization",
                "deterministic")
MODEL_FIELDS = ("steps", "layer_records", "ops_per_step", "cache_len",
                "deterministic")
MODEL_ARCHS = ("qwen2-0.5b", "rwkv6-7b", "olmoe-1b-7b")
WALL_CLOCK_ONLY = ("trace overhead", "zero-fault overhead", "record overhead")


def _reference(name):
    return json.loads((ROOT / name).read_text())["records"]


def _py(args, env=None, timeout=300):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=str(ROOT), env={**ENV, **(env or {})},
                          timeout=timeout)


def _gate_failures(stdout):
    return [line for line in stdout.splitlines() if line.startswith("FAIL:")]


def _wall_clock_only(failures):
    return bool(failures) and all(any(w in f for w in WALL_CLOCK_ONLY)
                                  for f in failures)


def _twin(args, env, out, gate_flag, tries=TRIES):
    """Run a twin, then the gate on its output; repeat while the gate's only
    failures are wall-clock overheads.  Returns (records file, gate run)."""
    for attempt in range(1, tries + 1):
        r = _py(args, env)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
        gate = _py([str(GATE), gate_flag, str(out)])
        failures = _gate_failures(gate.stdout)
        if gate.returncode == 0 or not _wall_clock_only(failures) \
                or attempt == tries:
            return json.loads(out.read_text()), gate
    raise AssertionError("unreachable")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("bench")


@pytest.fixture(scope="module")
def serve(work):
    out = work / "serve.json"
    env = {"SERVE_BENCH_PROFILES": "smoke", "SERVE_BENCH_OUT": str(out),
           "SERVE_BENCH_SPANS_DIR": str(work / "spans_port")}
    return _twin(["benchmarks/serve_bench_torch.py", "--device", "cpu"], env,
                 out, "--serve-new")


@pytest.fixture(scope="module")
def resilience(work):
    out = work / "resilience.json"
    return _twin(["benchmarks/resilience_bench_torch.py", "--smoke",
                  "--device", "cpu", "--out", str(out)], {}, out,
                 "--resilience-new")


@pytest.fixture(scope="module")
def model(work):
    out = work / "model.json"
    return _twin(["benchmarks/model_profile_bench_torch.py", "--device", "cpu"],
                 {"MODEL_BENCH_OUT": str(out)}, out, "--model-new")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-7b"])
def test_serve_smoke_equals_the_reference(serve, arch):
    data, _ = serve
    ref = {r["arch"]: r for r in _reference("BENCH_serve.json")
           if r["profile"] == "smoke"}[arch]
    got = {r["arch"]: r for r in data["records"]}[arch]
    assert got["profile"] == "smoke" and got["family"] == ref["family"]
    assert {f: got[f] for f in SERVE_FIELDS} == {f: ref[f] for f in SERVE_FIELDS}
    assert data["device"] == "cpu" and data["schema"] == 1


def test_serve_stable_spans_equal_the_reference_live(serve, work):
    """The reference's serve_bench, run now, writes the smoke qwen2-0.5b
    stable span stream; the twin's is the same bytes."""
    spans = work / "spans_ref"
    r = _py(["-c", "from benchmarks import serve_bench; "
             "serve_bench.run(lambda *a: None)"],
            {"SERVE_BENCH_ARCHS": "qwen2-0.5b", "SERVE_BENCH_PROFILES": "smoke",
             "SERVE_BENCH_REPEATS": "2", "SERVE_BENCH_SPANS_DIR": str(spans),
             "SERVE_BENCH_OUT": str(work / "serve_ref.json")})
    assert r.returncode == 0, r.stderr[-3000:]
    name = "serve_qwen2-0.5b_smoke.spans.jsonl"
    want = (spans / name).read_bytes()
    assert want and (work / "spans_port" / name).read_bytes() == want


def _res_key(r):
    return (r["profile"], r["campaign"], r.get("policy", ""),
            r.get("fault_rate", 0.0))


RES_KEYS = [_res_key(r) for r in _reference("BENCH_resilience.json")
            if r["profile"] == "smoke"]


@pytest.mark.parametrize("key", RES_KEYS, ids=["/".join(map(str, k)) for k in RES_KEYS])
def test_resilience_smoke_equals_the_reference(resilience, key):
    """Every field of every record, but the wall-clock overhead: the
    deadlines count ticks, so the campaigns' counts are the reference's."""
    data, _ = resilience
    assert len(data["records"]) == len(RES_KEYS)
    ref = {_res_key(r): r for r in _reference("BENCH_resilience.json")}[key]
    got = {_res_key(r): r for r in data["records"]}[key]
    drop = {"resilience_overhead"}
    assert {k: v for k, v in got.items() if k not in drop} == \
        {k: v for k, v in ref.items() if k not in drop}


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_profile_equals_the_reference(model, arch):
    data, _ = model
    ref = {r["arch"]: r for r in _reference("BENCH_model.json")}[arch]
    got = {r["arch"]: r for r in data["records"]}[arch]
    assert {f: got[f] for f in MODEL_FIELDS} == {f: ref[f] for f in MODEL_FIELDS}
    for f in ("analytic_flops", "analytic_bytes"):
        assert got["crosscheck"][f] == ref["crosscheck"][f]
    assert got["crosscheck"]["flops_rel_err"] <= 0.02
    assert "counted_flops" in got["crosscheck"] and \
        "hlo_flops" not in got["crosscheck"]
    ref_rows = {row["op"]: row for row in ref["offload"]}
    assert sorted(row["op"] for row in got["offload"]) == sorted(ref_rows)
    for row in got["offload"]:
        for f in ("flops_per_step", "bytes_per_step", "intensity"):
            assert row[f] == ref_rows[row["op"]][f], (row["op"], f)
    # the H100's datasheet peaks, not the reference's accelerator's
    from repro_torch.launch import op_stats
    assert data["device_peaks"] == {"flops_per_s": op_stats.PEAK_FLOPS_BF16,
                                    "hbm_bytes_per_s": op_stats.HBM_BW}


@pytest.mark.parametrize("twin", ["serve", "resilience", "model"])
def test_the_gate_passes_each_cpu_output(request, twin):
    _, gate = request.getfixturevalue(twin)
    assert gate.returncode == 0, gate.stdout[-3000:]


def test_gate_reruns_only_on_wall_clock_overheads():
    assert _wall_clock_only(["FAIL: resilience qwen2-0.5b/smoke/zero_fault/0.0: "
                             "armed zero-fault overhead +5.8%"])
    assert _wall_clock_only(["FAIL: serve ('qwen2-0.5b', 'smoke'): trace "
                             "overhead +5.1%"])
    assert not _wall_clock_only([])
    assert not _wall_clock_only(["FAIL: model qwen2-0.5b: record overhead +6%",
                                 "FAIL: model qwen2-0.5b: layer stream not "
                                 "deterministic"])


def test_roofline_emits_one_line_per_offload_row(model, tmp_path):
    data, _ = model
    path = tmp_path / "model.json"
    path.write_text(json.dumps(data))
    r = _py(["benchmarks/roofline_report_torch.py", "--device", "cpu"],
            {"MODEL_BENCH_OUT": str(path)})
    assert r.returncode == 0, r.stderr[-2000:]
    names = [line.split(",")[0] for line in r.stdout.splitlines()]
    want = []
    for rec in data["records"]:
        want += [f"roofline_{rec['arch']}_{row['op']}" for row in rec["offload"]]
        want.append(f"roofline_{rec['arch']}_offload_top")
    assert [n for n in names if not n.startswith("roofline_torch_")] == want


def test_kernel_bench_emits_the_reference_lines():
    r = _py(["benchmarks/kernel_bench_torch.py", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    names = [line.split(",")[0] for line in r.stdout.splitlines()]
    assert names == ["kernel_matmul_banks1", "kernel_matmul_banks2",
                     "kernel_matmul_banks4", "kernel_matmul_ref",
                     "kernel_flash_attention", "kernel_attention_ref",
                     "kernel_ssm_scan_inclusive", "kernel_ssm_scan_bonus",
                     "kernel_ssm_scan_ref"]
    assert "block=(64, 128, 128)" in r.stdout


@pytest.mark.parametrize("section", ["paper_tables", "banking_ablation",
                                     "calyx_bench"])
def test_runner_refuses_the_sections_not_ported(section):
    r = _py(["benchmarks/run_torch.py", section, "--device", "cpu"])
    assert r.returncode == 1
    assert "ValueError" in r.stderr and "ROADMAP.md A.4" in r.stderr
    assert f"failures: ['{section}']" in r.stdout


def test_twins_raise_without_a_card():
    r = _py(["benchmarks/run_torch.py", "kernel_bench"],
            {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1 and "no CUDA device" in r.stdout


def test_full_width_profiles_serve_only_qwen2_on_the_card(monkeypatch):
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import serve_bench_torch as SB
    finally:
        sys.path.remove(str(ROOT))
    cpu, card = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("SERVE_BENCH_PROFILES", raising=False)
    monkeypatch.delenv("SERVE_BENCH_ARCHS", raising=False)
    assert SB.matrix(cpu) == [(a, p) for a in SB.ARCHS for p in ("smoke", "heavy")]
    assert SB.matrix(card) == [
        ("qwen2-0.5b", "smoke"), ("qwen2-0.5b", "heavy"), ("qwen2-0.5b", "full"),
        ("qwen2-0.5b", "full_wide"), ("rwkv6-7b", "smoke"), ("rwkv6-7b", "heavy")]
    monkeypatch.setenv("SERVE_BENCH_PROFILES", "full")
    with pytest.raises(ValueError, match="only on the card"):
        SB.matrix(cpu)
    # the heavy traffic as it is, and the wide one: 1,012 and 3,816 positions
    assert SB._max_len(SB.profile_trace(SB.PROFILES["full"])) == 1012
    assert SB._max_len(SB.profile_trace(SB.PROFILES["full_wide"])) == 3816
    assert SB.point_config("qwen2-0.5b", "full").dtype == "bfloat16"
    assert SB.point_config("qwen2-0.5b", "heavy").d_model == 64
