"""The port's batched serving driver against the reference's, on the CPU.

``examples/serve_batched_torch.py --device cpu`` against
``examples/serve_batched.py`` with the same flags, each in this process: for
the seven architectures of ``tests/test_decode_consistency.py`` at their
reduced configs in float32 (whisper and the VLM with their frame or patch
embeddings drawn from the seed before the prompts, filled into the cross
caches by ``init_cache``), the printed ``req`` lines and the ``--stable``
span stream are the reference's; a ``--fault-plan`` replay drops the same
rows; and ``--profile-layers`` on whisper and the VLM is refused with the
reference's message.
"""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import faults as FLT  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-0.5b", "gemma2-27b", "olmoe-1b-7b", "rwkv6-7b", "zamba2-7b",
         "whisper-large-v3", "llama-3.2-vision-11b"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def drivers():
    return _load("serve_batched"), _load("serve_batched_torch")


def _run(drivers, monkeypatch, capsys, args, out):
    """(reference stdout, port stdout); the span streams at ``out``.ref and
    ``out``.port."""
    ref, port = drivers
    monkeypatch.setattr("sys.argv", ["serve_batched", *args,
                                     "--spans-out", f"{out}.ref"])
    capsys.readouterr()
    ref.main()
    want = capsys.readouterr().out
    port.main(["--device", "cpu", *args, "--spans-out", f"{out}.port"])
    got = capsys.readouterr().out
    return want, got


def _lines(out, prefix):
    return [line for line in out.splitlines() if line.startswith(prefix)]


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_driver_matches_reference(drivers, monkeypatch, capsys,
                                          tmp_path, arch):
    args = ["--arch", arch, "--requests", "2", "--gen", "4", "--prompt-len",
            "4", "--stable"]
    want, got = _run(drivers, monkeypatch, capsys, args, tmp_path / "s")
    assert got.rstrip().endswith("OK") and want.rstrip().endswith("OK")
    assert len(_lines(got, "req")) == 2
    assert _lines(got, "req") == _lines(want, "req")
    assert _lines(got, "arch=") == _lines(want, "arch=")
    mine = (tmp_path / "s.port").read_bytes()
    assert mine and mine == (tmp_path / "s.ref").read_bytes()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-large-v3",
                                  "llama-3.2-vision-11b"])
def test_batched_driver_fault_replay_matches_reference(drivers, monkeypatch,
                                                       capsys, tmp_path, arch):
    """NaN logits, cache corruptions (the cross K/V included) and latency
    spikes: the same faults injected and detected, the same rows dropped,
    the same survivors' tokens and span stream."""
    plan = FLT.FaultPlan.generate(5, 10, 0.3, 3,
                                  kinds=(FLT.NAN_LOGITS, FLT.CACHE_CORRUPT,
                                         FLT.LATENCY_SPIKE), spike_us=100)
    plan.save(str(tmp_path / "plan.json"))
    args = ["--arch", arch, "--requests", "3", "--gen", "6", "--prompt-len",
            "4", "--stable", "--fault-plan", str(tmp_path / "plan.json")]
    want, got = _run(drivers, monkeypatch, capsys, args, tmp_path / "s")
    assert got.rstrip().endswith("OK")
    resilience = _lines(got, "resilience:")
    assert resilience == _lines(want, "resilience:") and resilience
    assert "dropped=0" not in resilience[0]
    assert _lines(got, "req") == _lines(want, "req")
    mine = (tmp_path / "s.port").read_bytes()
    assert mine and mine == (tmp_path / "s.ref").read_bytes()


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b"])
def test_batched_driver_refuses_profile_layers(drivers, monkeypatch, capsys,
                                               tmp_path, arch):
    ref, port = drivers
    args = ["--arch", arch, "--requests", "1", "--profile-layers",
            str(tmp_path / "layers.jsonl")]
    monkeypatch.setattr("sys.argv", ["serve_batched", *args])
    capsys.readouterr()
    with pytest.raises(SystemExit) as want:
        ref.main()
    want_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as got:
        port.main(["--device", "cpu", *args])
    got_err = capsys.readouterr().err
    assert got.value.code == want.value.code == 2
    assert _lines(got_err, "serve_batched") == _lines(want_err, "serve_batched")
    assert "--profile-layers supports families" in got_err
    assert not (tmp_path / "layers.jsonl").exists()


def test_batched_driver_needs_a_card_by_default(drivers):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        drivers[1].main(["--requests", "1", "--gen", "1", "--prompt-len", "1"])


# == the compiler example twins ==============================================

ORACLE_TOL = 1e-4            # tests/test_core_sim.py: design vs oracle


@pytest.fixture(scope="module")
def compilers():
    return _load("compile_to_calyx"), _load("compile_to_calyx_torch")


def _compile(compilers, monkeypatch, capsys, args, tmp_path):
    """(reference stdout, port stdout), each with its own output paths
    (``ref.*`` and ``port.*`` under ``tmp_path``) written as ``OUT``."""
    ref, port = compilers
    outs = {}
    for side in ("ref", "port"):
        side_args = [a.replace("OUT", str(tmp_path / side)) for a in args]
        capsys.readouterr()
        if side == "ref":
            monkeypatch.setattr("sys.argv", ["compile_to_calyx", *side_args])
            ref.main()
        else:
            port.main(["--device", "cpu", *side_args])
        outs[side] = capsys.readouterr().out.replace(str(tmp_path / side),
                                                     "OUT")
    return outs["ref"], outs["port"]


def _oracle_errors(out):
    """The ``max|out - oracle|`` figures, and the text with them blanked."""
    import re
    pat = re.compile(r"max\|out - oracle\|=([0-9.e+-]+)")
    return [float(v) for v in pat.findall(out)], pat.sub("max|out - oracle|=", out)


@pytest.mark.parametrize("args", [
    ["--model", "ffnn", "--factor", "2", "--out", "OUT.futil", "--simulate",
     "--emit-verilog", "OUT.sv", "--simulate-rtl", "--trace", "OUT.jsonl",
     "--vcd", "OUT.vcd"],
    ["--model", "ffnn", "--factor", "2", "--mode", "branchy", "--out",
     "OUT.futil", "--emit-verilog", "OUT.sv", "--simulate"],
    ["--model", "ffnn", "--factor", "4", "--opt-level", "2", "--profile",
     "--out", "OUT.futil"],
    ["--model", "ffnn", "--factor", "4", "--no-share", "--no-verify",
     "--opt-level", "1", "--out", "OUT.futil"],
    ["--model", "mha", "--factor", "2", "--out", "OUT.futil"],
], ids=["ffnn-f2-rtl-trace", "ffnn-f2-branchy", "ffnn-f4-o2-profile",
        "ffnn-f4-noshare-o1", "mha-f2"])
def test_compile_to_calyx_matches_reference(compilers, monkeypatch, capsys,
                                            tmp_path, args):
    """Every printed line is the reference's but the oracle's error (torch
    in place of jnp), which both hold under the design tolerance; the
    .futil, .sv, trace and VCD files are the reference's byte for byte."""
    want, got = _compile(compilers, monkeypatch, capsys, args, tmp_path)
    want_err, want_text = _oracle_errors(want)
    got_err, got_text = _oracle_errors(got)
    assert got_text == want_text
    assert len(got_err) == len(want_err)
    assert all(e < ORACLE_TOL for e in got_err + want_err), (got_err, want_err)
    if "--simulate" in args or "--simulate-rtl" in args:
        assert "matches estimate" in got and "MISMATCH" not in got
    for ext in ("futil", "sv", "jsonl", "vcd"):
        ref_file = tmp_path / f"ref.{ext}"
        if ref_file.exists():
            assert (tmp_path / f"port.{ext}").read_bytes() == \
                ref_file.read_bytes(), ext


def test_compile_to_calyx_keeps_the_bank_conflict(compilers, monkeypatch,
                                                  tmp_path):
    """MHA at factor 4 raises ``BankConflictError`` in both (C.5)."""
    from repro.core.banking import BankConflictError as RefConflict
    from repro_torch.core import BankConflictError
    ref, port = compilers
    args = ["--model", "mha", "--factor", "4", "--out",
            str(tmp_path / "mha.futil")]
    monkeypatch.setattr("sys.argv", ["compile_to_calyx", *args])
    with pytest.raises(RefConflict) as want:
        ref.main()
    with pytest.raises(BankConflictError) as got:
        port.main(["--device", "cpu", *args])
    assert str(got.value) == str(want.value)


def test_banking_sweep_matches_reference(monkeypatch, capsys):
    ref, port = _load("banking_sweep"), _load("banking_sweep_torch")
    capsys.readouterr()
    ref.main()
    want = capsys.readouterr().out
    port.main()
    assert capsys.readouterr().out == want
    assert "speedup 1->2" in want
