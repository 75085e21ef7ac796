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
