"""The port's training path against the reference's, on the CPU.

* **Gradients**, for the seven architectures of
  ``tests/test_decode_consistency.py`` at their reduced configs in
  float32: the loss and every gradient leaf of ``transformer.loss_fn``
  under autograd against ``jax.value_and_grad`` of the reference's, on
  its seed-0 weights and one ``SyntheticLM`` batch of 2 x 32 (the VLM
  with the same non-zero cross gates on both sides, C.15: the drawn zeros
  leave its cross layer's weight gradients at zero).  Both packages sit
  up to 1.0e-3 of a leaf's largest gradient from a float64 evaluation of
  the port on the same weights (port 1.0e-3 on whisper, reference 9.2e-4
  on gemma2; the losses within 1.3e-7 relative), and up to 9.4e-4 from
  each other, so a leaf is held at ``GRAD_TOL`` = 2e-3 of its largest
  magnitude and the loss at ``LOSS_RTOL`` = 1e-6.
* **One step from the same state**: for each of 8 steps of the
  reference's ``Trainer`` (qwen2-0.5b, and olmoe-1b-7b for its routing),
  the reference's state carried over with ``state_from_numpy``, one port
  step, and the reference's next state: loss at ``LOSS_RTOL``,
  ``grad_norm``, ``m`` and ``v`` at ``GRAD_TOL`` (they are made of the
  gradients; 3.9e-4 measured), the rate at ``LR_RTOL`` = 1e-6 (one ulp
  measured), and each parameter within twice the step's rate of the
  reference's: Adam's first steps move a parameter by about ``lr *
  sign(g)``, so a gradient near zero may move it by ``2 lr`` on a
  rounding difference (9.3e-4 measured against 3e-3).  Free-running
  trajectories drift apart for that reason and are not compared;
  ``apply_updates`` on identical gradients is held to an ulp in
  ``tests/test_torch_optim.py``.
* **Rematerialization**: with ``cfg.remat`` and the CE chunk's checkpoint
  the gradients are bit-equal to a run without any checkpoint, less is
  saved for the backward pass, and forward and decode wrap nothing.
* Microbatches 1 and 2 of ``launch.steps.make_train_step`` against the
  reference's; restart, max restarts, the straggler detector, the
  ``launch.train`` CLI and ``examples/train_lm_torch.py`` against the
  reference's driver.
"""
import dataclasses
import importlib.util
import pathlib
import re
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.data.pipeline import DataConfig as RDataConfig  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.runtime.trainer import Trainer as RTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as RTrainerConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402
from repro_torch.runtime import trainer as TR  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-0.5b", "gemma2-27b", "olmoe-1b-7b", "rwkv6-7b", "zamba2-7b",
         "whisper-large-v3", "llama-3.2-vision-11b"]
GRAD_TOL = 2e-3
LOSS_RTOL = 1e-6
LR_RTOL = 1e-6
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=8, weight_decay=0.01)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _gates(groups: int) -> dict:
    """Seeded non-zero cross gates, one a group, of both signs (C.15)."""
    rng = np.random.default_rng(15)
    sign = (-1.0) ** np.arange(groups)
    return {k: (rng.uniform(0.5, 1.5, groups) * sign).astype(np.float32)
            for k in ("gate_attn", "gate_mlp")}


def _setup(name, **over):
    """(port cfg, reference cfg, the reference's seed-0 weights as float32
    numpy, the VLM's gates set non-zero, one 2 x 32 batch)."""
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    rcfg = dataclasses.replace(ref_config(name).reduced(), **over)
    tree = jax.tree.map(_np, RP.init_params(rcfg, seed=0))
    if cfg.family == "vlm":
        tree["blocks"]["cross"].update(_gates(cfg.num_groups))
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2), model_cfg=cfg).batch(0)
    return cfg, rcfg, tree, batch


def _port_grads(cfg, tree, batch):
    prm = P.params_from_numpy(tree, "cpu", torch.float32)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    metrics, grads = S.grad_of(cfg, prm, tb)
    return metrics, grads


def _close_leaf(got, want, tol, label=""):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=label)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_the_reference(name):
    cfg, rcfg, tree, batch = _setup(name)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    (rloss, rmetrics), rgrads = jax.value_and_grad(
        lambda p: RT.loss_fn(rcfg, p, rb), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    metrics, grads = _port_grads(cfg, tree, batch)
    assert set(metrics) == set(rmetrics)
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(rmetrics[k]),
                                                  rel=LOSS_RTOL, abs=1e-7), k
    flat = jax.tree_util.tree_flatten_with_path(rgrads)[0]
    assert len(flat) == len(grads)
    for (path, want), got in zip(flat, grads):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        _close_leaf(got, want, GRAD_TOL, jax.tree_util.keystr(path))
    if cfg.family == "vlm":          # the gates reach the cross layer
        cross = [g for (p, _), g in zip(flat, grads)
                 if "cross" in jax.tree_util.keystr(p)]
        assert all(bool(g.any()) for g in cross)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "olmoe-1b-7b", "zamba2-7b",
                                  "whisper-large-v3", "llama-3.2-vision-11b"])
def test_remat_and_the_ce_checkpoint_are_bit_equal(name, monkeypatch):
    """``remat=True`` (each group step, whisper's encoder layers) and the
    CE chunk checkpoint (4 chunks of 8) against the same loss with every
    checkpoint replaced by a plain call: equal bits, the MoE's auxiliary
    losses counted once, and fewer bytes saved for the backward pass."""
    cfg, _, tree, batch = _setup(name, remat=True)
    prm = P.params_from_numpy(tree, "cpu", torch.float32)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}

    def run():
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t
        leaves = A.leaves(prm)
        for p in leaves:
            p.requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            x, aux = T.forward_hidden(cfg, prm, tb["tokens"],
                                      modality=tb.get("modality"))
            ce = T.chunked_ce(cfg, prm, x, tb["tokens"], chunk=8)
            loss = ce + sum(aux.values()) if aux else ce
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads, saved[0]

    calls = []
    real = T.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)
    monkeypatch.setattr(T, "checkpoint", counted)
    loss, aux, grads, saved = run()
    groups = cfg.num_groups + (cfg.encoder_layers if cfg.family == "audio" else 0)
    assert len(calls) == groups + 4
    monkeypatch.setattr(T, "checkpoint", lambda fn, *a, **kw: fn(*a))
    loss0, aux0, grads0, saved0 = run()
    assert torch.equal(loss, loss0)
    assert aux.keys() == aux0.keys() and all(torch.equal(aux[k], aux0[k])
                                             for k in aux)
    for a, b in zip(grads, grads0):
        assert torch.equal(a, b)
    assert saved < saved0


def test_forward_and_decode_wrap_nothing(monkeypatch):
    """Serving keeps its path: no checkpoint without a tensor that needs
    a gradient, under grad mode or ``no_grad``."""
    cfg, _, tree, batch = _setup("whisper-large-v3", remat=True)
    prm = P.params_from_numpy(tree, "cpu", torch.float32)
    calls = []
    monkeypatch.setattr(T, "checkpoint", lambda *a, **kw: calls.append(a))
    toks, mod = torch.as_tensor(batch["tokens"]), torch.as_tensor(batch["modality"])
    T.forward(cfg, prm, toks, modality=mod)
    T.loss_fn(cfg, prm, {"tokens": toks, "modality": mod})
    cache = D.init_cache(cfg, prm, 2, 8, modality=mod)
    D.serve_step(cfg, prm, cache, toks[:, :1], 0)
    with torch.no_grad():
        T.forward(cfg, prm, toks, modality=mod)
    assert calls == []


@pytest.mark.parametrize("name", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_one_step_from_the_reference_state(name, tmp_path):
    """8 steps: the reference's jitted step beside one port step from the
    reference's state before it (module docstring)."""
    cfg, rcfg = get_config(name).reduced(), ref_config(name).reduced()
    rt = RTrainer(rcfg, RTrainerConfig(total_steps=8, checkpoint_dir=str(tmp_path)),
                  opt_cfg=RA.AdamWConfig(**OPT),
                  data_cfg=RDataConfig(rcfg.vocab_size, 32, 4))
    ref_step = rt._compiled_step()
    port_step = S.make_train_step(cfg, A.AdamWConfig(**OPT))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4), model_cfg=cfg)
    state = rt.init_state()
    for step in range(8):
        before = jax.tree.map(np.asarray, state)
        batch = rt.data.batch(step)
        np.testing.assert_array_equal(batch["tokens"], data.batch(step)["tokens"])
        state, rm = ref_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        ps = TR.state_from_numpy({"params": before["params"],
                                  "opt": tuple(before["opt"])}, "cpu", torch.float32)
        ps, pm = port_step(ps, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert int(ps["opt"].step) == int(state["opt"].step) == step + 1
        assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=LOSS_RTOL)
        assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                       rel=GRAD_TOL)
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=LR_RTOL)
        for tree, rtree in ((ps["opt"].m, state["opt"].m),
                            (ps["opt"].v, state["opt"].v)):
            for got, want in zip(A.leaves(tree), jax.tree.leaves(rtree)):
                _close_leaf(got, want, GRAD_TOL, f"step {step}")
        bound = 2 * float(rm["lr"])
        for got, want in zip(A.leaves(ps["params"]),
                             jax.tree.leaves(state["params"])):
            assert float(np.abs(_np(got) - _np(want)).max()) <= bound, step


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_reference_steps(microbatches):
    """``make_train_step`` with and without accumulation, from the same
    state, against ``repro.launch.steps.make_train_step``: the last
    microbatch's loss, the accumulated gradients' norm, the moments and
    the parameters (as in the one-step test)."""
    cfg, rcfg, tree, _ = _setup("qwen2-0.5b")
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4)).batch(0)
    rstate = {"params": jax.tree.map(jnp.asarray, tree),
              "opt": RA.init_state(jax.tree.map(jnp.asarray, tree))}
    rnew, rm = RS.make_train_step(rcfg, RA.AdamWConfig(**OPT), microbatches)(
        rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    pstate = {"params": P.params_from_numpy(tree, "cpu", torch.float32)}
    pstate["opt"] = A.init_state(pstate["params"])
    pnew, pm = S.make_train_step(cfg, A.AdamWConfig(**OPT), microbatches)(
        pstate, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert set(pm) == set(rm)
    assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=LOSS_RTOL)
    assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                   rel=GRAD_TOL)
    assert float(pm["lr"]) == float(rm["lr"])
    for got, want in zip(A.leaves(pnew["opt"].m), jax.tree.leaves(rnew["opt"].m)):
        _close_leaf(got, want, GRAD_TOL)
    for got, want in zip(A.leaves(pnew["params"]), jax.tree.leaves(rnew["params"])):
        assert float(np.abs(_np(got) - _np(want)).max()) <= 2 * float(rm["lr"])


def test_microbatches_accumulate_in_f32_and_take_the_last_metrics():
    """Two microbatches: the update from the mean of the two microbatches'
    float32 gradients, the metrics of the second."""
    cfg, _, tree, _ = _setup("qwen2-0.5b")
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticLM(DataConfig(cfg.vocab_size, 32, 4)).batch(1).items()}
    prm = P.params_from_numpy(tree, "cpu", torch.float32)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()} for i in range(2)]
    (m0, g0), (m1, g1) = (S.grad_of(cfg, prm, h) for h in halves)
    mean = [(torch.zeros_like(a) + a + b) / 2 for a, b in zip(g0, g1)]
    it = iter(mean)
    want_p, want_opt, want_m = A.apply_updates(
        A.AdamWConfig(**OPT), prm, A.tree_map(lambda _: next(it), prm),
        A.init_state(prm))
    state = {"params": P.params_from_numpy(tree, "cpu", torch.float32)}
    state["opt"] = A.init_state(state["params"])
    new, metrics = S.make_train_step(cfg, A.AdamWConfig(**OPT), 2)(state, batch)
    assert torch.equal(metrics["loss"], m1["loss"])
    assert torch.equal(metrics["grad_norm"], want_m["grad_norm"])
    for a, b in zip(A.leaves(new["params"]) + A.leaves(new["opt"].m),
                    A.leaves(want_p) + A.leaves(want_opt.m)):
        assert torch.equal(a, b)


def test_prefill_and_serve_steps_are_the_model_functions():
    cfg, _, tree, batch = _setup("qwen2-0.5b")
    prm = P.params_from_numpy(tree, "cpu", torch.float32)
    toks = torch.as_tensor(batch["tokens"])
    logits = S.make_prefill_step(cfg)(prm, {"tokens": toks})
    assert not logits.requires_grad
    assert torch.equal(logits, T.forward(cfg, prm, toks)[0])
    cache = D.init_cache(cfg, prm, 2, 8)
    got, _ = S.make_serve_step(cfg)(prm, cache, toks[:, :1], 0)
    want, _ = D.serve_step(cfg, prm, D.init_cache(cfg, prm, 2, 8), toks[:, :1], 0)
    assert torch.equal(got, want)


def test_state_from_numpy_round_trips():
    _, _, tree, _ = _setup("qwen2-0.5b")
    rng = np.random.default_rng(3)
    m = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
    st = TR.state_from_numpy({"params": tree, "opt": (5, m, m)}, "cpu",
                             torch.bfloat16)
    assert st["opt"].step.dtype == torch.int32 and int(st["opt"].step) == 5
    assert all(t.dtype == torch.bfloat16 for t in A.leaves(st["params"]))
    back = TR.state_to_numpy(st)
    again = TR.state_from_numpy(back, "cpu", torch.bfloat16)
    for a, b in zip(A.leaves(st["params"]) + A.leaves(st["opt"].m),
                    A.leaves(again["params"]) + A.leaves(again["opt"].m)):
        assert torch.equal(a, b)
    for a, b in zip(A.leaves(back["opt"].m), jax.tree.leaves(m)):
        np.testing.assert_array_equal(a, b)


# -- the runtime (twins of tests/test_substrate.py) ----------------------------


def _trainer(tmp_path, failure_hook=None, steps=12, device="cpu"):
    cfg = get_config("qwen2-0.5b").reduced()
    tcfg = TR.TrainerConfig(total_steps=steps, checkpoint_every=4,
                            checkpoint_dir=str(tmp_path), max_restarts=2)
    opt = A.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps,
                        weight_decay=0.0)
    return TR.Trainer(cfg, tcfg, opt_cfg=opt, failure_hook=failure_hook,
                      data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=32, global_batch=4),
                      device=device)


def test_loss_decreases(tmp_path):
    tr = _trainer(tmp_path, steps=12)
    tr.run_with_restarts()
    first = np.mean([h["loss"] for h in tr.history[:3]])
    last = np.mean([h["loss"] for h in tr.history[-3:]])
    assert last < first
    assert all(h["step_time_s"] > 0 for h in tr.history)
    assert tr.ckpt.all_steps() == [4, 8, 12]


def test_restart_resumes_from_checkpoint(tmp_path):
    fired = {"done": False}

    def fail_once(step):
        if step == 6 and not fired["done"]:
            fired["done"] = True
            raise TR.WorkerFailure("injected at step 6")

    tr = _trainer(tmp_path, failure_hook=fail_once, steps=12)
    tr.run_with_restarts()
    resumes = [h for h in tr.history if "restart" in h]
    assert resumes == [{"restart": 1, "resume_step": 4}]
    steps_seen = [h["step"] for h in tr.history if "step" in h]
    assert steps_seen == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9, 10, 11]


def test_trajectory_identical_after_restart(tmp_path):
    """Counter-based data and the checkpointed state: the replayed steps'
    losses equal an unfailed run's (at ``rel=1e-4``, as the reference holds
    its own; on the CPU they are bit-equal)."""
    base = _trainer(tmp_path / "a", steps=8)
    base.run_with_restarts()
    base_losses = {h["step"]: h["loss"] for h in base.history if "step" in h}
    fired = {"done": False}

    def fail_once(step):
        if step == 5 and not fired["done"]:
            fired["done"] = True
            raise TR.WorkerFailure("boom")

    ft = _trainer(tmp_path / "b", failure_hook=fail_once, steps=8)
    ft.run_with_restarts()
    ft_losses = {h["step"]: h["loss"] for h in ft.history if "step" in h}
    for s in (4, 5, 6, 7):
        assert ft_losses[s] == pytest.approx(base_losses[s], rel=1e-4)
        assert ft_losses[s] == base_losses[s]


def test_exceeds_max_restarts(tmp_path):
    def always_fail(step):
        raise TR.WorkerFailure("dead node")

    tr = _trainer(tmp_path, failure_hook=always_fail, steps=8)
    with pytest.raises(RuntimeError, match="max_restarts"):
        tr.run_with_restarts()


def test_rescale_restores_into_another_skeleton(tmp_path):
    tr = _trainer(tmp_path, steps=4)
    state = tr.run_with_restarts()
    like = {"params": A.tree_map(lambda t: t.to(torch.bfloat16), state["params"]),
            "opt": state["opt"]}
    back, step = tr.rescale(like)
    assert step == 4
    for a, b in zip(A.leaves(back["params"]), A.leaves(state["params"])):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))


def test_trainer_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _trainer(tempfile.mkdtemp(), device=None)


def test_straggler_flags_slow_host():
    d = TR.StragglerDetector(alpha=1.0, threshold=1.5)
    for h in range(8):
        d.record(h, 1.0)
    d.record(3, 9.0)
    assert d.stragglers() == [3]


def test_straggler_no_false_positives():
    d = TR.StragglerDetector()
    for h in range(8):
        for _ in range(5):
            d.record(h, 1.0 + 0.01 * h)
    assert d.stragglers() == []


# -- the CLI and the example ---------------------------------------------------


_LINE = re.compile(r"\[train\] (\S+): (\d+) steps, loss ([\d.]+) -> ([\d.]+), "
                   r"ckpt=(\S+)")


def test_train_cli_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``--device cpu --reduced``: the reference's line (same name, steps
    and first loss, the last within the drift of 6 free-running steps) and
    its checkpoints."""
    from repro.launch import train as ref_cli
    args = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "6",
            "--checkpoint-every", "3"]
    train_cli.main(args + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "p")])
    got = _LINE.search(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["train", *args, "--ckpt-dir",
                                     str(tmp_path / "r")])
    ref_cli.main()
    want = _LINE.search(capsys.readouterr().out)
    assert got and want
    assert got.groups()[:3] == want.groups()[:3]
    assert float(got.group(4)) == pytest.approx(float(want.group(4)), abs=1e-2)
    assert got.group(5) == str(tmp_path / "p")
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == [
        "step_00000003", "step_00000006"]


def test_train_cli_refuses_without_a_card_and_on_dry_run(capfd):
    """Without a card the CLI raises, and ``--dry-run`` delegates to the dry
    run (``--device cuda`` unless named), which exits non-zero there rather
    than running on the CPU; ``tests/test_torch_dryrun.py`` holds the
    delegated command."""
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            train_cli.main(["--arch", "qwen2-0.5b", "--dry-run"])
        assert e.value.code != 0
        assert "no CUDA device" in capfd.readouterr().err
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1"])


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_twin_restarts_and_profiles(tmp_path, capsys, monkeypatch):
    """``examples/train_lm_torch.py --device cpu --inject-failure 6`` beside
    ``examples/train_lm.py`` with the same flags: ``restarts=1``, ``OK``,
    the same first loss and the same ``--stable`` layer records."""
    args = ["--steps", "14", "--inject-failure", "6", "--batch", "4",
            "--seq", "32", "--profile-steps", "4", "--stable"]
    _load("train_lm_torch").main(
        ["--device", "cpu", *args, "--ckpt-dir", str(tmp_path / "p"),
         "--profile-layers", str(tmp_path / "p.jsonl")])
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["train_lm", *args, "--ckpt-dir",
                                     str(tmp_path / "r"), "--profile-layers",
                                     str(tmp_path / "r.jsonl")])
    _load("train_lm").main()
    want = capsys.readouterr().out
    pat = re.compile(r"arch=(\S+) steps=(\d+) loss ([\d.]+) -> ([\d.]+) "
                     r"\(ln V = ([\d.]+)\) restarts=(\d+)")
    g, w = pat.search(got), pat.search(want)
    assert g and w and g.group(6) == "1"
    assert g.group(1, 2, 3, 5, 6) == w.group(1, 2, 3, 5, 6)
    assert "!! injecting WorkerFailure at step 6" in got
    assert got.rstrip().endswith("OK")
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "r.jsonl").read_bytes()
