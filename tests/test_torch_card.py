"""The port on the card (``-m cuda``; these tests skip without one): its CUDA
kernels, the serve step of the decode path, a train step with its
checkpoint, the dry run of a reduced cell, the op counter's exact mesh
counts with fake CUDA tensors and the Calyx matrix's torch oracle.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card.py

Imports neither JAX nor ``repro``, so it runs where only the port is
installed.  ``chip_smoke.py`` makes the same checks and more; both take the
matmul, attention, scan and conv cases and the determinism calls from
``repro_torch.kernels.checks``, whose tables are also run through the plain
versions on the CPU here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import banked_conv2d as bc  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels import banked_matmul as bm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")


def _hold_all(checks, module):
    """Each check's wrapper call steps ``module.launches`` once and agrees
    with its plain version at the check's tolerance."""
    for c in checks:
        before = module.launches
        out = c.got()
        torch.cuda.synchronize()
        assert module.launches - before == 1, c.label
        want = c.want()
        assert out.shape == want.shape and out.dtype == want.dtype, c.label
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=c.rtol, atol=c.atol, err_msg=c.label)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """Every case of ``checks.matmul``: TestBankedMatmul's shapes and bank
    plans (B as a transposed view too), every matmul of the main path, and
    both variants at their boundaries (split-K included)."""
    _card()
    _hold_all(checks.matmul("cuda"), bm)


@pytest.mark.cuda
def test_main_path_products_take_the_skinny_variant_on_the_card():
    """The main path's products run the skinny variant and agree with the
    plain version; the plan's choice is the one the CPU tests hold."""
    _card()
    cases = [c for c in checks.matmul("cuda") if c.label.startswith("main path")]
    assert len(cases) == len(checks.MAIN_PATH_MATMULS)
    for m, k, n, f, _ in checks.MAIN_PATH_MATMULS:
        assert bm.plan(m, n, k, bm.derive_block(m, n, k, (f, f, f))).skinny
    _hold_all(cases, bm)


@pytest.mark.cuda
def test_redesigned_kernels_are_deterministic_on_the_card():
    """Two calls with the same inputs give the same bits: the CNN's product,
    a split-K product, full-width attention in f32 and bf16, both full-width
    scans and the paper's conv."""
    _card()
    for label, call in checks.deterministic("cuda"):
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second), label


@pytest.mark.cuda
def test_attention_matches_plain_on_the_card():
    """Every case of TestFlashAttention and kernel_bench.py's GQA 4:2."""
    _card()
    _hold_all(checks.attention("cuda"), fa)


@pytest.mark.cuda
def test_decay_scan_matches_plain_on_the_card():
    """Every case of TestDecayScan (chunk 8 against chunk 32 to 1e-5) and
    kernel_bench.py's two scans."""
    _card()
    _hold_all(checks.decay_scan("cuda"), ss)


@pytest.mark.cuda
def test_decay_scan_state_carries_on_the_card():
    _card()
    carry = next(c for c in checks.decay_scan("cuda") if c.label.endswith("state carry"))
    out = carry.got()
    assert float(out[0, 0, -1, 0]) > 0
    _hold_all([carry], ss)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
def test_decay_scan_state_pass_over_many_chunks_on_the_card(mode):
    """S 4096 at chunk 8: the state pass carries the state over 512 chunks
    (a slow decay keeps each token's trace alive across dozens of them);
    the kernel agrees with the step recurrence at the scan's 1e-4."""
    _card()
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(4096 + 8)
    q, k = (torch.tensor(rng.normal(size=(1, 2, 4096, 8)), dtype=torch.float32,
                         device="cuda") for _ in range(2))
    v = torch.tensor(rng.normal(size=(1, 2, 4096, 8)), dtype=torch.float32,
                     device="cuda")
    w = torch.tensor(-np.abs(rng.normal(size=(1, 2, 4096, 8))) * 0.02,
                     dtype=torch.float32, device="cuda")
    u = torch.tensor(rng.normal(size=(2, 8)), dtype=torch.float32, device="cuda")
    before = ss.launches
    out = ops.decay_scan(q, k, v, w, u=u, chunk=8, diag_mode=mode)
    torch.cuda.synchronize()
    assert ss.launches - before == 1
    want = ref.ssm_scan_ref(q, k, v, w, u=u, diag_mode=mode)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_conv2d_matches_plain_on_the_card():
    """Every case of TestBankedConv2d and the kernel's own variants."""
    _card()
    _hold_all(checks.conv2d("cuda"), bc)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["", "int8"])
def test_serve_step_on_the_card_matches_the_cpu(kv):
    """qwen2-0.5b reduced, float32: twelve teacher-forced serve steps on the
    card give the CPU's logits at 1e-5 (of the logits' scale, at least 1),
    a plain and an int8 KV cache; the cache stays on the card."""
    _card()
    import dataclasses
    from repro_torch.models import decode, get_config, params
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), kv_cache_dtype=kv)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    runs = {}
    for dev in ("cpu", "cuda"):
        prm = params.init_params(cfg, seed=0, device=dev)
        cache = decode.init_cache(cfg, prm, 2, 16)
        assert all(t.device.type == dev for t in decode._leaves(cache))
        out = []
        for i in range(12):
            logits, cache = decode.serve_step(cfg, prm, cache,
                                              tokens[:, i:i + 1].to(dev), i)
            out.append(logits.cpu().numpy())
        runs[dev] = np.stack(out)
    scale = max(1.0, float(np.abs(runs["cpu"]).max()))
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finite_screen_graph_on_the_card(dtype):
    """The engine's finite screen on the card replays a CUDA graph captured
    at the logits' first shape; each replay reads the logits it is given
    (a NaN, a +inf, a -inf, a tie), as ``_screen`` does eagerly."""
    _card()
    from repro_torch.launch import serve as SV
    rng = np.random.default_rng(5)
    for rep in range(3):
        last = torch.tensor(rng.normal(size=(6, 300)), dtype=torch.float32,
                            device="cuda").to(dtype)
        bad = [(1, 7 + rep, float("nan")), (2, 9, float("inf")),
               (3, 11 + rep, float("-inf"))]
        for row, col, val in bad[:rep + 1]:
            last[row, col] = val
        last[5, 200] = last[5, 3] = last[5].max() + 1
        nxt, finite = SV._guarded_argmax(last[:, :])
        want_nxt, want_finite = SV._screen(last).cpu().numpy()
        assert finite.tolist() == want_finite.astype(bool).tolist()
        assert finite.tolist() == [i not in [b[0] for b in bad[:rep + 1]]
                                   for i in range(6)]
        assert nxt[finite].tolist() == want_nxt[finite].tolist() and nxt[5] == 3


@pytest.mark.parametrize("table", ["matmul", "attention", "decay_scan", "conv2d"])
def test_check_tables_hold_on_the_cpu(table):
    """The shared check tables are well formed: on CPU tensors every wrapper
    takes its plain version, launches nothing, and meets ``want``."""
    counters = (bm, fa, ss, bc)
    before = [m.launches for m in counters]
    cases = getattr(checks, table)("cpu")
    assert len({c.label for c in cases}) == len(cases)
    for c in cases:
        out, want = c.got(), c.want()
        assert out.device.type == "cpu" and out.dtype == want.dtype, c.label
        np.testing.assert_allclose(out.float().numpy(), want.float().numpy(),
                                   rtol=c.rtol, atol=c.atol, err_msg=c.label)
    assert [m.launches for m in counters] == before


@pytest.mark.cuda
def test_rwkv_on_the_card_matches_the_cpu():
    """rwkv6-7b reduced, float32: twelve teacher-forced serve steps and a
    forward of 128 tokens (two scan chunks) on the card give the CPU's
    logits at 1e-5 (of the logits' scale, at least 1); in bf16 the card's
    wkv state is float32 after the first step (ROADMAP.md C.13)."""
    _card()
    import dataclasses
    from repro_torch.models import decode, get_config, params, transformer
    cfg = get_config("rwkv6-7b").reduced()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)))
    runs = {}
    for dev in ("cpu", "cuda"):
        prm = params.init_params(cfg, seed=0, device=dev)
        cache = decode.init_cache(cfg, prm, 2, 16)
        out = []
        for i in range(12):
            logits, cache = decode.serve_step(cfg, prm, cache,
                                              tokens[:, i:i + 1].to(dev), i)
            out.append(logits.cpu().numpy())
        full, _ = transformer.forward(cfg, prm, tokens.to(dev))
        runs[dev] = (np.stack(out), full.cpu().numpy())
    for got, want in zip(runs["cuda"], runs["cpu"]):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    prm = params.init_params(bf, seed=0, device="cuda")
    cache = decode.init_cache(bf, prm, 2, 16)
    assert cache["lyr"]["wkv"].dtype == torch.bfloat16
    logits, cache = decode.serve_step(bf, prm, cache,
                                      tokens[:, :1].to("cuda"), 0)
    assert cache["lyr"]["wkv"].dtype == torch.float32
    assert cache["lyr"]["wkv"].device.type == "cuda"
    assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zamba2-7b", "olmoe-1b-7b"])
def test_hybrid_and_moe_serve_step_on_the_card_match_the_cpu(name):
    """zamba2-7b and olmoe-1b-7b reduced, float32: twelve teacher-forced
    serve steps on the card give the CPU's logits within 2e-2
    (tests/test_decode_consistency.py's tolerance); every cache leaf stays on
    the card, and in bf16 the Mamba state is float32 after the first step
    (ROADMAP.md C.14)."""
    _card()
    import dataclasses
    from repro_torch.models import decode, get_config, params
    cfg = get_config(name).reduced()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    runs = {}
    for dev in ("cpu", "cuda"):
        prm = params.init_params(cfg, seed=0, device=dev)
        cache = decode.init_cache(cfg, prm, 2, 16)
        out = []
        for i in range(12):
            logits, cache = decode.serve_step(cfg, prm, cache,
                                              tokens[:, i:i + 1].to(dev), i)
            out.append(logits.cpu().numpy())
        assert all(t.device.type == dev for t in decode._leaves(cache))
        runs[dev] = np.stack(out)
    assert np.isfinite(runs["cuda"]).all()
    assert float(np.abs(runs["cuda"] - runs["cpu"]).max()) < 2e-2
    if cfg.family == "hybrid":
        bf = dataclasses.replace(cfg, dtype="bfloat16")
        prm = params.init_params(bf, seed=0, device="cuda")
        cache = decode.init_cache(bf, prm, 2, 16)
        logits, cache = decode.serve_step(bf, prm, cache,
                                          tokens[:, :1].to("cuda"), 0)
        assert cache["mamba"]["h"].dtype == torch.float32
        assert cache["mamba"]["conv"].dtype == torch.bfloat16
        assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whisper-large-v3", "llama-3.2-vision-11b"])
def test_modality_serve_step_on_the_card_matches_the_cpu(name):
    """whisper-large-v3 and llama-3.2-vision-11b reduced, float32, with frames
    or patches drawn from numpy (the VLM's cross gates set non-zero,
    ROADMAP.md C.15): ``init_cache`` fills the cross caches (through the
    encoder, for whisper) and twelve teacher-forced serve steps on the card
    give the CPU's logits within 2e-2 (tests/test_decode_consistency.py's
    tolerance), every cache leaf on the card; in bf16 the cross K/V are
    stored in bf16 (C.18) and the logits are finite."""
    _card()
    import dataclasses
    from repro_torch.models import decode, get_config, params
    cfg = get_config(name).reduced()
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.num_patches
    modality = torch.from_numpy(
        rng.normal(size=(2, n, cfg.d_model)).astype(np.float32))
    gates = rng.uniform(0.5, 1.5, (2, cfg.num_groups)).astype(np.float32)
    runs = {}
    for dev in ("cpu", "cuda"):
        prm = params.init_params(cfg, seed=0, device=dev)
        if cfg.family == "vlm":
            prm["blocks"]["cross"]["gate_attn"] = torch.from_numpy(gates[0]).to(dev)
            prm["blocks"]["cross"]["gate_mlp"] = torch.from_numpy(-gates[1]).to(dev)
        cache = decode.init_cache(cfg, prm, 2, 16, modality=modality.to(dev))
        out = []
        for i in range(12):
            logits, cache = decode.serve_step(cfg, prm, cache,
                                              tokens[:, i:i + 1].to(dev), i)
            out.append(logits.cpu().numpy())
        assert all(t.device.type == dev for t in decode._leaves(cache))
        runs[dev] = np.stack(out)
    assert np.isfinite(runs["cuda"]).all()
    assert float(np.abs(runs["cuda"] - runs["cpu"]).max()) < 2e-2
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    prm = params.init_params(bf, seed=0, device="cuda")
    cache = decode.init_cache(bf, prm, 2, 16,
                              modality=modality.to("cuda", torch.bfloat16))
    cross = cache["lyr"]["cross"] if cfg.family == "audio" else cache["cross"]
    assert cross["k"].dtype == torch.bfloat16 and bool(cross["k"].any())
    logits, cache = decode.serve_step(bf, prm, cache, tokens[:, :1].to("cuda"), 0)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(tmp_path):
    """qwen2-0.5b reduced, float32: one train step from the seed-0 state on
    the card and on the CPU (``launch.steps.make_train_step``, 4 x 32
    tokens): the loss at 1e-5, the gradient norm and the moments at
    ``tests/test_torch_trainer.py``'s 2e-3 of their scale, the parameters
    within twice the step's rate; then a checkpoint saved from the card
    restores on the CPU with the card state's bits."""
    _card()
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import get_config, params
    from repro_torch.optim import adamw
    cfg = get_config("qwen2-0.5b").reduced()
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=8,
                            weight_decay=0.01)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4)).batch(0)
    runs = {}
    for dev in ("cpu", "cuda"):
        prm = params.init_params(cfg, seed=0, device=dev)
        state = {"params": prm, "opt": adamw.init_state(prm)}
        state, m = steps.make_train_step(cfg, opt)(
            state, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        assert all(t.device.type == dev for t in adamw.leaves(state["params"]))
        runs[dev] = state, m
    (cpu, cm), (card, gm) = runs["cpu"], runs["cuda"]
    assert float(gm["loss"]) == pytest.approx(float(cm["loss"]), rel=1e-5)
    assert float(gm["grad_norm"]) == pytest.approx(float(cm["grad_norm"]), rel=2e-3)
    for a, b in zip(adamw.leaves(card["opt"].m), adamw.leaves(cpu["opt"].m)):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 2e-3 * scale
    for a, b in zip(adamw.leaves(card["params"]), adamw.leaves(cpu["params"])):
        assert float((a.cpu() - b).abs().max()) <= 2 * float(cm["lr"])
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, card)
    ckpt.wait()
    like = {"params": adamw.tree_map(torch.zeros_like, cpu["params"]),
            "opt": adamw.init_state(cpu["params"])}
    back, step = ckpt.restore(like)
    assert step == 1 and int(back["opt"].step) == 1
    for a, b in zip(adamw.leaves(back["params"]) + adamw.leaves(back["opt"].v),
                    adamw.leaves(card["params"]) + adamw.leaves(card["opt"].v)):
        assert a.device.type == "cpu" and torch.equal(a, b.cpu())


_DRY_RUN = r"""
import json, pathlib, sys
from repro_torch.launch import dryrun, mesh as ME
ME.fake_group(4)
rec = dryrun.run_cell("olmoe-1b-7b", "decode_32k", False,
                      pathlib.Path(sys.argv[1]), force=True, device="cuda",
                      reduced=True, mesh_shape=(2, 2))
ME.release()
print(json.dumps(rec))
"""


@pytest.mark.cuda
def test_dry_run_of_a_reduced_cell_on_the_card(tmp_path):
    """The dry run's ``run_cell`` with ``device="cuda"`` (fake CUDA tensors
    over a fake process group, in a process of its own) on a reduced cell
    of a small mesh: ``ok``, with counted FLOPs and collectives."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    _card()
    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run(
        [sys.executable, "-c", _DRY_RUN, str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=str(root),
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["chips"] == 4, rec.get("traceback")
    assert rec["mesh"] == "mesh2x2"
    assert rec["hlo_cost"]["flops"] > 0
    assert rec["collectives"]["count_by_kind"]["all-reduce"] > 0


@pytest.mark.cuda
def test_op_counts_on_a_fake_cuda_mesh():
    """The op counter's exact mesh counts of ``test_torch_op_analysis.py``
    (a product sharded over 16x16 at 2·M·N·K / 256 a device, DTensor's
    global-shape run not counted; a sum over 8 ranks) with fake CUDA tensors
    under the card's torch."""
    import torch_mesh_counts
    _card()
    out = torch_mesh_counts.counts("cuda")
    torch_mesh_counts.check_product(out)
    torch_mesh_counts.check_sum(out)


@pytest.mark.cuda
def test_calyx_bench_oracle_on_the_card(tmp_path):
    """``benchmarks/calyx_bench_torch.py`` over the matmul points with the
    torch oracle on the card: exit 0, 12 records naming the card, each
    oracle error within the matrix's 1e-4."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    _card()
    root = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path / "calyx.json"
    r = subprocess.run(
        [sys.executable, "benchmarks/calyx_bench_torch.py", "--device", "cuda"],
        capture_output=True, text=True, timeout=300, cwd=str(root),
        env={**os.environ, "PYTHONPATH": os.pathsep.join([str(root / "src"), str(root)]),
             "CALYX_BENCH_DESIGNS": "matmul", "CALYX_BENCH_OUT": str(out)})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    data = json.loads(out.read_text())
    assert data["device"] != "cpu" and len(data["records"]) == 12
    for rec in data["records"]:
        assert rec["design"] == "matmul" and rec["cycles_match"]
        assert 0.0 <= rec["oracle_max_abs_err"] <= 1e-4
