"""DeepSeek-V2's decoder in the port (``MLAConfig``): latent attention with
YaRN, a dense lead layer, shared experts and a held share of the routed
experts, held against the benchmark's plain reference
(``perfbench/reference/mla_moe_lm.py``) at the tiny size ``reduced()``
gives, which keeps every one of those mechanisms, in float32 on the CPU.

The tolerances are float32 round-off: the port attends by an online
softmax over blocks and sums the experts' parts in another order than the
reference, so a number agrees to a few ulps of its size, never exactly; a
missing or misplaced term (a scale, a norm, the rotary frequencies, a
dropped assignment) moves it by percents.
"""
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import cells, weights as W  # noqa: E402
from perfbench.reference import mla_moe_lm as REF  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import all_names, get_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.common import yarn_freqs  # noqa: E402
from repro_torch.models.config import MLAConfig  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

CELL = "deepseek-v2-lite-ep8.train-4k-ranges"
SEED = 2**31 + 29


def _file(cfg: MLAConfig, **extra) -> dict:
    """The benchmark's configuration dict for ``cfg``: its fields, with the
    harness's own keys."""
    c = dataclasses.asdict(cfg)
    c.update(capacity_multiple=8, embed_std=0.02, qk_head_dim=cfg.qk_head_dim,
             reference="perfbench/reference/mla_moe_lm.py", **extra)
    return c


def _tiny(name="deepseek-v2-lite-ep8", **changes):
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    c = _file(cfg)
    w = W.make(c, SEED, torch.device("cpu"), torch.float32)
    return cfg, c, w


def _tokens(cfg, b=2, s=32, seed=5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).long()


def _close(a, b, rtol):
    return float((a - b).norm() / b.norm().clamp_min(1e-30)) <= rtol


# -- the registry -------------------------------------------------------------

def test_the_configs_are_the_ports_alone():
    assert all_names() == sorted(
        ["olmoe-1b-7b", "granite-moe-1b-a400m", "llama-3.2-vision-11b",
         "gemma2-27b", "qwen2-0.5b", "starcoder2-7b", "qwen2-7b", "zamba2-7b",
         "whisper-large-v3", "rwkv6-7b"])
    full, ep8 = get_config("deepseek-v2-lite"), get_config("deepseek-v2-lite-ep8")
    assert isinstance(full, MLAConfig) and isinstance(ep8, MLAConfig)
    assert (ep8.num_experts, ep8.routed_experts, ep8.vocab_size) == (8, 64, 12800)
    assert dataclasses.replace(ep8, num_experts=64, vocab_size=102400,
                               name=full.name) == full
    # the fields the reference's configs do not have stay off them
    assert "kv_lora_rank" not in dataclasses.asdict(get_config("olmoe-1b-7b"))


def test_sizes_match_the_model_card():
    """15.7 B parameters (arXiv:2405.04434, the model card); one share of 8
    holds about 2.74 B: the dense layer 81 M, each MoE layer 100.4 M, the
    embedding and the head 52.4 M."""
    assert 15.6e9 < P.count_params(get_config("deepseek-v2-lite")) < 15.8e9
    ep8 = get_config("deepseek-v2-lite-ep8")
    assert 2.73e9 < P.count_params(ep8) < 2.75e9
    tree = P.param_shapes(ep8)
    assert tree["lead"]["mlp"]["wi"] == ((1, 2048, 10944), "normal")
    assert tree["blocks"]["lyr"]["moe"]["router"] == ((26, 2048, 64), "normal")
    assert tree["blocks"]["lyr"]["moe"]["shared"]["wg"] == ((26, 2048, 2816),
                                                           "normal")
    assert tree["blocks"]["lyr"]["attn"]["wkv_a"] == ((26, 2048, 576), "normal")
    assert tree["blocks"]["lyr"]["attn"]["wkv_b"] == ((26, 512, 4096), "normal")


def _shapes(tree):
    """The tree's shapes; the reference marks the routed experts' leaves
    ``expert`` where the port's draw names them ``normal``."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tree[0]


def test_the_reference_writes_the_ports_tree():
    for name in ("deepseek-v2-lite", "deepseek-v2-lite-ep8"):
        for cfg in (get_config(name), get_config(name).reduced()):
            assert _shapes(REF.shapes(_file(cfg))) == _shapes(P.param_shapes(cfg))


# -- the layers against the reference -----------------------------------------

def test_yarn_frequencies_and_scale():
    """The rotary tables and the score scale of the published rope_scaling:
    factor 40, original 4,096, beta 32 / 1, mscale 0.707 on both."""
    cfg = get_config("deepseek-v2-lite-ep8")
    from repro_torch.models.common import yarn_scale
    assert yarn_scale(cfg) == pytest.approx(0.11472, abs=1e-5)
    pos = torch.arange(4096)
    cos, sin = yarn_freqs(cfg, pos)
    x = torch.randn(1, 1, 4096, 64, generator=torch.Generator().manual_seed(1))
    from repro_torch.models.common import apply_rope
    got = apply_rope(x, cos, sin)
    want = REF.yarn_rope(_file(cfg), x, pos)
    assert torch.allclose(got, want, rtol=0, atol=2e-5)   # angles up to 4,095 rad


def test_mla_block_matches_the_reference():
    cfg, c, w = _tiny()
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(2))
    p = {k: (v[0] if not isinstance(v, dict) else {"w": v["w"][0]})
         for k, v in w["lead"]["attn"].items()}
    rope = yarn_freqs(cfg, torch.arange(40))
    got = A.mla_block(cfg, p, x, rope)
    want = REF.mla_attention(c, p, x, torch.arange(40), None)
    assert _close(got, want, 2e-6)


def test_chunked_attention_takes_values_narrower_than_keys():
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn(1, 2, 70, 24, generator=g) for _ in range(2))
    v = torch.randn(1, 2, 70, 8, generator=g)
    got = A.chunked_attention(q, k, v, scale=0.3, q_chunk=16, kv_chunk=16)
    s = (q @ k.transpose(-1, -2) * 0.3).masked_fill(
        torch.ones(70, 70, dtype=torch.bool).triu(1), float("-inf"))
    assert got.shape == (1, 2, 70, 8)
    assert torch.allclose(got, torch.softmax(s, -1) @ v, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["deepseek-v2-lite", "deepseek-v2-lite-ep8"])
def test_loss_and_gradients_match_the_reference(name):
    """The whole model, the dense lead, the shared experts and (ep8) the held
    share: the loss to 1e-6 and every leaf's gradient to 2e-5 of its norm.
    Capacity drops some assignments at this size: both drop the same."""
    cfg, c, w = _tiny(name)
    tok = _tokens(cfg)
    leaves = [t for _, t in W.leaf_paths(w)]
    for t in leaves:
        t.requires_grad_(True)
    loss, m = TF.loss_fn(cfg, w, {"tokens": tok})
    got = torch.autograd.grad(loss, leaves)
    ref_loss = REF.loss(c, w, tok)
    want = torch.autograd.grad(ref_loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=1e-6)
    for (path, _), a, b in zip(W.leaf_paths(w), got, want):
        assert _close(a, b, 2e-5), path


def test_the_shares_add_up_to_the_uncut_layer():
    """Nothing dropped: the 8 shares' routed parts, with the shared experts
    counted once, are the uncut layer's output, the port's and the
    reference's."""
    cfg, c, w = _tiny("deepseek-v2-lite", moe_capacity_factor=16.0)
    p = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
         for k, v in w["blocks"]["lyr"]["moe"].items()}
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        whole, _ = MOE.moe_block(cfg, p, x)
        shared = MOE.mlp_block(cfg, p["shared"], x)
        n = cfg.num_experts // 8
        parts = []
        for j in range(8):
            share = dataclasses.replace(cfg, num_experts=n, expert_offset=j * n)
            ps = dict(p, **{k: p[k][j * n:(j + 1) * n] for k in ("w1", "wg", "w2")})
            y, _ = MOE.moe_block(share, ps, x)
            parts.append(y - shared)
        ref, _, _ = REF.moe(c, p, x.reshape(-1, cfg.d_model), None)
    total = sum(parts) + shared
    assert _close(total, whole, 1e-6)
    assert _close(total.reshape(-1, cfg.d_model), ref, 1e-6)


def test_remote_assignments_are_counted_apart_from_drops(monkeypatch):
    cfg, c, w = _tiny()
    reg = MetricsRegistry()
    step = S.make_train_step(cfg, adamw.AdamWConfig(), metrics=reg)
    seen = []
    real = MOE._router

    def spy(*a, **k):
        out = real(*a, **k)
        if torch._C._current_graph_task_id() == -1:
            seen.append(out[1])
        return out
    monkeypatch.setattr(MOE, "_router", spy)
    step({"params": w, "opt": adamw.init_state(w)}, {"tokens": _tokens(cfg)})
    held = cfg.num_experts
    remote = sum(int((t >= held).sum()) for t in seen)
    total = sum(t.numel() for t in seen)
    assert len(seen) == cfg.num_groups and remote > 0
    assert reg.get("moe_assignments_total").value == total
    assert reg.get("moe_remote_assignments_total").value == remote
    dropped = reg.get("moe_dropped_assignments_total").value
    assert 0 <= dropped <= total - remote


def test_decoding_a_latent_config_is_refused():
    cfg, c, w = _tiny()
    with pytest.raises(D.LatentCacheMissing, match="latent cache"):
        D.init_cache(cfg, w, 2, 8)
    with pytest.raises(D.LatentCacheMissing):
        D.serve_step(cfg, w, {}, _tokens(cfg)[:, :1], 0)


# -- the MoE configs the benchmark runs compute as they did -------------------

# sha256 over the loss and every gradient of the reduced config, seed 7, a
# (2, 64) batch, remat off and on: the values before latent attention, the
# shared experts and the held share entered the code they share
PINNED = {
    "granite-moe-1b-a400m":
        "135e9d0c9a7ad7def04d2a8f2fef617c2b3b69c428713577b2764c0f3132b45a",
    "olmoe-1b-7b":
        "acc5560fca7fb7f7910a67bf837e1a181ce793faebbccb9a48cb6e1aee1f2096",
}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", sorted(PINNED))
def test_moe_configs_keep_their_bits(name, remat):
    cfg = dataclasses.replace(get_config(name).reduced(), remat=remat)
    prm = P.init_params(cfg, 7, "cpu")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 64))).long()
    m, g = S.grad_of(cfg, prm, {"tokens": tok})
    h = hashlib.sha256(m["loss"].numpy().tobytes())
    for t in g:
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED[name]


# -- the benchmark's cell, through the harness at a tiny size ------------------

def _checkout(tmp_path, **edit):
    """A copy of the harness; ``edit`` changes keys of the cell's
    configuration file."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    path = root / "perfbench" / "configs" / "deepseek-v2-lite-ep8.json"
    c = json.loads(path.read_text())
    c.update(edit)
    path.write_text(json.dumps(c))
    return root


def _run(root, trace: int):
    tiny = get_config("deepseek-v2-lite-ep8").reduced()
    file = cells.config("deepseek-v2-lite-ep8")
    ov = {"config": {k: v for k, v in _file(tiny).items() if k in file},
          "traffic": {"batch": 2, "seq_len": 64, "pool": 4,
                      "doc_len": {"median": 16, "sigma": 1.0, "min": 4,
                                  "max": 64}}}
    code = (
        "import json, sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench import run\n"
        "assert run.__file__.startswith(%r)\n"
        "sys.exit(run.main(['--workload', %r, '--seed', str(2**31 + 41),"
        " '--seconds', '0.3', '--trace', '%d'], device='cpu',"
        " overrides=json.loads(%r)))\n"
        % (str(root), os.path.join(ROOT, "src"), str(root), CELL, trace,
           json.dumps(ov)))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(root))


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_to_correct_at_a_tiny_size(tmp_path, trace):
    out = _run(_checkout(tmp_path), trace)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    if trace:
        assert last["metrics"]["mfu.train"]["value"] > 0
        assert "ranges window 0" in out.stderr
        assert "moe_remote_assignments_total" in out.stderr
    else:
        assert set(last["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_the_cell_with_a_port_field_changed_exits_3(tmp_path):
    out = _run(_checkout(tmp_path, kv_lora_rank=256), 0)
    assert out.returncode == 3, out.stderr[-2000:]
    assert "kv_lora_rank: file 256, port 512" in out.stderr
    assert out.stdout.strip() == ""


def test_the_float8_control_is_refused_at_a_tiny_size(capsys):
    """The cell's limits, set from the card's readings, refuse the
    reference computed in float8 in the program's place, and the half
    batch, and pass the program, here too."""
    from perfbench import calibrate, verdict
    tiny = get_config("deepseek-v2-lite-ep8").reduced()
    file = cells.config("deepseek-v2-lite-ep8")
    ov = {"config": {k: v for k, v in _file(tiny).items() if k in file},
          "traffic": {"batch": 2, "seq_len": 64, "pool": 4,
                      "doc_len": {"median": 16, "sigma": 1.0, "min": 4,
                                  "max": 64}}}
    assert calibrate.main(["--workload", CELL, "--seeds", "31,32",
                           "--seconds", "0.3", "--control"], device="cpu",
                          overrides=ov) == 0
    limits = cells.run_limits(CELL)
    for line in capsys.readouterr().out.splitlines():
        r = json.loads(line)
        assert verdict.judge(r["program"], limits)[0], r["program"]
        assert not verdict.judge(r["control"], limits)[0], r["control"]
        assert not verdict.judge(r["half_batch"], limits)[0]


def test_attn_roofline_reads_the_ranges_window():
    from types import SimpleNamespace
    reader = cells.metric_reader("attn_roofline.train")
    c = cells.config("deepseek-v2-lite-ep8")
    spec = cells.traffic("train-4k-ranges")
    ranges = {"steps": 2, "ranges": {
        "attn": {"device_s": 2.0}, "attn.latent": {"device_s": 0.5},
        "attn.bwd": {"device_s": 3.5}}}
    run = SimpleNamespace(cfg=c, spec=spec, rec={"ranges": ranges})
    # 64.4 TFLOP a step at 989 TFLOP/s over 3 s a step
    assert reader(run) == pytest.approx(100 * 64.367e12 / 989e12 / 3.0, rel=1e-3)
    assert reader(SimpleNamespace(cfg=c, spec=spec, rec={})) is None
