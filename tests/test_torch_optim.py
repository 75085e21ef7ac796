"""The port's AdamW and int8 error-feedback compression against the
reference's, on the CPU.

* ``schedule``: the warm-up is equal bit for bit; past it XLA's float32
  ``cos`` is its own approximation (it differs from torch's, and from the
  correctly rounded value, in 1-5% of arguments), and near the end of the
  decay ``1 + cos`` turns one ulp of the cosine into a few of the rate, so
  the rate is held at ``LR_RTOL`` = 1e-6 (at most 5 ulps measured over
  10,000 steps of the default config).
* ``apply_updates`` on identical gradients: with clipping off, ``m`` and
  ``v`` are bit-equal and the parameters differ from the reference's in
  at most 1% of their elements (0.1% measured), each by at most one ulp of
  its leaf's largest magnitude: XLA's CPU code rounds a rare quotient
  differently.  The gradient norm is a float32 sum of 25,000 squares in
  another order (``GNORM_RTOL`` = 1e-5; 1.4e-6 measured on bfloat16
  gradients), so with clipping on the clip scale and with it ``m``, ``v``
  and the parameters move by up to ``ULPS`` = 2 ulps of each leaf's
  largest magnitude.
* ``apply_updates_`` (in place) is bit-equal to ``apply_updates``.
* ``ef_compress``/``ef_decompress`` are bit-equal (both round half to
  even).  ``compressed_psum`` on a 2-rank gloo group gives the synced
  gradients of the reference's on a 2-device host mesh bit for bit; the
  reference's sync is jitted, and XLA's CPU code then fuses the residual
  ``corrected - q * scale`` into one multiply-add, so its new errors sit
  within one rounding of ``q * scale`` (float32 eps times the leaf's
  largest ``|g + e|``) of the port's, which round the product first as
  the eager reference does.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.optim import compression as RC  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402
from repro_torch.optim import compression as C  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LR_RTOL = 1e-6
GNORM_RTOL = 1e-5
ULPS = 2
SCHEDULES = [dict(lr=3e-3, warmup_steps=2, total_steps=12, weight_decay=0.01),
             dict(), dict(lr=1.0, warmup_steps=10, total_steps=100),
             dict(lr=3e-3, warmup_steps=6, total_steps=60)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _opt_cfgs(**kw):
    return RA.AdamWConfig(**kw), A.AdamWConfig(**kw)


def _tree(seed=1):
    """The reduced qwen2-0.5b parameters (the reference's draw) with seeded
    gradients and moments of realistic sizes, as float32 numpy trees."""
    rcfg = ref_config("qwen2-0.5b").reduced()
    p = jax.tree.map(_np, RP.init_params(rcfg, seed=0))
    rng = np.random.default_rng(seed)

    def draw(scale, positive=False):
        def one(a):
            x = rng.normal(size=a.shape) * scale
            return (np.abs(x) if positive else x).astype(np.float32)
        return jax.tree.map(one, p)
    return p, draw(0.05), draw(0.01), draw(1e-4, positive=True)


def _reference(rc, dt, p, g, m, v, step):
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a).astype(dt), t)  # noqa: E731
    f32 = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    return RA.apply_updates(rc, cast(p), cast(g), RA.OptState(
        jnp.asarray(step, jnp.int32), f32(m), f32(v)))


def _port_state(p, g, m, v, step, dt):
    return (P.params_from_numpy(p, "cpu", dt), P.params_from_numpy(g, "cpu", dt),
            A.OptState(torch.tensor(step, dtype=torch.int32),
                       P.params_from_numpy(m, "cpu", torch.float32),
                       P.params_from_numpy(v, "cpu", torch.float32)))


def _within_ulps(got, want, dtype, ulps=ULPS) -> int:
    """Every element within ``ulps`` ulps (of ``dtype``) of the leaf's
    largest magnitude; returns how many elements differ at all."""
    got, want = _np(got), _np(want)
    eps = float(torch.finfo(dtype).eps)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=ulps * eps * scale)
    return int((got != want).sum())


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedule_matches_the_reference(kw):
    rc, pc = _opt_cfgs(**kw)
    for s in range(pc.total_steps + 3):
        want = float(RA.schedule(rc, jnp.asarray(s, jnp.int32)))
        got = A.schedule(pc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        if s <= pc.warmup_steps:
            assert float(got) == want, s
        else:
            assert float(got) == pytest.approx(want, rel=LR_RTOL, abs=0), s


def test_schedule_warmup_and_decay():
    cfg = A.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    lrs = [float(A.schedule(cfg, torch.tensor(s))) for s in [0, 5, 10, 100]]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[3] == pytest.approx(0.1, rel=0.01)


def test_converges_on_quadratic():
    cfg = A.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                        total_steps=200)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = A.init_state(params)
    for _ in range(150):
        grads = {"x": 2 * params["x"]}
        params, state, _ = A.apply_updates(cfg, params, grads, state)
    assert float(params["x"].abs().max()) < 0.3


def test_clipping_reports_the_norm_before_the_clip():
    cfg = A.AdamWConfig(clip_norm=1.0, warmup_steps=1)
    params = {"x": torch.zeros(3)}
    _, _, m = A.apply_updates(cfg, params, {"x": torch.full((3,), 1e6)},
                              A.init_state(params))
    assert float(m["grad_norm"]) > 1e5


def test_init_state_and_global_norm_match_the_reference():
    p, g, _, _ = _tree()
    tp = P.params_from_numpy(p, "cpu", torch.bfloat16)
    st = A.init_state(tp)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for leaf, m, v in zip(A.leaves(tp), A.leaves(st.m), A.leaves(st.v)):
        assert m.dtype == v.dtype == torch.float32 and m.shape == leaf.shape
        assert not m.any() and not v.any() and m.data_ptr() != v.data_ptr()
    want = float(RA.global_norm(jax.tree.map(jnp.asarray, g)))
    got = A.global_norm(P.params_from_numpy(g, "cpu", torch.float32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=GNORM_RTOL)


@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_on_identical_gradients(dtype, clip):
    """Steps 0-8 of a 12-step schedule (warm-up 2), weight decay 0.01: the
    reference's values to an ulp, as the module docstring sets out."""
    tdt = getattr(torch, dtype)
    p, g, m, v = _tree()
    rc, pc = _opt_cfgs(lr=3e-3, warmup_steps=2, total_steps=12,
                       weight_decay=0.01, clip_norm=clip)
    for step in range(9):
        rp, rs, rm = _reference(rc, dtype, p, g, m, v, step)
        tp, ts, tm = A.apply_updates(pc, *_port_state(p, g, m, v, step, tdt))
        assert int(ts.step) == step + 1 and ts.step.dtype == torch.int32
        assert float(tm["lr"]) == float(rm["lr"])
        assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                       rel=GNORM_RTOL)
        differ = 0
        for name, want, got in (("p", rp, tp), ("m", rs.m, ts.m),
                                ("v", rs.v, ts.v)):
            for w, t in zip(jax.tree.leaves(want), A.leaves(got)):
                assert t.dtype == (tdt if name == "p" else torch.float32)
                if clip > 1 and name != "p":
                    np.testing.assert_array_equal(_np(t), _np(w))
                elif clip > 1:
                    differ += _within_ulps(t, w, tdt, ulps=1)
                else:
                    _within_ulps(t, w, tdt if name == "p" else torch.float32)
        assert differ <= 0.01 * sum(t.numel() for t in A.leaves(tp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_update_is_bit_equal_to_the_functional_one(dtype):
    p, g, m, v = _tree()
    pc = A.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12,
                       weight_decay=0.01)
    fp, fs, fm = A.apply_updates(pc, *_port_state(p, g, m, v, 3, dtype))
    ip, ig, istate = _port_state(p, g, m, v, 3, dtype)
    ptrs = [t.data_ptr() for t in A.leaves(ip) + A.leaves(istate.m)]
    istate, im = A.apply_updates_(pc, ip, ig, istate)
    assert [t.data_ptr() for t in A.leaves(ip) + A.leaves(istate.m)] == ptrs
    assert int(istate.step) == int(fs.step) == 4
    for k in ("lr", "grad_norm"):
        assert torch.equal(im[k], fm[k])
    for a, b in zip(A.leaves(ip) + A.leaves(istate.m) + A.leaves(istate.v),
                    A.leaves(fp) + A.leaves(fs.m) + A.leaves(fs.v)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- compression -------------------------------------------------------------


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(64, 64)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(33,)) * scale * 1e-3).astype(np.float32)},
            "z": np.zeros((5,), np.float32)}


def test_ef_compress_is_bit_equal_over_steps():
    """Five steps of error feedback from the same gradients: q, the scales
    and the carried errors equal the reference's at every step."""
    e_ref = RC.init_errors(jax.tree.map(jnp.asarray, _grads(0)))
    e = C.init_errors(P.params_from_numpy(_grads(0), "cpu", torch.float32))
    for step in range(5):
        g = _grads(step, scale=10.0 ** (step - 2))
        rq, rs, e_ref = RC.ef_compress(jax.tree.map(jnp.asarray, g), e_ref)
        q, s, e = C.ef_compress(P.params_from_numpy(g, "cpu", torch.float32), e)
        for a, b in zip(jax.tree.leaves(rq), A.leaves(q)):
            assert b.dtype == torch.int8
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for tree_ref, tree in ((rs, s), (e_ref, e)):
            for a, b in zip(jax.tree.leaves(tree_ref), A.leaves(tree)):
                np.testing.assert_array_equal(_np(b), _np(a))
        for a, b in zip(jax.tree.leaves(RC.ef_decompress(rq, rs)),
                        A.leaves(C.ef_decompress(q, s))):
            np.testing.assert_array_equal(_np(b), _np(a))


def test_roundtrip_error_bounded():
    g = P.params_from_numpy({"w": _grads(0)["w"]}, "cpu", torch.float32)
    q, s, _ = C.ef_compress(g, C.init_errors(g))
    err = float((C.ef_decompress(q, s)["w"] - g["w"]).abs().max())
    assert err <= float(s["w"]) * 0.5 + 1e-6
    assert q["w"].dtype == torch.int8


def test_error_feedback_accumulates():
    g = {"w": torch.full((128,), 0.001)}
    e = C.init_errors(g)
    total = torch.zeros(128)
    for _ in range(50):
        q, s, e = C.ef_compress(g, e)
        total = total + C.ef_decompress(q, s)["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(), rtol=0.2)


_RANK = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.optim import compression as C
from repro_torch.optim.adamw import leaves
rank, store, out, seeds = sys.argv[1], sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
rank = int(rank)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
try:
    rng = np.random.default_rng(seeds[rank])
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32),
         "b": rng.normal(size=(33,)).astype(np.float32) * 1e-3}
    e = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-3
         for k, v in g.items()}
    synced, new_e = C.compressed_psum(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in e.items()})
    np.savez(out, **{"out/" + k: synced[k].numpy() for k in synced},
             **{"e/" + k: new_e[k].numpy() for k in new_e})
finally:
    dist.destroy_process_group()
"""

_MESH = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.optim.compression import compressed_psum
out, seed = sys.argv[1], int(sys.argv[2])
mesh = jax.make_mesh((2,), ("data",))
rng = np.random.default_rng(seed)
g = {"w": jnp.asarray(rng.normal(size=(64, 64)).astype(np.float32)),
     "b": jnp.asarray(rng.normal(size=(33,)).astype(np.float32) * 1e-3)}
e = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 1e-3)
     for k, v in g.items()}
with mesh:
    synced, new_e = jax.jit(lambda g, e: compressed_psum(g, e, mesh, "data"))(g, e)
np.savez(out, **{"out/" + k: np.asarray(synced[k]) for k in synced},
         **{"e/" + k: np.asarray(new_e[k]) for k in new_e})
"""


def _inputs(seed):
    """The gradients and errors each rank script draws from ``seed``."""
    rng = np.random.default_rng(seed)
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32),
         "b": rng.normal(size=(33,)).astype(np.float32) * 1e-3}
    e = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-3
         for k, v in g.items()}
    return g, e


def _run_ranks(tmp_path, seeds):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
         str(outs[r]), json.dumps(seeds)], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
    finally:
        for p in procs:
            p.kill()
    return [dict(np.load(o)) for o in outs]


def test_compressed_psum_on_gloo_equals_the_two_device_mesh(tmp_path):
    """The reference's sync runs on replicated gradients (its in_specs are
    ``P()``), so both ranks pass the same seeded gradients and errors; the
    port's int32 sum and scale sum then give the reference's bits."""
    got = _run_ranks(tmp_path, [7, 7])
    r = subprocess.run([sys.executable, "-c", _MESH, str(tmp_path / "mesh.npz"),
                        "7"], capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    want = dict(np.load(tmp_path / "mesh.npz"))
    assert sorted(want) == sorted(got[0]) == sorted(got[1])
    g, e = _inputs(7)
    for k in ("w", "b"):
        amax = float(np.abs(g[k] + e[k]).max())
        for rank in got:
            np.testing.assert_array_equal(rank["out/" + k], want["out/" + k])
            np.testing.assert_allclose(rank["e/" + k], want["e/" + k], rtol=0,
                                       atol=np.finfo(np.float32).eps * amax)


def test_compressed_psum_averages_distinct_gradients(tmp_path):
    """Ranks with their own gradients: each gets sum(q) * (sum(scale) / 2)
    / 2 of the port's own ``ef_compress``, and that is near the mean."""
    got = _run_ranks(tmp_path, [3, 4])
    qs, ss, gs = [], [], []
    for seed in (3, 4):
        g, e = _inputs(seed)
        q, s, _ = C.ef_compress(P.params_from_numpy(g, "cpu", torch.float32),
                                P.params_from_numpy(e, "cpu", torch.float32))
        qs.append(q), ss.append(s), gs.append(g)
    for k in ("w", "b"):
        want = ((qs[0][k].to(torch.int32) + qs[1][k].to(torch.int32)).float()
                * ((ss[0][k] + ss[1][k]) / 2) / 2).numpy()
        for rank in got:
            np.testing.assert_array_equal(rank["out/" + k], want)
        mean = (gs[0][k] + gs[1][k]) / 2
        bound = float(ss[0][k] + ss[1][k]) + 2e-3
        assert np.abs(got[0]["out/" + k] - mean).max() <= bound
