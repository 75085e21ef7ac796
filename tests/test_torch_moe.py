"""The port's MoE dispatch against the reference's, on the CPU.

Port twin of ``tests/test_moe.py`` (banked equals gather at capacity 4.0,
where nothing drops, at its 2e-4; the auxiliary losses finite, aux >= 1;
drops graceful; capacity lane-aligned), and ``repro_torch.models.moe``
against ``repro.models.moe`` on the reduced olmoe-1b-7b config and the same
weights and inputs: ``capacity`` for 1-512 tokens, both dispatches and both
auxiliary losses at 1e-5 of the output's scale (max |want|, at least 1),
bf16 at 2e-2.  Also the two traps of ``ROADMAP.md`` C.12: exact router ties
select the lowest expert indices, as ``jax.lax.top_k`` does, and dropped
assignments (a capacity factor that forces drops) add zero rows onto the
last slot, so the output is the reference's.  ``_assign``'s slots, bit for
bit, against a plain loop's exclusive counts: 4-128 experts, 1-131,072
assignments, uniform, Zipf and single-expert ids, with and without drops.
The banked dispatch's flat slot index (``index_add_`` / ``index_select``)
against the (expert, slot) ``index_put_`` and advanced index it replaced:
the output and every gradient equal, without drops, with drops on a skewed
expert and with a held share.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from torch_moe_indexed import indexed_banked  # noqa: E402

NAME = "olmoe-1b-7b"
F32, BF16 = 1e-5, 2e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=F32):
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


def _layer(name=NAME, dtype="float32", **over):
    """(port cfg, reference cfg, port layer-0 moe params, reference's)."""
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype, **over)
    rcfg = dataclasses.replace(ref_config(name).reduced(), dtype=dtype, **over)
    tree = jax.tree.map(_np, RP.init_params(rcfg, seed=0))
    lp = jax.tree.map(lambda a: a[0], tree["blocks"])["lyr"]["moe"]
    rlp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.dtype(dtype)), lp)
    return cfg, rcfg, P.params_from_numpy(lp, "cpu", dtype), rlp


def _x(cfg, shape=(2, 16), dtype="float32", seed=0):
    x = np.random.default_rng(seed).normal(size=(*shape, cfg.d_model))
    x = x.astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(jnp.dtype(dtype)))


# == twin of tests/test_moe.py ===============================================


@pytest.fixture(scope="module")
def setup():
    # generous capacity so no tokens drop -> banked == gather
    cfg, _, p, _ = _layer(moe_capacity_factor=4.0)
    x, _ = _x(cfg)
    return cfg, p, x


def test_banked_matches_gather(setup):
    cfg, p, x = setup
    yb, _ = MOE.moe_block(dataclasses.replace(cfg, moe_dispatch="banked"), p, x)
    yg, _ = MOE.moe_block(dataclasses.replace(cfg, moe_dispatch="gather"), p, x)
    np.testing.assert_allclose(yb.numpy(), yg.numpy(), rtol=2e-4, atol=2e-4)


def test_aux_losses_finite(setup):
    cfg, p, x = setup
    _, aux = MOE.moe_block(cfg, p, x)
    assert np.isfinite(float(aux["moe_aux"]))
    assert np.isfinite(float(aux["moe_zloss"]))
    assert float(aux["moe_aux"]) >= 1.0 - 1e-3   # >= 1 by Cauchy-Schwarz


def test_capacity_drops_are_graceful(setup):
    cfg, p, x = setup
    y, _ = MOE.moe_block(dataclasses.replace(cfg, moe_capacity_factor=0.25),
                         p, x)
    assert bool(torch.isfinite(y).all())


def test_capacity_lane_aligned(setup):
    cfg, _, _ = setup
    assert MOE.capacity(cfg, 1024) % 8 == 0


# == against the reference ===================================================


@pytest.mark.parametrize("name", [NAME, "granite-moe-1b-a400m"])
@pytest.mark.parametrize("factor", [0.25, 1.25, 4.0, 8.0])
def test_capacity_matches_reference(name, factor):
    for full in (False, True):
        cfg, rcfg = get_config(name), ref_config(name)
        if not full:
            cfg, rcfg = cfg.reduced(), rcfg.reduced()
        cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
        rcfg = dataclasses.replace(rcfg, moe_capacity_factor=factor)
        assert [MOE.capacity(cfg, t) for t in range(1, 513)] \
            == [RMOE.capacity(rcfg, t) for t in range(1, 513)]


@pytest.mark.parametrize("dispatch", ["banked", "gather"])
@pytest.mark.parametrize("name,act", [(NAME, "silu"),
                                      ("granite-moe-1b-a400m", "silu"),
                                      (NAME, "gelu")])
def test_moe_block_matches_reference(name, act, dispatch):
    """Both dispatches and both auxiliary losses; gelu takes the ungated
    expert FFN (no ``wg``)."""
    cfg, rcfg, p, rp = _layer(name, act=act, moe_dispatch=dispatch)
    assert ("wg" in p) == (act == "silu")
    x, jx = _x(cfg)
    y, aux = MOE.moe_block(cfg, p, x)
    ry, raux = RMOE.moe_block(rcfg, rp, jx)
    assert y.dtype == torch.float32 and y.shape == x.shape
    _close(y, ry)
    assert sorted(aux) == sorted(raux) == ["moe_aux", "moe_zloss"]
    for k in aux:
        assert aux[k].dtype == torch.float32 and aux[k].shape == ()
        _close(aux[k], raux[k])


def test_moe_block_bf16_matches_reference():
    """bf16 in, bf16 out; the router in float32 in both packages."""
    cfg, rcfg, p, rp = _layer(dtype="bfloat16")
    x, jx = _x(cfg, dtype="bfloat16")
    y, aux = MOE.moe_block(cfg, p, x)
    ry, raux = RMOE.moe_block(rcfg, rp, jx)
    assert y.dtype == torch.bfloat16 and aux["moe_aux"].dtype == torch.float32
    _close(y, ry, BF16)
    for k in aux:
        _close(aux[k], raux[k], BF16)


def test_decode_may_skip_the_auxiliary_losses():
    """``aux=False`` (the decode step's) returns the same output, no losses."""
    cfg, _, p, _ = _layer()
    x, _ = _x(cfg, (4, 1))
    y, aux = MOE.moe_block(cfg, p, x)
    y0, aux0 = MOE.moe_block(cfg, p, x, aux=False)
    assert aux0 == {} and sorted(aux) == ["moe_aux", "moe_zloss"]
    assert torch.equal(y, y0)


def test_exact_ties_select_the_lowest_experts():
    """C.12a: with a zero router every token's probabilities tie exactly;
    ``jax.lax.top_k`` then takes experts 0..k-1, and so does the port."""
    cfg, rcfg, p, rp = _layer()
    p["router"].zero_()
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    x, jx = _x(cfg)
    x2 = x.reshape(-1, cfg.d_model)
    top_p, top_i, _ = MOE._router(cfg, p, x2)
    rtop_p, rtop_i, _ = RMOE._router(rcfg, rp, jx.reshape(-1, cfg.d_model))
    k = cfg.experts_per_token
    want = np.tile(np.arange(k), (x2.shape[0], 1))
    np.testing.assert_array_equal(np.asarray(rtop_i), want)
    np.testing.assert_array_equal(top_i.numpy(), want)
    np.testing.assert_array_equal(top_p.numpy(), np.asarray(rtop_p))
    y, _ = MOE.moe_block(cfg, p, x)
    ry, _ = RMOE.moe_block(rcfg, rp, jx)
    _close(y, ry)


@pytest.mark.parametrize("factor", [0.25, 0.5])
def test_dropped_assignments_match_reference(factor):
    """C.12b: at a capacity factor that forces drops, the dropped
    assignments add zero rows onto each expert's last slot; the output is
    the reference's (an overwrite would zero the last slot's real row)."""
    cfg, rcfg, p, rp = _layer(moe_capacity_factor=factor)
    x, jx = _x(cfg, (4, 16))
    t, k = 64, cfg.experts_per_token
    _, top_i, _ = MOE._router(cfg, p, x.reshape(t, cfg.d_model))
    load = torch.bincount(top_i.reshape(-1), minlength=cfg.num_experts)
    assert int(load.max()) > MOE.capacity(cfg, t)          # drops happen
    y, _ = MOE.moe_block(cfg, p, x)
    ry, _ = RMOE.moe_block(rcfg, rp, jx)
    _close(y, ry)
    full, _ = MOE.moe_block(dataclasses.replace(cfg, moe_capacity_factor=8.0),
                            p, x)
    assert float((full - y).abs().max()) > 1e-3            # the drops show


# == the capacity assignment =================================================


def _exclusive_counts(eid):
    """Each assignment's count of earlier assignments to its expert."""
    seen, out = {}, []
    for e in eid:
        out.append(seen.get(e, 0))
        seen[e] = out[-1] + 1
    return out


def _ids(e, n, kind):
    """(n,) expert ids: uniform, Zipf-skewed onto a shuffled ranking of the
    experts, or all on one expert."""
    rng = np.random.default_rng([e, n, len(kind)])
    if kind == "uniform":
        return rng.integers(0, e, n)
    if kind == "zipf":
        w = 1.0 / np.arange(1, e + 1) ** 1.1
        return rng.permutation(e)[rng.choice(e, n, p=w / w.sum())]
    return np.full(n, e // 2)


@pytest.mark.parametrize("room", ["drops", "keeps_all"])
@pytest.mark.parametrize("kind", ["uniform", "zipf", "one_expert"])
@pytest.mark.parametrize("n", [1, 7, 1024, 131_072])
@pytest.mark.parametrize("e", [4, 32, 64, 128])
def test_assign_matches_exclusive_counts(e, n, kind, room):
    """``_assign``'s slot is the number of earlier assignments to the same
    expert in token-major order, bit for bit, with ``keep`` and the clamped
    slot derived from it; expert ids and gates pass through."""
    ids = _ids(e, n, kind)
    k = 8 if n % 8 == 0 else 1
    top_i = torch.from_numpy(ids).reshape(n // k, k)
    top_p = torch.from_numpy(
        np.random.default_rng(n).random(n, dtype=np.float32)).reshape(n // k, k)
    cap = max(1, n // (2 * e)) if room == "drops" else n
    eid, gate, keep, pos_c = MOE._assign(top_p, top_i, cap)
    want = torch.tensor(_exclusive_counts(ids.tolist()), dtype=torch.int64)
    assert torch.equal(eid, top_i.reshape(-1))
    assert torch.equal(gate, top_p.reshape(-1))
    assert torch.equal(keep, want < cap)
    assert pos_c.dtype == torch.int64
    assert torch.equal(pos_c, torch.clamp_max(want, cap - 1))
    if n > e * cap:                                  # drops by pigeonhole
        assert not bool(keep.all())


# == the flat slot index =====================================================


# (config, changes, the expert the router is skewed toward or None)
FLAT_CASES = {
    "no_drops": (NAME, {"moe_capacity_factor": 8.0}, None),
    "skewed_drops": (NAME, {"moe_capacity_factor": 0.5}, 1),
    "held_share": ("deepseek-v2-lite-ep8", {"expert_offset": 4}, 5),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_slot_index_equals_the_expert_slot_index(case, dtype):
    """The output and the gradients of x, the router, w1, wg and w2 equal,
    bit for bit, those of the (expert, slot) formulation: every kept
    assignment has a slot of its own and every other row added to a slot
    is zero, so no sum depends on the order of its addends."""
    name, changes, skew = FLAT_CASES[case]
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype,
                              **changes)
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(31)
    p = {}
    for leaf in ("router", "w1", "wg", "w2"):
        shape = P.moe_shapes(cfg)[leaf][0]
        p[leaf] = (torch.randn(*shape, generator=g)
                   / shape[-2] ** 0.5).to(dt).requires_grad_(True)
    if skew is not None:
        with torch.no_grad():
            p["router"][:, skew] += 0.5
    x = torch.randn(2, 32, cfg.d_model, generator=g).to(dt).requires_grad_(True)
    dy = torch.randn(2, 32, cfg.d_model, generator=g)
    t = x.shape[0] * x.shape[1]
    _, top_i, _ = MOE._router(cfg, p, x.detach().reshape(t, cfg.d_model))
    held = top_i.reshape(-1) - cfg.expert_offset
    held = held[(held >= 0) & (held < cfg.num_experts)]
    load = torch.bincount(held, minlength=cfg.num_experts)
    drops = int(load.max()) > MOE.capacity(cfg, t)
    assert drops == (skew is not None)
    assert (held.numel() < top_i.numel()) == (case == "held_share")
    leaves = [x] + [p[k] for k in ("router", "w1", "wg", "w2")]
    runs = []
    for fn in (MOE.moe_block_banked, indexed_banked):
        y, aux = fn(cfg, p, x)
        loss = (y.float() * dy).sum() + aux["moe_aux"] + aux["moe_zloss"]
        runs.append([y, *torch.autograd.grad(loss, leaves)])
    for got, want, what in zip(*runs, ["y", "x", "router", "w1", "wg", "w2"]):
        assert got.dtype == want.dtype and torch.equal(got, want), what
        assert bool(want.abs().sum() > 0), what
