"""The port's RWKV6 (``family="ssm"``) against the reference's, on the CPU.

``repro_torch.models.rwkv`` and the ssm branches of ``transformer`` and
``decode`` against ``repro.models.*`` on the reduced rwkv6-7b config and
the same weights, with the two low-rank adapters (``mix_B``, ``wlora_B``)
drawn non-zero: they are zeros at init, so seeded weights alone never
exercise them.  float32 at 1e-5 relative to the output's scale (max |want|,
at least 1; ``tests/test_torch_decode.py``'s tolerance), decode vs forward
at 2e-2 (``tests/test_decode_consistency.py``).  Also: the shift caches
hold the normed inputs (``ROADMAP.md`` C.10), the slot surgery and the
sliced step bit for bit, the engine's token streams and ``--stable`` span
streams equal to the reference engine's (plain and under a fault plan;
the twins of ``tests/test_serve_spans.py::test_non_transformer_family_spans``
and ``tests/test_serve_faults.py``'s chaos run), and the streamed weight
draw bit for bit against ``init_numpy_params`` for every config.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.launch import faults as RFLT  # noqa: E402
from repro.launch import resilience as RRES  # noqa: E402
from repro.launch import serve as RSV  # noqa: E402
from repro.models import decode as RD  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.models import rwkv as RR  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.obs import SpanTracer as RSpanTracer  # noqa: E402
from repro_torch.launch import faults as FLT  # noqa: E402
from repro_torch.launch import resilience as RES  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import all_names, get_config  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import SpanTracer, spans as SP, traffic  # noqa: E402

NAME = "rwkv6-7b"
F32 = 1e-5
DECODE_TOL = 2e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=F32):
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _both(dtype="float32", lora=True, **over):
    """(port cfg, reference cfg, port params, reference params): the
    reference's seeded weights, ``mix_B`` and ``wlora_B`` redrawn non-zero
    when ``lora``, the same values in both packages."""
    cfg = dataclasses.replace(get_config(NAME).reduced(), dtype=dtype, **over)
    rcfg = dataclasses.replace(ref_config(NAME).reduced(), dtype=dtype, **over)
    tree = jax.tree.map(_np, RP.init_params(rcfg, seed=0))
    if lora:
        rng = np.random.default_rng(9)
        tm = tree["blocks"]["lyr"]["tm"]
        for key, std in (("mix_B", 0.05), ("wlora_B", 0.02)):
            tm[key] = (rng.normal(size=tm[key].shape) * std).astype(np.float32)
    rprm = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.dtype(dtype)), tree)
    return cfg, rcfg, P.params_from_numpy(tree, "cpu", dtype), rprm


def _group0(prm, rprm):
    return (T.group_params(prm["blocks"], 0)["lyr"],
            jax.tree.map(lambda a: a[0], rprm["blocks"])["lyr"])


def _x(cfg, s, seed=4):
    x = np.random.default_rng(seed).normal(size=(2, s, cfg.d_model))
    x = x.astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def _ref_step(rcfg):
    return jax.jit(lambda p, c, t, pos: RD.serve_step(rcfg, p, c, t, pos))


# == the model ===============================================================


@pytest.mark.parametrize("s", [12, 128])
@pytest.mark.parametrize("op", ["time_mix", "channel_mix", "rwkv_block"])
def test_blocks_match_reference(op, s):
    """At 128 tokens the scan runs two chunks of 64."""
    cfg, rcfg, prm, rprm = _both()
    p, rp = _group0(prm, rprm)
    if op != "rwkv_block":
        key = "tm" if op == "time_mix" else "cm"
        p, rp = p[key], rp[key]
    x, jx = _x(cfg, s)
    got = getattr(R, op)(cfg, p, x)
    want = getattr(RR, op)(rcfg, rp, jx)
    assert got.shape == (2, s, cfg.d_model) and got.dtype == torch.float32
    _close(got, want)


def test_the_low_rank_adapters_move_the_output():
    """The redrawn ``mix_B``/``wlora_B`` change time_mix's output, so the
    comparisons above hold both adapter paths."""
    cfg, _, prm, _ = _both()
    cfg0, _, prm0, _ = _both(lora=False)
    x, _ = _x(cfg, 12)
    with_lora = R.time_mix(cfg, T.group_params(prm["blocks"], 0)["lyr"]["tm"], x)
    without = R.time_mix(cfg0, T.group_params(prm0["blocks"], 0)["lyr"]["tm"],
                         x)
    assert float((with_lora - without).abs().max()) > 1e-2


@pytest.mark.parametrize("s", [12, 128])
def test_forward_and_loss_match_reference(s):
    cfg, rcfg, prm, rprm = _both()
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, s))
    logits, aux = T.forward(cfg, prm, torch.from_numpy(tokens))
    rlogits, _ = RT.forward(rcfg, rprm, jnp.asarray(tokens))
    assert aux == {} and logits.shape == (2, s, cfg.vocab_size)
    _close(logits, rlogits)
    loss, _ = T.loss_fn(cfg, prm, {"tokens": torch.from_numpy(tokens)})
    rloss, _ = RT.loss_fn(rcfg, rprm, {"tokens": jnp.asarray(tokens)})
    _close(loss, rloss)


def test_forward_refuses_a_sequence_the_chunk_does_not_divide():
    """C.9 at the model: RWKV's scan runs at chunk 64, so 80 tokens fail in
    the reference (its assert) and in the port (``ValueError``)."""
    cfg, rcfg, prm, rprm = _both()
    tokens = np.zeros((1, 80), np.int64)
    with pytest.raises(AssertionError):
        RT.forward(rcfg, rprm, jnp.asarray(tokens))
    with pytest.raises(ValueError, match="divide"):
        T.forward(cfg, prm, torch.from_numpy(tokens))


# == decode ==================================================================


def test_serve_step_matches_reference():
    """Logits every step and the O(1) state after the last, at 1e-5."""
    cfg, rcfg, prm, rprm = _both()
    b, steps = 2, 12
    cache = D.init_cache(cfg, prm, b, steps + 2)
    rcache = RD.init_cache(rcfg, rprm, b, steps + 2)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, steps))
    rstep = _ref_step(rcfg)
    for i in range(steps):
        logits, cache = D.serve_step(cfg, prm, cache, torch.from_numpy(
            tokens[:, i:i + 1]), i)
        rlogits, rcache = rstep(rprm, rcache, jnp.asarray(tokens[:, i:i + 1]),
                                jnp.asarray(i, jnp.int32))
        assert logits.shape == (b, 1, cfg.vocab_size)
        _close(logits, rlogits)
    got, want = dict(_leaves(cache)), dict(_leaves(rcache))
    assert sorted(got) == sorted(want) == ["/lyr/shift_cm", "/lyr/shift_tm",
                                          "/lyr/wkv"]
    for path, leaf in got.items():
        assert leaf.shape == want[path].shape, path
        assert str(leaf.dtype).replace("torch.", "") == str(want[path].dtype)
        _close(leaf, want[path])


def test_decode_matches_forward():
    """Teacher-forced decode reproduces the port's forward within 2e-2
    (the twin of tests/test_decode_consistency.py), adapters non-zero."""
    cfg, _, prm, _ = _both()
    b, s = 2, 16
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)))
    full, _ = T.forward(cfg, prm, tokens)
    cache = D.init_cache(cfg, prm, b, max_len=s + 4)
    errs = []
    for i in range(s):
        logits_i, cache = D.serve_step(cfg, prm, cache, tokens[:, i:i + 1], i)
        errs.append(float((logits_i[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < DECODE_TOL, f"max logit divergence {max(errs):.4f}"


def test_shift_caches_hold_the_normed_inputs():
    """C.10: after one step from an empty cache, ``shift_tm`` holds ln1 of
    the embedded token (not the residual stream) and ``shift_cm`` ln2 of
    the stream after the time mix."""
    cfg, _, prm, _ = _both()
    tok = torch.tensor([[3], [7]])
    cache = D.init_cache(cfg, prm, 2, 4)
    D.serve_step(cfg, prm, cache, tok, 0)
    p = T.group_params(prm["blocks"], 0)["lyr"]
    x1 = C.embed(cfg, prm, tok)
    xn = C.layer_norm(x1, p["ln1"]["w"], p["ln1"]["b"])
    assert torch.equal(cache["lyr"]["shift_tm"][0], xn)
    x2, _ = R.rwkv_time_mix_step(cfg, p, x1, {
        "wkv": torch.zeros_like(cache["lyr"]["wkv"][0]),
        "shift_tm": torch.zeros_like(xn)})
    xn2 = C.layer_norm(x2, p["ln2"]["w"], p["ln2"]["b"])
    assert torch.equal(cache["lyr"]["shift_cm"][0], xn2)
    assert not torch.equal(cache["lyr"]["shift_tm"][0], x1)


@pytest.mark.parametrize("form", ["fused", "per-group list"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_surgery_matches_reference_bit_for_bit(dtype, form):
    """Port twin of tests/test_serve_faults.py's slot surgery on identical
    caches after one step (in bf16 the wkv leaf is then float32 and the
    shift leaves bf16, C.13): corrupt slot 1, then reset slot 0, in both
    packages; every leaf equal bit for bit, NaNs in place."""
    cfg, rcfg, prm, _ = _both(dtype)
    cache = D.init_cache(cfg, prm, 3, 8)
    D.serve_step(cfg, prm, cache, torch.tensor([[1], [2], [3]]), 0)
    rcache = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        str(t.dtype).replace("torch.", "")), cache)
    work = cache if form == "fused" else \
        [T.group_params(cache, g) for g in range(cfg.num_groups)]
    D.reset_cache_slot(cfg, D.corrupt_cache_slot(cfg, work, 1), 0)
    rcache = RD.reset_cache_slot(rcfg, RD.corrupt_cache_slot(rcfg, rcache, 1), 0)
    got, want = dict(_leaves(cache)), dict(_leaves(rcache))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert str(leaf.dtype).replace("torch.", "") == str(want[path].dtype)
        np.testing.assert_array_equal(_np(leaf), _np(want[path]), path)
        rows = leaf.movedim(1, 0)
        assert bool(rows[1].isnan().all()) and not rows[0].any()
        assert bool(rows[2].isfinite().all())


def test_profiled_step_holds_the_state_in_f32_in_both_forms():
    """C.13 in bf16: the fused and the sliced step both hold the wkv state
    in float32 from the first step on (the list form as views of one
    stacked tensor), with the reference's cache bytes, and give the same
    logits and cache bit for bit through a corruption and quarantine."""
    cfg, rcfg, prm, rprm = _both("bfloat16")
    fused, prof = D.make_serve_step(cfg), D.make_profiled_serve_step(cfg)
    cache_f = D.init_cache(cfg, prm, 2, 8)
    cache_p = D.ProfiledServeStep.init_cache(cfg, prm, 2, 8)
    rcache = RD.init_cache(rcfg, rprm, 2, 8)
    assert cache_f["lyr"]["wkv"].dtype == torch.bfloat16
    assert D.cache_num_bytes(cache_f) == D.cache_num_bytes(cache_p) \
        == RD.cache_num_bytes(rcache)
    tok = torch.tensor([[5], [9]])
    rstep = _ref_step(rcfg)
    for i in range(5):
        if i == 3:
            for c in (cache_f, cache_p):
                D.corrupt_cache_slot(cfg, c, 0)
                D.reset_cache_slot(cfg, c, 0)
        lf, cache_f = fused(prm, cache_f, tok, i)
        lp, cache_p, walls = prof(prm, cache_p, tok, i)
        _, rcache = rstep(rprm, rcache, jnp.asarray(tok.numpy()),
                          jnp.asarray(i, jnp.int32))
        assert torch.equal(lf, lp) and len(walls) == len(D.profile_ops(cfg))
        assert cache_f["lyr"]["wkv"].dtype == torch.float32
        assert all(g["lyr"]["wkv"].dtype == torch.float32 for g in cache_p)
        assert len({g["lyr"]["wkv"].untyped_storage().data_ptr()
                    for g in cache_p}) == 1
        assert cache_f["lyr"]["shift_tm"].dtype == torch.bfloat16
        assert D.cache_num_bytes(cache_f) == D.cache_num_bytes(cache_p) \
            == RD.cache_num_bytes(rcache)
        tok = lf[:, -1].argmax(-1)[:, None]
    stacked = D.ProfiledServeStep.stack_cache(cache_p)
    for (pa, a), (pb, b) in zip(_leaves(cache_f), _leaves(stacked)):
        assert pa == pb and torch.equal(a, b)


# == the engine ==============================================================


def _engine_pair(plan=None, requests=3, mean=0.0, prompt_lens=(3,),
                 gen_lens=(4,), slots=2):
    """The port's and the reference's engines on the reduced config's seeded
    weights and one arrival trace (``tests/test_serve_spans.py``'s run)."""
    cfg, rcfg = get_config(NAME).reduced(), ref_config(NAME).reduced()
    trace = traffic.synth_trace(0, requests, mean, prompt_lens, gen_lens)
    max_len = 4 * (traffic.total_tokens(trace)
                   + max(t.prompt_len + t.gen_len for t in trace)) + 64
    out = []
    for sv, make_params, tracer, faults, resilience in (
            (SV, lambda: P.init_params(cfg, 0, "cpu"), SpanTracer, FLT, RES),
            (RSV, lambda: RP.init_params(rcfg, 0), RSpanTracer, RFLT, RRES)):
        rng = np.random.default_rng(1)
        arrivals = [(t.arrival_step, sv.Request(t.rid, rng.integers(
            1, cfg.vocab_size, size=t.prompt_len).astype(np.int32), t.gen_len))
            for t in trace]
        kw = {"device": "cpu"} if sv is SV else {}
        if plan is not None:
            kw.update(faults=faults.FaultPlan.from_json(plan.to_json()),
                      resilience=resilience.ResilienceConfig(
                          deadline_ticks=300, seed=0))
        tr = tracer()
        eng = sv.Engine(cfg if sv is SV else rcfg, make_params(), slots,
                        max_len, spans=tr, **kw)
        sv.replay(eng, arrivals)
        out.append((eng, tr))
    return out


def test_engine_spans_and_tokens_match_reference():
    """Twin of test_non_transformer_family_spans: valid spans, every request
    completes, and the tokens and ``--stable`` stream are the reference's."""
    (eng, tr), (reng, rtr) = _engine_pair()
    assert SP.validate(tr.events, slots=2, engine_steps=eng.steps) == []
    assert sum(r.reason == SP.FINISHED for r in eng.done) == 3
    assert {r.rid: list(r.out) for r in eng.done} \
        == {r.rid: list(r.out) for r in reng.done}
    assert SP.to_jsonl(tr.events, stable=True) \
        == SP.to_jsonl(rtr.events, stable=True)


def test_chaos_run_matches_reference():
    """Twin of test_chaos_runs_are_byte_identical on RWKV6: NaN logits,
    exceptions, latency spikes and cache corruptions under resilience; no
    request lost, and the port's ``--stable`` stream is the reference's."""
    plan = FLT.FaultPlan.generate(11, 96, 0.15, 2,
                                  kinds=(FLT.NAN_LOGITS, FLT.EXCEPTION,
                                         FLT.LATENCY_SPIKE, FLT.CACHE_CORRUPT),
                                  spike_ticks=3, spike_us=200)
    (eng, tr), (reng, rtr) = _engine_pair(plan, requests=6, mean=0.5,
                                          prompt_lens=(3, 5), gen_lens=(3, 6))
    assert SP.validate(tr.events, slots=2, engine_steps=eng.steps) == []
    assert len(eng.done) == 6 and eng.faults_injected > 0
    assert eng.faults_detected == reng.faults_detected > 0
    assert SP.to_jsonl(tr.events, stable=True) \
        == SP.to_jsonl(rtr.events, stable=True)


# == the streamed draw =======================================================


@pytest.mark.parametrize("name", sorted(all_names()))
def test_streamed_draw_is_the_reference_draw(name):
    """``stream_params`` in pieces of 7 numbers (pieces that straddle rows)
    equals ``init_numpy_params``'s tree bit for bit in float32, and its
    bf16 cast (``cast_params``) equals the bf16 tree of the same numpy
    values.  (``init_params`` streams in pieces of 2**24 numbers;
    tests/test_torch_models.py holds it against the reference's draw.)"""
    cfg = get_config(name).reduced()
    tree = P.init_numpy_params(cfg, 3)
    whole = P.params_from_numpy(tree, "cpu", "float32")
    streamed = P.stream_params(cfg, seed=3, device="cpu", piece=7)
    assert [p for p, _ in _leaves(whole)] == [p for p, _ in _leaves(streamed)]
    for (_, a), (_, b) in zip(_leaves(whole), _leaves(streamed)):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    bf16 = P.params_from_numpy(tree, "cpu", "bfloat16")
    assert P.cast_params(streamed, "bfloat16") is streamed
    for (_, a), (_, b) in zip(_leaves(bf16), _leaves(streamed)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
