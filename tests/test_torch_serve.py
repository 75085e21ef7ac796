"""The port's serving engine: twins of the reference's serve tests, and its
CLI against the reference's, on the CPU.

Port twins of ``tests/test_serve_spans.py`` and ``tests/test_serve_faults.py``
(the same checks, run against ``repro_torch.launch.serve.Engine``; the slot
surgery twin is in ``tests/test_torch_decode.py``, and the non-transformer
family run is gemma2's local/global pair until RWKV6 is ported), the
layer-profiler join of ``tests/test_modelprof.py``, and the two CLIs writing
byte-identical ``--stable`` span streams and layer records under one seed,
plain and under a fault plan.  The JAX-free modules the port copies
verbatim are held to be the reference's files.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import faults as FLT  # noqa: E402
from repro_torch.launch import resilience as RES  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.launch.serve import Engine, ReplayDriver, Request, replay  # noqa: E402
from repro_torch.models import decode, get_config  # noqa: E402
from repro_torch.models import params as MP  # noqa: E402
from repro_torch.models.decode import profile_ops  # noqa: E402
from repro_torch.obs import MetricsRegistry, SpanTracer, spans as SP, traffic  # noqa: E402
from repro_torch.obs import modelprof as MPF  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 0


def _arrivals(cfg, trace, seed=SEED):
    rng = np.random.default_rng(seed + 1)
    return [(t.arrival_step,
             Request(t.rid,
                     rng.integers(1, cfg.vocab_size,
                                  size=t.prompt_len).astype(np.int32),
                     t.gen_len))
            for t in trace]


def _span_run(arch="qwen2-0.5b", slots=2, requests=6, mean=0.5,
              prompt_lens=(3, 5), gen_lens=(3, 6), max_len=None):
    """``tests/test_serve_spans.py``'s run."""
    cfg = get_config(arch).reduced()
    params = MP.init_params(cfg, seed=SEED, device="cpu")
    trace = traffic.synth_trace(SEED, requests, mean, prompt_lens, gen_lens)
    if max_len is None:
        max_len = traffic.total_tokens(trace) \
            + max(t.prompt_len + t.gen_len for t in trace) + 8
    reg = MetricsRegistry()
    tr = SpanTracer()
    eng = Engine(cfg, params, slots, max_len, metrics=reg, spans=tr,
                 device="cpu")
    replay(eng, _arrivals(cfg, trace))
    return eng, reg, tr


def _run(arch="qwen2-0.5b", slots=2, requests=6, mean=0.5,
         prompt_lens=(3, 5), gen_lens=(3, 6), max_len=None,
         plan=None, res=None, instrument=True):
    """``tests/test_serve_faults.py``'s run."""
    cfg = get_config(arch).reduced()
    params = MP.init_params(cfg, seed=SEED, device="cpu")
    trace = traffic.synth_trace(SEED, requests, mean, prompt_lens, gen_lens)
    if max_len is None:
        max_len = 4 * (traffic.total_tokens(trace)
                       + max(t.prompt_len + t.gen_len for t in trace)) + 64
    reg = MetricsRegistry() if instrument else None
    tr = SpanTracer() if instrument else None
    eng = Engine(cfg, params, slots, max_len, metrics=reg, spans=tr,
                 faults=plan, resilience=res, device="cpu")
    replay(eng, _arrivals(cfg, trace))
    return eng, reg, tr


# == twin of tests/test_serve_spans.py ======================================


@pytest.fixture(scope="module")
def qwen_run():
    return _span_run()


def test_lifecycle_invariants_hold(qwen_run):
    eng, reg, tr = qwen_run
    assert SP.validate(tr.events, slots=2, engine_steps=eng.steps) == []


def test_every_request_completes(qwen_run):
    eng, reg, tr = qwen_run
    summaries = SP.summarize(tr.events)
    assert sorted(summaries) == list(range(6))
    assert all(s.reason == SP.FINISHED for s in summaries.values())
    assert int(reg.get("serve_requests_completed_total").value) == 6
    assert int(reg.get("serve_requests_truncated_total").value) == 0
    # phase chain complete and monotone for every finished request
    for s in summaries.values():
        chain = [s.enqueue_us, s.admit_us, s.prefill_us,
                 s.first_token_us, s.complete_us]
        assert all(v >= 0 for v in chain), s
        assert chain == sorted(chain), s
        assert s.ttft_us >= 0


def test_step_events_match_engine_steps(qwen_run):
    eng, reg, tr = qwen_run
    step_events = [e for e in tr.events if e.kind == SP.STEP]
    assert len(step_events) == eng.steps
    assert int(reg.get("serve_engine_steps_total").value) == eng.steps
    assert [e.step for e in step_events] == list(range(eng.steps))


def test_token_accounting_matches_metrics(qwen_run):
    eng, reg, tr = qwen_run
    gen_from_engine = sum(len(r.out) for r in eng.done)
    gen_from_steps = sum(e.data[2] for e in tr.events if e.kind == SP.STEP)
    gen_from_spans = sum(s.tokens for s in SP.summarize(tr.events).values())
    assert gen_from_engine == gen_from_steps == gen_from_spans \
        == int(reg.get("serve_tokens_generated_total").value)
    pre_from_steps = sum(e.data[3] for e in tr.events if e.kind == SP.STEP)
    assert pre_from_steps \
        == int(reg.get("serve_tokens_prefill_total").value) \
        == sum(r.fed for r in eng.done)
    util = SP.slot_utilization(tr.events, 2)
    assert 0.0 < util <= 1.0


def test_latency_histograms_populated(qwen_run):
    eng, reg, tr = qwen_run
    ttft = reg.get("serve_ttft_us")
    assert ttft.count == 6
    assert ttft.quantile(0.5) >= 0
    step_h = reg.get("serve_step_latency_us")
    assert step_h.count == eng.steps
    # every request generated >= 2 tokens, so decode latency is defined
    assert reg.get("serve_decode_token_us").count == 6


def test_truncation_reason_and_counter():
    # max_len too small for the workload: the engine must truncate with a
    # reason rather than lose requests, and the spans must stay valid
    eng, reg, tr = _span_run(requests=4, mean=0.0, prompt_lens=(4,),
                        gen_lens=(32,), max_len=12)
    assert SP.validate(tr.events, slots=2, engine_steps=eng.steps) == []
    assert len(eng.done) == 4
    truncated = [r for r in eng.done
                 if r.reason == SP.TRUNCATED_PREFIX + "max_len"]
    assert truncated, "expected at least one truncated request"
    assert int(reg.get("serve_requests_truncated_total").value) \
        == len(truncated)
    summaries = SP.summarize(tr.events)
    assert all(s.reason == SP.FINISHED
               or s.reason.startswith(SP.TRUNCATED_PREFIX)
               for s in summaries.values())


def test_per_reason_truncation_counters():
    # the aggregate truncation counter decomposes exactly into the
    # per-reason companions; max_len truncations land on their own counter
    eng, reg, tr = _span_run(requests=4, mean=0.0, prompt_lens=(4,),
                        gen_lens=(32,), max_len=12)
    total = int(reg.get("serve_requests_truncated_total").value)
    assert total > 0
    by_reason = {reason: int(reg.get(
        f"serve_requests_truncated_{reason}_total").value)
        for reason in ("max_len", "deadline", "shed", "fault",
                       "quarantine_retry_exhausted")}
    assert by_reason["max_len"] == total
    assert sum(by_reason.values()) == total


def test_ttft_sentinel_never_reaches_histogram():
    # requests truncated before emitting any token must not contribute a
    # TTFT sample (the first_token_us = -1 sentinel regression): max_len=6
    # kills the second wave mid-prefill with zero generated tokens
    eng, reg, tr = _span_run(requests=4, mean=0.0, prompt_lens=(4,),
                        gen_lens=(32,), max_len=6)
    tokenless = [r for r in eng.done if not r.out]
    assert tokenless, "expected requests truncated before their first token"
    ttft = reg.get("serve_ttft_us")
    assert ttft.count == sum(bool(r.out) for r in eng.done)
    assert ttft.quantile(0.0) >= 0
    assert SP.validate(tr.events, slots=2, engine_steps=eng.steps) == []


def test_same_seed_runs_serialize_identically():
    _, _, tr_a = _span_run(requests=4)
    _, _, tr_b = _span_run(requests=4)
    a = SP.to_jsonl(tr_a.events, stable=True)
    b = SP.to_jsonl(tr_b.events, stable=True)
    assert a == b
    assert a  # non-empty
    # round-trip through the parser preserves the structural fields
    evs = SP.from_jsonl(a)
    assert len(evs) == len(tr_a.events)
    assert [e.kind for e in evs] == [e.kind for e in tr_a.events]
    assert [e.rid for e in evs] == [e.rid for e in tr_a.events]


def test_local_global_family_spans():
    eng, reg, tr = _span_run(arch="gemma2-27b", requests=3, mean=0.0,
                        prompt_lens=(3,), gen_lens=(4,))
    assert SP.validate(tr.events, slots=2, engine_steps=eng.steps) == []
    assert int(reg.get("serve_requests_completed_total").value) == 3


def test_uninstrumented_engine_emits_nothing():
    cfg = get_config("qwen2-0.5b").reduced()
    params = MP.init_params(cfg, seed=SEED, device="cpu")
    trace = traffic.synth_trace(SEED, 2, 0.0, (3,), (3,))
    eng = Engine(cfg, params, 2, 32, device="cpu")
    replay(eng, _arrivals(cfg, trace))
    assert eng.spans is None and eng._m is None
    assert len(eng.done) == 2


def test_validate_flags_broken_streams():
    ev = SP.SpanEvent
    # enqueue with no complete
    bad = [ev(0, SP.REQ_ENQUEUE, SP.req_prov(0), 0, 0)]
    assert any("complete" in p for p in SP.validate(bad))
    # non-monotone phase timestamps
    bad = [ev(10, SP.REQ_ENQUEUE, SP.req_prov(1), 0, 1),
           ev(5, SP.REQ_COMPLETE, SP.req_prov(1), 1, 1, 0, SP.FINISHED,
              data=(1,))]
    assert any("monotone" in p for p in SP.validate(bad))
    # bad completion reason
    bad = [ev(0, SP.REQ_ENQUEUE, SP.req_prov(2), 0, 2),
           ev(1, SP.REQ_COMPLETE, SP.req_prov(2), 1, 2, 0, "exploded",
              data=(0,))]
    assert any("reason" in p for p in SP.validate(bad))
    # step events not contiguous
    bad = [ev(0, SP.STEP, SP.step_prov(1), 1, data=(0, 0, 0, 0))]
    assert any("contiguous" in p for p in SP.validate(bad))


def test_step_stats_sanity():
    cfg = get_config("qwen2-0.5b").reduced()
    params = MP.init_params(cfg, seed=SEED, device="cpu")
    cache = decode.init_cache(cfg, params, 2, 16)
    st = decode.step_stats(cfg, cache)
    assert st["cache_bytes"] > 0
    assert st["cache_max_len"] == 16
    assert st["approx_flops_per_token"] > 0


# == twin of tests/test_serve_faults.py =====================================


def _tokens_by_rid(eng):
    return {r.rid: list(r.out) for r in eng.done}


# -- fault plans -------------------------------------------------------------


def test_fault_plan_generate_deterministic_and_roundtrip(tmp_path):
    a = FLT.FaultPlan.generate(7, 200, 0.1, 4)
    b = FLT.FaultPlan.generate(7, 200, 0.1, 4)
    assert a.specs == b.specs
    assert len(a) > 0
    assert sum(a.counts().values()) == len(a)
    for s in a.specs:
        assert 0 <= s.step < 200
        assert s.kind in FLT.KINDS
        if s.kind in FLT.SLOT_KINDS:
            assert 0 <= s.slot < 4
    # step index lookups agree with the flat spec list
    flat = [s for step in range(200) for s in a.at(step)]
    assert flat == list(a.specs)
    p = tmp_path / "plan.json"
    a.save(str(p))
    back = FLT.FaultPlan.load(str(p))
    assert back.specs == a.specs
    assert back.meta["seed"] == 7
    # a different seed draws a different campaign
    assert FLT.FaultPlan.generate(8, 200, 0.1, 4).specs != a.specs


def test_fault_spec_validation():
    with pytest.raises(ValueError):
        FLT.FaultSpec(0, "meteor_strike")
    with pytest.raises(ValueError):
        FLT.FaultSpec(0, FLT.NAN_LOGITS)  # slot kind needs a slot
    with pytest.raises(ValueError):
        FLT.FaultPlan.generate(0, 10, 0.5, 2, kinds=("bogus",))


def test_backoff_deterministic_and_capped():
    cfg = RES.ResilienceConfig(backoff_base=2, backoff_cap=16,
                               backoff_jitter=3, seed=5)
    seq = [RES.backoff_ticks(cfg, rid=9, attempt=a) for a in range(1, 8)]
    assert seq == [RES.backoff_ticks(cfg, 9, a) for a in range(1, 8)]
    for a, d in enumerate(seq, start=1):
        base = min(16, 2 * 2 ** (a - 1))
        assert base <= d <= base + 3
    # jitter distinguishes requests; zero jitter removes it
    nojit = RES.ResilienceConfig(backoff_base=2, backoff_cap=16,
                                 backoff_jitter=0)
    assert RES.backoff_ticks(nojit, 1, 3) == RES.backoff_ticks(nojit, 2, 3) \
        == 8


# -- chaos determinism (satellite: same seed + plan => byte-identical) -------


def _mixed_plan(steps=96, rate=0.15):
    return FLT.FaultPlan.generate(11, steps, rate, 2,
                                  kinds=(FLT.NAN_LOGITS, FLT.EXCEPTION,
                                         FLT.LATENCY_SPIKE,
                                         FLT.CACHE_CORRUPT),
                                  spike_ticks=3, spike_us=200)


def test_chaos_runs_are_byte_identical():
    res = RES.ResilienceConfig(deadline_ticks=300, seed=SEED)
    eng_a, _, tr_a = _run(plan=_mixed_plan(), res=res)
    eng_b, _, tr_b = _run(plan=_mixed_plan(), res=res)
    a = SP.to_jsonl(tr_a.events, stable=True)
    b = SP.to_jsonl(tr_b.events, stable=True)
    assert a == b and a
    assert SP.validate(tr_a.events, slots=2, engine_steps=eng_a.steps) == []
    # zero lost requests: every offered request terminated with a reason
    assert len(eng_a.done) == 6
    assert all(r.reason == SP.FINISHED
               or r.reason.startswith(SP.TRUNCATED_PREFIX)
               for r in eng_a.done)
    assert eng_a.faults_injected == eng_b.faults_injected > 0
    assert eng_a.faults_detected == eng_b.faults_detected


def test_negative_control_corruption_without_guard():
    """An injected cache corruption with NO resilience silently poisons the
    victim's downstream tokens while leaving the other slot untouched —
    proof the finite-guard is load-bearing, not decorative."""
    plan = FLT.FaultPlan([FLT.FaultSpec(4, FLT.CACHE_CORRUPT, slot=0)])
    clean, _, _ = _run(requests=2, mean=0.0, prompt_lens=(3,),
                       gen_lens=(8,))
    dirty, _, _ = _run(requests=2, mean=0.0, prompt_lens=(3,),
                       gen_lens=(8,), plan=plan)  # faults, no resilience
    ct, dt = _tokens_by_rid(clean), _tokens_by_rid(dirty)
    assert dt[0] != ct[0], "corruption did not reach the victim's tokens"
    assert dt[1] == ct[1], "corruption leaked across batch slots"
    # the engine is failure-blind here: the victim still "finishes"
    assert all(r.reason == SP.FINISHED for r in dirty.done)


def test_guard_detects_quarantines_and_retries():
    """Same corruption with resilience on: detected, quarantined, retried,
    and the victim finishes on attempt 2 with a valid attempt-split span."""
    plan = FLT.FaultPlan([FLT.FaultSpec(4, FLT.CACHE_CORRUPT, slot=0)])
    res = RES.ResilienceConfig(seed=SEED)
    eng, reg, tr = _run(requests=2, mean=0.0, prompt_lens=(3,),
                        gen_lens=(8,), plan=plan, res=res)
    assert eng.faults_detected >= 1
    assert eng.retries >= 1
    assert int(reg.get("serve_retries_total").value) == eng.retries
    assert int(reg.get("serve_faults_detected_total").value) \
        == eng.faults_detected
    assert SP.validate(tr.events, slots=2, engine_steps=eng.steps) == []
    summaries = SP.summarize(tr.events)
    victim = summaries[0]
    assert victim.attempts == 2
    assert victim.reason == SP.FINISHED
    assert [e.kind for e in tr.events if e.kind == SP.REQ_RETRY] \
        == [SP.REQ_RETRY] * eng.retries
    # bystander untouched: single attempt, finished
    assert summaries[1].attempts == 1
    assert summaries[1].reason == SP.FINISHED
    assert all(r.reason == SP.FINISHED for r in eng.done)


def test_retry_exhaustion_reasons():
    # nan on slot 0 at every step: whoever holds slot 0 can never progress
    plan = FLT.FaultPlan([FLT.FaultSpec(s, FLT.NAN_LOGITS, slot=0)
                          for s in range(400)])
    res = RES.ResilienceConfig(max_attempts=2, backoff_base=1,
                               backoff_jitter=0, seed=SEED)
    eng, reg, tr = _run(requests=2, slots=1, mean=0.0, prompt_lens=(3,),
                        gen_lens=(4,), plan=plan, res=res)
    assert SP.validate(tr.events, slots=1, engine_steps=eng.steps) == []
    reasons = sorted(r.reason for r in eng.done)
    assert reasons == [SP.TRUNCATED_PREFIX + RES.REASON_RETRY_EXHAUSTED] * 2
    assert int(reg.get(
        "serve_requests_truncated_quarantine_retry_exhausted_total").value) \
        == 2
    # retries disabled entirely -> the fault itself is the reason
    res1 = RES.ResilienceConfig(max_attempts=1, seed=SEED)
    eng1, reg1, _ = _run(requests=2, slots=1, mean=0.0, prompt_lens=(3,),
                         gen_lens=(4,), plan=plan, res=res1)
    assert all(r.reason == SP.TRUNCATED_PREFIX + RES.REASON_FAULT
               for r in eng1.done)
    assert int(reg1.get("serve_requests_truncated_fault_total").value) == 2


def test_exception_fault_freezes_the_step():
    plan = FLT.FaultPlan([FLT.FaultSpec(2, FLT.EXCEPTION),
                          FLT.FaultSpec(5, FLT.EXCEPTION)])
    res = RES.ResilienceConfig(seed=SEED)
    eng, reg, tr = _run(requests=2, mean=0.0, prompt_lens=(3,),
                        gen_lens=(6,), plan=plan, res=res)
    assert SP.validate(tr.events, slots=2, engine_steps=eng.steps) == []
    # pos is frozen on aborted steps, so it trails the step counter
    assert eng.pos == eng.steps - 2
    fault_steps = [e for e in tr.events
                   if e.kind == SP.STEP and e.detail == "fault:exception"]
    assert [e.step for e in fault_steps] == [2, 5]
    assert all(e.data[2] == 0 for e in fault_steps)  # no tokens that step
    assert all(r.reason == SP.FINISHED for r in eng.done)
    assert int(reg.get("serve_faults_detected_total").value) == 2
    # without resilience the injected exception is fatal (failure-blind)
    with pytest.raises(FLT.InjectedFault):
        _run(requests=2, mean=0.0, prompt_lens=(3,), gen_lens=(6,),
             plan=plan)


def test_latency_spike_advances_deadline_clock():
    # 1 spike of 40 ticks against a 30-tick deadline: structurally, the
    # in-flight requests blow their deadline on the spike step even though
    # barely any real steps ran
    plan = FLT.FaultPlan([FLT.FaultSpec(4, FLT.LATENCY_SPIKE,
                                        spike_ticks=40, spike_us=0)])
    res = RES.ResilienceConfig(deadline_ticks=30, seed=SEED)
    eng, reg, tr = _run(requests=2, mean=0.0, prompt_lens=(3,),
                        gen_lens=(64,), plan=plan, res=res)
    assert SP.validate(tr.events, slots=2, engine_steps=eng.steps) == []
    assert all(r.reason == SP.TRUNCATED_PREFIX + RES.REASON_DEADLINE
               for r in eng.done)
    assert int(reg.get("serve_requests_truncated_deadline_total").value) == 2
    # and without the spike the same workload meets the deadline budget
    eng2, _, _ = _run(requests=2, mean=0.0, prompt_lens=(3,), gen_lens=(8,),
                      res=res)
    assert all(r.reason == SP.FINISHED for r in eng2.done)


# -- deadlines + admission control -------------------------------------------


def test_completion_deadline_enforced():
    res = RES.ResilienceConfig(deadline_ticks=6, seed=SEED)
    eng, reg, tr = _run(requests=4, slots=1, mean=0.0, prompt_lens=(3,),
                        gen_lens=(8,), res=res)
    assert SP.validate(tr.events, slots=1, engine_steps=eng.steps) == []
    assert len(eng.done) == 4
    reasons = {r.rid: r.reason for r in eng.done}
    assert any(v == SP.TRUNCATED_PREFIX + RES.REASON_DEADLINE
               for v in reasons.values())
    assert int(reg.get("serve_requests_truncated_deadline_total").value) \
        == sum(v == SP.TRUNCATED_PREFIX + RES.REASON_DEADLINE
               for v in reasons.values())


def test_ttft_deadline_and_sentinel_regression():
    """Requests killed before emitting a token must (a) carry the deadline
    reason and (b) never reach the TTFT histogram — the first_token_us=-1
    sentinel regression."""
    res = RES.ResilienceConfig(ttft_deadline_ticks=5, seed=SEED)
    eng, reg, tr = _run(requests=4, slots=1, mean=0.0, prompt_lens=(4,),
                        gen_lens=(6,), res=res)
    assert SP.validate(tr.events, slots=1, engine_steps=eng.steps) == []
    no_token = [r for r in eng.done if not r.out]
    with_token = [r for r in eng.done if r.out]
    assert no_token, "expected some requests to miss the TTFT deadline"
    assert all(r.reason == SP.TRUNCATED_PREFIX + RES.REASON_DEADLINE
               for r in no_token)
    ttft = reg.get("serve_ttft_us")
    assert ttft.count == len(with_token)
    assert ttft.quantile(0.0) >= 0  # no -1 sentinel ever observed
    # decode histogram likewise only sees requests with >= 2 tokens
    assert reg.get("serve_decode_token_us").count \
        == sum(len(r.out) >= 2 for r in with_token)


def test_shed_policy_reject_newest_with_client_retry():
    res = RES.ResilienceConfig(queue_cap=1, seed=SEED)
    eng, reg, tr = _run(requests=8, slots=1, mean=0.0, prompt_lens=(3,),
                        gen_lens=(8,), res=res)
    assert SP.validate(tr.events, slots=1, engine_steps=eng.steps) == []
    assert len(eng.done) == 8, "zero-loss: every offered request terminates"
    assert int(reg.get("serve_queue_rejections_total").value) > 0
    shed = [r for r in eng.done
            if r.reason == SP.TRUNCATED_PREFIX + RES.REASON_SHED]
    fin = [r for r in eng.done if r.reason == SP.FINISHED]
    assert shed and fin
    assert int(reg.get("serve_requests_truncated_shed_total").value) \
        == len(shed)


def test_shed_policy_shed_oldest():
    res = RES.ResilienceConfig(queue_cap=1,
                               shed_policy=RES.POLICY_SHED_OLDEST,
                               seed=SEED)
    eng, reg, tr = _run(requests=8, slots=1, mean=0.0, prompt_lens=(3,),
                        gen_lens=(8,), res=res)
    assert SP.validate(tr.events, slots=1, engine_steps=eng.steps) == []
    assert len(eng.done) == 8
    # evictions happen queue-side: no retryable rejections, straight sheds
    assert int(reg.get("serve_queue_rejections_total").value) == 0
    assert any(r.reason == SP.TRUNCATED_PREFIX + RES.REASON_SHED
               for r in eng.done)


def test_shed_policy_token_budget():
    res = RES.ResilienceConfig(shed_policy=RES.POLICY_TOKEN_BUDGET,
                               token_budget=12, seed=SEED)
    eng, reg, tr = _run(requests=8, slots=1, mean=0.0, prompt_lens=(3,),
                        gen_lens=(8,), res=res)
    assert SP.validate(tr.events, slots=1, engine_steps=eng.steps) == []
    assert len(eng.done) == 8
    assert int(reg.get("serve_queue_rejections_total").value) > 0
    assert all(r.reason == SP.FINISHED
               or r.reason.startswith(SP.TRUNCATED_PREFIX)
               for r in eng.done)


def test_resilience_off_engine_unchanged():
    """A resilience-enabled zero-fault run completes the identical token
    streams as the plain engine — the machinery is inert when idle."""
    plain, _, tr_plain = _run()
    armed, _, tr_armed = _run(res=RES.ResilienceConfig(seed=SEED))
    assert _tokens_by_rid(plain) == _tokens_by_rid(armed)
    assert SP.to_jsonl(tr_plain.events, stable=True) \
        == SP.to_jsonl(tr_armed.events, stable=True)


# -- health state machine ----------------------------------------------------


def test_health_degrades_and_recovers():
    plan = FLT.FaultPlan([FLT.FaultSpec(4, FLT.NAN_LOGITS, slot=0)])
    res = RES.ResilienceConfig(recovery_ticks=3, seed=SEED)
    eng, reg, tr = _run(requests=2, mean=0.0, prompt_lens=(3,),
                        gen_lens=(12,), plan=plan, res=res)
    health = [(e.step, e.detail) for e in tr.events if e.kind == SP.HEALTH]
    assert [d for _, d in health] == [RES.DEGRADED, RES.HEALTHY]
    assert health[0][0] == 4
    assert health[1][0] >= health[0][0] + 3
    assert eng.health == RES.HEALTHY
    assert eng.health_ticks[RES.DEGRADED] >= 3
    assert int(reg.get("serve_engine_health").value) == 0


def test_health_drains_and_sheds_new_work():
    plan = FLT.FaultPlan([FLT.FaultSpec(s, FLT.NAN_LOGITS, slot=0)
                          for s in (4, 5)])
    res = RES.ResilienceConfig(drain_faults=2, drain_window=16,
                               backoff_base=1, backoff_jitter=0, seed=SEED)
    eng, reg, tr = _run(requests=6, slots=2, mean=3.0, prompt_lens=(3,),
                        gen_lens=(6,), plan=plan, res=res)
    assert SP.validate(tr.events, slots=2, engine_steps=eng.steps) == []
    assert eng.health == RES.DRAINING
    assert len(eng.done) == 6
    shed = [r for r in eng.done
            if r.reason == SP.TRUNCATED_PREFIX + RES.REASON_SHED]
    assert shed, "late arrivals should be shed while draining"
    assert int(reg.get("serve_engine_health").value) \
        == RES.HEALTH_CODE[RES.DRAINING]


# -- validate: attempt-aware invariants --------------------------------------


def test_validate_attempt_splitting():
    ev = SP.SpanEvent
    ok = [
        ev(0, SP.REQ_ENQUEUE, SP.req_prov(0), 0, 0),
        ev(1, SP.REQ_ADMIT, SP.req_prov(0), 0, 0, 0),
        ev(2, SP.REQ_PREFILL, SP.req_prov(0), 0, 0, 0),
        ev(3, SP.REQ_RETRY, SP.req_prov(0), 2, 0, 0, "quarantine:nonfinite",
           data=(1, 2)),
        ev(4, SP.REQ_ADMIT, SP.req_prov(0), 5, 0, 1),
        ev(5, SP.REQ_PREFILL, SP.req_prov(0), 5, 0, 1),
        ev(6, SP.REQ_FIRST_TOKEN, SP.req_prov(0), 7, 0, 1),
        ev(7, SP.REQ_COMPLETE, SP.req_prov(0), 9, 0, 1, SP.FINISHED,
           data=(3,)),
    ]
    assert SP.validate(ok) == []
    assert SP.summarize(ok)[0].attempts == 2
    # re-enqueue inside a retry attempt is a violation
    bad = ok[:4] + [ev(4, SP.REQ_ENQUEUE, SP.req_prov(0), 5, 0)] + ok[4:]
    assert any("enqueue" in p for p in SP.validate(bad))
    # events after the complete are a violation
    bad = ok + [ev(8, SP.REQ_FIRST_TOKEN, SP.req_prov(0), 10, 0, 1)]
    assert any("after complete" in p for p in SP.validate(bad))
    # phases regressing *within* one attempt are still caught
    bad = [ok[0], ok[1],
           ev(2, SP.REQ_FIRST_TOKEN, SP.req_prov(0), 1, 0, 0),
           ev(3, SP.REQ_PREFILL, SP.req_prov(0), 1, 0, 0),
           ok[7]]
    assert any("out of order" in p for p in SP.validate(bad))
    # health events are part of the schema, not unknown kinds
    stream = ok + [ev(9, SP.HEALTH, ("engine",), 2, detail=RES.DEGRADED,
                      data=(1,))]
    assert SP.validate(stream) == []


def test_validate_occupancy_intervals_with_retry():
    ev = SP.SpanEvent
    # rid0 occupies slot 0 for steps 0-1, is quarantined on step 1, then
    # re-admitted on step 3; the step occupancy snapshots must match
    stream = [
        ev(0, SP.REQ_ENQUEUE, SP.req_prov(0), 0, 0),
        ev(1, SP.REQ_ADMIT, SP.req_prov(0), 0, 0, 0),
        ev(2, SP.STEP, SP.step_prov(0), 0, data=(1, 0, 0, 1)),
        ev(3, SP.REQ_RETRY, SP.req_prov(0), 1, 0, 0, "quarantine:nonfinite",
           data=(1, 1)),
        ev(4, SP.STEP, SP.step_prov(1), 1, data=(1, 0, 0, 0)),
        ev(5, SP.STEP, SP.step_prov(2), 2, data=(0, 0, 0, 0)),
        ev(6, SP.REQ_ADMIT, SP.req_prov(0), 3, 0, 0),
        ev(7, SP.STEP, SP.step_prov(3), 3, data=(1, 0, 0, 1)),
        ev(8, SP.REQ_COMPLETE, SP.req_prov(0), 4, 0, 0, SP.FINISHED,
           data=(1,)),
        ev(9, SP.STEP, SP.step_prov(4), 4, data=(1, 0, 1, 0)),
    ]
    assert SP.validate(stream, slots=1, engine_steps=5) == []
    # claiming occupancy on the gap step is flagged
    wrong = list(stream)
    wrong[5] = ev(5, SP.STEP, SP.step_prov(2), 2, data=(1, 0, 0, 0))
    assert any("in flight" in p for p in SP.validate(wrong, slots=1,
                                                     engine_steps=5))


# == layer profiling: the join of tests/test_modelprof.py ====================


def _drive_profiled(arch="qwen2-0.5b", requests=3):
    cfg = get_config(arch).reduced()
    params = MP.init_params(cfg, seed=0, device="cpu")
    tr = SpanTracer()
    prof = MPF.LayerProfiler()
    eng = Engine(cfg, params, slots=2, max_len=64, spans=tr, layers=prof,
                 device="cpu")
    rng = np.random.default_rng(1)
    arrivals = [(0, Request(r, rng.integers(
        1, cfg.vocab_size, size=4).astype(np.int32), 4))
        for r in range(requests)]
    drv = ReplayDriver(eng, arrivals)
    while drv.active:
        drv.tick()
    return cfg, eng, tr, prof


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-27b"])
def test_layer_join_closes(arch):
    cfg, eng, tr, prof = _drive_profiled(arch)
    assert MPF.validate(prof.records, cfg=cfg, engine_steps=eng.steps) == []
    assert MPF.join_mismatches(prof.records, tr.events, cfg=cfg) == []
    rows = MPF.join_steps(prof.records, tr.events)
    assert set(rows) == set(range(eng.steps))
    for row in rows.values():
        assert row.layer_count == len(profile_ops(cfg))
        assert 0 < row.layers_wall_us <= row.step_wall_us
    summary = MPF.summarize(prof.records)
    assert set(summary) == set(profile_ops(cfg))
    assert abs(sum(MPF.op_shares(prof.records).values()) - 1.0) < 1e-9
    broken = [r for r in prof.records if r.step != 1]
    assert MPF.join_mismatches(broken, tr.events, cfg=cfg)


def test_layer_records_roundtrip_and_validate():
    cfg = get_config("qwen2-0.5b").reduced()
    prof = MPF.LayerProfiler()
    ops = profile_ops(cfg)
    for s in range(2):
        prof.on_step(s, ops, [10.0] * len(ops))
    assert MPF.from_jsonl(MPF.to_jsonl(prof.records)) == prof.records
    assert MPF.validate(prof.records, cfg=cfg, engine_steps=2) == []
    assert any("ops" in p for p in MPF.validate(prof.records[:-1], cfg=cfg))
    assert '"n":0' in MPF.to_jsonl(prof.records, stable=True)


# == the engine runs on the card unless told otherwise ======================


def test_engine_and_cli_need_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_config("qwen2-0.5b").reduced()
    params = MP.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError):
        Engine(cfg, params, 2, 16)
    with pytest.raises(RuntimeError):
        SV.main(["--requests", "1", "--spans-out", str(tmp_path / "s.jsonl")])
    assert not (tmp_path / "s.jsonl").exists()


def test_engine_refuses_params_on_another_device():
    cfg = get_config("qwen2-0.5b").reduced()
    params = MP.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError):
        Engine(cfg, params, 2, 16, device="meta")


# == the port's CLI against the reference's =================================


def _reference_cli(monkeypatch, args, out, warm=False):
    """The reference's CLI in this process.  ``warm``: one run first, whose
    own layer-coverage gate may fail on the JAX compiles it triggers
    (a first step that compiles takes ~0.2 s against ~1 ms of layers)."""
    from repro.launch import serve as ref_serve
    if warm:
        monkeypatch.setattr("sys.argv", ["serve", *args,
                                         "--spans-out", f"{out}.warm.spans",
                                         "--profile-layers", f"{out}.warm.layers"])
        try:
            ref_serve.main()
        except AssertionError:
            pass
    monkeypatch.setattr("sys.argv", ["serve", *args, "--spans-out",
                                     f"{out}.spans", "--profile-layers",
                                     f"{out}.layers"])
    ref_serve.main()


@pytest.mark.parametrize("faulty", [False, True])
def test_cli_streams_byte_identical_to_reference(tmp_path, monkeypatch, capsys,
                                                 faulty):
    """Same seed, trace (and plan): the port's ``--stable`` span stream and
    layer records are the reference's, byte for byte.  The plan draws NaN
    logits, cache corruptions and latency spikes (an exception fault aborts
    a step, which the reference's layer records cannot carry)."""
    args = ["--slots", "2", "--requests", "6", "--gen", "6", "--prompt-len",
            "4", "--arrival-mean", "0.5", "--stable"]
    if faulty:
        plan = FLT.FaultPlan.generate(7, 80, 0.15, 2,
                                      kinds=(FLT.NAN_LOGITS, FLT.CACHE_CORRUPT,
                                             FLT.LATENCY_SPIKE),
                                      spike_us=100)
        plan.save(str(tmp_path / "plan.json"))
        args += ["--fault-plan", str(tmp_path / "plan.json")]
    _reference_cli(monkeypatch, args, tmp_path / "ref", warm=faulty)
    capsys.readouterr()
    SV.main(["--device", "cpu", *args,
             "--spans-out", str(tmp_path / "port.spans"),
             "--profile-layers", str(tmp_path / "port.layers")])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    if not faulty:
        assert "6/6 requests" in out
    else:
        assert "retries" in out
    for kind in ("spans", "layers"):
        mine = (tmp_path / f"port.{kind}").read_bytes()
        assert mine and mine == (tmp_path / f"ref.{kind}").read_bytes(), kind
    if faulty:
        assert b"retry" in (tmp_path / "port.spans").read_bytes()


@pytest.mark.parametrize("path", ["obs/metrics.py", "obs/spans.py",
                                  "obs/traffic.py", "launch/faults.py",
                                  "launch/resilience.py"])
def test_jax_free_modules_are_verbatim_copies(path):
    """(``obs/__init__.py`` differs only in its docstring.)"""
    assert (ROOT / "src/repro_torch" / path).read_bytes() \
        == (ROOT / "src/repro" / path).read_bytes()
