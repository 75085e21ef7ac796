"""End-to-end serving driver on the PyTorch port: batched prefill + decode
with a KV cache.

    PYTHONPATH=src python examples/serve_batched_torch.py --arch qwen2-0.5b \
        --requests 4 --prompt-len 16 --gen 24 \
        --metrics-out /tmp/batched.prom --spans-out /tmp/batched.jsonl

The twin of ``examples/serve_batched.py`` on ``repro_torch``, on ``cuda``
unless ``--device`` names another device (``--device cpu`` runs it on the
CPU; without a card and without ``--device`` it raises ``RuntimeError``).
Serves the reduced config of any assigned architecture: a batch of
requests is prefilled token-by-token into the cache, then decoded greedily.
whisper and the VLM get frame or patch embeddings drawn from the seed
before the prompts, and ``init_cache`` fills their cross-attention caches
from them (the encoder first, for whisper).

All reported wall-clock numbers are taken after the device is synchronized
on the step outputs (the card runs asynchronously, so stamping before the
sync would time the enqueue, not the compute).  With ``--metrics-out`` /
``--spans-out`` the driver additionally syncs per step and emits the same
metric names and span schema as the continuous-batching engine
(``repro_torch.launch.serve``); the uninstrumented run keeps the
sync-at-phase-end behavior and pays nothing.  Under one seed and the same
flags, the ``req`` lines and the ``--stable`` span stream are the
reference driver's.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch import faults as FLT, resilience as RES
from repro_torch.launch.serve import serve_metrics
from repro_torch.models import decode, get_config
from repro_torch.models import params as MP
from repro_torch.obs import MetricsRegistry, SpanTracer, modelprof as MPF, \
    spans as SP


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; raises "
                         "without a card unless --device cpu)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics registry here on exit "
                         "(.json -> JSON, anything else -> Prometheus text)")
    ap.add_argument("--spans-out", default="",
                    help="write the span event stream here as JSONL")
    ap.add_argument("--profile-layers", default="",
                    help="run the sliced per-operator decode step and "
                         "write one layer record per (op, step) here as "
                         "JSONL (obs.modelprof schema)")
    ap.add_argument("--stable", action="store_true",
                    help="normalize wall-clock fields in the span and "
                         "layer exports")
    ap.add_argument("--fault-plan", default="",
                    help="replay a FaultPlan JSON (launch.faults): "
                         "nan/inf logits, latency spikes, and cache "
                         "corruption apply per step with an always-on "
                         "finite guard; victim rows are dropped with the "
                         "'fault' reason instead of poisoning the report. "
                         "'exception' specs are engine-level and ignored "
                         "by this fixed-batch driver")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="wall-clock completion deadline for the batch; "
                         "rows still in flight when it expires are "
                         "truncated with the 'deadline' reason")
    args = ap.parse_args(argv)

    plan = None
    if args.fault_plan:
        if args.profile_layers:
            ap.error("--fault-plan and --profile-layers are mutually "
                     "exclusive (fault replay targets the standard path)")
        plan = FLT.FaultPlan.load(args.fault_plan)
    resilient = plan is not None or args.deadline_ms > 0

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    rng = np.random.default_rng(args.seed)
    params = MP.init_params(cfg, seed=args.seed, device=device)
    max_len = args.prompt_len + args.gen

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    modality = None
    if cfg.family in ("vlm", "audio"):
        n = cfg.num_patches if cfg.family == "vlm" else cfg.encoder_seq
        modality = torch.from_numpy(rng.normal(
            size=(args.requests, n, cfg.d_model))).to(
                device=device, dtype=getattr(torch, cfg.dtype))

    layers = None
    if args.profile_layers:
        if cfg.family not in decode.PROFILED_FAMILIES:
            ap.error(f"--profile-layers supports families "
                     f"{decode.PROFILED_FAMILIES}, not {cfg.family}")
        layers = MPF.LayerProfiler()

    if layers is not None:
        pstep = decode.make_profiled_serve_step(cfg)
        cache = decode.ProfiledServeStep.init_cache(cfg, params,
                                                    args.requests, max_len)
    else:
        cache = decode.init_cache(cfg, params, args.requests, max_len,
                                  modality=modality)
        step = decode.make_serve_step(cfg)

    metrics = MetricsRegistry() if args.metrics_out else None
    spans_tr = SpanTracer() if args.spans_out else None
    observing = metrics is not None or spans_tr is not None
    m = serve_metrics(metrics, cfg, args.requests,
                      decode.ProfiledServeStep.stack_cache(cache)
                      if layers is not None else cache) \
        if metrics is not None else None
    now_us = spans_tr.now_us if spans_tr is not None \
        else lambda t0=time.perf_counter(): int((time.perf_counter() - t0)
                                                * 1e6)

    if layers is not None:
        def step(params, cache, toks, pos):
            """Sliced step: record one layer wall per operator, stamped on
            the span tracer's clock when one is attached (one-clock rule)."""
            logits, cache, walls = pstep(params, cache, toks, pos)
            layers.on_step(int(pos), pstep.ops, walls,
                           ts_us=now_us() if spans_tr is not None else None)
            return logits, cache

    prompts = rng.integers(1, cfg.vocab_size,
                           size=(args.requests, args.prompt_len)).astype(
                               np.int32)
    prompts_dev = torch.from_numpy(prompts.astype(np.int64)).to(device)
    print(f"arch={cfg.name} (reduced) requests={args.requests} "
          f"prompt={args.prompt_len} gen={args.gen}")

    # every request is enqueued and admitted up front (fixed batch, one
    # slot per request) — the spans still carry the full phase chain so
    # the batched and continuous drivers export comparable streams
    enqueue_us = now_us() if observing else 0
    if spans_tr is not None:
        for r in range(args.requests):
            spans_tr.emit(SP.REQ_ENQUEUE, ts_us=enqueue_us,
                          prov=SP.req_prov(r), step=0, rid=r)
        for r in range(args.requests):
            spans_tr.emit(SP.REQ_ADMIT, ts_us=enqueue_us,
                          prov=SP.req_prov(r), step=0, rid=r, slot=r)
            spans_tr.emit(SP.REQ_PREFILL, ts_us=enqueue_us,
                          prov=SP.req_prov(r), step=0, rid=r, slot=r)
    if m is not None:
        m["enq"].inc(args.requests)
        m["adm"].inc(args.requests)
        m["occ"].set(args.requests)

    def observe_step(idx, t_step, tokens_out, prefill_fed, occ):
        """Per-step sync + event/metric emission (instrumented runs only)."""
        wall = int((time.perf_counter() - t_step) * 1e6)
        if spans_tr is not None:
            spans_tr.emit(SP.STEP, prov=SP.step_prov(idx), step=idx,
                          dur_us=wall,
                          data=(occ, 0, tokens_out, prefill_fed))
        if m is not None:
            m["steps"].inc()
            m["gen"].inc(tokens_out)
            m["pre"].inc(prefill_fed)
            m["step_h"].observe(wall)

    # fixed-batch resilience state: rows are dropped (never retried — there
    # is no queue to retry into) and the rest of the batch keeps serving
    alive = np.ones(args.requests, bool)
    toks_emitted = np.zeros(args.requests, np.int64)
    counts = {"inj": 0, "det": 0}
    expired = False
    sync_each = observing or resilient

    def apply_faults(idx, logits, cache):
        """Replay this step's fault specs.  Latency sleeps land inside the
        step wall; 'exception' specs are engine-level and skipped here."""
        for f in plan.at(idx):
            if f.kind in (FLT.NAN_LOGITS, FLT.INF_LOGITS) \
                    and 0 <= f.slot < args.requests:
                logits = logits.clone()
                logits[f.slot, -1] = float("nan") \
                    if f.kind == FLT.NAN_LOGITS else float("inf")
            elif f.kind == FLT.CACHE_CORRUPT \
                    and 0 <= f.slot < args.requests:
                cache = decode.corrupt_cache_slot(cfg, cache, f.slot)
            elif f.kind == FLT.LATENCY_SPIKE:
                time.sleep(f.spike_us / 1e6)
            else:
                continue
            counts["inj"] += 1
            if m is not None:
                m["finj"].inc()
        return logits, cache

    def finish_rows(rows, idx, detail):
        """Terminate rows with a truncation reason (span + counters)."""
        us = now_us() if observing else 0
        for r in rows:
            alive[r] = False
            if spans_tr is not None:
                spans_tr.emit(SP.REQ_COMPLETE, ts_us=us,
                              prov=SP.req_prov(r), step=idx, rid=r, slot=r,
                              detail=detail, data=(int(toks_emitted[r]),))
        if m is not None and rows:
            m["trunc"].inc(len(rows))
            m["trunc_" + detail[len(SP.TRUNCATED_PREFIX):]].inc(len(rows))
            m["occ"].set(int(alive.sum()))

    def screen(idx, logits):
        """Finite guard: drop rows whose sampled logits went non-finite."""
        fin = np.isfinite(logits[:, -1].float().cpu().numpy()).all(axis=1)
        bad = [r for r in range(args.requests) if alive[r] and not fin[r]]
        if bad:
            counts["det"] += len(bad)
            if m is not None:
                m["fdet"].inc(len(bad))
            finish_rows(bad, idx, SP.TRUNCATED_PREFIX + RES.REASON_FAULT)

    def past_deadline():
        return args.deadline_ms > 0 \
            and (time.perf_counter() - t_serve0) * 1e3 > args.deadline_ms

    # prefill (token-by-token through the decode path)
    t0 = t_serve0 = time.perf_counter()
    logits = None
    steps_run = 0
    for i in range(args.prompt_len):
        t_step = time.perf_counter() if observing else 0.0
        logits, cache = step(params, cache, prompts_dev[:, i:i + 1], i)
        if sync_each:
            sync()
        if plan is not None:
            logits, cache = apply_faults(i, logits, cache)
        occ_now = int(alive.sum())  # rows dying this step still occupy it
        if plan is not None:
            screen(i, logits)
        if i == args.prompt_len - 1:
            # the last prefill step's logits produce the first tokens
            toks_emitted[alive] += 1
        steps_run += 1
        if observing:
            observe_step(i, t_step,
                         int(alive.sum()) if i == args.prompt_len - 1 else 0,
                         args.requests, occ_now)
        if past_deadline():
            finish_rows([r for r in range(args.requests) if alive[r]], i,
                        SP.TRUNCATED_PREFIX + RES.REASON_DEADLINE)
            expired = True
            break
    sync()
    t_prefill = time.perf_counter() - t0

    # greedy decode
    outs = []
    t_decode = 0.0
    first_us = enqueue_us
    if not expired:
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        if observing:
            sync()
            first_us = now_us()
            if spans_tr is not None:
                for r in range(args.requests):
                    if alive[r]:
                        spans_tr.emit(SP.REQ_FIRST_TOKEN, ts_us=first_us,
                                      prov=SP.req_prov(r),
                                      step=args.prompt_len - 1, rid=r,
                                      slot=r)
            if m is not None:
                for r in range(args.requests):
                    if alive[r]:
                        m["ttft"].observe(first_us - enqueue_us)
        t0 = time.perf_counter()
        for i in range(args.gen):
            outs.append(tok.cpu().numpy())
            t_step = time.perf_counter() if observing else 0.0
            logits, cache = step(params, cache, tok, args.prompt_len + i)
            if sync_each:
                sync()
            if plan is not None:
                logits, cache = apply_faults(args.prompt_len + i, logits,
                                             cache)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            occ_now = int(alive.sum())
            if plan is not None:
                screen(args.prompt_len + i, logits)
            if i < args.gen - 1:
                # the final iteration's freshly computed token is discarded
                toks_emitted[alive] += 1
            steps_run += 1
            if observing:
                sync()
                observe_step(args.prompt_len + i, t_step,
                             int(alive.sum()) if i < args.gen - 1 else 0,
                             0, occ_now)
            if past_deadline():
                finish_rows([r for r in range(args.requests) if alive[r]],
                            args.prompt_len + i,
                            SP.TRUNCATED_PREFIX + RES.REASON_DEADLINE)
                expired = True
                break
            if not alive.any():
                break
        sync()
        t_decode = time.perf_counter() - t0

    if observing:
        done_us = now_us()
        last_step = max(steps_run - 1, 0)
        if spans_tr is not None:
            for r in range(args.requests):
                if alive[r]:
                    spans_tr.emit(SP.REQ_COMPLETE, ts_us=done_us,
                                  prov=SP.req_prov(r), step=last_step,
                                  rid=r, slot=r, detail=SP.FINISHED,
                                  data=(int(toks_emitted[r]),))
        if m is not None:
            m["fin"].inc(int(alive.sum()))
            m["occ"].set(0)
            if not expired:
                for r in range(args.requests):
                    if alive[r] and toks_emitted[r] >= 2:
                        m["dtok"].observe((done_us - first_us)
                                          / (int(toks_emitted[r]) - 1))

    tps = int(toks_emitted.sum()) / t_decode if t_decode > 0 else 0.0
    print(f"prefill: {t_prefill:.2f}s   decode: {t_decode:.2f}s "
          f"({tps:.1f} tok/s aggregate)")
    if outs:
        gen = np.concatenate(outs, axis=1)
        for r in range(min(args.requests, 2)):
            print(f"req{r}: prompt={prompts[r, :8].tolist()}... "
                  f"generated={gen[r, :12].tolist()}...")
    if resilient:
        print(f"resilience: faults injected={counts['inj']} "
              f"detected={counts['det']} "
              f"dropped={int((~alive).sum())} "
              f"survivors={int(alive.sum())}")
    if metrics is not None:
        with open(args.metrics_out, "w") as f:
            f.write(metrics.dump_json()
                    if args.metrics_out.endswith(".json")
                    else metrics.to_prometheus())
        print(f"metrics -> {args.metrics_out}")
    if spans_tr is not None:
        problems = SP.validate(spans_tr.events, slots=args.requests,
                               engine_steps=steps_run)
        assert not problems, problems
        with open(args.spans_out, "w") as f:
            f.write(SP.to_jsonl(spans_tr.events, stable=args.stable))
        print(f"{len(spans_tr.events)} span events -> {args.spans_out}"
              f"{' (stable)' if args.stable else ''}")
    if layers is not None:
        problems = MPF.validate(layers.records, cfg=cfg,
                                engine_steps=steps_run)
        if spans_tr is not None:
            problems += MPF.join_mismatches(layers.records, spans_tr.events,
                                            cfg=cfg)
        assert not problems, problems
        with open(args.profile_layers, "w") as f:
            f.write(MPF.to_jsonl(layers.records, stable=args.stable))
        print(f"{len(layers.records)} layer records -> "
              f"{args.profile_layers}{' (stable)' if args.stable else ''}")
    finite = np.isfinite(logits.float().cpu().numpy())
    assert finite[alive].all() if resilient else finite.all()
    print("OK")


if __name__ == "__main__":
    main()
