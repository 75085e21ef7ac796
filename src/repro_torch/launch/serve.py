"""Production serving launcher: continuous batched decode loop.

The port of ``repro.launch.serve``, on ``cuda`` unless told otherwise::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --slots 4 --requests 12 --gen 16 \
        --metrics-out /tmp/serve.prom --spans-out /tmp/serve_spans.jsonl

(``--device cpu`` runs it on the CPU.)

Implements slot-based continuous batching over the family-appropriate
cache: finished sequences release their slot, queued requests claim it, and
every engine step decodes the whole batch.  One global position ``pos``
serves every slot: a request admitted at step P also attends to its slot's
entries 0..P-1, as in the reference (``ROADMAP.md`` C.7).

Observability (``obs``): the engine accepts an optional
``MetricsRegistry`` and ``SpanTracer``.  Every instrumentation site is
guarded by ``if ... is not None`` — the uninstrumented engine pays nothing
beyond the device sync it always performs (the step's argmax
is transferred to the host each step regardless, so the sync is inherent to
the serving loop, and making it explicit means *every* wall-clock stamp is
taken after device work finished — async-dispatch timing lies are
structurally impossible).  One span per request tracks the
enqueue -> admit -> prefill -> first_token -> complete phase chain; one
event per engine step carries slot occupancy, queue depth, and tokens
emitted.  Under a fixed ``--seed`` the span stream is byte-identical across
runs in the exporter's ``--stable`` mode (wall-clock fields normalized).

Resilience (``launch.resilience`` + ``launch.faults``): the
engine optionally takes a :class:`~repro_torch.launch.faults.FaultPlan` (seeded,
replayable step-level fault injection) and a
:class:`~repro_torch.launch.resilience.ResilienceConfig` (detection + recovery
policy), each defaulting to ``None`` under the same zero-cost-when-off
contract as the observability hooks.  With resilience on: sampled logits
pass a per-step finite-guard; a non-finite slot is quarantined (cache
positions zeroed, slot released) and its request requeued with capped
exponential backoff + deterministic jitter, up to ``max_attempts``;
injected step exceptions abort the step without mutating any request;
per-request TTFT/completion deadlines and a bounded queue with pluggable
shedding run admission control; engine health walks
healthy -> degraded -> draining.  Deadlines and backoff are measured on a
virtual *tick* clock (engine steps + latency-spike penalties), never wall
time, so the whole failure/recovery schedule is deterministic under a seed
and the chaos span streams stay byte-identical in ``--stable`` mode.
"""
import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import faults as FLT
from repro_torch.launch import resilience as RES
from repro_torch.models import decode, get_config
from repro_torch.models import params as MP
from repro_torch.obs import MetricsRegistry, SpanTracer, spans as SP, traffic
from repro_torch.obs.modelprof import LayerProfiler
from repro_torch.obs import modelprof as MPF


class Request:
    def __init__(self, rid: int, prompt: np.ndarray, gen: int,
                 deadline_ticks: int = 0, ttft_deadline_ticks: int = 0):
        self.rid = rid
        self.prompt = prompt
        self.gen = gen
        self.out: List[int] = []
        self.fed = 0              # prompt tokens consumed
        self.reason = ""          # set on completion
        self.enqueue_us = -1      # engine-epoch stamps (observability only)
        self.first_token_us = -1
        # resilience state (all deterministic; ticks, not wall time)
        self.attempt = 1
        self.enqueue_tick = -1    # first-submit tick (-1 = never offered)
        self.deadline_ticks = deadline_ticks        # per-request override
        self.ttft_deadline_ticks = ttft_deadline_ticks
        self.deadline_end = -1    # absolute tick bounds (-1 = none)
        self.ttft_end = -1
        self.ttft_seen = False    # first token emitted (any attempt)
        self.ttft_observed = False  # TTFT recorded once (metrics only)

    @property
    def est_tokens(self) -> int:
        """Footprint estimate for token-budget admission control."""
        return len(self.prompt) + self.gen


def serve_metrics(reg: MetricsRegistry, cfg, slots: int, cache) -> dict:
    """Create (get-or-create) the serving instrument set on ``reg``.

    Shared by the engine and the batch driver so every serving surface
    exports the same metric names (see the README metric table).
    """
    st = decode.step_stats(cfg, cache)
    reg.gauge("serve_slots_total", "configured engine slots").set(slots)
    reg.gauge("serve_cache_bytes",
              "bytes held by the decode cache").set(st["cache_bytes"])
    reg.gauge("serve_cache_max_len",
              "cache positions available").set(st["cache_max_len"])
    reg.gauge("serve_approx_flops_per_token",
              "2 x active params").set(st["approx_flops_per_token"])
    m = {
        "enq": reg.counter("serve_requests_enqueued_total",
                           "requests submitted to the queue"),
        "adm": reg.counter("serve_requests_admitted_total",
                           "requests that claimed a slot"),
        "fin": reg.counter("serve_requests_completed_total",
                           "requests finished normally"),
        "trunc": reg.counter("serve_requests_truncated_total",
                             "requests truncated before finishing"),
        "steps": reg.counter("serve_engine_steps_total",
                             "engine steps executed"),
        "gen": reg.counter("serve_tokens_generated_total",
                           "tokens decoded across all requests"),
        "pre": reg.counter("serve_tokens_prefill_total",
                           "prompt tokens fed through the decode path"),
        "occ": reg.gauge("serve_slots_occupied",
                         "slots occupied after the last admit/step"),
        "qd": reg.gauge("serve_queue_depth", "requests waiting for a slot"),
        "step_h": reg.histogram("serve_step_latency_us",
                                "engine step wall time (post-sync)"),
        "ttft": reg.histogram("serve_ttft_us",
                              "enqueue to first generated token"),
        "dtok": reg.histogram("serve_decode_token_us",
                              "steady-state per-token decode latency"),
        "retry": reg.counter("serve_retries_total",
                             "slot quarantines that requeued the victim"),
        "finj": reg.counter("serve_faults_injected_total",
                            "faults injected by the active FaultPlan"),
        "fdet": reg.counter("serve_faults_detected_total",
                            "faults caught by the finite-guard or step "
                            "exception handler"),
        "rej": reg.counter("serve_queue_rejections_total",
                           "submissions bounced by admission control "
                           "(retryable by the client)"),
        "health": reg.gauge("serve_engine_health",
                            "0 healthy / 1 degraded / 2 draining"),
    }
    for reason in RES.REASONS:
        m["trunc_" + reason] = reg.counter(
            f"serve_requests_truncated_{reason}_total",
            f"requests truncated with reason {reason!r}")
    return m


def _screen(last: torch.Tensor) -> torch.Tensor:
    """(2, slots) int64: the argmax per slot, and 1 where every logit in the
    slot's row is finite."""
    return torch.stack([torch.argmax(last, dim=-1),
                        torch.isfinite(last).all(dim=-1).long()])


class _ScreenGraph:
    """``_screen`` captured in a CUDA graph for one logits shape, dtype and
    card.  The reference fuses the screen into one jitted dispatch; eagerly
    it is five launches, each a dispatch of ~20 us on a card's host against
    a reduced config's ~3 ms step, which the armed-engine overhead gate
    (5%) sees.  A replay is one launch: the logits are copied into the
    graph's input and its output copied to the host."""

    def __init__(self, like: torch.Tensor):
        with torch.cuda.device(like.device):
            self.inp = torch.zeros_like(like, memory_format=torch.contiguous_format)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _screen(self.inp)                # load the kernels before capture
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = _screen(self.inp)

    def __call__(self, last: torch.Tensor) -> np.ndarray:
        self.inp.copy_(last)
        self.graph.replay()
        return self.out.cpu().numpy()


_SCREEN_GRAPHS: Dict[Tuple, _ScreenGraph] = {}


def _guarded_argmax(last: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Sample + finite-screen: the argmax per slot and whether every logit
    in that slot's row is finite.  On a card, ``_screen``'s CUDA graph for
    the logits' shape (captured at its first use), brought to the host in
    one copy; on the CPU the logits already lie in host memory and numpy
    reads them there (torch's five dispatches cost ~30 us, about 5% of a
    reduced config's CPU step).  Both argmaxes take the first of equal
    maxima; a row that is not finite is dropped whatever its argmax."""
    if last.device.type == "cpu":
        rows = last.float().numpy()
        return rows.argmax(axis=-1).astype(np.int32), np.isfinite(rows).all(axis=-1)
    key = (tuple(last.shape), last.dtype, last.device)
    if key not in _SCREEN_GRAPHS:
        _SCREEN_GRAPHS[key] = _ScreenGraph(last)
    nxt, finite = _SCREEN_GRAPHS[key](last)
    return nxt.astype(np.int32), finite.astype(bool)


class Engine:
    """Slot-based continuous batching on top of serve_step.

    Runs on ``device`` (``cuda`` unless the caller names another; raises
    ``RuntimeError`` when no card is present); ``params`` must lie there.
    """

    def __init__(self, cfg, params, slots: int, max_len: int,
                 metrics: Optional[MetricsRegistry] = None,
                 spans: Optional[SpanTracer] = None,
                 layers: Optional["LayerProfiler"] = None,
                 faults: Optional[FLT.FaultPlan] = None,
                 resilience: Optional[RES.ResilienceConfig] = None,
                 device: DeviceLike = None):
        dev, held = resolve_device(device), params["embed"].device
        if held.type != dev.type or dev.index not in (None, held.index):
            raise ValueError(f"params lie on {held}; the engine runs on {dev}")
        self.device = held
        self.cfg = cfg
        self.params = params
        self.slots: List[Optional[Request]] = [None] * slots
        self.pos = 0
        self.max_len = max_len
        # attaching a layer profiler switches the engine to the sliced
        # per-operator step (same math, bit-identical logits — asserted by
        # tests) whose cache travels in per-group list form; the fused
        # engine pays nothing for the feature existing
        self.layers = layers
        if layers is not None:
            self._prof = decode.make_profiled_serve_step(cfg)
            self.cache = decode.ProfiledServeStep.init_cache(
                cfg, params, slots, max_len)
        else:
            self._prof = None
            self.cache = decode.init_cache(cfg, params, slots, max_len)
        self._step = decode.make_serve_step(cfg)
        self.steps = 0
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.spans = spans
        # resilience state — all structural (tick clock, not wall time)
        self.faults = faults
        self.res = resilience
        self._tick = 0            # steps + latency-spike penalty ticks
        self.delayed: List[Tuple[int, Request]] = []  # (due_tick, victim)
        self.health = RES.HEALTHY
        self.health_ticks = {RES.HEALTHY: 0, RES.DEGRADED: 0,
                             RES.DRAINING: 0}
        self._clean = 0           # consecutive fault-free steps
        self._fault_ticks: List[int] = []
        self.faults_injected = 0
        self.faults_detected = 0
        self.retries = 0
        if resilience is not None and resilience.token_budget > 0:
            self._token_budget = resilience.token_budget
        else:
            self._token_budget = slots * max_len
        # one clock for every stamp: when a tracer is attached its epoch is
        # the authoritative one (span events default to tracer time), so the
        # metrics-side stamps must read the same clock or phase timestamps
        # drift apart by the construction-time offset
        self._t0 = time.perf_counter()
        self._now_us = spans.now_us if spans is not None \
            else self._own_now_us
        self._m = serve_metrics(metrics, cfg, slots, self.cache) \
            if metrics is not None else None

    # -- observability helpers ----------------------------------------------

    def _own_now_us(self) -> int:
        return int((time.perf_counter() - self._t0) * 1e6)

    @property
    def inflight(self) -> int:
        return sum(s is not None for s in self.slots)

    # -- health state machine ------------------------------------------------

    def _set_health(self, state: str) -> None:
        if state == self.health:
            return
        self.health = state
        if self.spans is not None:
            self.spans.emit(SP.HEALTH, prov=("engine",), step=self.steps,
                            detail=state, data=(RES.HEALTH_CODE[state],))
        if self._m is not None:
            self._m["health"].set(RES.HEALTH_CODE[state])

    def _record_fault(self) -> None:
        """A fault was *detected* this step: degrade, maybe drain."""
        self._clean = 0
        res = self.res
        if res.drain_faults > 0:
            self._fault_ticks.append(self._tick)
            self._fault_ticks = [t for t in self._fault_ticks
                                 if t > self._tick - res.drain_window]
            if len(self._fault_ticks) >= res.drain_faults:
                self._set_health(RES.DRAINING)
                return
        if self.health == RES.HEALTHY:
            self._set_health(RES.DEGRADED)

    def _health_step(self, detected: bool) -> None:
        if self.res is None:
            return
        if not detected:
            self._clean += 1
            if self.health == RES.DEGRADED \
                    and self._clean >= self.res.recovery_ticks:
                self._set_health(RES.HEALTHY)
        self.health_ticks[self.health] += 1

    # -- queue lifecycle -----------------------------------------------------

    def submit(self, req: Request) -> str:
        """Offer a request.  Returns ``"queued"``, ``"rejected"``
        (admission control bounced it — the client may retry),
        ``"shed"`` (terminally dropped), or ``"deadline"``."""
        if req.enqueue_tick < 0:
            # first offer: stamp the span + absolute deadline bounds once,
            # before any admission decision — rejected requests were still
            # *offered* and must carry an enqueue event
            req.enqueue_tick = self._tick
            res = self.res
            dl = req.deadline_ticks or (res.deadline_ticks if res else 0)
            req.deadline_end = req.enqueue_tick + dl if dl > 0 else -1
            tdl = req.ttft_deadline_ticks or \
                (res.ttft_deadline_ticks if res else 0)
            req.ttft_end = req.enqueue_tick + tdl if tdl > 0 else -1
            if self.spans is not None or self._m is not None:
                now = self._now_us()
                req.enqueue_us = now
                if self.spans is not None:
                    self.spans.emit(SP.REQ_ENQUEUE, ts_us=now,
                                    prov=SP.req_prov(req.rid),
                                    step=self.steps, rid=req.rid)
                if self._m is not None:
                    self._m["enq"].inc()
        res = self.res
        if res is None:
            self.queue.append(req)
            if self._m is not None:
                self._m["qd"].set(len(self.queue))
            return "queued"
        if self.health == RES.DRAINING:
            self._finish(req, SP.TRUNCATED_PREFIX + RES.REASON_SHED)
            return "shed"
        if req.deadline_end >= 0 and self._tick >= req.deadline_end:
            # a client retry arrived after the request's own deadline
            self._finish(req, SP.TRUNCATED_PREFIX + RES.REASON_DEADLINE)
            return "deadline"
        if res.queue_cap and len(self.queue) >= res.queue_cap:
            if res.shed_policy == RES.POLICY_SHED_OLDEST:
                self._finish(self.queue.pop(0),
                             SP.TRUNCATED_PREFIX + RES.REASON_SHED)
            else:
                if self._m is not None:
                    self._m["rej"].inc()
                return "rejected"
        if res.shed_policy == RES.POLICY_TOKEN_BUDGET:
            est = req.est_tokens + sum(q.est_tokens for q in self.queue)
            if est > self._token_budget:
                if self._m is not None:
                    self._m["rej"].inc()
                return "rejected"
        self.queue.append(req)
        if self._m is not None:
            self._m["qd"].set(len(self.queue))
        return "queued"

    def shed(self, req: Request) -> None:
        """Terminally drop an offered-but-unqueued request (e.g. the
        client gave up retrying a rejection)."""
        self._finish(req, SP.TRUNCATED_PREFIX + RES.REASON_SHED)

    def _release_delayed(self) -> None:
        """Move due backed-off victims to the queue front (retries jump
        the line — they have already waited).  When the engine is
        otherwise idle, fast-forward the tick clock to the earliest due
        retry instead of spinning empty steps."""
        if not self.delayed:
            return
        if not self.inflight and not self.queue:
            earliest = min(t for t, _ in self.delayed)
            if earliest > self._tick:
                self._tick = earliest
        due = sorted(((t, r.rid, r) for t, r in self.delayed
                      if t <= self._tick))
        if not due:
            return
        self.delayed = [(t, r) for t, r in self.delayed if t > self._tick]
        self.queue[:0] = [r for _, _, r in due]
        if self._m is not None:
            self._m["qd"].set(len(self.queue))

    def _sweep_queue_deadlines(self) -> None:
        """Expire queued requests that can no longer meet their deadline
        (even if admitted right now, completion lands past the bound)."""
        if self.res is None:
            return
        keep: List[Request] = []
        for r in self.queue:
            if (r.deadline_end >= 0 and self._tick >= r.deadline_end) or \
                    (r.ttft_end >= 0 and not r.ttft_seen
                     and self._tick >= r.ttft_end):
                self._finish(r, SP.TRUNCATED_PREFIX + RES.REASON_DEADLINE)
            else:
                keep.append(r)
        if len(keep) != len(self.queue):
            self.queue[:] = keep
            if self._m is not None:
                self._m["qd"].set(len(self.queue))

    def admit(self, queue: Optional[List[Request]] = None) -> None:
        """Fill free slots from ``queue`` (default: the engine's own)."""
        q = self.queue if queue is None else queue
        if queue is None:
            self._release_delayed()
            self._sweep_queue_deadlines()
        for i, slot in enumerate(self.slots):
            if slot is None and q:
                r = q.pop(0)
                self.slots[i] = r
                if self.spans is not None:
                    self.spans.emit(SP.REQ_ADMIT, prov=SP.req_prov(r.rid),
                                    step=self.steps, rid=r.rid, slot=i)
                if self._m is not None:
                    self._m["adm"].inc()
                    self._m["qd"].set(len(self.queue))
                    self._m["occ"].set(self.inflight)

    def _finish(self, r: Request, detail: str, slot: int = -1) -> None:
        """Shared terminal bookkeeping: span, per-reason counters, dtok."""
        r.reason = detail
        self.done.append(r)
        if self.spans is not None:
            self.spans.emit(SP.REQ_COMPLETE, prov=SP.req_prov(r.rid),
                            step=self.steps, rid=r.rid, slot=slot,
                            detail=detail, data=(len(r.out),))
        if self._m is not None:
            m = self._m
            if detail == SP.FINISHED:
                m["fin"].inc()
            else:
                m["trunc"].inc()
                key = "trunc_" + detail[len(SP.TRUNCATED_PREFIX):]
                if key in m:
                    m[key].inc()
            m["occ"].set(self.inflight)
            m["qd"].set(len(self.queue))
            if slot >= 0 and len(r.out) >= 2 and r.first_token_us >= 0:
                m["dtok"].observe((self._now_us() - r.first_token_us)
                                  / (len(r.out) - 1))

    def _complete(self, i: int, reason: str) -> None:
        r = self.slots[i]
        assert r is not None
        self.slots[i] = None
        self._finish(r, reason, slot=i)

    def truncate_all(self, reason: str) -> None:
        """Release every in-flight, queued, and backed-off request."""
        detail = SP.TRUNCATED_PREFIX + reason
        for i, r in enumerate(self.slots):
            if r is not None:
                self._complete(i, detail)
        while self.queue:
            self._finish(self.queue.pop(0), detail)
        for _, _, r in sorted((t, r.rid, r) for t, r in self.delayed):
            self._finish(r, detail)
        self.delayed = []

    def _enforce_deadlines(self) -> None:
        """End-of-step deadline pass over in-flight requests (end of step
        so the release never contradicts the step's occupancy snapshot)."""
        if self.res is None:
            return
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            if (r.deadline_end >= 0 and self._tick > r.deadline_end) or \
                    (r.ttft_end >= 0 and not r.ttft_seen
                     and self._tick > r.ttft_end):
                self._complete(i, SP.TRUNCATED_PREFIX + RES.REASON_DEADLINE)

    # -- the engine step -----------------------------------------------------

    def _abort_step(self, observing: bool, t0: float, spike_ticks: int,
                    spike_us: int) -> None:
        """An injected (or caught) step exception: the whole lockstep batch
        loses the step — no tokens, no cache advance, ``pos`` frozen — but
        the step still counts, ticks, and carries a span."""
        self._record_fault()
        if spike_us:
            time.sleep(spike_us / 1e6)
        occupied = self.inflight
        if observing:
            now = self._now_us()
            wall_us = int((time.perf_counter() - t0) * 1e6)
        if self.spans is not None:
            self.spans.emit(SP.STEP, prov=SP.step_prov(self.steps),
                            step=self.steps, detail="fault:exception",
                            dur_us=wall_us,
                            data=(occupied, len(self.queue), 0, 0))
        if self._m is not None:
            self._m["steps"].inc()
            self._m["step_h"].observe(wall_us)
        self._health_step(detected=True)
        self._tick += 1 + spike_ticks
        self._enforce_deadlines()
        self.steps += 1

    def step(self) -> None:
        pending = self.faults.at(self.steps) if self.faults is not None \
            else ()
        observing = self.spans is not None or self._m is not None
        t0 = time.perf_counter() if observing else 0.0
        spike_ticks = 0
        spike_us = 0
        injected = 0
        n_exc = 0
        for f in pending:
            if f.kind == FLT.LATENCY_SPIKE:
                injected += 1
                spike_ticks += f.spike_ticks
                spike_us += f.spike_us
            elif f.kind == FLT.EXCEPTION:
                injected += 1
                n_exc += 1
        if n_exc:
            # injected before any request mutation, so the aborted step
            # needs no rollback
            self.faults_injected += injected
            if self._m is not None:
                self._m["finj"].inc(injected)
            if self.res is None:
                raise FLT.InjectedFault(
                    f"injected step exception at step {self.steps}")
            self.faults_detected += n_exc
            if self._m is not None:
                self._m["fdet"].inc(n_exc)
            self._abort_step(observing, t0, spike_ticks, spike_us)
            return
        toks = np.zeros((len(self.slots), 1), np.int64)
        prefill_started: List[int] = []
        fed_slots: List[int] = []
        prefill_fed = 0
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            if r.fed < len(r.prompt):
                if r.fed == 0:
                    prefill_started.append(r.rid)
                toks[i, 0] = r.prompt[r.fed]
                r.fed += 1
                fed_slots.append(i)
                prefill_fed += 1
            elif r.out:
                toks[i, 0] = r.out[-1]
        if self.spans is not None:
            for rid in prefill_started:
                self.spans.emit(SP.REQ_PREFILL, prov=SP.req_prov(rid),
                                step=self.steps, rid=rid)
        occupied = self.inflight
        seg_walls: Optional[List[float]] = None
        try:
            tokens = torch.from_numpy(toks).to(self.device)
            if self._prof is not None:
                logits, self.cache, seg_walls = self._prof(
                    self.params, self.cache, tokens, self.pos)
            else:
                logits, self.cache = self._step(
                    self.params, self.cache, tokens, self.pos)
        except Exception:
            if self.res is None:
                raise
            # genuine runtime failure: roll back this step's prompt feeds
            # (no cache was written) and degrade instead of crashing
            for i in fed_slots:
                r = self.slots[i]
                if r is not None:
                    r.fed -= 1
            self.faults_detected += 1
            if self._m is not None:
                self._m["fdet"].inc()
            self._abort_step(observing, t0, spike_ticks, spike_us)
            return
        last = logits[:, -1]
        for f in pending:
            if f.kind in (FLT.NAN_LOGITS, FLT.INF_LOGITS):
                injected += 1
                last = last.clone()
                last[f.slot] = float("nan") if f.kind == FLT.NAN_LOGITS \
                    else float("inf")
        if self.res is not None and self.res.finite_guard:
            nxt, finite = _guarded_argmax(last)
        else:
            nxt = torch.argmax(last, dim=-1).cpu().numpy().astype(np.int32)
            finite = None
        for f in pending:
            if f.kind == FLT.CACHE_CORRUPT:
                # applied after the step's cache write: silent until the
                # poison reaches the slot's logits on a later step
                injected += 1
                self.cache = decode.corrupt_cache_slot(self.cfg, self.cache,
                                                       f.slot)
        if injected:
            self.faults_injected += injected
            if self._m is not None:
                self._m["finj"].inc(injected)
        # the argmax transfer above already forced the logits; wait for the
        # cache writes too so every wall-clock stamp below is post-device-sync
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if spike_us:
            time.sleep(spike_us / 1e6)
        bad: List[int] = []
        if finite is not None:
            bad = [i for i, r in enumerate(self.slots)
                   if r is not None and not bool(finite[i])]
        new_tokens = 0
        first_token: List[int] = []
        completed: List[int] = []
        for i, r in enumerate(self.slots):
            if r is None or i in bad:
                continue
            if r.fed >= len(r.prompt):
                r.out.append(int(nxt[i]))
                new_tokens += 1
                if len(r.out) == 1:
                    r.ttft_seen = True
                    first_token.append(i)
                if len(r.out) >= r.gen:
                    completed.append(i)
        if observing:
            now = self._now_us()
            wall_us = int((time.perf_counter() - t0) * 1e6)
            for i in first_token:
                r = self.slots[i]
                assert r is not None
                r.first_token_us = now
                if self.spans is not None:
                    self.spans.emit(SP.REQ_FIRST_TOKEN, ts_us=now,
                                    prov=SP.req_prov(r.rid), step=self.steps,
                                    rid=r.rid, slot=i)
                if self._m is not None and r.enqueue_us >= 0 \
                        and not r.ttft_observed:
                    # once per request: a retried victim keeps its original
                    # TTFT; the -1 sentinel can never reach the histogram
                    # because observation happens only at emission time
                    self._m["ttft"].observe(now - r.enqueue_us)
                    r.ttft_observed = True
        for i in completed:
            self._complete(i, SP.FINISHED)
        for i in bad:
            self._quarantine(i)
        if self.spans is not None:
            self.spans.emit(SP.STEP, prov=SP.step_prov(self.steps),
                            step=self.steps, dur_us=wall_us,
                            data=(occupied, len(self.queue), new_tokens,
                                  prefill_fed))
        if self._m is not None:
            m = self._m
            m["steps"].inc()
            m["gen"].inc(new_tokens)
            m["pre"].inc(prefill_fed)
            m["occ"].set(self.inflight)
            m["step_h"].observe(wall_us)
        if self.layers is not None and seg_walls is not None:
            # one-clock rule: when a span tracer is attached its epoch is
            # authoritative, so the layer records stamp with the same
            # post-step `now` as the step span they join to
            self.layers.on_step(
                self.steps, self._prof.ops, seg_walls,
                ts_us=now if self.spans is not None else None)
        self._health_step(detected=bool(bad))
        self._tick += 1 + spike_ticks
        self._enforce_deadlines()
        self.pos += 1
        self.steps += 1

    def _quarantine(self, i: int) -> None:
        """Non-finite logits on slot ``i``: zero the slot's cache
        positions, release the slot, and either requeue the victim with
        backoff or terminate it when attempts are exhausted."""
        r = self.slots[i]
        assert r is not None
        self.faults_detected += 1
        if self._m is not None:
            self._m["fdet"].inc()
        self._record_fault()
        self.cache = decode.reset_cache_slot(self.cfg, self.cache, i)
        res = self.res
        if r.attempt >= res.max_attempts:
            reason = RES.REASON_FAULT if res.max_attempts == 1 \
                else RES.REASON_RETRY_EXHAUSTED
            self._complete(i, SP.TRUNCATED_PREFIX + reason)
            return
        self.slots[i] = None
        failed = r.attempt
        r.attempt += 1
        r.out = []
        r.fed = 0
        r.first_token_us = -1
        delay = RES.backoff_ticks(res, r.rid, failed)
        self.delayed.append((self._tick + 1 + delay, r))
        self.retries += 1
        if self.spans is not None:
            self.spans.emit(SP.REQ_RETRY, prov=SP.req_prov(r.rid),
                            step=self.steps, rid=r.rid, slot=i,
                            detail=SP.QUARANTINE_PREFIX + "nonfinite",
                            data=(failed, delay))
        if self._m is not None:
            self._m["retry"].inc()
            self._m["occ"].set(self.inflight)

    # -- drivers -------------------------------------------------------------

    def run(self) -> None:
        """Drain the queue, backed-off retries, and all in-flight work."""
        while self.queue or self.inflight or self.delayed:
            if self.pos >= self.max_len - 1:
                self.truncate_all("max_len")
                break
            self.admit()
            self.step()


class ReplayDriver:
    """Incremental replay of an arrival schedule: each request joins the
    queue once the engine has executed its ``arrival_step`` steps (when
    the engine goes idle the clock fast-forwards to the next arrival).

    One :meth:`tick` is one scheduler round (submit due arrivals, admit,
    step).  Exposing the replay one tick at a time lets the serve
    benchmark drive an instrumented and an uninstrumented engine through
    the identical schedule *interleaved tick-for-tick*, so its overhead
    comparison pairs wall-clock samples taken milliseconds apart —
    back-to-back full runs would be seconds apart and CPU load drift
    swamps the signal.

    Admission-control rejections are retryable: the driver plays the
    client, resubmitting a bounced request with doubling step backoff up
    to ``client_retries`` times before giving up and shedding it — so
    every offered request still terminates with an explicit reason.
    """

    def __init__(self, eng: Engine,
                 arrivals: Sequence[Tuple[int, Request]],
                 client_retries: int = 4) -> None:
        self.eng = eng
        self.arrivals = arrivals
        self._order = sorted(range(len(arrivals)),
                             key=lambda j: (arrivals[j][0],
                                            arrivals[j][1].rid))
        self._i = 0
        self.client_retries = client_retries
        self._pending: List[Tuple[int, int, Request]] = []  # (due, tries, r)

    @property
    def active(self) -> bool:
        return (self._i < len(self.arrivals) or bool(self._pending)
                or bool(self.eng.queue) or bool(self.eng.delayed)
                or bool(self.eng.inflight))

    def _offer(self, req: Request, tries: int = 0) -> None:
        if self.eng.submit(req) == "rejected":
            if tries >= self.client_retries:
                self.eng.shed(req)
            else:
                self._pending.append((self.eng.steps + (2 << tries),
                                      tries + 1, req))

    def _submit_due(self, all_remaining: bool = False) -> None:
        eng = self.eng
        if self._pending:
            due = [(d, t, r) for d, t, r in self._pending
                   if all_remaining or d <= eng.steps]
            if due:
                self._pending = [p for p in self._pending if p not in due]
                for d, t, r in sorted(due, key=lambda p: (p[0], p[2].rid)):
                    self._offer(r, t)
        while self._i < len(self.arrivals) and (
                all_remaining
                or self.arrivals[self._order[self._i]][0] <= eng.steps
                or (not eng.inflight and not eng.queue and not eng.delayed
                    and not self._pending)):
            self._offer(self.arrivals[self._order[self._i]][1])
            self._i += 1

    def _flush(self) -> None:
        """Force every not-yet-offered request into the engine and shed
        anything still bouncing, so ``truncate_all`` accounts for all."""
        self._submit_due(all_remaining=True)
        while self._pending:
            _, _, r = self._pending.pop(0)
            self.eng.shed(r)

    def tick(self) -> bool:
        """One scheduler round; returns True if an engine step ran."""
        if not self.active:
            return False
        eng = self.eng
        self._submit_due()
        if eng.pos >= eng.max_len - 1:
            self._flush()
            eng.truncate_all("max_len")
            return False
        eng.admit()
        eng.step()
        return True


def replay(eng: Engine, arrivals: Sequence[Tuple[int, Request]]) -> None:
    """Drive ``eng`` through an arrival schedule to completion."""
    drv = ReplayDriver(eng, arrivals)
    while drv.active:
        drv.tick()


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; raises "
                         "without a card unless --device cpu)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival-mean", type=float, default=0.0,
                    help="Poisson mean inter-arrival gap in engine steps "
                         "(0 = whole queue arrives up front)")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics registry here on exit "
                         "(.json -> JSON, anything else -> Prometheus text)")
    ap.add_argument("--spans-out", default="",
                    help="write the span event stream here as JSONL")
    ap.add_argument("--profile-layers", default="",
                    help="run the sliced per-operator step and write one "
                         "layer record per operator per engine step here "
                         "as JSONL (obs.modelprof)")
    ap.add_argument("--stable", action="store_true",
                    help="normalize wall-clock fields in the span/layer "
                         "exports (byte-identical across same-seed runs)")
    ap.add_argument("--fault-plan", default="",
                    help="replay a FaultPlan JSON (launch.faults); "
                         "auto-enables resilience")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="per-request completion deadline in engine ticks "
                         "(0 = none); auto-enables resilience")
    ap.add_argument("--ttft-deadline-steps", type=int, default=0,
                    help="per-request TTFT deadline in engine ticks")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="bound the queue (0 = unbounded)")
    ap.add_argument("--shed-policy", default=RES.POLICY_REJECT_NEWEST,
                    choices=RES.SHED_POLICIES)
    ap.add_argument("--max-attempts", type=int, default=3,
                    help="total tries per request incl. the first")
    ap.add_argument("--resilience", action="store_true",
                    help="enable the resilience layer even with no faults "
                         "or deadlines configured")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    rng = np.random.default_rng(args.seed)
    params = MP.init_params(cfg, seed=args.seed, device=device)
    per_req = args.prompt_len + args.gen
    if args.arrival_mean > 0:
        # spread arrivals stretch the schedule; budget for a serial tail
        max_len = per_req * args.requests + 8
    else:
        max_len = per_req * (1 + args.requests // args.slots) + 8

    resilient = (args.resilience or args.fault_plan or args.deadline_steps
                 or args.ttft_deadline_steps or args.queue_cap)
    res = RES.ResilienceConfig(
        max_attempts=args.max_attempts, queue_cap=args.queue_cap,
        shed_policy=args.shed_policy, deadline_ticks=args.deadline_steps,
        ttft_deadline_ticks=args.ttft_deadline_steps,
        seed=args.seed) if resilient else None
    plan = FLT.FaultPlan.load(args.fault_plan) if args.fault_plan else None
    if plan is not None or res is not None:
        # retries replay whole requests and exception faults freeze pos:
        # give the step budget headroom so chaos runs end by draining, not
        # by tripping the max_len guard
        max_len = max_len * 2 + 64

    trace = traffic.synth_trace(args.seed, args.requests, args.arrival_mean,
                                [args.prompt_len], [args.gen])
    arrivals = [(t.arrival_step,
                 Request(t.rid,
                         rng.integers(1, cfg.vocab_size,
                                      size=t.prompt_len).astype(np.int32),
                         t.gen_len))
                for t in trace]

    metrics = MetricsRegistry() if args.metrics_out else None
    spans_tr = SpanTracer() if args.spans_out else None
    layers = LayerProfiler() if args.profile_layers else None
    eng = Engine(cfg, params, args.slots, max_len,
                 metrics=metrics, spans=spans_tr, layers=layers,
                 faults=plan, resilience=res, device=device)

    t0 = time.perf_counter()
    replay(eng, arrivals)
    # Engine.step syncs on the step outputs before returning, so this delta
    # is a true post-device wall clock.
    dt = time.perf_counter() - t0
    finished = [r for r in eng.done if r.reason == SP.FINISHED]
    truncated = [r for r in eng.done if r.reason != SP.FINISHED]
    total_tokens = sum(len(r.out) for r in eng.done)
    print(f"[serve] {cfg.name}: {len(finished)}/{args.requests} requests, "
          f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s, "
          f"{eng.steps} engine steps)")
    if truncated:
        print(f"[serve] {len(truncated)} truncated: "
              f"{sorted(set(r.reason for r in truncated))}")
    if plan is not None or res is not None:
        print(f"[serve] resilience: {eng.faults_injected} faults injected, "
              f"{eng.faults_detected} detected, {eng.retries} retries, "
              f"goodput {len(finished) / max(args.requests, 1):.3f}, "
              f"health={eng.health}")
    if metrics is not None:
        ttft = metrics.get("serve_ttft_us")
        print(f"[serve] ttft p50={ttft.quantile(0.5):.0f}us "
              f"p99={ttft.quantile(0.99):.0f}us "
              f"({ttft.count} first tokens)")
        with open(args.metrics_out, "w") as f:
            f.write(metrics.dump_json()
                    if args.metrics_out.endswith(".json")
                    else metrics.to_prometheus())
        print(f"[serve] metrics -> {args.metrics_out}")
    if spans_tr is not None:
        problems = SP.validate(spans_tr.events, slots=args.slots,
                               engine_steps=eng.steps)
        assert not problems, problems
        with open(args.spans_out, "w") as f:
            f.write(SP.to_jsonl(spans_tr.events, stable=args.stable))
        print(f"[serve] {len(spans_tr.events)} span events -> "
              f"{args.spans_out}{' (stable)' if args.stable else ''}")
    if layers is not None:
        problems = MPF.validate(layers.records, cfg=cfg,
                                engine_steps=eng.steps)
        if spans_tr is not None:
            problems += MPF.join_mismatches(layers.records,
                                            spans_tr.events, cfg=cfg)
        assert not problems, problems
        with open(args.profile_layers, "w") as f:
            f.write(MPF.to_jsonl(layers.records, stable=args.stable))
        print(f"[serve] {len(layers.records)} layer records -> "
              f"{args.profile_layers}{' (stable)' if args.stable else ''}")
    assert len(eng.done) == args.requests, "requests lost by the engine"
    if plan is None and res is None:
        assert len(finished) == args.requests, "not all requests completed"
    print("OK")


if __name__ == "__main__":
    main()
