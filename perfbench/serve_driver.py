"""Serving cells: closed-loop clients on the port's lockstep ``Engine``.

The harness plays the clients itself.  Each client sends its next request
as soon as the previous one completes; the clients start staggered over
one mean request (the ramp, part of set-up).  One loop round is: the idle
clients submit, ``Engine.admit``, ``Engine.step`` (which ends in the
engine's own device synchronize).  A client offers a request to the
current engine session only if its prompt and output fit in the positions
the session has left; once the session has drained, a new ``Engine`` on the
same weights takes over (the turnover's time counts where it falls).

Every time is the host clock after the step returned.  The harness also
records the token each slot was fed at each position, from its own count
of each request's prompt, so the reference can replay every slot's stream.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import counts, traffic as TR


class _Client:
    __slots__ = ("reqs", "i", "start", "busy", "blocked")

    def __init__(self, reqs, start):
        self.reqs, self.i, self.start = reqs, 0, start
        self.busy = self.blocked = False


class Hooks:
    """``record_function`` ranges around the port's decode attention and
    MoE block, and a record of each MoE call's routing, installed from the
    harness in the traced run only (the program has no ranges there yet)."""

    ATTN, MOE = "perfbench.attn_decode", "perfbench.moe_block"

    def __init__(self):
        from repro_torch.models import attention as A, moe as M
        self.A, self.M = A, M
        self.orig = (A.attn_decode, M.moe_block, M._router)
        self.routes: List[torch.Tensor] = []
        self.recording = False

        def ranged(name, fn):
            def wrapped(*a, **k):
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            return wrapped

        def router(*a, **k):
            out = self.orig[2](*a, **k)
            if self.recording:
                self.routes.append(out[1])
            return out

        A.attn_decode = ranged(self.ATTN, self.orig[0])
        M.moe_block = ranged(self.MOE, self.orig[1])
        M._router = router

    def close(self):
        self.A.attn_decode, self.M.moe_block, self.M._router = self.orig


class Capture:
    """The top ``TOPK`` logits (values and ids) of every slot at every
    engine step, as the program's serve step returned them: the check
    compares them with the reference's.  One ``topk`` on the device a step,
    kept on the device until the window has closed."""

    TOPK = 8

    def __init__(self):
        from repro_torch.models import decode
        self.decode, self.orig = decode, decode.make_serve_step
        self.steps: List = []

        def make(cfg):
            step = self.orig(cfg)

            def run(params, cache, tokens, pos):
                logits, cache = step(params, cache, tokens, pos)
                self.steps.append(torch.topk(logits[:, -1], self.TOPK, dim=-1))
                return logits, cache
            return run

        decode.make_serve_step = make

    def close(self):
        self.decode.make_serve_step = self.orig


def run(cfg_file: Dict, port_cfg, spec: Dict, params, seed: int,
        seconds: float, trace: bool, device, t_start: float, log) -> Dict:
    """Set up, ramp, and measure for ``seconds``.  Returns the run's
    record: stamps, streams, the traced window, and what the check needs."""
    from repro_torch.launch.serve import Engine, Request
    from perfbench import trace as TW

    slots, max_len = spec["slots"], spec["max_len"]
    reqs = TR.serve_requests(spec, seed, cfg_file["vocab_size"])
    starts = TR.client_start_steps(spec)
    clients = [_Client(r, starts[j]) for j, r in reqs]
    ramp_steps = TR.mean_request_steps(spec)
    warm = spec["warmup_steps"]
    hooks = Hooks() if trace else None
    capture = Capture()

    sessions: List[List[np.ndarray]] = []
    session_start: List[int] = []       # capture index of each session's step 0
    meta: Dict[int, Dict] = {}          # rid -> request record
    by_rid: Dict[int, _Client] = {}
    fed: Dict[int, int] = {}
    seen: Dict[int, int] = {}
    eng = None
    done_i = 0
    rid_next = 0
    step_walls: List[float] = []
    traced: List[Dict] = []
    window_flops = 0.0
    out_tokens = 0
    steps = 0

    def new_session():
        nonlocal eng, done_i
        eng = None                      # free the old cache first
        eng = Engine(port_cfg, params, slots, max_len, device=device)
        sessions.append([])
        session_start.append(len(capture.steps))
        done_i = 0

    def submit_ready(now: float):
        nonlocal rid_next
        for c in clients:
            if c.busy or c.blocked or steps < warm + c.start:
                continue
            prompt, gen = c.reqs[c.i % len(c.reqs)]
            if len(prompt) + gen > max_len:     # fits no session: never sent
                c.i += 1
                continue
            if eng.pos + len(prompt) + gen > max_len:
                c.blocked = True
                continue
            r = Request(rid_next, prompt, gen)
            meta[rid_next] = {"sent": now, "plen": len(prompt), "gen": gen,
                              "session": len(sessions) - 1, "slot": -1,
                              "start": -1, "stamps": [], "end": None,
                              "reason": None}
            by_rid[rid_next] = c
            fed[rid_next] = seen[rid_next] = 0
            eng.submit(r)
            c.busy, c.i = True, c.i + 1
            rid_next += 1

    def one_step(window: bool):
        nonlocal done_i, window_flops, out_tokens, steps
        now = time.perf_counter()
        submit_ready(now)
        if not eng.inflight and not eng.queue and any(c.blocked for c in clients):
            new_session()
            for c in clients:
                c.blocked = False
            submit_ready(time.perf_counter())
        t_a = time.perf_counter()
        eng.admit()
        row = np.zeros(slots, np.int64)
        flops = 0.0
        snapshot = list(eng.slots)
        for i, r in enumerate(snapshot):
            if r is None:
                continue
            f = fed[r.rid]
            if f < len(r.prompt):
                if f == 0:
                    meta[r.rid]["slot"], meta[r.rid]["start"] = i, eng.pos
                row[i] = r.prompt[f]
                fed[r.rid] = f + 1
                ctx = f + 1
            else:
                row[i] = r.out[-1]
                ctx = len(r.prompt) + len(r.out)
            flops += counts.serve_token_flops(cfg_file, ctx)
        sessions[-1].append(row)
        if hooks is not None and hooks.recording:
            traced.append({"pos": eng.pos, "slots": slots})
        eng.step()
        t_b = time.perf_counter()
        for r in snapshot:
            if r is not None and len(r.out) > seen[r.rid]:
                seen[r.rid] = len(r.out)
                meta[r.rid]["stamps"].append(t_b)
                if window:
                    out_tokens += 1
        for r in eng.done[done_i:]:
            meta[r.rid]["end"], meta[r.rid]["reason"] = t_b, r.reason
            meta[r.rid]["out"] = list(r.out)
            by_rid[r.rid].busy = False
        done_i = len(eng.done)
        if window:
            step_walls.append(t_b - t_a)
            window_flops += flops
        steps += 1

    new_session()
    while steps < warm + ramp_steps:
        one_step(False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    trace_at = spec.get("trace_after_steps", 5)
    trace_steps = spec.get("trace_steps", 20)
    summary = None
    paused = 0.0            # profiled steps and trace reading, in the window
    traced_flops = 0.0
    t0 = time.perf_counter()
    n = 0
    while True:
        if trace and n == trace_at:
            for attempt in range(4):
                hooks.recording = True
                hooks.routes.clear()
                traced.clear()
                t_w, flops_w = time.perf_counter(), window_flops
                w = TW.Window(device)
                with w:
                    for _ in range(trace_steps):
                        one_step(True)
                        n += 1
                hooks.recording = False
                summary = w.read([Hooks.ATTN, Hooks.MOE])
                # the profiled steps run slower: leave them and the trace's
                # reading out of the window that mfu.serve divides by
                paused += time.perf_counter() - t_w
                traced_flops += window_flops - flops_w
                log(f"trace window {attempt}: span/events "
                    f"{summary.get('span_ratio')} trusted {summary.get('trusted')}")
                if summary.get("trusted") or device.type != "cuda":
                    break
            else:
                summary = None
        one_step(True)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    capture.close()
    if hooks is not None:
        hooks.close()
    return {
        "setup_s": t0 - t_start, "window": (t0, t1),
        "untraced_s": t1 - t0 - paused,
        "steps": n, "step_walls": step_walls, "meta": meta,
        "sessions": sessions, "session_start": session_start,
        "logits_top": capture.steps,
        "untraced_flops": window_flops - traced_flops,
        "out_tokens": out_tokens, "trace": summary, "traced": traced,
        "routes": hooks.routes if hooks is not None else [],
        "engine": eng,
    }


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics of every sample (numpy's default rule)."""
    v = sorted(values)
    if not v:
        return float("nan")
    x = (len(v) - 1) * q / 100.0
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def end_to_end(rec: Dict, log) -> Dict[str, float]:
    """The serving cells' end-to-end metrics from the run's stamps."""
    t0, t1 = rec["window"]
    win = t1 - t0
    ttft, itl = [], []
    attempted = failed = 0
    for m in rec["meta"].values():
        st = m["stamps"]
        if st and t0 <= st[0] <= t1:
            ttft.append(st[0] - m["sent"])
        itl.extend(b - a for a, b in zip(st, st[1:]) if a >= t0 and b <= t1)
        if m["end"] is not None and t0 <= m["end"] <= t1:
            attempted += 1
            failed += m["reason"] != "finished"
    log(f"window {win:.3f} s, {rec['steps']} steps, {rec['out_tokens']} "
        f"output tokens, ttft samples {len(ttft)}, itl samples {len(itl)}, "
        f"requests ended {attempted} (failed {failed})")
    return {
        "decode_tokens_per_s": rec["out_tokens"] / win,
        "ttft_p95_ms": percentile(ttft, 95) * 1e3,
        "itl_p95_ms": percentile(itl, 95) * 1e3,
        "setup_s": rec["setup_s"],
        "_attempted": attempted, "_failed": failed,
    }


def check_sample(rec: Dict, seed: int, want_tokens: int) -> List[int]:
    """Finished requests to compare, drawn from the seed: the one with the
    most served tokens, then others in a seeded order until ``want_tokens``
    served tokens are in."""
    done = sorted(rid for rid, m in rec["meta"].items()
                  if m["reason"] == "finished")
    if not done:
        return []
    longest = max(done, key=lambda r: (rec["meta"][r]["gen"],
                                       rec["meta"][r]["plen"], -r))
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 0xC4EC])
    pick, total = [longest], rec["meta"][longest]["gen"]
    for rid in rng.permutation(done):
        if total >= want_tokens:
            break
        if int(rid) != longest:
            pick.append(int(rid))
            total += rec["meta"][int(rid)]["gen"]
    return sorted(pick)


def _errors(ref: torch.Tensor, values: torch.Tensor, ids: torch.Tensor,
            served: torch.Tensor) -> torch.Tensor:
    """Per position, the larger of: the largest gap between a logit of
    ``values`` (at ``ids``) and the reference's logit of the same token, and
    the reference's best logit less its logit of the ``served`` token."""
    off = (values - ref.gather(1, ids)).abs().amax(dim=1)
    gap = ref.max(dim=-1).values - ref.gather(1, served[:, None])[:, 0]
    return torch.maximum(off, gap)


def reference_errors(cfg_file: Dict, weights, rec: Dict, rids: List[int],
                     device, precision: Optional[str] = None) -> Dict:
    """At each served token of the sampled requests: ``errors``, how far the
    program's logits lie from the reference's (``_errors`` over the
    program's top logits and the served token); ``gaps``, the reference's
    best logit less its logit of the served token; ``altered``, the error
    were each served token replaced by the next id (a token altered where
    it is produced).  With a control ``precision``, ``control``: the same
    error of the reference computed in that precision, with the token it
    puts first as the served one.  Per session the reference replays every
    slot's stream up to the last position a sampled request needs, in the
    configuration's reference module."""
    from perfbench import cells
    REF = cells.reference(cfg_file)
    out: Dict[str, List[torch.Tensor]] = {"errors": [], "gaps": [],
                                          "altered": [], "control": []}
    by_session: Dict[int, List[int]] = {}
    for rid in rids:
        by_session.setdefault(rec["meta"][rid]["session"], []).append(rid)
    for s, srids in sorted(by_session.items()):
        rows, served = [], []
        for rid in srids:
            m = rec["meta"][rid]
            first = m["start"] + m["plen"] - 1
            for j, tok in enumerate(m["out"]):
                rows.append((m["slot"], first + j))
                served.append(tok)
        t_need = max(r[1] for r in rows) + 1
        st = torch.from_numpy(np.stack(rec["sessions"][s][:t_need], axis=1)).to(device)
        ref = REF.stream_logits(cfg_file, weights, st, rows)
        top = [rec["logits_top"][rec["session_start"][s] + t] for _, t in rows]
        pick = (torch.arange(len(rows)), torch.tensor([r[0] for r in rows]))
        values = torch.stack([v.cpu() for v, _ in top])[pick].to(device)
        ids = torch.stack([i.cpu() for _, i in top])[pick].to(device)
        tok = torch.tensor(served, device=device)
        out["errors"].append(_errors(ref, values.float(), ids, tok))
        out["gaps"].append(ref.max(dim=-1).values - ref.gather(1, tok[:, None])[:, 0])
        out["altered"].append(_errors(ref, values.float(), ids,
                                      (tok + 1) % ref.shape[1]))
        if precision is not None:
            ctl = REF.stream_logits(cfg_file, weights, st, rows, precision)
            cv, ci = torch.topk(ctl, Capture.TOPK, dim=-1)
            out["control"].append(_errors(ref, cv, ci, ci[:, 0]))
            del ctl
        del ref
    res = {k: torch.cat(v).cpu() for k, v in out.items() if v}
    res["tokens"] = int(res["errors"].numel()) if "errors" in res else 0
    return res


def check(cfg_file: Dict, spec: Dict, rec: Dict, seed: int, weights, device,
          log, limits=None) -> Dict[str, float]:
    """The numbers compared (``verdict``), from a sample of the window's
    finished requests against the reference on ``weights``:
    ``logit_err_share``, the share of the sampled served tokens whose error
    is over the limits' ``margin``."""
    rids = check_sample(rec, seed, spec["check_tokens"])
    got = reference_errors(cfg_file, weights, rec, rids, device)
    n = got["tokens"]
    margin = ((limits or {}).get("logit_err_share") or {}).get("margin")
    if not n or margin is None:
        return {"logit_err_share": float("nan")}
    e = got["errors"].double()
    log(f"checked {len(rids)} requests, {n} served tokens; error quartiles "
        f"{[float(q) for q in e.quantile(torch.tensor([0.25, 0.5, 0.75], dtype=e.dtype))]}"
        f", widest {float(e.max())}, widest gap of a served token "
        f"{float(got['gaps'].max())} (not compared)")
    return {"logit_err_share": float((e > margin).double().mean())}
