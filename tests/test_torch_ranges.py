"""The port's layer ranges and training counters, on the CPU.

* Under ``torch.profiler``, a reduced MoE train step with remat records each
  layer's forward ranges twice (the forward and remat's recomputation) and
  its ``.bwd`` ranges once, properly nested on each thread and all closed;
  every backward product runs inside a ``.bwd`` range.
* The loss and the gradients are bit-equal with and without a profiler,
  and with no profiler the model code enters no range and puts no marker
  in the graph.
* ``obs.ranges.profile`` records the program's ranges and no operator.
* ``launch.steps.make_train_step(..., metrics=registry)`` counts steps,
  tokens and the MoE's dropped assignments (once a step under remat, equal
  to the drops of ``moe._assign``'s ``keep``), folded into the registry
  when it is read; without a registry nothing is counted.
"""
import dataclasses
import json
from collections import defaultdict

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.obs import ranges as R  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402

FORWARD = ("attn", "moe", "moe.router", "moe.assign", "moe.dispatch",
           "moe.experts", "moe.combine")


def _setup(capacity=None):
    """(a reduced granite MoE config with remat on, its weights, a batch of
    2 x 64 tokens)."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              remat=True)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    prm = P.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    return cfg, prm, {"tokens": tokens}


def _events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _annotations(events):
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _nested(intervals):
    """No two intervals of a thread overlap unless one holds the other."""
    stack = []
    for a, b, name in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        while stack and stack[-1][1] <= a:
            stack.pop()
        if stack and b > stack[-1][1]:
            return False
        stack.append((a, b, name))
    return True


def test_ranges_through_forward_recomputation_and_backward(tmp_path):
    cfg, prm, batch = _setup()
    layers = cfg.num_groups
    step = S.make_train_step(cfg, A.AdamWConfig())
    state = {"params": prm, "opt": A.init_state(prm)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state, m = step(state, batch)
    events = _events(prof, tmp_path)
    ranges = _annotations(events)
    count = defaultdict(int)
    by_tid = defaultdict(list)
    for e in ranges:
        count[e["name"]] += 1
        by_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    for name in FORWARD:
        assert count[name] == 2 * layers, name      # forward, recomputation
    for name in ("attn.bwd", "moe.bwd"):
        assert count[name] == layers, name
    for name in ("embed", "embed.bwd", "lm_loss", "lm_loss.bwd",
                 "train_step.grads", "train_step.optimizer"):
        assert count[name] == 1, name
    assert all(_nested(iv) for iv in by_tid.values())

    # the recomputation runs inside its group's first .bwd range, moe.bwd
    moe_bwd = [(e["ts"], e["ts"] + e["dur"]) for e in ranges
               if e["name"] == "moe.bwd"]
    assert len(moe_bwd) == layers
    recomputed = [e for e in ranges if e["name"] == "attn"
                  and any(a <= e["ts"] <= b for a, b in moe_bwd)]
    assert len(recomputed) == layers
    # every backward product is inside a .bwd range of its thread
    bwd = [iv for iv in (iv for ivs in by_tid.values() for iv in ivs)
           if iv[2].endswith(".bwd")]
    products = [e for e in events if e.get("ph") == "X"
                and e.get("cat") == "cpu_op"
                and e["name"].startswith("autograd::engine::evaluate_function: ")
                and e["name"].split(": ")[1] in ("MmBackward0", "BmmBackward0")]
    assert len(products) >= 4 * layers
    for p in products:
        assert any(a <= p["ts"] and p["ts"] + p["dur"] <= b
                   for a, b, _ in bwd), p["name"]


def test_loss_and_gradients_are_bit_equal_under_a_profiler(tmp_path):
    cfg, prm, batch = _setup()
    base_m, base_g = S.grad_of(cfg, prm, batch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        prof_m, prof_g = S.grad_of(cfg, prm, batch)
    with R.profile("cpu", str(tmp_path / "ranges.json")):
        ranged_m, ranged_g = S.grad_of(cfg, prm, batch)
    for m, g in ((prof_m, prof_g), (ranged_m, ranged_g)):
        assert m.keys() == base_m.keys()
        assert all(torch.equal(m[k], base_m[k]) for k in m)
        assert all(torch.equal(a, b) for a, b in zip(g, base_g))


def test_without_a_profiler_the_model_enters_no_range(monkeypatch):
    """No range entered and no marker in the graph; the train step enters
    its own two ranges, as it always did."""
    cfg, prm, batch = _setup()
    entered, marked = [], []
    real = torch.ops.profiler._record_function_enter_new
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        lambda *a: entered.append(a[0]) or real(*a))
    for fn in (R._MarkInput, R._MarkOutput):
        monkeypatch.setattr(fn, "apply", lambda *a: marked.append(a))
    assert not R.profiling()
    S.grad_of(cfg, prm, batch)
    assert entered == [] and marked == []
    step = S.make_train_step(cfg, A.AdamWConfig())
    step({"params": prm, "opt": A.init_state(prm)}, batch)
    assert entered == ["train_step.grads", "train_step.optimizer"]
    assert marked == []


def test_ranges_only_session_records_ranges_and_no_operator(tmp_path):
    cfg, prm, batch = _setup()
    step = S.make_train_step(cfg, A.AdamWConfig())
    state = {"params": prm, "opt": A.init_state(prm)}
    with R.profile("cpu", str(tmp_path / "ranges.json")) as path:
        assert R.profiling()
        step(state, batch)
    assert not R.profiling()
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    cats = {e.get("cat") for e in events}
    assert "cpu_op" not in cats and "python_function" not in cats
    names = {e["name"] for e in _annotations(events)}
    assert {"train_step.grads", "attn", "attn.bwd", "moe.assign", "moe.bwd",
            "lm_loss.bwd", "embed.bwd"} <= names


def test_a_backward_range_closes_where_its_input_is_not_reached(tmp_path):
    """A gradient of the experts' weights alone never reaches the first
    layer's input marker: its ``moe.bwd`` closes when the backward ends,
    though the graph that holds it lives on."""
    cfg, prm, batch = _setup()
    leaves = A.leaves(prm)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            loss, _ = T.loss_fn(cfg, prm, batch)
            torch.autograd.grad(loss, [prm["blocks"]["lyr"]["moe"]["w2"]],
                                retain_graph=True)
            with torch.profiler.record_function("after_backward"):
                pass
    finally:
        for p in leaves:
            p.requires_grad_(False)
    ranges = _annotations(_events(prof, tmp_path))
    after = [e["ts"] for e in ranges if e["name"] == "after_backward"]
    bwd = [e for e in ranges if e["name"].endswith(".bwd")]
    assert sum(e["name"] == "moe.bwd" for e in bwd) == cfg.num_groups
    assert all(e["ts"] + e["dur"] <= after[0] for e in bwd)
    del loss


def test_decode_runs_the_forward_ranges_only(tmp_path):
    cfg, prm, batch = _setup()
    cache = D.init_cache(cfg, prm, 2, 8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        D.serve_step(cfg, prm, cache, batch["tokens"][:, :1], 0)
    count = defaultdict(int)
    for e in _annotations(_events(prof, tmp_path)):
        count[e["name"]] += 1
    assert count["attn"] == count["moe"] == cfg.num_groups
    assert not [n for n in count if n.endswith(".bwd")]


def _drops(cfg, prm, batch):
    """Assignments and dropped assignments of one forward, from ``keep``."""
    seen = []
    real = MOE._assign

    def spy(*a):
        out = real(*a)
        seen.append(out[2])
        return out
    MOE._assign = spy
    try:
        with torch.no_grad():
            T.loss_fn(cfg, prm, batch)
    finally:
        MOE._assign = real
    return (sum(k.numel() for k in seen),
            sum(int((~k).sum()) for k in seen))


def test_drop_counter_counts_each_forward_once_under_remat(monkeypatch):
    cfg, prm, batch = _setup(capacity=0.5)
    reg = MetricsRegistry()
    step = S.make_train_step(cfg, A.AdamWConfig(), metrics=reg)
    state = {"params": prm, "opt": A.init_state(prm)}
    calls = []
    real = MOE._assign
    monkeypatch.setattr(MOE, "_assign", lambda *a: calls.append(1) or real(*a))
    want_a = want_d = 0
    for _ in range(2):
        with monkeypatch.context() as m:
            m.setattr(MOE, "_assign", real)
            a, d = _drops(cfg, state["params"], batch)
        want_a, want_d = want_a + a, want_d + d
        state, _ = step(state, batch)
    assert len(calls) == 2 * 2 * cfg.num_groups       # forward, recomputation
    assert want_d > 0
    assert want_a == 2 * 2 * 64 * cfg.num_groups * cfg.experts_per_token
    assert reg.get("moe_assignments_total").value == want_a
    assert reg.get("moe_dropped_assignments_total").value == want_d
    assert reg.to_json()["metrics"]["moe_dropped_assignments_total"][
        "value"] == want_d                                  # folded once
    assert reg.get("train_steps_total").value == 2
    assert reg.get("train_tokens_total").value == 2 * 2 * 64
    # the allocator's counters are the card's
    assert "train_device_mallocs_total" not in reg.names()


def test_without_a_registry_no_tally_is_installed(monkeypatch):
    cfg, prm, batch = _setup()
    tallies = []
    real = MOE._assign

    def spy(*a):
        tallies.append(MOE._TALLY.get())
        return real(*a)
    monkeypatch.setattr(MOE, "_assign", spy)
    step = S.make_train_step(cfg, A.AdamWConfig())
    step({"params": prm, "opt": A.init_state(prm)}, batch)
    assert tallies and all(t is None for t in tallies)


def test_drop_counters_read_the_device_only_when_read(monkeypatch):
    """The step leaves the tally on the device; reading the counter reads
    it back, and reading twice counts nothing twice."""
    cfg, prm, batch = _setup(capacity=0.5)
    reg = MetricsRegistry()
    step = S.make_train_step(cfg, A.AdamWConfig(), metrics=reg)
    reads = []
    real = MOE.DropTally.dropped
    monkeypatch.setattr(MOE.DropTally, "dropped",
                        lambda self: reads.append(1) or real(self))
    step({"params": prm, "opt": A.init_state(prm)}, batch)
    assert reads == []
    first = reg.get("moe_dropped_assignments_total").value
    assert reads == [1] and first > 0
    assert reg.get("moe_dropped_assignments_total").value == first
    assert f"moe_dropped_assignments_total {first}" in reg.to_prometheus()
