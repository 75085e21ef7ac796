"""The yardstick's FLOP and byte counts against hand counts at small shapes."""
import math

import numpy as np
import pytest

from perfbench import counts

C = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
     "head_dim": 4, "d_ff": 6, "vocab_size": 10, "num_experts": 4,
     "experts_per_token": 2, "moe_capacity_factor": 1.25,
     "capacity_multiple": 8, "dtype": "bfloat16", "tie_embeddings": False,
     "reference": "perfbench/reference/moe_lm.py"}


def test_active_params_by_hand():
    attn = 8 * 8 + 8 * 4 + 8 * 4 + 8 * 8          # wq, wk, wv, wo
    per_layer = attn + 8 * 4 + 2 * 3 * 8 * 6       # router, 2 experts
    assert counts.active_params(C) == 2 * per_layer + 8 * 10


def test_active_params_of_a_share_of_the_experts():
    """A file that holds 2 of the 4 experts the router chooses among: a
    token multiplies 2 x 2 / 4 of the experts held; a tied head counts
    once, as the embedding transposed."""
    c = dict(C, num_experts=2, router_experts=4, tie_embeddings=True)
    attn = 8 * 8 + 8 * 4 + 8 * 4 + 8 * 8
    per_layer = attn + 8 * 2 + 3 * 8 * 6 * 2 * 2 / 4
    assert counts.active_params(c) == 2 * per_layer + 8 * 10


def test_train_step_flops_of_other_widths():
    """Scores ``qk_head_dim`` wide, values ``v_head_dim``, attention in
    ``attention_layers`` of the layers."""
    b, s = 2, 3
    c = dict(C, qk_head_dim=6, v_head_dim=5, attention_layers=1)
    attn_fwd = 2 * b * 2 * (6 + 5) * (1 + 2 + 3)
    assert counts.train_step_flops(c, b, s) == \
        6 * counts.active_params(c) * b * s + 3 * 1 * attn_fwd


@pytest.mark.parametrize("name,active,flops", [
    ("granite-moe-1b-a400m", 428_608_512, 52_031_951_732_736),
    ("olmoe-1b-7b", 1_178_861_568, 129_084_168_339_456)])
def test_counts_of_the_configuration_files(name, active, flops):
    """What ``mfu.train`` divides by, as the hand-written MoE formula gave
    it: 4 x 4,096 tokens a step."""
    from perfbench import cells
    c = cells.config(name)
    assert counts.active_params(c) == active
    assert counts.train_step_flops(c, 4, 4096) == flops


def test_attn_decode_call_by_hand():
    got = counts.attn_decode_call(C, batch=3, pos=5)
    proj = 192
    flops = 2 * 3 * proj + 2 * 2 * 3 * 2 * 6 * 4   # q.k and p.v over 6 keys
    nbytes = 2 * (proj + 2 * 3 * 8 + 2 * 3 * 1 * 4 + 2 * 3 * 1 * 5 * 4)
    assert got == {"flops": flops, "bytes": nbytes}


def test_moe_call_by_hand():
    got = counts.moe_call(C, tokens=3, kept=5, experts_hit=2)
    assert got["flops"] == 2 * 3 * 8 * 4 + 2 * 5 * 3 * 8 * 6
    assert got["bytes"] == 2 * (2 * 3 * 8 * 6 + 8 * 4 + 2 * 3 * 8)


def test_serve_token_flops_by_hand():
    assert counts.serve_token_flops(C, 7) == \
        2 * counts.active_params(C) + 2 * (2 * 2 * 2 * 4 * 7)


def test_train_step_flops_by_hand():
    b, s = 2, 3
    attn_fwd = 2 * 2 * b * 2 * 4 * (1 + 2 + 3)     # causal: 1 + 2 + 3 keys
    assert counts.train_step_flops(C, b, s) == \
        6 * counts.active_params(C) * b * s + 3 * 2 * attn_fwd


@pytest.mark.parametrize("tokens,cap", [(1, 8), (12, 8), (13, 16), (128, 80)])
def test_capacity(tokens, cap):
    # ceil(tokens * 2 * 1.25 / 4), up to a multiple of 8, at least 8
    assert counts.capacity(C, tokens) == cap
    assert cap >= math.ceil(tokens * 2 * 1.25 / 4)


def test_moe_routing_drops_past_capacity():
    # 13 tokens all to experts 0 and 1: capacity 16 keeps every one
    top = np.array([[0, 1]] * 13)
    assert counts.moe_routing(C, top, 13) == {"kept": 26, "hit": 2}
    # 20 tokens to 0 and 1 with capacity 16: 4 of each dropped
    top = np.array([[0, 1]] * 20)
    assert counts.moe_routing(C, top, 20) == {"kept": 32, "hit": 2}


def test_least_time_takes_the_larger_bound():
    assert counts.least_time_s(989e12, 1.0) == pytest.approx(1.0)
    assert counts.least_time_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_olmoe_decode_counts_at_full_size():
    """A full-width decode step: the MoE reads at most every expert's
    weights, 805 MB a layer in bf16."""
    from perfbench import cells
    c = cells.config("olmoe-1b-7b")
    moe = counts.moe_call(c, 128, 1024, 64)
    assert moe["bytes"] == pytest.approx(2 * (64 * 3 * 2048 * 1024 + 2048 * 64
                                              + 2 * 128 * 2048))
    assert counts.active_params(c) == 16 * (4 * 2048 * 2048 + 2048 * 64
                                            + 8 * 3 * 2048 * 1024) + 2048 * 50304
