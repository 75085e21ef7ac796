"""Each configuration file against the port's registered config, and the
harness's weight tree against the port's parameter shapes."""
import hashlib
import os

import pytest
import torch

from perfbench import cells, run, weights as W

# every configuration file of the harness, in a cell or not
ALL = sorted(f[:-5] for f in os.listdir(os.path.join(cells.HERE, "configs"))
             if f.endswith(".json"))
# the MoE files whose keys, counts and weights are pinned below
FILES = ["granite-moe-1b-a400m", "olmoe-1b-7b"]


@pytest.mark.parametrize("name", FILES)
def test_config_file_equals_registered(name):
    from repro_torch.models import get_config
    c = cells.config(name)
    port = get_config(c["port_config"])
    assert cells.check_port_config(c, port) == []
    assert set(cells.PORT_KEYS) | {"name"} <= set(cells.port_keys(c, port))
    assert c["reduced"] == [] and c["dtype"] == port.dtype == "bfloat16"
    assert c["departures"] and len(c["source"]) <= 200


@pytest.mark.parametrize("name", FILES)
def test_every_port_field_of_the_file_is_checked(name):
    """A port field that the file names and the port does not hold, even
    one outside the MoE's keys, is a difference."""
    import dataclasses
    from repro_torch.models import get_config
    c = cells.config(name)
    port = get_config(c["port_config"])
    c["qkv_bias"] = True
    assert "qkv_bias" in cells.port_keys(c, port)
    assert cells.check_port_config(c, port) == ["qkv_bias: file True, port False"]
    assert cells.check_port_config(c, dataclasses.replace(port, qkv_bias=True)) == []


# sha256 over each leaf's path and float32 bytes, in sorted-key order, of
# W.make at conftest.TINY and seed 2**31 + 77 on the CPU: the draw of the
# harness whose weight tree was written by hand in weights.py
DIGESTS = {
    "granite-moe-1b-a400m": "bfe15294fed29c90505a78ac159040d8a1b34df17fc6beab5bca8b2e96255ebb",
    "olmoe-1b-7b": "82ce1c80726c4541158562777747550a40049c20bb64492a46fda21889ef0189",
}


@pytest.mark.parametrize("name", FILES)
def test_weights_from_a_seed_are_pinned(name):
    from conftest import TINY
    c = dict(cells.config(name), **TINY)
    w = W.make(c, 2**31 + 77, torch.device("cpu"), torch.float32)
    h = hashlib.sha256()
    for path, t in W.leaf_paths(w):
        h.update(path.encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == DIGESTS[name]


@pytest.mark.parametrize("name", ALL)
def test_weight_tree_is_the_ports(name):
    from repro_torch.models import get_config
    from repro_torch.models.params import param_shapes
    c = cells.config(name)
    assert run._shape_tree(W.shapes(c)) == \
        run._shape_tree(param_shapes(get_config(c["port_config"])))


def test_weights_repeat_per_seed_at_their_scale():
    from conftest import TINY
    c = dict(cells.config("olmoe-1b-7b"), **TINY)
    a = W.make(c, 2**31 + 77, torch.device("cpu"), torch.float32)
    b = W.make(c, 2**31 + 77, torch.device("cpu"), torch.float32)
    d = W.make(c, 5, torch.device("cpu"), torch.float32)
    for (pa, ta), (_, tb), (_, td) in zip(W.leaf_paths(a), W.leaf_paths(b),
                                          W.leaf_paths(d)):
        assert torch.equal(ta, tb), pa
        if "ln" in pa or "norm" in pa:
            assert torch.all(ta == 1)
        else:
            assert not torch.equal(ta, td)
    wq = a["blocks"]["lyr"]["attn"]["wq"]
    assert abs(wq.std().item() - TINY["d_model"] ** -0.5) < 0.2 * TINY["d_model"] ** -0.5
    assert abs(a["embed"].std().item() - c["embed_std"]) < 0.2 * c["embed_std"]
