"""Each configuration file against the port's registered config, and the
harness's weight tree against the port's parameter shapes."""
import pytest
import torch

from perfbench import cells, run, weights as W

CONFIGS = [c["name"] for c in cells.benchmark()["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_equals_registered(name):
    from repro_torch.models import get_config
    c = cells.config(name)
    port = get_config(c["port_config"])
    assert cells.check_port_config(c, port) == []
    for k in cells.PORT_KEYS:
        assert k in c, k
    assert c["reduced"] == [] and c["dtype"] == port.dtype == "bfloat16"
    assert c["departures"] and len(c["source"]) <= 200


@pytest.mark.parametrize("name", CONFIGS)
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
