"""The port's expert-parallel MoE dispatch (``moe_block_banked_ep``) on two
gloo ranks against the reference's ``shard_map`` on a (1, 2) host mesh,
and against both packages' single-device banked dispatch, at the kernel
tolerance (2e-5, f32).

The ranks form a (data 1, model 2) mesh under the default rules, so each
owns half of the reduced config's 4 experts; with one data shard the local
capacity is the global one, and the banked dispatch gives the same rows.
Both packages draw the same weights (``init_numpy_params``) and the same
input, passed to every process as one npz file.  The tolerance is relative
to the output's scale (max |want|, at least 1), as in
``tests/test_torch_moe.py``: the seeded expert weights give outputs in the
hundreds, where two float32 summation orders differ by more than 2e-5 in
the elements that cancel."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import get_config, moe  # noqa: E402
from repro_torch.models import params as MP  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
TOL = 2e-5


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


_RANK = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.models import get_config, moe
from repro_torch.models.common import set_sharding_rules
from repro_torch.sharding.rules import (PartitionSpec as P, ShardingStrategy,
                                        logical_rules, to_placements)
rank, store, arch, inp, out = (int(sys.argv[1]),) + tuple(sys.argv[2:])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
try:
    cfg = get_config(arch).reduced()
    data = dict(np.load(inp))
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    set_sharding_rules(mesh, logical_rules(ShardingStrategy()))
    assert moe._ep_context() is not None
    x = distribute_tensor(torch.from_numpy(data.pop("x")), mesh,
                          to_placements(P(("data",), None, None), mesh))
    p = {k: distribute_tensor(torch.from_numpy(v), mesh, to_placements(
            P("model", None, None) if v.ndim == 3 else P(None, None), mesh))
         for k, v in data.items()}
    y, aux = moe.moe_block(cfg, p, x)
    np.savez(out, y=y.full_tensor().numpy(),
             **{k: v.full_tensor().numpy() for k, v in aux.items()})
finally:
    dist.destroy_process_group()
"""

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.models import get_config, moe
from repro.models.common import clear_sharding_rules, set_sharding_rules
from repro.sharding.rules import ShardingStrategy, logical_rules
arch, inp, out = sys.argv[1:]
cfg = get_config(arch).reduced()
data = {k: jnp.asarray(v) for k, v in np.load(inp).items()}
x = data.pop("x")
mesh = jax.make_mesh((1, 2), ("data", "model"))
set_sharding_rules(mesh, logical_rules(ShardingStrategy()))
with mesh:
    y, aux = jax.jit(lambda p, x: moe.moe_block(cfg, p, x))(data, x)
clear_sharding_rules()
yb, auxb = moe.moe_block_banked(cfg, data, x)
np.savez(out, y=np.asarray(y), yb=np.asarray(yb),
         **{k: np.asarray(v) for k, v in aux.items()},
         **{"b_" + k: np.asarray(v) for k, v in auxb.items()})
"""


def _inputs(arch, path):
    cfg = get_config(arch).reduced()
    tree = MP.init_numpy_params(cfg, seed=0)
    p = {k: np.asarray(v[0]) for k, v in tree["blocks"]["lyr"]["moe"].items()}
    x = np.random.default_rng(3).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32)
    np.savez(path, x=x, **p)
    return cfg, x, p


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-1b-a400m"])
def test_expert_parallel_matches_the_reference(arch, tmp_path):
    cfg, x, p = _inputs(arch, tmp_path / "in.npz")
    assert cfg.num_experts % 2 == 0
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"), arch,
         str(tmp_path / "in.npz"), str(outs[r])], env=ENV, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, arch, str(tmp_path / "in.npz"),
         str(tmp_path / "ref.npz")], env={**ENV, "JAX_PLATFORMS": "cpu"},
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        for proc in procs + [ref]:
            _, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-2000:]
    finally:
        for proc in procs + [ref]:
            proc.kill()
    ranks = [dict(np.load(o)) for o in outs]
    want = dict(np.load(tmp_path / "ref.npz"))
    yb, auxb = moe.moe_block_banked(
        cfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x))
    for got in ranks:                          # both ranks hold the result
        _close(got["y"], want["y"])
        _close(got["y"], yb.numpy())
        for k in ("moe_aux", "moe_zloss"):
            _close(got[k], want[k])
            _close(got[k], auxb[k].numpy())
    # the single-device banked dispatch of both packages agrees too
    _close(yb.numpy(), want["yb"])
    _close(want["y"], want["yb"])
