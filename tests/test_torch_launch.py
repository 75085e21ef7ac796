"""The port's launch layer against the reference's: shapes, cell skips,
model FLOPs, sharding rules, cache specs, divisibility, input specs and
their per-device bytes (the twin of ``tests/test_launch.py``).

Partition specs compare by ``tuple(spec)`` leaf for leaf, keys sorted at
every level.  Both packages' ``sanitize_spec`` and ``validate_divisibility``
read only a mesh's ``axis_names`` and ``devices.shape``, so stub 16x16 and
2x16x16 meshes stand in for the production ones here.  The input specs
need real meshes: the port's are fake DTensors over a fake process group
(one per process, so built in a subprocess) and the reference's are
``ShapeDtypeStruct``s over 512 host devices (a subprocess with the device
flag, specs only, nothing compiled).
"""
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from jax.sharding import PartitionSpec as JP  # noqa: E402
from repro.launch import shapes as RSH  # noqa: E402
from repro.launch.dryrun import model_flops as ref_model_flops  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro.models import params as RMP  # noqa: E402
from repro.sharding import rules as RR  # noqa: E402
from repro_torch.launch import shapes as SH  # noqa: E402
from repro_torch.launch.dryrun import model_flops  # noqa: E402
from repro_torch.models import all_names, get_config  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = all_names()
MESHES = {"none": None,
          "16x16": types.SimpleNamespace(axis_names=("data", "model"),
                                         devices=np.empty((16, 16))),
          "2x16x16": types.SimpleNamespace(
              axis_names=("pod", "data", "model"),
              devices=np.empty((2, 16, 16)))}
# (strategy, mesh): the pod strategy needs a pod axis
COMBOS = [("base", "none"), ("base", "16x16"), ("base", "2x16x16"),
          ("pod", "none"), ("pod", "2x16x16")]


def _strategies(pod: bool):
    if pod:
        return R.ShardingStrategy().with_pod(), RR.ShardingStrategy().with_pod()
    return R.ShardingStrategy(), RR.ShardingStrategy()


def _flat(tree, is_leaf):
    if is_leaf(tree):
        return [tree]
    return [x for k in sorted(tree) for x in _flat(tree[k], is_leaf)]


def test_shapes_and_skips_equal_the_reference():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind)
            for k, s in SH.SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind)
         for k, s in RSH.SHAPES.items()}
    for arch in ARCHS:
        for shape in SH.SHAPES:
            assert SH.cell_supported(get_config(arch), shape) == \
                RSH.cell_supported(ref_config(arch), shape), (arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_exact(arch):
    for shape in SH.SHAPES:
        assert model_flops(get_config(arch), SH.SHAPES[shape]) == \
            ref_model_flops(ref_config(arch), RSH.SHAPES[shape])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "-".join(c))
def test_param_pspecs_leaf_for_leaf(arch, combo):
    pod, mesh = combo[0] == "pod", MESHES[combo[1]]
    st, rst = _strategies(pod)
    got = _flat(R.param_pspecs(get_config(arch), st, mesh=mesh),
                lambda x: isinstance(x, R.PartitionSpec))
    want = _flat(RR.param_pspecs(ref_config(arch), rst, mesh=mesh),
                 lambda x: isinstance(x, JP))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    shapes = _flat(RMP.param_shapes(ref_config(arch)), RMP._is_leaf)
    assert len(shapes) == len(got)
    if mesh is not None:
        assert R.validate_divisibility(get_config(arch), mesh, st) == \
            RR.validate_divisibility(ref_config(arch), mesh, rst)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_the_reference(arch):
    for combo in ("16x16", "2x16x16"):
        mesh = MESHES[combo]
        st, rst = _strategies(combo == "2x16x16")
        for shape in SH.SHAPES.values():
            b = shape.global_batch
            got = _flat(SH.cache_pspecs(get_config(arch), b, mesh, st),
                        lambda x: isinstance(x, R.PartitionSpec))
            want = _flat(RSH.cache_pspecs(ref_config(arch), b, mesh, rst),
                         lambda x: isinstance(x, JP))
            assert [tuple(s) for s in got] == [tuple(s) for s in want], \
                (combo, shape.name)


def test_partition_spec_normalizes_like_jax():
    for axes in [(("data",), None), (("pod", "data"), "model"), (),
                 (None, None), (["data"], ("pod", "data", "model"))]:
        assert tuple(R.PartitionSpec(*axes)) == tuple(JP(*axes))


def test_to_placements_round_trip():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    cases = {
        (("pod", "data"), "model"): [Shard(0), Shard(0), Shard(1)],
        (None, ("pod", "data"), None): [Shard(1), Shard(1), Replicate()],
        ("model", None): [Replicate(), Replicate(), Shard(0)],
        (None, None): [Replicate()] * 3,
        ("data", "pod"): [Shard(1), Shard(0), Replicate()],
    }
    for axes, want in cases.items():
        spec = R.PartitionSpec(*axes)
        got = R.to_placements(spec, mesh)
        assert got == want, axes
        back = {}
        for name, pl in zip(mesh.mesh_dim_names, got):
            if pl.is_shard():
                back.setdefault(pl.dim, []).append(name)
        rebuilt = R.PartitionSpec(*[tuple(back.get(d, ())) or None
                                    for d in range(len(spec))])
        assert tuple(rebuilt) == tuple(spec)
    with pytest.raises(ValueError):       # DTensor splits in mesh order only
        R.to_placements(R.PartitionSpec(("data", "pod")), mesh)
    with pytest.raises(ValueError):       # one mesh axis, two dimensions
        R.to_placements(R.PartitionSpec("model", "model"), mesh)


# == the sharded specs, per device: one subprocess per package ===============

_PORT = r"""
import json, sys
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import mesh as ME, shapes as SH
from repro_torch.launch.dryrun import _spec_bytes_per_device
from repro_torch.launch.steps import step_and_args
from repro_torch.models import all_names, get_config
from repro_torch.sharding import rules as R
def spec_of(t, mesh):
    # a DTensor's partition spec: per dimension its mesh axes, in mesh order
    names, per_dim = list(mesh.mesh_dim_names), {}
    for i, pl in enumerate(t.placements):
        if pl.is_shard():
            per_dim.setdefault(pl.dim, []).append(names[i])
    return [None if d not in per_dim else per_dim[d][0]
            if len(per_dim[d]) == 1 else per_dim[d] for d in range(t.ndim)]
out = {"cells": {}, "offsets": {}}
ME.fake_group(512)
for multi in (False, True):
    mesh = ME.make_production_mesh(multi_pod=multi, device="cpu")
    st = R.ShardingStrategy().with_pod() if multi else R.ShardingStrategy()
    name = "pod2x16x16" if multi else "pod16x16"
    with FakeTensorMode():
        for arch in all_names():
            cfg = get_config(arch)
            for shape in SH.SHAPES:
                specs = SH.input_specs(cfg, shape, mesh, st)
                _, args = step_and_args(cfg, SH.SHAPES[shape].kind, specs)
                leaves = [[list(t.shape), str(t.dtype).split(".")[-1],
                           spec_of(t, mesh) if isinstance(t, DTensor)
                           else None]
                          for t in SH.leaves(specs)]
                out["cells"][f"{arch}|{shape}|{name}"] = {
                    "leaves": leaves,
                    "bytes": _spec_bytes_per_device(args, mesh.size())}
ME.release()
# each rank's block of a (8, 8) tensor on a (2, 2, 2) mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
axes = ("pod", "data", "model")
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=axes)
    for spec in ([["pod", "data"], "model"], [None, ["pod", "data", "model"]],
                 ["data", ["pod", "model"]]):
        p = R.to_placements(R.PartitionSpec(*spec), mesh)
        shape, off = compute_local_shape_and_global_offset((8, 8), mesh, p)
        out["offsets"][f"{json.dumps(spec)}|{list(mesh.get_coordinate())}"] = \
            [list(shape), list(off)]
    dist.destroy_process_group()
print(json.dumps(out))
"""

_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch import mesh as ME, shapes as SH
from repro.launch.dryrun import _spec_bytes_per_device
from repro.launch.steps import step_and_args
from repro.models import all_names, get_config
from repro.sharding import rules as R
out = {"cells": {}, "offsets": {}}
for multi in (False, True):
    mesh = ME.make_production_mesh(multi_pod=multi)
    st = R.ShardingStrategy().with_pod() if multi else R.ShardingStrategy()
    name = "pod2x16x16" if multi else "pod16x16"
    for arch in all_names():
        cfg = get_config(arch)
        for shape in SH.SHAPES:
            specs = SH.input_specs(cfg, shape, mesh, st)
            _, args = step_and_args(cfg, SH.SHAPES[shape].kind, specs)
            leaves = [[list(t.shape), str(t.dtype),
                       [list(a) if isinstance(a, tuple) else a
                        for a in (list(t.sharding.spec)
                                  + [None] * (len(t.shape)
                                              - len(t.sharding.spec)))]
                       if getattr(t, "sharding", None) is not None else None]
                      for t in jax.tree.leaves(specs)]
            out["cells"][f"{arch}|{shape}|{name}"] = {
                "leaves": leaves,
                "bytes": _spec_bytes_per_device(args, mesh.devices.size)}
axes = ("pod", "data", "model")
mesh = jax.make_mesh((2, 2, 2), axes, devices=jax.devices()[:8])
for spec in ([["pod", "data"], "model"], [None, ["pod", "data", "model"]],
             ["data", ["pod", "model"]]):
    sh = NamedSharding(mesh, P(*[tuple(a) if isinstance(a, list) else a
                                 for a in spec]))
    idx = sh.devices_indices_map((8, 8))
    for coord in np.ndindex(2, 2, 2):
        sl = [s.indices(8) for s in idx[mesh.devices[coord]]]
        out["offsets"][f"{json.dumps(spec)}|{list(coord)}"] = [
            [b - a for a, b, _ in sl], [a for a, _, _ in sl]]
print(json.dumps(out))
"""


def _start(code: str, **env) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(ROOT),
                            env={**os.environ,
                                 "PYTHONPATH": str(ROOT / "src"), **env})


def _axes(spec):
    """A spec with no axis anywhere, or none at all (the reference's
    unsharded position and optimizer step), as ``None``."""
    return spec if spec and any(spec) else None


@pytest.fixture(scope="module")
def sharded():
    """(the port's records, the reference's), the two built side by side."""
    procs = [_start(_PORT), _start(_REF, JAX_PLATFORMS="cpu")]
    try:
        outs = []
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    return tuple(outs)


def test_input_specs_equal_the_reference(sharded):
    """Every arch x shape x mesh: each leaf's global shape, dtype and
    partition spec."""
    port, ref = sharded
    assert sorted(port["cells"]) == sorted(ref["cells"])
    assert len(port["cells"]) == 80
    for key, cell in port["cells"].items():
        want = ref["cells"][key]["leaves"]
        assert len(cell["leaves"]) == len(want), key
        for got, exp in zip(cell["leaves"], want):
            assert got[:2] == exp[:2], key
            assert _axes(got[2]) == _axes(exp[2]), (key, got, exp)


def test_arg_bytes_per_device_byte_equal(sharded):
    port, ref = sharded
    for key, cell in port["cells"].items():
        assert cell["bytes"] == ref["cells"][key]["bytes"], key


def test_shards_split_major_to_minor_as_jax(sharded):
    """A dimension over a tuple of axes: each rank holds the block JAX
    gives the device at the same mesh coordinate."""
    port, ref = sharded
    assert port["offsets"] == ref["offsets"]
    assert len(port["offsets"]) == 24
