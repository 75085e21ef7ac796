"""The microbatched train step on a mesh (ROADMAP.md C.23).

``launch.steps.make_train_step(..., microbatches=m)`` splits the batch into
the reference's ``m`` contiguous row blocks (``split_rows``).  On DTensors
sharded over the data axes a reshape to ``(m, -1, ...)`` is refused
(``m`` does not divide over the data shards), so the split moves the rows
through the last dimension's shards and places each microbatch as the
batch is placed.

* On a real mesh of two gloo ranks, (data 2, model 1), the microbatched
  step on DTensors gives the plain-tensor microbatched step's loss,
  gradient norm, moments and update, at ``tests/test_torch_trainer.py``'s
  tolerances (loss ``LOSS_RTOL`` = 1e-6, ``GRAD_TOL`` = 2e-3 of a leaf's
  largest magnitude, a parameter within twice the rate); every microbatch
  is sharded on its rows over the data axis.
* On fake 2x2 and 2x2x2 meshes, reduced configs, ``train_4k`` with
  ``REPRO_MICROBATCH`` 2 and 4 ends ``ok`` through the dry run, counts the
  same dot FLOPs a device as one microbatch (within 1%) and holds fewer
  live bytes at its peak.

The full-size cell (qwen2-0.5b ``train_4k`` on 16x16 at 4 microbatches)
is held in ``tests/test_torch_dryrun_report.py`` on the committed sweep
and live by ``chip_smoke.py``.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
ENV.pop("REPRO_MICROBATCH", None)
GRAD_TOL = 2e-3                  # tests/test_torch_trainer.py
LOSS_RTOL = 1e-6
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=8, weight_decay=0.01)
ARCH, SEQ, ROWS = "qwen2-0.5b", 32, 8
FLOPS_RTOL = 0.01

_RANK = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps as S
from repro_torch.models import get_config, params as P
from repro_torch.models.common import clear_sharding_rules
from repro_torch.optim import adamw as A
from repro_torch.sharding.rules import (PartitionSpec as PS, ShardingStrategy,
                                        param_pspecs, to_placements)
rank, store, arch, seq, rows, m, opt, out = sys.argv[1:]
rank, seq, rows, m = int(rank), int(seq), int(rows), int(m)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
try:
    cfg = get_config(arch).reduced()
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    st = ShardingStrategy()
    S.install_rules(cfg, mesh, st)
    specs = param_pspecs(cfg, st, mesh=mesh)

    def place(tree, spec, fn):
        if isinstance(tree, dict):
            return {k: place(tree[k], spec[k], fn) for k in tree}
        return distribute_tensor(fn(tree), mesh, to_placements(spec, mesh))

    tree = P.params_from_numpy(P.init_numpy_params(cfg, seed=0), "cpu",
                               torch.float32)
    params = place(tree, specs, lambda t: t)
    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32)
    state = {"params": params,
             "opt": A.OptState(step=torch.zeros((), dtype=torch.int32),
                               m=place(tree, specs, zeros),
                               v=place(tree, specs, zeros))}
    raw = SyntheticLM(DataConfig(cfg.vocab_size, seq, rows)).batch(0)
    batch = {k: distribute_tensor(torch.as_tensor(v), mesh,
                                  to_placements(PS(st.batch, None), mesh))
             for k, v in raw.items()}
    split = S.split_rows(batch["tokens"], m)
    placed = all(isinstance(p, DTensor) and p.placements == batch["tokens"].placements
                 and p.to_local().shape[0] == rows // m // 2 for p in split)
    with implicit_replication():
        new, metrics = S.make_train_step(cfg, A.AdamWConfig(**json.loads(opt)),
                                         m)(state, batch)
    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    leaves = {f"{part}{i}": full(t).numpy() for part, tree in
              (("p", new["params"]), ("m", new["opt"].m), ("v", new["opt"].v))
              for i, t in enumerate(A.leaves(tree))}
    scalars = {k: float(full(v)) for k, v in metrics.items()}
    scalars["placed"] = placed
    scalars["microbatch"] = [full(p).numpy().tolist() for p in split]
    if rank == 0:
        np.savez(out, **leaves)
        print(json.dumps(scalars))
finally:
    clear_sharding_rules()
    dist.destroy_process_group()
"""


def _plain_step(m):
    cfg = get_config(ARCH).reduced()
    tree = P.init_numpy_params(cfg, seed=0)
    state = {"params": P.params_from_numpy(tree, "cpu", torch.float32)}
    state["opt"] = A.init_state(state["params"])
    raw = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, ROWS)).batch(0)
    new, metrics = S.make_train_step(cfg, A.AdamWConfig(**OPT), m)(
        state, {k: torch.as_tensor(v) for k, v in raw.items()})
    return raw, new, metrics


@pytest.mark.parametrize("m", [1, 2, 4])
def test_dtensor_microbatches_match_the_plain_step_on_two_ranks(m, tmp_path):
    out = tmp_path / "rank0.npz"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"), ARCH,
         str(SEQ), str(ROWS), str(m), json.dumps(OPT), str(out)], env=ENV,
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    leaves = dict(np.load(out))
    raw, new, metrics = _plain_step(m)
    # the reference's rows, each microbatch sharded on its rows as the batch
    assert got.pop("placed") is True
    want_rows = raw["tokens"].reshape((m, -1, SEQ))
    assert np.array_equal(np.asarray(got.pop("microbatch")), want_rows)
    assert set(got) == set(metrics)
    assert got["loss"] == pytest.approx(float(metrics["loss"]), rel=LOSS_RTOL)
    assert got["grad_norm"] == pytest.approx(float(metrics["grad_norm"]),
                                             rel=GRAD_TOL)
    assert got["lr"] == float(metrics["lr"])
    for part, tree in (("m", new["opt"].m), ("v", new["opt"].v)):
        for i, want in enumerate(A.leaves(tree)):
            want = want.numpy()
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(leaves[f"{part}{i}"], want, rtol=0,
                                       atol=GRAD_TOL * scale)
    bound = 2 * float(metrics["lr"])
    for i, want in enumerate(A.leaves(new["params"])):
        assert float(np.abs(leaves[f"p{i}"] - want.numpy()).max()) <= bound


_CELLS = r"""
import json, os, pathlib, sys
from repro_torch.launch import dryrun, mesh as ME, shapes
from repro_torch.launch.shapes import ShapeSpec
arch, seq, rows, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
ME.fake_group(8)
shapes.SHAPES["train_4k"] = ShapeSpec("train_4k", seq, rows, "train")
out = {}
for mesh in ((2, 2), (2, 2, 2)):
    data_shards = mesh[0] * (mesh[1] if len(mesh) == 3 else 1)
    for m in (1, 2, 4):
        if rows // m < data_shards:
            continue
        os.environ["REPRO_MICROBATCH"] = str(m)
        rec = dryrun.run_cell(arch, "train_4k", False,
                              pathlib.Path(outdir) / str(m), force=True,
                              device="cpu", reduced=True, mesh_shape=mesh)
        out[f"{rec['mesh']}|{m}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_mesh_records(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("mb")
    r = subprocess.run(
        [sys.executable, "-c", _CELLS, ARCH, "64", str(ROWS), str(outdir)],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT), env=ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh,m", [("mesh2x2", 2), ("mesh2x2", 4),
                                    ("mesh2x2x2", 2)])
def test_microbatched_cell_runs_on_a_fake_mesh(fake_mesh_records, mesh, m):
    one = fake_mesh_records[f"{mesh}|1"]
    rec = fake_mesh_records[f"{mesh}|{m}"]
    assert one["status"] == "ok", one.get("traceback")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["microbatches"] == m and one["microbatches"] == 1
    assert rec["hlo_cost"]["flops"] == pytest.approx(
        one["hlo_cost"]["flops"], rel=FLOPS_RTOL)
    assert rec["memory_analysis"]["peak_live_bytes"] < \
        one["memory_analysis"]["peak_live_bytes"]
    assert rec["model_flops"] == one["model_flops"]
