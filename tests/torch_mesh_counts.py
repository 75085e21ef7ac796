"""The op counter on fake meshes, in a process of its own (a process has one
default group): ``python tests/torch_mesh_counts.py DEVICE`` prints one JSON
object of counts; :func:`counts` runs it and :func:`check_product` /
:func:`check_sum` hold the counts exactly.  ``test_torch_op_analysis.py``
runs it with ``cpu`` tensors, ``test_torch_card.py`` with fake ``cuda``
tensors under the card's torch."""
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def counts(device: str) -> dict:
    r = subprocess.run([sys.executable, __file__, device], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT),
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def check_product(out: dict) -> None:
    """On a 16x16 fake mesh a product sharded over both axes counts
    2·M·N·K / 256 per device; DTensor's run of the op on the global shapes
    (to propagate its metadata) is not counted, the first time or after."""
    for key in ("product0", "product1"):
        flops, coll = out[key]
        assert flops == 2 * 4096 ** 3 / 256
        # the a-operand's model shards gathered: 256 x 256 f32 in, 4096 x
        # 256 out
        assert coll == {"all-gather": 4096 * 256 * 4}


def check_sum(out: dict) -> None:
    """A sum over an axis sharded on 8 ranks moves one row per device."""
    coll, flops = out["sum"]
    assert coll == {"all-reduce": 4096 * 4}
    assert flops == 0


def main(device: str) -> None:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch import mesh as ME
    from repro_torch.launch import op_analysis as OA
    out = {"torch": torch.__version__}
    mesh = ME.make_production_mesh(device=device)
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(4096, 4096), mesh,
                              [Shard(0), Shard(1)])
        b = distribute_tensor(torch.empty(4096, 4096), mesh,
                              [Replicate(), Shard(1)])
        for i in range(2):         # the second run hits DTensor's caches
            c = OA.run_counted(lambda x, y: x @ y, a, b)[1]
            out[f"product{i}"] = [c.flops, c.collective_bytes]
    mesh = ME.make_fake_mesh((8,), ("d",), device=device)
    x = distribute_tensor(torch.ones(8, 4096, device=device), mesh, [Shard(0)])
    cost = OA.analyze(lambda x: x.sum(0).redistribute(mesh, [Replicate()]), x)
    out["sum"] = [cost.collective_bytes, cost.flops]
    ME.release()
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
