"""Cells of the dry run's whole sweep that ended ``error`` before their
repair, at shapes shrunk in place on small fake meshes (in a subprocess: a
process has one fake group).  Each cell below ended ``error`` before its
repair, with the fault named; the production cells are in the sweep
(``EXPERIMENTS_torch.md``).

* ROADMAP.md C.24, rwkv6-7b ``prefill_32k`` and ``train_4k``: a product's
  partial sum resolved by DTensor in the next pointwise op with a scatter
  over the sequence, which the next product could not flatten
  (``Sharding propagation failed for aten.mm`` / ``aten.bmm``).  The
  registered config at 2x2 (``train_4k``) and 2x2x2 (``prefill_32k``), the
  reduced one at 4x4.
* ROADMAP.md C.25, llama-3.2-vision-11b ``decode_32k``: the cross
  attention's query split into kv groups while its heads were sharded over
  more ranks than there are kv heads (``Cannot unflatten unevenly sharded
  tensor``).  The registered config at 2x16: 8 kv heads under 16 model
  ranks, as on the production mesh.

The GPU machine's torch (2.11) failed seven more cells that pass under
torch 2.13 on the CPU: zamba2-7b ``prefill_32k`` and ``train_4k`` on both
meshes (the Mamba conv's pad of a DTensor, C.24), rwkv6-7b ``long_500k``
on 16x16 (a partial sum into the decode step's channel mix, C.24: it now
takes ``channel_mix``'s layouts) and whisper-large-v3 and
granite-moe-1b-a400m ``train_4k`` on 16x16 (a tied table's two gradients
placed apart, C.27).  The first and the last are held here as the layouts
that avoid them.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
ENV.pop("REPRO_MICROBATCH", None)
TINY = {"train_4k": (64, 8), "prefill_32k": (128, 4), "decode_32k": (64, 8)}
# (arch, shape, mesh, reduced)
CELLS = [("rwkv6-7b", "train_4k", "2x2", False),
         ("rwkv6-7b", "prefill_32k", "2x2x2", False),
         ("rwkv6-7b", "prefill_32k", "4x4", True),
         ("llama-3.2-vision-11b", "decode_32k", "2x16", False)]

_CELLS = r"""
import json, pathlib, sys
from repro_torch.launch import dryrun, mesh as ME, shapes
from repro_torch.launch.shapes import ShapeSpec
tiny, cells, outdir = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
ME.fake_group(32)
for name, (seq, batch) in tiny.items():
    shapes.SHAPES[name] = ShapeSpec(name, seq, batch, shapes.SHAPES[name].kind)
out = {}
for arch, shape, mesh, reduced in cells:
    rec = dryrun.run_cell(arch, shape, False, pathlib.Path(outdir), force=True,
                          device="cpu", reduced=reduced,
                          mesh_shape=tuple(int(n) for n in mesh.split("x")))
    out[f"{arch}|{shape}|{mesh}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    r = subprocess.run(
        [sys.executable, "-c", _CELLS, json.dumps(TINY), json.dumps(CELLS),
         str(tmp_path_factory.mktemp("faults"))], capture_output=True,
        text=True, timeout=900, cwd=str(ROOT), env=ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(map(str, c)))
def test_cell_that_failed_the_sweep_runs(records, cell):
    arch, shape, mesh, _ = cell
    rec = records[f"{arch}|{shape}|{mesh}"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["hlo_cost"]["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0


# -- faults the card's torch showed, held as the layouts that avoid them -------

_LAYOUTS = r"""
import json, pathlib, sys, torch
from repro_torch.launch import dryrun, mesh as ME, shapes
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import common as CM, mamba as M, transformer as TF
outdir = pathlib.Path(sys.argv[1])
ME.fake_group(256)
seen = {"conv": [], "lookup": [], "head": []}     # "conv": every pad's input

def placements(t):
    return [str(p) for p in getattr(t, "placements", ())]

class Probe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, name):
        ctx.name = name
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        seen[ctx.name].append(placements(grad))
        return grad, None

pad, embed, head = torch.nn.functional.pad, CM._embed_replicated, CM.lm_logits
torch.nn.functional.pad = lambda x, *a, **k: (
    seen["conv"].append(placements(x)), pad(x, *a, **k))[1]
CM._embed_replicated = lambda tokens, table: embed(
    tokens, Probe.apply(table, "lookup"))
TF.lm_logits = lambda cfg, params, x: head(
    cfg, {**params, "embed": Probe.apply(params["embed"], "head")}, x)
status = {}
for arch, shape, seq, batch in (("zamba2-7b", "prefill_32k", 256, 32),
                                ("granite-moe-1b-a400m", "train_4k", 64, 256)):
    shapes.SHAPES[shape] = ShapeSpec(shape, seq, batch, shapes.SHAPES[shape].kind)
    rec = dryrun.run_cell(arch, shape, False, outdir, force=True, device="cpu")
    status[arch] = rec["status"]
print(json.dumps({"status": status, **seen}))
"""


def test_layouts_the_card_torch_needs(tmp_path):
    """On the production 16x16 mesh (shapes shrunk in place): the Mamba
    conv pads local tensors only (C.24: the card's torch 2.11 cannot pad a
    DTensor), and a tied table's gradients from the lookup and the head
    arrive placed alike (C.27: 2.11 cannot turn the lookup's shards into
    the head's partial sum to add them)."""
    r = subprocess.run([sys.executable, "-c", _LAYOUTS, str(tmp_path)],
                       capture_output=True, text=True, timeout=900,
                       cwd=str(ROOT), env=ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["status"] == {"zamba2-7b": "ok", "granite-moe-1b-a400m": "ok"}
    assert got["conv"] and all(p == [] for p in got["conv"]), got["conv"]
    assert len(got["lookup"]) == len(got["head"]) == 1
    assert got["lookup"] == got["head"]
