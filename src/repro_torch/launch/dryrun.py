"""Multi-pod dry run: run every (arch x shape x mesh) cell's step once on a
fake mesh; the port of ``repro.launch.dryrun``.

This is the proof that the distribution config is coherent: every cell's
step must run on DTensors placed by the production shardings over the 16x16
single-pod and 2x16x16 multi-pod meshes (a fake process group of 256 or
512 ranks, ``launch/mesh.py``), under ``FakeTensorMode``, so a 27B model's
train step runs with no memory.  The op analysis (``launch/op_analysis.py``)
counts the run per device.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--both] [--force]

``--device`` (default ``cuda``, raising without a card) is the device type
of the fake tensors; ``--device cpu`` runs where there is no card.  It
honours ``REPRO_KV_DTYPE`` and ``REPRO_MICROBATCH`` as the reference does.
``--cell ARCH:SHAPE:MESH`` (repeatable) names cells one by one.
:func:`run_cell`'s ``reduced`` and ``mesh_shape`` run the reduced configs on
a small fake mesh, for tests.

Artifacts: ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
(resumable).  A record has the reference's keys, with these meanings:
``run_s`` (in place of ``lower_s`` and ``compile_s``) the seconds of the one
counted run; ``chips`` the mesh's ranks; ``arg_bytes_per_device`` the
arguments' local bytes (a plain tensor, which the reference leaves
unsharded, at its bytes over the ranks, as the reference counts it);
``memory_analysis`` ``{"peak_live_bytes"}``, the peak of the bytes of live
local storages the op counter tracked (arguments included); ``hlo_cost`` the
op counter's per-device cost; ``xla_cost`` the same FLOPs and bytes under
XLA's key names (an eager run has no loop body to undercount);
``collectives`` bytes and op counts by kind; ``roofline`` the H100 terms of
``launch/op_stats.py``; ``uneven_sharding`` ``validate_divisibility``;
``hlo_bytes`` the number of local ops the run dispatched.
"""
import argparse
import dataclasses
import json
import os
import pathlib
import time
import traceback
from typing import Any, Dict, Optional, Tuple

from repro_torch.device import resolve_device
from repro_torch.launch import mesh as ME
from repro_torch.launch import op_analysis, op_stats
from repro_torch.launch.shapes import (SHAPES, cell_supported, input_specs,
                                       leaves)
from repro_torch.launch.steps import install_rules, step_and_args
from repro_torch.models import all_names, get_config
from repro_torch.models.common import clear_sharding_rules

ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")


def _attn_layer_spans(cfg, s: int):
    """[(n_layers, kv_span)]: how many layers attend over which span."""
    if cfg.family == "ssm":
        return []
    if cfg.family == "hybrid":
        return [(cfg.num_groups, s)]          # shared attn once per group
    if cfg.local_global:
        half = cfg.num_layers // 2
        return [(half, min(s, cfg.sliding_window)), (half, s)]
    return [(cfg.num_layers, s)]


def model_flops(cfg, shape) -> float:
    """Useful-work FLOPs for the cell (6ND train / 2ND prefill / 2N decode),
    plus attention score FLOPs over each layer's true kv span (sliding
    windows and hybrid shared-attention counted exactly)."""
    n_active = cfg.active_param_count()
    n_embed = cfg.vocab_size * cfg.d_model
    n_eff = n_active - (0 if cfg.tie_embeddings else n_embed)
    b, s = shape.global_batch, shape.seq_len
    h_dh = cfg.num_heads * cfg.head_dim
    if shape.kind in ("train", "prefill"):
        # causal: each query sees ~span/2 keys on average (full span) or
        # ~span keys (window smaller than the sequence)
        attn = 0.0
        for layers, span in _attn_layer_spans(cfg, s):
            avg_kv = span / 2 if span == s else span
            attn += 4.0 * layers * b * s * avg_kv * h_dh  # QK^T + PV
        if shape.kind == "train":
            return 6.0 * n_eff * b * s + 3.0 * attn
        return 2.0 * n_eff * b * s + attn
    # decode: one token per sequence reads each layer's kv span once
    attn_dec = sum(4.0 * layers * min(span, s) * h_dh * b
                   for layers, span in _attn_layer_spans(cfg, s))
    return 2.0 * n_eff * b + attn_dec


def _spec_bytes_per_device(tree, n_dev: int) -> float:
    """A DTensor's local bytes; a plain tensor's bytes over ``n_dev``."""
    from torch.distributed.tensor import DTensor
    total = 0.0
    for leaf in leaves(tree):
        if isinstance(leaf, DTensor):
            loc = leaf.to_local()
            total += loc.numel() * loc.element_size()
        else:
            total += leaf.numel() * leaf.element_size() / n_dev
    return total


def _mesh_name(multi_pod: bool, mesh_shape: Optional[Tuple[int, ...]]):
    if mesh_shape is None:
        return "pod2x16x16" if multi_pod else "pod16x16"
    return "mesh" + "x".join(str(n) for n in mesh_shape)


def _mesh_for(multi_pod: bool, mesh_shape: Optional[Tuple[int, ...]],
              device: str):
    """The production mesh, or a small fake one for tests."""
    if mesh_shape is None:
        return ME.make_production_mesh(multi_pod=multi_pod, device=device)
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    return ME.make_fake_mesh(mesh_shape, axes, device)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             outdir: pathlib.Path, force: bool = False, device: str = None,
             reduced: bool = False,
             mesh_shape: Optional[Tuple[int, ...]] = None) -> Dict[str, Any]:
    mesh_name = _mesh_name(multi_pod, mesh_shape)
    out = outdir / f"{arch}__{shape_name}__{mesh_name}.json"
    if out.exists() and not force:
        return json.loads(out.read_text())
    outdir.mkdir(parents=True, exist_ok=True)

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    kv_dt = os.environ.get("REPRO_KV_DTYPE", "")
    if kv_dt:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dt)
    shape = SHAPES[shape_name]
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    ok, why = cell_supported(cfg, shape_name)
    if not ok:
        record.update(status="skipped", reason=why)
        out.write_text(json.dumps(record, indent=1))
        return record

    t0 = time.time()
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.sharding.rules import (ShardingStrategy,
                                                validate_divisibility)
        mesh = _mesh_for(multi_pod, mesh_shape, device)
        st = ShardingStrategy()
        if "pod" in mesh.mesh_dim_names:
            st = st.with_pod()
        install_rules(cfg, mesh, st)
        mb = int(os.environ.get("REPRO_MICROBATCH", "1"))
        record["microbatches"] = mb
        chips = mesh.size()
        with FakeTensorMode(), implicit_replication():
            specs = input_specs(cfg, shape_name, mesh, st)
            fn, args = step_and_args(cfg, shape.kind, specs, microbatches=mb)
            arg_bytes = _spec_bytes_per_device(args, chips)
            t1 = time.time()
            _, counter = op_analysis.run_counted(fn, *args)
            t_run = time.time() - t1

        mcost = counter.cost()
        coll = op_stats.CollectiveStats.from_counter(counter)
        mf = model_flops(cfg, shape)
        roof = op_stats.roofline_terms(
            {"flops": mcost.flops, "bytes accessed": mcost.traffic_bytes},
            coll, chips, mf)
        record.update(
            status="ok",
            run_s=round(t_run, 1),
            chips=chips,
            arg_bytes_per_device=arg_bytes,
            memory_analysis={"peak_live_bytes": int(counter.peak_live_bytes)},
            xla_cost={"flops": mcost.flops,
                      "bytes accessed": mcost.traffic_bytes},
            hlo_cost=mcost.as_dict(),
            collectives=coll.as_dict(),
            model_flops=mf,
            roofline=roof.as_dict(),
            uneven_sharding=validate_divisibility(cfg, mesh, st),
            hlo_bytes=counter.ops,
        )
    except Exception as e:  # failures here are bugs in the system
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    finally:
        clear_sharding_rules()
    record["wall_s"] = round(time.time() - t0, 1)
    out.write_text(json.dumps(record, indent=1))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod meshes")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (default cuda; "
                         "raises without a card unless --device cpu)")
    ap.add_argument("--cell", action="append", default=[],
                    metavar="ARCH:SHAPE:MESH",
                    help="run this cell (MESH pod16x16 or pod2x16x16); "
                         "repeatable, in place of --arch/--shape/--all")
    args = ap.parse_args(argv)
    outdir = pathlib.Path(args.out)
    resolve_device(args.device)

    if args.cell:
        cells = []
        for text in args.cell:
            arch, shape, mesh = text.split(":")
            if shape not in SHAPES or mesh not in ("pod16x16", "pod2x16x16"):
                ap.error(f"--cell {text}: unknown shape or mesh")
            cells.append((arch, shape, mesh == "pod2x16x16"))
    else:
        archs = all_names() if (args.all or not args.arch) else [args.arch]
        shapes = list(SHAPES) if (args.all or not args.shape) \
            else [args.shape]
        meshes = [False, True] if args.both else [args.multi_pod]
        cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    ME.fake_group(512 if any(mp for _, _, mp in cells) else 256)

    n_ok = n_skip = n_err = 0
    for arch, shape, mp in cells:
        rec = run_cell(arch, shape, mp, outdir, force=args.force,
                       device=args.device)
        tag = rec["status"]
        n_ok += tag == "ok"
        n_skip += tag == "skipped"
        n_err += tag == "error"
        extra = ""
        if tag == "ok":
            r = rec["roofline"]
            extra = (f"dom={r['dominant']} "
                     f"roofline={r['roofline_frac']:.3f} "
                     f"run={rec['run_s']}s")
        elif tag == "error":
            extra = rec["error"][:120]
        print(f"[{tag:7s}] {arch:22s} {shape:12s} "
              f"{rec['mesh']:10s} {extra}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    ME.release()
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
