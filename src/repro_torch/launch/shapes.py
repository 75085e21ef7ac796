"""The assigned input-shape set, per-cell input specs, and skip logic; the
port of ``repro.launch.shapes``.

Four canonical shapes per architecture (40 cells):
  train_4k    : seq 4096,   global_batch 256   -> train_step
  prefill_32k : seq 32768,  global_batch 32    -> prefill (forward)
  decode_32k  : cache 32768, global_batch 128  -> serve_step
  long_500k   : cache 524288, global_batch 1   -> serve_step (SSM/hybrid only)

``long_500k`` is skipped for pure full-attention architectures: quadratic
attention at 512k would misrepresent them.

The reference's builders return ``jax.ShapeDtypeStruct``s carrying a
``NamedSharding``; the port's return fake DTensors on the mesh, with the
same global shape, dtype and partition spec.  A leaf the reference leaves
without a sharding (the decode
position, the optimizer's step) is a plain 0-d tensor.  The builders make
fake tensors only: they raise unless a ``FakeTensorMode`` is active, so a
27B model's state costs no memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..models import decode
from ..models import params as MP
from ..models.config import ModelConfig
from ..sharding.rules import (PartitionSpec as P, ShardingStrategy,
                              axis_sizes, param_pspecs, sanitize_spec,
                              shard_count, to_placements)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention architecture: 512k decode is "
                       "quadratic; skipped per assignment (DESIGN.md §4)")
    return True, ""


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _sharded(mesh, shape: tuple, dtype: torch.dtype, spec: P):
    """A fake DTensor of global ``shape`` placed as ``spec`` says: this
    rank's shard, wrapped (nothing is scattered)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    if detect_fake_mode() is None:
        raise RuntimeError("the sharded input specs are fake tensors: build "
                           "them under a FakeTensorMode")
    placements = to_placements(spec, mesh)
    with unset_fake_temporarily():      # it computes offsets with tensors
        local, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                         placements)
    t = torch.empty(local, dtype=dtype, device=mesh.device_type)
    stride, n = [], 1
    for d in reversed(shape):          # contiguous, as the global tensor
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _plain(mesh, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """A leaf the reference gives no sharding: a plain fake tensor."""
    from torch._guards import detect_fake_mode
    if detect_fake_mode() is None:
        raise RuntimeError("the input specs are fake tensors: build them "
                           "under a FakeTensorMode")
    return torch.zeros(shape, dtype=dtype, device=mesh.device_type)


def _modality_spec(cfg: ModelConfig, batch: int, mesh,
                   st: ShardingStrategy):
    dt = _dtype(cfg)
    if cfg.family == "vlm":
        return _sharded(mesh, (batch, cfg.num_patches, cfg.d_model), dt,
                        P(st.batch, None, None))
    if cfg.family == "audio":
        return _sharded(mesh, (batch, cfg.encoder_seq, cfg.d_model), dt,
                        P(st.batch, None, None))
    return None


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                st: ShardingStrategy) -> Dict[str, Any]:
    """Training/prefill batch (tokens + optional modality)."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {
        "tokens": _sharded(mesh, (b, s), torch.int32, P(st.batch, None)),
    }
    mod = _modality_spec(cfg, b, mesh, st)
    if mod is not None:
        specs["modality"] = mod
    return specs


def _cache_axis_for(cfg: ModelConfig, mesh, st: ShardingStrategy,
                    batch: int):
    """(batch_axes, head_axis): shard heads over TP only when divisible;
    tiny-batch cells (long_500k) rely on head sharding."""
    sizes = axis_sizes(mesh)
    tp = sizes.get(st.tp, 1)
    head_ok = cfg.num_kv_heads % tp == 0 and cfg.num_kv_heads >= tp
    baxes = st.batch if batch >= shard_count(st.batch, sizes) else None
    return baxes, (st.tp if head_ok else None)


def cache_pspecs(cfg: ModelConfig, batch: int, mesh,
                 st: ShardingStrategy) -> Any:
    """Partition specs for the decode cache tree (path-keyed)."""
    baxes, hax = _cache_axis_for(cfg, mesh, st, batch)
    shapes = decode.cache_shapes(cfg, batch, 8)   # structure only

    def spec_for(path: Tuple[str, ...], shape: tuple) -> P:
        name = path[-1]
        stacked_inner = (("self" in path and cfg.family == "vlm")
                         or ("mamba" in path and cfg.family == "hybrid"))
        n_lead = 1 + (1 if stacked_inner else 0)
        lead = [None] * n_lead
        if name in ("k", "v", "k_scale", "v_scale"):
            return P(*lead, baxes, hax, None, None)
        if name == "h":                     # mamba state (…,B,nh,st,hd)
            return P(*lead, baxes, hax, None, None)
        if name == "conv":                  # (…,B,K-1,CH)
            return P(*lead, baxes, None, st.tp)
        if name == "wkv":                   # (…,B,H,dk,dv)
            return P(*lead, baxes, hax, None, None)
        if name.startswith("shift"):        # (…,B,1,D)
            return P(*lead, baxes, None, None)
        raise KeyError(path)

    def walk(tree, path=()):
        if isinstance(tree, tuple):
            return spec_for(path, tree)
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(shapes)


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def cache_specs_sharded(cfg: ModelConfig, shape: ShapeSpec, mesh,
                        st: ShardingStrategy) -> Any:
    specs = decode.cache_specs(cfg, shape.global_batch, shape.seq_len)
    pspecs = cache_pspecs(cfg, shape.global_batch, mesh, st)
    return _zip_map(
        lambda sd, p: _sharded(mesh, sd.shape, sd.dtype,
                               sanitize_spec(p, sd.shape, mesh)),
        specs, pspecs)


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                       st: ShardingStrategy) -> Dict[str, Any]:
    b = shape.global_batch
    baxes, _ = _cache_axis_for(cfg, mesh, st, b)
    return {
        "tokens": _sharded(mesh, (b, 1), torch.int32, P(baxes, None)),
        "pos": _plain(mesh, (), torch.int32),
        "cache": cache_specs_sharded(cfg, shape, mesh, st),
    }


def _param_tree(cfg: ModelConfig, mesh, st: ShardingStrategy,
                dtype: torch.dtype) -> Any:
    shapes = MP.param_shapes(cfg)
    pspecs = param_pspecs(cfg, st, mesh=mesh)

    def walk(lf, spec):
        if MP._is_leaf(lf):
            return _sharded(mesh, lf[0], dtype, spec)
        return {k: walk(lf[k], spec[k]) for k in lf}

    return walk(shapes, pspecs)


def param_specs_sharded(cfg: ModelConfig, mesh,
                        st: ShardingStrategy) -> Any:
    return _param_tree(cfg, mesh, st, _dtype(cfg))


def opt_state_specs_sharded(cfg: ModelConfig, mesh,
                            st: ShardingStrategy) -> Any:
    """AdamW m/v mirror params (fp32) + scalar step."""
    from ..optim.adamw import OptState
    return OptState(step=_plain(mesh, (), torch.int32),
                    m=_param_tree(cfg, mesh, st, torch.float32),
                    v=_param_tree(cfg, mesh, st, torch.float32))


def input_specs(cfg: ModelConfig, shape_name: str, mesh,
                st: ShardingStrategy) -> Dict[str, Any]:
    """Everything the step function needs, as fake (D)Tensors."""
    shape = SHAPES[shape_name]
    params = param_specs_sharded(cfg, mesh, st)
    if shape.kind == "train":
        return {"state": {"params": params,
                          "opt": opt_state_specs_sharded(cfg, mesh, st)},
                "batch": batch_specs(cfg, shape, mesh, st)}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch_specs(cfg, shape, mesh, st)}
    return {"params": params, **decode_input_specs(cfg, shape, mesh, st)}


def leaves(tree) -> list:
    """The tensors of a spec tree, keys sorted at every level (the order
    ``jax.tree.leaves`` walks a dict; an ``OptState`` in field order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]
