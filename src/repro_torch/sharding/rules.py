"""Logical-axis sharding rules and parameter partition specs; the port of
``repro.sharding.rules``.

Model code annotates activations with logical axes (``common.constrain``);
parameters get partition specs from path-based rules here.  The default
strategy is FSDP(+pod) x TP: tensor-parallel over ``model``, parameters and
optimizer state additionally sharded over the data axes (ZeRO-3).

Expert ("bank") dimensions shard over ``model``: the device index is the
bank index.

A spec is the port's own :class:`PartitionSpec`, a tuple of per-dimension
mesh axes (``None``, an axis name, or a tuple of names), so it compares with
the reference's by ``tuple(spec)``.  :func:`sanitize_spec` and
:func:`validate_divisibility` read only the mesh's axis names and shape
(:func:`axis_sizes`), so they run on a ``DeviceMesh`` and on any object with
``axis_names`` and ``devices.shape``, as the reference's do.
:func:`to_placements` turns a spec into DTensor placements over a
``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from ..models import params as MP
from ..models.config import ModelConfig


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``None``, a name, or a tuple of names.  A
    one-name tuple becomes the name, as JAX's ``PartitionSpec`` keeps it."""

    def __new__(cls, *axes):
        def norm(ax):
            if isinstance(ax, (tuple, list)):
                return ax[0] if len(ax) == 1 else tuple(ax)
            return ax
        return super().__new__(cls, tuple(norm(a) for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingStrategy:
    name: str = "fsdp_tp"
    tp: str = "model"
    fsdp: Tuple[str, ...] = ("data",)         # ZeRO-3 param axes
    batch: Tuple[str, ...] = ("data",)
    shard_params_fsdp: bool = True

    def with_pod(self) -> "ShardingStrategy":
        return dataclasses.replace(self, fsdp=("pod",) + self.fsdp,
                                   batch=("pod",) + self.batch)


def logical_rules(strategy: ShardingStrategy, *,
                  shard_heads: bool = False) -> Dict[str, Any]:
    """Activation logical-axis -> mesh axes."""
    return {
        "batch": strategy.batch,
        "seq": None,
        "embed": None,
        "heads": strategy.tp if shard_heads else None,
        "kv_heads": strategy.tp if shard_heads else None,
        "mlp": strategy.tp,
        "vocab": strategy.tp,
        "experts": strategy.tp,      # banks over the model axis
        "capacity": strategy.batch,
    }


# path-suffix -> spec builder; evaluated against the unstacked leaf
_COL = {"wq", "wk", "wv", "wi", "wg", "in_proj", "lm_head", "router",
        "wr", "mix_A", "wlora_A"}
_ROW = {"wo", "out_proj", "wlora_B"}
_TP_VEC = {"bq", "bk", "bv", "conv_b", "A_log", "D", "dt_bias"}


def _base_spec(path: Tuple[str, ...], shape: tuple,
               st: ShardingStrategy) -> P:
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    fsdp = tuple(st.fsdp) if st.shard_params_fsdp else None
    fa = fsdp if fsdp else None

    if name == "embed":
        return P(st.tp, fa)
    if parent == "moe":
        if name in ("w1", "wg"):
            return P(st.tp, fa, None)
        if name == "w2":
            return P(st.tp, None, fa)
        if name == "router":
            return P(fa, None)
    if parent == "cm" and name == "wv":      # rwkv channel-mix down proj
        return P(st.tp, fa)
    if parent == "cm" and name == "wk":
        return P(fa, st.tp)
    if name in _COL and len(shape) == 2:
        return P(fa, st.tp)
    if name in _ROW and len(shape) == 2:
        return P(st.tp, fa)
    if name == "conv_w":
        return P(None, st.tp)
    if name in _TP_VEC and len(shape) == 1:
        return P(st.tp)
    if name == "u":
        return P(st.tp, None)
    if name == "mix_B":
        return P(None, None, fa)
    # norms, gates, mu, gn_*: replicate
    return P(*([None] * len(shape)))


def _n_stack_dims(path: Tuple[str, ...]) -> int:
    n = 0
    if "blocks" in path or "encoder" in path:
        n += 1
    if any(k in path for k in ("self", "mamba")):
        n += 1
    return n


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size: a ``DeviceMesh``'s ``mesh_dim_names`` and
    ``shape``, else ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axes(ax) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)


def shard_count(ax, sizes: Dict[str, int]) -> int:
    """Shards of one spec entry: the product of its axes' sizes."""
    out = 1
    for a in _axes(ax):
        out *= sizes[a]
    return out


def sanitize_spec(spec: P, shape: tuple, mesh) -> P:
    """Drop spec axes whose shard count does not divide the dimension
    (input shardings must tile evenly; e.g. whisper vocab 51866 over 16)."""
    if mesh is None:
        return spec
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = [ax if (ax is None or dim % shard_count(ax, sizes) == 0) else None
           for dim, ax in zip(shape, entries)]
    return P(*out)


def _walk_leaves(tree, path=()):
    """(path, leaf) over a shape tree, keys sorted at every level (the
    order ``jax.tree.leaves`` walks a dict)."""
    if MP._is_leaf(tree):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _walk_leaves(tree[k], path + (k,))


def param_pspecs(cfg: ModelConfig, strategy: ShardingStrategy,
                 mesh=None) -> Any:
    """Spec tree matching ``param_shapes(cfg)``.  With ``mesh``, specs are
    sanitized to evenly-dividing axes."""
    shapes = MP.param_shapes(cfg)

    def walk(tree, path):
        if MP._is_leaf(tree):
            n_lead = _n_stack_dims(path)
            inner_shape = tree[0][n_lead:]
            base = _base_spec(path, inner_shape, strategy)
            spec = P(*([None] * n_lead + list(base)))
            return sanitize_spec(spec, tree[0], mesh)
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(shapes, ())


def to_placements(spec: P, mesh) -> List[Any]:
    """DTensor placements of ``spec`` over a ``DeviceMesh``: per mesh
    dimension ``Shard(d)`` for the tensor dimension ``d`` it shards, else
    ``Replicate()``.  A dimension sharded over a tuple of axes is split
    major to minor in the tuple's order, as JAX splits it; DTensor splits a
    dimension over its mesh dimensions in mesh order, so the tuple must list
    its axes in mesh order (raises otherwise)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        idx = [names.index(a) for a in _axes(ax)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax!r} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions in {spec!r}")
            out[i] = Shard(d)
    return out


def param_shardings(cfg: ModelConfig, mesh,
                    strategy: ShardingStrategy) -> Any:
    """Placement lists per leaf, the tree of ``param_pspecs``."""
    def walk(tree):
        if isinstance(tree, PartitionSpec):
            return to_placements(tree, mesh)
        return {k: walk(v) for k, v in tree.items()}

    return walk(param_pspecs(cfg, strategy, mesh=mesh))


def validate_divisibility(cfg: ModelConfig, mesh,
                          strategy: ShardingStrategy) -> Dict[str, int]:
    """Report leaves whose sharded dims don't divide (GSPMD pads these;
    DTensor shards them unevenly; surfaced for the roofline notes)."""
    sizes = axis_sizes(mesh)
    uneven = {}
    shapes = [lf for _, lf in _walk_leaves(MP.param_shapes(cfg))]
    flat_specs = _flat_specs(param_pspecs(cfg, strategy))
    for lf, spec in zip(shapes, flat_specs):
        for dim, ax in zip(lf[0], tuple(spec)):
            n = shard_count(ax, sizes)
            if n > 1 and dim % n:
                uneven[f"{lf[0]}@{ax}"] = dim
    return uneven


def _flat_specs(tree) -> List[P]:
    if isinstance(tree, PartitionSpec):
        return [tree]
    return [s for k in sorted(tree) for s in _flat_specs(tree[k])]
