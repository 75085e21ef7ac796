"""Per-device op-level cost analysis; the twin of ``repro.launch.hlo_analysis``.

The reference parses post-SPMD HLO text; the port counts the ops PyTorch
runs, under a ``TorchDispatchMode`` (:class:`OpCounter`), with the
reference's conventions:

  * FLOPs come from the dot ops only: ``mm``, ``addmm``, ``bmm``,
    ``baddbmm`` and the convolutions (forward and backward), at 2 x result
    elements x contracted size (``torch.utils.flop_counter``'s formulas);
  * HBM traffic counts each op's operands + result.  Eager ops are kernel
    boundaries, as XLA's fusion boundaries are, so an elementwise chain
    counts every link.  Views and metadata ops count nothing (``view``,
    ``expand``, ``transpose``, ``permute``, ``slice``, ``select``,
    ``as_strided``, ``unsqueeze``, ``_unsafe_view``, ``prim.device``, the
    ``empty`` allocations), as ``bitcast`` does; an in-place write into a
    slice (``copy_``, ``index_put_``, ``index_copy_``, ``index_add_``) counts
    the slice read and written, not the buffer, as ``dynamic-update-slice``;
    a gather or index read counts twice the result plus the index operands, as
    ``dynamic-slice``;
  * collective bytes take max(operands, result) per op (a ring-transfer
    proxy) under the reference's kind names: ``_c10d_functional``'s
    ``all_reduce`` / ``all_gather_into_tensor`` / ``reduce_scatter_tensor``
    / ``all_to_all_single`` and their ``c10d`` forms; ``wait_tensor``
    counts nothing;
  * trip counts: eager Python loops unroll, so a loop over layers counts
    each layer as it runs; there is no loop body to multiply.

On a mesh the mode counts per device.  A mode entered outside DTensor
receives each DTensor op with global shapes and no collectives, so it
defers on DTensor arguments (returns ``NotImplemented``): DTensor then runs
the device's local ops and the collectives of its redistributions, and the
mode counts those.  DTensor's sharding propagation also runs each op once
on the *global* fake shapes to learn the output's metadata; that run is
excluded (``_propagate_tensor_meta_non_cached`` is wrapped while the mode is
active).  The mode also keeps the peak of the bytes held by live storages
(the arguments registered by :func:`analyze`, every op's outputs), the
port's stand-in for XLA's memory analysis.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# (namespace, op name) -> collective kind, the reference's kind names
_COLLECTIVES = {
    **{("_c10d_functional", n): "all-reduce"
       for n in ("all_reduce", "all_reduce_", "all_reduce_coalesced",
                 "all_reduce_coalesced_")},
    **{("_c10d_functional", n): "all-gather"
       for n in ("all_gather_into_tensor", "all_gather_into_tensor_out",
                 "all_gather_into_tensor_coalesced")},
    **{("_c10d_functional", n): "reduce-scatter"
       for n in ("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced")},
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    ("c10d", "recv_"): "collective-permute",
}

_DOT_OPS = {"mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
            "convolution_backward"}

# no traffic: allocation, metadata, aliasing that is not an aten view
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "_unsafe_view", "lift_fresh",
               "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
               "sym_storage_offset", "is_same_size", "device",
               "wait_tensor", "_has_compatible_shallow_copy_type",
               "record_stream"}

# in-place writes into a slice through index operands: (index of the
# update, index of the index operands); ``copy_`` into a view counts the
# view written and the source read
_SLICE_WRITES = {"index_put_": (2, 1), "index_copy_": (3, 2),
                 "index_add_": (3, 2), "_index_put_impl_": (2, 1)}

# reads of a slice: index of the index operands
_SLICE_READS = {"index": 1, "gather": 2, "index_select": 2, "embedding": 1,
                "take_along_dim": 1}


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


@dataclasses.dataclass
class ModuleCost:
    flops: float
    traffic_bytes: float
    collective_bytes: Dict[str, float]

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self):
        return {"flops": self.flops, "traffic_bytes": self.traffic_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "total_collective_bytes": self.total_collective_bytes}


class OpCounter(TorchDispatchMode):
    """Counts the local ops that run under it (see the module docstring):
    ``flops``, ``traffic_bytes``, ``collective_bytes`` / ``collective_count``
    by kind, ``peak_live_bytes``, ``ops`` (local ops dispatched) and
    ``op_counts`` (the same ops by name: the aten op's name, other
    namespaces' as ``ns::name``; the counterpart of the reference's
    ``hlo_stats.count_op``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.traffic_bytes = 0.0
        self.collective_bytes: Dict[str, float] = {}
        self.collective_count: Dict[str, int] = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.ops = 0
        self.op_counts: Dict[str, int] = {}
        self._refs: Dict[int, List[int]] = {}   # storage -> [refs, bytes]
        self._suppress = 0
        self._patched = None

    # -- DTensor's propagation run ------------------------------------------

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def propagate(*args, **kwargs):
            counter._suppress += 1
            try:
                return orig(*args, **kwargs)
            finally:
                counter._suppress -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._patched = (ShardingPropagator, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._patched
        cls._propagate_tensor_meta_non_cached = orig
        return super().__exit__(*exc)

    # -- live storages -------------------------------------------------------

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until the last tracked tensor on it
        is freed."""
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = st._cdata
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [0, st.nbytes()]
            self.live_bytes += ref[1]
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        ref[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live_bytes -= ref[1]
            del self._refs[key]

    # -- counting ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._suppress:
            self.ops += 1
            key = (func._opname if func.namespace == "aten"
                   else f"{func.namespace}::{func._opname}")
            self.op_counts[key] = self.op_counts.get(key, 0) + 1
            self._count(func, args, kwargs, out)
            for t in _tensors(out):
                self.track(t)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns, name = func.namespace, func._opname
        kind = _COLLECTIVES.get((ns, name))
        if kind is not None:
            moved = max([_nbytes(out)] + [_nbytes(a) for a in args])
            self.collective_bytes[kind] = (self.collective_bytes.get(kind, 0.0)
                                           + moved)
            self.collective_count[kind] = self.collective_count.get(kind, 0) + 1
            self.traffic_bytes += _nbytes(args) + _nbytes(out)
            return
        if name in _DOT_OPS and ns == "aten":
            from torch.utils.flop_counter import flop_registry
            self.flops += float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        if func.is_view or name in _NO_TRAFFIC:
            return
        if name == "copy_":
            self.traffic_bytes += _nbytes(args[0]) + _nbytes(args[1])
            return
        if name in _SLICE_WRITES:
            upd, idx = _SLICE_WRITES[name]
            self.traffic_bytes += 2 * (_nbytes(args[upd]) + _nbytes(args[idx]))
            return
        if name in _SLICE_READS:
            idx = _SLICE_READS[name]
            self.traffic_bytes += 2 * _nbytes(out) + _nbytes(args[idx])
            return
        self.traffic_bytes += (_nbytes(args) + _nbytes(list(kwargs.values()))
                               + _nbytes(out))

    def slice_reads(self) -> int:
        """The index reads counted: the gathers and indexings of
        ``_SLICE_READS``, the ops XLA lowers to ``gather`` /
        ``dynamic-slice``."""
        return sum(self.op_counts.get(name, 0) for name in _SLICE_READS)

    def cost(self) -> ModuleCost:
        return ModuleCost(flops=self.flops, traffic_bytes=self.traffic_bytes,
                          collective_bytes=dict(self.collective_bytes))


def _arg_tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _arg_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _arg_tensors(v)


def analyze(fn, *args, **kwargs) -> ModuleCost:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` and
    return its per-device cost."""
    return run_counted(fn, *args, **kwargs)[1].cost()


def run_counted(fn, *args, **kwargs):
    """(``fn``'s result, the :class:`OpCounter` that counted its run; the
    arguments' storages count as live from the start)."""
    counter = OpCounter()
    for t in _arg_tensors((args, kwargs)):
        counter.track(t)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter
