"""Fault-tolerant checkpointing: atomic, async, device-agnostic; the port of
``repro.checkpoint.manager``, writing the reference's files.

Layout:  <dir>/step_{k:08d}/{manifest.json, arrays.npz}
A checkpoint is valid iff its manifest exists and carries a matching
``complete: true`` marker: the manifest is written LAST, after arrays are
flushed, and the step directory is renamed from a temp name, so a host
dying mid-save can never corrupt the latest checkpoint.

Keys follow the reference's flattening: dict keys joined by ``/`` in
sorted order, a ``NamedTuple`` field as jax's attribute key prints it
(``.step``), a list or tuple item by its index; a train state writes
``opt/.step``, ``opt/.m/<path>``, ``opt/.v/<path>`` and ``params/<path>``.
A bfloat16 leaf is stored as the reference stores it: its raw bits under
the npy type ``'<V2'``, with ``bfloat16`` in the manifest.

Every tensor is copied to host memory before :meth:`CheckpointManager.save`
returns, so an asynchronous write never sees a later step's values, even
of a state the optimizer updates in place.

Restore is *elastic*: each array is placed on the device and in the dtype
of the matching tensor of ``like``, so a checkpoint saved from ``cuda``
restores on the CPU and the reverse.  A ``'<V2'`` array (a bfloat16 leaf)
does not restore, as in the reference, whose numpy cannot cast the void
type back (``ROADMAP.md`` C.19): :meth:`restore` raises ``ValueError``.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import pathlib
import shutil
import time
import zipfile
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch
from numpy.lib import format as npy_format

BF16_DESCR = "<V2"          # the npy type ml_dtypes' bfloat16 writes


def _items(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _items(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _items(x, path + (str(i),))
    else:
        yield "/".join(path), tree


def _flatten(tree: Any) -> List[Tuple[str, Any]]:
    """[(key, leaf)] in the reference's order and with its key names."""
    return list(_items(tree))


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves taken from ``leaves`` in
    :func:`_flatten`'s order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _to_host(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(a host copy the caller owns, the manifest's dtype name)."""
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_DESCR), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _savez(path: pathlib.Path, items: List[Tuple[str, np.ndarray, str]]) -> None:
    """``np.savez``'s archive (stored members ``<key>.npy``), with a
    bfloat16 leaf's header naming ``'<V2'`` as the reference's does."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr, _ in items:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                header = npy_format.header_data_from_array_1_0(arr)
                if arr.dtype.kind == "V":
                    header["descr"] = BF16_DESCR
                npy_format.write_array_header_1_0(f, header)
                f.write(memoryview(np.ascontiguousarray(arr).reshape(-1)
                                   .view(np.uint8)))


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_save else None)
        self._pending: Optional[concurrent.futures.Future] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        host = [(k, *_to_host(v)) for k, v in _flatten(state)]
        if self._pool is None or blocking:
            self._write(step, host)
        else:
            self.wait()
            self._pending = self._pool.submit(self._write, step, host)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, items: List[Tuple[str, np.ndarray, str]]) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        _savez(tmp / "arrays.npz", items)
        manifest = {
            "step": step, "complete": True, "time": time.time(),
            "keys": [k for k, _, _ in items],
            "shapes": {k: list(v.shape) for k, v, _ in items},
            "dtypes": {k: d for k, _, d in items},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                       # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in sorted(self.dir.glob("step_*")):
            man = p / "manifest.json"
            if not man.exists():
                continue
            try:
                if json.loads(man.read_text()).get("complete"):
                    out.append(int(p.name.split("_")[1]))
            except (json.JSONDecodeError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore into the structure of ``like``, each leaf on the device
        and in the dtype of ``like``'s tensor there.  Raises
        ``ValueError`` for a bfloat16 leaf saved as ``'<V2'`` (C.19)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        leaves = []
        with np.load(path / "arrays.npz") as data:
            for key, proto in _flatten(like):
                arr = data[key]
                if arr.dtype.kind == "V":
                    raise ValueError(
                        f"{key}: No cast function available from the void "
                        f"type {arr.dtype.str!r} to {proto.dtype} (a "
                        f"bfloat16 leaf; ROADMAP.md C.19)")
                leaves.append(torch.from_numpy(arr).to(proto.device, proto.dtype))
        return _unflatten(like, iter(leaves)), step
