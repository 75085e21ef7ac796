"""Build the port's CUDA sources at first use and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C functions.  ``nvcc`` compiles it for
``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the repository
root; the hash covers the sources and the flags, so an edited source builds
anew.  ``build`` starts one ``nvcc`` per source, all together, and waits for
them.  A failed build raises: nothing falls back.  ``function`` binds one
exported function with its C types; ``launch`` calls a kernel's function on
the current stream of its tensors' card and raises on the CUDA error it
returns.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple, Union

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# Extra -D defines for every source, from the environment: ``PHASE_CLOCKS``
# compiles in the kernels' per-phase clock64() counts (csrc/phase_clocks.cuh,
# scripts/torch_phase_clocks.py).  They are part of the flags, so such a
# build gets libraries of its own.
DEFINES = tuple(f"-D{d}" for d in os.environ.get("REPRO_TORCH_CUDA_DEFINES", "").split())
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v") + DEFINES

log: Dict[str, str] = {}   # nvcc's output (ptxas register/smem report) per source
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA "
                       "toolkit (put nvcc on PATH or set CUDA_HOME)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> float:
    """Build every named source not built yet, all at once; return seconds."""
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        log[name] = stdout + stderr
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    if name not in _libs:
        build([name])
        _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return _libs[name]


def function(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """``symbol`` of ``csrc/<name>.cu``'s library with its C types (pointers
    and the stream as ``c_void_p``), building the library if needed."""
    if (name, symbol) not in _fns:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        _fns[name, symbol] = fn
    return _fns[name, symbol]


# The current stream's handle of a device: torch's raw getter returns it as
# an int, where ``current_stream().cuda_stream`` first builds a Stream
# object, a cost paid on every launch; the public call stands in where a
# torch build lacks the getter.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(fn, device: torch.device, *args,
           what: Union[str, Callable[[], str]]) -> None:
    """Call ``fn(*args, stream)`` on the current stream of ``device`` (made
    the current device for the call if it is not); raise ``RuntimeError``
    if it returns a CUDA error, as a refused launch does.  ``what`` names the
    call in that error (a callable is called only then)."""
    current = torch.cuda.current_device()
    if device.index in (None, current):
        rc = fn(*args, _stream(current))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, _stream(device.index))
    if rc != 0:
        raise RuntimeError(f"{what() if callable(what) else what} launch failed: "
                           f"CUDA error {rc}")
