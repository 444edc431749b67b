"""Build, load and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface and loaded with
``ctypes``.  A library is built at first use, or up front for all sources
at once with :func:`build` (one ``nvcc`` process per source, all started
together).  Libraries land in ``build/repro_torch/`` at the repository
root, named after a digest of their sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

A :class:`CudaKernel` binds one C entry point: it launches on the
tensors' device and PyTorch's current stream, raises when the launch
reports a CUDA error, and counts its launches.

Nothing here runs at import time, and nothing falls back: a missing
``nvcc``, a failed compile or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "CudaKernel", "build",
           "check", "load", "nvcc"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("batched_decode", "coded_accumulate", "fused_decode_apply")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}; have {SOURCES}")
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet.

    Starts one ``nvcc`` per source, waits for all of them, and returns the
    seconds each took (0.0 for a library that was already there).  The
    compiler's ``-Xptxas -v`` report goes to ``<library>.log``.
    """
    names = SOURCES if names is None else tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    seconds = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            seconds[name] = 0.0
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, lib, tmp, time.perf_counter())
    failed = []
    for name, (proc, lib, tmp, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)              # atomic: readers never see a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int64}


class CudaKernel:
    """One ``extern "C"`` launcher of a built library.

    ``signature`` spells its arguments before the trailing stream: ``p``
    for a device pointer (``tensor.data_ptr()``), ``i`` for a 64-bit size.
    ``launches`` counts the kernel launches made through this object.
    """

    def __init__(self, source: str, symbol: str, signature: str):
        self.source = source
        self.symbol = symbol
        self.signature = signature
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args: int) -> None:
        if device.type != "cuda":
            raise ValueError(f"{self.symbol} is a CUDA kernel; its tensors "
                             f"are on {device}")
        if len(args) != len(self.signature):
            raise TypeError(f"{self.symbol} takes {len(self.signature)} "
                            f"arguments, got {len(args)}")
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = [_CTYPES[c] for c in self.signature] \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: kernel launch failed with "
                               f"cudaError {rc}")
        self.launches += 1


def check(x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` -- what a kernel's raw pointer arithmetic assumes."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
