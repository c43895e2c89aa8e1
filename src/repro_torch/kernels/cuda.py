"""Build, load and count the hand-written CUDA kernels.

Each `src/repro_torch/csrc/<name>.cu` is compiled by nvcc into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ctypes and called with raw device pointers and
PyTorch's current stream.  Libraries are built at first use into
`<checkout>/build/repro_torch/`, named by a hash of their source and the
shared headers (`csrc/*.cuh`) so an edited source is rebuilt; `build_all()` compiles every source in parallel,
one nvcc process each.

Every C entry point returns `cudaGetLastError()` right after its launch;
`check()` raises on anything but cudaSuccess.  There is no fallback: a
missing nvcc, a failed build or a failed launch is an error.

`LAUNCHES` counts kernel launches by name.  A wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels the
serving path went through (`reset_launches()` before, `launches()` after).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "nvcc on the machine with the card")
    return path


def _lib_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every library's key
    src = b"".join(f.read_bytes() for f in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for csrc/<name>.cu unless its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    proc.tmp, proc.out, proc.log = tmp, out, log
    return proc


def _finish_build(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    rc = proc.wait()
    proc.log.close()
    if rc != 0:
        os.unlink(proc.tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {rc}):\n"
                           + proc.out.with_suffix(".log").read_text())
    os.replace(proc.tmp, proc.out)


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources in parallel; returns each library's
    ptxas report (registers, shared memory, spills)."""
    names = list(names)
    with _LOCK:
        procs = {n: _start_build(n) for n in names}
        for n, p in procs.items():
            _finish_build(n, p)
    return {n: _lib_path(n).with_suffix(".log").read_text()
            if _lib_path(n).with_suffix(".log").exists() else ""
            for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
                lib.repro_error_string.argtypes = [ctypes.c_int]
                lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def function(lib: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point `symbol` of csrc/<lib>.cu with its argument types
    declared (every pointer and the stream as c_void_p); returns int."""
    key = (lib, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(library(lib), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return fn


def check(lib: str, rc: int, what: str) -> None:
    """Raise unless a C entry point returned cudaSuccess."""
    if rc != 0:
        msg = library(lib).repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape=None, device: Optional[torch.device] = None) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def device_of(t: torch.Tensor) -> str:
    """'cpu' or 'cuda' — the dispatch key of the kernel wrappers.  Any other
    device is refused rather than sent down either path."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type
