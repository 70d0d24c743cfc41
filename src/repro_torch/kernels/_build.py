"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, never at import, into ``build/kernels/`` at the
root of the checkout; a library's file name carries a hash of its sources
and flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per missing library, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("similarity", "ivf_scan", "ivf_scan_q", "flash_attention", "rmsnorm",
           "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_count_lock = threading.Lock()


class KernelError(Exception):
    """A kernel that could not be built or launched.

    Deliberately not a ``RuntimeError``: the engine's scheduler re-queues a
    request on ``RuntimeError`` (the reference's fault path for a failed
    worker) and in the end returns an empty generation for it, which would
    hide a broken kernel behind a run that exits 0."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise KernelError("nvcc not found: the CUDA toolkit is needed to "
                          "build repro_torch's kernels")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build() -> float:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all started together.  Raises ``KernelError`` with the
    compiler's output if one fails.  -> wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        log = so.with_suffix(".log")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, so, log))
    failed = []
    for name, proc, tmp, so, log in jobs:
        if proc.wait() != 0:
            failed.append(f"{name}:\n{log.read_text()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)        # atomic: a reader never sees half a file
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building every kernel
    library first if this one is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = library_path(name)
            if not so.exists():
                build()
            lib = _libs[name] = ctypes.CDLL(str(so))
        return lib


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """``symbol`` of the library for ``csrc/<name>.cu``, typed: every
    pointer and the stream are ``c_void_p`` (a plain int would be cut to 32
    bits), and every entry point returns its CUDA error code.  Typed once;
    later calls return the same object."""
    f = _functions.get((name, symbol))
    if f is None:
        f = getattr(load(name), symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _functions[(name, symbol)] = f
    return f


def check(rc: int, name: str, what: str) -> None:
    """Raise ``KernelError`` on a CUDA error code returned by a kernel's C
    entry point."""
    if rc != 0:
        msg = function(name, "repro_cuda_error_string", [ctypes.c_int])
        msg.restype = ctypes.c_char_p
        raise KernelError(f"{what}: CUDA error {rc} ({msg(rc).decode()})")


def require(t, what: str, dtype, ndim: int, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (one dtype
    or a tuple of the accepted ones) and rank ``ndim`` (on ``device`` when
    given): what the kernels take."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise ValueError(f"{what} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must have rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def count_launch(namespace: dict) -> None:
    """Add one to a kernel module's ``launches`` (``namespace`` is its
    ``globals()``), under one lock: the plan executor calls the ops entries
    from several fragment threads at once, and a bare ``launches += 1`` can
    lose a count between its read and its write."""
    with _count_lock:
        namespace["launches"] += 1


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
