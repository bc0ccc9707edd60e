"""Build the port's CUDA sources with ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

A library is built at first use, from the sources in the repository only,
into ``build/repro_torch/`` at the root of the checkout (see
``_build_dir`` for an installed package), under a name keyed by a hash
of its sources and flags, so an edited source is rebuilt and an
unchanged one is reused.  Each library has its own lock, so two first
calls of one library (the Executor runs casts on a thread pool) build it
once, while two libraries may build at the same time.
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
from typing import Dict, Sequence

import torch


def _build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR`` if set; else ``build/repro_torch/`` at
    the root of the checkout this file lies in (``src/repro_torch/``);
    else, for an installed package, a per-user cache directory."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    pkg = Path(__file__).resolve().parents[1]
    if pkg.parent.name == "src":
        return pkg.parents[1] / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()                 # guards _LIBS and _KEY_LOCKS
_LIBS: Dict[str, ctypes.CDLL] = {}
_KEY_LOCKS: Dict[str, threading.Lock] = {}
# nvcc's stderr of each build made in this process (ptxas register and
# spill report), by library name
BUILD_LOGS: Dict[str, str] = {}


class BuildError(RuntimeError):
    pass


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise BuildError("nvcc not found: the CUDA kernels need the CUDA "
                         "toolkit (set CUDA_HOME)")
    return path


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """Where the build of library ``name`` from ``sources`` lies."""
    return BUILD_DIR / f"{name}-{_digest([Path(s) for s in sources])}.so"


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """The ``ctypes`` handle of library ``name`` built from ``sources``,
    building it first if no build of these exact sources exists."""
    target = library_path(name, sources)
    key = target.stem
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is not None:
            return lib
        key_lock = _KEY_LOCKS.setdefault(key, threading.Lock())
    with key_lock:
        with _LOCK:
            lib = _LIBS.get(key)
        if lib is not None:
            return lib
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                     *[str(s) for s in sources]],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise BuildError(f"nvcc failed building {name} "
                                     f"(exit {proc.returncode}):\n"
                                     f"{proc.stderr}")
                BUILD_LOGS[name] = proc.stderr
                os.replace(tmp, target)      # atomic across processes
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(target))
        with _LOCK:
            _LIBS[key] = lib
        return lib


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad: a kernel
    called through ``ctypes`` has no backward pass, and the tensor it
    returns would carry no graph, so a loss through it would train its
    inputs' producers on silently wrong (missing) gradients."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward pass: its CUDA kernel does not "
            f"take inputs that require grad (train with "
            f"attn_impl='reference', or call it under torch.no_grad())")
