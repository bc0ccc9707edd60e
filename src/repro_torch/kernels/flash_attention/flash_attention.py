"""Binding of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), which replaces the Pallas TPU kernel of
``repro.kernels.flash_attention.flash_attention`` (``_flash_kernel``).

The wrapper takes CUDA tensors only and raises on anything else; the CPU
path is ``ref.py``, chosen by ``ops.py`` from the tensor's device.  It
allocates the output, launches on PyTorch's current stream without
synchronising, raises if the launch reports an error, and adds one to its
launch count.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
HEAD_DIMS = (16, 32, 64, 128)           # the kernel's template instances
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID = 65535                        # grid y (q heads) and z (batch)

# launches in this process (chip_smoke.py zeroes and reads it around the
# main path)
launches = 0
_COUNT_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = _build.load_library("flash_attention", SOURCES)
    if not hasattr(lib, "_repro_typed"):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_flash_attention.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
            ctypes.c_float, i32, i32, ptr]
        lib.repro_flash_attention.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def reset_launch_count() -> None:
    global launches
    with _COUNT_LOCK:
        launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != q.device:
            raise ValueError("q, k and v must be on one device")
        if x.dtype not in DTYPES or x.dtype != q.dtype:
            raise TypeError(f"q, k and v must share one dtype of {DTYPES}, "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d tensor, got "
                             f"shape {tuple(x.shape)}, strides {x.stride()}")
        if x.numel() == 0 or x.numel() >= 2**31:
            raise ValueError(f"{name} must hold 1 to 2**31 - 1 values, got "
                             f"{x.numel()}")
    b, _, hq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k and v must be (B, T, Hkv, Dh) of q's B and Dh: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if hq % k.shape[2] or hq > MAX_GRID or b > MAX_GRID:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads "
                         f"({k.shape[2]}), both heads and batch at most "
                         f"{MAX_GRID}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} is not one of {HEAD_DIMS}")


def flash_attention_4d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool) -> torch.Tensor:
    """q: (B,S,Hq,Dh), k and v: (B,T,Hkv,Dh) on the card -> (B,S,Hq,Dh)."""
    global launches
    _check(q, k, v)
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    lib = load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, hq, hkv, dh, float(np.float32(dh ** -0.5)),
            int(q.dtype == torch.bfloat16), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    with _COUNT_LOCK:
        launches += 1
    return out
