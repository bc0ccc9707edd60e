"""Binding of the two hand-written CUDA flash-attention kernels, which
replace the Pallas TPU kernel of
``repro.kernels.flash_attention.flash_attention`` (``_flash_kernel``):

- ``csrc/flash_attention_sm90.cu``, the tensor-core route: bf16 inputs
  with head dim 64 or 128 (every served configuration), both products on
  ``wgmma`` over TMA-fed tiles, P rounded to bf16 for P.V;
- ``csrc/flash_attention.cu``, the CUDA-core route: float32 inputs, and
  head dims 16 and 32, all math in float32 (the 2e-5 that float32 is held
  to does not survive a bf16 P).

``route`` picks one from the dtype and the head dim alone, before any
launch.  The wrapper takes CUDA tensors only and raises on anything else;
the CPU path is ``ref.py``, chosen by ``ops.py`` from the tensor's
device.  It allocates the output, launches on PyTorch's current stream
without synchronising, raises if the launch reports an error, and adds
one to its launch count and to its route's.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "flash_attention.cu",)
SM90_SOURCES = (_CSRC / "flash_attention_sm90.cu",)
HEAD_DIMS = (16, 32, 64, 128)           # the CUDA-core kernel's instances
TC_HEAD_DIMS = (64, 128)                # the tensor-core kernel's
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID = 65535                        # grid y and z: heads / batch
TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"

# launches in this process, in all and by route (chip_smoke.py zeroes and
# reads them around the main path)
launches = 0
tensor_core_launches = 0
cuda_core_launches = 0
_COUNT_LOCK = threading.Lock()


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes inputs of ``dtype`` and ``head_dim``:
    ``TENSOR_CORE`` for bf16 at head dim 64 or 128, else ``CUDA_CORE``."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return TENSOR_CORE
    return CUDA_CORE


def load() -> ctypes.CDLL:
    """Build (at first use) and load the CUDA-core kernel's library."""
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


def load_sm90() -> ctypes.CDLL:
    """Build (at first use) and load the tensor-core kernel's library."""
    lib = _build.load_library("flash_attention_sm90", SM90_SOURCES)
    if not hasattr(lib, "_repro_typed"):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_flash_attention_sm90.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
            ctypes.c_float, i32, ptr]
        lib.repro_flash_attention_sm90.restype = i32
        lib.repro_sm90_error_string.argtypes = [i32]
        lib.repro_sm90_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def reset_launch_count() -> None:
    global launches, tensor_core_launches, cuda_core_launches
    with _COUNT_LOCK:
        launches = tensor_core_launches = cuda_core_launches = 0


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
    global launches, tensor_core_launches, cuda_core_launches
    _check(q, k, v)
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    scale = float(np.float32(dh ** -0.5))
    which = route(q.dtype, dh)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if which == TENSOR_CORE:
            # TMA reads from 16-byte aligned addresses only
            if any(x.data_ptr() % 16 for x in (q, k, v)):
                raise ValueError("q, k and v must start 16-byte aligned")
            lib = load_sm90()
            err = lib.repro_flash_attention_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, t, hq, hkv, dh, scale, int(bool(causal)), stream)
            what = lib.repro_sm90_error_string
        else:
            lib = load()
            err = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, t, hq, hkv, dh, scale,
                int(q.dtype == torch.bfloat16), int(bool(causal)), stream)
            what = lib.repro_cuda_error_string
    if err:
        raise RuntimeError(f"flash_attention ({which}) launch failed: "
                           f"{what(err).decode()}")
    with _COUNT_LOCK:
        launches += 1
        if which == TENSOR_CORE:
            tensor_core_launches += 1
        else:
            cuda_core_launches += 1
    return out
