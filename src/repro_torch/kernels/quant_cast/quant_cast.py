"""Binding of the hand-written CUDA quant_cast kernels
(``csrc/quant_cast.cu``), which replace the Pallas TPU kernels of
``repro.kernels.quant_cast.quant_cast``.

The wrappers take CUDA tensors only and raise on anything else; the CPU
path is ``ref.py``, chosen by ``ops.py`` from the tensor's device.  Each
wrapper allocates its outputs, launches on PyTorch's current stream
without synchronising, raises if the launch reports an error, and adds
one to its launch count.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

ROWS = 8          # rows per padded tile (ops.py pads to ROWS x BLOCK)
BLOCK = 128       # values per row == quant block
SOURCES = (Path(__file__).resolve().parent / "csrc" / "quant_cast.cu",)

# launches of each kernel in this process (chip_smoke.py zeroes and reads
# them around the main path)
quantize_launches = 0
dequantize_launches = 0
_COUNT_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    lib = _build.load_library("quant_cast", SOURCES)
    if not hasattr(lib, "_repro_typed"):
        ptr = ctypes.c_void_p
        lib.repro_quantize_rows.argtypes = [ptr, ptr, ptr,
                                            ctypes.c_longlong, ptr]
        lib.repro_quantize_rows.restype = ctypes.c_int
        lib.repro_dequantize_rows.argtypes = [ptr, ptr, ptr,
                                              ctypes.c_longlong, ptr]
        lib.repro_dequantize_rows.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return {"quantize": quantize_launches,
                "dequantize": dequantize_launches}


def reset_launch_counts() -> None:
    global quantize_launches, dequantize_launches
    with _COUNT_LOCK:
        quantize_launches = dequantize_launches = 0


def _check(t: torch.Tensor, what: str, dtype: torch.dtype,
           shape: Tuple[int, ...], align: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{what} must be contiguous and {align}-byte "
                         f"aligned")


def _launched(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    if err:
        raise RuntimeError(f"quant_cast {kernel} launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")


def quantize_2d(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d: (nb, BLOCK) f32 on the card -> (q int8 (nb, BLOCK),
    scale f32 (nb, 1))."""
    global quantize_launches
    nb = x2d.shape[0] if x2d.dim() == 2 else -1
    _check(x2d, "x2d", torch.float32, (nb, BLOCK), 16)
    if nb == 0:
        raise ValueError("x2d has no rows")
    lib = load()
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x2d.device)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.repro_quantize_rows(x2d.data_ptr(), q.data_ptr(),
                                      scale.data_ptr(), nb, stream)
    _launched(lib, err, "quantize")
    with _COUNT_LOCK:
        quantize_launches += 1
    return q, scale


def dequantize_2d(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q: (nb, BLOCK) int8, scale: (nb, 1) f32 on the card ->
    (nb, BLOCK) f32."""
    global dequantize_launches
    nb = q.shape[0] if q.dim() == 2 else -1
    _check(q, "q", torch.int8, (nb, BLOCK), 4)
    _check(scale, "scale", torch.float32, (nb, 1), 4)
    if scale.device != q.device:
        raise ValueError("q and scale must be on one device")
    if nb == 0:
        raise ValueError("q has no rows")
    lib = load()
    x2d = torch.empty((nb, BLOCK), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_dequantize_rows(q.data_ptr(), scale.data_ptr(),
                                        x2d.data_ptr(), nb, stream)
    _launched(lib, err, "dequantize")
    with _COUNT_LOCK:
        dequantize_launches += 1
    return x2d
