"""Binding of the hand-written CUDA streaming kernels (``csrc/stream.cu``),
which replace the Pallas TPU kernels of ``repro.stream.kernels``
(``window_minmax`` and ``join_bounds``).

The wrappers take CUDA tensors only and raise on anything else; the CPU
path is ``ref.py``, chosen by ``ops.py`` from the tensor's device.  Each
wrapper allocates its outputs (and the min/max scan's scratch), launches
on PyTorch's current stream without synchronising, raises if the launch
reports an error, and adds one to its launch count.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "stream.cu",)
# rows and keys are int-indexed in the kernels
MAX_INT = 2**31 - 1

# launches of each kernel in this process (chip_smoke.py zeroes and reads
# them around the main path)
window_minmax_launches = 0
join_bounds_launches = 0
_COUNT_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    lib = _build.load_library("stream", SOURCES)
    if not hasattr(lib, "_repro_typed"):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_window_minmax_chunk.argtypes = []
        lib.repro_window_minmax_chunk.restype = i32
        lib.repro_window_minmax_rows.argtypes = [
            ptr, ptr, ptr, ctypes.c_longlong, i32, i32, i32, ptr]
        lib.repro_window_minmax_rows.restype = i32
        lib.repro_join_bounds_rows.argtypes = [
            ptr, ptr, ctypes.c_double, i32, i32, i32, ptr, ptr, ptr]
        lib.repro_join_bounds_rows.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return {"window_minmax": window_minmax_launches,
                "join_bounds": join_bounds_launches}


def reset_launch_counts() -> None:
    global window_minmax_launches, join_bounds_launches
    with _COUNT_LOCK:
        window_minmax_launches = join_bounds_launches = 0


def _check(t: torch.Tensor, what: str, dim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float64:
        raise TypeError(f"{what} must be float64, got {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dim}-d tensor, got "
                         f"shape {tuple(t.shape)}")
    if not 0 < t.numel() <= MAX_INT:
        raise ValueError(f"{what} must hold 1 to {MAX_INT} values, got "
                         f"{t.numel()}")


def _launched(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    if err:
        raise RuntimeError(f"stream {kernel} launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")


def _stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def window_minmax_2d(windows: torch.Tensor, is_max: bool) -> torch.Tensor:
    """windows: (W, size) f64 on the card -> (W,) f64 per-row min or
    max."""
    global window_minmax_launches
    _check(windows, "windows", 2)
    w, size = windows.shape
    lib = load()
    chunks = -(-size // lib.repro_window_minmax_chunk())
    out = torch.empty((w,), dtype=torch.float64, device=windows.device)
    scratch = (torch.empty((w * chunks,), dtype=torch.float64,
                           device=windows.device) if chunks > 1 else out)
    with torch.cuda.device(windows.device):
        err = lib.repro_window_minmax_rows(
            windows.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), w, size, int(bool(is_max)),
            _stream_of(windows))
    _launched(lib, err, "window_minmax")
    with _COUNT_LOCK:
        window_minmax_launches += 1
    return out


def join_bounds_1d(lt: torch.Tensor, rs: torch.Tensor, tol: float,
                   steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """lt: (nl,) f64, rs: (nr,) f64 sorted, on the card -> int32 (lo,
    hi) of ``[lt - tol, lt + tol]`` in ``rs``, each bisection ``steps``
    iterations long."""
    global join_bounds_launches
    _check(lt, "lt", 1)
    _check(rs, "rs", 1)
    if rs.device != lt.device:
        raise ValueError("lt and rs must be on one device")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    lib = load()
    lo = torch.empty(lt.shape, dtype=torch.int32, device=lt.device)
    hi = torch.empty(lt.shape, dtype=torch.int32, device=lt.device)
    with torch.cuda.device(lt.device):
        err = lib.repro_join_bounds_rows(
            lt.data_ptr(), rs.data_ptr(), float(tol), lt.numel(),
            rs.numel(), int(steps), lo.data_ptr(), hi.data_ptr(),
            _stream_of(lt))
    _launched(lib, err, "join_bounds")
    with _COUNT_LOCK:
        join_bounds_launches += 1
    return lo, hi
