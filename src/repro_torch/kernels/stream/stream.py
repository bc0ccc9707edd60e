"""Binding of the hand-written CUDA streaming kernels (``csrc/stream.cu``),
which replace the Pallas TPU kernels of ``repro.stream.kernels``:
``window_minmax`` (``_minmax_kernel``) and ``join_bounds``
(``_bounds_kernel``).

Both are one launch a call, and both are bounded by the latency of
device memory rather than its rate at the main path's sizes (a one-hour
row of 3.6 MB, a one-minute row of 60 KB, 450,000 join keys a side):

- ``window_minmax`` has every thread issue all of its loads before its
  first compare, and sizes the grid so that the whole row is requested
  at once (``minmax_geometry``).  A row that fits one block's share is
  one block with no scratch; a longer row's blocks write partials, and
  the last of them to arrive (an arrival counter a row, ``atomicInc``
  wrapping it back to 0) folds them in the same launch.
- ``join_bounds`` narrows each block's search to the slice of the right
  keys its left keys can reach (a 32-way warp search), stages a short
  slice in shared memory and bisects it there, a wide one in device
  memory, every thread's chains interleaved (``join_geometry``).

The launch geometry lives here, so the CPU tests reach it; the kernel
checks it.  The arrival counters must be zero when a launch starts and
must not be shared by two launches that can overlap: ``_arrivals`` holds
one zeroed buffer per (device, stream), which every launch leaves zeroed
and launches on one stream do not overlap; under CUDA graph capture it
allocates a buffer for that capture (zeroed by a node of the graph),
since the graph may be replayed on any stream, and CUDA runs no two
launches of one graph at once.

The wrappers take CUDA tensors only and raise on anything else; the CPU
path is ``ref.py``, chosen by ``ops.py`` from the tensor's device.  Each
wrapper allocates its outputs and scratch, launches on PyTorch's current
stream without synchronising, raises if the launch reports an error,
and adds one to its launch count.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "stream.cu",)
# rows and keys are int-indexed in the kernels
MAX_INT = 2**31 - 1

# window_minmax: double2 loads a thread issues at once (the library's
# kMinmaxLoads), threads of a row that is one block's, threads of each
# block of a longer row
MINMAX_LOADS = 8
MINMAX_ROW_THREADS = 512
MINMAX_SPLIT_THREADS = 256
# join_bounds: threads a block (the kernel's kJoinThreads) and left keys
# a thread (its kJoinKeys); the right keys a block stages in shared
# memory are the kernel's kJoinBudget (repro_join_bounds_budget)
JOIN_THREADS = 256
JOIN_KEYS = 4

# launches of each kernel in this process (chip_smoke.py zeroes and reads
# them around the main path)
window_minmax_launches = 0
join_bounds_launches = 0
_COUNT_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class MinmaxGeometry:
    """One window_minmax launch: ``chunks`` blocks of ``threads`` threads
    a row, each over ``chunk`` values; ``scratch`` partials and
    ``counters`` arrival counters (0 and 0 when a row is one block)."""
    threads: int
    chunk: int
    chunks: int
    scratch: int
    counters: int


def minmax_geometry(w: int, size: int,
                    loads: int = MINMAX_LOADS) -> MinmaxGeometry:
    """A row of up to ``2 * loads * MINMAX_ROW_THREADS`` values is one
    block's, with as many threads (a multiple of 32) as its loads need; a
    longer row is split into blocks of ``2 * loads *
    MINMAX_SPLIT_THREADS`` values; either way a thread's ``loads``
    double2 loads cover its share."""
    if w < 1 or size < 1:
        raise ValueError(f"window_minmax needs w, size >= 1, got "
                         f"{(w, size)}")
    if size <= 2 * loads * MINMAX_ROW_THREADS:
        threads = max(32, -(-size // (2 * loads * 32)) * 32)
        return MinmaxGeometry(threads, size, 1, 0, 0)
    chunk = 2 * loads * MINMAX_SPLIT_THREADS
    chunks = -(-size // chunk)
    return MinmaxGeometry(MINMAX_SPLIT_THREADS, chunk, chunks, w * chunks,
                          w)


@dataclasses.dataclass(frozen=True)
class JoinGeometry:
    """One join_bounds launch: ``blocks`` blocks of ``threads`` threads,
    each over ``block`` left keys (``keys`` a thread)."""
    threads: int
    keys: int
    block: int
    blocks: int


def join_geometry(nl: int, keys: int = JOIN_KEYS) -> JoinGeometry:
    """``JOIN_THREADS * keys`` left keys a block."""
    if nl < 1:
        raise ValueError(f"join_bounds needs nl >= 1, got {nl}")
    block = JOIN_THREADS * keys
    return JoinGeometry(JOIN_THREADS, keys, block, -(-nl // block))


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    lib = _build.load_library("stream", SOURCES)
    if not hasattr(lib, "_repro_typed"):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_window_minmax_loads.argtypes = []
        lib.repro_window_minmax_loads.restype = i32
        lib.repro_join_bounds_keys.argtypes = []
        lib.repro_join_bounds_keys.restype = i32
        lib.repro_join_bounds_budget.argtypes = []
        lib.repro_join_bounds_budget.restype = i32
        lib.repro_window_minmax_rows.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
        lib.repro_window_minmax_rows.restype = i32
        lib.repro_join_bounds_rows.argtypes = [
            ptr, ptr, ctypes.c_double, i32, i32, i32, i32, i32, ptr, ptr,
            ptr]
        lib.repro_join_bounds_rows.restype = i32
        lib.repro_capture_id.argtypes = [ptr]
        lib.repro_capture_id.restype = ctypes.c_ulonglong
        lib.repro_empty_launch.argtypes = [ptr]
        lib.repro_empty_launch.restype = i32
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


# arrival counters by (device index, stream, capture id or 0)
_ARRIVALS: Dict[Tuple[int, int, int], torch.Tensor] = {}
_ARRIVALS_LOCK = threading.Lock()


def _arrivals(lib: ctypes.CDLL, device: torch.device, stream: int,
              n: int) -> torch.Tensor:
    """At least ``n`` zeroed arrival counters for a launch on ``stream``:
    the stream's own, or, while the stream is being captured, the
    capture's own (the counters of captures that have ended are let go:
    their graphs keep the memory, as they keep any other of theirs)."""
    capture = lib.repro_capture_id(stream)
    key = (device.index, stream, capture)
    with _ARRIVALS_LOCK:
        for old in [k for k in _ARRIVALS
                    if k[2] and lib.repro_capture_id(k[1]) != k[2]]:
            del _ARRIVALS[old]
        buf = _ARRIVALS.get(key)
        if buf is None or buf.numel() < n:
            grown = n if buf is None else max(n, 2 * buf.numel())
            buf = torch.zeros(grown, dtype=torch.int32, device=device)
            _ARRIVALS[key] = buf
        return buf


def window_minmax_2d(windows: torch.Tensor, is_max: bool) -> torch.Tensor:
    """windows: (W, size) f64 on the card -> (W,) f64 per-row min or
    max."""
    global window_minmax_launches
    _check(windows, "windows", 2)
    w, size = windows.shape
    lib = load()
    geo = minmax_geometry(w, size, lib.repro_window_minmax_loads())
    out = torch.empty((w,), dtype=torch.float64, device=windows.device)
    with torch.cuda.device(windows.device):
        stream = _stream_of(windows)
        partial = arrivals = None
        if geo.chunks > 1:
            partial = torch.empty((geo.scratch,), dtype=torch.float64,
                                  device=windows.device)
            arrivals = _arrivals(lib, windows.device, stream, geo.counters)
        err = lib.repro_window_minmax_rows(
            windows.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if arrivals is None else arrivals.data_ptr(), w, size,
            geo.chunk, geo.chunks, geo.threads, int(bool(is_max)), stream)
    _launched(lib, err, "window_minmax")
    with _COUNT_LOCK:
        window_minmax_launches += 1
    return out


def join_bounds_1d(lt: torch.Tensor, rs: torch.Tensor, tol: float,
                   steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """lt: (nl,) f64, rs: (nr,) f64 sorted, on the card -> int32 (lo,
    hi) of ``[lt - tol, lt + tol]`` in ``rs``; a block whose targets are
    not all finite bisects all of ``rs`` in ``steps`` levels."""
    global join_bounds_launches
    _check(lt, "lt", 1)
    _check(rs, "rs", 1)
    if rs.device != lt.device:
        raise ValueError("lt and rs must be on one device")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    lib = load()
    geo = join_geometry(lt.numel(), lib.repro_join_bounds_keys())
    lo = torch.empty(lt.shape, dtype=torch.int32, device=lt.device)
    hi = torch.empty(lt.shape, dtype=torch.int32, device=lt.device)
    with torch.cuda.device(lt.device):
        err = lib.repro_join_bounds_rows(
            lt.data_ptr(), rs.data_ptr(), float(tol), lt.numel(),
            rs.numel(), int(steps), geo.blocks, geo.threads, lo.data_ptr(),
            hi.data_ptr(), _stream_of(lt))
    _launched(lib, err, "join_bounds")
    with _COUNT_LOCK:
        join_bounds_launches += 1
    return lo, hi


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel (one block of 32 threads) on the current
    stream: the least a launch costs, for measurement (not counted)."""
    lib = load()
    with torch.cuda.device(device):
        err = lib.repro_empty_launch(
            torch.cuda.current_stream(device).cuda_stream)
    _launched(lib, err, "empty")
