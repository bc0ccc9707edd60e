"""Binding of the hand-written CUDA selective-scan kernel
(``csrc/mamba_scan.cu``), which replaces the Pallas TPU kernel of
``repro.kernels.mamba_scan.mamba_scan`` (``_scan_kernel``).

The wrapper takes CUDA tensors only and raises on anything else; the CPU
path is ``ref.py``, chosen by ``ops.py`` from the tensor's device.  It
allocates the outputs, launches on PyTorch's current stream without
synchronising, raises if the launch reports an error, and adds one to
its launch count and to that of its kind: a sequence (S > 1, a prefill)
or one token (S = 1, a decode step).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu",)
DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 16                          # N: the kernel's register arrays
MAX_BATCH = 65535                       # grid y

# launches in this process, in all and by S (chip_smoke.py zeroes and
# reads them around the main path)
launches = 0
prefill_launches = 0                    # S > 1
decode_launches = 0                     # S = 1
_COUNT_LOCK = threading.Lock()


def load(name: str = "mamba_scan", sources=SOURCES) -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library (or, given
    another name and sources, a variant of it: scan_variants.py)."""
    lib = _build.load_library(name, sources)
    if not hasattr(lib, "_repro_typed"):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_selective_scan.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.repro_selective_scan.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def reset_launch_count() -> None:
    global launches, prefill_launches, decode_launches
    with _COUNT_LOCK:
        launches = prefill_launches = decode_launches = 0


def _check(u, dt, a, b, c, h0) -> None:
    bsz, s, di = u.shape if u.dim() == 3 else (0, 0, 0)
    n = a.shape[-1] if a.dim() == 2 else 0
    shapes = {"u": (u, (bsz, s, di)), "dt": (dt, (bsz, s, di)),
              "a": (a, (di, n)), "b": (b, (bsz, s, n)), "c": (c, (bsz, s, n))}
    if h0 is not None:
        shapes["h0"] = (h0, (bsz, di, n))
    for name, (x, shape) in shapes.items():
        if not x.is_cuda or x.device != u.device:
            raise ValueError(f"{name} must be a CUDA tensor on u's device, "
                             f"got {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor "
                             f"(u is (B, S, Di), a (Di, N)), got shape "
                             f"{tuple(x.shape)}, strides {x.stride()}")
    if u.dtype not in DTYPES or any(x.dtype != u.dtype for x in (dt, b, c)):
        raise TypeError(f"u, dt, b and c must share one dtype of {DTYPES}, "
                        f"got {u.dtype}, {dt.dtype}, {b.dtype}, {c.dtype}")
    for name, x in (("a", a), ("h0", h0)):
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if u.numel() == 0 or not 1 <= n <= MAX_STATE or bsz > MAX_BATCH:
        raise ValueError(f"need S >= 1, Di >= 1, 1 <= N <= {MAX_STATE} and "
                         f"B <= {MAX_BATCH}: u {tuple(u.shape)}, a "
                         f"{tuple(a.shape)}")


def selective_scan_3d(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor,
                      h0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u,dt: (B,S,Di), b,c: (B,S,N), one dtype, on the card; a: (Di,N)
    f32; optional h0 (B,Di,N) f32, zero if None -> (y (B,S,Di) in u's
    dtype, final h (B,Di,N) f32)."""
    global launches, prefill_launches, decode_launches
    _check(u, dt, a, b, c, h0)
    bsz, s, di = u.shape
    n = a.shape[1]
    lib = load()
    y = torch.empty_like(u)
    h_out = torch.empty((bsz, di, n), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.repro_selective_scan(
            u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_out.data_ptr(), bsz, s, di, n,
            int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream(u.device).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    with _COUNT_LOCK:
        launches += 1
        if s > 1:
            prefill_launches += 1
        else:
            decode_launches += 1
    return y, h_out
