"""Binding of the hand-written CUDA WKV6 kernels (``csrc/rwkv6_scan.cu``),
which replace the Pallas TPU kernel of
``repro.kernels.rwkv6_scan.rwkv6_scan`` (``_wkv_kernel``), in two routes:

- ``CHUNKED`` (S >= 16, every prefill): the stable chunked form, its
  products on the tensor cores in 3xTF32 (``ref.wkv6_chunked`` is its
  plain version);
- ``PER_TOKEN`` (S < 16, every S = 1 decode step): the recurrence token
  by token on the CUDA cores.

``route`` picks one from S alone, before any launch.  The wrapper takes
CUDA tensors only and raises on anything else; the CPU path is
``ref.py``, chosen by ``ops.py`` from the tensor's device.  It allocates
the outputs, launches on PyTorch's current stream without synchronising,
raises if the launch reports an error, and adds one to its launch count
and to its route's.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu",)
HEAD_DIMS = (16, 32, 64)                # the kernels' template instances
CHUNK = 16                              # tokens of the chunked route's chunk
CHUNKED, PER_TOKEN = "chunked", "per_token"

# launches in this process, in all and by route (chip_smoke.py zeroes and
# reads them around the main path)
launches = 0
chunked_launches = 0
per_token_launches = 0
_COUNT_LOCK = threading.Lock()


def route(seq_len: int) -> str:
    """The kernel that takes a sequence of ``seq_len`` tokens: ``CHUNKED``
    from one whole chunk (16 tokens) up, else ``PER_TOKEN``."""
    return CHUNKED if seq_len >= CHUNK else PER_TOKEN


def load(name: str = "rwkv6_scan", sources=SOURCES) -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library (or, given
    another name and sources, a variant of it: scan_variants.py)."""
    lib = _build.load_library(name, sources)
    if not hasattr(lib, "_repro_typed"):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_wkv6.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.repro_wkv6.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def reset_launch_count() -> None:
    global launches, chunked_launches, per_token_launches
    with _COUNT_LOCK:
        launches = chunked_launches = per_token_launches = 0


def _check(r, k, v, w, u, state) -> None:
    b, s, h, d = r.shape if r.dim() == 4 else (0, 0, 0, 0)
    shapes = {"r": (r, (b, s, h, d)), "k": (k, (b, s, h, d)),
              "v": (v, (b, s, h, d)), "w": (w, (b, s, h, d)),
              "u": (u, (h, d))}
    if state is not None:
        shapes["state"] = (state, (b, h, d, d))
    for name, (x, shape) in shapes.items():
        if not x.is_cuda or x.device != r.device:
            raise ValueError(f"{name} must be a CUDA tensor on r's device, "
                             f"got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor "
                             f"(r is (B, S, H, D)), got shape "
                             f"{tuple(x.shape)}, strides {x.stride()}")
        # the chunked route copies r, k, v and w in 16-byte pieces
        if name in ("r", "k", "v", "w") and x.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")
    if r.numel() == 0:
        raise ValueError(f"r must hold at least one token, got shape "
                         f"{tuple(r.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if b * h >= 2**31:
        raise ValueError(f"B x H ({b} x {h}) must be below 2**31")


def wkv6_4d(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor,
            state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w: (B,S,H,D) float32 on the card; u: (H,D); optional initial
    state (B,H,D,D), zero if None -> (y (B,S,H,D), final state), through
    the route that ``route(S)`` names."""
    global launches, chunked_launches, per_token_launches
    _check(r, k, v, w, u, state)
    b, s, h, d = r.shape
    which = route(s)
    lib = load()
    y = torch.empty_like(r)
    s_out = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = lib.repro_wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), b, s, h, d,
            int(which == CHUNKED),
            torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"rwkv6_scan ({which}) launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    with _COUNT_LOCK:
        launches += 1
        if which == CHUNKED:
            chunked_launches += 1
        else:
            per_token_launches += 1
    return y, s_out
