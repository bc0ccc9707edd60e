"""Plain PyTorch versions of the streaming kernels (``csrc/stream.cu``),
ported from the plain references of ``repro.stream.kernels``
(``window_minmax_ref``, ``join_bounds_ref``).

Bit for bit what the reference's compiled path computes.  ``torch.amax``
and ``torch.amin`` keep a NaN as ``jnp.max``/``jnp.min`` do, but they
pick between ``-0.0`` and ``+0.0`` by position, where XLA (and the
Pallas kernel) orders ``-0 < +0``: a max whose result is zero is ``+0``
when the row holds a ``+0``, and a min whose result is zero is ``-0``
when the row holds a ``-0``.  ``window_minmax`` repairs the sign of a
zero result to that order.  ``torch.searchsorted`` resolves ties as
``jnp.searchsorted`` does, on exact float64 compares.

``join_bounds_narrowed`` is the CUDA kernel's algorithm written out
(block ranges, a 32-way warp search, a staged or a wide slice, the
whole of ``rs`` for non-finite targets), so that the CPU tests can hold
it to the reference; the port runs ``join_bounds``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def window_minmax(windows: torch.Tensor, is_max: bool) -> torch.Tensor:
    """(W, size) stacked windows -> (W,) per-window min or max."""
    out = torch.amax(windows, dim=1) if is_max else torch.amin(windows, dim=1)
    # the zero the order -0 < +0 picks: +0 for a max holding one, -0 for
    # a min holding one (no branch on the data: no host sync)
    wanted = windows.signbit() != is_max
    has = ((windows == 0) & wanted).any(dim=1)
    signed = torch.where(has == is_max, 0.0, -0.0).to(out.dtype)
    return torch.where(out == 0, signed, out)


def join_bounds(lt: torch.Tensor, rs: torch.Tensor, tol: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 searchsorted bounds of ``[lt - tol, lt + tol]`` in sorted
    ``rs``."""
    lo = torch.searchsorted(rs, lt - tol, out_int32=True)
    hi = torch.searchsorted(rs, lt + tol, right=True, out_int32=True)
    return lo, hi


def bisect(s: torch.Tensor, targets: torch.Tensor, steps: int,
           right: bool, lo: Optional[torch.Tensor] = None,
           hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference kernel's branchless searchsorted of ``targets`` in
    sorted ``s`` (ties go right iff ``right``), ``steps`` levels, each
    target's search open over ``[lo, hi)`` (all of ``s`` by default):
    exact when ``steps >= floor(log2(hi - lo)) + 1``; a NaN target finds
    ``lo``."""
    n = s.shape[0]
    if lo is None:
        lo = torch.zeros(targets.shape, dtype=torch.int64)
        hi = torch.full(targets.shape, n, dtype=torch.int64)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = s[mid.clamp(max=n - 1)]
        go = (v <= targets if right else v < targets) & (mid < hi)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    return lo


def levels(n: int) -> int:
    """``ceil(log2(max(n, 2))) + 1``: the reference's bisection levels
    over ``n`` sorted keys."""
    return (max(int(n), 2) - 1).bit_length() + 1


def guess_place(t, r0: float, r1: float, n: int):
    """The kernel's guess at the place of ``t`` among ``n`` sorted keys
    running from ``r0`` to ``r1``, as if they were evenly spaced: in
    ``[0, n)``, an end for NaN, infinite or out-of-range values (the
    kernel computes it in float32; a guess only steers the search)."""
    scale = (n - 1) / (r1 - r0) if r1 > r0 else 0.0
    at = (torch.as_tensor(t, dtype=torch.float64) - r0) * scale
    return torch.where(at > 0, at, 0.0).clamp(max=n - 1).to(torch.int64)


def warp_bound(rs: torch.Tensor, t: float, right: bool) -> int:
    """The kernel's warp search: the length of the prefix of sorted
    ``rs`` before ``t`` (``< t``, or ``<= t`` when ``right``).  The 32
    lanes first probe keys 0, 1, 3, ... 32,767 after a guess and 1, 2,
    4, ... 32,768 before it, then keys evenly spaced over the range
    left open, each level narrowing it by the count of probes before
    ``t``."""
    n = rs.shape[0]
    lanes = torch.arange(32, dtype=torch.int64)
    g = int(guess_place(t, float(rs[0]), float(rs[n - 1]), n))
    offsets = torch.where(lanes < 16, -(1 << (15 - lanes).clamp(min=0)),
                          (1 << (lanes - 16).clamp(min=0)) - 1)
    q = (g + offsets).clamp(0, n - 1)
    lo, hi = 0, n
    while True:
        v = rs[q]
        c = int(((v <= t) if right else (v < t)).sum())
        if c > 0:
            lo = int(q[c - 1]) + 1
        if c < 32:
            hi = int(q[c])
        if lo >= hi:
            return lo
        q = lo + (((hi - lo) * lanes) >> 5)


def _gallop(s: torch.Tensor, t: torch.Tensor, right: bool,
            lo: torch.Tensor, hi: torch.Tensor,
            forward: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's gallop: each bound, known to lie in ``[lo, hi]``,
    probed 1, 2, 4, ... keys on from ``lo`` (``forward``) or back from
    ``hi`` until a probe passes it; returns the narrowed ``[lo, hi]``."""
    open_ = lo < hi
    step = 1
    while bool(open_.any()):
        reach = torch.minimum(torch.full_like(lo, step), hi - lo)
        probe = torch.where(forward, lo + reach - 1, hi - reach)
        v = s[probe.clamp(0, s.shape[0] - 1)]
        below = (v <= t) if right else (v < t)
        lo = torch.where(open_ & below, probe + 1, lo)
        hi = torch.where(open_ & ~below, probe, hi)
        open_ = open_ & (below == forward) & (lo < hi)
        step *= 2
    return lo, hi


def lower_bounds(s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The kernel's lower bounds of ``a`` in sorted ``s``: each key's place
    guessed from the ends of ``s`` (``guess_place``), a gallop from the
    guess towards the bound, a bisection of the last step."""
    m = s.shape[0]
    guess = guess_place(a, float(s[0]), float(s[m - 1]), m)
    forward = s[guess] < a
    lo, hi = _gallop(s, a, False, torch.where(forward, guess + 1, 0),
                     torch.where(forward, m, guess), forward)
    return bisect(s, a, levels(int((hi - lo).max())), False, lo, hi)


def upper_bounds(s: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 lo: torch.Tensor) -> torch.Tensor:
    """The kernel's upper bounds of ``b`` in sorted ``s``, given ``lo``,
    the lower bounds of ``a``: at or after them when ``b >= a`` (a gallop
    from ``lo``, then a bisection of the last step), at or before them
    otherwise."""
    m = s.shape[0]
    up = b >= a
    start, stop = _gallop(s, b, True, torch.where(up, lo, 0),
                          torch.where(up, m, lo), up)
    return bisect(s, b, levels(int((stop - start).max())), True, start, stop)


def join_bounds_narrowed(lt: torch.Tensor, rs: torch.Tensor, tol: float,
                         block: int, budget: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Dict[str, int]]:
    """``join_bounds`` as the CUDA kernel computes it, block by block of
    ``block`` left keys, with the number of blocks each route took:
    ``full`` (targets not all finite: both bisections over all of
    ``rs``, the reference's levels, as its kernel), else the slice
    ``[L, H)`` two warp searches give, ``empty`` when it holds no key,
    ``staged`` when it holds at most ``budget`` (shared memory), ``wide``
    otherwise; in the slice, ``lower_bounds`` then ``upper_bounds``."""
    a, b = lt - tol, lt + tol
    lo = torch.empty(lt.shape, dtype=torch.int64)
    hi = torch.empty(lt.shape, dtype=torch.int64)
    routes = dict.fromkeys(("full", "empty", "staged", "wide"), 0)
    for start in range(0, lt.shape[0], block):
        sl = slice(start, start + block)
        ta, tb = a[sl], b[sl]
        if not bool(torch.isfinite(ta).all() & torch.isfinite(tb).all()):
            steps = levels(rs.shape[0])
            lo[sl] = bisect(rs, ta, steps, False)
            hi[sl] = bisect(rs, tb, steps, True)
            routes["full"] += 1
            continue
        first = warp_bound(rs, float(torch.minimum(ta, tb).min()), False)
        m = warp_bound(rs, float(torch.maximum(ta, tb).max()), True) - first
        if m == 0:
            lo[sl] = hi[sl] = first
            routes["empty"] += 1
            continue
        routes["staged" if m <= budget else "wide"] += 1
        s = rs[first:first + m]
        la = lower_bounds(s, ta)
        lo[sl], hi[sl] = first + la, first + upper_bounds(s, ta, tb, la)
    return lo.to(torch.int32), hi.to(torch.int32), routes
