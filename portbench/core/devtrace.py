"""The device's side of a traced run, from ``torch.profiler`` (CUPTI):
the seconds in which an operation ran on the card, time by kernel, and
the longest idle gaps labelled by what the harness's host thread was
doing then (its own marks, on the same wall clock as the trace).

Only the CUDA activity is recorded: the per-launch cost of recording
every host operator would slow the host path the metrics judge.
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time
from typing import Dict, List, Optional, Tuple


class HostMarks:
    """What the harness's host thread is doing, as labelled intervals on
    the wall clock (ns since the epoch, as the profiler stamps events)."""

    def __init__(self) -> None:
        self.marks: List[Tuple[int, int, str]] = []
        self.on = False

    @contextlib.contextmanager
    def mark(self, label: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.marks.append((t0, time.time_ns(), label))

    def label_at(self, t_ns: int) -> str:
        starts = [m[0] for m in self.marks]
        i = bisect.bisect_right(starts, t_ns) - 1
        if i >= 0 and self.marks[i][1] >= t_ns:
            return self.marks[i][2]
        return "harness"


class DeviceTrace:
    """Profile the card from ``start()`` to ``stop()``; the traced window
    runs from ``begin()`` to ``stop()``, so that the profiler's start-up
    (the first activity buffers, CUPTI's own set-up) is not read as the
    card standing idle."""

    def __init__(self) -> None:
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.intervals: List[Tuple[int, int, str]] = []

    def start(self) -> None:
        import torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        self.t0_ns = time.time_ns()

    def begin(self) -> None:
        """Open the traced window (the profiler already running)."""
        import torch
        torch.cuda.synchronize()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(None, None, None)
        self.intervals = _device_events(self.prof)
        self.prof = None

    # -- readings ------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_s(self) -> float:
        """Seconds in which at least one operation ran on the card (the
        union of every kernel, copy and set's interval), in the window."""
        total, end = 0, self.t0_ns
        for s, e, _ in sorted(self.intervals):
            s, e = max(s, end, self.t0_ns), min(e, self.t1_ns)
            if e > s:
                total += e - s
                end = e
        return total / 1e9

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        """(count, seconds) of device operations by name."""
        out: Dict[str, Tuple[int, float]] = {}
        for s, e, name in self.intervals:
            n, sec = out.get(name, (0, 0.0))
            out[name] = (n + 1, sec + (e - s) / 1e9)
        return out

    def matching(self, pattern: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name matches the
        regular expression ``pattern``."""
        n, sec = 0, 0.0
        for name, (c, t) in self.by_name().items():
            if re.search(pattern, name):
                n, sec = n + c, sec + t
        return n, sec

    def gaps(self, marks: Optional[HostMarks], top: int = 10
             ) -> List[Tuple[str, float]]:
        """The longest idle gaps of the card, each labelled by the host
        mark at its midpoint."""
        edges, end = [], self.t0_ns
        for s, e, _ in sorted(self.intervals):
            if s > end:
                edges.append((s - end, end, s))
            end = max(end, e)
        if self.t1_ns > end:
            edges.append((self.t1_ns - end, end, self.t1_ns))
        edges.sort(reverse=True)
        out = []
        for dur, a, b in edges[:top]:
            label = marks.label_at((a + b) // 2) if marks else "harness"
            out.append((label, dur / 1e9))
        return out

    def breakdown(self, marks: Optional[HostMarks]) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])
        return {"device_ops": [[_short(n), t] for n, (_, t) in ops[:10]],
                "idle_gaps": [[n, t] for n, t in self.gaps(marks)]}


def _short(name: str) -> str:
    """A device operation's name without its template arguments."""
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out)[:160]


def _device_events(prof) -> List[Tuple[int, int, str]]:
    """(start ns, end ns, name) of every operation the card ran."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            s = int(e.start_ns())
            out.append((s, s + int(e.duration_ns()), e.name()))
    return out
