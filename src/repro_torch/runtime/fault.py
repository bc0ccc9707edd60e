"""Fault-tolerant execution harness: heartbeats, failure injection,
checkpoint/restart recovery, and straggler mitigation, ported from
``repro.runtime.fault``.

On a real cluster the heartbeat source is the coordinator's RPC layer;
here hosts are simulated workers so the recovery logic (detect -> restore
latest checkpoint -> rebuild state -> resume from the failed step, with the
deterministic data pipeline replaying the exact batch) is fully exercised
by tests.  The straggler path feeds the polystore Monitor (per-engine EWMA
-> Planner avoidance), the same loop the paper uses for engine selection.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.monitor import Monitor


class NodeFailure(Exception):
    def __init__(self, host_id: int, step: int) -> None:
        super().__init__(f"host {host_id} failed at step {step}")
        self.host_id = host_id
        self.step = step


class SimulatedCrash(BaseException):
    """Raised by an armed crash point to simulate a process kill at a
    precise instruction boundary.  Deliberately a ``BaseException``:
    recovery-minded ``except Exception`` handlers in the code under
    test must NOT swallow a kill — only the test harness catches it.
    """

    def __init__(self, point: str, hit: int) -> None:
        super().__init__(f"simulated crash at {point!r} (hit #{hit})")
        self.point = point
        self.hit = hit


# -- crash points ------------------------------------------------------------
#
# Durable-path code (segment log appends, checkpoint promote/prune,
# commit/flush boundaries) calls ``crash_point("layer/step")`` at every
# instruction boundary where a real kill could land.  Disarmed — the
# production state — the call is one attribute load and a None check.
# Tests arm a deterministic countdown: the k-th matching hit raises
# ``SimulatedCrash``, so a property-test strategy that draws ``k``
# enumerates the entire crash surface, and shrinking ``k`` toward 1
# minimizes a failure to the earliest crash site that exhibits it.

_CRASH_LOCK = threading.Lock()
_ARMED: Optional[Dict[str, Any]] = None


def arm_crash_point(match: Optional[str] = None, at_hit: int = 1) -> None:
    """Arm the global crash injector: the ``at_hit``-th crash point whose
    name matches the ``match`` glob (all points when None) raises
    ``SimulatedCrash``.  Hits are counted process-wide under a lock, so
    the schedule is deterministic for a deterministic workload."""
    global _ARMED
    assert at_hit >= 1
    with _CRASH_LOCK:
        _ARMED = {"match": match, "remaining": int(at_hit),
                  "hits": [], "fired": None}


def disarm_crash_points() -> Dict[str, Any]:
    """Disarm and return the report: ``hits`` (every matching point
    reached, in order) and ``fired`` (the point that crashed, or None —
    e.g. when ``at_hit`` exceeded the workload's crash surface, which is
    how tests *count* the surface before sweeping it)."""
    global _ARMED
    with _CRASH_LOCK:
        report, _ARMED = _ARMED, None
    return report if report is not None else {"hits": [], "fired": None}


def crash_points_armed() -> bool:
    return _ARMED is not None


def crash_point(name: str,
                flush: Optional[Callable[[], None]] = None) -> None:
    """A possible kill site.  No-op unless armed.  When this hit fires,
    ``flush`` (if given) runs first — the caller's chance to push
    buffered bytes to disk so the simulated kill leaves exactly the
    torn on-disk state a real kill at this boundary would."""
    if _ARMED is None:
        return
    with _CRASH_LOCK:
        armed = _ARMED
        if armed is None:
            return
        if armed["match"] is not None and \
                not fnmatch.fnmatch(name, armed["match"]):
            return
        armed["hits"].append(name)
        armed["remaining"] -= 1
        if armed["remaining"] > 0:
            return
        if armed["fired"] is not None:        # crash once, not per thread
            return
        armed["fired"] = name
        hit = len(armed["hits"])
    if flush is not None:
        flush()
    raise SimulatedCrash(name, hit)


@contextlib.contextmanager
def crash_at(match: Optional[str] = None, at_hit: int = 1):
    """Context manager: arm on entry, disarm on exit, yield a mutable
    report dict that is filled in on exit (``hits``/``fired``)."""
    arm_crash_point(match, at_hit)
    report: Dict[str, Any] = {}
    try:
        yield report
    finally:
        report.update(disarm_crash_points())


@dataclasses.dataclass
class Heartbeat:
    host_id: int
    last_seen: float
    step: int


class HeartbeatRegistry:
    def __init__(self, timeout_seconds: float = 10.0) -> None:
        self.timeout = timeout_seconds
        self.beats: Dict[int, Heartbeat] = {}

    def beat(self, host_id: int, step: int) -> None:
        self.beats[host_id] = Heartbeat(host_id, time.monotonic(), step)

    def dead_hosts(self) -> List[int]:
        now = time.monotonic()
        return [h for h, b in self.beats.items()
                if now - b.last_seen > self.timeout]


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule: {step: host_id}."""
    schedule: Dict[int, int] = dataclasses.field(default_factory=dict)

    def check(self, step: int) -> None:
        if step in self.schedule:
            host = self.schedule.pop(step)
            raise NodeFailure(host, step)


@dataclasses.dataclass
class RecoveryReport:
    steps_run: int
    failures_recovered: int
    restarts: List[int]


def run_with_recovery(
        *, init_state: Callable[[], Any],
        step_fn: Callable[[Any, int], Any],
        ckpt: CheckpointManager,
        num_steps: int,
        checkpoint_every: int = 10,
        injector: Optional[FailureInjector] = None,
        max_failures: int = 4) -> RecoveryReport:
    """Run ``num_steps`` of ``step_fn`` with checkpoint/restart recovery.

    On NodeFailure: restore the latest checkpoint and resume from the step
    after it.  The data pipeline is step-deterministic, so replayed steps
    recompute identical batches (exactly-once semantics w.r.t. optimizer
    updates is guaranteed by restarting from the checkpointed step).
    """
    failures = 0
    restarts: List[int] = []
    state = init_state()
    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        state, start = ckpt.restore(state)
        start += 1

    step = start
    steps_run = 0
    while step < num_steps:
        try:
            if injector is not None:
                injector.check(step)
            state = step_fn(state, step)
            steps_run += 1
            if step % checkpoint_every == 0:
                ckpt.save(step, state)
            step += 1
        except NodeFailure:
            failures += 1
            if failures > max_failures:
                raise
            restarts.append(step)
            # detect -> restore -> resume
            latest = ckpt.latest_step()
            if latest is None:
                state = init_state()
                step = 0
            else:
                state, restored = ckpt.restore(state)
                step = restored + 1
    ckpt.wait()
    return RecoveryReport(steps_run=steps_run,
                          failures_recovered=failures, restarts=restarts)


@dataclasses.dataclass
class StragglerMitigator:
    """Per-host step-time EWMAs; slow hosts are reported for re-sharding.

    Policy mirrors the paper's Monitor->Planner loop: the Monitor observes,
    the Planner re-routes (here: the launcher re-balances data shards away
    from hosts whose EWMA exceeds factor x median).
    """
    monitor: Monitor
    factor: float = 2.0

    def observe(self, host_id: int, seconds: float) -> None:
        self.monitor.observe_engine(f"host{host_id}", seconds)

    def slow_hosts(self) -> List[int]:
        return [int(name[4:]) for name in
                self.monitor.stragglers(self.factor)
                if name.startswith("host")]

    def rebalance(self, num_hosts: int) -> Dict[int, float]:
        """Returns per-host data-shard weights (slow hosts get less)."""
        slow = set(self.slow_hosts())
        weights = {h: (0.5 if h in slow else 1.0)
                   for h in range(num_hosts)}
        total = sum(weights.values())
        return {h: w / total for h, w in weights.items()}
