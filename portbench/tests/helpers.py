"""Helpers of the benchmark's CPU tests: run a cell's small rehearsal in
a process of its own (a run sets environment variables and the query
backend, which must not leak into other tests), optionally with the
system under test broken underneath by a named fault."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FAULT_RUN = Path(__file__).resolve().parent / "fault_run.py"


def rehearse(workload: str, seed: int, seconds: float, *extra: str,
             fault: str = "", root: Path = ROOT, timeout: float = 240):
    """(exit code, result dict or None, stderr) of one rehearsal."""
    args = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--rehearsal", *extra]
    cmd = [sys.executable, str(FAULT_RUN), fault or "none",
           str(Path(root) / "portbench" / "run.py"), *args]
    env = dict(os.environ)
    env.pop("REPRO_QUERY_BACKEND", None)
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=root, env=env)
    lines = proc.stdout.strip().splitlines()
    result = None
    if lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return proc.returncode, result, proc.stderr
