"""Run one cell of the port's benchmark once, and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the system under test, ``src/repro_torch``.  The run loads the cell
(``BENCHMARK.json`` and the files it names), sets up the system on the
card with inputs made from ``--seed``, warms the cell's own shapes,
measures for ``--seconds``, checks what the timed path produced against
the plain reference (``portbench/reference/``), and prints one JSON
object as the last line of its standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read under ``torch.profiler`` and
the program's own spans.  Each number the check compares is printed
beside its limit, as the last lines of standard error and under
``checks``, the result's last key.

A run prints no result, and exits with another code than 0, when there
is no card or fewer than the cell asks for (4), when the system under
test is not in the checkout (3), or when a module of JAX or of the JAX
package was loaded (5).  ``--control 1`` also reads the lower-precision
control (``reference`` computed one precision down in the program's
place); ``--rehearsal`` runs the cell's small ``rehearsal`` sizes on the
CPU, for tests: neither is used by the benchmark's own runs.
"""
import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.core import env, manifest  # noqa: E402
from portbench.core.devtrace import DeviceTrace, HostMarks  # noqa: E402

EXIT_NO_SYSTEM, EXIT_NO_CARD, EXIT_FORBIDDEN = 3, 4, 5
TRACE_RING = 4_000_000        # program spans kept in a traced run


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearsal", action="store_true")
    return p.parse_args(argv)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Context:
    """What a client gets: the cell, its parameters, the seed, the device,
    and the hooks that open and close the measured window."""

    def __init__(self, args, cell: manifest.Cell) -> None:
        self.args = args
        self.cell = cell
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.rehearsal = bool(args.rehearsal)
        self.device = "cpu" if self.rehearsal else "cuda"
        self.config = cell.config
        self.params = dict(cell.workload["params"])
        if self.rehearsal:
            self.params.update(cell.workload.get("rehearsal", {}))
        self.marks = HostMarks()
        self.marks.on = self.trace
        self.dtrace = DeviceTrace() if (self.trace and not self.rehearsal) \
            else None
        self.window_t0 = self.window_t1 = 0.0
        self.spans = []

    def sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def open_window(self) -> float:
        """Start the measured window (and the traces of a traced run);
        returns its start on the host's perf counter.  The collector is
        off in the window, its set-up's objects frozen out of it: its
        pauses would land on whichever operation they hit."""
        self.sync()
        gc.collect()
        gc.freeze()
        gc.disable()
        if self.trace:
            from repro_torch.obs import trace
            trace.reset()
            trace.set_enabled(True)
            if self.dtrace is not None:
                self.dtrace.begin()
        self.window_t0 = time.perf_counter()
        return self.window_t0

    def close_window(self) -> None:
        """End the measured window, then the traces (before the collector
        comes back on: its first pass over the window's objects is no
        part of the window)."""
        self.sync()
        self.window_t1 = time.perf_counter()
        if self.trace:
            from repro_torch.obs import trace
            if self.dtrace is not None:
                self.dtrace.stop()
            trace.set_enabled(False)
            self.spans = trace.spans()
        gc.enable()
        gc.unfreeze()


def main(argv=None) -> int:
    args = parse(argv)
    env.prepare(ROOT)
    env.steady_host()
    if args.trace:
        # read by the program's tracing module when it is imported
        os.environ["REPRO_TRACE_RING"] = str(TRACE_RING)
    if not (ROOT / "src" / "repro_torch").is_dir():
        log("portbench: the system under test (src/repro_torch) is not "
            "in this checkout")
        return EXIT_NO_SYSTEM
    man = manifest.load_manifest(ROOT)
    cell = manifest.Cell(man, args.workload)
    import torch
    if not args.rehearsal:
        if not torch.cuda.is_available():
            log("portbench: no CUDA device; the benchmark runs only on "
                "the card")
            return EXIT_NO_CARD
        if torch.cuda.device_count() < cell.chips:
            log(f"portbench: {cell.name} asks for {cell.chips} cards, "
                f"{torch.cuda.device_count()} present")
            return EXIT_NO_CARD
    ctx = Context(args, cell)
    client = cell.client()

    state = client.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - _T_START
    if ctx.dtrace is not None:
        # the profiler's own start-up falls before the window opens
        ctx.dtrace.start()
    out = client.window(ctx, state)
    peak = (torch.cuda.max_memory_allocated() if ctx.device == "cuda"
            else 0)
    client.release(ctx, state)
    t_check = time.perf_counter()
    checks = client.check(ctx, state, out)
    out.setdefault("notes", []).append(
        f"portbench: set-up {setup_s!r} s, window "
        f"{ctx.window_t1 - ctx.window_t0!r} s, check "
        f"{time.perf_counter() - t_check!r} s")
    if args.control:
        for c in client.control(ctx, state, out):
            log("control " + c.line())

    found = env.forbidden_loaded(sys.modules)
    if found:
        log(f"portbench: modules of JAX or of the JAX package were "
            f"loaded: {', '.join(found)}")
        return EXIT_FORBIDDEN

    metrics = {}
    if not args.trace:
        for m in cell.end_to_end():
            value = setup_s if m["name"] == "setup_s" else \
                out["metrics"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(ctx, out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if ctx.rehearsal:
        device = {"platform": "cpu", "kind": "cpu", "count": 0,
                  "memory_peak_bytes": 0}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(checks) and all(c.ok for c in checks),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": metrics, "device": device}
    if ctx.dtrace is not None:
        device["busy_s"] = ctx.dtrace.busy_s()
        device["window_s"] = ctx.dtrace.window_s
        result["breakdown"] = ctx.dtrace.breakdown(ctx.marks)
    for line in out.get("notes", []):
        log(line)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    for c in checks:
        log(c.line())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
