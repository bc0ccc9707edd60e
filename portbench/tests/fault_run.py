"""Run ``portbench/run.py`` in this process with the system under test
broken underneath, from the moment the measured window opens:

    python fault_run.py <fault> <path of run.py> <run.py's arguments>

Faults (``none`` runs it as it is):
- ``stale``: the Migrator acknowledges every migration and leaves the
  destination as it was (a step that returns its state unchanged);
- ``quant``: the quant route's int8 pages come back with one code off by
  one (an answer altered where it is produced);
- ``half_rows``: the relational engine hands every query half of each
  table's rows (half of the batch left out).
"""
from __future__ import annotations

import sys
from pathlib import Path


def _install(fault: str) -> None:
    import torch
    if fault == "stale":
        from repro_torch.core import migrator
        migrator.Migrator.migrate = lambda self, *a, **k: None
    elif fault == "quant":
        from repro_torch.kernels.quant_cast import ops
        orig = ops.quantize

        def quantize(x, block=128):
            q, scale = orig(x, block)
            q = q.clone()
            q.view(-1)[0] = torch.where(q.view(-1)[0] < 127,
                                        q.view(-1)[0] + 1,
                                        q.view(-1)[0] - 1)
            return q, scale
        ops.quantize = quantize
    elif fault == "half_rows":
        from repro_torch.core import datamodel as dm
        from repro_torch.core import engines
        orig = engines.Engine.get

        def get(self, name):
            obj = orig(self, name)
            if isinstance(obj, dm.Table) and obj.num_rows > 1:
                n = obj.num_rows // 2
                return dm.Table({k: v[:n] for k, v in obj.columns.items()})
            return obj
        engines.Engine.get = get
    elif fault != "none":
        raise SystemExit(f"unknown fault {fault!r}")


def main() -> None:
    fault, run_py = sys.argv[1], Path(sys.argv[2])
    sys.path.insert(0, str(run_py.parents[1]))
    sys.path.insert(0, str(run_py.parents[1] / "src"))
    from portbench import run
    if fault != "none":
        opened = run.Context.open_window

        def open_window(self):
            _install(fault)
            return opened(self)
        run.Context.open_window = open_window
    sys.argv = [str(run_py), *sys.argv[3:]]
    sys.exit(run.main())


if __name__ == "__main__":
    main()
