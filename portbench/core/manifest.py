"""The benchmark's manifest (``BENCHMARK.json`` at the checkout's root) and
the files it names.  Everything that belongs to one configuration, one
traffic mix or one per-layer metric sits in a file of its own, found by
the name the manifest gives it:

- ``portbench/configs/<config>.json``   a configuration (the manifest's
  ``file`` names it);
- ``portbench/workloads/<cell>.json``   a traffic mix: its generator, the
  generator's parameters, the client that feeds the system, the loop;
- ``portbench/traffic/<generator>.py``  a traffic generator;
- ``portbench/clients/<client>.py``     the client that drives one entry
  of the system under test;
- ``portbench/metrics/<metric>.py``     the reader of a per-layer metric.

So a later change adds a cell or a metric by adding files and manifest
entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class ManifestError(RuntimeError):
    pass


def load_manifest(root: Path = ROOT) -> Dict[str, Any]:
    path = Path(root) / "BENCHMARK.json"
    if not path.exists():
        raise ManifestError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find(entries: List[Dict[str, Any]], name: str, what: str
         ) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise ManifestError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path, label: str) -> ModuleType:
    """Import the file at ``path`` as a module of its own (file names may
    hold dots, as metric names do)."""
    if not path.exists():
        raise ManifestError(f"missing {label}: {path}")
    mod_name = "portbench_" + re.sub(r"\W", "_", str(
        path.relative_to(path.parents[1]).with_suffix("")))
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with its configuration, traffic mix,
    client, generator and per-layer metric readers, all found by name
    under ``bench_dir``."""

    def __init__(self, manifest: Dict[str, Any], name: str,
                 bench_dir: Path = BENCH_DIR) -> None:
        self.manifest = manifest
        self.bench_dir = Path(bench_dir)
        self.entry = find(manifest["workloads"], name, "workload")
        self.name = name
        self.config_entry = find(manifest["configs"], self.entry["config"],
                                 "configuration")
        root = self.bench_dir.parent
        self.config = json.loads(
            (root / self.config_entry["file"]).read_text())
        self.workload = json.loads(
            (self.bench_dir / "workloads" / f"{name}.json").read_text())
        if self.workload["traffic"] != self.entry["traffic"]:
            raise ManifestError(
                f"{name}: the workload file's traffic "
                f"{self.workload['traffic']!r} is not the manifest's "
                f"{self.entry['traffic']!r}")
        self.chips = int(self.entry["chips"])

    def client(self) -> ModuleType:
        return load_module(self.bench_dir / "clients"
                           / f"{self.workload['client']}.py", "client")

    def generator(self) -> ModuleType:
        return load_module(self.bench_dir / "traffic"
                           / f"{self.workload['generator']}.py",
                           "traffic generator")

    def end_to_end(self) -> List[Dict[str, Any]]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict[str, Any]]:
        """The per-layer metrics read in this cell (those whose
        ``workloads`` list it, or with no list, every cell that reports
        the end-to-end metric they move)."""
        e2e = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.manifest["per_layer"]:
            cells = m.get("workloads")
            if (self.name in cells) if cells is not None else (
                    m["moves"] in e2e):
                out.append(m)
        return out

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           "metric reader")
