"""BENCHMARK.json against the rules a manifest keeps, and every file its
entries name."""
import json
import re

import pytest

from helpers import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _metrics(m):
    return m["end_to_end"] + m["per_layer"]


def test_top_level_keys(manifest):
    assert set(manifest) == KEYS
    assert manifest["command"][:2] == ["python3", "portbench/run.py"]
    assert manifest["paths"] == ["portbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_well_formed_and_distinct(manifest, section):
    names = [e["name"] for e in manifest[section]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


def test_units_and_sources(manifest):
    for m in _metrics(manifest):
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}


def test_each_per_layer_metric_moves_what_its_cells_report(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert cell in moved.get("workloads", sorted(cells)), (m, cell)


def test_every_cell_reports_setup_another_and_a_layer(manifest):
    for w in manifest["workloads"]:
        e2e = [m["name"] for m in manifest["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in manifest["per_layer"])


def test_every_named_file_exists(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] \
            == c["name"]
    for w in manifest["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        spec = json.loads((BENCH / "workloads"
                           / f"{w['name']}.json").read_text())
        assert spec["traffic"] == w["traffic"]
        assert (BENCH / "clients" / f"{spec['client']}.py").is_file()
        assert (BENCH / "traffic" / f"{spec['generator']}.py").is_file()
    for m in manifest["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_readers_declare_what_the_manifest_says(manifest):
    from portbench.core.manifest import load_module
    for m in manifest["per_layer"]:
        mod = load_module(BENCH / "metrics" / f"{m['name']}.py", "reader")
        assert (mod.LAYER, mod.SOURCE, mod.UNIT, mod.MOVES) == (
            m["layer"], m["source"], m["unit"], m["moves"])


def test_roofline_and_mfu_names(manifest):
    for m in manifest["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"
