"""A later change adds a cell and a per-layer metric by adding files and
manifest entries alone: here, in a copy of the benchmark, a cell with a
traffic mix of its own (the text island's key ranges and the catalog)
goes into BENCHMARK.json with a new metric and its reader, and runs
there, with no file of the copy edited."""
import json
import os
import shutil

from helpers import ROOT, rehearse

READER = '''"""Queries a traced window held (a count of the harness's own)."""
LAYER = "endpoint"
SOURCE = "program_counter"
UNIT = "queries"
MOVES = "query_p95_ms"


def read(ctx, out):
    return out.get("layer", {}).get("queries") or None
'''


def test_add_a_cell_and_a_metric(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", tmp_path / "src")
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = json.loads((ROOT / "portbench" / "workloads"
                       / "icu-analyst.json").read_text())
    spec["traffic"] = "notes_mix"
    spec["params"]["mix"] = {"text_range": 3, "catalog": 1}
    (tmp_path / "portbench" / "workloads" / "icu-notes.json"
     ).write_text(json.dumps(spec))
    m["workloads"].append({"name": "icu-notes", "config": "icu-mimic2",
                           "traffic": "notes_mix", "chips": 1,
                           "why": "key ranges over the notes"})
    for e in m["end_to_end"]:
        if e["name"] == "query_p95_ms":
            e["workloads"].append("icu-notes")
    (tmp_path / "portbench" / "metrics" / "queries.notes.py"
     ).write_text(READER)
    m["per_layer"].append({"name": "queries.notes", "unit": "queries",
                           "better": "higher", "source": "program_counter",
                           "layer": "endpoint", "moves": "query_p95_ms",
                           "workloads": ["icu-notes"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    rc, result, err = rehearse("icu-notes", 3, 0.3, "--trace", "1",
                               root=tmp_path)
    assert rc == 0, err[-2000:]
    assert result["correct"] is True
    assert result["metrics"]["queries.notes"]["value"] > 0
    assert "planner_ms.analyst" not in result["metrics"]
    rc, result, err = rehearse("icu-notes", 3, 0.3, root=tmp_path)
    assert rc == 0, err[-2000:]
    assert set(result["metrics"]) == {"query_p95_ms", "setup_s"}
