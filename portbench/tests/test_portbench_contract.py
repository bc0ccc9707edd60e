"""The last line a run prints, on a tiny CPU rehearsal; its refusals
(no card, no system under test), and the JAX-import check."""
import json
import shutil
import subprocess
import sys

import pytest

from helpers import ROOT, rehearse
from portbench.core import env

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,metric", [("icu-analyst", "query_p95_ms")])
def test_last_line_of_a_rehearsal(cell, metric):
    rc, result, err = rehearse(cell, 2 ** 31 + 17, 0.5)
    assert rc == 0, err[-2000:]
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {metric, "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    # every number compared, beside its limit, ends standard error
    checks = [ln for ln in err.strip().splitlines()][-len(result["checks"]):]
    assert all(ln.startswith("check ") for ln in checks)
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"]


def test_traced_rehearsal_reports_program_spans():
    rc, result, err = rehearse("icu-analyst", 5, 0.5, "--trace", "1")
    assert rc == 0, err[-2000:]
    assert "planner_ms.analyst" in result["metrics"]
    assert "query_p95_ms" not in result["metrics"]


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "icu-analyst", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "icu-analyst",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch", "repro_torch.serve.engine", "reproducible",
             "jaxtyping", "torch", "numpy"]
    assert env.forbidden_loaded(names) == []
    assert env.forbidden_loaded(names + ["repro.core.api", "jax.numpy",
                                         "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro.core.api"]


def test_caches_live_in_the_checkout():
    e = env.cache_env(ROOT)
    for key in ("REPRO_TORCH_BUILD_DIR", "TORCH_EXTENSIONS_DIR",
                "TRITON_CACHE_DIR"):
        assert e[key].startswith(str(ROOT / "build"))
    assert e["USE_FLAX"] == "0"


def test_manifest_command_names_no_file_outside_paths():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    for word in m["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in m["paths"])
