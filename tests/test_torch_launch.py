"""The port's launch layer: the dry run's CLI on the 16 x 16 production
mesh (rank 0 of a fake process group, fake tensors, so it runs here in
seconds; the twin of the reference's slow subprocess test), one cell
with the cost probe at a reduced config on a fake (2, 4) mesh, and the
sweep and hill-climb drivers restricted to one cell."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh

from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.models import registry as jregistry

from repro_torch.launch import drive_dryrun, hillclimb
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.models import registry

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def _reference_decode_argument_bytes(arch: str, shape: str) -> int:
    """The reference's per-device bytes of a decode cell's inputs (bf16
    params, decode batch, cache, the int32 pos) on the abstract 16 x 16
    mesh."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    cfg = jregistry.get_config(arch)
    rules = jspecs.pick_rules(cfg, mesh)
    plans = [jspecs.param_structs_and_shardings(cfg, mesh, rules,
                                                dtype=jnp.bfloat16)[1:],
             jspecs.decode_batch_specs(cfg, JSHAPES[shape], mesh),
             jspecs.cache_structs_and_shardings(cfg, JSHAPES[shape], mesh,
                                                rules)]
    total = 4
    for structs, shards in plans:
        for s, sh in zip(jax.tree.leaves(structs), jax.tree.leaves(shards)):
            n = 1
            for d in sh.shard_shape(s.shape):
                n *= d
            total += n * s.dtype.itemsize
    return total


def test_dryrun_cli_single_cell(tmp_path):
    out = tmp_path / "cell.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "qwen2-1.5b", "--shape", "decode_32k", "--no-cost-probe",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(out.read_text().strip())
    assert rec["status"] == "ok"
    assert rec["devices"] == 256
    assert rec["memory"]["argument_bytes"] == \
        _reference_decode_argument_bytes("qwen2-1.5b", "decode_32k")
    # the cache is written in place: the outputs reuse all of it
    assert rec["memory"]["alias_bytes"] > 0
    assert "flops_per_device" not in rec


def test_run_cell_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        D.run_cell("qwen2-1.5b", "decode_32k", False)


def test_run_cell_reduced_with_cost_probe(monkeypatch):
    """A reduced Qwen2 train cell on a fake (2, 4) mesh, both traces."""
    get = registry.get_config
    monkeypatch.setattr(registry, "get_config",
                        lambda arch, **kw: get(arch, reduced=True, **kw))
    monkeypatch.setattr(D, "fake_world", lambda n: M.fake_world(8))
    monkeypatch.setattr(
        D, "make_production_mesh",
        lambda multi_pod=False, device=None: M.make_mesh(
            (2, 4), ("data", "model"), device))
    try:
        rec = D.run_cell("qwen2-1.5b", "train_4k", False, device="cpu",
                         microbatches=2)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rec["status"] == "ok", rec
    assert rec["devices"] == 8 and rec["microbatches"] == 2
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["alias_bytes"] > 0               # the donated train state
    assert rec["flops_per_device"] > 0
    assert rec["flops_per_device"] == rec["matmul_flops_per_device"]
    colls = rec["collectives"]
    assert sum(colls[op]["count"] for op in D._COLL_OPS) > 0
    assert colls["total_bytes"] > 0


def test_drive_dryrun_one_cell(tmp_path, monkeypatch):
    out = tmp_path / "sweep.jsonl"
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    monkeypatch.setattr(sys, "argv", [
        "drive_dryrun", "--out", str(out), "--archs", "qwen2-1.5b",
        "--shapes", "decode_32k", "--multi-pod-only", "--device", "cpu"])
    drive_dryrun.main()
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 1
    assert recs[0]["status"] == "ok" and recs[0]["devices"] == 512
    assert recs[0]["mesh"] == "2x16x16"


def test_hillclimb_one_cell(tmp_path, monkeypatch):
    out = tmp_path / "perf_log.jsonl"
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    step = ("C", 0, "baseline, one cell", "qwen2-1.5b", "decode_32k", [])
    monkeypatch.setattr(hillclimb, "PLAN", [step])
    monkeypatch.setattr(sys, "argv", ["hillclimb", "--device", "cpu",
                                      "--out", str(out)])
    hillclimb.main()
    rec = json.loads(out.read_text().strip())
    assert rec["status"] == "ok" and rec["cell"] == "C"
    assert rec["hypothesis"] == "baseline, one cell"
    assert rec["flops_per_device"] > 0
    assert rec["collectives"]["total_bytes"] > 0


def test_driver_plans_match_the_reference():
    import repro.launch.drive_dryrun as jdrive
    import repro.launch.hillclimb as jhill
    assert drive_dryrun.ARCH_NAMES == jdrive.ARCH_NAMES
    assert drive_dryrun.SHAPE_NAMES == jdrive.SHAPE_NAMES
    assert hillclimb.PLAN == jhill.PLAN
    assert hillclimb.PLAN_A4 == jhill.PLAN_A4
    assert hillclimb.PLAN_V2_OPT == jhill.PLAN_V2_OPT
