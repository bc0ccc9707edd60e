"""The port's administrative interface (``repro_torch.core.admin``,
``repro_torch.core.islands``) against the JAX package's, on the CPU:
the tests of ``tests/test_admin_async.py`` and the admin checks of
``tests/test_obs.py``, ``tests/test_stream_sharded.py``,
``tests/test_stream_event_time.py`` and ``tests/test_stream_durability.py``
run on both packages' deployments (the reference on its interpreter, the
port on ``device="cpu"``); ``status()`` of equal deployments; the
islands; every CLI command through ``main([..., "--device", "cpu"])``
against the reference's ``main()`` on the same flags; and the two
example twins.

What is not compared: times (keys holding ``_ms``, ``seconds``,
``rows_per_second``, ``latency``) and the backpressure counted against
them, temporary directories, the ml
island's counters (process-wide in each package: only their keys), and
what the port has no counterpart for (``jax_available`` and the ml
island's ``fallbacks``: the port needs no jax).  The ml demo scores on
the reference's params carried across, within 2e-3 relative (its jitted
forward keeps bf16 intermediates in float32;
tests/test_torch_stream_ml.py).
"""
import dataclasses
import importlib.util
import itertools
import json
import os
import pathlib
import re
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest

from repro.core import admin as jadmin
from repro.core import bql as jbql
from repro.core import islands as jislands
from repro.core.api import default_deployment as jax_deployment
from repro.data import mimic as jmimic
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.serve import engine as jengine
from repro.serve import frontdoor as jfd
from repro.stream import compile as jqc
from repro.stream import ml as jml
from repro.stream import spec as jspec
from repro_torch.core import admin, bql, islands
from repro_torch.core.api import default_deployment
from repro_torch.core.interop import to_numpy
from repro_torch.data import mimic
from repro_torch.obs import metrics, trace
from repro_torch.serve import engine as pengine
from repro_torch.serve import frontdoor as pfd
from repro_torch.stream import compile as qc
from repro_torch.stream import ml
from repro_torch.stream import spec as pspec
from test_torch_support import assert_same, jax_desc

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]

PKGS = {
    "ref": types.SimpleNamespace(
        name="ref", deploy=jax_deployment, admin=jadmin, bql=jbql,
        mimic=jmimic, spec=jspec, fd=jfd, engine=jengine, desc=jax_desc),
    "port": types.SimpleNamespace(
        name="port", deploy=lambda: default_deployment(device="cpu"),
        admin=admin, bql=bql, mimic=mimic, spec=pspec, fd=pfd,
        engine=pengine, desc=to_numpy),
}
# times, and what counts against them (an execution slower than its
# cadence is backpressure)
TIME_KEYS = ("_ms", "seconds", "rows_per_second", "latency",
             "backpressure")
# what only the reference reports: whether jax is importable (the query
# backend's and the ml island's blocks), and the ml island's interpreter
# fallbacks when it is not
REF_ONLY = ("jax_available",)
REF_ONLY_ML = ("jax_available", "fallbacks")


@pytest.fixture(autouse=True)
def _interpreter(monkeypatch):
    """Both packages on their interpreters; counters that both keep
    process-wide start from zero."""
    monkeypatch.setenv(qc.BACKEND_ENV, "interpreter")
    for fd in (jfd, pfd):
        monkeypatch.setattr(fd, "_SUB_IDS", itertools.count())
    jqc.reset_stats()
    qc.reset_stats()


def _both(scenario, *args):
    return {name: scenario(pkg, *args) for name, pkg in PKGS.items()}


def _is_time(key) -> bool:
    return isinstance(key, str) and any(t in key for t in TIME_KEYS)


def assert_same_status(ref, port, path="status", skip=()):
    """The same keys at every level; equal values but for times (whose
    keys are still compared) and the keys in ``skip``."""
    if isinstance(ref, dict):
        ml_block = path.endswith(".ml")
        ref = {k: v for k, v in ref.items()
               if k not in (REF_ONLY_ML if ml_block else REF_ONLY)}
        assert list(ref) == list(port), (path, list(ref), list(port))
        for key in ref:
            if key in skip or ml_block:   # the ml counters are process-wide
                continue
            if _is_time(key):
                if isinstance(ref[key], dict):
                    assert list(ref[key]) == list(port[key]), (path, key)
                continue
            assert_same_status(ref[key], port[key], f"{path}.{key}", skip)
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(port), (path, ref, port)
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_same_status(a, b, f"{path}[{i}]", skip)
    else:
        assert ref == port, (path, ref, port)


def _mimic(pkg):
    bd = pkg.deploy()
    pkg.mimic.load_mimic_demo(bd, num_patients=32, num_orders=128)
    return bd


# -- tests/test_admin_async.py -------------------------------------------------
def test_admin_status_reports_engines_and_objects():
    def scenario(pkg):
        st = pkg.admin.status(_mimic(pkg))
        assert st["engines"]["hoststore0"]["objects"] >= 2
        assert st["engines"]["hoststore0"]["bytes"] > 0
        assert "relational" in st["islands"]
        assert "densehbm0" in st["islands"]["array"]
        # the v0.1 topology's 5 engines + the streaming island's
        assert st["catalog"]["engines"] == 6
        assert "streaming" in st["islands"]
        assert st["catalog"]["objects"] >= 5
        return st
    out = _both(scenario)
    assert_same_status(out["ref"], out["port"])


def test_admin_start_stop_monitoring_daemon():
    def scenario(pkg):
        bd = _mimic(pkg)
        pkg.admin.start(bd, interval_seconds=0.05)
        assert bd.monitoring_task is not None
        assert pkg.admin.status(bd)["monitor"]["monitoring_task_running"]
        bd.engines["hoststore0"].record("probe", 0.001)
        deadline = time.monotonic() + 5.0
        while (bd.monitoring_task.ticks < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)               # let the daemon tick
        assert bd.monitoring_task.ticks >= 1
        pkg.admin.stop(bd)
        assert bd.monitoring_task is None
        pkg.admin.stop(bd)                 # stopping twice is a no-op
        return pkg.admin.status(bd)["monitor"]["monitoring_task_running"]
    assert _both(scenario) == {"ref": False, "port": False}


def test_execute_plan_async_returns_future():
    def scenario(pkg):
        bd = _mimic(pkg)
        root = pkg.bql.parse(
            "bdrel(select * from mimic2v26.d_patients limit 3)")
        plans = bd.planner.enumerate_plans(root)
        res = bd.planner.executor.execute_plan_async(plans[0]).result(
            timeout=30)
        assert res.value.num_rows == 3
        assert res.qep_id == plans[0].qep_id
        return res.value
    out = _both(scenario)
    assert_same(jax_desc(out["ref"]), to_numpy(out["port"]))


def test_async_plans_run_concurrently():
    def scenario(pkg):
        bd = _mimic(pkg)
        root = pkg.bql.parse("bdrel(select poe_id, dose from"
                             " mimic2v26.poe_order where dose > 1)")
        plans = bd.planner.enumerate_plans(root)
        futures = [bd.planner.executor.execute_plan_async(plans[0])
                   for _ in range(4)]
        results = [f.result(timeout=30) for f in futures]
        for r in results[1:]:              # deterministic results
            assert_same(pkg.desc(results[0].value), pkg.desc(r.value))
        return results[0].value
    out = _both(scenario)
    assert_same(jax_desc(out["ref"]), to_numpy(out["port"]))


# -- tests/test_obs.py: status() against background mutation -----------------
def test_status_consistent_while_monitoring_task_mutates():
    """status() renders one Monitor snapshot while the MonitoringTask and
    three producer threads ticking the runtime mutate the live dicts:
    structurally complete, JSON-serializable output every time, with the
    reference's sections."""
    bd = default_deployment(device="cpu")
    mimic.load_mimic_demo(bd, num_patients=32, num_orders=128)
    bd.register_stream("streamstore0", "vitals.stream", ("hr",),
                       capacity=2048)
    bd.register_continuous(
        "bdstream(aggregate(window(vitals.stream, 32), avg(hr)))",
        every_n_ticks=1, name="hr_avg")
    stream = bd.engines["streamstore0"].get("vitals.stream")
    task = bd.start_monitoring(interval_seconds=0.001)
    task.start()
    stop = threading.Event()
    errors = []

    def producer(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                with stream.producer() as p:
                    p.append({"hr": rng.standard_normal(64)})
                bd.streams.tick()
            except Exception as exc:          # noqa: BLE001 — recorded
                errors.append(exc)
                return

    threads = [threading.Thread(target=producer, args=(i,))
               for i in range(3)]
    for t in threads:
        t.start()
    want = list(jadmin.status(jax_deployment()))
    renders = 0
    try:
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            st = admin.status(bd)
            json.dumps(st)                    # serializable mid-mutation
            assert list(st) == want
            assert set(st) == {"engines", "islands", "monitor",
                               "concurrency", "streams", "plan_cache",
                               "catalog", "serve", "ml"}
            assert "watermarks" in st["streams"]
            json.loads(bd.monitor.to_json())
            renders += 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        task.stop()
        bd.monitoring_task = None
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and renders > 0
    assert bd.streams.queries["hr_avg"].executions > 0


# -- tests/test_stream_sharded.py: the rebalance hook, shard status ------------
def test_rebalance_hook_moves_shard_off_lopsided_engine():
    """Skewed shard-key traffic makes the Monitor's per-shard stats
    lopsided; rebalance() moves a shard off the hot engine, then reports
    the stream as skipped rather than thrashing shards."""
    def scenario(pkg):
        bd = pkg.deploy()
        sh = bd.register_stream("streamstore0", "skew.stream",
                                ("patient", "hr"), capacity=2048, shards=4,
                                shard_key="patient", num_engines=2)
        rng = np.random.default_rng(3)
        for _ in range(6):
            patient = np.where(rng.random(128) < 0.9, 1.0,
                               rng.integers(0, 4, 128).astype(float))
            sh.append({"patient": patient,
                       "hr": 75 + rng.standard_normal(128)})
            bd.streams.tick()
        assert bd.monitor.lopsided_shards("skew.stream") == [1]
        outcome = pkg.admin.rebalance(bd)
        assert len(outcome["moves"]) == 1 and not outcome["skipped"]
        assert outcome["moves"][0]["stream"] == "skew.stream"
        engines = [s["engine"] for s in sh.shard_stats().values()]
        assert engines.count(sh.shard_stats()[1]["engine"]) < 3
        again = pkg.admin.rebalance(bd)
        assert again["moves"] == []
        assert [s["stream"] for s in again["skipped"]] == ["skew.stream"]
        return outcome, again, sh.shard_stats()
    out = _both(scenario)
    assert_same_status(out["ref"], out["port"])


def test_status_reports_per_shard_stats():
    def scenario(pkg):
        bd = pkg.deploy()
        sh = bd.register_stream("streamstore0", "vitals.stream", ("hr",),
                                capacity=512, shards=4, num_engines=2,
                                block_rows=4)
        sh.append({"hr": np.arange(64, dtype=float)})
        bd.streams.tick()
        st = pkg.admin.status(bd)
        info = st["streams"]["streams"]["vitals.stream"]
        assert set(info["shards"]) == {0, 1, 2, 3}
        for shard in info["shards"].values():
            assert {"engine", "rows", "appended", "dropped"} <= set(shard)
        assert info["engine"] == ["streamstore0", "streamstore1",
                                  "streamstore0", "streamstore1"]
        assert st["streams"]["background"]["running"] is False
        assert not any("@shard" in name
                       for name in st["streams"]["streams"])
        assert set(bd.monitor.shard_stats["vitals.stream"]) == \
            {0, 1, 2, 3}
        return st
    out = _both(scenario)
    assert_same_status(out["ref"], out["port"])


# -- tests/test_stream_event_time.py, tests/test_stream_durability.py ----------
def test_watermark_surfaced_in_monitor_and_status():
    def scenario(pkg):
        bd = pkg.deploy()
        s = bd.register_stream("streamstore0", "wm.ts", ("ts", "x"),
                               capacity=64, ts_field="ts", max_delay=2.0)
        s.append({"ts": [0.0, 7.0], "x": [0.0, 1.0]})
        bd.streams.tick()
        st = pkg.admin.status(bd)
        info = st["streams"]["streams"]["wm.ts"]
        assert info["watermark"] == 5.0 and info["ts_field"] == "ts"
        assert info["pending"] == 1 and info["late"] == 0
        assert st["streams"]["watermarks"]["wm.ts"]["watermark"] == 5.0
        r = bd.query("bdstream(watermark(wm.ts))")
        assert float(r.value.columns["watermark"][0]) == 5.0
        bd.query("bdstream(flush(wm.ts))")    # punctuation through BQL
        assert s.watermark == 7.0
        with pytest.raises(Exception):
            bd.query("bdstream(watermark(nope.ts))")
        return st
    out = _both(scenario)
    assert_same_status(out["ref"], out["port"])


def test_status_carries_the_durability_block(tmp_path):
    def scenario(pkg):
        bd = pkg.deploy()
        s = bd.register_stream("streamstore0", "vitals.stream",
                               ("patient", "hr"), capacity=1024, shards=2,
                               durability=str(tmp_path / pkg.name),
                               checkpoint_every_rows=200)
        rng = np.random.default_rng(10)
        for _ in range(6):
            s.append({"patient": rng.integers(0, 8, 96).astype(float),
                      "hr": 75 + rng.standard_normal(96)})
            bd.streams.tick()
        s._durable.manager.wait()
        assert s._durable.checkpoints >= 2    # 576 rows / 200 cadence
        stats = bd.monitor.snapshot()["durability_stats"]["vitals.stream"]
        assert stats["log_rows"] == 576 and stats["checkpoints"] >= 2
        st = pkg.admin.status(bd)
        assert "vitals.stream" in st["streams"]["durability"]
        s._durable.close()
        return st
    out = _both(scenario)
    assert_same_status(out["ref"], out["port"], skip=("directory",))


# -- status() of equal deployments ------------------------------------------------
def test_status_of_equal_deployments_matches_the_reference(tmp_path):
    """Both packages' status() over the same deployment (the MIMIC demo,
    a standing query over the waveform feed, a sharded durable stream
    behind a front door with two tenants, a query): the same keys at
    every level, equal values but for times."""
    def scenario(pkg):
        bd = _mimic(pkg)
        bd.register_continuous(
            "bdstream(aggregate(window(mimic2v26.waveform_stream, 64),"
            " max(signal)))", name="peak")
        door = pkg.fd.FrontDoor(bd, pkg.engine.ServeConfig(streams=(
            pkg.spec.StreamSpec(
                "vitals.stream", ("patient", "hr"), capacity=512,
                sharding=pkg.spec.Sharding(shards=2),
                durability=pkg.spec.Durability(str(tmp_path / pkg.name),
                                               checkpoint_every_rows=128)),
        )), stream_engine="streamstore0", result_buffer=2)
        for tenant in ("a", "b"):
            door.open_session(tenant).subscribe(
                "bdstream(aggregate(window(vitals.stream, 32), avg(hr)))")
        vitals = bd.engines["streamstore0"].get("vitals.stream")
        rng = np.random.default_rng(4)
        for info in pkg.mimic.stream_mimic_waveforms(
                bd, batch_rows=64, num_batches=6, capacity=256):
            vitals.append({"patient": rng.integers(0, 8, 48).astype(float),
                           "hr": 75 + rng.standard_normal(48)})
        vitals._durable.manager.wait()
        bd.query("bdrel(select * from mimic2v26.d_patients limit 3)")
        st = pkg.admin.status(bd)
        door.close()
        vitals._durable.close()
        return st
    out = _both(scenario)
    assert out["port"]["serve"]["tenants"] == 2
    assert_same_status(out["ref"], out["port"], skip=("directory",))


# -- islands ---------------------------------------------------------------------
def test_islands_and_validate_result_match_the_reference():
    def type_names(t):
        return tuple(c.__name__ for c in (t if isinstance(t, tuple)
                                          else (t,)))

    assert list(islands.ISLANDS) == list(jislands.ISLANDS)
    for name, want in jislands.ISLANDS.items():
        got = islands.ISLANDS[name]
        assert (got.name, got.data_model, got.operations) == \
            (want.name, want.data_model, want.operations)
        assert type_names(got.result_type) == type_names(want.result_type)
        assert dataclasses.is_dataclass(got) and got.__dataclass_params__ \
            .frozen
    queries = {
        "relational": "bdrel(select * from mimic2v26.d_patients limit 3)",
        "array": "bdarray(filter(myarray, dim1>150))",
        "text": ("bdtext({ 'op' : 'range', 'table' : 'mimic_logs',"
                 " 'range' : { 'start' : ['r_0001','',''],"
                 " 'end' : ['r_0015','',''] } })"),
        "streaming": "bdstream(rate(mimic2v26.waveform_stream))",
    }
    values = {}
    for pkg in PKGS.values():
        bd = _mimic(pkg)
        for _ in pkg.mimic.stream_mimic_waveforms(bd, num_batches=2):
            pass
        values[pkg.name] = {k: bd.query(q).value
                            for k, q in queries.items()}
    for island in jislands.ISLANDS:
        for kind in queries:
            want = jislands.validate_result(island, values["ref"][kind])
            assert islands.validate_result(
                island, values["port"][kind]) == want, (island, kind)
    with pytest.raises(KeyError):
        islands.validate_result("graph", None)


# -- the CLI -----------------------------------------------------------------------
COMMANDS = ("status", "demo-status", "streams", "rebalance", "joins",
            "trace", "metrics", "recover", "serve", "ml")


def _run_ref(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["admin", *argv])
    was_on = jtrace.enabled()
    try:
        jadmin.main()
    finally:
        jtrace.set_enabled(was_on)
    return capsys.readouterr().out


def _run_port(argv, capsys):
    admin.main([*argv, "--device", "cpu"])
    return capsys.readouterr().out


def _last_json(text):
    start = text.rfind("\n{")
    return json.loads(text[start + 1:] if start >= 0 else text)


def _families(text):
    return sorted(line.split()[2] for line in text.splitlines()
                  if line.startswith("# TYPE"))


def _carry_lm_params():
    """The reference's ``lm`` params in the port's island cache."""
    from repro.models import registry as jreg
    from repro.sharding import logical as JL
    from repro_torch.models import convert, registry
    arch = ml.resolve_arch("lm")
    jcfg = jreg.get_config(arch, reduced=True)
    jparams = JL.init_params(jax.random.PRNGKey(0), jreg.param_specs(jcfg))
    key = (arch, 0, "cpu")
    saved = ml._LOADED.pop(key, None)
    ml._LOADED[key] = ml._Loaded(
        cfg=registry.get_config(arch, reduced=True),
        params=convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"))
    return key, saved


@pytest.mark.parametrize("command", COMMANDS)
def test_cli_command_matches_the_reference(command, monkeypatch, capsys,
                                           tmp_path):
    """Each command on the same flags (the defaults, --ticks 8 and
    --tenants 4): every field that is not a time equal."""
    argv = [command]
    if command == "trace":
        argv += ["--out", str(tmp_path / "trace_{}.json")]
    ref_argv, port_argv = list(argv), list(argv)
    if command == "trace":
        ref_argv[-1] = ref_argv[-1].format("ref")
        port_argv[-1] = port_argv[-1].format("port")
    if command == "recover":
        ref_argv += ["--dir", str(tmp_path / "ref")]
        port_argv += ["--dir", str(tmp_path / "port")]
    if command in ("metrics", "trace"):
        jmetrics.reset()
        metrics.reset()
    if command == "ml":
        key, saved = _carry_lm_params()
        before = (jml.stats(), ml.stats())
    try:
        ref = _run_ref(ref_argv, monkeypatch, capsys)
        # the port's trace picks the jit backend itself unless one is set
        monkeypatch.delenv(qc.BACKEND_ENV)
        port = _run_port(port_argv, capsys)
    finally:
        if command == "ml":
            ml._LOADED.pop(key)
            if saved is not None:
                ml._LOADED[key] = saved
    assert qc.BACKEND_ENV not in os.environ
    assert not trace.enabled()
    if command == "metrics":
        want, got = _families(ref), _families(port)
        assert "repro_stream_tick_seconds" in got
        assert want == got, set(want) ^ set(got)
        return
    want, got = _last_json(ref), _last_json(port)
    skip = ()
    if command == "trace":
        # the reference's jit backend cannot run under the installed jax,
        # so its trace holds no compile layer; the port's does
        assert set(got["layers"]) - set(want["layers"]) == {"compile"}
        layers = json.loads(pathlib.Path(port_argv[-1]).read_text())
        assert {e["cat"] for e in layers["traceEvents"]
                if e["ph"] == "X"} == set(got["layers"])
        assert len(got["layers"]) >= 4
        skip = ("layers", "spans", "out", "slow_ops")
    if command == "recover":
        assert got["identical"] is True
        assert got["recovery"]["vitals.stream"]["rows_replayed"] > 0
        skip = ("dir", "directory")
    if command == "ml":
        np.testing.assert_allclose(got["abp_scores"], want["abp_scores"],
                                   rtol=2e-3, atol=1e-4)
        after = (jml.stats(), ml.stats())
        delta = [{k: a[k] - b[k] for k in ml.stats()}
                 for a, b in zip(after, before)]
        loads = [d.pop("models_loaded") + d.pop("params_cache_hits")
                 for d in delta]
        assert delta[0] == delta[1] and loads[0] == loads[1]
        skip = ("abp_scores", "ml")
    if command == "serve":
        assert got["delivered_per_tenant"] == [8] * 4
        assert got["standing_queries"] == ["fd0", "fd4"]
    assert_same_status(want, got, skip=skip)


# -- the example twins ------------------------------------------------------------
def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# lines that print times, or a plan chosen by them
_TIMED = ("ms", "best:", "seconds", "rows_per_second", "backpressure",
          "jax_available")
# the times serve_lm prints at the end of a line that holds more: its
# requests' prefill and decode times, and the run's tokens a second
_TIMES_AT_END = re.compile(r"\s+\(prefill \d+ ms, decode \d+ ms\)$"
                           r"|, [\d.]+ tok/s$")
# the twins handed the reference's parameters (models.convert, from its
# seed-0 init_train_state), so that their greedy tokens and round-trip
# errors can match the reference's
_REFERENCE_PARAMS = {"serve_lm": "qwen2-1.5b",
                     "polystore_tensors": "olmoe-1b-7b"}
# flags both packages' examples take (serve_lm's eager reference decodes
# slowly: three requests of four new tokens)
_FLAGS = {"serve_lm": ["--requests", "3", "--max-new", "4"]}


def _reference_params(arch):
    from repro.models import registry as jregistry
    from repro.train.step import init_train_state as jinit
    from repro_torch.models import convert
    jparams = jinit(jregistry.get_config(arch, reduced=True),
                    jax.random.PRNGKey(0))["params"]
    return convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")


@pytest.mark.parametrize("name", ["quickstart", "streaming_mimic",
                                  "serve_lm", "polystore_tensors"])
def test_example_twin_prints_what_the_reference_prints(name, capsys,
                                                       monkeypatch):
    """Each twin at its own sizes, on the CPU: the same lines as the
    reference's example but for the times and the plan they pick.  The
    reference's serve_lm runs eagerly (``jax.disable_jit()``): its jitted
    bf16 path keeps excess precision, which moves its logits."""
    flags = _FLAGS.get(name, [])
    monkeypatch.setattr(sys, "argv", [name] + flags)   # what argparse reads
    with jax.disable_jit(name == "serve_lm"):
        _example(name).main()
    want = capsys.readouterr().out
    kwargs = ({"params": _reference_params(_REFERENCE_PARAMS[name])}
              if name in _REFERENCE_PARAMS else {})
    _example(f"{name}_torch").main(["--device", "cpu"] + flags, **kwargs)
    got = capsys.readouterr().out

    def kept(text):
        out, closer = [], None
        for line in text.splitlines():
            line = _TIMES_AT_END.sub("", line)
            if closer is not None:        # inside a block of times
                closer = None if line.startswith(closer) else closer
            elif any(t in line for t in _TIMED):
                if line.rstrip().endswith("{"):
                    closer = line[:len(line) - len(line.lstrip())] + "}"
            else:
                out.append(line)
        return out
    assert len(got.splitlines()) == len(want.splitlines()) - (
        name == "streaming_mimic")            # the jax_available line
    assert kept(got) == kept(want)
    assert {"quickstart": "-- catalog",
            "streaming_mimic": "continuity preserved",
            "serve_lm": "kv cache registered",
            "polystore_tensors": "roundtrip_err"}[name] in got
