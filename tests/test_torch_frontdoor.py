"""The port's serving front door (``repro_torch.serve.frontdoor``) against
the JAX package's, on the CPU: every test of
``tests/test_serve_frontdoor.py`` run on both packages' deployments
(the reference on its interpreter, the port on ``device="cpu"``) with the
same numpy-seeded rows, each outcome asserted on both and their results
held to each other bit for bit; the scored subscription of
``tests/test_stream_ml.py``; both doors fed one feed, tenant by tenant
(the port under both of its query backends); and the runtime's tick
listeners under the background driver.

The stream's ``rate`` reads the wall clock, so its ``rows_per_second``
is never compared; ``stats()``'s ``*_ms`` fields are times.
"""
import dataclasses
import itertools
import threading
import time
import types

import jax
import numpy as np
import pytest

from repro.core import admin as jadmin
from repro.core.api import default_deployment as jax_deployment
from repro.serve import engine as jengine
from repro.serve import frontdoor as jfd
from repro.stream import durability as jdur
from repro.stream import engine as jstream
from repro.stream import spec as jspec
from repro_torch.core import admin
from repro_torch.core.api import default_deployment
from repro_torch.core.interop import to_numpy
from repro_torch.serve import engine as pengine
from repro_torch.serve import frontdoor as pfd
from repro_torch.stream import compile as qc
from repro_torch.stream import durability as pdur
from repro_torch.stream import engine as pstream
from repro_torch.stream import spec as pspec
from test_torch_support import assert_same, jax_desc

AVG_Q = "bdstream(aggregate(window(fd.s, 8), avg(v)))"

PKGS = {
    "ref": types.SimpleNamespace(
        name="ref", deploy=jax_deployment, fd=jfd, engine=jengine,
        dur=jdur, spec=jspec, StreamEngine=jstream.StreamEngine,
        admin=jadmin, desc=jax_desc),
    "port": types.SimpleNamespace(
        name="port", deploy=lambda: default_deployment(device="cpu"),
        fd=pfd, engine=pengine, dur=pdur, spec=pspec,
        StreamEngine=pstream.StreamEngine, admin=admin, desc=to_numpy),
}


@pytest.fixture(autouse=True)
def _interpreter(monkeypatch):
    """Both packages on their interpreters unless a test says otherwise;
    both doors' query names counted from 0, as in a fresh process."""
    monkeypatch.setenv(qc.BACKEND_ENV, "interpreter")
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.fd, "_SUB_IDS", itertools.count())


def _door(pkg, bd=None, **kwargs):
    bd = bd or pkg.deploy()
    kwargs.setdefault("stream_engine", "streamstore0")
    cfg = kwargs.pop("config", pkg.engine.ServeConfig(streams=(
        pkg.spec.StreamSpec("fd.s", ("ts", "v"), capacity=128),)))
    return bd, pkg.fd.FrontDoor(bd, cfg, **kwargs)


def _feed(bd, stream, n=8, base=0.0):
    stream.append({"ts": np.arange(float(n)) + base,
                   "v": np.arange(float(n)) + base})
    return bd.streams.tick()


def _both(scenario, *args):
    """``scenario(pkg, *args)`` on each package: {name: outcome}."""
    return {name: scenario(pkg, *args) for name, pkg in PKGS.items()}


def _same_results(ref, port, path="results"):
    """Two packages' [(tick, value)] lists equal bit for bit."""
    assert [t for t, _ in ref] == [t for t, _ in port], path
    for (tick, a), (_, b) in zip(ref, port):
        assert_same(jax_desc(a), to_numpy(b), path=f"{path}[{tick}]")


# -- session & subscription lifecycle -----------------------------------------
def test_config_streams_are_registered_via_specs():
    def scenario(pkg):
        bd, door = _door(pkg)
        stream = bd.engines["streamstore0"].get("fd.s")
        assert stream.capacity == 128
        assert stream.spec == door.config.streams[0]
        return dataclasses.asdict(stream.spec)
    out = _both(scenario)
    assert out["ref"] == out["port"]
    # the reference's fields, less the KV knob nothing reads (ROADMAP §3)
    fields = [f.name for f in dataclasses.fields(pengine.ServeConfig)]
    assert fields == [f.name for f in dataclasses.fields(jengine.ServeConfig)
                      if f.name != "quantize_kv_between_waves"]
    assert pengine.ServeConfig(streams=[]).streams == ()


def test_serve_config_rejects_non_spec_streams():
    def scenario(pkg):
        with pytest.raises(TypeError) as exc:
            pkg.fd.FrontDoor(pkg.deploy(), pkg.engine.ServeConfig(
                streams=({"name": "x"},)), stream_engine="streamstore0")
        return str(exc.value)
    out = _both(scenario)
    assert out["ref"] == out["port"]


def test_open_session_is_idempotent_per_tenant():
    def scenario(pkg):
        _, door = _door(pkg)
        assert door.open_session("a") is door.open_session("a")
        return door.stats()["tenants"]
    assert _both(scenario) == {"ref": 1, "port": 1}


def test_close_session_releases_query_and_capacity():
    def scenario(pkg):
        bd, door = _door(pkg, max_tenants=1)
        session = door.open_session("a")
        session.subscribe(AVG_Q)
        before = door.stats()["shared_queries"]
        session.close()
        after = door.stats()
        assert not bd.streams.queries          # CQ deregistered
        door.open_session("b")                 # capacity freed
        return before, after["tenants"], after["shared_queries"]
    assert _both(scenario) == {"ref": (1, 0, 0), "port": (1, 0, 0)}


# -- admission control --------------------------------------------------------
def test_admission_rejects_over_max_tenants():
    def scenario(pkg):
        _, door = _door(pkg, max_tenants=2)
        door.open_session("a")
        door.open_session("b")
        with pytest.raises(pkg.fd.AdmissionError, match="max_tenants") \
                as exc:
            door.open_session("c")
        return str(exc.value), door.stats()["admission_rejects"]
    out = _both(scenario)
    assert out["ref"] == out["port"] and out["port"][1] == 1


def test_admission_rejects_over_per_tenant_queries():
    def scenario(pkg):
        _, door = _door(pkg, max_queries_per_tenant=1)
        session = door.open_session("a")
        session.subscribe(AVG_Q)
        with pytest.raises(pkg.fd.AdmissionError,
                           match="max_queries_per_tenant") as exc:
            session.subscribe(AVG_Q, every_n_ticks=2)
        return str(exc.value)
    out = _both(scenario)
    assert out["ref"] == out["port"]


def test_load_circuit_breaker_from_monitor_drops():
    """The breaker reads the Monitor's stream block: once the standing
    queries have visibly lost rows to ring overflow, new admissions are
    refused until the operator re-arms."""
    def scenario(pkg):
        bd, door = _door(pkg, config=pkg.engine.ServeConfig(streams=(
            pkg.spec.StreamSpec("fd.s", ("ts", "v"), capacity=4,
                                rolling=False),)), admit_max_dropped=0)
        session = door.open_session("a")
        session.subscribe("bdstream(snapshot(fd.s))")
        stream = bd.engines["streamstore0"].get("fd.s")
        stream.append({"ts": np.arange(16.), "v": np.arange(16.)})
        bd.streams.tick()                  # stream_stats sees the drops
        msgs = []
        with pytest.raises(pkg.fd.AdmissionError, match="dropped") as exc:
            door.open_session("b")
        msgs.append(str(exc.value))
        with pytest.raises(pkg.fd.AdmissionError, match="dropped") as exc:
            session.subscribe("bdstream(rate(fd.s))")
        msgs.append(str(exc.value))
        door.reset_admission()             # incident over
        door.open_session("b")
        return msgs, door.stats()["admission_rejects"]
    out = _both(scenario)
    assert out["ref"] == out["port"]


# -- backpressure -------------------------------------------------------------
def test_slow_consumer_drops_oldest_results_only():
    def scenario(pkg):
        bd, door = _door(pkg, result_buffer=3)
        sub = door.open_session("a").subscribe(AVG_Q)
        stream = bd.engines["streamstore0"].get("fd.s")
        for i in range(5):
            _feed(bd, stream, base=8.0 * i)
        assert sub.pending == 3 and sub.dropped == 2
        results = sub.poll()
        # the *newest* three survived, in order
        assert [tick for tick, _ in results] == [3, 4, 5]
        assert door.stats()["results_dropped"] == 2
        assert sub.poll() == []            # drained
        return results
    out = _both(scenario)
    _same_results(out["ref"], out["port"])


# -- bit-identity & warm sharing ----------------------------------------------
def test_front_door_results_bit_identical_to_direct():
    """Every result a tenant receives through the front door is bitwise
    what a directly registered continuous query produces for the same
    BQL and ticks, and the port's are the reference's."""
    def scenario(pkg):
        bd, door = _door(pkg)
        sub_a = door.open_session("a").subscribe(AVG_Q)
        sub_b = door.open_session("b").subscribe(AVG_Q)
        direct = bd.streams.register_continuous(AVG_Q, name="direct")
        stream = bd.engines["streamstore0"].get("fd.s")
        want = []
        for i in range(4):
            ran = dict(_feed(bd, stream, base=8.0 * i))
            want.append((i + 1, ran["direct"].value))
        got_a, got_b = sub_a.poll(), sub_b.poll()
        assert len(got_a) == 4
        for (ta, a), (tb, b), (tw, w) in zip(got_a, got_b, want):
            assert ta == tb == tw and a is b   # one object, two tenants
            assert_same(pkg.desc(w), pkg.desc(a))
        return got_a
    out = _both(scenario)
    _same_results(out["ref"], out["port"])


def test_identical_subscriptions_share_one_execution():
    def scenario(pkg):
        bd, door = _door(pkg)
        subs = [door.open_session(f"t{i}").subscribe(AVG_Q)
                for i in range(4)]
        st = door.stats()
        assert st["shared_queries"] == 1 and st["shared_attaches"] == 3
        stream = bd.engines["streamstore0"].get("fd.s")
        _feed(bd, stream)
        _feed(bd, stream, base=8.0)
        (cq,) = bd.streams.queries.values()
        assert cq.executions == 2          # one per tick, not per tenant
        assert cq.cache_hits >= 1          # warm plan cache after tick 1
        assert all(len(s.poll()) == 2 for s in subs)
        # a different cadence is a different execution
        door.open_session("t0").subscribe(AVG_Q, every_n_ticks=2)
        assert door.stats()["shared_queries"] == 2
        return cq.name, sorted(bd.streams.queries)
    out = _both(scenario)
    # one counter numbers queries and subscriptions: fd0, subs 1-4, fd5
    assert out["ref"] == out["port"] == ("fd0", ["fd0", "fd5"])


def test_close_stops_fanout_and_deregisters():
    def scenario(pkg):
        bd, door = _door(pkg)
        sub = door.open_session("a").subscribe(AVG_Q)
        stream = bd.engines["streamstore0"].get("fd.s")
        _feed(bd, stream)
        door.close()
        door.close()                       # idempotent
        _feed(bd, stream, base=8.0)
        assert not bd.streams.queries
        return len(sub.poll())             # nothing delivered post-close
    assert _both(scenario) == {"ref": 1, "port": 1}


# -- replica fan-out ----------------------------------------------------------
def test_replica_copy_leaves_primary_and_serves_reads(tmp_path):
    def scenario(pkg):
        bd, door = _door(pkg, config=pkg.engine.ServeConfig(streams=(
            pkg.spec.StreamSpec(
                "fd.s", ("ts", "v"), capacity=128,
                sharding=pkg.spec.Sharding(shards=2),
                durability=pkg.spec.Durability(str(tmp_path / pkg.name))),
        )))
        stream = bd.engines["streamstore0"].get("fd.s")
        stream.append({"ts": np.arange(16.), "v": np.arange(16.)})
        (rname,) = door.replicate("fd.s", n=1)
        assert rname == "fd.s.replica0"
        assert bd.engines["streamstore0"].get("fd.s") is stream
        # the replica serves the window read, bitwise the primary's
        got = door.open_session("a").read("fd.s", 4)
        assert_same(pkg.desc(stream.window(4)), pkg.desc(got))
        stream._durable.close()
        return got
    out = _both(scenario)
    assert_same(jax_desc(out["ref"]), to_numpy(out["port"]))


def _denamed(fp):
    fp = dict(fp)
    fp.pop("name", None)
    if "shards" in fp:
        fp["shards"] = [dict(d, name=None) for d in fp["shards"]]
    return fp


def test_replica_catch_up_from_segment_log(tmp_path):
    def scenario(pkg):
        bd, door = _door(pkg, config=pkg.engine.ServeConfig(streams=(
            pkg.spec.StreamSpec(
                "fd.s", ("ts", "v"), capacity=256,
                sharding=pkg.spec.Sharding(shards=2, block_rows=8),
                durability=pkg.spec.Durability(str(tmp_path / pkg.name))),
        )))
        primary = bd.engines["streamstore0"].get("fd.s")
        primary.append({"ts": np.arange(24.), "v": np.arange(24.)})
        door.replicate("fd.s", n=2)
        # the primary moves on; replicas are stale until refreshed
        primary.append({"ts": np.arange(24., 48.),
                        "v": np.arange(24., 48.)})
        rows = door.refresh_replicas("fd.s")
        assert set(rows) == {"fd.s.replica0", "fd.s.replica1"}
        assert all(n == 24 for n in rows.values())
        want = _denamed(pkg.dur.fingerprint(primary))
        for i in range(2):
            (replica,) = [e.get(f"fd.s.replica{i}")
                          for e in bd.engines.values()
                          if isinstance(e, pkg.StreamEngine)
                          and e.has(f"fd.s.replica{i}")]
            assert _denamed(pkg.dur.fingerprint(replica)) == want
        # refresh again: incremental, nothing to replay
        again = door.refresh_replicas("fd.s")
        assert all(n == 0 for n in again.values())
        primary._durable.close()
        return rows, want
    out = _both(scenario)
    assert out["ref"] == out["port"]


def test_refresh_replicas_requires_durability():
    def scenario(pkg):
        bd, door = _door(pkg)
        stream = bd.engines["streamstore0"].get("fd.s")
        stream.append({"ts": np.arange(8.), "v": np.arange(8.)})
        door.replicate("fd.s", n=1)
        with pytest.raises(pkg.fd.AdmissionError, match="durability") \
                as exc:
            door.refresh_replicas("fd.s")
        return str(exc.value)
    out = _both(scenario)
    assert out["ref"] == out["port"]


# -- serve stats surfacing ----------------------------------------------------
def test_serve_stats_flow_to_monitor_and_admin_status():
    def scenario(pkg):
        bd, door = _door(pkg)
        door.open_session("a").subscribe(AVG_Q)
        stream = bd.engines["streamstore0"].get("fd.s")
        _feed(bd, stream)
        snap = bd.monitor.snapshot()["serve_stats"]
        assert snap["tenants"] == 1 and snap["results_delivered"] == 1
        st = pkg.admin.status(bd)
        assert st["serve"]["subscriptions"] == 1
        assert st["serve"]["p99_tick_ms"] >= 0.0
        return {k: v for k, v in st["serve"].items()
                if not k.endswith("_ms")}
    out = _both(scenario)
    assert out["ref"] == out["port"]


# -- Scheduler close: idempotent + atexit -------------------------------------
def test_scheduler_close_is_idempotent_and_releases_port():
    import socket

    for pkg in PKGS.values():
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        session = types.SimpleNamespace(
            scfg=pkg.engine.ServeConfig(metrics_port=port))
        sched = pkg.engine.Scheduler(session)
        assert sched._metrics_server is not None
        sched.close()
        sched.close()                      # a second close is a no-op,
        sched.close()                      # not a hang
        assert sched._metrics_server is None
        # the socket is released: the port binds again at once
        probe = socket.socket()
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        probe.bind(("127.0.0.1", port))
        probe.close()


def test_scheduler_close_unregisters_atexit_hook():
    import atexit

    for pkg in PKGS.values():
        session = types.SimpleNamespace(
            scfg=pkg.engine.ServeConfig(metrics_port=0))
        # metrics_port=0 binds an ephemeral port; a Scheduler without a
        # port registers no hook
        none_session = types.SimpleNamespace(
            scfg=pkg.engine.ServeConfig(metrics_port=None))
        sched_none = pkg.engine.Scheduler(none_session)
        sched_none.close()                 # idempotent without a server
        sched_none.close()
        sched = pkg.engine.Scheduler(session)
        sched.close()
        # re-registering after close must not resurrect the old server
        assert sched._metrics_server is None
        atexit.unregister(sched.close)     # harmless either way


# -- the ml island behind the door ---------------------------------------------
def test_frontdoor_scored_subscription_matches_direct():
    """Two tenants on one scored query: bitwise the direct standing
    query's scores in each package, one shared execution; the port, on
    the reference's params carried across into its island's cache, within
    2e-3 relative of the reference (its jitted forward keeps bf16
    intermediates in float32: tests/test_torch_stream_ml.py)."""
    from repro.models import registry as jreg
    from repro.sharding import logical as JL
    from repro_torch.models import convert, registry
    from repro_torch.stream import ml

    arch, w = "qwen2-1.5b", 16
    rng = np.random.default_rng(5)
    rows = {"ts": np.arange(float(w)),
            "hr": 70 + 8 * np.sin(np.arange(w) / 3)
            + rng.standard_normal(w)}
    q = f"bdml(infer(window(vitals.hr, {w}), models.lm))"

    def scenario(pkg):
        bd = pkg.deploy()
        bd.register_model("lm")
        door = pkg.fd.FrontDoor(bd, pkg.engine.ServeConfig(streams=(
            pkg.spec.StreamSpec("vitals.hr", ("ts", "hr"), capacity=64),)),
            stream_engine="streamstore0")
        sub_a = door.open_session("a").subscribe(q)
        sub_b = door.open_session("b").subscribe(q)
        direct = bd.register_continuous(q, name="direct")
        bd.engines["streamstore0"].get("vitals.hr").append(rows)
        bd.streams.tick()
        got_a, got_b = sub_a.poll(), sub_b.poll()
        assert len(got_a) == 1 and len(got_b) == 1
        want = pkg.desc(direct.last_value)["columns"]["score"]
        for got in (got_a, got_b):
            np.testing.assert_array_equal(
                pkg.desc(got[0][1])["columns"]["score"], want)
        assert door.stats()["shared_queries"] == 1
        door.close()
        return want

    jcfg = jreg.get_config(arch, reduced=True)
    jparams = JL.init_params(jax.random.PRNGKey(0), jreg.param_specs(jcfg))
    key = (arch, 0, "cpu")
    saved = ml._LOADED.pop(key, None)
    ml._LOADED[key] = ml._Loaded(
        cfg=registry.get_config(arch, reduced=True),
        params=convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"))
    try:
        out = _both(scenario)
    finally:
        ml._LOADED.pop(key)
        if saved is not None:
            ml._LOADED[key] = saved
    assert out["ref"].dtype == out["port"].dtype
    np.testing.assert_allclose(out["port"], out["ref"], rtol=2e-3)


# -- both doors on one feed ------------------------------------------------------
WAVE = "icu.wave"
MINUTE = 16
DOOR_QUERIES = {
    "max_hr": (f"bdstream(aggregate(window({WAVE}, {4 * MINUTE}),"
               " max(hr)))", 1),
    "min_signal": (f"bdstream(aggregate(window({WAVE}, {MINUTE}),"
                   " min(signal)))", 1),
    "wave_avg": (f"bdarray(aggregate(bdcast(bdstream(window({WAVE},"
                 f" {MINUTE})), w_arr, '<signal:double>[tick=0:"
                 f"{MINUTE - 1},{MINUTE},0]', array), avg(signal)))", 1),
    "sliding": (f"bdstream(window({WAVE}, {MINUTE}, {MINUTE // 2}))", 3),
    "rate": (f"bdstream(rate({WAVE}))", 2),
    "join": ("bdstream(join(ewindow(icu.abp, 8), ewindow(icu.ecg, 8),"
             " on=ts, tol=0.5))", 2),
}


def _feed_rows(seed, batches=12):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(batches):
        t = b * MINUTE + np.arange(MINUTE, dtype=np.float64)
        out.append((
            {"signal": np.sin(t / 5) + 0.05 * rng.standard_normal(MINUTE),
             "hr": 75 + rng.standard_normal(MINUTE)},
            {"ts": t[rng.permutation(MINUTE)], "abp": 90
             + rng.standard_normal(MINUTE)},
            {"ts": t + 0.25, "ecg": rng.standard_normal(MINUTE)}))
    return out


def _door_feed(pkg, batches, tenants=6, buffer=4):
    """Tenant i subscribes every query whose index is not i mod 3; the
    last tenant never polls.  Per tenant and query the (tick, value)
    sequence it received, the door's stats and its query names."""
    spec = pkg.spec
    door_cfg = pkg.engine.ServeConfig(streams=(
        spec.StreamSpec(WAVE, ("signal", "hr"), capacity=8 * MINUTE),
        spec.StreamSpec("icu.abp", ("ts", "abp"), capacity=8 * MINUTE,
                        event_time=spec.EventTime("ts", max_delay=MINUTE)),
        spec.StreamSpec("icu.ecg", ("ts", "ecg"), capacity=8 * MINUTE,
                        event_time=spec.EventTime("ts", max_delay=MINUTE))))
    bd = pkg.deploy()
    door = pkg.fd.FrontDoor(bd, door_cfg, stream_engine="streamstore0",
                            result_buffer=buffer)
    subs = {}
    for i in range(tenants):
        session = door.open_session(f"tenant{i}")
        for j, (name, (q, every)) in enumerate(DOOR_QUERIES.items()):
            if j % 3 != i % 3:
                subs[(i, name)] = session.subscribe(q, every)
    got = {key: [] for key in subs}
    engine = bd.engines["streamstore0"]
    for wave, abp, ecg in batches:
        engine.get(WAVE).append(wave)
        engine.get("icu.abp").append(abp)
        engine.get("icu.ecg").append(ecg)
        bd.streams.tick()
        for (i, name), sub in subs.items():
            if i != tenants - 1:
                got[(i, name)] += sub.poll()
    for (i, name), sub in subs.items():
        if i == tenants - 1:
            got[(i, name)] = sub.poll() + [("dropped", sub.dropped)]
    stats = {k: v for k, v in door.stats().items() if not k.endswith("_ms")}
    names = sorted(bd.streams.queries)
    door.close()
    return got, stats, names


@pytest.mark.parametrize("backend", ["interpreter", "jit"])
def test_both_front_doors_deliver_the_same_results(backend, monkeypatch):
    """Both packages' doors, fed the same batches with the same tenants
    and subscriptions, hand every tenant bitwise-equal (tick, value)
    sequences (the idle tenant the same survivors and losses), name their
    shared queries alike and report equal stats but for times.  The
    array island's float32 mean sums in another order than XLA's, so it
    is held to 1e-6 relative (``assert_same``'s ``sum_tol``)."""
    batches = _feed_rows(7)
    ref = _door_feed(PKGS["ref"], batches)
    monkeypatch.setenv(qc.BACKEND_ENV, backend)
    qc.reset_stats()
    port = _door_feed(PKGS["port"], batches)
    assert qc.stats()["fallbacks"] == 0
    assert ref[1] == port[1] and ref[2] == port[2]
    assert ref[1]["results_dropped"] > 0
    assert list(ref[0]) == list(port[0])
    for key in ref[0]:
        if key[1] == "rate":
            for seq in (ref[0][key], port[0][key]):
                for i, (t, v) in enumerate(seq):
                    if t != "dropped":
                        seq[i] = (t, type(v)({
                            k: c for k, c in v.columns.items()
                            if k != "rows_per_second"}))
        want, have = ref[0][key], port[0][key]
        assert [t for t, _ in want] == [t for t, _ in have], key
        for (t, a), (_, b) in zip(want, have):
            if t == "dropped":
                assert a == b, key
            else:
                assert_same(jax_desc(a), to_numpy(b), path=f"{key}@{t}",
                            sum_tol=("avg_signal",))


# -- tick listeners ---------------------------------------------------------------
@pytest.mark.parametrize("pkg_name", ["ref", "port"])
def test_listeners_fire_under_the_background_driver(pkg_name):
    """A listener sees every tick, cooperative or driven by ``start()``,
    in order, with the queries that ran; a raising listener is counted
    and recorded and breaks neither the tick nor the other listener; a
    removed listener hears nothing more."""
    pkg = PKGS[pkg_name]
    bd = pkg.deploy()
    bd.register_stream("streamstore0", pkg.spec.StreamSpec(
        "l.s", ("v",), capacity=64))
    bd.register_continuous("bdstream(snapshot(l.s))", name="snap")
    bd.engines["streamstore0"].get("l.s").append({"v": np.arange(4.)})
    seen = []

    def listen(tick_no, ran):
        seen.append((tick_no, [name for name, _ in ran],
                     threading.current_thread() is threading.main_thread()))

    def boom(tick_no, ran):
        raise RuntimeError(f"boom {tick_no}")

    bd.streams.add_tick_listener(boom)
    bd.streams.add_tick_listener(listen)
    bd.streams.add_tick_listener(listen)       # added once
    bd.streams.tick()
    bd.streams.start(interval_seconds=0.005)
    try:
        deadline = time.monotonic() + 10.0
        while (len(seen) < 4 and time.monotonic() < deadline):
            time.sleep(0.005)
    finally:
        assert bd.streams.stop()
    st = bd.streams.status()["background"]
    assert st["driver_errors"] == 0 and bd.streams.driver_ticks >= 3
    ticks = bd.streams.ticks
    assert [t for t, _, _ in seen] == list(range(1, ticks + 1))
    assert all(names == ["snap"] for _, names, _ in seen)
    assert seen[0][2] and not any(main for _, _, main in seen[1:])
    assert bd.streams.listener_errors == ticks
    assert bd.streams.last_listener_error == f"RuntimeError: boom {ticks}"
    assert bd.streams.queries["snap"].executions == ticks
    bd.streams.remove_tick_listener(listen)
    bd.streams.remove_tick_listener(listen)    # absent: a no-op
    bd.streams.tick()
    assert len(seen) == ticks
    assert bd.streams.listener_errors == ticks + 1
