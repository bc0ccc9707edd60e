"""The port's compiled standing-query backend (``REPRO_QUERY_BACKEND=jit``,
``repro_torch.stream.compile``) against the JAX package's interpreter,
on the CPU: every op of the compiled family (``repro/stream/compile.py``
module docstring) must give the interpreter's values, dtypes, column
order, error strings and ``JOIN_STATS`` deltas, bit for bit.  The
reference's own jit backend cannot run under the installed jax (its
``enable_x64`` import fails), so the reference runs its interpreter.

Also covered: the plan cache, the fallback taxonomy (out-of-family ops
bump ``interpreted``; non-finite join keys are the one data-driven
fallback) and the port's departure from the reference — any other error
inside a compiled plan, such as a kernel that fails, leaves
``maybe_execute`` instead of becoming a fallback.
"""
import warnings

import numpy as np
import pytest

from repro.core.api import default_deployment as jax_deployment
from repro.stream import shim as jshim
from repro_torch.core.api import default_deployment
from repro_torch.core.interop import to_numpy
from repro_torch.kernels.stream import ops
from repro_torch.kernels.stream import stream as k
from repro_torch.stream import compile as qc
from repro_torch.stream import shim
from test_torch_support import assert_same, jax_desc


@pytest.fixture(autouse=True)
def _fresh_stats():
    qc.reset_stats()
    yield
    qc.reset_stats()


def _feed(bd, rng):
    """The op-family zoo of tests/test_stream_compile.py: a plain stream,
    an event-time stream, and a 2-shard colocated event-time pair."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        p = bd.register_stream("streamstore0", "c.p", ("v", "w"),
                               capacity=256)
        s = bd.register_stream("streamstore0", "c.s", ("ts", "x"),
                               capacity=256, ts_field="ts", max_delay=0.0)
        a = bd.register_stream("streamstore0", "c.a", ("ts", "x"),
                               capacity=256, ts_field="ts", max_delay=0.0,
                               shards=2, num_engines=2)
        b = bd.register_stream("streamstore0", "c.b", ("ts", "y"),
                               capacity=256, ts_field="ts", max_delay=0.0,
                               shards=2, num_engines=2)
    n = 96
    p.append({"v": rng.normal(size=n), "w": rng.normal(size=n)})
    ts = np.sort(rng.uniform(0, 50, size=n))
    s.append({"ts": ts, "x": rng.normal(size=n)})
    s.flush()
    a.append({"ts": ts, "x": rng.normal(size=n)})
    b.append({"ts": ts + rng.uniform(-0.2, 0.2, size=n),
              "y": rng.normal(size=n)})
    a.flush()
    b.flush()
    return bd


def _pair(seed):
    return (_feed(jax_deployment(), np.random.default_rng(seed)),
            _feed(default_deployment(device="cpu"),
                  np.random.default_rng(seed)))


_FAMILY = [
    "window(c.p, 32)",
    "window(c.p, 32, 8)",
    "ewindow(c.s, 10, 5)",
    "aggregate(window(c.p, 16), sum(v))",
    "aggregate(window(c.p, 16), avg(v))",
    "aggregate(window(c.p, 16), min(v))",
    "aggregate(window(c.p, 16), max(v))",
    "aggregate(window(c.p, 16), count(*))",
    "aggregate(window(c.p, 32, 8), max(w))",
    "aggregate(ewindow(c.s, 10, 5), sum(x))",
    "join(ewindow(c.s, 20, 10), ewindow(c.s, 20, 10), on=ts, tol=0.5)",
    "join(ewindow(c.a, 20, 10), ewindow(c.b, 20, 10), on=ts, tol=0.25)",
    "join(window(c.p, 32), window(c.p, 64), on=v, tol=0.3)",
]


def _run(bd, query, backend, monkeypatch):
    monkeypatch.setenv(qc.BACKEND_ENV, backend)
    return bd.query(f"bdstream({query})").value


@pytest.mark.parametrize("query", _FAMILY)
def test_jit_matches_reference_interpreter(query, monkeypatch):
    jbd, bd = _pair(7)
    ref = jax_desc(_run(jbd, query, "interpreter", monkeypatch))
    before = dict(shim.JOIN_STATS)
    interp = to_numpy(_run(bd, query, "interpreter", monkeypatch))
    mid = dict(shim.JOIN_STATS)
    got = to_numpy(_run(bd, query, "jit", monkeypatch))
    after = dict(shim.JOIN_STATS)
    assert_same(ref, interp)
    assert_same(ref, got)
    st = qc.stats()
    assert st["fallbacks"] == 0 and st["executions"] == 1, st
    for key in before:
        assert after[key] - mid[key] == mid[key] - before[key], key
    if query.startswith("join"):
        assert after["joins"] == mid["joins"] + 1


def test_jit_results_are_canonical_float32(monkeypatch):
    _, bd = _pair(8)
    out = _run(bd, "window(c.p, 32, 8)", "jit", monkeypatch)
    assert out.dim_names == ("window", "tick")
    assert {str(v.dtype) for v in out.attrs.values()} == {"torch.float32"}
    assert tuple(out.attrs["v"].shape) == ((96 - 32) // 8 + 1, 32)


def test_plan_cache_hits_on_second_execution(monkeypatch):
    _, bd = _pair(8)
    monkeypatch.setenv(qc.BACKEND_ENV, "jit")
    bd.query("bdstream(window(c.p, 32))")
    st = qc.stats()
    assert st["compiles"] == 1 and st["cache_hits"] == 0
    bd.query("bdstream(window(c.p, 32))")
    bd.query("bdstream(window(c.p,   32))")   # normalized: same plan
    st = qc.stats()
    assert st["compiles"] == 1 and st["cache_hits"] == 2


def test_out_of_family_ops_stay_interpreted(monkeypatch):
    _, bd = _pair(9)
    monkeypatch.setenv(qc.BACKEND_ENV, "jit")
    bd.query("bdstream(snapshot(c.p))")
    bd.query("bdstream(aggregate(window(c.a, 16), max(x)))")
    st = qc.stats()
    assert st["interpreted"] == 1 and st["executions"] == 1
    assert st["fallbacks"] == 0 and st["compiles"] == 1


def test_error_strings_match_reference(monkeypatch):
    jbd = jax_deployment()
    bd = default_deployment(device="cpu")
    msgs = {}
    for name, dep, backend in (("ref", jbd, "interpreter"),
                               ("interpreter", bd, "interpreter"),
                               ("jit", bd, "jit")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            if not dep.engines["streamstore0"].has("c.empty"):
                dep.register_stream("streamstore0", "c.empty", ("v",),
                                    capacity=64)
        monkeypatch.setenv(qc.BACKEND_ENV, backend)
        # the executor wraps the StreamException; the full wrapped
        # string must match, so the underlying messages are identical
        with pytest.raises(Exception) as exc:
            dep.query("bdstream(aggregate(window(c.empty, 16), max(v)))")
        msgs[name] = str(exc.value)
    assert "no complete window of size 16" in msgs["ref"]
    assert msgs["ref"] == msgs["interpreter"] == msgs["jit"]


def test_non_finite_join_keys_fall_back_with_reason(monkeypatch):
    q = "bdstream(join(window(c.nan, 16), window(c.nan, 16), on=t, tol=0.5))"
    t = np.arange(16.0)
    t[3] = np.nan
    values = {}
    for name, dep, backend in (("ref", jax_deployment(), "interpreter"),
                               ("port", default_deployment(device="cpu"),
                                "jit")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            s = dep.register_stream("streamstore0", "c.nan", ("t", "v"),
                                    capacity=64)
        s.append({"t": t, "v": np.arange(16.0)})
        monkeypatch.setenv(qc.BACKEND_ENV, backend)
        values[name] = dep.query(q).value
    assert_same(jax_desc(values["ref"]), to_numpy(values["port"]))
    st = qc.stats()
    # the interpreter's join then evaluates its two window operands,
    # which the compiled path serves
    assert st["fallbacks"] == 1 and st["executions"] == 2
    assert st["fallback_reasons"] == {"non-finite join keys": 1}


def test_a_failing_kernel_leaves_maybe_execute(monkeypatch):
    """No catch-all: an error inside a compiled plan other than the
    data-driven non-finite keys propagates instead of becoming an
    interpreter fallback."""
    _, bd = _pair(10)

    def broken(*args, **kwargs):
        raise RuntimeError("stream join_bounds launch failed: test")

    monkeypatch.setattr(ops, "join_bounds", broken)
    monkeypatch.setenv(qc.BACKEND_ENV, "jit")
    engine = bd.engines["streamstore0"]
    query = "join(ewindow(c.s, 20, 10), ewindow(c.s, 20, 10), on=ts, tol=0.5)"
    with pytest.raises(RuntimeError, match="join_bounds launch failed"):
        qc.maybe_execute(engine, query)
    with pytest.raises(Exception, match="join_bounds launch failed"):
        bd.query(f"bdstream({query})")
    st = qc.stats()
    assert st["fallbacks"] == 0 and st["executions"] == 0


def test_cpu_jit_takes_the_plain_versions(monkeypatch):
    _, bd = _pair(11)
    before = k.launch_counts()
    for query in ("aggregate(window(c.p, 16), max(v))", _FAMILY[10]):
        _run(bd, query, "jit", monkeypatch)
    assert qc.stats()["executions"] == 2
    assert k.launch_counts() == before


def test_backend_env_validation_and_default(monkeypatch):
    monkeypatch.delenv(qc.BACKEND_ENV, raising=False)
    assert qc.backend() == "interpreter"
    monkeypatch.setenv(qc.BACKEND_ENV, "jit")
    assert qc.backend() == "jit"
    monkeypatch.setenv(qc.BACKEND_ENV, "xla")
    assert qc.backend() == "interpreter"


def test_join_stats_counters_are_separate_per_package(monkeypatch):
    jbd, bd = _pair(12)
    jbefore, before = dict(jshim.JOIN_STATS), dict(shim.JOIN_STATS)
    _run(bd, _FAMILY[11], "jit", monkeypatch)
    assert jshim.JOIN_STATS == jbefore
    assert shim.JOIN_STATS["partial_joins"] == before["partial_joins"] + 1
