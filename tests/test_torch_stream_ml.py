"""The port's ml island (``bdml``, ``repro_torch.stream.ml``), twin of
``tests/test_stream_ml.py``: ``infer`` over a gathered window is bitwise
the port's own direct ``registry.forward`` score on the same rows —
plain, sliding, sharded and event-time streams — with one wave per tick,
the params cache, transient incomplete windows, bad arguments, planner
pinning and the Monitor's ``ml`` block.

Against the reference the score is compared on the reference's params
(carried across into the island's cache): the reference scores through
its jitted forward, whose bf16 intermediates XLA keeps in float32, so the
mean NLL is held to 2e-3 relative (the logits differ by up to a few
percent of the largest one, and the NLL averages those differences over
the window's positions).  The reference's durable-replay case waits for
the durability slice; the jax-absent fallback has no counterpart (the
port needs no jax).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.api import default_deployment as jax_deployment
from repro.models import registry as jreg
from repro.sharding import logical as JL
from repro.stream import ml as jml
from repro.stream.spec import StreamSpec as JStreamSpec
from repro_torch.core.api import default_deployment
from repro_torch.core.executor import (DataUnavailableException,
                                       LocalQueryExecutionException)
from repro_torch.models import convert, registry
from repro_torch.sharding import logical as L
from repro_torch.stream import ml
from repro_torch.stream.spec import EventTime, Sharding, StreamSpec

ARCH = "qwen2-1.5b"          # the "lm" alias
W = 16


def direct_score(values, arch=ARCH, seed=0):
    """What the island must match bitwise: quantize the rows, run the
    port's own ``registry.forward`` on params drawn as the island draws
    them, mean next-token NLL in f32."""
    cfg = registry.get_config(arch, reduced=True)
    params = L.init_params(torch.Generator().manual_seed(seed),
                           registry.param_specs(cfg), "cpu")
    toks = ml.quantize(np.asarray(values, np.float64), cfg.vocab_size)
    t = torch.from_numpy(toks[None, :])
    logits, _ = registry.forward(params, {"tokens": t}, cfg)
    logp = torch.log_softmax(logits[0, :-1].float(), -1)
    return -logp.gather(-1, t[0, 1:, None].long())[..., 0].mean()


def _deploy(spec=None):
    bd = default_deployment(device="cpu")
    bd.register_model("lm")
    if spec is not None:
        bd.register_stream("streamstore0", spec)
    return bd


def _rows(n=W, seed=0):
    rng = np.random.default_rng(seed)
    return {"ts": np.arange(float(n)),
            "hr": 70 + 8 * np.sin(np.arange(n) / 3)
            + rng.standard_normal(n)}


def _score(out, i=0):
    return out.columns["score"][i]


# -- bit-identity: infer ≡ direct registry.forward ---------------------------
def test_infer_matches_direct_forward_bitwise():
    bd = _deploy(StreamSpec("vitals.hr", ("ts", "hr"), capacity=64))
    rows = _rows()
    bd.engines["streamstore0"].get("vitals.hr").append(rows)
    out = bd.query(f"bdml(infer(window(vitals.hr, {W}), models.lm))").value
    assert out.columns["score"].dtype == torch.float32
    assert out.columns["window"].dtype == torch.int32
    assert int(out.columns["rows"][0]) == W
    assert torch.equal(_score(out), direct_score(rows["hr"]))


def test_infer_sliding_windows_each_match_direct():
    bd = _deploy(StreamSpec("vitals.hr", ("ts", "hr"), capacity=64))
    rows = _rows(2 * W)
    bd.engines["streamstore0"].get("vitals.hr").append(rows)
    out = bd.query(
        f"bdml(infer(window(vitals.hr, {W}, {W}), models.lm))").value
    assert int(out.columns["window"].shape[0]) == 2
    for i in range(2):
        assert torch.equal(_score(out, i),
                           direct_score(rows["hr"][i * W:(i + 1) * W]))


def test_infer_field_kwarg_and_defaults():
    bd = _deploy(StreamSpec("vitals.hr", ("ts", "hr"), capacity=64))
    rows = _rows()
    bd.engines["streamstore0"].get("vitals.hr").append(rows)
    q = f"bdml(infer(window(vitals.hr, {W}), models.lm, field=%s))"
    explicit = bd.query(q % "hr").value
    default = bd.query(
        f"bdml(infer(window(vitals.hr, {W}), models.lm))").value
    assert torch.equal(_score(explicit), _score(default))
    assert torch.equal(_score(bd.query(q % "ts").value),
                       direct_score(rows["ts"]))


def test_sharded_scores_match_unsharded_bitwise():
    rows = _rows(2 * W, seed=3)
    plain = _deploy(StreamSpec("vitals.hr", ("ts", "hr"), capacity=64))
    plain.engines["streamstore0"].get("vitals.hr").append(rows)
    sharded = _deploy(StreamSpec(
        "vitals.hr", ("ts", "hr"), capacity=64,
        sharding=Sharding(shards=2, num_engines=2)))
    sharded.engines["streamstore0"].get("vitals.hr").append(rows)
    q = f"bdml(infer(window(vitals.hr, {W}, {W}), models.lm))"
    assert torch.equal(plain.query(q).value.columns["score"],
                       sharded.query(q).value.columns["score"])


def test_event_time_window_scores_match_direct():
    bd = _deploy(StreamSpec(
        "icu.abp", ("ts", "abp"), capacity=128,
        event_time=EventTime("ts", max_delay=4.0)))
    s = bd.engines["streamstore0"].get("icu.abp")
    rng = np.random.default_rng(7)
    ts = np.arange(24.0)
    order = np.argsort(ts + rng.uniform(-2, 2, ts.shape[0]))
    s.append({"ts": ts[order], "abp": (80 + ts)[order]})
    s.flush()                              # close every window
    view = bd.query("bdstream(ewindow(icu.abp, 16.0))").value
    out = bd.query("bdml(infer(ewindow(icu.abp, 16.0), models.lm))").value
    assert torch.equal(_score(out), direct_score(
        view.attrs["abp"].numpy().astype(np.float64)))
    ts_view = view.attrs["ts"]
    assert torch.equal(torch.sort(ts_view).values, ts_view)


# -- against the reference ----------------------------------------------------
@pytest.mark.parametrize("slide", [None, W // 2])
def test_scores_match_the_reference_on_its_params(slide):
    """The reference's params in the island's cache, the same rows in both
    deployments: tokens bitwise, scores within 2e-3 relative."""
    jcfg = jreg.get_config(ARCH, reduced=True)
    jparams = JL.init_params(jax.random.PRNGKey(0), jreg.param_specs(jcfg))
    key = (ARCH, 0, "cpu")
    saved = ml._LOADED.pop(key, None)
    ml._LOADED[key] = ml._Loaded(
        cfg=registry.get_config(ARCH, reduced=True),
        params=convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"))
    try:
        rows = _rows(3 * W, seed=13)
        win = f"window(vitals.hr, {W}" + (f", {slide})" if slide else ")")
        q = f"bdml(infer({win}, models.lm))"
        jbd = jax_deployment()
        jbd.register_model("lm")
        jbd.register_stream("streamstore0", JStreamSpec(
            "vitals.hr", ("ts", "hr"), capacity=64))
        jbd.engines["streamstore0"].get("vitals.hr").append(rows)
        bd = _deploy(StreamSpec("vitals.hr", ("ts", "hr"), capacity=64))
        bd.engines["streamstore0"].get("vitals.hr").append(rows)
        want = np.asarray(jbd.query(q).value.columns["score"])
        got = bd.query(q).value.columns["score"].numpy()
        assert want.shape == got.shape and want.dtype == got.dtype
        np.testing.assert_allclose(got, want, rtol=2e-3)
        hr = rows["hr"][-W:]
        np.testing.assert_array_equal(ml.quantize(hr, 256),
                                      jml.quantize(hr, 256))
    finally:
        ml._LOADED.pop(key)
        if saved is not None:
            ml._LOADED[key] = saved


@pytest.mark.parametrize("alias", ["moe", "rwkv6", "mamba"])
def test_family_aliases_score_bitwise_and_as_the_reference(alias):
    """The MoE, RWKV6 and Mamba aliases score through their reduced
    configs (plain attention and scans, as the reference's island runs
    them): bitwise the port's direct forward on the island's own params;
    on the reference's params carried across, within 1e-3 relative of the
    reference's island run eagerly and within 2e-3 of it as it runs
    (compiled).  Where the reference's own two runs part by more than
    that (Jamba's MoE: a router's near-tie that XLA's fused float32 tips
    the other way; ROADMAP.md §3), the port is held to their distance
    plus 1e-3."""
    arch = ml.resolve_arch(alias)
    rows = _rows(2 * W, seed=17)
    q = f"bdml(infer(window(vitals.hr, {W}, {W}), models.{alias}))"
    bd = default_deployment(device="cpu")
    bd.register_model(alias, arch=arch)
    bd.register_stream("streamstore0", StreamSpec("vitals.hr", ("ts", "hr"),
                                                  capacity=64))
    bd.engines["streamstore0"].get("vitals.hr").append(rows)
    got = bd.query(q).value.columns["score"]
    for i in range(2):
        assert torch.equal(got[i], direct_score(
            rows["hr"][i * W:(i + 1) * W], arch=arch))

    jcfg = jreg.get_config(arch, reduced=True)
    jparams = JL.init_params(jax.random.PRNGKey(0), jreg.param_specs(jcfg))
    key = (arch, 0, "cpu")
    saved = ml._LOADED.pop(key)
    ml._LOADED[key] = ml._Loaded(
        cfg=registry.get_config(arch, reduced=True),
        params=convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"))
    try:
        want = {}
        for mode in ("compiled", "eager"):
            jbd = jax_deployment()
            jbd.register_model(alias, arch=arch)
            jbd.register_stream("streamstore0", JStreamSpec(
                "vitals.hr", ("ts", "hr"), capacity=64))
            jbd.engines["streamstore0"].get("vitals.hr").append(rows)
            with jax.disable_jit(mode == "eager"):
                want[mode] = np.asarray(jbd.query(q).value.columns["score"])
        got = bd.query(q).value.columns["score"].numpy()
        np.testing.assert_allclose(got, want["eager"], rtol=1e-3)
        split = np.abs(want["eager"] - want["compiled"])
        bound = np.maximum(2e-3 * np.abs(want["compiled"]),
                           split + 1e-3 * np.abs(want["compiled"]))
        assert (np.abs(got - want["compiled"]) <= bound).all()
    finally:
        ml._LOADED[key] = saved


# -- wave scheduling ----------------------------------------------------------
def test_standing_infer_queries_share_one_wave_per_tick():
    bd = _deploy(StreamSpec("vitals.hr", ("ts", "hr"), capacity=64))
    bd.engines["streamstore0"].get("vitals.hr").append(_rows())
    n = 3
    for i in range(n):
        bd.register_continuous(
            f"bdml(infer(window(vitals.hr, {W}), models.lm))"
            if i == 0 else
            f"bdml(infer(window(vitals.hr, {W}), models.lm, field=hr))",
            name=f"scored{i}")
    s0 = ml.stats()
    ran = bd.streams.tick()
    s1 = ml.stats()
    assert len(ran) == n
    assert s1["waves"] - s0["waves"] == 1
    assert s1["wave_submissions"] - s0["wave_submissions"] == n
    assert s1["infer_executions"] - s0["infer_executions"] == n
    bd.streams.tick()
    assert ml.stats()["waves"] - s1["waves"] == 1


def test_params_cache_shared_across_queries():
    bd = _deploy(StreamSpec("vitals.hr", ("ts", "hr"), capacity=64))
    bd.engines["streamstore0"].get("vitals.hr").append(_rows())
    q = f"bdml(infer(window(vitals.hr, {W}), models.lm))"
    s0 = ml.stats()
    bd.query(q)
    bd.query(q)
    assert ml.stats()["params_cache_hits"] - s0["params_cache_hits"] >= 1
    assert (ARCH, 0, "cpu") in ml._LOADED


# -- failure modes ------------------------------------------------------------
def test_incomplete_window_is_transient():
    bd = _deploy(StreamSpec("vitals.hr", ("ts", "hr"), capacity=64))
    bd.engines["streamstore0"].get("vitals.hr").append(_rows(n=4))
    with pytest.raises(LocalQueryExecutionException) as exc:
        bd.query(f"bdml(infer(window(vitals.hr, {W}), models.lm))")
    assert isinstance(exc.value.__cause__, DataUnavailableException)
    cq = bd.register_continuous(
        f"bdml(infer(window(vitals.hr, {W}), models.lm))", name="scored")
    bd.streams.tick()
    assert cq.errors == 1 and cq.executions == 0
    bd.engines["streamstore0"].get("vitals.hr").append(_rows(n=W))
    bd.streams.tick()
    assert cq.executions == 1               # recovered on the next tick


def test_unknown_model_and_bad_args():
    bd = _deploy(StreamSpec("vitals.hr", ("ts", "hr"), capacity=64))
    bd.engines["streamstore0"].get("vitals.hr").append(_rows())
    with pytest.raises(Exception, match="not registered"):
        bd.query(f"bdml(infer(window(vitals.hr, {W}), models.nope))")
    with pytest.raises(Exception, match="no field"):
        bd.query(f"bdml(infer(window(vitals.hr, {W}), models.lm,"
                 f" field=bogus))")
    with pytest.raises(ml.MLException, match="unknown model"):
        ml.resolve_arch("not-an-arch")
    assert ml.resolve_arch("moe") == "olmoe-1b-7b"
    assert ml.resolve_arch("qwen2-1.5b") == "qwen2-1.5b"
    with pytest.raises(ValueError, match="unsupported ml op"):
        ml.execute_ml(bd.engines["mlhost0"], "predict(x, models.lm)")


@pytest.mark.parametrize("alias,arch", [("audio", "seamless-m4t-medium")])
def test_unported_families_raise(alias, arch):
    bd = _deploy(StreamSpec("vitals.hr", ("ts", "hr"), capacity=64))
    bd.register_model(alias, arch=arch)
    bd.engines["streamstore0"].get("vitals.hr").append(_rows())
    with pytest.raises(LocalQueryExecutionException) as exc:
        bd.query(f"bdml(infer(window(vitals.hr, {W}), models.{alias}))")
    assert isinstance(exc.value.__cause__, NotImplementedError)
    assert "ROADMAP" in str(exc.value.__cause__)


# -- surface ------------------------------------------------------------------
def test_planner_pinning_and_monitor_block():
    bd = _deploy(StreamSpec("vitals.hr", ("ts", "hr"), capacity=64))
    bd.engines["streamstore0"].get("vitals.hr").append(_rows())
    resp = bd.query(f"bdml(infer(window(vitals.hr, {W}), models.lm))")
    # the ml branch pins the read to the model's home engine: one plan
    assert resp.plans_considered == 1
    assert "mlhost0" in resp.qep_id
    bd.streams.tick()
    block = bd.monitor.snapshot()["ml_stats"]
    assert block == ml.stats()
    for key in ("models_loaded", "waves", "windows_scored",
                "infer_executions", "params_cache_hits"):
        assert key in block, key
    assert bd.engines["mlhost0"].kind == "mlserve"
    assert bd.engines["mlhost0"].device == torch.device("cpu")
    isl = bd.catalog.island_by_name("ml")
    assert isl is not None


def test_ml_engines_and_casts_are_the_references():
    """The same engines in the same order, and the same casts (by engine
    name and method), in both deployments once the island is grown."""
    jbd = jax_deployment(stream_engines=2)
    jbd.register_model("lm")
    bd = default_deployment(device="cpu", stream_engines=2)
    bd.register_model("lm")
    assert list(bd.engines) == list(jbd.engines)

    def casts(dep):
        name = {e.eid: e.name for e in dep.catalog.engines.values()}
        return sorted((name[c.src_eid], name[c.dst_eid], c.method)
                      for c in dep.catalog.casts.values())
    assert casts(bd) == casts(jbd)
    bd.ensure_stream_engines(3)
    jbd.ensure_stream_engines(3)
    assert casts(bd) == casts(jbd)

