"""The port's serving engine (``repro_torch.serve.engine``) against the
reference's ``ServeSession`` on the reduced configs: the same params (the
reference's, carried across), the same numpy-seeded prompts of mixed
lengths (left-padded into one wave), greedy decode.

Each step's logits are compared teacher-forced, both sessions fed the
reference's tokens, so one flipped token cannot derail the rest; the
port's greedy token must equal the reference's wherever the reference's
top-2 gap exceeds the tolerance.  Against the reference session run
eagerly (``jax.disable_jit()``) the logits agree to 1e-2 of the largest
one; against the session as the reference runs it (jitted: bf16
intermediates kept in float32 by XLA's fusion) to 5e-2.  See
``tests/test_torch_models.py`` for both tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.serve import engine as jserve
from repro.sharding import logical as JL
from repro_torch import _tree
from repro_torch.models import convert, registry
from repro_torch.obs import trace
from repro_torch.serve import engine as serve
from repro_torch.sharding import logical as L

EAGER_TOL, COMPILED_TOL = 1e-2, 5e-2
CACHE, NEW = 32, 6


def _requests(vocab, seed, n=3):
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 12, n)
    return [(i, rng.integers(0, vocab, int(m)).astype(np.int32))
            for i, m in enumerate(lens)]


def _sessions(arch, seed=0, **overrides):
    jcfg = jreg.get_config(arch, reduced=True, **overrides)
    cfg = registry.get_config(arch, reduced=True, **overrides)
    jparams = JL.init_params(jax.random.PRNGKey(seed),
                             jreg.param_specs(jcfg))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    jsess = jserve.ServeSession(jcfg, jparams, jserve.ServeConfig(
        max_batch=4, cache_len=CACHE, max_new_tokens=NEW))
    sess = serve.ServeSession(cfg, params, serve.ServeConfig(
        max_batch=4, cache_len=CACHE, max_new_tokens=NEW), device="cpu")
    return jsess, sess


def _padded(reqs):
    plen = max(len(p) for _, p in reqs)
    out = np.zeros((len(reqs), plen), np.int32)
    for i, (_, p) in enumerate(reqs):
        out[i, -len(p):] = p
    return out


def _ref_forced(jsess, prompts, toks):
    """The reference session's own jitted prefill/decode, fed ``toks``:
    (B, V) logits of each step."""
    cfg = jsess.cfg
    cache = jreg.init_cache(cfg, prompts.shape[0], jsess.scfg.cache_len)
    batch = {"tokens": jnp.asarray(prompts)}
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = jnp.zeros(
            (prompts.shape[0], cfg.num_prefix_embeds, cfg.d_model))
    logits, cache, extras = jsess._prefill(jsess.params, batch, cache)
    out = [np.asarray(logits[:, -1])]
    pos0 = prompts.shape[1] + (cfg.num_prefix_embeds
                               if cfg.frontend == "vision" else 0)
    for i in range(toks.shape[1] - 1):
        logits, cache = jsess._decode(
            jsess.params, {"tokens": jnp.asarray(toks[:, i:i + 1]),
                           **extras}, cache, jnp.int32(pos0 + i))
        out.append(np.asarray(logits[:, -1]))
    return out


def _port_forced(sess, prompts, toks):
    logits, cache, extras, pos0 = sess.prefill(prompts)
    out = [logits[:, -1].numpy()]
    for i in range(toks.shape[1] - 1):
        logits, cache = sess.decode(toks[:, i], cache, pos0 + i, extras)
        out.append(logits[:, -1].numpy())
    return out


def _run(session, reqs, module):
    return np.stack([c.tokens for c in session.run_wave(
        [module.Request(rid, p, NEW) for rid, p in reqs])])


def _rel(want, got):
    return float(np.max(np.abs(want - got))) / (
        float(np.max(np.abs(want))) + 1e-6)


def _check_steps(want, got, want_toks, tol):
    for i, (w, g) in enumerate(zip(want, got)):
        assert _rel(w, g) <= tol, f"step {i}: {_rel(w, g):.3e}"
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > tol * np.abs(w).max()
        np.testing.assert_array_equal(g.argmax(-1)[clear],
                                      want_toks[clear, i])


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internvl2-2b", "rwkv6-7b",
                                  "jamba-v0.1-52b"])
def test_steps_match_the_eager_reference_session(arch, impl):
    jsess, sess = _sessions(arch, attn_impl=impl)
    reqs = _requests(sess.cfg.vocab_size, 1)
    prompts = _padded(reqs)
    with jax.disable_jit():
        want_toks = _run(jsess, reqs, jserve)
        want = _ref_forced(jsess, prompts, want_toks)
    assert _run(sess, reqs, serve).shape == want_toks.shape
    _check_steps(want, _port_forced(sess, prompts, want_toks), want_toks,
                 EAGER_TOL)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_steps_match_the_compiled_reference_session(impl):
    jsess, sess = _sessions("qwen2-1.5b", seed=2, attn_impl=impl)
    reqs = _requests(sess.cfg.vocab_size, 3, n=4)
    prompts = _padded(reqs)
    want_toks = _run(jsess, reqs, jserve)
    want = _ref_forced(jsess, prompts, want_toks)
    _check_steps(want, _port_forced(sess, prompts, want_toks), want_toks,
                 COMPILED_TOL)


def test_int8_kv_session_matches_the_eager_reference_session():
    jsess, sess = _sessions("qwen2-1.5b", seed=5, kv_cache_dtype="int8")
    reqs = _requests(sess.cfg.vocab_size, 6)
    prompts = _padded(reqs)
    with jax.disable_jit():
        want_toks = _run(jsess, reqs, jserve)
        want = _ref_forced(jsess, prompts, want_toks)
    # the eager reference divides by 127 where the port (as the compiled
    # reference) multiplies by its reciprocal: scales may differ in an ulp
    _check_steps(want, _port_forced(sess, prompts, want_toks), want_toks,
                 EAGER_TOL)


def test_parallel_waves_equal_serial_waves():
    _, sess = _sessions("qwen2-1.5b", seed=7)
    reqs = _requests(sess.cfg.vocab_size, 8, n=10)
    out = {}
    for parallel in (1, 3):
        s = serve.ServeSession(sess.cfg, sess.params, serve.ServeConfig(
            max_batch=4, cache_len=CACHE, max_new_tokens=NEW,
            max_parallel_waves=parallel), device="cpu")
        sched = serve.Scheduler(s)
        for rid, p in reqs:
            sched.submit(serve.Request(rid, p, NEW))
        out[parallel] = sched.run()
    assert [c.rid for c in out[1]] == [c.rid for c in out[3]] == list(
        range(10))
    for a, b in zip(out[1], out[3]):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def _cast_once_session(cfg):
    params = L.init_params(torch.Generator().manual_seed(0),
                           registry.param_specs(cfg), "cpu")
    sess = serve.ServeSession(cfg, params, serve.ServeConfig(
        cache_len=CACHE), device="cpu")
    return params, sess


def _assert_cast_once_bitwise(cfg, params, sess):
    """The session's prefill and decode give the bits of the registry run
    on the float32 params (which casts at every use, as the reference
    does)."""
    prompts = _padded(_requests(cfg.vocab_size, 9))
    logits, cache, _, pos0 = sess.prefill(prompts)
    want_cache = registry.init_cache(cfg, 3, CACHE, "cpu")
    batch = {"tokens": torch.from_numpy(prompts)}
    if cfg.frontend == "vision":          # the session's zero image prefix
        batch["prefix_embeds"] = torch.zeros(
            (3, cfg.num_prefix_embeds, cfg.d_model))
    want, want_cache, _ = registry.prefill(params, batch, want_cache, cfg)
    assert torch.equal(logits, want)
    for a, b in zip(_tree.tree_leaves(cache), _tree.tree_leaves(want_cache)):
        assert torch.equal(a, b)
    tok = logits[:, -1].argmax(-1).numpy()
    got, _ = sess.decode(tok, cache, pos0, {})
    want, _ = registry.decode_step(
        params, {"tokens": torch.from_numpy(tok.astype(np.int32)[:, None])},
        want_cache, pos0, cfg)
    assert torch.equal(got, want)


def test_one_time_cast_is_bitwise_the_per_call_cast():
    """The session casts projections, biases, the embedding and the FFN
    to bf16 once; norm scales stay float32.  Its prefill and decode give
    the bits of the registry run on the float32 params (which casts at
    every use, as the reference does)."""
    cfg = registry.get_config("command-r-35b", reduced=True)
    params, sess = _cast_once_session(cfg)
    blk = sess.params["blocks"]["sub0"]
    assert blk["ln1"]["scale"].dtype == torch.float32
    assert blk["ln1"]["bias"].dtype == torch.float32
    assert sess.params["final_norm"]["scale"].dtype == torch.float32
    assert blk["mixer"]["wq"].dtype == torch.bfloat16
    assert blk["ffn"]["wo"].dtype == torch.bfloat16
    assert sess.params["embed"]["embedding"].dtype == torch.bfloat16
    _assert_cast_once_bitwise(cfg, params, sess)


@pytest.mark.parametrize("arch,overrides", [
    ("qwen2-1.5b", {}), ("qwen2-1.5b", {"qk_norm": True}),
    ("deepseek-coder-33b", {}), ("command-r-plus-104b", {}),
    ("internvl2-2b", {}), ("rwkv6-7b", {}), ("jamba-v0.1-52b", {}),
    ("olmoe-1b-7b", {}), ("deepseek-moe-16b", {})])
def test_one_time_cast_is_bitwise_for_every_dense_arch(arch, overrides):
    """Every ported arch (the dense family, QK-norm, and the recurrent,
    hybrid and MoE families) reads in float32 only the leaves
    ``lm.FLOAT32_LEAVES`` names: casting all the others once gives the
    per-call cast's bits, and every float32 leaf left lies under a name
    in that set."""
    from repro_torch.models import lm
    cfg = registry.get_config(arch, reduced=True, **overrides)
    params, sess = _cast_once_session(cfg)
    kept = [path for path, leaf in _leaves_with_paths(sess.params)
            if leaf.dtype == torch.float32]
    assert kept and all(set(path) & lm.FLOAT32_LEAVES for path in kept)
    if overrides.get("qk_norm"):
        assert any("q_norm" in path for path in kept)
    _assert_cast_once_bitwise(cfg, params, sess)


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, path + (k,))
    else:
        yield path, tree


def test_session_runs_on_the_card_unless_asked(monkeypatch):
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    params = L.init_params(torch.Generator().manual_seed(0),
                           registry.param_specs(cfg), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.ServeSession(cfg, params, serve.ServeConfig())
    sess = serve.ServeSession(cfg, params, serve.ServeConfig(), device="cpu")
    assert {t.device for t in _tree.tree_leaves(sess.params)} == {
        torch.device("cpu")}


def test_wave_spans_metrics_and_last_logits():
    _, sess = _sessions("qwen2-1.5b", seed=11)
    reqs = _requests(sess.cfg.vocab_size, 12)
    trace.reset()
    trace.set_enabled(True)
    try:
        done = sess.run_wave([serve.Request(rid, p, NEW) for rid, p in reqs])
    finally:
        trace.set_enabled(False)
    spans = [sp for sp in trace.spans() if sp.name == "serve/wave"]
    assert len(spans) == 1 and spans[0].attrs["batch"] == 3
    assert "prefill_s" in spans[0].attrs and "decode_s" in spans[0].attrs
    assert all(c.tokens.shape == (NEW,) for c in done)
    assert sess.last_logits.shape == (3, sess.cfg.vocab_size)
    assert np.array_equal(sess.last_logits.argmax(-1).numpy(),
                          np.stack([c.tokens for c in done])[:, -1])


def test_tick_wave_scheduler_accounts_one_wave_per_key():
    w = serve.TickWaveScheduler()
    assert [w.submit(k, lambda k=k: k * 10) for k in (1, 1, 2, 2, 2)] == [
        10, 10, 20, 20, 20]
    assert w.stats() == {"waves": 2, "submissions": 5, "current_batch": 3}
    with pytest.raises(ZeroDivisionError):
        w.submit(3, lambda: 1 / 0)
    assert w.stats() == {"waves": 3, "submissions": 6, "current_batch": 1}
