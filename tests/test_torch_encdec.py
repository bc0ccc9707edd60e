"""The port's encoder-decoder family (``repro_torch.models.encdec``,
seamless-m4t-medium) against the JAX package's, on the reduced config (2
encoder and 2 decoder layers, d_model 64): the reference's own params
carried across (``convert.params_from_numpy``), numpy-seeded tokens and
frame embeddings through both.

Tolerances, as ``tests/test_torch_families.py`` states them: 1e-2 of
the largest logit against the reference run eagerly
(``jax.disable_jit()``), 5e-2 against the compiled one, or, at a
position where the reference's compiled run itself parts from its eager
run by more than that, that split plus 1e-2 (under ``attn_impl="flash"``
the reference's two runs differ by up to 8.9e-2 of the largest logit
on these random weights: XLA keeps fused bf16 intermediates in float32
around the interpreted kernel).  The f32 cross-attention alone is held to
2e-5.  Between the port's own two attention paths (``"flash"`` against
``"reference"``) the bound is 5e-2, as ``tests/test_decode_consistency.py``
holds the reference's paths: the plain path rounds the scores to bf16
before its softmax and the kernel keeps them in float32.
``attn_impl="flash"`` sends the decoder's causal self-attention to the
reference's Pallas kernel in interpret mode and to the port's plain
version of its kernel on the CPU; the encoder and the cross-attention
take the plain path in both.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import registry as jreg
from repro.serve import engine as jserve
from repro.sharding import logical as JL
from repro_torch import _tree
from repro_torch.models import attention, convert, encdec, lm, registry
from repro_torch.serve import engine as serve
from repro_torch.sharding import logical as L
from test_torch_families import assert_compiled
from test_torch_models import _flat_specs, assert_rel
from test_torch_serve import (_check_steps, _padded, _port_forced,
                              _requests, _run)

ARCH = "seamless-m4t-medium"
EAGER_TOL, COMPILED_TOL = 1e-2, 5e-2
B, S, SRC, CACHE, STEPS = 2, 12, 5, 24, 3


def _setup(seed=1, **overrides):
    jcfg = jreg.get_config(ARCH, reduced=True, **overrides)
    cfg = registry.get_config(ARCH, reduced=True, **overrides)
    jparams = JL.init_params(jax.random.PRNGKey(seed),
                             jreg.param_specs(jcfg))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, SRC, cfg.d_model)).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "frame_embeds": jnp.asarray(frames)}
    batch = {"tokens": torch.from_numpy(toks),
             "frame_embeds": torch.from_numpy(frames)}
    return jcfg, cfg, jparams, params, jbatch, batch


def _jax_serve(jparams, jbatch, jcfg, steps):
    """Reference prefill of all but the last ``steps`` tokens, then one
    decode step per remaining token: the logits of each, the cache and
    the encoder memory."""
    pre = dict(jbatch, tokens=jbatch["tokens"][:, :-steps])
    cache = jreg.init_cache(jcfg, B, CACHE)
    logits, cache, extras = jreg.prefill(jparams, pre, cache, jcfg, None)
    out = [logits[:, -1]]
    start = pre["tokens"].shape[1]
    for i in range(steps):
        tok = jbatch["tokens"][:, -steps + i][:, None]
        logits, cache = jreg.decode_step(jparams, {"tokens": tok, **extras},
                                         cache, jnp.int32(start + i), jcfg,
                                         None)
        out.append(logits[:, -1])
    return out, cache, extras["memory"]


def _port_serve(params, batch, cfg, steps):
    pre = dict(batch, tokens=batch["tokens"][:, :-steps])
    cache = registry.init_cache(cfg, B, CACHE, "cpu")
    logits, cache, extras = registry.prefill(params, pre, cache, cfg)
    out = [logits[:, -1]]
    start = pre["tokens"].shape[1]
    for i in range(steps):
        tok = batch["tokens"][:, -steps + i][:, None]
        logits, cache = registry.decode_step(
            params, {"tokens": tok, **extras}, cache, start + i, cfg)
        out.append(logits[:, -1])
    return out, cache, extras["memory"]


def _jax_forward(jparams, jbatch, jcfg):
    return jreg.forward(jparams, jbatch, jcfg, None)[0]


@functools.lru_cache(maxsize=None)
def _case(impl):
    jcfg, cfg, jparams, params, jbatch, batch = _setup(attn_impl=impl)
    with jax.disable_jit():
        eager_fwd = np.asarray(_jax_forward(jparams, jbatch, jcfg))
        eager_serve, jcache, jmem = _jax_serve(jparams, jbatch, jcfg, STEPS)
    jit_fwd = np.asarray(jax.jit(_jax_forward, static_argnums=2)(
        jparams, jbatch, jcfg))
    jit_serve, _, _ = jax.jit(_jax_serve, static_argnums=(2, 3))(
        jparams, jbatch, jcfg, STEPS)
    as_np = functools.partial(np.asarray, dtype=np.float32)
    return dict(cfg=cfg, params=params, batch=batch, eager_fwd=eager_fwd,
                jit_fwd=jit_fwd, eager_serve=[as_np(x) for x in eager_serve],
                jit_serve=[as_np(x) for x in jit_serve],
                jcache=jax.tree.map(np.asarray, jcache),
                jmem=np.asarray(jmem.astype(jnp.float32)))


# -- specs, params, conversion -------------------------------------------------
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_param_and_cache_specs_are_the_references(reduced):
    jcfg = jreg.get_config(ARCH, reduced=reduced)
    cfg = registry.get_config(ARCH, reduced=reduced)
    assert (_flat_specs(registry.param_specs(cfg), False)
            == _flat_specs(jreg.param_specs(jcfg), True))
    assert (_flat_specs(encdec.param_specs(cfg), False)
            == _flat_specs(jencdec.param_specs(jcfg), True))
    for codec in ("bf16", "int8"):
        jc = dataclasses.replace(jcfg, kv_cache_dtype=codec)
        c = dataclasses.replace(cfg, kv_cache_dtype=codec)
        assert (_flat_specs(registry.cache_specs(c, 2, 16), False)
                == _flat_specs(jreg.cache_specs(jc, 2, 16), True))
    assert encdec.MAX_POSITIONS == jencdec.MAX_POSITIONS == 32768
    assert (_flat_specs(attention.attn_specs(cfg, cross=True), False)
            == _flat_specs(jattn.attn_specs(jcfg, cross=True), True))


def test_full_width_has_its_published_size():
    cfg = registry.get_config(ARCH)
    assert (cfg.encoder_layers, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.padded_vocab) == (12, 12, 1024, 16, 16, 64, 4096, 256206,
                                  256206)
    n = L.count_params(registry.param_specs(cfg))
    assert n == JL.count_params(jreg.param_specs(jreg.get_config(ARCH)))
    # 0.91 B: the untied embedding and unembedding (256,206 x 1,024 each)
    # are 0.52 B of it, the 32,768 learned positions 0.03 B
    assert n == 910835712


def test_convert_round_trips_the_encdec_tree():
    """The enc-dec parameter tree (enc_blocks, dec_blocks with
    cross_attn, pos_embed) and a bf16 cache, leaf for leaf and bit for
    bit, across the packages."""
    jcfg = jreg.get_config(ARCH, reduced=True)
    tree = {"params": jax.tree.map(np.asarray, JL.init_params(
        jax.random.PRNGKey(0), jreg.param_specs(jcfg))),
            "cache": jax.tree.map(np.array, jreg.init_cache(jcfg, 2, 8))}
    tree["cache"]["k"][:] = np.arange(8, dtype=np.float32).astype(
        ml_dtypes.bfloat16)[None, None, :, None, None]
    port = convert.params_from_numpy(tree, "cpu")
    assert set(port["params"]) == {"embed", "pos_embed", "enc_blocks",
                                   "enc_norm", "dec_blocks", "final_norm"}
    assert set(port["params"]["dec_blocks"]) == {
        "ln1", "self_attn", "ln_x", "cross_attn", "ln2", "ffn"}
    assert port["cache"]["k"].dtype == torch.bfloat16
    back = convert.params_to_numpy(port, bf16_dtype=ml_dtypes.bfloat16)
    want_paths = [jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(tree)[0]]
    got_paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(back)[0]]
    assert want_paths == got_paths
    for want, got in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert want.dtype == got.dtype and want.shape == got.shape
        np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))


def test_place_params_keeps_the_encdec_norms_in_float32():
    cfg = registry.get_config(ARCH, reduced=True)
    params = L.init_params(torch.Generator().manual_seed(0),
                           registry.param_specs(cfg), "cpu")
    placed = serve.place_params(params, "cpu")
    for name in ("ln1", "ln_x", "ln2"):
        assert placed["dec_blocks"][name]["scale"].dtype == torch.float32
    assert placed["enc_norm"]["bias"].dtype == torch.float32
    assert placed["enc_blocks"]["ln1"]["scale"].dtype == torch.float32
    assert {"ln_x", "enc_norm"} <= lm.FLOAT32_LEAVES
    assert placed["pos_embed"].dtype == torch.bfloat16
    assert placed["dec_blocks"]["cross_attn"]["wq"].dtype == torch.bfloat16


# -- attention pieces -------------------------------------------------------------
def test_cross_attention_alone_at_f32():
    """q from the decoder stream, k/v from the memory, no mask, no rope:
    2e-5 of the largest output at f32."""
    jcfg, cfg, jparams, params, _, _ = _setup(seed=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 9, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["dec_blocks"]["cross_attn"])
    p = _tree.tree_map(lambda t: t[0], params["dec_blocks"]["cross_attn"])
    want = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(mem), jcfg,
                                 None)
    got = attention.cross_attention(p, torch.from_numpy(x),
                                    torch.from_numpy(mem), cfg)
    assert got.dtype == torch.float32 and got.shape == (B, 7, cfg.d_model)
    assert_rel(want, got, 2e-5, "cross_attention f32")


def test_full_self_attention_takes_the_plain_path_under_flash(monkeypatch):
    """The encoder's self-attention (causal=False) never reaches the
    flash kernel, under either ``attn_impl``; causal self-attention
    does under "flash"."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    cfg = registry.get_config(ARCH, reduced=True, attn_impl="flash")
    params = L.init_params(torch.Generator().manual_seed(0),
                           attention.attn_specs(cfg), "cpu")
    calls = []
    real = flash_ops.flash_attention
    monkeypatch.setattr(flash_ops, "flash_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    x = torch.randn(1, 6, cfg.d_model).bfloat16()
    full = attention.self_attention(params, x, cfg, causal=False)
    assert calls == []
    ref = attention.self_attention(
        params, x, dataclasses.replace(cfg, attn_impl="reference"),
        causal=False)
    assert torch.equal(full, ref)
    attention.self_attention(params, x, cfg)
    assert calls == [{"causal": True}]


# -- forward, prefill, decode against the reference -------------------------------
@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_forward_matches_the_reference(impl):
    c = _case(impl)
    got, aux = registry.forward(c["params"], c["batch"], c["cfg"])
    assert got.dtype == torch.float32
    assert got.shape == (B, S, c["cfg"].padded_vocab) and float(aux) == 0.0
    assert_rel(c["eager_fwd"], got, EAGER_TOL, "eager")
    assert_compiled(c["jit_fwd"], c["eager_fwd"], got, "compiled")


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_prefill_and_decode_match_the_reference(impl):
    """Prefill's last-token logits, its cache and the encoder memory,
    then three decode steps' logits, against the eager and the compiled
    reference; the first layer's cached bf16 k bitwise the eager
    reference's."""
    c = _case(impl)
    got, cache, memory = _port_serve(c["params"], c["batch"], c["cfg"],
                                     STEPS)
    for i, g in enumerate(got):
        assert_rel(c["eager_serve"][i], g, EAGER_TOL, f"eager step {i}")
        assert_compiled(c["jit_serve"][i], c["eager_serve"][i], g,
                        f"compiled step {i}")
    assert memory.dtype == torch.bfloat16
    assert_rel(c["jmem"], memory.float(), EAGER_TOL, "memory")
    jk = c["jcache"]["k"].view(np.uint16)
    k = cache["k"].view(torch.int16).numpy().view(np.uint16)
    assert jk.shape == k.shape == (c["cfg"].num_layers, B, CACHE,
                                   c["cfg"].num_kv_heads,
                                   c["cfg"].head_dim)
    np.testing.assert_array_equal(jk[0], k[0])
    jv = c["jcache"]["v"].astype(np.float32)
    assert_rel(jv, cache["v"].float(), EAGER_TOL, "cached v")


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_decode_matches_forward(impl):
    """The port's own serve path against its forward, as
    ``tests/test_decode_consistency.py`` holds the reference: prefill on
    all but the last four tokens and four decode steps, each against the
    forward truncated there; 5e-2 of the largest logit."""
    _, cfg, _, params, _, batch = _setup(seed=4, attn_impl=impl)
    steps = 4
    got, _, _ = _port_serve(params, batch, cfg, steps)
    for i in range(steps):
        cut = dict(batch, tokens=batch["tokens"][:, :S - steps + i + 1])
        want, _ = registry.forward(params, cut, cfg)
        assert_rel(want[:, -1].numpy(), got[i + 1], 5e-2, f"step {i}")


def test_flash_matches_the_plain_attention_path():
    """``attn_impl="flash"`` (the kernel's plain version on the CPU)
    against ``"reference"`` on the same params: forward, prefill and a
    decode step, within 5e-2 (the module docstring says why not 1e-2)."""
    _, cfg, _, params, _, batch = _setup(seed=5)
    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    want, _ = registry.forward(params, batch, cfg)
    got, _ = registry.forward(params, batch, fcfg)
    assert_rel(want.numpy(), got, COMPILED_TOL, "forward")
    w, _, wmem = _port_serve(params, batch, cfg, 1)
    g, _, gmem = _port_serve(params, batch, fcfg, 1)
    assert torch.equal(wmem, gmem)        # the encoder runs no kernel
    for i, (a, b) in enumerate(zip(w, g)):
        assert_rel(a.numpy(), b, COMPILED_TOL, f"step {i}")


def test_positions_clamp_as_dynamic_slice():
    """A span that would run past the table starts where it fits, as
    ``dynamic_slice`` clamps it."""
    cfg = registry.get_config(ARCH, reduced=True)
    table = torch.arange(encdec.MAX_POSITIONS, dtype=torch.float32)[:, None]
    params = {"pos_embed": table.expand(-1, cfg.d_model)}
    x = torch.zeros(1, 4, cfg.d_model)
    out = encdec._add_positions(params, x, encdec.MAX_POSITIONS - 2)
    assert out[0, :, 0].tolist() == [32764.0, 32765.0, 32766.0, 32767.0]
    jout = jencdec._add_positions({"pos_embed": jnp.asarray(params[
        "pos_embed"].numpy())}, jnp.zeros((1, 4, cfg.d_model)),
        encdec.MAX_POSITIONS - 2)
    np.testing.assert_array_equal(np.asarray(jout), out.numpy())


# -- serving ---------------------------------------------------------------------------
def _sessions(seed=0, **overrides):
    jcfg = jreg.get_config(ARCH, reduced=True, **overrides)
    cfg = registry.get_config(ARCH, reduced=True, **overrides)
    jparams = JL.init_params(jax.random.PRNGKey(seed),
                             jreg.param_specs(jcfg))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    scfg = dict(max_batch=4, cache_len=32, max_new_tokens=6)
    jsess = jserve.ServeSession(jcfg, jparams, jserve.ServeConfig(**scfg))
    sess = serve.ServeSession(cfg, params, serve.ServeConfig(**scfg),
                              device="cpu")
    return jsess, sess


def _ref_forced(jsess, prompts, toks):
    """The reference session's jitted prefill/decode fed ``toks``, with
    its stub audio frontend's zero frames: (B, V) logits of each step."""
    cfg = jsess.cfg
    b, plen = prompts.shape
    cache = jreg.init_cache(cfg, b, jsess.scfg.cache_len)
    batch = {"tokens": jnp.asarray(prompts),
             "frame_embeds": jnp.zeros(
                 (b, max(1, plen // cfg.src_ratio), cfg.d_model))}
    logits, cache, extras = jsess._prefill(jsess.params, batch, cache)
    out = [np.asarray(logits[:, -1])]
    for i in range(toks.shape[1] - 1):
        logits, cache = jsess._decode(
            jsess.params, {"tokens": jnp.asarray(toks[:, i:i + 1]),
                           **extras}, cache, jnp.int32(plen + i))
        out.append(np.asarray(logits[:, -1]))
    return out


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_served_waves_match_the_reference_session(impl):
    """The port's ``ServeSession`` (zero frame embeddings, one frame per
    ``src_ratio`` prompt positions, the encoder memory passed to every
    decode step) against the reference's: each step's logits
    teacher-forced on the reference's tokens, within 1e-2 of the eager
    session's and 5e-2 of the compiled one's, and the port's greedy token
    equal to the reference's wherever its top-2 gap exceeds that."""
    jsess, sess = _sessions(attn_impl=impl)
    reqs = _requests(sess.cfg.vocab_size, 1)
    prompts = _padded(reqs)
    got_toks = _run(sess, reqs, serve)
    with jax.disable_jit():
        want_toks = _run(jsess, reqs, jserve)
        want = _ref_forced(jsess, prompts, want_toks)
    assert got_toks.shape == want_toks.shape
    got = _port_forced(sess, prompts, want_toks)
    _check_steps(want, got, want_toks, EAGER_TOL)
    jit_toks = _run(jsess, reqs, jserve)
    _check_steps(_ref_forced(jsess, prompts, jit_toks),
                 _port_forced(sess, prompts, jit_toks), jit_toks,
                 COMPILED_TOL)


def test_session_frames_and_memory():
    """The stub frontend's frames (``frontend_batch``, which prefill
    feeds) are float32 zeros of (B, max(1, P // src_ratio), D), the
    memory returned by prefill is what each decode step reads, and the
    session's one-time cast gives the bits of the registry run on the
    float32 params."""
    cfg = registry.get_config(ARCH, reduced=True)
    params = L.init_params(torch.Generator().manual_seed(0),
                           registry.param_specs(cfg), "cpu")
    sess = serve.ServeSession(cfg, params, serve.ServeConfig(cache_len=32),
                              device="cpu")
    for plen in (3, 11):
        prompts = np.arange(2 * plen, dtype=np.int32).reshape(2, plen) % 7
        logits, cache, extras, pos0 = sess.prefill(prompts)
        assert pos0 == plen
        frames = torch.zeros(2, max(1, plen // cfg.src_ratio), cfg.d_model)
        batch = sess.frontend_batch(prompts)
        assert torch.equal(batch["frame_embeds"], frames)
        assert torch.equal(batch["tokens"], torch.from_numpy(prompts))
        want_cache = registry.init_cache(cfg, 2, 32, "cpu")
        want, want_cache, want_extras = registry.prefill(
            params, {"tokens": torch.from_numpy(prompts),
                     "frame_embeds": frames}, want_cache, cfg)
        assert torch.equal(logits, want)
        assert torch.equal(extras["memory"], want_extras["memory"])
        assert extras["memory"].shape == frames.shape
        tok = logits[:, -1].argmax(-1).numpy()
        got, _ = sess.decode(tok, cache, pos0, extras)
        want, _ = registry.decode_step(
            params, {"tokens": torch.from_numpy(tok.astype(np.int32)[:, None]),
                     **want_extras}, want_cache, pos0, cfg)
        assert torch.equal(got, want)
