"""The port's model stack (``repro_torch.models``) against the JAX package's
(``repro.models``) on the reduced configs of the dense family: the same
numpy-seeded tokens and the reference's own parameters
(``init_params(PRNGKey)`` carried across by ``convert.params_from_numpy``)
go through both.

Two references, two tolerances:

* **eager** (``jax.disable_jit()``: every HLO op runs alone, so each bf16
  op rounds its result, as each torch op does): held to 1e-2 of the
  largest logit.  The port follows the reference's op sequence (XLA's
  sigmoid expansion, weakly typed constants rounded to bf16), so most
  cases agree to the bit; the margin is for a bf16 product the two
  libraries accumulate in another order, whose one flipped rounding
  (2**-8 of a value) moves a logit by a few bf16 ulps.
* **compiled** (``jax.jit``, as the reference's serve path and ml island
  run): XLA fuses bf16 elementwise ops and keeps their intermediates in
  float32 (excess precision), which moves logits by up to a few percent
  of the largest one on these random models.  Held to 5e-2 of the
  largest logit: the bound the reference holds between its own two paths
  (``tests/test_decode_consistency.py``).

``attn_impl="flash"`` runs the reference's Pallas kernel in interpret
mode and the port's plain version of its kernel (``ref.py``) on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import registry as jreg
from repro.sharding import logical as JL
from repro_torch import _tree
from repro_torch.models import attention, convert, layers, registry
from repro_torch.sharding import logical as L

DENSE = ["qwen2-1.5b", "deepseek-coder-33b", "command-r-35b", "internvl2-2b"]
# the recurrent, hybrid and MoE families (tests/test_torch_families.py)
FAMILIES = ["rwkv6-7b", "jamba-v0.1-52b", "olmoe-1b-7b", "deepseek-moe-16b"]
ENCDEC = ["seamless-m4t-medium"]        # (tests/test_torch_encdec.py)
EAGER_TOL, COMPILED_TOL = 1e-2, 5e-2
B, S, CACHE = 2, 12, 24


def assert_rel(want, got, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().cpu().numpy() if isinstance(got, torch.Tensor) else got
    assert want.shape == got.shape, (what, want.shape, got.shape)
    scale = float(np.max(np.abs(want))) + 1e-6
    err = float(np.max(np.abs(want - got)))
    assert err <= tol * scale, f"{what}: rel err {err / scale:.3e} > {tol}"


def setup(arch, seed=1, **overrides):
    """Configs of both packages, the reference's params in both, and one
    numpy-seeded batch in both."""
    jcfg = jreg.get_config(arch, reduced=True, **overrides)
    cfg = registry.get_config(arch, reduced=True, **overrides)
    jparams = JL.init_params(jax.random.PRNGKey(seed),
                             jreg.param_specs(jcfg))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks)}
    batch = {"tokens": torch.from_numpy(toks)}
    if cfg.frontend == "vision":
        pe = rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
        jbatch["prefix_embeds"] = jnp.asarray(pe)
        batch["prefix_embeds"] = torch.from_numpy(pe)
    return jcfg, cfg, jparams, params, jbatch, batch


def _leaf_desc(spec):
    return (tuple(spec.shape), tuple(spec.axes),
            str(np.dtype(spec.dtype)) if not isinstance(spec.dtype,
                                                        torch.dtype)
            else str(spec.dtype).removeprefix("torch."),
            spec.init, spec.init_scale)


def _flat_specs(tree, is_jax):
    if is_jax:
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JL.ParamSpec))[0]
        return {jax.tree_util.keystr(p): _leaf_desc(s) for p, s in leaves}
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + f"['{k}']")
        else:
            out[path] = _leaf_desc(node)
    walk(tree, "")
    return out


# -- configs and specs -----------------------------------------------------------
@pytest.mark.parametrize("arch", jreg.ARCH_NAMES)
def test_configs_are_the_references(arch):
    for reduced in (False, True):
        want = dataclasses.asdict(jreg.get_config(arch, reduced=reduced))
        got = dataclasses.asdict(registry.get_config(arch, reduced=reduced))
        assert want == got
    assert registry.ARCH_NAMES == jreg.ARCH_NAMES


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch",
                         DENSE + ["command-r-plus-104b"] + FAMILIES + ENCDEC)
def test_spec_trees_match(arch, reduced):
    """Names, shapes, axes, dtypes and initializers of every parameter and
    cache leaf, at the reduced and the published widths."""
    jcfg = jreg.get_config(arch, reduced=reduced)
    cfg = registry.get_config(arch, reduced=reduced)
    assert (_flat_specs(registry.param_specs(cfg), False)
            == _flat_specs(jreg.param_specs(jcfg), True))
    assert (L.count_params(registry.param_specs(cfg))
            == JL.count_params(jreg.param_specs(jcfg)))
    for codec in ("bf16", "int8"):
        jc = dataclasses.replace(jcfg, kv_cache_dtype=codec)
        c = dataclasses.replace(cfg, kv_cache_dtype=codec)
        assert (_flat_specs(registry.cache_specs(c, 2, 16), False)
                == _flat_specs(jreg.cache_specs(jc, 2, 16), True))


def test_full_width_qwen2_has_its_published_size():
    cfg = registry.get_config("qwen2-1.5b", attn_impl="flash")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        28, 1536, 12, 2, 128, 8960, 151936)
    assert cfg.qkv_bias and cfg.tie_embeddings and cfg.rope_theta == 1e6
    # 1.54 B float32 parameters: 6.2 GB, which one H100 holds
    assert L.count_params(registry.param_specs(cfg)) == 1543714304


# -- parameters ------------------------------------------------------------------
def test_init_params_follow_the_spec_initializers():
    cfg = registry.get_config("command-r-35b", reduced=True)
    specs = registry.param_specs(cfg)
    a = L.init_params(torch.Generator().manual_seed(3), specs, "cpu")
    b = L.init_params(torch.Generator().manual_seed(3), specs, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(_tree.tree_leaves(a),
                                                  _tree.tree_leaves(b)))
    ln = a["blocks"]["sub0"]["ln1"]
    assert torch.equal(ln["scale"], torch.ones_like(ln["scale"]))
    assert torch.equal(ln["bias"], torch.zeros_like(ln["bias"]))
    # "normal" scales by the second-to-last dim, as _init_one does
    for w in (a["blocks"]["sub0"]["mixer"]["wq"],
              a["blocks"]["sub0"]["ffn"]["wi_gate"]):
        assert abs(float(w.std()) * w.shape[-2] ** 0.5 - 1.0) < 0.05
    emb = a["embed"]["embedding"]
    assert abs(float(emb.std()) / 0.02 - 1.0) < 0.05
    assert all(t.dtype == torch.float32 for t in _tree.tree_leaves(a))


def test_convert_round_trips_params_and_bf16_caches():
    jcfg = jreg.get_config("qwen2-1.5b", reduced=True)
    tree = {"params": jax.tree.map(np.asarray, JL.init_params(
        jax.random.PRNGKey(0), jreg.param_specs(jcfg))),
            "cache": jax.tree.map(np.array, jreg.init_cache(jcfg, 2, 8))}
    tree["cache"]["blocks"]["sub0"]["kv"]["k"][:] = np.arange(
        8, dtype=np.float32).astype(ml_dtypes.bfloat16)[None, :, None, None]
    port = convert.params_from_numpy(tree, "cpu")
    assert port["cache"]["blocks"]["sub0"]["kv"]["k"].dtype == torch.bfloat16
    back = convert.params_to_numpy(port, bf16_dtype=ml_dtypes.bfloat16)
    for want, got in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert want.dtype == got.dtype and want.shape == got.shape
        np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))


def test_rope_frequencies_within_an_ulp():
    """``theta ** exponents`` in float32: the two packages' pow may
    differ in the last bit, and no more."""
    for arch in jreg.ARCH_NAMES:
        cfg = registry.get_config(arch)
        want = np.asarray(jlayers.rope_frequencies(cfg.head_dim,
                                                   cfg.rope_theta))
        got = layers.rope_frequencies(cfg.head_dim, cfg.rope_theta).numpy()
        ulps = np.abs(want.view(np.int32) - got.view(np.int32))
        assert ulps.max() <= 1, arch


# -- forward, prefill, decode ------------------------------------------------------
def _jax_forward(jparams, jbatch, jcfg):
    return jreg.forward(jparams, jbatch, jcfg, None)[0]


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_the_reference(arch, impl):
    jcfg, cfg, jparams, params, jbatch, batch = setup(arch, attn_impl=impl)
    got, aux = registry.forward(params, batch, cfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    with jax.disable_jit():
        assert_rel(_jax_forward(jparams, jbatch, jcfg), got, EAGER_TOL,
                   "eager")
    assert_rel(jax.jit(_jax_forward, static_argnums=2)(jparams, jbatch,
                                                       jcfg),
               got, COMPILED_TOL, "compiled")


def _jax_serve(jparams, jbatch, jcfg, steps):
    """Reference prefill of all but the last ``steps`` tokens, then one
    decode step per remaining token; the logits of each, and the cache."""
    pre = dict(jbatch, tokens=jbatch["tokens"][:, :-steps])
    cache = jreg.init_cache(jcfg, B, CACHE)
    logits, cache, extras = jreg.prefill(jparams, pre, cache, jcfg, None)
    out = [logits[:, -1]]
    start = pre["tokens"].shape[1] + (jcfg.num_prefix_embeds
                                      if jcfg.frontend == "vision" else 0)
    for i in range(steps):
        tok = jbatch["tokens"][:, -steps + i][:, None]
        logits, cache = jreg.decode_step(jparams, {"tokens": tok, **extras},
                                         cache, jnp.int32(start + i), jcfg,
                                         None)
        out.append(logits[:, -1])
    return out, cache


def _port_serve(params, batch, cfg, steps):
    pre = dict(batch, tokens=batch["tokens"][:, :-steps])
    cache = registry.init_cache(cfg, B, CACHE, "cpu")
    logits, cache, extras = registry.prefill(params, pre, cache, cfg)
    out = [logits[:, -1]]
    start = pre["tokens"].shape[1] + (cfg.num_prefix_embeds
                                      if cfg.frontend == "vision" else 0)
    for i in range(steps):
        tok = batch["tokens"][:, -steps + i][:, None]
        logits, cache = registry.decode_step(params, {"tokens": tok},
                                             cache, start + i, cfg)
        out.append(logits[:, -1])
    return out, cache


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_the_reference(arch, impl):
    """Prefill's last-token logits and its cache, then three decode
    steps' logits, against the eager reference; the first layer's cached
    bf16 k (written by prefill and decode) bitwise."""
    jcfg, cfg, jparams, params, jbatch, batch = setup(arch, attn_impl=impl)
    got, cache = _port_serve(params, batch, cfg, 3)
    with jax.disable_jit():
        want, jcache = _jax_serve(jparams, jbatch, jcfg, 3)
    for i, (w, g) in enumerate(zip(want, got)):
        assert_rel(w, g, EAGER_TOL, f"step {i}")
    jk = np.asarray(jcache["blocks"]["sub0"]["kv"]["k"]).view(np.uint16)
    k = cache["blocks"]["sub0"]["kv"]["k"].view(torch.int16).numpy()
    np.testing.assert_array_equal(jk, k.view(np.uint16))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "command-r-35b"])
def test_prefill_and_decode_against_the_compiled_reference(arch):
    jcfg, cfg, jparams, params, jbatch, batch = setup(arch)
    got, _ = _port_serve(params, batch, cfg, 2)
    want, _ = jax.jit(_jax_serve, static_argnums=(2, 3))(jparams, jbatch,
                                                          jcfg, 2)
    for i, (w, g) in enumerate(zip(want, got)):
        assert_rel(w, g, COMPILED_TOL, f"step {i}")


# -- the int8 KV codec ----------------------------------------------------------------
def _heads(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    x *= 10.0 ** rng.integers(-3, 3, (2, 16, 2, 1))
    x[0, 3, 1] = 0.0                                  # an all-zero head
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_heads_follows_the_compiled_scale(seed):
    """Codes and scales bitwise to the reference's compiled codec (XLA
    multiplies by the float32 reciprocal of 127); against its eager
    codec (a true division) the scales are within one ulp and the codes
    equal wherever the scales are."""
    jx, x = _heads(seed)
    q, scale = attention._quant_heads(x)
    jq, jscale = jax.jit(jattn._quant_heads)(jx)
    np.testing.assert_array_equal(np.asarray(jq), q.numpy())
    np.testing.assert_array_equal(np.asarray(jscale), scale.numpy())
    eq, escale = jattn._quant_heads(jx)
    escale = np.asarray(escale)
    ulps = np.abs(escale.view(np.int32) - scale.numpy().view(np.int32))
    assert ulps.max() <= 1
    same = np.broadcast_to(ulps == 0, q.shape)
    np.testing.assert_array_equal(np.asarray(eq)[same], q.numpy()[same])
    deq = attention._dequant_heads(q, scale, torch.bfloat16)
    jdeq = jattn._dequant_heads(jq, jscale, jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(jdeq.astype(jnp.float32)),
                                  deq.float().numpy())


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_int8_cache_serve_matches_the_reference(impl):
    """The serve path with int8 KV pages: the cache's codes and scales
    against the compiled reference's codec on the same k/v, and the
    decode logits against the eager reference (whose scales may differ
    from the compiled ones in an ulp)."""
    jcfg, cfg, jparams, params, jbatch, batch = setup(
        "qwen2-1.5b", attn_impl=impl, kv_cache_dtype="int8")
    got, cache = _port_serve(params, batch, cfg, 3)
    with jax.disable_jit():
        want, jcache = _jax_serve(jparams, jbatch, jcfg, 3)
    for i, (w, g) in enumerate(zip(want, got)):
        assert_rel(w, g, EAGER_TOL, f"step {i}")
    kv = cache["blocks"]["sub0"]["kv"]
    assert kv["k"].dtype == torch.int8 and kv["k_scale"].dtype == torch.float32
    jkv = jcache["blocks"]["sub0"]["kv"]
    ulps = np.abs(np.asarray(jkv["k_scale"]).view(np.int32)
                  - kv["k_scale"].numpy().view(np.int32))
    assert ulps.max() <= 1


# -- the port's own forward ≡ decode -----------------------------------------------
@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch, impl):
    """As ``tests/test_decode_consistency.py`` holds the reference: the
    last position's logits of a full forward against prefill on all but
    the last token and one decode step, and four decode steps each
    against the forward truncated there; 5e-2 of the largest logit."""
    _, cfg, _, params, _, batch = setup(arch, seed=4, attn_impl=impl)
    steps = 4
    got, _ = _port_serve(params, batch, cfg, steps)
    for i in range(steps):
        cut = dict(batch, tokens=batch["tokens"][:, :S - steps + i + 1])
        want, _ = registry.forward(params, cut, cfg)
        assert_rel(want[:, -1].numpy(), got[i + 1], 5e-2, f"step {i}")
