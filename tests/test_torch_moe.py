"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the reduced MoE configs: routing (the
top-k order on ties, the gates, the load-balancing loss), the dropless
path (the default) with and without shared experts, and the capacity
path with slots over capacity dropped.

Inputs and parameters are drawn with numpy from a seed and handed to
both packages.  The router's logits are a float32 product summed in
another order than XLA's, so gates and the loss are held to 1e-5
relative and the expert ids exactly (the draws leave no near-ties); the
bf16 outputs are held to 1e-2 of the largest value against the reference
run eagerly (``jax.disable_jit()``), as ``tests/test_torch_models.py``
holds whole models.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.sharding import logical as JL
from repro_torch.models import convert, moe, registry

EAGER_TOL = 1e-2


def _setup(arch, seed, tokens=(2, 10), **overrides):
    jcfg = jreg.get_config(arch, reduced=True, **overrides)
    cfg = registry.get_config(arch, reduced=True, **overrides)
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(s.shape[-2] if len(s.shape) > 1 else 1)
                   ).astype(np.float32),
        jmoe.moe_specs(jcfg), is_leaf=lambda x: isinstance(x, JL.ParamSpec))
    x = rng.standard_normal((*tokens, cfg.d_model)).astype(
        ml_dtypes.bfloat16)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, np_params),
            convert.params_from_numpy(np_params, "cpu"), jnp.asarray(x),
            convert.params_from_numpy({"x": x}, "cpu")["x"])


def _rel(want, got):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(want - got.float().numpy()))
                 / (np.max(np.abs(want)) + 1e-6))


@pytest.mark.parametrize("row", [
    [0.1, 0.3, 0.3, 0.2, 0.3, 0.05],          # a three-way tie for the top
    [0.25, 0.25, 0.25, 0.25, 0.0, 0.0],       # a four-way tie, k inside it
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],           # all tied
    [0.4, 0.1, 0.2, 0.2, 0.05, 0.05]])        # a tie below the top
@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_breaks_ties_toward_the_lower_index(row, k):
    x = np.asarray([row, row[::-1]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = moe.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b",
                                  "jamba-v0.1-52b"])
def test_route_matches_the_reference(arch):
    jcfg, cfg, jp, p, jx, x = _setup(arch, seed=1, tokens=(3, 16))
    xt, jxt = x.reshape(-1, cfg.d_model), jx.reshape(-1, cfg.d_model)
    gate, ids, aux = moe.route(p, xt, cfg)
    jgate, jids, jaux = jmoe.route(jp, jxt, jcfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_route_of_a_zero_router_takes_the_lowest_experts():
    """A zero router ties every expert: each token goes to experts 0..k-1
    with equal gates, as ``jax.lax.top_k`` orders them."""
    jcfg, cfg, jp, p, jx, x = _setup("olmoe-1b-7b", seed=2)
    p = dict(p, router=torch.zeros_like(p["router"]))
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    xt, jxt = x.reshape(-1, cfg.d_model), jx.reshape(-1, cfg.d_model)
    gate, ids, _ = moe.route(p, xt, cfg)
    _, jids, _ = jmoe.route(jp, jxt, jcfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (ids == torch.arange(cfg.top_k)).all()
    assert torch.equal(gate, torch.full_like(gate, 1.0 / cfg.top_k))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b",
                                  "jamba-v0.1-52b"])
def test_dropless_moe_matches_the_eager_reference(arch):
    """The default path, shared experts included (deepseek-moe's two)."""
    jcfg, cfg, jp, p, jx, x = _setup(arch, seed=3)
    assert cfg.moe_dropless
    with jax.disable_jit():
        want, jaux = jmoe.apply_moe(jp, jx, jcfg, None)
    got, aux = moe.apply_moe(p, x, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _rel(want, got) <= EAGER_TOL
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_dropless_rows_do_not_depend_on_the_batch():
    """A token's output is a function of its own row: the first row run
    alone gives the bits it has inside the batch."""
    _, cfg, _, p, _, x = _setup("olmoe-1b-7b", seed=4)
    full, _ = moe.apply_moe(p, x, cfg)
    alone, _ = moe.apply_moe(p, x[:1, :3], cfg)
    assert torch.equal(full[:1, :3], alone)


@pytest.mark.parametrize("arch,factor", [
    ("olmoe-1b-7b", 1.25), ("olmoe-1b-7b", 0.3),
    ("deepseek-moe-16b", 0.5), ("jamba-v0.1-52b", 0.25)])
def test_capacity_moe_matches_the_eager_reference(arch, factor):
    """The sort-based capacity path; a capacity factor below 1 sends more
    slots to some experts than they hold, and those are dropped (the
    reference's ``mode="drop"``)."""
    jcfg, cfg, jp, p, jx, x = _setup(arch, seed=5, tokens=(4, 16),
                                     moe_dropless=False,
                                     capacity_factor=factor)
    t = x.shape[0] * x.shape[1]
    _, ids, _ = moe.route(p, x.reshape(t, -1), cfg)
    over = torch.bincount(ids.reshape(-1), minlength=cfg.num_experts)
    dropped = int((over - moe.capacity(t, cfg)).clamp(min=0).sum())
    assert (dropped > 0) == (factor < 1)
    assert moe.capacity(t, cfg) == jmoe.capacity(t, jcfg)
    with jax.disable_jit():
        want, jaux = jmoe.apply_moe(jp, jx, jcfg, None)
    got, aux = moe.apply_moe(p, x, cfg)
    assert _rel(want, got) <= EAGER_TOL
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_capacity_path_without_drops_is_the_dropless_function():
    """With room for every slot the capacity path computes the dropless
    function (to bf16 rounding: its combine adds in bf16)."""
    cfg = registry.get_config("olmoe-1b-7b", reduced=True)
    _, _, _, p, _, x = _setup("olmoe-1b-7b", seed=6)
    cap = dataclasses.replace(cfg, moe_dropless=False, capacity_factor=4.0)
    a, _ = moe.apply_moe(p, x, cfg)
    b, _ = moe.apply_moe(p, x, cap)
    torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2)
