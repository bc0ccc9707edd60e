"""The port's two scans against the JAX package's, on the CPU: the plain
versions of the WKV6 and selective-scan kernels
(``repro_torch.kernels.{rwkv6_scan,mamba_scan}``) and the RWKV6 and
Mamba layers built on them (``repro_torch.models.{rwkv6,mamba}``).

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances are those of ``tests/test_kernels.py`` for the scans (5e-4
for WKV6, 5e-5 for the selective scan, float32 sums taken in another
order); the layers' float32 intermediates are held to 1e-5 relative,
their bf16 outputs to 1e-2 of the largest value against the reference
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

from repro.kernels.mamba_scan import ops as jmops
from repro.kernels.mamba_scan import ref as jmref
from repro.kernels.rwkv6_scan import ops as jwops
from repro.kernels.rwkv6_scan import ref as jwref
from repro.models import mamba as jmamba
from repro.models import registry as jreg
from repro.models import rwkv6 as jrwkv6
from repro.sharding import logical as JL
from repro_torch.kernels.mamba_scan import ops as mops
from repro_torch.kernels.mamba_scan import ref as mref
from repro_torch.kernels.rwkv6_scan import ops as wops
from repro_torch.kernels.rwkv6_scan import ref as wref
from repro_torch.models import convert, mamba, registry, rwkv6
from repro_torch.sharding import logical as L

WKV_TOL, SCAN_TOL, EAGER_TOL = 5e-4, 5e-5, 1e-2


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(want, got, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def assert_rel(want, got, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert want.shape == got.shape, (what, want.shape, got.shape)
    scale = float(np.max(np.abs(want))) + 1e-6
    err = float(np.max(np.abs(want - got)))
    assert err <= tol * scale, f"{what}: rel err {err / scale:.3e} > {tol}"


# -- WKV6 --------------------------------------------------------------------------
def _wkv_inputs(b, s, h, d, seed, decays=(0.85, 0.999)):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    if decays == "full_width":
        # RWKV6-7B's decays under the reference's initializer: w0 = 0 and a
        # decay lora of standard deviation 0.63 at d_model 4,096
        w = np.exp(-np.exp(0.63 * rng.standard_normal((b, s, h, d))))
    else:
        w = rng.uniform(*decays, (b, s, h, d))
    u = rng.standard_normal((h, d)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, d, d)) * 0.3).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, s0


@pytest.mark.parametrize("b,s,h,d,chunk", [
    (1, 64, 1, 16, 16), (2, 128, 2, 32, 32), (1, 256, 4, 64, 64),
    (2, 96, 2, 32, 32)])
def test_wkv6_matches_the_reference_kernel(b, s, h, d, chunk):
    """The sweep of ``tests/test_kernels.py``: the reference's chunked
    kernel (interpret mode) with a carried state against the port's plain
    recurrence, through the port's public entry point."""
    x = _wkv_inputs(b, s, h, d, seed=s + d)
    want_y, want_s = jwops.wkv6(*_j(*x[:5]), state=jnp.asarray(x[5]),
                                chunk=chunk)
    y, sf = wops.wkv6(*_t(*x[:5]), state=_t(x[5])[0])
    _close(want_y, y, WKV_TOL)
    _close(want_s, sf, WKV_TOL)


@pytest.mark.parametrize("s", [1, 7, 64])
def test_wkv6_zero_state_matches_the_reference_oracle(s):
    """No state (zero), ragged S and S = 1, against the reference's oracle."""
    r, k, v, w, u, _ = _wkv_inputs(2, s, 2, 32, seed=s)
    want_y, want_s = jwref.wkv6(*_j(r, k, v, w, u),
                                jnp.zeros((2, 2, 32, 32), jnp.float32))
    y, sf = wops.wkv6(*_t(r, k, v, w, u))
    _close(want_y, y, WKV_TOL)
    _close(want_s, sf, WKV_TOL)


def test_wkv6_at_full_width_decays_splits_from_the_chunked_kernel():
    """At RWKV6-7B's decays the reference's chunked kernel (the TPU's
    form) divides k by decay products that underflow float32 and returns
    non-finite values; its oracle and the port's recurrence stay finite
    and agree.  The port's chunked route runs another chunked form, whose
    every decay factor is a running product in [0, 1] and which stays
    finite there (``test_wkv6_chunked_form_matches_the_recurrence``); the
    TPU's form is the one that fails (ROADMAP.md §3)."""
    r, k, v, w, u, s0 = _wkv_inputs(1, 64, 2, 64, seed=0,
                                    decays="full_width")
    cum = np.log(w).sum(axis=1)                  # (B, H, D) over the chunk
    assert (cum < -87).any()                     # exp underflows float32
    chunked_y, _ = jwops.wkv6(*_j(r, k, v, w, u), chunk=64)
    assert not np.isfinite(np.asarray(chunked_y)).all()
    want_y, want_s = jwref.wkv6(*_j(r, k, v, w, u, s0))
    y, sf = wops.wkv6(*_t(r, k, v, w, u, s0))
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    _close(want_y, y, WKV_TOL)
    _close(want_s, sf, WKV_TOL)


def test_wkv6_decays_at_the_edges():
    """Decays of exactly 0 and 1 (and near them) stay finite in the port."""
    r, k, v, w, u, s0 = _wkv_inputs(1, 33, 2, 16, seed=5)
    w[:, ::3] = 1.0
    w[:, 1::3] = 0.0
    w[:, 2::3, 0] = 1e-30
    want_y, want_s = jwref.wkv6(*_j(r, k, v, w, u, s0))
    y, sf = wref.wkv6(*_t(r, k, v, w, u, s0))
    _close(want_y, y, WKV_TOL)
    _close(want_s, sf, WKV_TOL)


def _edge_inputs(s, seed):
    """One head of 64 with decays drawn from 0, 1e-30, 1 - 1e-7 and 1."""
    r, k, v, w, u, s0 = _wkv_inputs(1, s, 1, 64, seed)
    rng = np.random.default_rng(seed + 1)
    w = rng.choice(np.array([0.0, 1e-30, 1.0 - 1e-7, 1.0], np.float32),
                   w.shape)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("s", [1, 15, 33, 1000])
@pytest.mark.parametrize("carried", [True, False], ids=["carried", "zero"])
@pytest.mark.parametrize("decays", ["sweep", "full_width", "near_1",
                                    "edges"])
def test_wkv6_chunked_form_matches_the_recurrence(decays, carried, s,
                                                  chunk):
    """``ref.wkv6_chunked``, the chunked CUDA route's stable form with its
    3xTF32 products emulated (chunk 16 as the kernel runs it; 64 with
    sub-chunks of 16), at one head of 64, against the port's recurrence
    evaluated in float64 and against the reference's oracle (float32), on
    the same numpy inputs, finite throughout.  5e-4 as
    ``tests/test_kernels.py``; decays near 1 sum ~S undecayed outer
    products into outputs of magnitude ~S, where float32 rounding reaches
    ~1e-3 whatever the order (the oracle's own float32 result is as far
    from the exact one), so that case is held to 5e-4 of its largest
    |value|, as ``chip_smoke.py`` holds the kernel."""
    if decays == "edges":
        x = _edge_inputs(s, seed=s + chunk)
    else:
        x = _wkv_inputs(1, s, 1, 64, seed=s + chunk, decays={
            "sweep": (0.85, 0.999), "full_width": "full_width",
            "near_1": (1.0 - 1e-4, 1.0)}[decays])
    r, k, v, w, u, s0 = x
    if not carried:
        s0 = np.zeros_like(s0)
    y, sf = wref.wkv6_chunked(*_t(r, k, v, w, u, s0), chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    exact_y, exact_s = wref.wkv6(*(t.double() for t in _t(r, k, v, w, u,
                                                          s0)))
    oracle_y, oracle_s = jwref.wkv6(*_j(r, k, v, w, u, s0))
    for want_y, want_s in ((exact_y.numpy(), exact_s.numpy()),
                           (np.asarray(oracle_y), np.asarray(oracle_s))):
        atol = WKV_TOL * (float(np.abs(want_y).max())
                          if decays == "near_1" else 1.0)
        np.testing.assert_allclose(y.numpy(), want_y, atol=atol,
                                   rtol=WKV_TOL)
        np.testing.assert_allclose(sf.numpy(), want_s, atol=atol,
                                   rtol=WKV_TOL)


def test_wkv6_chunked_form_takes_whole_sub_chunks():
    x = _t(*_wkv_inputs(1, 8, 1, 16, seed=0))
    with pytest.raises(ValueError, match="multiple of 16"):
        wref.wkv6_chunked(*x, chunk=24)


@pytest.mark.parametrize("s,which", [(1, "per_token"), (15, "per_token"),
                                     (16, "chunked"), (17, "chunked"),
                                     (1024, "chunked")])
def test_wkv6_route_follows_sequence_length(s, which):
    """S alone picks the CUDA kernel: the per-token route below one whole
    chunk of 16 tokens (every decode step), the chunked one from there."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    assert wk.route(s) == which
    assert {wk.CHUNKED, wk.PER_TOKEN} == {"chunked", "per_token"}


def test_cpu_tensors_launch_no_scan_kernel():
    """On the CPU the entry points take the plain versions: no launch
    count, no route count moves."""
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    counts = lambda: (wk.launches, wk.chunked_launches,  # noqa: E731
                      wk.per_token_launches, mk.launches,
                      mk.prefill_launches, mk.decode_launches)
    before = counts()
    wops.wkv6(*_t(*_wkv_inputs(1, 20, 1, 16, seed=1)[:5]))
    mops.selective_scan(*_t(*_scan_inputs(1, 3, 8, 4, seed=2)))
    assert counts() == before


# -- the selective scan ------------------------------------------------------------
def _scan_inputs(b, s, di, n, seed, dt_kind="sweep"):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, di)).astype(np.float32)
    if dt_kind == "sweep":
        dt = rng.uniform(0.001, 0.1, (b, s, di))
        a = -rng.uniform(0.5, 2.0, (di, n))
    else:
        # Jamba's: softplus of a unit-scale projection, A = -exp(0) = -1
        dt = np.log1p(np.exp(rng.standard_normal((b, s, di))))
        a = -np.ones((di, n))
    bb, c = (rng.standard_normal((b, s, n)).astype(np.float32)
             for _ in range(2))
    h0 = (rng.standard_normal((b, di, n)) * 0.2).astype(np.float32)
    return (u, dt.astype(np.float32), a.astype(np.float32), bb, c, h0)


@pytest.mark.parametrize("b,s,di,n,bd,chunk", [
    (1, 64, 64, 8, 64, 32), (2, 128, 128, 16, 64, 64),
    (1, 96, 256, 16, 128, 32)])
def test_selective_scan_matches_the_reference_kernel(b, s, di, n, bd, chunk):
    """The sweep of ``tests/test_kernels.py``: the reference's chunked
    kernel (interpret mode) folding ``h0`` against the port's plain scan."""
    x = _scan_inputs(b, s, di, n, seed=s + di)
    want_y, want_h = jmops.selective_scan(*_j(*x[:5]), h0=jnp.asarray(x[5]),
                                          bd=bd, chunk=chunk)
    y, h = mops.selective_scan(*_t(*x))
    _close(want_y, y, SCAN_TOL)
    _close(want_h, h, SCAN_TOL)


@pytest.mark.parametrize("s,dt_kind", [(1, "jamba"), (37, "jamba"),
                                       (64, "sweep")])
def test_selective_scan_matches_the_reference_oracle(s, dt_kind):
    x = _scan_inputs(2, s, 48, 16, seed=s, dt_kind=dt_kind)
    want_y, want_h = jmref.selective_scan(*_j(*x))
    y, h = mref.selective_scan(*_t(*x))
    _close(want_y, y, SCAN_TOL)
    _close(want_h, h, SCAN_TOL)


def test_selective_scan_returns_y_in_u_dtype():
    """bf16 inputs: y comes out in bf16, the float32 result rounded once
    (as the reference's kernel writes it), h in float32; no h0 is a zero
    state."""
    u, dt, a, b, c, _ = _scan_inputs(1, 9, 32, 8, seed=3, dt_kind="jamba")
    tu, tdt, ta, tb, tc = _t(u, dt, a, b, c)
    y, h = mops.selective_scan(tu.bfloat16(), tdt.bfloat16(), ta,
                               tb.bfloat16(), tc.bfloat16())
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    want_y, want_h = mref.selective_scan(
        tu.bfloat16(), tdt.bfloat16(), ta, tb.bfloat16(), tc.bfloat16(),
        torch.zeros((1, 32, 8)))
    assert torch.equal(y, want_y.bfloat16()) and torch.equal(h, want_h)


def _decay_inputs(s, seed, regime):
    """u, b, c normal; dt and A giving decays exp(dt A) in one regime:
    Jamba's at full width (A = -1, dt = softplus(z)), near 1, near 0, or
    at the edges (exactly 1, 1 - 1e-7, ~1e-30 and exactly 0), reached
    through A with a small dt or, at a large dt, through dt (0, 1e-7,
    69.08 and 200) with A = -1."""
    rng = np.random.default_rng(seed)
    b, di, n = 2, 48, 16
    u = rng.standard_normal((b, s, di))
    a = -np.ones((di, n))
    if regime == "full_width":
        dt = np.log1p(np.exp(rng.standard_normal((b, s, di))))
    elif regime == "near_1":
        dt = 1e-4 * rng.uniform(size=(b, s, di))
    elif regime == "near_0":
        dt = rng.uniform(0.05, 0.1, (b, s, di))
        a = -rng.uniform(200.0, 300.0, (di, n))
    elif regime == "edges":
        dt = rng.choice([0.0, 1e-7, 0.1], (b, s, di))
        a = np.tile([-1.0, -690.7755, -1e30, -1.0], (di, n // 4))
    else:
        dt = rng.choice([0.0, 1e-7, 69.0776, 200.0], (b, s, di))
    bb, c = (rng.standard_normal((b, s, n)) for _ in range(2))
    h0 = rng.standard_normal((b, di, n)) * 0.2
    return [np.asarray(x, np.float32) for x in (u, dt, a, bb, c, h0)]


@pytest.mark.parametrize("s", [1, 37, 200])
@pytest.mark.parametrize("regime", ["full_width", "near_1", "near_0",
                                    "edges"])
def test_selective_scan_exp2_holds_the_float64_scan(regime, s):
    """The CUDA kernel's exponent, exp(dt A) as exp2(dt (A log2 e)) with
    A log2 e rounded once to float32 (``ref.selective_scan_exp2``), keeps
    the plain scan within 5e-5 of the scan evaluated in float64, and the
    reference's oracle (float32) agrees with both."""
    x = _decay_inputs(s, s, regime)
    y, h = mref.selective_scan_exp2(*_t(*x))
    want_y, want_h = mref.selective_scan(*(t.double() for t in _t(*x)))
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    oracle_y, oracle_h = jmref.selective_scan(*_j(*x))
    _close(oracle_y, y, SCAN_TOL)
    _close(oracle_h, h, SCAN_TOL)


@pytest.mark.parametrize("s", [37, 200])
@pytest.mark.parametrize("scan", ["selective_scan", "selective_scan_exp2"])
def test_float32_scans_at_a_large_dt_hold_the_float32_bound(scan, s):
    """At a large dt, y sums terms up to ~10^4 times its size, so no
    float32 scan meets 5e-5 at every output; the plain float32 scans (exp,
    and exp2 as the CUDA kernel takes it) and the reference's oracle stay
    within 5e-5 plus ``ref.float32_error_bound`` of the float64 scan, the
    rule ``chip_smoke.py`` holds the kernel to there.  The bound is far
    below y's own scale."""
    x = _decay_inputs(s, s, "large_dt")
    want_y, want_h = mref.selective_scan(*(t.double() for t in _t(*x)))
    bound_y, bound_h = mref.float32_error_bound(*_t(*x))
    assert float(bound_y.max()) < 1e-5 * float(want_y.abs().max())
    oracle_y, oracle_h = jmref.selective_scan(*_j(*x))
    for y, h in (getattr(mref, scan)(*_t(*x)),
                 (torch.tensor(np.asarray(oracle_y)),
                  torch.tensor(np.asarray(oracle_h)))):
        assert y.dtype == h.dtype == torch.float32
        ey = (y.double() - want_y).abs()
        eh = (h.double() - want_h).abs()
        assert bool((ey <= SCAN_TOL * (1 + want_y.abs()) + bound_y).all())
        assert bool((eh <= SCAN_TOL * (1 + want_h.abs()) + bound_h).all())


# -- the layers ----------------------------------------------------------------
def _random_params(spec_tree, seed, scale=0.5):
    """Every leaf drawn normal (zeros- and ones-initialized leaves too, so
    the biases, mus, decays and bonus all take part), as numpy."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)
    return jax.tree.map(draw, spec_tree,
                        is_leaf=lambda x: isinstance(x, JL.ParamSpec))


def _layer_setup(arch, specs_fn, seed, s=10, **overrides):
    jcfg = jreg.get_config(arch, reduced=True, **overrides)
    cfg = registry.get_config(arch, reduced=True, **overrides)
    np_params = _random_params(specs_fn(jcfg), seed)
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    xb = x.astype(ml_dtypes.bfloat16)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, np_params),
            convert.params_from_numpy(np_params, "cpu"), jnp.asarray(xb),
            convert.params_from_numpy({"x": xb}, "cpu")["x"])


def _state_pair(jstate_specs, seed):
    """A random carried state in both packages (bf16 shifts and conv
    tails, float32 recurrent states)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in jstate_specs.items():
        a = (0.5 * rng.standard_normal(spec.shape)).astype(np.float32)
        out[name] = a.astype(spec.dtype)
    return (jax.tree.map(jnp.asarray, out),
            convert.params_from_numpy(out, "cpu"))


def test_rwkv6_decay_and_group_norm_follow_the_reference():
    """The float32 pieces: the decay (whose einsums promote bf16 ``xw``
    to float32 in the reference) and the per-head group norm."""
    jcfg, cfg, jp, p, jx, x = _layer_setup("rwkv6-7b", jrwkv6.time_mix_specs,
                                           seed=1)
    w = rwkv6._decay(p, x)
    jw = jrwkv6._decay(jp, jx)
    assert w.dtype == torch.float32
    # exp(-exp(x)) multiplies exp(x)'s relative error by exp(x), so decays
    # near 0 are held to an absolute 1e-7 beside the relative 1e-5
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-7)
    h = rwkv6.num_rwkv_heads(cfg)
    y = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32) * 3)
    got = rwkv6._group_norm(y, p["ln_scale"], p["ln_bias"], h)
    want = jrwkv6._group_norm(jnp.asarray(y.numpy()), jp["ln_scale"],
                              jp["ln_bias"], h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rwkv6_token_shift_and_ddlerp_are_the_references_bits():
    jcfg, cfg, jp, p, jx, x = _layer_setup("rwkv6-7b", jrwkv6.time_mix_specs,
                                           seed=2)
    prev = x[:, 3:4]
    for jprev, tprev in ((None, None), (jx[:, 3:4], prev)):
        jxx = jrwkv6._token_shift(jx, jprev)
        xx = rwkv6._token_shift(x, tprev)
        np.testing.assert_array_equal(
            np.asarray(jxx.astype(jnp.float32)), xx.float().numpy())
    with jax.disable_jit():
        want = jrwkv6._ddlerp(jp, jx, jxx)
    for i, (w, g) in enumerate(zip(want, rwkv6._ddlerp(p, x, xx))):
        assert_rel(w, g, EAGER_TOL, f"ddlerp {i}")


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_rwkv6_time_and_channel_mix_match_the_eager_reference(impl, carried):
    """``apply_time_mix`` and ``apply_channel_mix`` (sequence mode, or a
    carried random state written in place) against the eager reference:
    outputs to 1e-2 of the largest value, the new states to 5e-4 (wkv)
    and bitwise (the bf16 shifts)."""
    jcfg, cfg, jp, p, jx, x = _layer_setup(
        "rwkv6-7b", jrwkv6.time_mix_specs, seed=3, attn_impl=impl)
    jstate = state = None
    if carried:
        jstate, state = _state_pair(jrwkv6.init_time_state(jcfg, 2), 4)
    with jax.disable_jit():
        want, jnew = jrwkv6.apply_time_mix(jp, jx, jcfg, None, jstate)
    got, new = rwkv6.apply_time_mix(p, x, cfg, state)
    assert_rel(want, got, EAGER_TOL, "time mix")
    if carried:
        assert new is state
        _close(jnew["wkv"], new["wkv"], WKV_TOL)
        np.testing.assert_array_equal(
            np.asarray(jnew["shift"].astype(jnp.float32)),
            new["shift"].float().numpy())

    np_cm = _random_params(jrwkv6.channel_mix_specs(jcfg), 5)
    jcm = jax.tree.map(jnp.asarray, np_cm)
    cm = convert.params_from_numpy(np_cm, "cpu")
    jstate = state = None
    if carried:
        jstate, state = _state_pair(jrwkv6.init_channel_state(jcfg, 2), 6)
    with jax.disable_jit():
        want, jnew = jrwkv6.apply_channel_mix(jcm, jx, jcfg, None, jstate)
    got, new = rwkv6.apply_channel_mix(cm, x, cfg, state)
    assert_rel(want, got, EAGER_TOL, "channel mix")
    if carried:
        np.testing.assert_array_equal(
            np.asarray(jnew["shift"].astype(jnp.float32)),
            new["shift"].float().numpy())


def test_mamba_pieces_are_the_references_bits():
    """The causal conv (taps summed in order), the dt/B/C RMS norms and
    softplus (``logaddexp(x, 0)`` op by op in bf16) against the eager
    reference, bitwise."""
    jcfg, cfg, jp, p, jx, x = _layer_setup(
        "jamba-v0.1-52b", jmamba.mamba_specs, seed=7)
    di = mamba.d_inner(cfg)
    rng = np.random.default_rng(8)
    xin = rng.standard_normal((2, 10, di)).astype(ml_dtypes.bfloat16)
    prev = rng.standard_normal((2, cfg.ssm_conv - 1, di)).astype(
        ml_dtypes.bfloat16)
    t = convert.params_from_numpy({"x": xin, "p": prev}, "cpu")
    cw = p["conv_w"].bfloat16()
    cb = p["conv_b"].bfloat16()
    with jax.disable_jit():
        for jprev, tprev in ((None, None), (jnp.asarray(prev), t["p"])):
            want = jmamba._causal_conv(
                jnp.asarray(xin), jp["conv_w"].astype(jnp.bfloat16),
                jp["conv_b"].astype(jnp.bfloat16), jprev)
            got = mamba._causal_conv(t["x"], cw, cb, tprev)
            np.testing.assert_array_equal(np.asarray(want, np.float32),
                                          got.float().numpy())
        z = jnp.asarray(xin[..., :cfg.ssm_state]) * 4
        want_rms = jmamba._rms(z, jp["b_norm"])
        want_sp = jax.nn.softplus(z)
    tz = t["x"][..., :cfg.ssm_state] * 4
    np.testing.assert_array_equal(
        np.asarray(want_rms, np.float32),
        mamba._rms(tz, p["b_norm"]).float().numpy())
    np.testing.assert_array_equal(np.asarray(want_sp, np.float32),
                                  mamba.softplus(tz).float().numpy())


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_mamba_mixer_matches_the_eager_reference(impl, carried):
    """``apply_mamba`` (sequence mode, or a carried random state written
    in place) against the eager reference: output to 1e-2 of the largest
    value, h to 5e-5, the bf16 conv tail bitwise."""
    jcfg, cfg, jp, p, jx, x = _layer_setup(
        "jamba-v0.1-52b", jmamba.mamba_specs, seed=9, attn_impl=impl)
    # decays and steps as the model meets them: a_log near 0, dt_bias 0
    jp = dict(jp, a_log=jp["a_log"] * 0.1, dt_bias=jp["dt_bias"] * 0)
    p = dict(p, a_log=p["a_log"] * 0.1, dt_bias=p["dt_bias"] * 0)
    jstate = state = None
    if carried:
        jstate, state = _state_pair(jmamba.init_mamba_state(jcfg, 2), 10)
    with jax.disable_jit():
        want, jnew = jmamba.apply_mamba(jp, jx, jcfg, None, jstate)
    got, new = mamba.apply_mamba(p, x, cfg, state)
    assert_rel(want, got, EAGER_TOL, "mamba")
    if carried:
        assert new is state
        _close(jnew["h"], new["h"], SCAN_TOL)
        np.testing.assert_array_equal(
            np.asarray(jnew["conv"].astype(jnp.float32)),
            new["conv"].float().numpy())


@pytest.mark.parametrize("arch,mixer", [("rwkv6-7b", "rwkv6"),
                                        ("jamba-v0.1-52b", "mamba")])
def test_flash_and_reference_scans_compute_one_function(arch, mixer):
    """On the CPU ``attn_impl="flash"`` routes the scans through the
    kernels' entry points (their plain versions here): the same bits as
    the model's own plain scan."""
    cfg = registry.get_config(arch, reduced=True)
    flash = dataclasses.replace(cfg, attn_impl="flash")
    specs = (rwkv6.time_mix_specs if mixer == "rwkv6"
             else mamba.mamba_specs)(cfg)
    params = L.init_params(torch.Generator().manual_seed(0), specs, "cpu")
    x = torch.randn((2, 7, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    apply = (rwkv6.apply_time_mix if mixer == "rwkv6"
             else mamba.apply_mamba)
    assert torch.equal(apply(params, x, cfg)[0], apply(params, x, flash)[0])
