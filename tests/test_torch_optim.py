"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's (``repro.optim.adamw``) on identical numpy-seeded inputs, the
reference called eagerly (each jnp op alone, as the port's torch ops).

Float rules: the schedule, the moments and the update are float32
elementwise arithmetic in the reference's order, so they agree to the
ulp: XLA's and torch's ``cos`` and ``pow`` may each round their last bit
differently, and ``1 - b**step`` feeds that bit into ``mhat`` and
``vhat``.  The global norm is a float32 reduction the two libraries sum
in other orders: 1e-6 relative.  The int8 moment codes and scales are
bitwise (the reference's Pallas kernel runs in interpret mode here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch import _tree
from repro_torch.optim import adamw

F32 = np.float32


def _ulps(want, got) -> np.ndarray:
    """|got - want| in units of float32's spacing at |want|."""
    want = np.asarray(want, F32)
    got = np.asarray(got, F32)
    return np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))


def _t(tree):
    return _tree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_at_is_the_references(schedule):
    cfg = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100,
               schedule=schedule)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    for step in (0, 1, 9, 50, 99, 10_000):
        want = float(jadamw.lr_at(jcfg, jnp.int32(step)))
        got = adamw.lr_at(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        # 2 ulp: cos (cosine schedule) may round its last bit otherwise
        assert _ulps(want, got.item()) <= 2, (step, want, got.item())


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 3)).astype(F32) * 30,
            "b": {"c": rng.standard_normal((5,)).astype(F32),
                  "d": F32(rng.standard_normal())}}


def test_global_norm_and_clip_are_the_references():
    g = _grads(0)
    want_n = float(jadamw.global_norm(_j(g)))
    got_n = float(adamw.global_norm(_t(g)))
    # a float32 sum of squares, summed in another order: 1e-6 relative
    assert got_n == pytest.approx(want_n, rel=1e-6)
    for max_norm in (1.0, 0.3, 1e6):
        want, wn = jadamw.clip_by_global_norm(_j(g), max_norm)
        got, gn = adamw.clip_by_global_norm(_t(g), max_norm)
        assert float(gn) == pytest.approx(float(wn), rel=1e-6)
        for w, t in zip(jax.tree.leaves(want), _tree.tree_leaves(got)):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6)


def _update_inputs(seed):
    """params, grads, m, v with a leaf of each ndim 0..3; one gradient
    element exactly 0, one 1e-9 (below eps)."""
    rng = np.random.default_rng(seed)
    shapes = {"s": (), "bias": (7,), "w": (6, 5), "stack": (2, 4, 3)}
    p = {k: rng.standard_normal(s).astype(F32) for k, s in shapes.items()}
    g = {k: (rng.standard_normal(s) * 0.1).astype(F32)
         for k, s in shapes.items()}
    g["w"][0, 0] = 0.0
    g["w"][0, 1] = 1e-9
    m = {k: (rng.standard_normal(s) * 0.01).astype(F32)
         for k, s in shapes.items()}
    v = {k: (rng.random(s) * 1e-3).astype(F32) for k, s in shapes.items()}
    return p, g, m, v


@pytest.mark.parametrize("step", [1, 7])
def test_apply_updates_is_the_references(step):
    cfg = dict(learning_rate=3e-4, warmup_steps=2, total_steps=10)
    p, g, m, v = _update_inputs(step)
    jstate = {"m": _j(m), "v": _j(v), "step": jnp.int32(step - 1)}
    tstate = {"m": _t(m), "v": _t(v),
              "step": torch.tensor(step - 1, dtype=torch.int32)}
    want_p, want_s = jadamw.apply_updates(jadamw.AdamWConfig(**cfg), _j(p),
                                          _j(g), jstate)
    got_p, got_s = adamw.apply_updates(adamw.AdamWConfig(**cfg), _t(p),
                                       _t(g), tstate)
    assert got_s["step"].dtype == torch.int32
    assert int(got_s["step"]) == int(want_s["step"]) == step
    lr = float(jadamw.lr_at(jadamw.AdamWConfig(**cfg), jnp.int32(step)))
    for key in p:
        for moment in ("m", "v"):
            # the same three float32 ops in the same order: 1 ulp
            assert _ulps(want_s[moment][key],
                         got_s[moment][key].numpy()).max() <= 1, (key, moment)
        w = np.asarray(want_p[key], F32)
        t = got_p[key].numpy()
        assert t.dtype == w.dtype and t.shape == w.shape
        # 2 ulp of the parameter, plus lr * 1e-6: the bias corrections
        # 1 - b**step may differ in their last bit (pow), which moves
        # mhat / sqrt(vhat) (at most ~1) by ~1e-7 of itself
        slack = 2 * np.spacing(np.abs(w)) + lr * 1e-6
        assert np.all(np.abs(t - w) <= slack), key


def test_adamw_minimizes_quadratic():
    """The twin of tests/test_substrate.py::test_adamw_minimizes_quadratic,
    gradients by autograd."""
    cfg = adamw.AdamWConfig(learning_rate=0.1, weight_decay=0.0,
                            warmup_steps=0, total_steps=200,
                            schedule="constant")
    target = torch.tensor([3.0, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = adamw.init_state(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        (grad,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        params, state = adamw.apply_updates(cfg, params, {"w": grad}, state)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-3
    assert int(state["step"]) == 200


def test_grad_clip_and_lr_schedule():
    """The twin of tests/test_substrate.py::test_grad_clip_and_lr_schedule."""
    grads = {"a": torch.full((4,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    cfg = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=10,
                            total_steps=100)
    lrs = [float(adamw.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 9, 50, 99)]
    assert lrs[0] < lrs[1]                      # warmup rises
    assert lrs[1] > lrs[2] > lrs[3]             # cosine decays


def test_init_state_is_the_references_tree():
    p = {"w": torch.ones((3, 2)), "b": {"x": torch.ones(4,
                                                        dtype=torch.bfloat16)}}
    state = adamw.init_state(p)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for key in ("m", "v"):
        assert state[key]["w"].dtype == torch.float32
        assert state[key]["b"]["x"].dtype == torch.float32
        assert float(state[key]["w"].abs().sum()) == 0.0


def _moment_state(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((64, 32)).astype(F32),
              "odd": {"b": rng.standard_normal((3, 7, 33)).astype(F32),
                      "s": rng.standard_normal((5,)).astype(F32)}}
    v = jax.tree.map(lambda a: np.abs(a) * F32(0.01), params)
    v["odd"]["s"][:] = 0.0                       # an all-zero block
    return params, v


def test_compress_moments_int8_codes_are_the_references():
    params, v = _moment_state(0)
    jstate = {**jadamw.init_state(_j(params)), "v": _j(v)}
    tstate = {**adamw.init_state(_t(params)), "v": _t(v)}
    want = jadamw.compress_moments_int8(jstate)
    got = adamw.compress_moments_int8(tstate)
    for path, shape in (("w", (64, 32)), ("odd/b", (3, 7, 33)),
                        ("odd/s", (5,))):
        w, t = want["v"], got["v"]
        for k in path.split("/"):
            w, t = w[k], t[k]
        np.testing.assert_array_equal(t["q"].numpy(), np.asarray(w["q"]),
                                      strict=True)
        np.testing.assert_array_equal(t["scale"].numpy(),
                                      np.asarray(w["scale"]), strict=True)
        assert tuple(t["shape"]) == tuple(w["shape"]) == shape
    # m and step pass through untouched
    assert got["m"] is tstate["m"] and got["step"] is tstate["step"]
    back = adamw.decompress_moments_int8(got)
    jback = jadamw.decompress_moments_int8(want)
    for w, t in zip(jax.tree.leaves(jback["v"]), _tree.tree_leaves(back["v"])):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w), strict=True)


def test_int8_moment_compression_roundtrip():
    """The twin of
    tests/test_substrate.py::test_int8_moment_compression_roundtrip."""
    params = {"w": torch.from_numpy(np.random.default_rng(0)
                                    .standard_normal((64, 32))
                                    .astype(F32))}
    state = adamw.init_state(params)
    state["v"] = _tree.tree_map(lambda p: torch.abs(p) * 0.01, params)
    back = adamw.decompress_moments_int8(adamw.compress_moments_int8(state))
    err = float(torch.max(torch.abs(back["v"]["w"] - state["v"]["w"])))
    assert err <= float(torch.max(state["v"]["w"])) / 127.0 * 1.01
    assert back["v"]["w"].shape == (64, 32)
