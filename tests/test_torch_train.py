"""The port's train step (``repro_torch.train.step``) against the JAX
package's (``repro.train.step``): the reference's own parameters
(``init_train_state(PRNGKey(0))``, carried across with
``models.convert.params_from_numpy``) and the same numpy-seeded batch go
through both, one step per arch at the reduced size of
``tests/test_smoke_archs.py`` (seq 32, batch 2).

Float rules.  The models compute in bf16 and the port follows the
reference's eager per-op rounding (ROADMAP.md, "bf16 rounding").  The
bf16 tests run the reference compiled with XLA's excess precision off
(``xla_allow_excess_precision=False``), so that every bf16 op rounds its
result as in the eager run (``jax.disable_jit()``), for far less compile
time than the eager run's op-by-op compiles.  Forward, the packages
agree to a few bf16 ulps; backward, bf16 gradients are long sums and
products that the libraries accumulate in other orders, so a gradient
element can move by several bf16 ulps of its leaf's largest one (up to ~15 % of it for a leaf like Jamba's
``dt_norm``, whose gradient sums bf16 products over every position).
So:

* the gradients' logic is held tightly where nothing rounds to bf16:
  both packages computing in float32 (the reference through ``jax.jit``,
  which changes no rounding in float32), each leaf within 1e-3 of its
  largest |g|;
* in bf16, the loss within 1e-3 relative, the grad norm within 5e-2
  relative and each leaf within 0.25 of its largest |g|;
* the update ``new_p - p`` in units of lr.  At step 1 AdamW's bias
  correction makes ``mhat / sqrt(vhat)`` +-1 for every element, so an
  element whose gradient the two orders put on opposite sides of 0 moves
  by 2 lr: the elements whose reference |g| is below the gradient
  tolerance may come apart (by more than 1e-3 lr); their count is
  reported and bounded by a share of the elements; every other element
  agrees.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import _tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenDataset
from repro_torch.models import convert, lm, registry
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FailureInjector, run_with_recovery
from repro_torch.train import step as tstep

ARCHS = list(jreg.ARCH_NAMES)
SEQ, BATCH = 32, 2
OPT = dict(total_steps=10, warmup_steps=2)
LOSS_TOL = 1e-3         # relative: a few bf16 ulps of the logits
GNORM_TOL = 5e-2        # relative: bf16 gradient sums (see above)
GRAD_TOL = 0.25         # of each leaf's largest |g|, bf16
GRAD_TOL_F32 = 1e-3     # of each leaf's largest |g|, float32 compute
UPDATE_TOL = 1e-3       # in units of lr
APART_SHARE = 0.15      # of a model's elements, all below GRAD_TOL


def _bf16_values(a) -> np.ndarray:
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


def _setup(arch, microbatches=1, **overrides):
    jcfg = jreg.get_config(arch, reduced=True, **overrides)
    cfg = registry.get_config(arch, reduced=True, **overrides)
    jstate = jstep.init_train_state(jcfg, jax.random.PRNGKey(0))
    state = convert.params_from_numpy(jax.tree.map(np.asarray, jstate),
                                      "cpu")
    rng = np.random.default_rng(0)
    st = jreg.text_len(jcfg, SEQ)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, st)),
             "labels": rng.integers(0, cfg.vocab_size, (BATCH, st))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    # the stub frontends' embeddings, bf16 values (the reference casts
    # them to bf16 whatever the compute dtype)
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = _bf16_values(rng.standard_normal(
            (BATCH, cfg.num_prefix_embeds, cfg.d_model)))
    if cfg.frontend == "audio":
        batch["frame_embeds"] = _bf16_values(rng.standard_normal(
            (BATCH, SEQ // cfg.src_ratio, cfg.d_model)))
    jt = jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**OPT),
                           microbatches=microbatches)
    tt = tstep.TrainConfig(optimizer=adamw.AdamWConfig(**OPT),
                           microbatches=microbatches)
    return (jcfg, cfg, jstate, state, jax.tree.map(jnp.asarray, batch),
            {k: torch.from_numpy(v) for k, v in batch.items()}, jt, tt)


def _per_op_rounding(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off: each bf16
    op rounds its result to bf16, as in the eager run."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _grads_read_back(m_leaves, gnorm, tcfg) -> list:
    """Each leaf's gradient as a step from a zero state saw it, read back
    from the first moment it left: m = (1 - b1) * clip(g), with clip(g) =
    g * min(1, max_norm / (norm + 1e-9)) (two roundings of float32)."""
    opt = tcfg.optimizer
    scale = min(1.0, opt.grad_clip_norm / (float(gnorm) + 1e-9))
    return [np.asarray(m, np.float64) / (1 - opt.beta1) / scale
            for m in m_leaves]


def _rel(want, got) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _check_step(arch, state, jnew, jm, new, m, ref_grads):
    """Loss, grad norm and lr against the reference's; the update in units
    of lr, elements apart only where the reference's |g| is below the
    gradient tolerance.  Returns the count of elements apart."""
    assert set(m) == set(jm) == {"loss", "aux_loss", "grad_norm", "lr"}
    assert _rel(jm["loss"], m["loss"]) <= LOSS_TOL, (arch, jm, m)
    assert _rel(jm["grad_norm"], m["grad_norm"]) <= GNORM_TOL, (arch, jm, m)
    assert abs(float(m["aux_loss"]) - float(jm["aux_loss"])) <= \
        LOSS_TOL * max(1.0, abs(float(jm["aux_loss"]))), (arch, jm, m)
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == \
        int(state["opt"]["step"]) + 1
    lr = float(jm["lr"])
    apart = total = 0
    before = _tree.tree_flatten_with_path(state["params"])[0]
    for (path, p0), jp, p1, g in zip(
            before, jax.tree.leaves(jnew["params"]),
            _tree.tree_leaves(new["params"]), ref_grads):
        assert p1.dtype == p0.dtype and p1.shape == p0.shape, path
        p0 = p0.float().numpy()
        du = np.abs((np.asarray(jp, np.float32) - p0)
                    - (p1.float().numpy() - p0)) / lr
        far = du > UPDATE_TOL
        small = np.abs(g) <= GRAD_TOL * np.abs(g).max()
        assert not np.any(far & ~small), (arch, path, float(du.max()))
        apart += int(far.sum())
        total += far.size
    assert apart <= APART_SHARE * total, (arch, apart, total)
    return apart


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    jcfg, cfg, jstate, state, jbatch, batch, jt, tt = _setup(arch)
    jnew, jm = _per_op_rounding(jstep.make_train_step(jcfg, jt), jstate,
                                jbatch)
    new, m = tstep.make_train_step(cfg, tt)(state, batch)
    assert all(bool(torch.isfinite(v)) for v in m.values()), m
    ref_grads = _grads_read_back(jax.tree.leaves(jnew["opt"]["m"]),
                                 jm["grad_norm"], jt)
    for (path, _), want, got in zip(
            _tree.tree_flatten_with_path(state["params"])[0], ref_grads,
            _grads_read_back(_tree.tree_leaves(new["opt"]["m"]),
                             m["grad_norm"], tt)):
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= GRAD_TOL * scale, \
            (arch, path)
    apart = _check_step(arch, state, jnew, jm, new, m, ref_grads)
    print(f"{arch}: {apart} elements apart by more than {UPDATE_TOL} lr")
    # at least one parameter changed (tests/test_smoke_archs.py)
    assert any(not torch.equal(a, b) for a, b in zip(
        _tree.tree_leaves(state["params"]), _tree.tree_leaves(new["params"])))


def _float32_compute(monkeypatch):
    """Both packages compute in float32: the reference's embedding cast
    (which sets every later op's dtype) and the port's compute dtype."""
    embed = jlayers.embed_tokens
    monkeypatch.setattr(jlayers, "embed_tokens",
                        lambda p, t, rules, compute_dtype=None:
                        embed(p, t, rules, compute_dtype=jnp.float32))
    monkeypatch.setattr(lm, "COMPUTE_DTYPE", torch.float32)


# seamless's reference casts its audio frames to bf16 whatever the
# embedding's dtype (repro/models/encdec.py), so it has no float32 twin
@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a != "seamless-m4t-medium"])
def test_gradients_match_the_reference_in_float32(arch, monkeypatch):
    _float32_compute(monkeypatch)
    jcfg, cfg, jstate, state, jbatch, batch, _, _ = _setup(arch)

    def loss(p):
        return jstep.loss_and_metrics(p, jbatch, jcfg, None, 0.01)[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jstate["params"])
    flat, treedef = _tree.tree_flatten(state["params"])
    live = [p.detach().requires_grad_() for p in flat]
    tloss, _ = tstep.loss_and_metrics(
        _tree.tree_unflatten(treedef, live), batch, cfg, 0.01)
    grads = torch.autograd.grad(tloss, live, allow_unused=True,
                                materialize_grads=True)
    # a float32 forward summed in other orders: 1e-5 relative
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    for (path, _), want, got in zip(
            _tree.tree_flatten_with_path(state["params"])[0],
            jax.tree.leaves(jgrads), grads):
        want = np.asarray(want, np.float32)
        scale = float(np.abs(want).max())
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= GRAD_TOL_F32 * scale, (arch, path, err / scale)


def test_microbatches_match_the_references_scan():
    """microbatches=2: the port's loop (zeros + g1 + g2, then / 2; the
    metrics' mean) against the reference's ``lax.scan`` path."""
    jcfg, cfg, jstate, state, jbatch, batch, jt, tt = _setup(
        "qwen2-1.5b", microbatches=2)
    jnew, jm = _per_op_rounding(jstep.make_train_step(jcfg, jt), jstate,
                                jbatch)
    new, m = tstep.make_train_step(cfg, tt)(state, batch)
    ref_grads = _grads_read_back(jax.tree.leaves(jnew["opt"]["m"]),
                                 jm["grad_norm"], jt)
    apart = _check_step("qwen2-1.5b", state, jnew, jm, new, m, ref_grads)
    print(f"microbatches=2: {apart} elements apart")
    # the metrics are the microbatches' mean: the loss of each half alone
    halves = [tstep.loss_and_metrics(
        state["params"], {k: v[i:i + 1] for k, v in batch.items()}, cfg,
        0.01)[0] for i in range(2)]
    assert float(m["loss"]) == float((halves[0] + halves[1]) / 2)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-7b",
                                  "jamba-v0.1-52b"])
def test_training_refuses_flash_as_the_reference_cannot(arch):
    """No kernel of either package has a backward pass: the port refuses
    ``attn_impl="flash"`` before it runs, on any device; the reference
    fails inside jax's differentiation of its ``pallas_call``."""
    cfg = registry.get_config(arch, reduced=True, attn_impl="flash")
    with pytest.raises(ValueError, match="no kernel of either package"):
        tstep.make_train_step(cfg, tstep.TrainConfig())
    if arch != "qwen2-1.5b":
        return
    jcfg, _, jstate, _, jbatch, _, jt, _ = _setup(arch, attn_impl="flash")
    with pytest.raises(AssertionError):
        jax.jit(jstep.make_train_step(jcfg, jt))(jstate, jbatch)


def test_an_unreached_leaf_gets_a_zero_gradient_and_decays():
    """A leaf the loss does not reach gets zeros, as ``jax.grad`` gives,
    and AdamW still decays it (ndim > 1)."""
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    state = tstep.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    state["params"]["unused"] = torch.ones((3, 2))
    state["opt"] = adamw.init_state(state["params"])
    batch = registry.make_train_batch(cfg, 16, 2, device="cpu")
    new, m = tstep.make_train_step(cfg, tstep.TrainConfig(
        optimizer=adamw.AdamWConfig(**OPT)))(state, batch)
    assert float(new["opt"]["m"]["unused"].abs().max()) == 0.0
    lr = float(m["lr"])
    want = torch.full((3, 2), 1.0 - lr * 0.1)
    assert torch.allclose(new["params"]["unused"], want, rtol=0, atol=1e-7)


def test_init_train_state_runs_on_the_card_unless_asked(monkeypatch):
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tstep.init_train_state(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        registry.make_train_batch(cfg, 16, 2)
    state = tstep.init_train_state(cfg, device="cpu")
    leaves = _tree.tree_leaves(state)
    assert {t.device.type for t in leaves} == {"cpu"}
    assert state["opt"]["step"].dtype == torch.int32
    assert (_tree.tree_flatten(state["params"])[1]
            == _tree.tree_flatten(state["opt"]["m"])[1])


def test_recovery_trajectory_matches_failure_free(tmp_path):
    """The twin of
    tests/test_substrate.py::test_recovery_trajectory_matches_failure_free,
    port against port: training with injected failures lands where
    failure-free training does, to the reference's atol=1e-6 (bitwise on
    the CPU)."""
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(total_steps=20,
                                                         warmup_steps=2))
    step = tstep.make_train_step(cfg, tcfg)
    ds = TokenDataset(cfg, DataConfig(seq_len=16, global_batch=2))

    def fn(state, i):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
        return step(state, batch)[0]

    def init():
        return tstep.init_train_state(cfg, torch.Generator().manual_seed(5),
                                      "cpu")

    clean = init()
    for i in range(12):
        clean = fn(clean, i)

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    rep = run_with_recovery(
        init_state=init, step_fn=fn, ckpt=mgr, num_steps=12,
        checkpoint_every=3, injector=FailureInjector({5: 0, 9: 1}))
    assert rep.failures_recovered == 2
    recovered, final_step = mgr.restore(init())
    state = recovered
    for i in range(final_step + 1, 12):
        state = fn(state, i)
    want = _tree.tree_leaves(clean["params"])[0]
    got = _tree.tree_leaves(state["params"])[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    # the whole state, every leaf, bit for bit
    for a, b in zip(_tree.tree_leaves(clean), _tree.tree_leaves(state)):
        assert torch.equal(a, b)
