"""The port's sharded path against the JAX package's plans, and the port
sharded against itself unsharded.

* Plan parity, bitwise: for every arch and applicable shape on the two
  production meshes (16 x 16 and 2 x 16 x 16), ``pick_rules``' rule
  tuple, every leaf's partition and shard shape in the param (float32
  and bfloat16), train-state, batch, decode-batch and cache plans, the
  per-device argument bytes, ``active_params``, ``microbatches_for`` and
  ``seq_scan_correction``.  The reference is built on
  ``jax.sharding.AbstractMesh`` (no devices); the port on a
  ``DeviceMesh`` over a fake process group of the mesh's size.
* The cases of ``tests/test_launch.py``: the divisibility fallback, the
  kv policy, Command R+'s spec tree without allocation, the ring
  factors of the wire-byte estimate.
* Sharded numerics: four ``gloo`` ranks on a (2, 2) ("data", "model")
  mesh run five families (dense GQA with a sequence-sharded cache, MoE
  on the capacity path, RWKV6, the Jamba hybrid, the encoder-decoder)
  forward, one train step, prefill and two decode steps under
  ``default_rules``, against the port unsharded on rank 0; in the
  float32 twin, every leaf's gradient as well.
* Block remat: gradients bitwise those of ``remat="none"``.
"""
import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.models import registry as jregistry

from repro_torch import _tree
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as S
from repro_torch.models import encdec, lm, registry
from repro_torch.optim import adamw
from repro_torch.sharding import logical as L
from repro_torch.train import step as tstep


@pytest.fixture(scope="module")
def jdry():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` put back as
    it was (its import asks for 512 host devices, which would hold for
    every later jax start in this process)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


@pytest.fixture(scope="module")
def meshes():
    """{multi_pod: (the port's mesh, the reference's abstract mesh)};
    the port's plans read only the meshes' names and sizes, so the
    256-device mesh outlives its fake group."""
    M.fake_world(256)
    single = M.make_production_mesh(device="cpu")
    M.fake_world(512)
    pod = M.make_production_mesh(multi_pod=True, device="cpu")
    yield {False: (single, AbstractMesh((16, 16), ("data", "model"))),
           True: (pod, AbstractMesh((2, 16, 16), ("pod", "data", "model")))}
    if dist.is_initialized():
        dist.destroy_process_group()


def _same_plan(jplan, tplan, tmesh, what):
    """Two (structs, shardings) plans agree leaf for leaf: partition,
    shard shape and element size; returns the per-device bytes."""
    jstructs, jshards = jplan
    tstructs, tparts = tplan
    jl = jax.tree.leaves(jstructs)
    js = jax.tree.leaves(jshards)
    tl = _tree.tree_leaves(tstructs)
    tp = _tree.tree_leaves(tparts)
    assert len(jl) == len(tl) == len(js) == len(tp), what
    total = 0
    for i, (a, sa, b, pb) in enumerate(zip(jl, js, tl, tp)):
        assert tuple(sa.spec) == tuple(pb), (what, i, sa.spec, pb)
        shard = L.shard_shape(b.shape, pb, tmesh)
        assert tuple(sa.shard_shape(a.shape)) == shard, (what, i)
        assert a.dtype.itemsize == b.element_size(), (what, i)
        n = 1
        for d in shard:
            n *= d
        total += n * b.element_size()
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_plans_equal_the_reference(arch, multi_pod, meshes, jdry):
    tmesh, jmesh = meshes[multi_pod]
    cfg = registry.get_config(arch, moe_dropless=False)
    jcfg = jregistry.get_config(arch, moe_dropless=False)
    trules = S.pick_rules(cfg, tmesh)
    jrules = jspecs.pick_rules(jcfg, jmesh)
    assert tuple(trules.rules) == tuple(jrules.rules)

    specs = registry.param_specs(cfg)
    jspec_tree = jregistry.param_specs(jcfg)
    n_total, n_active = D.active_params(cfg, specs)
    assert (n_total, n_active) == jdry.active_params(jcfg, jspec_tree)

    params = {}
    for dt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        _, ts, tp = S.param_structs_and_shardings(cfg, tmesh, trules,
                                                  dtype=dt)
        _, js, jp = jspecs.param_structs_and_shardings(jcfg, jmesh, jrules,
                                                       dtype=jdt)
        params[dt] = _same_plan((js, jp), (ts, tp), tmesh, f"params {dt}")
    state = _same_plan(jspecs.train_state_specs(jcfg, jmesh, jrules),
                       S.train_state_specs(cfg, tmesh, trules), tmesh,
                       "train state")

    for name, shape in SHAPES.items():
        if not applicable(cfg, shape)[0]:
            continue
        jshape = JSHAPES[name]
        batch = _same_plan(jspecs.batch_specs(jcfg, jshape, jmesh),
                           S.batch_specs(cfg, shape, tmesh), tmesh, name)
        dbatch = _same_plan(jspecs.decode_batch_specs(jcfg, jshape, jmesh),
                            S.decode_batch_specs(cfg, shape, tmesh), tmesh,
                            name)
        cache = _same_plan(
            jspecs.cache_structs_and_shardings(jcfg, jshape, jmesh, jrules),
            S.cache_structs_and_shardings(cfg, shape, tmesh, trules),
            tmesh, name)
        if shape.kind == "train":
            want = state + batch
        elif shape.kind == "prefill":
            labels = jspecs.batch_specs(jcfg, jshape, jmesh)
            lab = labels[1]["labels"].shard_shape(
                labels[0]["labels"].shape)
            want = params[torch.bfloat16] + batch - 4 * lab[0] * lab[1] \
                + cache
        else:
            want = params[torch.bfloat16] + dbatch + cache + 4
        built = D.build_step(arch, name, tmesh)
        assert D._argument_bytes(built, tmesh) == want, name

        assert (D.microbatches_for(cfg, shape, tmesh, n_total)
                == jdry.microbatches_for(jcfg, jshape, jmesh, n_total))
        tokens = (shape.global_batch * shape.seq_len
                  if shape.kind != "decode" else shape.global_batch)
        devices = 512 if multi_pod else 256
        assert (D.seq_scan_correction(cfg, tokens, devices, shape.kind)
                == jdry.seq_scan_correction(jcfg, tokens, devices,
                                            shape.kind))


# ---------------------------------------------------------------------------
# The cases of tests/test_launch.py
# ---------------------------------------------------------------------------
@pytest.fixture
def world():
    """A fake world of the size a test asks for, destroyed after it."""
    def start(n):
        M.fake_world(n)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_sharding_divisibility_fallback(world):
    world(2)
    mesh = M.make_mesh((1, 2), ("data", "model"), device="cpu")
    rules = L.default_rules(mesh)
    # 12 heads on model=2 divides -> sharded; 13 doesn't -> replicated
    ok = L.sharding_for(L.ParamSpec((64, 12, 8),
                                    (L.EMBED, L.HEADS, L.HEAD_DIM)),
                        mesh, rules)
    bad = L.sharding_for(L.ParamSpec((64, 13, 8),
                                     (L.EMBED, L.HEADS, L.HEAD_DIM)),
                         mesh, rules)
    assert ok[1] == "model"
    assert bad[1] is None
    # and constrain falls back alike on a tensor of 13 heads
    from torch.distributed.tensor import Replicate, Shard
    x = L.distribute(torch.zeros(2, 4, 13, 8), L.P(None, None, None, None),
                     mesh)
    y = L.constrain(x, rules, (L.BATCH, L.SEQ, L.HEADS, L.HEAD_DIM))
    assert tuple(y.placements) == (Shard(0), Replicate())
    z = L.constrain(L.distribute(torch.zeros(2, 4, 12, 8),
                                 L.P(None, None, None, None), mesh),
                    rules, (L.BATCH, L.SEQ, L.HEADS, L.HEAD_DIM))
    assert tuple(z.placements) == (Shard(0), Shard(2))


def test_pick_rules_kv_policy(world):
    world(32)
    mesh = M.make_mesh((2, 16), ("data", "model"), device="cpu")
    # kv=16 divides model=16 -> heads sharded, cache seq unsharded
    r1 = S.pick_rules(registry.get_config("olmoe-1b-7b"), mesh)
    assert r1.mesh_axes(L.KV_HEADS) == "model"
    assert r1.mesh_axes(L.KV_SEQ) is None
    # kv=8 does not divide 16 -> cache sequence sharded instead
    r2 = S.pick_rules(registry.get_config("command-r-35b"), mesh)
    assert r2.mesh_axes(L.KV_HEADS) is None
    assert r2.mesh_axes(L.KV_SEQ) == "model"


def test_spec_tree_structs_no_allocation():
    cfg = registry.get_config("command-r-plus-104b")   # 104B: specs only
    specs = registry.param_specs(cfg)
    structs = L.spec_tree_structs(specs)
    assert L.count_params(specs) > 95e9                # ~104B params
    leaf = _tree.tree_leaves(structs)[0]
    assert leaf.device.type == "meta"


def test_wire_bytes_ring_factors():
    st = D.wire_bytes([("all-reduce", 1024 * 4, 4),
                       ("all-gather", 2048 * 2, 2),
                       ("reduce-scatter", 256 * 4, 4),
                       ("collective-permute", 100 * 4, 1),
                       ("all-to-all", 512 * 4, 8)])
    assert st["all-reduce"]["count"] == 1
    assert st["all-reduce"]["bytes"] == pytest.approx(2 * 1024 * 4 * 3 / 4)
    assert st["all-gather"]["bytes"] == pytest.approx(2048 * 2 * 1 / 2)
    assert st["reduce-scatter"]["bytes"] == pytest.approx(256 * 4 * 3)
    assert st["collective-permute"]["bytes"] == 100 * 4
    assert st["all-to-all"]["bytes"] == pytest.approx(512 * 4 * 7 / 8)
    assert st["total_bytes"] > 0


def test_wire_bytes_ignores_trivial_groups():
    assert D.wire_bytes([("all-reduce", 4096, 1)])["all-reduce"]["count"] \
        == 0


def test_placements_follow_mesh_order(meshes):
    from torch.distributed.tensor import Replicate, Shard
    pod = meshes[True][0]
    assert L.placements(L.P(("pod", "data"), None, "model"), pod) == (
        Shard(0), Shard(0), Shard(2))
    assert L.placements(L.P(None, "data"), pod) == (
        Replicate(), Shard(1), Replicate())
    assert L.shard_shape((128, 64, 32), L.P(("pod", "data"), None, "model"),
                         pod) == (4, 64, 2)


def test_constrain_is_a_no_op_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    rules = L.single_device_rules()
    assert L.constrain(x, None, (L.BATCH, L.SEQ, L.ACT_EMBED)) is x
    assert L.constrain(x, rules, (L.BATCH, L.SEQ, L.ACT_EMBED)) is x


# ---------------------------------------------------------------------------
# Sharded numerics: 4 gloo ranks against the port unsharded
# ---------------------------------------------------------------------------
# (arch, config overrides, also run in bf16).  Every family runs its
# float32 twin, held to 1e-5 of the largest logit: MoE routes, whose bf16
# near-ties can flip, are compared there.  The dense model also runs in
# bf16, where sharding reorders bf16 sums (partial products rounded
# before they are added): held to the distance of its own unsharded bf16
# run from the float32 one, which on these random models is several
# percent of the largest logit.
FAMILIES = (
    ("qwen2-1.5b", {}, True),
    ("olmoe-1b-7b", {"moe_dropless": False}, False),
    ("rwkv6-7b", {}, False),
    ("jamba-v0.1-52b", {}, False),
    ("seamless-m4t-medium", {}, False),
)
B, SEQ, CACHE = 4, 8, 16


def _batch(cfg, rng):
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ),
                                  dtype=np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, SEQ),
                                  dtype=np.int32)}
    if cfg.frontend == "audio":
        out["frame_embeds"] = rng.standard_normal(
            (B, max(1, SEQ // cfg.src_ratio), cfg.d_model)).astype(
                np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _shard_tree(tree, parts, mesh):
    flat, treedef = _tree.tree_flatten(tree)
    return _tree.tree_unflatten(treedef, [
        L.distribute(t, p, mesh)
        for t, p in zip(flat, _tree.tree_leaves(parts))])


def _full(x):
    return x.full_tensor() if L.is_dtensor(x) else x


def _steps(cfg, params, batch, cache, rules):
    """forward logits, the train step's loss and grad norm, and the
    logits of prefill and two decode steps; and, leaf by leaf, the first
    moment after the train step ((1 - b1) times the clipped gradient)."""
    logits, _ = registry.forward(params, batch, cfg, rules)
    state = {"params": params, "opt": adamw.init_state(params)}
    new, metrics = tstep.make_train_step(cfg, tstep.TrainConfig(),
                                         rules)(state, batch)
    moments = [_full(m) for m in _tree.tree_leaves(new["opt"]["m"])]
    pb = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        pre, cache, extras = registry.prefill(params, pb, cache, cfg, rules)
        out = [_full(logits), _full(metrics["loss"]),
               _full(metrics["grad_norm"]), _full(pre)]
        tok = batch["tokens"][:, :1]
        for pos in (SEQ, SEQ + 1):
            step, cache = registry.decode_step(
                params, {"tokens": tok, **extras}, cache, pos, cfg, rules)
            out.append(_full(step))
    return out, moments


def _errors(got, want):
    """Each logits output's largest error over its largest |logit| (the
    loss and the grad norm, outputs 1 and 2, left out)."""
    return [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max())
            for i, (a, b) in enumerate(zip(got, want)) if i not in (1, 2)]


def _leaf_errors(got, want):
    """Each leaf's largest error over its largest |value|; a leaf that is
    zero unsharded must be zero sharded."""
    out = []
    for a, b in zip(got, want):
        d, m = float((a - b).abs().max()), float(b.abs().max())
        out.append(d / m if m > 0 else (0.0 if d == 0 else float("inf")))
    return out


def _family(arch, over, bf16_too, mesh, rank):
    """This rank's sharded run of one family (float32 twin, then bf16 if
    asked); rank 0 also runs it unsharded and returns the errors."""
    report, plain_f32 = {}, None
    for f32 in ((True, False) if bf16_too else (True,)):
        saved = lm.COMPUTE_DTYPE, encdec.COMPUTE_DTYPE
        if f32:
            lm.COMPUTE_DTYPE = encdec.COMPUTE_DTYPE = torch.float32
        try:
            cfg = registry.get_config(arch, reduced=True, **over)
            rules = S.pick_rules(cfg, mesh)
            specs = registry.param_specs(cfg)
            params = L.init_params(torch.Generator().manual_seed(0), specs,
                                   "cpu")
            batch = _batch(cfg, np.random.default_rng(1))
            cache_specs = registry.cache_specs(cfg, B, CACHE)
            cache = registry.init_cache(cfg, B, CACHE, "cpu")
            ba = S._batch_axes(mesh, B)
            sharded, moments = _steps(
                cfg, _shard_tree(params, L.spec_tree_shardings(
                    specs, mesh, rules), mesh),
                {k: L.distribute(v, L.P(ba, *([None] * (v.ndim - 1))), mesh)
                 for k, v in batch.items()},
                _shard_tree(cache, L.spec_tree_shardings(
                    cache_specs, mesh, rules), mesh), rules)
            if rank == 0:
                plain, plain_moments = _steps(cfg, params, batch,
                               registry.init_cache(cfg, B, CACHE, "cpu"),
                               None)
                # rules on plain tensors change nothing, bit for bit
                again, _ = registry.forward(params, batch, cfg, rules)
                r = {"logits": _errors(sharded, plain),
                     "loss": float((sharded[1] - plain[1]).abs()),
                     "loss_rel": float((sharded[1] - plain[1]).abs()
                                       / plain[1].abs()),
                     "moments": _leaf_errors(moments, plain_moments),
                     "grad_norm": float((sharded[2] - plain[2]).abs()
                                        / plain[2].abs()),
                     "finite": all(bool(torch.isfinite(t).all())
                                   for t in sharded),
                     "rules_plain_bitwise": bool(torch.equal(again,
                                                             plain[0]))}
                if f32:
                    plain_f32 = plain
                else:
                    r["bf16_noise"] = max(_errors(plain, plain_f32))
                report["f32" if f32 else "bf16"] = r
        finally:
            lm.COMPUTE_DTYPE, encdec.COMPUTE_DTYPE = saved
    return report


def _gloo_worker(rank, port, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = M.make_mesh((2, 2), ("data", "model"), device="cpu")
        report = {arch: _family(arch, over, bf16_too, mesh, rank)
                  for arch, over, bf16_too in FAMILIES}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo") / "report.json"
    torch.multiprocessing.spawn(_gloo_worker, args=(_free_port(), str(out)),
                                nprocs=4, join=True)
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", [f[0] for f in FAMILIES])
def test_sharded_family_matches_unsharded(arch, gloo_report):
    rep = gloo_report[arch]
    assert "f32" in rep
    for key, r in rep.items():
        tol = 1e-5 if key == "f32" else r["bf16_noise"]
        assert r["finite"], (arch, key)
        assert max(r["logits"]) <= tol, (arch, key, r["logits"])
        assert r["loss"] <= 1e-3, (arch, key, r["loss"])
        assert r["grad_norm"] <= 5e-2, (arch, key, r["grad_norm"])
        assert r["rules_plain_bitwise"], (arch, key)
    # the float32 twin's gradients, leaf by leaf (read from the first
    # moment): a leaf's gradient scaled or summed over the wrong ranks
    # would hardly move the global norm above.  Each leaf is held to 1e-3
    # of its largest value, the float32 gradient bound of
    # tests/test_torch_train.py: float32 rounding alone puts the unsharded
    # run up to 1.2e-4 of a leaf's largest from a float64 run (seamless's
    # decoder), and the sharded run no further.
    f32 = rep["f32"]
    assert f32["loss_rel"] <= 1e-6, (arch, f32["loss_rel"])
    bad = [(i, e) for i, e in enumerate(f32["moments"]) if not e <= 1e-3]
    assert not bad, (arch, bad)


# ---------------------------------------------------------------------------
# Block remat
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "seamless-m4t-medium"])
def test_block_remat_gradients_are_bitwise(arch):
    grads = {}
    for remat in ("block", "none"):
        cfg = registry.get_config(arch, reduced=True, remat=remat)
        params = L.init_params(torch.Generator().manual_seed(0),
                               registry.param_specs(cfg), "cpu")
        batch = _batch(cfg, np.random.default_rng(2))
        flat, treedef = _tree.tree_flatten(params)
        live = [p.requires_grad_() for p in flat]
        loss, _ = tstep.loss_and_metrics(_tree.tree_unflatten(treedef, live),
                                         batch, cfg, 0.01)
        grads[remat] = (loss.detach(),
                        torch.autograd.grad(loss, live, allow_unused=True,
                                            materialize_grads=True))
    assert torch.equal(grads["block"][0], grads["none"][0])
    for a, b in zip(grads["block"][1], grads["none"][1]):
        assert torch.equal(a, b)
