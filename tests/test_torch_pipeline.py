"""The port's token pipeline (``repro_torch.data.pipeline``) against the
JAX package's (``repro.data.pipeline``), and the polystore training loop:
batches as relational Tables in the HostStore, cast to the array island
by the Migrator, into the train step, and the trained state registered
in the catalog through the TensorPolystore.

``TokenDataset`` is numpy in both packages, so its batches are bitwise;
so are the Tables built from them.  The training loop's losses are float
reductions over a bf16 model: the reference runs compiled with XLA's
excess precision off (every bf16 op rounds, as in the eager run the port
follows; ``tests/test_torch_train.py``).  The first step's loss agrees to
1e-3 relative (a few bf16 ulps of the logits); each later one follows
parameters that AdamW's sign-like first updates (+-lr wherever the two
libraries' gradients straddle 0) have moved apart by a few lr on a few
per cent of the elements: 1e-2 relative.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.api import default_deployment as jdefault_deployment
from repro.data import pipeline as jpipe
from repro.models import registry as jreg
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import step as jstep
from repro_torch import _tree
from repro_torch.core.api import default_deployment
from repro_torch.core.datamodel import ArrayObject, Table
from repro_torch.core.migrator import MigrationParams
from repro_torch.core.tensorstore import PlacementPolicy, TensorPolystore
from repro_torch.data.pipeline import (DataConfig, TokenDataset,
                                       batch_as_table, table_as_batch)
from repro_torch.models import convert, registry
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    make_train_step)

FIRST_LOSS_TOL, LATER_LOSS_TOL = 1e-3, 1e-2


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internvl2-2b",
                                  "seamless-m4t-medium"])
def test_batches_are_the_references_bitwise(arch):
    """Several steps, hosts 0 and 1 of 2, and the stub frontends'
    embeddings (tests/test_substrate.py:157)."""
    jcfg = jreg.get_config(arch, reduced=True)
    cfg = registry.get_config(arch, reduced=True)
    for host in (0, 1):
        dc = dict(seq_len=24, global_batch=4, seed=3, num_hosts=2,
                  host_id=host)
        want = jpipe.TokenDataset(jcfg, jpipe.DataConfig(**dc))
        got = TokenDataset(cfg, DataConfig(**dc))
        assert got.local_batch == want.local_batch == 2
        for step in (0, 1, 7, 1000):
            w, g = want.batch_at(step), got.batch_at(step)
            assert sorted(w) == sorted(g)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], strict=True)
    a = TokenDataset(cfg, DataConfig(seq_len=16, global_batch=4,
                                     num_hosts=2, host_id=0))
    b = TokenDataset(cfg, DataConfig(seq_len=16, global_batch=4,
                                     num_hosts=2, host_id=1))
    assert not np.array_equal(a.batch_at(3)["tokens"],
                              b.batch_at(3)["tokens"])
    assert not np.array_equal(a.batch_at(3)["tokens"],
                              a.batch_at(4)["tokens"])
    assert a.batch_at(3)["tokens"].max() < cfg.vocab_size
    with pytest.raises(ValueError, match="hosts"):
        TokenDataset(cfg, DataConfig(global_batch=3, num_hosts=2))


def test_iterating_a_dataset_steps_through_its_batches():
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    ds = TokenDataset(cfg, DataConfig(seq_len=8, global_batch=2))
    it = iter(ds)
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      ds.batch_at(step)["tokens"])


def test_batch_table_is_the_references_and_round_trips():
    """The Table's columns, dtypes and values are the reference's; a
    Table and its array-island cast both come back as the int32 batch
    (tests/test_substrate.py:173)."""
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    ds = TokenDataset(cfg, DataConfig(seq_len=8, global_batch=2))
    batch = ds.batch_at(0)
    table = batch_as_table(batch, device="cpu")
    want = jpipe.batch_as_table(batch)
    assert isinstance(table, Table)
    assert list(table.columns) == list(want.columns)
    for name, col in want.columns.items():
        np.testing.assert_array_equal(table.columns[name].numpy(),
                                      np.asarray(col), strict=True)
    for obj in (table, ArrayObject(dict(table.columns), ("i",))):
        back = table_as_batch(obj, 2, 8)
        for key in ("tokens", "labels"):
            assert back[key].dtype == torch.int32
            assert back[key].device == torch.device("cpu")
            np.testing.assert_array_equal(back[key].numpy(), batch[key])


def test_batch_as_table_runs_on_the_card_unless_asked(monkeypatch):
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    ds = TokenDataset(cfg, DataConfig(seq_len=8, global_batch=2))
    batch = ds.batch_at(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        batch_as_table(batch)


def _through_the_polystore(bd, raw, table_of):
    """HostStore (relational) -> binary cast -> DenseHBM (array) ->
    the batch, as tests/test_system.py:23 routes it."""
    bd.engines["hoststore0"].put("train_batch", table_of(raw))
    bd.migrator.migrate(bd.engines["hoststore0"], "train_batch",
                        bd.engines["densehbm0"], "train_batch_dev",
                        MigrationParams(method="binary"))
    return bd.engines["densehbm0"].get("train_batch_dev")


def test_end_to_end_polystore_training_loop():
    """The twin of
    tests/test_system.py::test_end_to_end_polystore_training_loop: three
    steps on one batch through the polystore in each package, from the
    reference's parameters; the losses agree and fall, and the trained
    state lands in the catalog."""
    jcfg = jreg.get_config("qwen2-1.5b", reduced=True)
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    opt = dict(learning_rate=3e-3, total_steps=30, warmup_steps=3)
    ds = TokenDataset(cfg, DataConfig(seq_len=16, global_batch=4, seed=1))
    raw = ds.batch_at(0)                       # same batch -> must overfit

    jbd = jdefault_deployment()
    jstate = jstep.init_train_state(jcfg, jax.random.PRNGKey(0))
    jtrain = jstep.make_train_step(jcfg, jstep.TrainConfig(
        optimizer=JAdamWConfig(**opt)))
    jbatch = jpipe.table_as_batch(_through_the_polystore(
        jbd, raw, jpipe.batch_as_table), 4, 16)
    # excess precision off: each bf16 op rounds, as in the eager run
    jstep_fn = jax.jit(jtrain).lower(jstate, jbatch).compile(
        compiler_options={"xla_allow_excess_precision": False})

    bd = default_deployment(device="cpu")
    ts = TensorPolystore(bd, PlacementPolicy(moments="resident"))
    state = convert.params_from_numpy(jax.tree.map(np.asarray, jstate),
                                      "cpu")
    train = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(**opt)))

    want, got = [], []
    for _ in range(3):
        jbatch = jpipe.table_as_batch(_through_the_polystore(
            jbd, raw, jpipe.batch_as_table), 4, 16)
        jstate, jm = jstep_fn(jstate, jbatch)
        want.append(float(jm["loss"]))
        obj = _through_the_polystore(
            bd, raw, lambda b: batch_as_table(b, device="cpu"))
        assert isinstance(obj, ArrayObject)
        batch = table_as_batch(obj, 4, 16)
        np.testing.assert_array_equal(batch["tokens"].numpy(), raw["tokens"])
        state, m = train(state, batch)
        got.append(float(m["loss"]))
    print("losses, reference / port:", want, got)
    for i, (w, g) in enumerate(zip(want, got)):
        tol = FIRST_LOSS_TOL if i == 0 else LATER_LOSS_TOL
        assert abs(g - w) <= tol * abs(w), (i, want, got)
    assert got[-1] < got[0] and want[-1] < want[0], (want, got)
    assert int(state["opt"]["step"]) == 3

    ts.register_train_state("qwen2-reduced", state)
    rows = bd.query("bdcatalog(select name from objects)").value
    assert any("qwen2-reduced/params" == r["name"] for r in rows)


@pytest.mark.parametrize("policy", ["resident", "offload", "compressed"])
def test_a_train_state_round_trips_the_tensor_store(policy):
    """``init_train_state``'s tree is the one the TensorPolystore
    registers and fetches (tests/test_substrate.py's
    ``test_tensorstore_policies_roundtrip``): params and step bitwise, the
    moments within the int8 codec's half scale when compressed."""
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    ts = TensorPolystore(default_deployment(device="cpu"),
                         PlacementPolicy(moments=policy))
    state = init_train_state(cfg, torch.Generator().manual_seed(1), "cpu")
    state["opt"]["v"] = _tree.tree_map(lambda p: p.abs() * 0.05,
                                       state["params"])
    ts.register_train_state("t", state)
    back = ts.fetch_train_state("t")
    for a, b in zip(_tree.tree_leaves(state["params"]),
                    _tree.tree_leaves(back["params"])):
        assert torch.equal(a, b)
    assert torch.equal(back["opt"]["step"], state["opt"]["step"])
    for v0, v1 in zip(_tree.tree_leaves(state["opt"]["v"]),
                      _tree.tree_leaves(back["opt"]["v"])):
        assert v1.shape == v0.shape and v1.dtype == torch.float32
        tol = (float(v0.abs().max()) / 127.0 * 1.01
               if policy == "compressed" else 0.0)
        assert float((v0 - v1).abs().max()) <= tol
