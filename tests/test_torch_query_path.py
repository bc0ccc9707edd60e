"""The port's query endpoint against the JAX package's, end to end on the
CPU: the paper's §VI queries and the cases of tests/test_polystore.py
(relational, array, text, cast and catalog paths), the binary, staged and
quant migrations, and both int8 policies of the TensorPolystore.  Both
packages load the same numpy-seeded MIMIC demo at the sizes of the
test_polystore fixture; values and dtypes must be equal, float sums
within ``assert_same``'s stated tolerance.

Both deployments carry the streaming island's ``streamstore0`` (added
last), so their catalogs match whole.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datamodel as jdm
from repro.core.api import default_deployment as jax_deployment
from repro.core.executor import QueryExecutionPlan as JaxPlan
from repro.core.migrator import MigrationParams as JaxParams
from repro.core.tensorstore import PlacementPolicy as JaxPolicy
from repro.core.tensorstore import TensorPolystore as JaxStore
from repro.data.mimic import load_mimic_demo as jax_load
from repro_torch.core import bql
from repro_torch.core.api import default_deployment
from repro_torch.core.executor import QueryExecutionPlan
from repro_torch.core.interop import from_numpy, load_objects, to_numpy
from repro_torch.core.migrator import MigrationParams
from repro_torch.core.tensorstore import PlacementPolicy, TensorPolystore
from repro_torch.data.mimic import load_mimic_demo
from test_torch_support import assert_same, jax_desc

SIZES = dict(num_patients=64, num_orders=256, wave_len=512, num_logs=32)


@pytest.fixture(scope="module")
def pair():
    jbd = jax_deployment()
    jax_load(jbd, **SIZES)
    bd = default_deployment(device="cpu")
    load_mimic_demo(bd, **SIZES)
    return jbd, bd


def _values(resp):
    v = resp.value
    return to_numpy(v) if not isinstance(v, list) else [
        (k, to_numpy(x)) for k, x in v] if v and isinstance(v[0], tuple) \
        else v


def _jax_values(resp):
    v = resp.value
    if isinstance(v, list) and v and isinstance(v[0], tuple):
        return [(k, jax_desc(x)) for k, x in v]
    return jax_desc(v)


# (query, float-sum fields) — lean mode; every query here has one engine
# placement holding its objects, or equal results on each placement
QUERIES = [
    ("bdrel(select * from mimic2v26.d_patients limit 4)", ()),
    ("bdrel(select count(*) from mimic2v26.d_patients where sex = 1)", ()),
    ("bdrel(select sex, avg(dob_year) from mimic2v26.d_patients"
     " group by sex)", ("avg_dob_year",)),
    ("bdrel(select subject_id, count(*) from mimic2v26.poe_order"
     " group by subject_id)", ()),
    ("bdrel(select poe_id, dose from mimic2v26.poe_order where dose > 25.0"
     " order by dose desc limit 10)", ()),
    ("bdrel(select icustay_id, poe_id from mimic2v26.poe_order"
     " order by icustay_id desc)", ()),
    ("bdrel(select distinct subject_id, poe_id from mimic2v26.poe_order)",
     ()),
    ("bdrel(select sum(dose) from mimic2v26.poe_order)", ("sum_dose",)),
    ("bdrel(select avg(dob_year) from mimic2v26.d_patients)",
     ("avg_dob_year",)),
    ("bdrel(select max(dob_year) from mimic2v26.d_patients)", ()),
    ("bdrel(select * from mimic2v26.poe_order, mimic2v26.d_patients where"
     " mimic2v26.poe_order.subject_id = mimic2v26.d_patients.subject_id"
     " and dose < 10.0)", ()),
    ("bdarray(filter(myarray, dim1>150))", ()),
    ("bdarray(aggregate(mimic2v26.waveform, avg(signal)))",
     ("avg_signal",)),
    # (the AFL splitter counts < and > as brackets: nested conditions
    # use = and !=)
    ("bdarray(aggregate(filter(mimic2v26.waveform, lead = 3),"
     " count(*)))", ()),
    ("bdarray(aggregate(filter(mimic2v26.waveform, lead != 0),"
     " max(signal)))", ()),
    ("bdarray(sort(project(myarray, val), val))", ()),
    ("bdarray(redimension(myarray, <val:double>[a=0:15,16,0,"
     " b=0:15,16,0]))", ()),
    ("bdarray(cross_join(filter(myarray, dim1 = 2), scan(myarray)))", ()),
    ("bdtext({ 'op' : 'range', 'table' : 'mimic_logs',"
     " 'range' : { 'start' : ['r_0001','',''],"
     " 'end' : ['r_0015','',''] } })", ()),
    ("bdtext({ 'op' : 'scan', 'table' : 'mimic_logs' })", ()),
]


@pytest.mark.parametrize("query,sums", QUERIES,
                         ids=[f"q{i}" for i in range(len(QUERIES))])
def test_island_query(pair, query, sums):
    jbd, bd = pair
    assert_same(_jax_values(jbd.query(query)), _values(bd.query(query)),
                sum_tol=sums)


# name -> (query, engine of each island node in post order); the casts
# between them all take one route
CASTS = {
    # paper §VI-e: relational -> array with the destination schema
    "rel_to_array": (
        "bdarray(scan(bdcast(bdrel(select poe_id, subject_id from"
        " mimic2v26.poe_order), poe_order_copy,"
        " '<subject_id:int32>[poe_id=0:*,10000000,0]', array)))",
        ("hoststore0", "densehbm0")),
    "array_to_rel": (
        "bdrel(select * from bdcast(bdarray(filter(myarray, dim1>200)),"
        " arr_rel, '<val:double>[dim1=0:*,256,0]', relational)"
        " order by val limit 7)",
        ("densehbm0", "hoststore0")),
    "double_nested": (
        "bdrel(select * from bdcast(bdarray(filter(bdcast(bdrel(select"
        " poe_id, dose from mimic2v26.poe_order), x,"
        " '<dose:double>[poe_id=0:*,1000,0]', array), poe_id > 100)),"
        " y, 'y', relational) limit 3)",
        ("hoststore0", "densehbm0", "hoststore0")),
}


@pytest.mark.parametrize("method", ["binary", "staged"])
@pytest.mark.parametrize("name", sorted(CASTS))
def test_cast_query_pinned_plan(pair, name, method):
    """Each cast route in both packages, placement pinned (the Monitor's
    straggler avoidance would otherwise let timing noise pick engines)."""
    from repro.core import bql as jbql
    jbd, bd = pair
    query, engines = CASTS[name]
    node_engines = dict(enumerate(engines))
    casts = {cid: method for cid in range(len(engines) - 1)}
    jres = jbd.planner.executor.execute_plan(
        JaxPlan(jbql.parse(query), node_engines, casts))
    res = bd.planner.executor.execute_plan(
        QueryExecutionPlan(bql.parse(query), node_engines, casts))
    assert jres.qep_id == res.qep_id
    assert_same(jax_desc(jres.value), to_numpy(res.value))
    assert [s for s, _ in jres.stages] == [s for s, _ in res.stages]


def test_cast_query_training_mode():
    """§VI-e in training mode on fresh deployments: the plan is chosen by
    measured time and may differ between packages (the staged route
    makes float32 columns), so compare the values as numbers."""
    jbd = jax_deployment()
    jax_load(jbd, **SIZES)
    bd = default_deployment(device="cpu")
    load_mimic_demo(bd, **SIZES)
    q = CASTS["rel_to_array"][0]
    jr, r = jbd.query(q, training=True), bd.query(q, training=True)
    assert r.plans_considered == jr.plans_considered == 4
    assert r.value.dim_names == jr.value.dim_names == ("poe_id",)
    for n in jr.value.attrs:
        np.testing.assert_array_equal(
            to_numpy(r.value.attrs[n]).astype(np.float64),
            np.asarray(jr.value.attrs[n], np.float64))
    lean = bd.query(q)
    assert lean.qep_id == r.qep_id and lean.plan_cache_hit


@pytest.mark.parametrize("table", ["engines", "objects", "casts", "islands",
                                   "shims", "databases"])
def test_catalog_rows(pair, table):
    jbd, bd = pair
    port = bd.query(f"bdcatalog(select * from {table})").value
    ref = jbd.query(f"bdcatalog(select * from {table})").value
    assert ref == port
    names = bd.query("bdcatalog(select name from engines)").value
    assert {"hoststore0", "densehbm0", "kvstore0", "streamstore0"} <= {
        r["name"] for r in names}


# -- migrations ----------------------------------------------------------------
MIGRATIONS = [
    ("hoststore0", "mimic2v26.poe_order", "densehbm0", "binary"),
    ("hoststore0", "mimic2v26.poe_order", "densehbm0", "staged"),
    ("hoststore0", "mimic2v26.d_patients", "hoststore1", "binary"),
    ("hoststore0", "mimic2v26.d_patients", "kvstore0", "staged"),
    ("densehbm0", "mimic2v26.waveform", "hoststore0", "staged"),
    ("densehbm0", "mimic2v26.waveform", "kvstore0", "binary"),
    ("densehbm0", "mimic2v26.waveform", "kvstore0", "quant"),
    ("densehbm0", "myarray", "kvstore0", "staged"),
    ("kvstore0", "mimic_logs", "hoststore1", "staged"),
]


@pytest.mark.parametrize("src,obj,dst,method", MIGRATIONS)
def test_migration_routes(pair, src, obj, dst, method):
    jbd, bd = pair
    dest = f"mig_{obj}_{dst}_{method}"
    jres = jbd.migrator.migrate(jbd.engines[src], obj, jbd.engines[dst],
                                dest, JaxParams(method=method))
    res = bd.migrator.migrate(bd.engines[src], obj, bd.engines[dst],
                              dest, MigrationParams(method=method))
    assert (res.bytes_moved, res.rows, res.method) \
        == (jres.bytes_moved, jres.rows, jres.method)
    assert_same(jax_desc(jbd.engines[dst].get(dest)),
                to_numpy(bd.engines[dst].get(dest)))


def test_quant_migration_of_kv_pages(pair):
    """ArrayObject -> KV pages (binary), then the pages' int8 re-coding."""
    jbd, bd = pair
    for b, params in ((jbd, JaxParams), (bd, MigrationParams)):
        b.migrator.migrate(b.engines["densehbm0"], "mimic2v26.waveform",
                           b.engines["kvstore0"], "wave_pages",
                           params(method="binary"))
        b.migrator.migrate(b.engines["kvstore0"], "wave_pages",
                           b.engines["kvstore0"], "wave_pages_q",
                           params(method="quant"))
    assert_same(jax_desc(jbd.engines["kvstore0"].get("wave_pages_q")),
                to_numpy(bd.engines["kvstore0"].get("wave_pages_q")))


def test_quant_migration_bounded_error(pair):
    from repro_torch.kernels.quant_cast import ops as qops
    _, bd = pair
    src, dst = bd.engines["densehbm0"], bd.engines["kvstore0"]
    bd.migrator.migrate(src, "mimic2v26.waveform", dst, "wave_q",
                        MigrationParams(method="quant"))
    q = dst.get("wave_q")["signal"]
    orig = src.get("mimic2v26.waveform").attrs["signal"]
    back = qops.dequantize(q["q"], q["scale"], orig.shape)
    bound = float(orig.abs().max()) / 127.0 * 1.01
    assert float((back - orig).abs().max()) <= bound


# -- TensorPolystore int8 policies -----------------------------------------------
def _state(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    shapes = {"wte": (40, 16), "blocks": [{"w": (16, 16), "b": (16,)},
                                          {"w": (16, 16), "b": (16,)}]}
    tree = lambda: {"wte": f(*shapes["wte"]), "blocks": [  # noqa: E731
        {k: f(*s) for k, s in blk.items()} for blk in shapes["blocks"]]}
    return {"params": tree(), "opt": {"m": tree(), "v": tree(),
                                      "step": np.asarray(3, np.int32)}}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree)


def test_tensorstore_compressed_moments():
    state = _state(0)
    jbd = jax_deployment()
    jstore = JaxStore(jbd, JaxPolicy(moments="compressed"))
    jstore.register_train_state("lm", _to_jax(state))
    bd = default_deployment(device="cpu")
    store = TensorPolystore(bd, PlacementPolicy(moments="compressed"))
    store.register_train_state("lm", from_numpy(state, "cpu"))
    assert_same(jax_desc(jbd.engines["kvstore0"].get("lm/opt/m")),
                to_numpy(bd.engines["kvstore0"].get("lm/opt/m")))
    assert_same(jax_desc(jstore.fetch_train_state("lm")),
                to_numpy(store.fetch_train_state("lm")))
    assert bd.catalog.object_by_name("lm/opt/v") is not None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tensorstore_int8_kv_pages(writer):
    """int8 KV pages written by one package fetch identically in both."""
    rng = np.random.default_rng(1)
    cache = [{"k": rng.standard_normal((2, 16, 2, 8)).astype(np.float32),
              "v": rng.standard_normal((2, 16, 2, 8)).astype(np.float32)}
             for _ in range(3)]
    jcache = [{k: jnp.asarray(v, jnp.bfloat16) for k, v in layer.items()}
              for layer in cache]
    tcache = [{k: torch.from_numpy(v).to(torch.bfloat16)
               for k, v in layer.items()} for layer in cache]
    jbd, bd = jax_deployment(), default_deployment(device="cpu")
    jstore = JaxStore(jbd, JaxPolicy(kv_codec="int8"))
    store = TensorPolystore(bd, PlacementPolicy(kv_codec="int8"))
    if writer == "jax":
        jstore.register_kv_cache("qwen", jcache)
        pages = jax_desc(jbd.engines["kvstore0"].get("qwen/kv_cache"))
        load_objects(bd, {"kvstore0": {"qwen/kv_cache": pages}})
    else:
        store.register_kv_cache("qwen", tcache)
        pages = to_numpy(bd.engines["kvstore0"].get("qwen/kv_cache"))
        jbd.engines["kvstore0"].put("qwen/kv_cache", _to_jax(pages))
    want = jstore.fetch_kv_cache("qwen", template=jcache)
    got = store.fetch_kv_cache("qwen", template=tcache)
    assert all(t.dtype == torch.bfloat16 for layer in got
               for t in layer.values())
    assert_same([{k: np.asarray(v.astype(jnp.float32)) for k, v in
                  layer.items()} for layer in want], to_numpy(got))


def test_later_slices_raise_not_implemented(pair):
    """The streaming island's durable streams (the shim's ``replay`` and
    ``recover_stream``) come with a later slice; the ml island, ported
    since, dispatches to its own shim (which takes ``infer`` on an
    MLEngine only)."""
    from repro_torch.core import shims
    from repro_torch.core.migrator import reshard
    from repro_torch.stream.ml import MLException
    _, bd = pair
    with pytest.raises(ValueError, match="unsupported ml op"):
        shims.execute("ml", bd.engines["densehbm0"], "x")
    with pytest.raises(MLException, match="need an MLEngine"):
        shims.execute("ml", bd.engines["densehbm0"],
                      "infer(window(s, 4), models.lm)")
    with pytest.raises(NotImplementedError, match="Durability slice"):
        shims.execute("streaming", bd.engines["streamstore0"],
                      "replay(any.stream)")
    with pytest.raises(NotImplementedError, match="Durability slice"):
        bd.recover_stream("streamstore0", "/nonexistent")
    t = torch.arange(5, dtype=torch.int32)
    moved = reshard(t, "cpu")
    assert moved.device.type == "cpu" and torch.equal(moved, t)
