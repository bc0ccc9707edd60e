"""The ICU analyst: a closed loop of one client issuing the paper's §VI
queries through the query endpoint (``BigDawg.query`` in lean mode: the
plan cache, the executor, the islands' shims, the Migrator's casts) and
a waveform record's migration through the quant route
(``Migrator.migrate``, method ``quant``: ``quant_cast`` on the card).  A
query's latency runs from its submission to its result's values on the
host.

The MIMIC II tables and the waveform store are drawn from the seed on
the card and registered with the deployment's engines
(``BigDawg.register_object``, one array object a waveform record).  The
reference judges the results against host copies of the tables taken
before the system under test saw them, and against the waveform store
drawn again from the seed once the system under test has freed it.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from portbench.core.checks import Check
from portbench.core.hostcopy import keep, to_host
from portbench.core.stats import percentile
from portbench.reference import queries as qref

BIG = ("cast_rel_to_array", "quant_route")   # results kept by a sample


def _tables(ctx):
    from portbench.core.manifest import load_module
    return load_module(ctx.cell.bench_dir / "traffic" / "mimic_tables.py",
                       "tables")


def _sizes(ctx) -> Dict[str, int]:
    sizes = dict(ctx.config["tables"])
    sizes.update(ctx.params.get("tables", {}))
    return sizes


def _load(bd, data, schema, record_name) -> None:
    from repro_torch.core import datamodel as dm
    pat = dm.Table({k: data["d_patients"][k] for k in schema["d_patients"]})
    bd.register_object("hoststore0", "mimic2v26.d_patients", pat,
                       fields=tuple(pat.fields))
    poe = dm.Table({k: data["poe_order"][k] for k in schema["poe_order"]})
    bd.register_object("hoststore0", "mimic2v26.poe_order", poe,
                       fields=tuple(poe.fields))
    bd.register_object("hoststore1", "mimic2v26.poe_order", poe,
                       fields=tuple(poe.fields))
    for r in range(data["store"].shape[0]):
        wave = dm.ArrayObject(attrs={"signal": data["store"][r]},
                              dim_names=("lead", "tick"))
        bd.register_object("densehbm0", record_name(r), wave,
                           fields=("signal",))
    arr = dm.ArrayObject(attrs={"val": data["myarray"]},
                         dim_names=("dim1",))
    bd.register_object("densehbm0", "myarray", arr, fields=("val",))
    keys, values = data["logs"]
    bd.register_object("kvstore0", "mimic_logs", dm.KVTable(keys, values),
                       fields=("row", "colfam", "colqual", "value"))


def _run(st, q):
    """One query of the mix, its result on the host."""
    bd = st["bd"]
    if q.kind == "quant_route":
        from repro_torch.core.migrator import MigrationParams
        bd.migrator.migrate(bd.engines["densehbm0"],
                            st["record_name"](q.const["r"]),
                            bd.engines["kvstore0"], "wave_q",
                            MigrationParams(method="quant"))
        return to_host(bd.engines["kvstore0"].get("wave_q"))
    return to_host(bd.query(q.bql, training=False).value)


def setup(ctx):
    from repro_torch.core.api import default_deployment

    sizes = _sizes(ctx)
    schema = ctx.config["schema"]
    data = _tables(ctx).make(sizes, ctx.seed, ctx.device)
    # the reference's copies, taken before the system under test sees
    # the tables
    host = {"d_patients": {k: data["d_patients"][k].cpu().numpy()
                           for k in schema["d_patients"]},
            "poe_order": {k: data["poe_order"][k].cpu().numpy()
                          for k in ("poe_id", "subject_id")},
            "myarray": data["myarray"].cpu().numpy(),
            "logs": data["logs"]}
    gen_mod = ctx.cell.generator()
    bd = default_deployment(device=ctx.device)
    _load(bd, data, schema, gen_mod.record_name)
    st = {"bd": bd, "data": data, "host": host, "sizes": sizes,
          "record_name": gen_mod.record_name,
          "gen": gen_mod.make(ctx.params, ctx.seed, sizes)}
    # warm: every kind of the mix twice, as the window will ask it
    warm = gen_mod.make(ctx.params, ctx.seed + 1, sizes)
    seen = set()
    while len(seen) < len(ctx.params["mix"]):
        q = next(warm)
        if q.kind not in seen:
            _run(st, q)
            _run(st, q)
            seen.add(q.kind)
    ctx.sync()
    return st


def _tails(lat: List[float], kinds: List[str]) -> Dict[str, Any]:
    """p50 and p95 (ms) by kind, and the p95 of the mix without each kind:
    how far the assumed weights set ``query_p95_ms``."""
    by_kind: Dict[str, List[float]] = {}
    for k, t in zip(kinds, lat):
        by_kind.setdefault(k, []).append(t)
    tails = {k: [percentile(v, 50) * 1e3, percentile(v, 95) * 1e3]
             for k, v in sorted(by_kind.items())}
    without = {k: percentile([t for kk, t in zip(kinds, lat) if kk != k],
                             95) * 1e3
               for k in sorted(by_kind) if len(by_kind) > 1}
    return {"tails": tails, "p95_without": without}


def window(ctx, st) -> Dict[str, Any]:
    rng = np.random.default_rng((ctx.seed + 7) % (2 ** 63))
    sample = int(ctx.params["keep_big"])
    lat: List[float] = []
    kinds: List[str] = []
    kept, failed, seen, reservoir = [], 0, {}, {k: [] for k in BIG}
    t0 = ctx.open_window()
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        q = next(st["gen"])
        start = time.perf_counter()
        try:
            with ctx.marks.mark(f"analyst/{q.kind}"):
                value = _run(st, q)
        except Exception as exc:                       # noqa: BLE001
            failed += 1
            kept.append((q, None, f"{type(exc).__name__}: {exc}"))
            lat.append(time.perf_counter() - start)
            kinds.append(q.kind)
            continue
        lat.append(time.perf_counter() - start)
        kinds.append(q.kind)
        if q.kind not in BIG:
            kept.append((q, keep(value), None))
            continue
        # a sample of the bulk results, drawn from the seed (reservoir)
        n = seen[q.kind] = seen.get(q.kind, 0) + 1
        res = reservoir[q.kind]
        j = len(res) if len(res) < sample else int(rng.integers(0, n))
        if j < sample:
            with ctx.marks.mark("harness/keep"):
                item = (q, keep(value), None)
            res[j:j + 1] = [item]
    ctx.close_window()
    for res in reservoir.values():
        kept.extend(res)
    cache = st["bd"].planner.plan_cache.stats()
    p95 = percentile(lat, 95) * 1e3
    sizes = st["sizes"]
    counts = {k: kinds.count(k) for k in sorted(set(kinds))}
    return {"attempted": len(lat), "failed": failed,
            "metrics": {"query_p95_ms": p95}, "kept": kept,
            "layer": {"queries": len(lat), "kinds": counts,
                      "quant_elements": int(sizes["wave_leads"])
                      * int(sizes["record_samples"])},
            "notes": [
                f"analyst: {len(lat)} queries in {ctx.seconds} s "
                f"({failed} failed); latency p50 "
                f"{percentile(lat, 50) * 1e3!r} ms, p95 {p95!r} ms over "
                f"all, max {max(lat) * 1e3!r} ms; by kind {counts}; "
                f"{_tails(lat, kinds)}; plan cache {cache}; "
                f"{len(kept)} results kept for the check"]}


def release(ctx, st) -> None:
    st.pop("bd", None)
    st.pop("data", None)
    import gc
    gc.collect()
    if ctx.device == "cuda":
        import torch
        torch.cuda.empty_cache()


def _record(ctx, st):
    """Waveform record ``r`` drawn again from the seed (the whole store at
    once, on the card, after the system under test has freed its own)."""
    if "store" not in st:
        st["store"] = _tables(ctx).store(st["sizes"], ctx.seed, ctx.device)
    return lambda r: st["store"][r]


def _judge(ctx, st, out, lower: bool):
    """(results wrong or failed, worst relative error of a mean) over the
    results kept.  With ``lower`` the values judged are the reference's
    own over the tables rounded to bfloat16 (the control), not the
    program's."""
    data = dict(st["host"], record=_record(ctx, st))
    low = qref.lowered(data) if lower else None
    engines = [tuple(e) for e in ctx.config["engines"]]
    wrong, worst, answers, lows = 0, 0.0, {}, {}
    for q, value, error in out["kept"]:
        if error is not None and not lower:
            wrong += 1
            continue
        key = (q.kind, tuple(sorted(q.const.items())))
        if key not in answers:
            answers[key] = qref.answer(q, data, engines)
            if lower:
                lows[key] = qref.answer(q, low, engines)
        if lower:
            value = lows[key]
        ok, err = qref.judge(q, value, answers[key])
        wrong += not ok
        worst = max(worst, err)
    return wrong, worst


def check(ctx, st, out):
    wrong, worst = _judge(ctx, st, out, lower=False)
    lim = ctx.cell.workload["limits"]
    return [Check("wrong_or_failed", wrong, lim["wrong_or_failed"]),
            Check("mean_rel_err", worst, lim["mean_rel_err"])]


def control(ctx, st, out):
    wrong, worst = _judge(ctx, st, out, lower=True)
    lim = ctx.cell.workload["limits"]
    return [Check("wrong_or_failed", wrong, lim["wrong_or_failed"]),
            Check("mean_rel_err", worst, lim["mean_rel_err"])]
