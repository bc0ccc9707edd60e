#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``): the quickest
proof that the port builds, is right and runs its main path on the card.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without them.  It prints one JSON object per line:

1. build     builds the CUDA kernels from the sources in the checkout,
             one nvcc for each library, all started together;
2. parity    holds each kernel against its plain PyTorch version on the
             card, bitwise: quant_cast on small shapes, an all-zero
             block, a row holding a NaN and the main path's shapes; the
             streaming kernels on rows holding a NaN or both signed
             zeros, W = 1, 7, 13 and 1024, sizes 1, 8,191 and 450,000, a
             row off the 16-byte grid, join keys tied at both edges of
             their band, 1 and 2 right keys, left counts that fill no
             whole block, and the main path's shapes;
3. query     drives the query endpoint at the size of a real deployment
             (MIMIC II v2.6's ~32,500 subjects, 70 min of an 8-lead
             waveform at 125 Hz): the paper's §VI queries through
             ``BigDawg.query``, each checked against numpy over the same
             seeded data;
4. quant     the quant route: the waveform migrated to int8 KV pages, and
             an int8 KV cache of Qwen2-1.5B's shape (28 layers x {k, v},
             each (8, 4096, 2, 128) bf16) registered and fetched through
             the TensorPolystore; round-trip errors held to the bound of
             tests/test_polystore.py, and every kernel's launch count on
             this main path (phases 3 and 4) above 0;
5. stream    the streaming island at the size of a real ICU feed, under
             the compiled backend (REPRO_QUERY_BACKEND=jit): a MIMIC II
             waveform at 125 Hz into a 1,048,576-row ring (160 one-minute
             batches, so the ring wraps) under four standing queries (a
             one-hour rolling max and a one-minute rolling min through
             window_minmax, the example's cast-and-average, a sliding
             window); a jittered ABP/ECG pair of event-time streams under
             a standing one-hour interval join (join_bounds over 450,000
             x 450,000 keys); and the example's sharded feed (4 shards
             over 2 StreamEngines, a live rebalance mid-feed).  Every
             standing query's last result is held bitwise against the
             interpreter on the same state and against numpy over the
             generator's rows, the sharded feed tick by tick against the
             unsharded one; every error a standing query records is a
             window not complete yet, and there are as many as the feed
             predicts; no fallback, and both streaming kernels'
             launch counts on this path above 0.  It prints each feed's
             wall time, each standing query's p50 tick latency, the ring
             export's share of the join's ticks (host, from the trace
             spans) and one join's card time by kernel and copy
             (torch.profiler);
6. kernels   each kernel's time (CUDA events over a CUDA graph of
             launches, L2 defeated by rotating buffers) beside its bound,
             its plain version's time, the time of the one PyTorch call
             that computes the same function where there is one, and its
             launches on its path (phases 3-4 for quant_cast, phase 5 for
             the streaming kernels); for join_bounds also the time its
             chains of dependent loads set, from a lone key's levels;

then the card's name and power limit, and last the contract line
``{"ok": true, "device": {...}}``.  No phase catches an error.
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
MAIN_PATH = dict(num_patients=32768, num_orders=1048576, wave_len=524288,
                 num_logs=4096)
KV_LAYERS, KV_LEAF = 28, (8, 4096, 2, 128)     # configs/qwen2_1_5b.py cache
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12                          # f32 outside the tensor cores
F64_OPS_PER_S = 34e12                          # f64 outside the tensor cores
REPLACES = "src/repro/kernels/quant_cast/quant_cast.py"
STREAM_REPLACES = "src/repro/stream/kernels.py"

# the streaming island at the size of a real ICU feed: MIMIC II waveforms
# at 125 Hz, one-minute batches (7,500 rows), a 2.3-hour ring
WAVE = "mimic2v26.waveform_stream"
WAVE_FEED = dict(batch_rows=7500, num_batches=160, capacity=1048576,
                 seed=SEED)
PAIRED_FEED = dict(batch_rows=7500, num_batches=160, capacity=1048576,
                   shards=1, jitter=2.0, max_delay=6.0, seed=SEED)
SHARDED_BATCHES = 60
HOUR, MINUTE = 450000, 7500                    # rows at 125 Hz
WAVE_QUERIES = {                               # name: (bql, every_n_ticks)
    "hr_max_1h": (f"bdstream(aggregate(window({WAVE}, {HOUR}), max(hr)))",
                  1),
    "signal_min_1m": (f"bdstream(aggregate(window({WAVE}, {MINUTE}),"
                      " min(signal)))", 1),
    "wave_avg": (f"bdarray(aggregate(bdcast(bdstream(window({WAVE},"
                 f" {MINUTE})), w_arr, '<signal:double>[tick=0:"
                 f"{MINUTE - 1},{MINUTE},0]', array), avg(signal)))", 1),
    "sliding_30s": (f"bdstream(window({WAVE}, {MINUTE}, {MINUTE // 2}))",
                    20),
}
JOIN = (f"bdstream(join(ewindow(mimic2v26.abp_stream, {HOUR}),"
        f" ewindow(mimic2v26.ecg_stream, {HOUR}), on=ts, tol=0.5))")
JOIN_EVERY = 4
ROLLING_AVG = f"bdstream(aggregate(window({WAVE}, {MINUTE}), avg(signal)))"
# the ticks on which a standing query records an error: those before its
# first complete window (the one-hour max needs 60 one-minute batches;
# the join's first hour closes once batch 61 moves the watermark past
# it, so its due ticks 4, 8, ..., 60 find none); every other query has
# a complete window from its first run
WANT_ERRORS = {"hr_max_1h": HOUR // MINUTE - 1,
               "abp_ecg_join": HOUR // MINUTE // JOIN_EVERY}
# the only error a standing query may record here: the Executor's wrap of
# a StreamException that says no window is complete yet
NOT_YET = re.compile(r"LocalQueryExecutionException: streaming query "
                     r"failed on \S+: '.*': stream '[^']+': (no complete "
                     r"window|no closed ewindow|watermark has not started)")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _inputs(shape, seed: int) -> np.ndarray:
    """Normal data whose 128-wide rows span twelve orders of magnitude,
    the first row zeroed when there is more than one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    mags = 10.0 ** rng.integers(-6, 6, -(-flat.size // 128))
    flat *= np.repeat(mags, 128)[:flat.size].astype(np.float32)
    if flat.size > 128:
        flat[:128] = 0.0
    return x


# -- 1. build --------------------------------------------------------------
def build() -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.quant_cast import quant_cast as k
    from repro_torch.kernels.stream import stream as sk
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        for lib in [pool.submit(k.load), pool.submit(sk.load)]:
            lib.result()
    seconds = time.perf_counter() - t0
    for name in ("quant_cast", "stream"):
        ptxas = [ln.strip() for ln in _build.BUILD_LOGS.get(name,
                                                            "").splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "library": name, "seconds": seconds,
              "ptxas": ptxas})


# -- 2. kernel against its plain version ---------------------------------------
def parity() -> dict:
    from repro_torch.kernels.quant_cast import ops, ref
    from repro_torch.kernels.quant_cast import quant_cast as k
    err = {"quantize": 0.0, "dequantize": 0.0}
    cases = {f"{s}": _inputs(s, i) for i, s in enumerate(
        [(1000,), (3, 7, 33), (8, 128)])}
    cases["zero_block"] = np.zeros((8, 128), np.float32)
    cases[f"waveform{(8, MAIN_PATH['wave_len'])}"] = _inputs(
        (8, MAIN_PATH["wave_len"]), 10)
    # a KV leaf, bf16 on the main path, reaches the kernel as f32
    leaf = torch.from_numpy(_inputs(KV_LEAF, 11)).to(torch.bfloat16)
    cases[f"kv_leaf{KV_LEAF}"] = leaf.float().numpy()
    for name, x in cases.items():
        x2d = ops._pad_to_tiles(torch.from_numpy(x).cuda().reshape(-1))
        q, s = k.quantize_2d(x2d)
        qr, sr = ref.quantize_blocks(x2d)
        d, dr = k.dequantize_2d(q, s), ref.dequantize_blocks(q, s)
        torch.cuda.synchronize()
        same = torch.equal(q, qr) and torch.equal(s, sr)
        check(same, f"quantize differs from the plain version on {name}")
        check(torch.equal(d, dr),
              f"dequantize differs from the plain version on {name}")
        err["quantize"] = max(err["quantize"],
                              float((q.int() - qr.int()).abs().max()),
                              float((s - sr).abs().max()))
        err["dequantize"] = max(err["dequantize"],
                                float((d - dr).abs().max()))
        emit({"phase": "parity", "case": name, "rows": x2d.shape[0],
              "q_scale_bitwise": same, "dequantize_bitwise": True})
    # a row holding a NaN: its scale is 1.0, as the plain version gives it;
    # the other rows stay bitwise
    x = torch.from_numpy(_inputs((8, 128), 12)).cuda()
    x[2, 5] = float("nan")
    q, s = k.quantize_2d(x)
    qr, sr = ref.quantize_blocks(x)
    torch.cuda.synchronize()
    others = [i for i in range(8) if i != 2]
    check(float(s[2, 0]) == float(sr[2, 0]) == 1.0,
          "NaN row: scale is not the plain version's 1.0")
    check(torch.equal(s[others], sr[others])
          and torch.equal(q[others], qr[others]),
          "NaN row disturbed the other rows")
    emit({"phase": "parity", "case": "nan_row", "scale": float(s[2, 0]),
          "plain_scale": float(sr[2, 0]), "other_rows_bitwise": True})
    return err


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal float64 bit patterns (the sign of a zero included); any NaN
    equals any NaN."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int64),
                            b[~nan].view(torch.int64)))


def _minmax_rows(w: int, size: int, seed: int) -> np.ndarray:
    """Normal rows; the second holds a NaN, the third mixed signed zeros
    below negatives, the fourth only -0.0, the fifth a -0.0 and a +0.0
    above positives (where the shape has those rows)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((w, size))
    if w > 1:
        x[1, size // 2] = np.nan
    if w > 2:
        x[2] = -np.abs(x[2])
        x[2, ::2], x[2, 1::2] = 0.0, -0.0
    if w > 3:
        x[3] = -0.0
    if w > 4 and size > 1:
        x[4] = np.abs(x[4])
        x[4, 0], x[4, -1] = -0.0, 0.0
    return x


def _join_keys(nl: int, nr: int, seed: int, tol: float):
    """Sorted right keys with duplicates; left keys that tie a right key
    at both edges of their [lt - tol, lt + tol] band."""
    rng = np.random.default_rng(seed)
    rs = np.sort(rng.integers(0, max(nr // 2, 4), nr) * 0.25)
    lt = rng.uniform(rs[0] - 1.0, rs[-1] + 1.0, nl)
    edge = rs[rng.integers(0, nr, nl)]
    lt[::3] = edge[::3] + tol
    lt[1::3] = edge[1::3] - tol
    return lt, rs


def stream_parity() -> dict:
    from repro_torch.kernels.stream import ops, ref
    from repro_torch.kernels.stream import stream as sk
    err = {"window_minmax": 0.0, "join_bounds": 0.0}
    shapes = [(w, size) for w in (1, 7, 13) for size in (1, 8191, HOUR)]
    shapes.append((1024, MINUTE))              # one-minute windows, batched
    for i, (w, size) in enumerate(shapes):
        x = torch.from_numpy(_minmax_rows(w, size, 20 + i)).cuda()
        # the last row again, 8 bytes off the 16-byte grid
        buf = torch.empty(size + 1, dtype=torch.float64, device="cuda")
        buf[1:] = x[-1]
        for name, rows in (("", x), ("_unaligned", buf[1:].view(1, size))):
            for is_max in (False, True):
                got = sk.window_minmax_2d(rows, is_max)
                want = ref.window_minmax(rows, is_max)
                torch.cuda.synchronize()
                check(_same_bits(got, want), f"window_minmax differs from "
                      f"the plain version at {(w, size)}{name} "
                      f"is_max={is_max}")
                fin = torch.isfinite(want)
                err["window_minmax"] = max(err["window_minmax"], float(
                    (got[fin] - want[fin]).abs().max()) if fin.any()
                    else 0.0)
        emit({"phase": "parity", "kernel": "window_minmax",
              "case": [w, size], "bitwise": True})
    tol = 0.5
    cases = [(1, 1), (7, 1), (1001, 1), (1001, 2), (4097, 33),
             (HOUR, HOUR), (524288, 524288)]
    for i, (nl, nr) in enumerate(cases):
        lt, rs = _join_keys(nl, nr, 40 + i, tol)
        lt_d, rs_d = torch.from_numpy(lt).cuda(), torch.from_numpy(rs).cuda()
        lo, hi = sk.join_bounds_1d(lt_d, rs_d, tol, ops.steps(nr))
        want_lo, want_hi = ref.join_bounds(lt_d, rs_d, tol)
        torch.cuda.synchronize()
        check(torch.equal(lo, want_lo) and torch.equal(hi, want_hi),
              f"join_bounds differs from the plain version at {(nl, nr)}")
        check(np.array_equal(lo.cpu().numpy(), np.searchsorted(
            rs, lt - tol, side="left")), f"join_bounds lo at {(nl, nr)}")
        err["join_bounds"] = max(err["join_bounds"], float(
            (lo - want_lo).abs().max()), float((hi - want_hi).abs().max()))
        emit({"phase": "parity", "kernel": "join_bounds", "case": [nl, nr],
              "bitwise": True})
    return err


# -- 3. the query endpoint at deployment size ----------------------------------
def _timed_query(bd, name: str, bql: str, training: bool = False):
    """Run ``bql`` as asked, then once more in lean mode (warm: the plan
    cache holds its plan and the card's kernels are loaded); return the
    first response."""
    runs = []
    for mode in (training, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = bd.query(bql, training=mode)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, r))
    (wall, r), (warm_wall, warm) = runs
    emit({"phase": "query", "query": name, "wall_s": wall,
          "training": training, "plans_considered": r.plans_considered,
          "qep_id": r.qep_id, "stages": [[s, sec] for s, sec in r.stages],
          "warm_wall_s": warm_wall, "warm_qep_id": warm.qep_id,
          "warm_plan_cache_hit": warm.plan_cache_hit,
          "warm_stages": [[s, sec] for s, sec in warm.stages]})
    return r


def queries(bd, data) -> None:
    from repro_torch.core.interop import to_numpy
    pat, poe = data["d_patients"], data["poe_order"]

    # §VI-b relational island: a gather
    r = _timed_query(bd, "rel_limit",
                     "bdrel(select * from mimic2v26.d_patients limit 4)")
    got = to_numpy(r.value)["columns"]
    check(list(got) == list(pat), "rel_limit: columns")
    for c in pat:
        check(np.array_equal(got[c], pat[c][:4])
              and got[c].dtype == pat[c].dtype, f"rel_limit: column {c}")

    # §VI-c array island: a filter on a dimension
    r = _timed_query(bd, "array_filter",
                     "bdarray(filter(myarray, dim1>150))")
    check(np.array_equal(to_numpy(r.value.mask()), np.arange(256) > 150),
          "array_filter: mask")
    check(np.array_equal(to_numpy(r.value.attrs["val"]), data["myarray"]),
          "array_filter: values")

    # §VI-d text island: a key range
    r = _timed_query(bd, "text_range",
                     "bdtext({ 'op' : 'range', 'table' : 'mimic_logs',"
                     " 'range' : { 'start' : ['r_0001','',''],"
                     " 'end' : ['r_0015','',''] } })")
    keys, values = data["logs"]
    check(r.value == list(zip(keys[1:16], values[1:16])), "text_range")

    # §VI-e inter-island cast, relational -> array, in training mode
    r = _timed_query(bd, "cast_rel_to_array",
                     "bdarray(scan(bdcast(bdrel(select poe_id, subject_id"
                     " from mimic2v26.poe_order), poe_order_copy,"
                     " '<subject_id:int32>[poe_id=0:*,10000000,0]',"
                     " array)))", training=True)
    order = np.argsort(poe["poe_id"], kind="stable")
    check(r.value.dim_names == ("poe_id",), "cast: dimension")
    # the staged route carries every column as float32 (exact here: the
    # ids are below 2**24)
    check(np.array_equal(
        to_numpy(r.value.attrs["subject_id"]).astype(np.float64),
        poe["subject_id"][order].astype(np.float64)), "cast: values")

    # §V.A catalog
    r = _timed_query(bd, "catalog", "bdcatalog(select name,"
                     " connection_properties from engines)")
    check([(row["name"], row["connection_properties"]) for row in r.value]
          == [(e.name, e.kind) for e in bd.engines.values()], "catalog")

    # a count, a grouped mean and a float sum on the card
    r = _timed_query(bd, "rel_count", "bdrel(select count(*) from"
                     " mimic2v26.d_patients where sex = 1)")
    check(int(to_numpy(r.value.columns["count_subject_id"])[0])
          == int(np.sum(pat["sex"] == 1)), "rel_count")
    r = _timed_query(bd, "rel_group_avg", "bdrel(select sex, avg(dob_year)"
                     " from mimic2v26.d_patients group by sex)")
    got = to_numpy(r.value)["columns"]
    want = [pat["dob_year"][pat["sex"] == s].astype(np.float64).mean()
            for s in (0, 1)]
    check(np.array_equal(got["sex"], np.array([0, 1], np.int32)),
          "rel_group_avg: keys")
    # int32 sums are exact; one f32 division rounds: 1e-6 relative
    check(np.allclose(got["avg_dob_year"], want, rtol=1e-6, atol=0),
          "rel_group_avg: means")
    r = _timed_query(bd, "array_avg",
                     "bdarray(aggregate(mimic2v26.waveform, avg(signal)))")
    sig = data["signal"].astype(np.float64)
    got = float(to_numpy(r.value.attrs["avg_signal"])[0])
    # an f32 sum of 4.2M terms in the card's tree order: error about
    # log2(n) * 2**-24 of the mean magnitude; held to 1e-5 of it
    check(abs(got - sig.mean()) <= 1e-5 * np.abs(sig).mean(),
          f"array_avg: {got} vs {sig.mean()}")


# -- 4. the quant route ----------------------------------------------------------
def quant_route(bd) -> dict:
    from repro_torch.core.migrator import MigrationParams
    from repro_torch.core.tensorstore import PlacementPolicy, TensorPolystore
    src, dst = bd.engines["densehbm0"], bd.engines["kvstore0"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bd.migrator.migrate(src, "mimic2v26.waveform", dst, "wave_q",
                              MigrationParams(method="quant"))
    torch.cuda.synchronize()
    emit({"phase": "quant", "step": "migrate_waveform",
          "wall_s": time.perf_counter() - t0,
          "bytes_moved": res.bytes_moved, "rows": res.rows})

    gen = torch.Generator(device=bd.device).manual_seed(SEED)
    cache = [{kv: torch.randn(KV_LEAF, generator=gen, device=bd.device,
                              dtype=torch.float32).to(torch.bfloat16)
              for kv in ("k", "v")} for _ in range(KV_LAYERS)]
    store = TensorPolystore(bd, PlacementPolicy(kv_codec="int8"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.register_kv_cache("qwen2_1_5b", cache)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = store.fetch_kv_cache("qwen2_1_5b", template=cache)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    emit({"phase": "quant", "step": "kv_cache_int8",
          "leaves": 2 * KV_LAYERS,
          "elements": 2 * KV_LAYERS * int(np.prod(KV_LEAF)),
          "register_s": t1 - t0, "fetch_s": t2 - t1})
    return {"cache": cache, "back": back}


def quant_checks(bd, kv) -> None:
    from repro_torch.kernels.quant_cast import ops as qops
    # the bound of tests/test_polystore.py: max error <= absmax / 127 * 1.01
    q = bd.engines["kvstore0"].get("wave_q")["signal"]
    orig = bd.engines["densehbm0"].get("mimic2v26.waveform").attrs["signal"]
    err = float((qops.dequantize(q["q"], q["scale"], orig.shape)
                 - orig).abs().max())
    bound = float(orig.abs().max()) / 127.0 * 1.01
    check(err <= bound, f"waveform quant error {err} > {bound}")
    worst = 0.0
    for layer, got_layer in zip(kv["cache"], kv["back"]):
        for name, t in layer.items():
            got = got_layer[name]
            check(got.dtype == torch.bfloat16 and got.shape == t.shape,
                  "kv leaf dtype/shape")
            t32 = t.float()
            e = float((got.float() - t32).abs().max())
            b = float(t32.abs().max()) / 127.0 * 1.01
            check(e <= b, f"kv leaf error {e} > {b}")
            worst = max(worst, e / b)
    emit({"phase": "quant", "step": "error_bounds", "waveform_err": err,
          "waveform_bound": bound, "kv_worst_err_over_bound": worst})


# -- 5. the streaming island at the size of an ICU feed ---------------------------
def _set_backend(name: str) -> None:
    from repro_torch.stream import compile as qc
    os.environ[qc.BACKEND_ENV] = name


def _waveform_rows(batch_rows: int, num_batches: int, seed: int):
    """The rows ``stream_mimic_waveforms`` appends, drawn again with numpy
    (the same generator calls in the same order)."""
    rng = np.random.default_rng(seed)
    t = np.arange(batch_rows * num_batches, dtype=np.float64)
    signal, hr = np.empty_like(t), np.empty_like(t)
    for b in range(num_batches):
        sl = slice(b * batch_rows, (b + 1) * batch_rows)
        signal[sl] = (np.sin(2 * np.pi * t[sl] / 360.0)
                      + 0.05 * rng.standard_normal(batch_rows))
        hr[sl] = (75.0 + 10.0 * np.sin(2 * np.pi * t[sl] / 3600.0)
                  + rng.standard_normal(batch_rows))
    return signal, hr


def _paired_rows(batch_rows: int, num_batches: int, seed: int,
                 jitter: float):
    """ABP and ECG by timestamp, as ``stream_mimic_paired_waveforms``
    draws them (arrival order undone: ts t holds row t)."""
    rng = np.random.default_rng(seed)
    n = batch_rows * num_batches
    abp, ecg = np.empty(n), np.empty(n)
    for b in range(num_batches):
        t = b * batch_rows + np.arange(batch_rows, dtype=np.float64)
        rng.uniform(-jitter, jitter, batch_rows)          # ABP arrival order
        abp[b * batch_rows:(b + 1) * batch_rows] = (
            90.0 + 12.0 * np.sin(2 * np.pi * t / 360.0)
            + 0.5 * rng.standard_normal(batch_rows))
        rng.uniform(-jitter, jitter, batch_rows)          # ECG arrival order
        ecg[b * batch_rows:(b + 1) * batch_rows] = (
            np.sin(2 * np.pi * t / 6.0)
            + 0.1 * rng.standard_normal(batch_rows))
    return abp, ecg


def _same_value(a, b) -> bool:
    """Two query results equal bit for bit (NaN equal to NaN)."""
    from repro_torch.core.interop import to_numpy
    a, b = to_numpy(a), to_numpy(b)
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(
                    np.ascontiguousarray(a).view(np.uint8),
                    np.ascontiguousarray(b).view(np.uint8)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same_value(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_value, a, b))
    return a == b


def _feed(feed, cqs: dict) -> None:
    """Run ``feed`` to its end, holding every error a standing query of
    ``cqs`` records to NOT_YET, before its first execution, and their
    number to WANT_ERRORS: a kernel that fails on a tick fails here."""
    seen = dict.fromkeys(cqs, 0)
    for info in feed:
        for name, cq in cqs.items():
            if cq.errors != seen[name]:
                check(cq.errors == seen[name] + 1 and cq.executions == 0
                      and NOT_YET.match(cq.last_error or "") is not None,
                      f"{name}, batch {info['batch']}: {cq.errors} errors "
                      f"after {cq.executions} runs: {cq.last_error}")
                seen[name] = cq.errors
    for name, cq in cqs.items():
        want = WANT_ERRORS.get(name, 0)
        check(cq.errors == want,
              f"{name}: {cq.errors} errors, expected {want}")


def _ran(bd, info) -> list:
    return [(n, bd.streams.queries[n].last_value) for n, _ in info["ran"]]


def waveform_feed(bd) -> None:
    """Four standing queries over a 2.3-hour ring, fed 160 one-minute
    batches; then each last result against the interpreter and numpy."""
    from repro_torch.core.interop import to_numpy
    from repro_torch.data.mimic import stream_mimic_waveforms
    cqs = {name: bd.register_continuous(q, every, name=name)
           for name, (q, every) in WAVE_QUERIES.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _feed(stream_mimic_waveforms(bd, **WAVE_FEED), cqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stream = bd.engines["streamstore0"].get(WAVE)
    emit({"phase": "stream", "feed": "waveform", "wall_s": wall,
          "ticks": WAVE_FEED["num_batches"], "rows": stream.total_appended,
          "dropped": stream.total_dropped,
          "queries": {n: cq.metrics() for n, cq in cqs.items()}})
    check(stream.total_dropped > 0, "the waveform ring did not wrap")
    _set_backend("interpreter")
    for name, cq in cqs.items():
        want = bd.query(cq.bql).value
        check(_same_value(want, cq.last_value),
              f"{name}: the compiled result differs from the interpreter")
        bd.streams.deregister(name)
    _set_backend("jit")
    signal, hr = _waveform_rows(WAVE_FEED["batch_rows"],
                                WAVE_FEED["num_batches"], WAVE_FEED["seed"])
    total = signal.shape[0]
    s_hour = (total // HOUR - 1) * HOUR
    s_min = (total // MINUTE - 1) * MINUTE
    got = {n: to_numpy(cq.last_value) for n, cq in cqs.items()}
    check(got["hr_max_1h"]["attrs"]["max_hr"][0]
          == np.float32(hr[s_hour:s_hour + HOUR].max()), "hr_max_1h value")
    check(got["signal_min_1m"]["attrs"]["min_signal"][0]
          == np.float32(signal[s_min:s_min + MINUTE].min()),
          "signal_min_1m value")
    window = signal[s_min:s_min + MINUTE].astype(np.float32)
    avg = float(got["wave_avg"]["attrs"]["avg_signal"][0])
    # an f32 mean of 7,500 terms in the card's order: 1e-5 of the mean
    # magnitude, as phase 3 holds the waveform mean
    check(abs(avg - window.astype(np.float64).mean())
          <= 1e-5 * np.abs(window).mean(), f"wave_avg {avg}")
    first = total - stream.capacity
    starts = np.arange(0, stream.capacity - MINUTE + 1, MINUTE // 2)
    want = np.stack([signal[first + a:first + a + MINUTE]
                     for a in starts]).astype(np.float32)
    check(np.array_equal(got["sliding_30s"]["attrs"]["signal"], want),
          "sliding_30s windows")
    emit({"phase": "stream", "feed": "waveform", "checks": "passed",
          "sliding_windows": int(starts.shape[0])})


def _export_share(spans, query: str) -> dict:
    """Host time of the ring export inside a standing query's ticks, from
    the trace spans (``stream/query`` of that query, and the
    ``compile/export`` spans of the same tick)."""
    ticks = {sp.trace_id: sp.duration for sp in spans
             if sp.name == "stream/query" and sp.attrs.get("query") == query}
    export = sum(sp.duration for sp in spans
                 if sp.name == "compile/export" and sp.trace_id in ticks)
    execute = sum(sp.duration for sp in spans
                  if sp.name == "compile/execute" and sp.trace_id in ticks)
    total = sum(ticks.values())
    return {"ticks": len(ticks), "query_s": total, "execute_s": execute,
            "export_s": export, "export_share": export / total}


def _device_times(bd) -> dict:
    """Card time of one join execution, by kernel and copy, from
    torch.profiler: only the events that ran on the card (a host op's
    self device time repeats its kernels'), less the profiler's own
    activity-buffer requests."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bd.query(JOIN)
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        if (ev.device_type == DeviceType.CPU
                or ev.key.startswith("Activity Buffer")):
            continue
        us = ev.self_device_time_total
        if us > 0:
            rows[ev.key] = rows.get(ev.key, 0.0) + us
    total = sum(rows.values())
    copy = sum(us for key, us in rows.items() if "HtoD" in key)
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:8]
    return {"device_us": total, "htod_us": copy,
            "htod_share": copy / total if total else None,
            "top": [[key[:80], us] for key, us in top]}


def paired_feed(bd) -> dict:
    """The ABP/ECG event-time pair under the standing one-hour join;
    returns the join's last result for the numpy checks."""
    from repro_torch.data.mimic import stream_mimic_paired_waveforms
    from repro_torch.obs import trace
    cq = bd.register_continuous(JOIN, JOIN_EVERY, name="abp_ecg_join")
    trace.reset()
    trace.set_enabled(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _feed(stream_mimic_paired_waveforms(bd, **PAIRED_FEED),
          {"abp_ecg_join": cq})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace.set_enabled(False)
    share = _export_share(trace.spans(), "abp_ecg_join")
    emit({"phase": "stream", "feed": "paired", "wall_s": wall,
          "ticks": PAIRED_FEED["num_batches"] + 1,
          "queries": {"abp_ecg_join": cq.metrics()},
          "join_tick_host": share, "join_card": _device_times(bd)})
    check(cq.executions > 0 and cq.last_value is not None,
          "the join never ran")
    value = cq.last_value
    _set_backend("interpreter")
    check(_same_value(bd.query(JOIN).value, value),
          "abp_ecg_join: the compiled result differs from the interpreter")
    _set_backend("jit")
    bd.streams.deregister("abp_ecg_join")
    return value


def sharded_feed() -> None:
    """The example's second half at full capacity: 4 shards over 2
    StreamEngines under the rolling average, one live rebalance
    mid-feed; every tick equal bit for bit to the unsharded feed."""
    from repro_torch.core.api import default_deployment
    from repro_torch.data.mimic import stream_mimic_waveforms
    results = {}
    for shards in (1, 4):
        dep = default_deployment(stream_engines=2)
        cq = dep.register_continuous(ROLLING_AVG, 1, name="rolling_avg")
        values, move = [], None
        t0 = time.perf_counter()
        for info in stream_mimic_waveforms(
                dep, batch_rows=WAVE_FEED["batch_rows"],
                num_batches=SHARDED_BATCHES,
                capacity=WAVE_FEED["capacity"], seed=SEED, shards=shards,
                num_engines=2 if shards > 1 else None):
            values.append(_ran(dep, info))
            if shards > 1 and info["batch"] == SHARDED_BATCHES // 2:
                move = dep.rebalance_stream(WAVE, shard=0,
                                            to_engine="streamstore1")
        torch.cuda.synchronize()
        results[shards] = values
        check(cq.errors == 0, f"rolling_avg: {cq.last_error}")
        emit({"phase": "stream", "feed": f"sharded_{shards}",
              "wall_s": time.perf_counter() - t0, "rebalance": move,
              "queries": {"rolling_avg": cq.metrics()}})
    check(sum(len(v) for v in results[4]) == SHARDED_BATCHES,
          "the sharded rolling average missed ticks")
    check(all(_same_value(a, b) for a, b in zip(results[1], results[4])),
          "the sharded feed differs from the unsharded feed")
    emit({"phase": "stream", "feed": "sharded", "checks": "passed",
          "ticks_compared": SHARDED_BATCHES})


def join_checks(bd, value) -> None:
    """The join against numpy over the generator's rows; its bounds
    against np.searchsorted (these launches follow the path's count)."""
    from repro_torch.core.interop import to_numpy
    from repro_torch.kernels.stream import ops
    cols = to_numpy(value)["columns"]
    abp, ecg = _paired_rows(PAIRED_FEED["batch_rows"],
                            PAIRED_FEED["num_batches"], PAIRED_FEED["seed"],
                            PAIRED_FEED["jitter"])
    # the latest hour the watermark (the last ts, after the final flush)
    # has closed
    start = (abp.shape[0] - 1 - HOUR) // HOUR * HOUR
    ts = np.arange(start, start + HOUR, dtype=np.float64)
    check(cols["dt"].shape == (HOUR,), f"join pairs {cols['dt'].shape}")
    check(np.all(cols["dt"] == np.float32(0.25)), "join dt")
    check(np.array_equal(cols["l_ts"], ts.astype(np.float32))
          and np.array_equal(cols["r_ts"], (ts + 0.25).astype(np.float32)),
          "join timestamps")
    check(np.array_equal(cols["l_abp"],
                         abp[start:start + HOUR].astype(np.float32))
          and np.array_equal(cols["r_ecg"],
                             ecg[start:start + HOUR].astype(np.float32)),
          "join values")
    left = bd.engines["streamstore0"].get("mimic2v26.abp_stream").ewindow(
        float(HOUR)).attrs["ts"].double()
    right = bd.engines["streamstore0"].get("mimic2v26.ecg_stream").ewindow(
        float(HOUR)).attrs["ts"].double()
    rs = torch.sort(right, stable=True).values
    lo, hi = ops.join_bounds(left, rs, 0.5)
    lt_np, rs_np = left.cpu().numpy(), rs.cpu().numpy()
    check(np.array_equal(lo.cpu().numpy(),
                         np.searchsorted(rs_np, lt_np - 0.5, side="left"))
          and np.array_equal(hi.cpu().numpy(), np.searchsorted(
              rs_np, lt_np + 0.5, side="right")), "join bounds")
    emit({"phase": "stream", "feed": "paired", "checks": "passed",
          "pairs": int(cols["dt"].shape[0])})


# -- 6. kernel times --------------------------------------------------------------
def _graph_ms(fns, reps: int = 20) -> float:
    """Mean device time of one call, from CUDA events around replays of a
    CUDA graph that holds ``reps`` passes over ``fns`` (so the host's
    launch cost is not timed)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:                      # warm up outside the graph
            f()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            for f in fns:
                f()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps * len(fns))


def quant_kernel_rows(launches: dict, err: dict) -> list:
    from repro_torch.kernels.quant_cast import ref
    from repro_torch.kernels.quant_cast import quant_cast as k
    n = int(np.prod(KV_LEAF))
    nb = n // k.BLOCK
    # eight buffers of each input (268 MB of f32) rotate so that no call
    # finds its input in the 50 MB L2, as a leaf of a fresh cache would not
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    xs = [torch.randn((nb, k.BLOCK), generator=gen, device="cuda")
          for _ in range(8)]
    qs = [k.quantize_2d(x) for x in xs]
    torch.cuda.synchronize()
    q_bytes = n * 4 + n * 1 + nb * 4         # read x; write q and scale
    d_bytes = n * 1 + nb * 4 + n * 4         # read q and scale; write x
    # quantize: abs, max, divide, round, two clamps an element, and the
    # scale's compare and multiply a row; dequantize: convert, multiply
    q_ops, d_ops = 6 * n + 2 * nb, 2 * n
    # one PyTorch call computes dequantize: int8 times f32 promotes to a
    # single f32 multiply, bitwise equal to the plain version; no single
    # call computes quantize's per-row absmax, scale and rounding
    check(all(torch.equal(torch.mul(*p), ref.dequantize_blocks(*p))
              for p in qs), "torch.mul(q, scale) differs from dequantize")
    rows = []
    for name, kern, plain, library, nbytes, ops, line in (
            ("quantize", [lambda x=x: k.quantize_2d(x) for x in xs],
             [lambda x=x: ref.quantize_blocks(x) for x in xs], None,
             q_bytes, q_ops, 21),
            ("dequantize", [lambda p=p: k.dequantize_2d(*p) for p in qs],
             [lambda p=p: ref.dequantize_blocks(*p) for p in qs],
             [lambda p=p: torch.mul(*p) for p in qs], d_bytes, d_ops, 30)):
        ms, plain_ms = _graph_ms(kern), _graph_ms(plain)
        library_ms = None if library is None else _graph_ms(library)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        rows.append({
            "name": f"quant_cast.{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/quant_cast/csrc/quant_cast.cu",
            "replaces": f"{REPLACES}:{line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "shape": [nb, k.BLOCK], "bytes": nbytes, "operations": ops})
    return rows


def _bound(nbytes: int, ops: int) -> dict:
    """The least time for ``nbytes`` of device memory traffic and ``ops``
    f64 operations, and which of the two bounds it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F64_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops}


def _minmax_times(w: int, size: int, copies: int) -> dict:
    """window_minmax (max) at (w, size), its plain version and torch.amax,
    over ``copies`` rotating inputs (past the 50 MB L2 together)."""
    from repro_torch.kernels.stream import ref
    from repro_torch.kernels.stream import stream as sk
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    xs = [torch.randn((w, size), generator=gen, device="cuda",
                      dtype=torch.float64) for _ in range(copies)]
    # torch.amax computes the same function on rows without a zero:
    # checked bitwise on these inputs before it is timed
    check(all(_same_bits(torch.amax(x, dim=1), sk.window_minmax_2d(x, True))
              for x in xs), "torch.amax differs from window_minmax")
    out = {"shape": [w, size],
           "ms": _graph_ms([lambda x=x: sk.window_minmax_2d(x, True)
                            for x in xs]),
           "plain_ms": _graph_ms([lambda x=x: ref.window_minmax(x, True)
                                  for x in xs]),
           "library_ms": _graph_ms([lambda x=x: torch.amax(x, dim=1)
                                    for x in xs]),
           "library": "torch.amax(x, dim=1)"}
    # read every value once, write one a row; one compare-select a value
    out.update(_bound(8 * w * size + 8 * w, w * size))
    return out


def _latency_bound(rs: torch.Tensor, tol: float, nl: int,
                   steps: int) -> dict:
    """join_bounds' time as its chains of dependent loads set it: each
    key's ``steps`` bisection levels (a load for lo and one for hi), with
    at most the card's resident threads' keys in flight.  The time of
    one level is the kernel's own, for one lone key: the difference
    between ``steps`` levels and 5 over 2 ** 19 right keys, whose levels
    6 on each load a line the key has not loaded (an L2 hit, L1 being
    cold at launch) until the last four, which share one."""
    from repro_torch.kernels.stream import stream as sk
    props = torch.cuda.get_device_properties(0)
    resident = (props.multi_processor_count
                * props.max_threads_per_multi_processor)
    lt = rs[123457:123458] - 0.25             # one key inside the range
    full = _graph_ms([lambda: sk.join_bounds_1d(lt, rs, tol, steps)],
                     reps=100)
    short = _graph_ms([lambda: sk.join_bounds_1d(lt, rs, tol, 5)],
                      reps=100)
    level_ms = (full - short) / (steps - 5)
    waves = -(-nl // resident)
    return {"latency_bound_ms": waves * steps * level_ms,
            "level_ms": level_ms, "resident_threads": resident,
            "waves": waves,
            "note": ("latency_bound_ms = waves x steps x level_ms: a model "
                     "of the dependent loads from a lone key's levels, "
                     "not a floor (keys that share a level's line in one "
                     "SM may find it in L1); bound_ms is the bytes bound")}


def stream_kernel_rows(launches: dict, err: dict) -> list:
    from repro_torch.kernels.stream import ops, ref
    from repro_torch.kernels.stream import stream as sk
    source = "src/repro_torch/kernels/stream/csrc/stream.cu"
    # (1, 450,000): the main path's one-hour window, 3.6 MB; sixteen
    # copies rotate past L2.  (1024, 7,500): one-minute windows batched,
    # 61 MB a copy, past L2 by itself.
    minmax = _minmax_times(1, HOUR, 16)
    minmax["note"] = ("at W = 1 the latency of its two launches dominates: "
                      "3.6 MB take ~1 us at the memory rate")
    minmax["batched"] = _minmax_times(1024, MINUTE, 2)
    # join_bounds at 524,288 x 524,288 keys shaped like the main path's
    # (right keys 0.25 after the left ones, tol 0.5); eight copies of
    # the 8.4 MB of keys rotate past L2
    n, tol = 524288, 0.5
    steps = ops.steps(n)
    keys = []
    for i in range(8):
        lt = torch.arange(n, dtype=torch.float64, device="cuda") + i * n
        keys.append((lt, lt + 0.25))
    join = {"shape": [n, n], "steps": steps,
            "ms": _graph_ms([lambda a=a, b=b: sk.join_bounds_1d(a, b, tol,
                                                                 steps)
                             for a, b in keys]),
            "plain_ms": _graph_ms([lambda a=a, b=b: ref.join_bounds(a, b,
                                                                     tol)
                                   for a, b in keys]),
            "library_ms": _graph_ms([
                lambda a=a, b=b: (torch.searchsorted(b, a - tol),
                                  torch.searchsorted(b, a + tol,
                                                     right=True))
                for a, b in keys]),
            "library": "torch.searchsorted x2 (two calls)",
            "dependent_loads_per_key": 2 * steps}
    # read both key arrays, write lo and hi; per left key two roundings
    # and 2 * steps compares
    join.update(_bound(8 * n + 8 * n + 4 * n + 4 * n, n * (2 + 2 * steps)))
    join.update(_latency_bound(keys[0][1], tol, n, steps))
    rows = []
    for name, t, line in (("window_minmax", minmax, 66),
                          ("join_bounds", join, 106)):
        rows.append({"name": f"stream.{name}", "route": "cuda",
                     "source": source,
                     "replaces": f"{STREAM_REPLACES}:{line}",
                     "launches": launches[name],
                     "max_abs_err": err[name], **t})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.core.api import default_deployment
    from repro_torch.data.mimic import load_mimic_demo, mimic_demo_arrays
    from repro_torch.kernels.quant_cast import quant_cast as k
    from repro_torch.kernels.stream import stream as sk
    from repro_torch.stream import compile as qc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build()
    err = parity()
    stream_err = stream_parity()

    bd = default_deployment()
    t0 = time.perf_counter()
    load_mimic_demo(bd, seed=SEED, **MAIN_PATH)
    torch.cuda.synchronize()
    emit({"phase": "load", "sizes": MAIN_PATH,
          "seconds": time.perf_counter() - t0, "device": str(bd.device)})
    data = mimic_demo_arrays(seed=SEED, **MAIN_PATH)

    k.reset_launch_counts()                   # the query path starts here
    queries(bd, data)
    kv = quant_route(bd)
    torch.cuda.synchronize()
    launches = k.launch_counts()              # ... and ends here
    emit({"phase": "launches", "main_path": launches})
    for name, count in launches.items():
        check(count > 0, f"the main path launched no {name} kernel")
    quant_checks(bd, kv)
    del kv, bd
    torch.cuda.empty_cache()

    bds = default_deployment(stream_engines=2)
    _set_backend("jit")
    qc.reset_stats()
    sk.reset_launch_counts()                  # the stream path starts here
    waveform_feed(bds)
    join = paired_feed(bds)
    sharded_feed()
    torch.cuda.synchronize()
    stream_launches = sk.launch_counts()      # ... and ends here
    stats = qc.stats()
    emit({"phase": "launches", "stream_path": stream_launches,
          "compile_stats": stats})
    for name, count in stream_launches.items():
        check(count > 0, f"the stream path launched no {name} kernel")
    check(stats["fallbacks"] == 0 and stats["executions"] > 0,
          f"compiled path: {stats}")
    join_checks(bds, join)
    del join, bds
    torch.cuda.empty_cache()

    rows = quant_kernel_rows(launches, err)
    rows += stream_kernel_rows(stream_launches, stream_err)
    emit({"kernels": rows})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
