#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``): the quickest
proof that the port builds, is right and runs its main path on the card.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without them.  It prints one JSON object per line:

1. build     builds the CUDA kernels from the sources in the checkout;
2. parity    holds each kernel against its plain PyTorch version on the
             card, bitwise, on small shapes, an all-zero block, a row
             holding a NaN and the main path's shapes;
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
5. kernels   each kernel's time (CUDA events over a CUDA graph of
             launches, L2 defeated by rotating buffers) beside its bound,
             its plain version's time, the time of the one PyTorch call
             that computes the same function where there is one, and its
             main-path launches;

then the card's name and power limit, and last the contract line
``{"ok": true, "device": {...}}``.  No phase catches an error.
"""
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
MAIN_PATH = dict(num_patients=32768, num_orders=1048576, wave_len=524288,
                 num_logs=4096)
KV_LAYERS, KV_LEAF = 28, (8, 4096, 2, 128)     # configs/qwen2_1_5b.py cache
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12                          # f32 outside the tensor cores
REPLACES = "src/repro/kernels/quant_cast/quant_cast.py"


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
    t0 = time.perf_counter()
    k.load()
    ptxas = [ln.strip() for ln in _build.BUILD_LOGS.get("quant_cast",
                                                        "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "library": "quant_cast",
          "seconds": time.perf_counter() - t0, "ptxas": ptxas})


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


# -- 5. kernel times --------------------------------------------------------------
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


def kernel_times(launches: dict, err: dict) -> None:
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
    emit({"kernels": rows})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.core.api import default_deployment
    from repro_torch.data.mimic import load_mimic_demo, mimic_demo_arrays
    from repro_torch.kernels.quant_cast import quant_cast as k
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build()
    err = parity()

    bd = default_deployment()
    t0 = time.perf_counter()
    load_mimic_demo(bd, seed=SEED, **MAIN_PATH)
    torch.cuda.synchronize()
    emit({"phase": "load", "sizes": MAIN_PATH,
          "seconds": time.perf_counter() - t0, "device": str(bd.device)})
    data = mimic_demo_arrays(seed=SEED, **MAIN_PATH)

    k.reset_launch_counts()                   # the main path starts here
    queries(bd, data)
    kv = quant_route(bd)
    torch.cuda.synchronize()
    launches = k.launch_counts()              # ... and ends here
    emit({"phase": "launches", "main_path": launches})
    for name, count in launches.items():
        check(count > 0, f"the main path launched no {name} kernel")
    quant_checks(bd, kv)
    del kv
    torch.cuda.empty_cache()

    kernel_times(launches, err)
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
