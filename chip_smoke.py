#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``): the quickest
proof that the port builds, is right and runs its main path on the card.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without them.  It prints one JSON object per line:

1. build     builds the CUDA kernels from the sources in the checkout,
             one nvcc for each of the six libraries, all started
             together;
2. parity    holds each kernel against its plain PyTorch version on the
             card, bitwise: quant_cast on small shapes, an all-zero
             block, a row holding a NaN and the main path's shapes; the
             streaming kernels on rows holding a NaN or both signed
             zeros, W = 1, 7, 13 and 1024, sizes 1, 7,500, 8,191, 8,192,
             8,193 and 450,000, a row off the 16-byte grid, join keys
             tied at both edges of their band, 1 and 2 right keys, left
             counts that fill no whole block, and the main path's 450,000
             x 450,000 keys in arrival order, shuffled, and with +-inf
             and NaN keys (against the plain version of the kernel's
             algorithm, ref.join_bounds_narrowed, whose routes it
             prints; +-inf also against searchsorted);
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
             (torch.profiler); then each streaming kernel's device
             kernels a call at its timed shapes (torch.profiler; 1 each,
             or the phase fails);
5b. durable  the waveform feed of phase 5 made durable (a segment log
             and a checkpoint every 262,144 logged rows, the last three
             kept), under the same four standing queries: killed at its
             120th log write (a torn record) by an armed crash point,
             recovered through ``recover_stream`` into a fresh
             deployment, its fingerprint held to an uncrashed twin fed
             the same durable prefix, then both fed the rest and every
             tick of the recovered one held bit for bit to the twin's;
             the same for the 4-shard feed, killed right after its third
             checkpoint's save; window_minmax launched after recovery;
             log bytes, rows replayed and recovery seconds, a blocking
             and an async checkpoint's seconds, and the feed's append
             and tick p50 with durability and without, in turns;
5c. door     the waveform feed of phase 5 behind the serving front door
             (``repro_torch.serve.frontdoor``): the stream declared in
             ``ServeConfig.streams``, durable, with 64 tenants (a 65th
             refused) each subscribed to the four standing queries, every
             eighth also to the stream's rate; every polling tenant
             handed the very result object tenant 0 is, each result
             bitwise a twin deployment's whose queries are registered
             directly, and window_minmax launched as often as for the
             twin; the tenant that never polls loses exactly its results
             past the last 64; two read replicas caught up from the
             segment log every 20 ticks, each read bitwise the primary's
             window; in turns (door, twin, twin, door); then 16 tenants
             on the ABP/ECG join against its twin, join_bounds launched
             as often; feed and tick times, each tick's fan-out and
             garbage-collector time, replica refresh and read seconds,
             and each turn's added peak memory;
5d. admin    every command of ``repro_torch.core.admin`` in-process on the
             card at the reference's default flags, each output checked
             for what it states (serve's deliveries, recover's identical
             fingerprint and replayed rows, trace's layers, compile among
             them, the metrics' tick and serve series, rebalance's move,
             status's islands), then ``python -m repro_torch.core.admin
             status`` and ``examples/quickstart_torch.py`` as processes;
6. flash     flash attention against its plain version on the card, each
             case through the kernel its dtype and head dim route it to
             (the tensor-core kernel for bf16 at head dim 64 or 128, the
             CUDA-core one for f32 and head dims 16 and 32), checked by
             the route's launch count: the shapes of tests/test_kernels.py,
             the serve shape (8, 1024, 12, 128) in f32 and bf16, a ragged
             (1, 1000, 12, 128) in f32 and bf16, S = 1, 63, 65 and 2,048,
             Jamba's GQA ratio (32/8 heads), and full (non-causal)
             attention; then the serve and ragged shapes again with scores
             of standard deviation ~300 (integer q and k, so every score
             is exact in float32 on both sides), the scale the
             reference's initializer gives at full width, where every
             softmax saturates and an error in the running max or its
             rescale would show; 2e-5 for f32, 2e-2 for bf16, as
             tests/test_kernels.py;
7. scans     rwkv6_scan and mamba_scan against their plain versions on
             the card (float64): rwkv6_scan through both routes, each case
             checked by its route counter (per-token at S = 1 and 15,
             chunked at the shapes of tests/test_kernels.py, a ragged S of
             1,000 and the serve shape (8, 1024, 64, 64) f32), with decays
             at RWKV6-7B's full width (where the TPU kernel's chunked form
             underflows), near 1, near 0 and at the edges (0, 1e-30,
             1 - 1e-7, 1), carried and not; mamba_scan at the shapes of
             tests/test_kernels.py, S = 1, ragged S, Di off the block
             grid, N < 16, decays at full width, near 1, near 0 and at the
             edges (through A at a small dt, and through a large dt,
             where the kernel and the plain float32 scans are also held
             to a bound on float32's rounding), and the serve shape (8,
             1024, 8192, 16) in bf16 and f32; 5e-4 and 5e-5, a bf16 y to
             one bf16 rounding;
8. serve     Qwen2-1.5B at its published width (28 layers, d_model 1536,
             vocab 151936; float32 params drawn on the card from seed 0,
             the attention projections rescaled to their true fan-in,
             bf16 compute) served through ``Scheduler``: a wave of eight
             1,024-token prompts and a wave of eight 600-1,000-token
             prompts left-padded to 1,000 (off the 128 grid), 32 new
             tokens each; every prefill's attention through the flash
             kernel's tensor-core route (28 launches a prefill), the
             flash prefill against
             the plain attention path (5e-2 of the largest logit, the
             bound of tests/test_decode_consistency.py), the last decode
             step against a full forward, the first wave bitwise
             repeatable, every logit finite; prefill and decode seconds a
             wave, decode tokens/s and peak device memory; and one decode
             step's card time against its wall time (torch.profiler);
8b. seamless seamless-m4t-medium (the encoder-decoder: 12 + 12 layers,
             d_model 1024, 16 heads of 64, vocab 256206) at its published
             width, served as phase 8 serves Qwen2 (every attention block
             rescaled to its true fan-in; the stub audio frontend's zero
             frames): the decoder's causal self-attention through the
             flash kernel's tensor-core route (12 launches a prefill; the
             encoder and the cross-attention run the plain path, as in
             the reference), the prefill against the plain path and the
             last decode step against a full forward, 5e-2 of the
             largest logit, row by row; prefill and decode seconds,
             decode tokens/s and peak device memory a wave;
9. families  RWKV6-7B at full width (32 layers, d_model 4096, vocab
             65536) and Jamba-v0.1 at full width cut to one period of 8
             layers (13.3 B params), bf16 params drawn on the card leaf by
             leaf from seed 0 and calmed (``_calm_weights``: the
             recurrent mixers' output projections at a tenth, the MoE
             routers at zero, attention at its true fan-in),
             attn_impl="flash", served
             through ``Scheduler`` (RWKV6: waves A and B as phase 8's;
             Jamba: wave A), 16 new tokens each: each scan launched on its
             path in prefill and in decode (rwkv6_scan's chunked and
             per-token routes), and flash attention in Jamba's; the
             prefill through
             the kernels against the plain path's prefill and the last
             decode step against a full forward through the plain path,
             5e-2 of the largest logit, row by row; prefill and decode
             seconds, decode tokens/s and peak device memory;
10. ml       the bdml island: standing infers of the lm and moe aliases
             over one-minute windows of the ICU waveform feed (a
             1,048,576-row ring, 20 batches) and of the rwkv6 and mamba
             aliases over ten-second windows every fifth tick, each
             score bitwise the port's direct registry.forward on the same
             rows, one wave a tick; the island runs the reduced configs
             with plain attention and scans, as the reference does, so
             this phase launches no kernel;
11. kernels  each kernel's time (CUDA events over a CUDA graph of
             launches, L2 defeated by rotating buffers) beside its bound,
             its plain version's time, the time of the one PyTorch call
             that computes the same function where there is one, and its
             launches on its path (phases 3-4 for quant_cast, phases 5,
             5b and 5c for the streaming kernels, phases 8, 8b and 9 for
             flash attention,
             phase 9 for the scans, by route); for the scans also their
             time at S = 1 beside the state's bytes, mamba_scan's exp
             floor on the SFUs, the models' prefill seconds, ptxas's
             registers and spills and their SASS hot loops
             (repro_torch.kernels._sass); for the streaming kernels
             their times at every main-path shape (window_minmax at (1,
             450,000), (1, 7,500) and (1,024, 7,500), join_bounds at
             450,000^2 in arrival order, sorted and shuffled and at
             524,288^2), the routes the join's blocks took, the launch
             floor (an empty kernel timed the same way), ptxas and
             SASS; for
             flash attention its tensor-core route at Qwen2's and Jamba's
             shapes, the CUDA-core route in f32, the tensor-core kernel's
             registers and spills (ptxas) and whether its machine code
             holds wgmma (HGMMA) and TMA loads (UTMALDG), and the
             seamless decoder's shape (8, 1024, 16/16, 64);

then the card's name and power limit, and last the contract line
``{"ok": true, "device": {...}}``.  No phase catches an error.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import threading
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
BF16_OPS_PER_S = 989e12                        # bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12                        # tf32 tensor cores, dense
SFU_EX2_PER_CLOCK = 16                         # MUFU.EX2 an SM a clock
REPLACES = "src/repro/kernels/quant_cast/quant_cast.py"
STREAM_REPLACES = "src/repro/stream/kernels.py"
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py"
WKV_REPLACES = "src/repro/kernels/rwkv6_scan/rwkv6_scan.py"
SCAN_REPLACES = "src/repro/kernels/mamba_scan/mamba_scan.py"

# serving Qwen2-1.5B at full width (configs/qwen2_1_5b.py): two waves of
# eight requests, the second left-padded to a length off the 128 grid
SERVE = dict(max_batch=8, cache_len=1088, max_new_tokens=32)
WAVE_A_LEN, WAVE_B_LENS = 1024, (600, 1000)
SERVE_SHAPE = (8, WAVE_A_LEN, 12, 2, 128)      # B, S, Hq, Hkv, Dh
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # test_kernels.py
LOGIT_TOL = 5e-2                    # tests/test_decode_consistency.py
ML_BATCHES = 20
# the recurrent and hybrid families served at full width: RWKV6-7B whole,
# Jamba-v0.1 cut to one period (8 of its 32 layers: 52 B params do not
# fit one H100); 16 new tokens a request
FAMILY_SERVE = dict(max_batch=8, cache_len=1088, max_new_tokens=16)
JAMBA_LAYERS = 8
WKV_SHAPE = (8, 1024, 64, 64)                  # B, S, H, D: RWKV6-7B's wave
SCAN_SHAPE = (8, 1024, 8192, 16)               # B, S, Di, N: Jamba's wave
SCAN_TOL = {"rwkv6_scan": 5e-4, "mamba_scan": 5e-5}   # test_kernels.py
# the ml island's recurrent aliases run their plain scans token by token
# (the reduced configs with plain attention, as the reference's island
# runs them): ten-second windows, every fifth tick
ML_SCAN_WINDOW, ML_SCAN_EVERY = 1250, 5

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
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.quant_cast import quant_cast as k
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    from repro_torch.kernels.stream import stream as sk
    t0 = time.perf_counter()
    loads = (k.load, sk.load, fk.load, fk.load_sm90, wk.load, mk.load)
    with ThreadPoolExecutor(max_workers=len(loads)) as pool:
        for lib in [pool.submit(load) for load in loads]:
            lib.result()
    seconds = time.perf_counter() - t0
    for name in ("quant_cast", "stream", "flash_attention",
                 "flash_attention_sm90", "rwkv6_scan", "mamba_scan"):
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
    # the one-minute window alone (one block), the largest row one block
    # takes and one value more (three blocks and a fold), one-minute
    # windows batched
    shapes += [(1, MINUTE), (1, 8192), (1, 8193), (1024, MINUTE)]
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
    # the main path's 450,000 x 450,000 keys: left keys in the paired
    # feed's arrival order (within +-2 of sorted), shuffled, and in arrival
    # order with +-inf keys (their blocks search all of rs); then NaN keys,
    # which the plain version of the kernel's algorithm answers as the
    # reference's kernel does (0), where searchsorted answers len(rs)
    geo = sk.join_geometry(HOUR, sk.load().repro_join_bounds_keys())
    for order in ("arrival", "shuffled", "arrival_inf", "arrival_nan"):
        lt_d, rs_d = join_inputs(order.split("_")[0], HOUR, copies=1)[0]
        lt = lt_d.cpu().numpy()
        if order != "arrival" and order != "shuffled":
            bad = np.inf if order.endswith("inf") else np.nan
            lt[[5, 70000, 70001, HOUR - 1]] = [bad, -bad, bad, -bad]
            lt_d = torch.from_numpy(lt).cuda()
        rs = rs_d.cpu().numpy()
        lo, hi = sk.join_bounds_1d(lt_d, rs_d, tol, ops.steps(HOUR))
        lo, hi = lo.cpu(), hi.cpu()
        nlo, nhi, routes = ref.join_bounds_narrowed(
            torch.from_numpy(lt), torch.from_numpy(rs), tol, geo.block,
            sk.load().repro_join_bounds_budget())
        check(torch.equal(lo, nlo) and torch.equal(hi, nhi),
              f"join_bounds differs from its algorithm's plain version "
              f"({order})")
        if order.endswith("nan"):
            nan = np.isnan(lt)
            check(not lo.numpy()[nan].any() and not hi.numpy()[nan].any(),
                  "join_bounds: a NaN key does not find 0")
            keep = ~nan
        else:
            want_lo, want_hi = ref.join_bounds(lt_d, rs_d, tol)
            check(torch.equal(lo, want_lo.cpu())
                  and torch.equal(hi, want_hi.cpu()),
                  f"join_bounds differs from the plain version ({order})")
            keep = np.ones(HOUR, bool)
        check(np.array_equal(lo.numpy()[keep], np.searchsorted(
            rs, lt[keep] - tol, side="left")) and np.array_equal(
            hi.numpy()[keep], np.searchsorted(rs, lt[keep] + tol,
                                              side="right")),
              f"join_bounds against np.searchsorted ({order})")
        emit({"phase": "parity", "kernel": "join_bounds",
              "case": [HOUR, HOUR, order], "routes": routes,
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


def _device_times(fn) -> dict:
    """Card time of one call of ``fn``, by kernel and copy, from
    torch.profiler: only the events that ran on the card (a host op's
    self device time repeats its kernels'), less the profiler's own
    activity-buffer requests; with the call's wall time and the number
    of device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, events = {}, 0
    for ev in prof.key_averages():
        if (ev.device_type == DeviceType.CPU
                or ev.key.startswith("Activity Buffer")):
            continue
        us = ev.self_device_time_total
        if us > 0:
            rows[ev.key] = rows.get(ev.key, 0.0) + us
            events += ev.count
    total = sum(rows.values())
    copy = sum(us for key, us in rows.items() if "HtoD" in key)
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:8]
    return {"device_us": total, "wall_us": wall * 1e6,
            "device_events": events, "htod_us": copy,
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
          "join_tick_host": share,
          "join_card": _device_times(lambda: bd.query(JOIN))})
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
          "pairs": int(cols["dt"].shape[0]),
          "left_keys_sorted": bool((left[1:] >= left[:-1]).all())})


# -- 5b. durable streams: crash, recover, continue ------------------------------------
# the durable ICU feed: the waveform ring of phase 5 with a segment log and
# a checkpoint every 262,144 logged rows (every 35th one-minute batch),
# keeping the last three; the plain feed is killed at its 120th log write
# (torn: a record header on disk, no payload), the 4-shard feed right
# after its third checkpoint's async save started, which the kill takes
# with it; (point, hit, async saves the kill takes)
DURABLE = dict(checkpoint_every_rows=262144, keep=3)
DURABLE_CRASHES = {"plain": ("stream/log:torn", 120, 0),
                   "sharded": ("stream/checkpoint:saved", 3, 1)}
SHARDED_DURABLE = dict(shards=4, num_engines=2)


def _durable_deployment(directory, queries, shards: int):
    """A deployment whose waveform stream is registered as the feed
    registers it, with ``directory``'s durability when one is given, and
    the standing ``queries`` on it."""
    from repro_torch.core.api import default_deployment
    from repro_torch.stream.spec import Durability, StreamSpec
    bd = default_deployment(stream_engines=2)
    kw = dict(SHARDED_DURABLE) if shards > 1 else {}
    spec = StreamSpec.from_kwargs(
        WAVE, ("signal", "hr"), capacity=WAVE_FEED["capacity"], **kw)
    if directory is not None:
        spec = dataclasses.replace(spec, durability=Durability(
            str(directory), **DURABLE))
    bd.register_stream("streamstore0", spec)
    cqs = {name: bd.register_continuous(q, every, name=name)
           for name, (q, every) in queries.items()}
    return bd, cqs


def _feed_batches(bd, batches, tick: bool = True) -> list:
    """Append each (signal, hr) batch and tick; per batch the ticked
    queries' results and the host seconds of the append and the tick."""
    stream = bd.engines["streamstore0"].get(WAVE)
    out = []
    for signal, hr in batches:
        t0 = time.perf_counter()
        stream.append({"signal": signal, "hr": hr})
        t1 = time.perf_counter()
        ran = bd.streams.tick() if tick else []
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.append({"values": [(n, bd.streams.queries[n].last_value)
                               for n, _ in ran],
                    "append_s": t1 - t0, "tick_s": t2 - t1})
    return out


def _p50(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _same_ticks(a: list, b: list) -> bool:
    """Two feeds' ticks ran the same queries with bit-identical results."""
    return len(a) == len(b) and all(
        [n for n, _ in x["values"]] == [n for n, _ in y["values"]]
        and all(_same_value(u, v) for (_, u), (_, v)
                in zip(x["values"], y["values"]))
        for x, y in zip(a, b))


def _crash_and_recover(root, batches, queries, shards: int,
                       launches) -> dict:
    """Feed a durable deployment until its armed crash point fires, then
    recover the stream into a fresh deployment, hold it to an uncrashed
    twin fed the same durable prefix (fingerprint), feed both the rest
    and hold every tick of the recovered one to the twin's, bit for
    bit.  ``launches()`` reads window_minmax's launch count."""
    from repro_torch.core.api import default_deployment
    from repro_torch.runtime import fault
    from repro_torch.stream import durability as dur
    kind = "sharded" if shards > 1 else "plain"
    point, at_hit, saves_lost = DURABLE_CRASHES[kind]
    directory = root / kind
    bd, _ = _durable_deployment(directory, queries, shards)
    durable = bd.engines["streamstore0"].get(WAVE)._durable
    died = []                     # threads the kill reached

    def hook(args):
        if args.exc_type is fault.SimulatedCrash:
            died.append(args.exc_value.point)
        else:
            default_hook(args)

    default_hook, threading.excepthook = threading.excepthook, hook
    fault.arm_crash_point(point, at_hit)
    crashed_at = exc_point = None
    try:
        for b, batch in enumerate(batches):
            crashed_at = b
            _feed_batches(bd, [batch])
        crashed_at = None
    except fault.SimulatedCrash as exc:
        # a kill takes the process's other threads with it: an async
        # save still in flight dies before its promote (this arming
        # comes microseconds after the save's thread started, long
        # before its ~10 ms of writes end)
        report = fault.disarm_crash_points()
        fault.arm_crash_point("checkpoint/promote")
        exc_point = exc.point
    else:
        report = fault.disarm_crash_points()
    try:
        durable.manager.wait()              # join the save, dead or done
    finally:
        fault.disarm_crash_points()
        threading.excepthook = default_hook
    check(crashed_at is not None and exc_point == point
          and report["fired"] == point and len(report["hits"]) == at_hit,
          f"{kind}: {point} fired {report['fired']!r} after "
          f"{len(report['hits'])} hits")
    check(crashed_at >= len(batches) // 2,
          f"{kind}: crashed in the first half (batch {crashed_at})")
    check(died == ["checkpoint/promote"] * saves_lost,
          f"{kind}: the kill took {died} of the async saves, not "
          f"{saves_lost}")
    stats = durable.stats()
    durable.close()
    del bd
    rec = default_deployment(stream_engines=2)
    t0 = time.perf_counter()
    stream = rec.recover_stream("streamstore0", str(directory))
    recover_s = time.perf_counter() - t0
    last = stream._durable.last_recovery
    check(last["rows_replayed"] > 0,
          f"{kind}: recovery replayed no rows of the log")
    rows = WAVE_FEED["batch_rows"]
    check(stream.total_appended % rows == 0,
          f"{kind}: recovered {stream.total_appended} rows, not whole "
          f"batches")
    done = stream.total_appended // rows
    check(done <= crashed_at + 1, f"{kind}: recovered past the crash")
    twin, _ = _durable_deployment(None, {}, shards)
    _feed_batches(twin, batches[:done], tick=False)
    twin_stream = twin.engines["streamstore0"].get(WAVE)
    check(dur.fingerprint(stream) == dur.fingerprint(twin_stream),
          f"{kind}: the recovered stream's fingerprint differs from the "
          f"twin's")
    cqs = {name: rec.register_continuous(q, every, name=name)
           for name, (q, every) in queries.items()}
    for name, (q, every) in queries.items():
        twin.register_continuous(q, every, name=name)
    rest = batches[done:]
    got, want, minmax = [], [], 0
    for batch in rest:
        before = launches()
        got += _feed_batches(rec, [batch])
        minmax += launches() - before
        want += _feed_batches(twin, [batch])
    check(_same_ticks(got, want),
          f"{kind}: a tick after recovery differs from the twin's")
    check(dur.fingerprint(stream) == dur.fingerprint(twin_stream),
          f"{kind}: the fed streams' fingerprints differ")
    for name, cq in cqs.items():
        check(cq.errors == 0 and cq.executions > 0,
              f"{kind} {name} after recovery: {cq.metrics()}")
    stream._durable.close()
    return {"feed": kind, "crash_point": point, "crash_hit": at_hit,
            "async_saves_lost": len(died), "crashed_at_batch": crashed_at, "batches_recovered": done,
            "log_bytes": stats["log_bytes"],
            "log_segments": stats["segments"],
            "checkpoints_before_crash": stats["checkpoints"],
            "recovered_from_checkpoint": last["checkpoint_step"],
            "records_replayed": last["records_replayed"],
            "rows_replayed": last["rows_replayed"],
            "truncated_records": last["truncated_records"],
            "recover_s": last["seconds"], "recover_stream_s": recover_s,
            "ticks_compared": len(rest),
            "window_minmax_after_recovery": minmax,
            "queries_after_recovery": {n: cq.metrics()["p50_latency_ms"]
                                       for n, cq in cqs.items()}}


def _checkpoint_seconds(root, batches) -> dict:
    """One blocking and one async checkpoint of the full ring (after
    the whole feed, no cadence), each timed to its return; the async
    one also to its landing (``manager.wait``)."""
    bd, _ = _durable_deployment(root / "ckpt", {}, 1)
    _feed_batches(bd, batches, tick=False)
    durable = bd.engines["streamstore0"].get(WAVE)._durable
    t0 = time.perf_counter()
    durable.checkpoint(blocking=True)
    blocking = time.perf_counter() - t0
    t0 = time.perf_counter()
    durable.checkpoint(blocking=False)
    returned = time.perf_counter() - t0
    durable.manager.wait()
    landed = time.perf_counter() - t0
    step = durable.manager.latest_step()
    path = root / "ckpt" / "ckpt" / f"step_{step:08d}"
    nbytes = sum(f.stat().st_size for f in path.iterdir())
    durable.close()
    return {"blocking_s": blocking, "async_return_s": returned,
            "async_landed_s": landed, "checkpoint_bytes": nbytes}


def _turns(root, batches, queries) -> dict:
    """The same feed with durability and without, in turns (durable,
    plain, durable, plain): per turn the p50 host seconds of an append
    and of a tick, and each standing query's p50."""
    out = {"durable": [], "plain": []}
    for i, kind in enumerate(("durable", "plain", "durable", "plain")):
        directory = root / f"turn{i}" if kind == "durable" else None
        bd, cqs = _durable_deployment(directory, queries, 1)
        ticks = _feed_batches(bd, batches)
        if directory is not None:
            bd.engines["streamstore0"].get(WAVE)._durable.close()
        out[kind].append({
            "append_p50_ms": 1e3 * _p50([t["append_s"] for t in ticks]),
            "tick_p50_ms": 1e3 * _p50([t["tick_s"] for t in ticks]),
            "feed_s": sum(t["append_s"] + t["tick_s"] for t in ticks),
            "queries_p50_ms": {n: cq.metrics()["p50_latency_ms"]
                               for n, cq in cqs.items()}})
        del bd, cqs
    return out


def durable_feed(root) -> dict:
    """Phase 5b: the ICU waveform feed made durable, crashed and
    recovered (plain and 4-shard), its checkpoints timed, and its ticks
    with durability against without, in turns.  Returns window_minmax's
    launches on this path: the whole phase and after the recoveries."""
    from repro_torch.kernels.stream import stream as sk
    _set_backend("jit")
    queries = WAVE_QUERIES
    signal, hr = _waveform_rows(WAVE_FEED["batch_rows"],
                                WAVE_FEED["num_batches"], WAVE_FEED["seed"])
    n = WAVE_FEED["batch_rows"]
    batches = [(signal[i:i + n], hr[i:i + n])
               for i in range(0, signal.shape[0], n)]
    def count():
        return sk.launch_counts()["window_minmax"]

    sk.reset_launch_counts()              # the durable path starts here
    crashes = [_crash_and_recover(root, batches, queries, shards, count)
               for shards in (1, 4)]
    total = count()                       # ... and ends here
    for c in crashes:
        emit({"phase": "durable", **c})
    ckpt = _checkpoint_seconds(root, batches)
    turns = _turns(root, batches, queries)
    emit({"phase": "durable", "checkpoint": ckpt, "turns": turns})
    after = sum(c["window_minmax_after_recovery"] for c in crashes)
    check(after > 0, "no window_minmax launch after recovery")
    emit({"phase": "durable", "checks": "passed",
          "window_minmax_launches": total,
          "window_minmax_after_recovery": after})
    return {"window_minmax": total, "after_recovery": after}


# -- 5c. the front door: 64 tenants on the ICU feed's standing queries -----------
# the door's defaults: 64 tenants, 64 results buffered a subscription;
# every tenant subscribes the four standing queries of phase 5, every
# eighth also the stream's rate every other tick, and the last one never
# polls; two read replicas, caught up from the segment log every 20 ticks
TENANTS, RESULT_BUFFER = 64, 64
RATE = (f"bdstream(rate({WAVE}))", 2)
RATE_TENANTS = 8
DOOR_QUERIES = {**WAVE_QUERIES, "rate": RATE}
IDLE_TENANT = TENANTS - 1
REPLICAS, REFRESH_EVERY = 2, 20
JOIN_TENANTS = 16
# what the tenant that never polls must have lost: all it was delivered
# but the last 64; a query delivers on each tick it ran without error, so
# hr_max_1h delivers 160 - 59 = 101, sliding_30s 160 / 20 = 8
WANT_DROPPED = {"hr_max_1h": 37, "signal_min_1m": 96, "wave_avg": 96,
                "sliding_30s": 0}


class _GcClock:
    """The seconds the cyclic garbage collector ran and its collections,
    clocked through ``gc.callbacks``."""

    def __init__(self) -> None:
        self.seconds, self.collections, self._t0 = 0.0, 0, 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.collections += 1


def _same_result(name: str, a, b) -> bool:
    """Two results of one query equal bit for bit; the rate's
    rows_per_second reads the wall clock, so only its counters are."""
    if name == "rate":
        a, b = ({k: v for k, v in x.columns.items()
                 if k != "rows_per_second"} for x in (a, b))
    return _same_value(a, b)


def _wave_spec(directory):
    from repro_torch.stream.spec import Durability, StreamSpec
    return StreamSpec(WAVE, ("signal", "hr"),
                      capacity=WAVE_FEED["capacity"],
                      durability=Durability(str(directory), **DURABLE))


def _queries_s(bd, ran) -> float:
    """The seconds a tick's standing queries took to execute."""
    return sum(bd.streams.queries[name].last_latency_seconds
               for name, _ in ran)


def _door_turn(directory, batches, count, gc_clock) -> dict:
    """The ICU feed behind a front door: 64 tenants, a 65th refused, the
    polling tenants each handed the very result object tenant 0 is, the
    idle tenant's losses counted, the replicas refreshed and read.
    Returns each query's results by tick (tenant 0's), the door's
    stats, its window_minmax launches and its timings, each tick's with
    the door's fan-out (its tick listener, read from the
    ``repro_serve_fanout_seconds`` histogram) and the collector's time."""
    from repro_torch.core.api import default_deployment
    from repro_torch.obs import metrics, trace
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.frontdoor import AdmissionError, FrontDoor
    bd = default_deployment()
    door = FrontDoor(bd, ServeConfig(streams=(_wave_spec(directory),)),
                     stream_engine="streamstore0",
                     result_buffer=RESULT_BUFFER)
    check(door.max_tenants == TENANTS, f"max_tenants {door.max_tenants}")
    sessions = [door.open_session(f"tenant{i}") for i in range(TENANTS)]
    try:
        door.open_session(f"tenant{TENANTS}")
        refused = None
    except AdmissionError as exc:
        refused = str(exc)
    check(refused is not None and "max_tenants" in refused,
          "the 65th tenant was admitted")
    subs = []
    for i, session in enumerate(sessions):
        subs.append({name: session.subscribe(q, every)
                     for name, (q, every) in WAVE_QUERIES.items()})
        if i % RATE_TENANTS == 0:
            subs[i]["rate"] = session.subscribe(*RATE)
    st = door.stats()
    check(st["subscriptions"] == TENANTS * len(WAVE_QUERIES) + RATE_TENANTS
          and st["shared_queries"] == len(WAVE_QUERIES) + 1,
          f"subscriptions {st}")
    door.replicate(WAVE, REPLICAS)
    primary = bd.engines["streamstore0"].get(WAVE)
    fanout = metrics.histogram("repro_serve_fanout_seconds")
    results = {name: {} for name in DOOR_QUERIES}
    ticks, refreshes, reads = [], [], []
    before = count()
    torch.cuda.synchronize()
    for b, (signal, hr) in enumerate(batches, 1):
        t0 = time.perf_counter()
        primary.append({"signal": signal, "hr": hr})
        t1 = time.perf_counter()
        fan0, gc0 = fanout.sum, gc_clock.seconds
        ran = bd.streams.tick()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fan_s, gc_s = fanout.sum - fan0, gc_clock.seconds - gc0
        first = {name: sub.poll() for name, sub in subs[0].items()}
        for i in range(1, TENANTS):
            if i == IDLE_TENANT:
                continue
            for name, sub in subs[i].items():
                got, want = sub.poll(), first[name]
                check(len(got) == len(want) and all(
                    t == u and v is w for (t, v), (u, w) in zip(got, want)),
                    f"tenant {i} {name}, tick {b}: not tenant 0's result")
        t3 = time.perf_counter()
        for name, got in first.items():
            results[name].update(got)
        ticks.append({"append_s": t1 - t0, "tick_s": t2 - t1,
                      "poll_s": t3 - t2, "fanout_s": fan_s, "gc_s": gc_s,
                      "queries_s": _queries_s(bd, ran)})
        if b % REFRESH_EVERY == 0:
            t0 = time.perf_counter()
            rows = door.refresh_replicas(WAVE)
            refreshes.append({"s": time.perf_counter() - t0,
                              "rows": sum(rows.values())})
            for _ in range(REPLICAS):
                # the read's span names the replica that served it
                traced = trace.set_enabled(True)
                t0 = time.perf_counter()
                got = door.read(WAVE, MINUTE)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                trace.set_enabled(traced)
                served = [r.attrs["replica"] for r in trace.spans()
                          if r.name == "serve/read"][-1]
                want = primary.window(MINUTE)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                check(served.startswith(f"{WAVE}.replica")
                      and _same_value(got, want),
                      f"tick {b}: {served!r}'s window is not the primary's")
                reads.append({"replica": served, "replica_s": t1 - t0,
                              "primary_s": t2 - t1})
    launches = count() - before
    served = [r["replica"] for r in reads]
    check(len(set(served)) == REPLICAS and all(
        a != b for a, b in zip(served, served[1:])),
          f"reads did not alternate replicas: {served}")
    # the door's standing queries, fd<n> as the module counter names them
    standing = {(cq.bql, cq.every_n_ticks): cq
                for name, cq in bd.streams.queries.items()
                if name.startswith("fd")}
    check(len(standing) == len(DOOR_QUERIES),
          f"standing queries {sorted(bd.streams.queries)}")
    query_p50 = {}
    for name, (q, every) in DOOR_QUERIES.items():
        cq = standing[(q, every)]
        query_p50[name] = 1e3 * _p50(list(cq.latencies))
        want = WANT_ERRORS.get(name, 0)
        check(cq.errors == want and (cq.errors == 0 or NOT_YET.match(
            cq.last_error or "")), f"{name}: {cq.metrics()}")
    for name, sub in subs[IDLE_TENANT].items():
        check(sub.dropped == WANT_DROPPED[name]
              and sub.delivered - sub.dropped == min(sub.delivered,
                                                     RESULT_BUFFER)
              and sub.delivered == len(results[name]),
              f"idle tenant {name}: delivered {sub.delivered}, dropped "
              f"{sub.dropped}")
    stats = door.stats()
    door.close()
    check(not bd.streams.queries, "close left standing queries")
    primary._durable.close()
    return {"results": results, "stats": stats, "launches": launches,
            "ticks": ticks, "refreshes": refreshes, "reads": reads,
            "query_p50_ms": query_p50,
            "idle_tenant": {n: {"delivered": s.delivered,
                                "dropped": s.dropped}
                            for n, s in subs[IDLE_TENANT].items()},
            "refused": refused}


def _twin_turn(directory, batches, count, gc_clock) -> dict:
    """The same feed into a deployment whose queries are registered
    directly: each query's result by tick, launches and timings."""
    from repro_torch.core.api import default_deployment
    bd = default_deployment()
    primary = bd.register_stream("streamstore0", _wave_spec(directory))
    for name, (q, every) in DOOR_QUERIES.items():
        bd.register_continuous(q, every, name=name)
    results = {name: {} for name in DOOR_QUERIES}
    ticks = []
    before = count()
    torch.cuda.synchronize()
    for b, (signal, hr) in enumerate(batches, 1):
        t0 = time.perf_counter()
        primary.append({"signal": signal, "hr": hr})
        t1 = time.perf_counter()
        gc0 = gc_clock.seconds
        ran = bd.streams.tick()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for name, response in ran:
            results[name][b] = response.value
        ticks.append({"append_s": t1 - t0, "tick_s": t2 - t1,
                      "poll_s": 0.0, "fanout_s": 0.0,
                      "gc_s": gc_clock.seconds - gc0,
                      "queries_s": _queries_s(bd, ran)})
    launches = count() - before
    primary._durable.close()
    return {"results": results, "launches": launches, "ticks": ticks,
            "query_p50_ms": {name: 1e3 * _p50(list(
                bd.streams.queries[name].latencies))
                for name in DOOR_QUERIES}}


def _turn_times(turn) -> dict:
    """A turn's feed time and its ticks' medians: the tick, its fan-out,
    its collections and its standing queries' execution, apart and
    taken from the tick."""
    ticks = turn["ticks"]
    return {"feed_s": sum(t["append_s"] + t["tick_s"] + t["poll_s"]
                          for t in ticks),
            "tick_p50_ms": 1e3 * _p50([t["tick_s"] for t in ticks]),
            "fanout_p50_ms": 1e3 * _p50([t["fanout_s"] for t in ticks]),
            "tick_gc_ms": 1e3 * sum(t["gc_s"] for t in ticks),
            "ticks_with_gc": sum(t["gc_s"] > 0 for t in ticks),
            "tick_less_fanout_gc_p50_ms": 1e3 * _p50(
                [t["tick_s"] - t["fanout_s"] - t["gc_s"] for t in ticks]),
            "queries_p50_ms": 1e3 * _p50([t["queries_s"] for t in ticks]),
            "tick_outside_queries_p50_ms": 1e3 * _p50(
                [t["tick_s"] - t["queries_s"] for t in ticks]),
            "query_p50_ms": turn["query_p50_ms"],
            "poll_p50_ms": 1e3 * _p50([t["poll_s"] for t in ticks]),
            "gc_collections": turn["gc_collections"]}


def _join_door(door_side: bool) -> dict:
    """The paired ABP/ECG feed under the one-hour join: behind a door
    whose 16 tenants subscribe it every 4 ticks (each handed the very
    result object tenant 0 is), or registered directly."""
    from repro_torch.core.api import default_deployment
    from repro_torch.data.mimic import stream_mimic_paired_waveforms
    from repro_torch.kernels.stream import stream as sk
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.frontdoor import FrontDoor
    from repro_torch.stream.spec import StreamSpec
    bd = default_deployment()
    specs = tuple(StreamSpec.from_kwargs(
        f"mimic2v26.{side}_stream", ("ts", side),
        capacity=PAIRED_FEED["capacity"], shards=PAIRED_FEED["shards"],
        ts_field="ts", max_delay=PAIRED_FEED["max_delay"])
        for side in ("abp", "ecg"))
    results, subs, door = {}, [], None
    if door_side:
        door = FrontDoor(bd, ServeConfig(streams=specs),
                         stream_engine="streamstore0")
        subs = [door.open_session(f"tenant{i}").subscribe(JOIN, JOIN_EVERY)
                for i in range(JOIN_TENANTS)]
    else:
        for spec in specs:
            bd.register_stream("streamstore0", spec)
        bd.register_continuous(JOIN, JOIN_EVERY, name="abp_ecg_join")
    before = sk.launch_counts()["join_bounds"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for info in stream_mimic_paired_waveforms(bd, **PAIRED_FEED):
        if door_side:
            want = subs[0].poll()
            for i, sub in enumerate(subs[1:], 1):
                got = sub.poll()
                check(len(got) == len(want) and all(
                    t == u and v is w for (t, v), (u, w) in zip(got, want)),
                    f"join tenant {i}, batch {info['batch']}: not tenant "
                    f"0's result")
            results.update(want)
        else:
            results.update((bd.streams.ticks, bd.streams.queries[n].last_value)
                           for n, _ in info["ran"])
    torch.cuda.synchronize()
    out = {"results": results, "wall_s": time.perf_counter() - t0,
           "launches": sk.launch_counts()["join_bounds"] - before}
    if door is not None:
        out["stats"] = door.stats()
        door.close()
    return out


def frontdoor_feed(root) -> dict:
    """Phase 5c: the ICU feed's standing queries behind the front door,
    64 tenants (and 16 on the join), against twins whose queries are
    registered directly; in turns (door, twin, twin, door), each door
    held against the twin beside it.  Returns each streaming kernel's
    launches through the doors."""
    import gc
    from repro_torch.kernels.stream import stream as sk
    _set_backend("jit")
    signal, hr = _waveform_rows(WAVE_FEED["batch_rows"],
                                WAVE_FEED["num_batches"], WAVE_FEED["seed"])
    n = WAVE_FEED["batch_rows"]
    batches = [(signal[i:i + n], hr[i:i + n])
               for i in range(0, signal.shape[0], n)]

    def count():
        return sk.launch_counts()["window_minmax"]

    order = ("door", "twin", "twin", "door")
    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    sk.reset_launch_counts()              # the door's path starts here
    turns, door_launches, peak = [], 0, []
    for i, kind in enumerate(order):
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        collections = gc_clock.collections
        if kind == "door":
            turn = _door_turn(root / f"door{i}", batches, count, gc_clock)
            door_launches += turn["launches"]
        else:
            turn = _twin_turn(root / f"twin{i}", batches, count, gc_clock)
        turn["gc_collections"] = gc_clock.collections - collections
        # the turn's own peak: what it added to what earlier turns hold
        peak.append(torch.cuda.max_memory_allocated() - held)
        turns.append(turn)
        if i % 2:                         # turns 0-1 and 2-3 are pairs
            door, twin = ((turns[i - 1], turn) if kind == "twin"
                          else (turn, turns[i - 1]))
            check(door["launches"] == twin["launches"],
                  f"window_minmax: {door['launches']} launches behind "
                  f"{TENANTS} tenants, {twin['launches']} for the twin")
            for name, got in door["results"].items():
                want = twin["results"][name]
                check(sorted(got) == sorted(want)
                      and all(_same_result(name, got[t], want[t])
                              for t in want),
                      f"{name}: the door's results differ from the twin's")
            door["results"] = twin["results"] = None
    gc.callbacks.remove(gc_clock)
    join_door = _join_door(True)
    door_joins = join_door["launches"]
    join_twin = _join_door(False)
    check(join_door["launches"] == join_twin["launches"] > 0,
          f"join_bounds: {join_door['launches']} launches behind "
          f"{JOIN_TENANTS} tenants, {join_twin['launches']} for the twin")
    check(sorted(join_door["results"]) == sorted(join_twin["results"])
          and all(_same_value(join_door["results"][t],
                              join_twin["results"][t])
                  for t in join_twin["results"]),
          "the join's results behind the door differ from the twin's")
    door = turns[0]
    refresh, reads = door["refreshes"], door["reads"]
    emit({"phase": "frontdoor", "tenants": TENANTS,
          "refused_65th": door["refused"],
          "turns": [dict(_turn_times(t), kind=k, launches=t["launches"],
                         peak_bytes_added=p)
                    for k, t, p in zip(order, turns, peak)],
          "stats": {k: door["stats"][k] for k in (
              "tenants", "subscriptions", "shared_queries",
              "shared_attaches", "results_delivered", "results_dropped",
              "replicas", "p50_tick_ms", "p99_tick_ms", "p99_fanout_ms")},
          "idle_tenant": door["idle_tenant"],
          "replica_refresh_s": [r["s"] for r in refresh],
          "replica_refresh_rows": [r["rows"] for r in refresh],
          "read_replica_p50_ms": 1e3 * _p50([r["replica_s"] for r in reads]),
          "read_primary_p50_ms": 1e3 * _p50([r["primary_s"] for r in reads]),
          "reads_compared": len(reads)})
    emit({"phase": "frontdoor", "feed": "paired", "tenants": JOIN_TENANTS,
          "door_wall_s": join_door["wall_s"],
          "twin_wall_s": join_twin["wall_s"],
          "join_bounds_launches": join_door["launches"],
          "twin_join_bounds_launches": join_twin["launches"],
          "results_compared": len(join_twin["results"]),
          "stats": join_door["stats"]})
    emit({"phase": "frontdoor", "checks": "passed",
          "window_minmax_launches": door_launches,
          "join_bounds_launches": door_joins})
    return {"window_minmax": door_launches, "join_bounds": door_joins}


# -- 5d. the admin interface ---------------------------------------------------------
ADMIN_COMMANDS = ("status", "demo-status", "streams", "rebalance", "joins",
                  "trace", "recover", "serve", "ml", "metrics")


def _admin(argv) -> str:
    """One admin command run in-process; its standard output."""
    import contextlib
    import io
    from repro_torch.core import admin
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        admin.main(argv)
    return out.getvalue()


def _last_json(text: str) -> dict:
    """The JSON object a command prints last (after a flamegraph, say)."""
    start = text.rfind("\n{")
    return json.loads(text[start + 1:] if start >= 0 else text)


def admin_phase(root) -> dict:
    """Phase 5d: every admin command on the card at the reference's
    default flags (--ticks 8, --tenants 4), each output checked for what
    it states; then the CLI and the quickstart twin as processes."""
    from repro_torch.core import admin, islands
    from repro_torch.core.api import default_deployment
    seconds, outputs = {}, {}
    for command in ADMIN_COMMANDS:
        argv = [command]
        if command == "trace":
            argv += ["--out", str(root / "trace.json")]
        if command == "recover":
            argv += ["--dir", str(root / "wal")]
        t0 = time.perf_counter()
        outputs[command] = _admin(argv)
        torch.cuda.synchronize()
        seconds[command] = time.perf_counter() - t0
    got = {c: _last_json(outputs[c]) for c in ADMIN_COMMANDS
           if c != "metrics"}
    check(set(got["status"]["islands"]) == set(islands.ISLANDS) - {"ml"},
          f"status islands {sorted(got['status']['islands'])}")
    bd = default_deployment()
    bd.register_model("lm")
    check(list(admin.status(bd)["islands"]) == list(islands.ISLANDS),
          "a deployment with a model does not list the five islands")
    check(got["demo-status"]["catalog"]["objects"] > 0, "demo-status")
    check(got["streams"]["streams"]["queries"]["wave_avg"]["executions"]
          == 8, "streams: wave_avg did not run each tick")
    check(len(got["rebalance"]["rebalance"]["moves"]) == 1,
          f"rebalance moved {got['rebalance']['rebalance']}")
    check(got["joins"]["joined_rows"] > 0, "joins joined no rows")
    layers = got["trace"]["layers"]
    traced = {e["cat"] for e in json.loads(
        (root / "trace.json").read_text())["traceEvents"] if e["ph"] == "X"}
    check(len(layers) >= 4 and "compile" in layers
          and set(layers) <= traced, f"trace layers {layers}")
    recovered = got["recover"]
    check(recovered["identical"] is True and recovered["recovery"][
        "vitals.stream"]["rows_replayed"] > 0, f"recover {recovered}")
    check(got["serve"]["delivered_per_tenant"] == [8] * 4,
          f"serve delivered {got['serve']['delivered_per_tenant']}")
    check(got["ml"]["delivered_to_tenant0"] > 0
          and all(np.isfinite(got["ml"]["abp_scores"])), "ml scores")
    text = outputs["metrics"]
    check("repro_stream_tick_seconds" in text and "repro_serve_" in text,
          "metrics lacks the tick or serve series")
    emit({"phase": "admin", "seconds": seconds, "layers": layers,
          "trace_spans": got["trace"]["spans"],
          "recover": {k: recovered[k] for k in ("identical", "rows")},
          "rows_replayed": recovered["recovery"]["vitals.stream"][
              "rows_replayed"],
          "serve": got["serve"]["serve"],
          "rebalance_moves": got["rebalance"]["rebalance"]["moves"],
          "metrics_lines": text.count("\n")})
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here / "src"))
    runs = {}
    for name, argv in (("admin_status", ["-m", "repro_torch.core.admin",
                                         "status"]),
                       ("quickstart_torch", [str(here / "examples"
                                                 / "quickstart_torch.py")])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=root, env=env,
                              capture_output=True, text=True, timeout=600)
        runs[name] = {"rc": proc.returncode,
                      "wall_s": time.perf_counter() - t0}
        check(proc.returncode == 0,
              f"{name} exited {proc.returncode}: {proc.stderr[-2000:]}")
    check("-- catalog" in proc.stdout, "the quickstart twin printed no catalog")
    emit({"phase": "admin", "processes": runs, "checks": "passed"})
    return {"seconds": seconds, "processes": runs}


# -- 6. flash attention against its plain version ----------------------------------
def _qkv(b, s, t, hq, hkv, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype)
        for shape in ((b, s, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh))]


def _qkv_wide(b, s, t, hq, hkv, dh, dtype, seed):
    """q and k integer-valued in [-30, 30], v standard normal.  Every q.k
    is an integer below 2**24, so the kernel's scores and the plain
    version's are the same float32 numbers, and the scaled scores have a
    standard deviation of ~300: each softmax row is near one-hot."""
    rng = np.random.default_rng(seed)
    arrays = (rng.integers(-30, 31, (b, s, hq, dh)),
              rng.integers(-30, 31, (b, t, hkv, dh)),
              rng.standard_normal((b, t, hkv, dh)))
    return [torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)
            for x in arrays]


def flash_parity() -> dict:
    """Each case through its route's kernel (checked by the route's launch
    count) against the plain version; the worst |err| of each route."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ref
    b, s, hq, hkv, dh = SERVE_SHAPE
    cases = [((bb, ss, ss, h, hk, d), dt, True)
             for bb, ss, h, hk, d in [(1, 128, 4, 4, 64), (2, 256, 4, 2, 64),
                                      (1, 512, 8, 2, 128), (2, 128, 6, 3, 32),
                                      (1, 384, 2, 1, 128)]
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((b, s, s, hq, hkv, dh), torch.float32, True),
              ((b, s, s, hq, hkv, dh), torch.bfloat16, True),
              ((1, 1000, 1000, hq, hkv, dh), torch.float32, True),
              ((1, 1000, 1000, hq, hkv, dh), torch.bfloat16, True),
              ((1, 128, 128, 2, 2, 64), torch.float32, False),
              ((b, s, s, hq, hkv, dh), torch.bfloat16, False)]
    # S off the tile grid: one row, one short of and one past half a
    # 128-row tile; two tiles of the serve shape's width; Jamba's 32/8
    cases += [((2, ss, ss, hq, hkv, d), dt, True)
              for ss, d in ((1, 128), (63, 128), (65, 64), (2048, 128))
              for dt in (torch.float32, torch.bfloat16)]
    cases += [((2, 256, 256, 32, 8, dh), dt, causal)
              for dt in (torch.float32, torch.bfloat16)
              for causal in (True, False)]
    cases = [c + (False,) for c in cases]
    cases += [((b, s, s, hq, hkv, dh), dt, causal, True)
              for dt in (torch.float32, torch.bfloat16)
              for causal in (True, False)]
    cases += [((1, 1000, 1000, hq, hkv, dh), dt, True, True)
              for dt in (torch.float32, torch.bfloat16)]
    worst = {fk.TENSOR_CORE: 0.0, fk.CUDA_CORE: 0.0}
    for i, (shape, dtype, causal, wide) in enumerate(cases):
        q, k, v = (_qkv_wide if wide else _qkv)(*shape, dtype, 60 + i)
        which = fk.route(dtype, shape[-1])
        before = _route_counts()
        got = fk.flash_attention_4d(q, k, v, causal)
        want = ref.gqa_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        after = _route_counts()
        check(after[which] == before[which] + 1 and
              sum(after.values()) == sum(before.values()) + 1,
              f"flash_attention at {shape} {dtype} did not take the "
              f"{which} route: {before} -> {after}")
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dtype]
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"flash_attention ({which}) differs from the plain version "
              f"at {shape} {dtype} causal={causal} wide={wide}: max |err| "
              f"{err}")
        worst[which] = max(worst[which], err)
        emit({"phase": "parity", "kernel": "flash_attention",
              "route": which, "case": list(shape), "dtype": str(dtype),
              "causal": causal, "scores": "std~300" if wide else "unit",
              "max_abs_err": err, "tol": tol})
    return worst


def _route_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fk
    return {fk.TENSOR_CORE: fk.tensor_core_launches,
            fk.CUDA_CORE: fk.cuda_core_launches}


# -- 7. the scans against their plain versions ---------------------------------------
EDGE_DECAYS = (0.0, 1e-30, 1.0 - 1e-7, 1.0)
DECAYS = ("full_width", "near_1", "near_0", "edges")


def _wkv_inputs(b, s, h, d, decays, seed, carried=True):
    """r, k, v standard normal; decays uniform in [0.85, 0.999] (the
    sweep's), as RWKV6-7B's initializer gives them at full width
    (exp(-exp(0.63 z)): down to ~1e-8, where the TPU kernel's chunked form
    underflows), near 1, near 0, or drawn from the edges 0, 1e-30,
    1 - 1e-7 and 1."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, s, h, d)
    r, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    z = torch.rand(shape, generator=gen, device="cuda")
    w = {"sweep": lambda: 0.85 + 0.149 * z,
         "full_width": lambda: torch.exp(-torch.exp(0.63 * torch.randn(
             shape, generator=gen, device="cuda"))),
         "near_1": lambda: 1.0 - 1e-4 * z,
         "near_0": lambda: 1e-6 * z,
         "edges": lambda: torch.tensor(EDGE_DECAYS, device="cuda")[
             (4 * z).long().clamp(max=3)]}[decays]()
    u = torch.randn((h, d), generator=gen, device="cuda")
    s0 = (0.3 * torch.randn((b, h, d, d), generator=gen, device="cuda")
          if carried else None)
    return r, k, v, w, u, s0


def _scan_inputs(b, s, di, n, dtype, seed, carried=True, decays="sweep"):
    """u standard normal; dt uniform in [0.001, 0.1] with A in [-2, -0.5]
    (the sweep's); A = -1 (a_log at the reference's initializer) with
    dt = softplus(z) (the model's, at full width) or dt below 1e-4
    (decays near 1); dt in [0.05, 0.1] with A in [-300, -200] (decays
    e^-10 to e^-30); or the edges, dt drawn from 0, 1e-7 and 0.1 and A
    cycling over the states through -1, -690.8, -1e30 and -1 (decays of
    1, 1 - 1e-7, ~1e-30 and exactly 0), where dt stays small and y near
    unit scale; or the same edges reached through a large dt, drawn from
    0, 1e-7, 69.08 and 200 with A = -1, where h grows to ~200 and y to
    ~10^4, sums of terms that may cancel.  The inputs are cast to
    ``dtype``, h0 float32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((b, s, di), generator=gen, device="cuda").to(dtype)
    z = torch.rand((b, s, di), generator=gen, device="cuda")
    dt = {"sweep": lambda: 0.001 + 0.099 * z,
          "full_width": lambda: torch.nn.functional.softplus(torch.randn(
              (b, s, di), generator=gen, device="cuda")),
          "near_1": lambda: 1e-4 * z,
          "near_0": lambda: 0.05 + 0.05 * z,
          "edges": lambda: torch.tensor((0.0, 1e-7, 0.1), device="cuda")[
              (3 * z).long().clamp(max=2)],
          "large_dt": lambda: torch.tensor(
              (0.0, 1e-7, 69.0776, 200.0), device="cuda")[
              (4 * z).long().clamp(max=3)]}[decays]().to(dtype)
    za = torch.rand((di, n), generator=gen, device="cuda")
    a = {"sweep": lambda: -(0.5 + 1.5 * za),
         "near_0": lambda: -(200.0 + 100.0 * za),
         "edges": lambda: torch.tensor(
             (-1.0, -690.7755, -1e30, -1.0), device="cuda")[
             torch.arange(n, device="cuda") % 4].expand(di, n).contiguous(),
         }.get(decays, lambda: -torch.ones((di, n), device="cuda"))()
    bb, c = (torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    h0 = (0.2 * torch.randn((b, di, n), generator=gen, device="cuda")
          if carried else None)
    return u, dt, a, bb, c, h0


def _double(*xs):
    return [None if x is None else x.double() for x in xs]


def _wkv_routes() -> dict:
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    return {wk.CHUNKED: wk.chunked_launches,
            wk.PER_TOKEN: wk.per_token_launches}


def _wkv_on_its_route(r, k, v, w, u, s0):
    """One launch of wkv6_4d, checked to have gone through the kernel that
    its S routes it to and no other."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    which = wk.route(r.shape[1])
    before = _wkv_routes()
    out = wk.wkv6_4d(r, k, v, w, u, s0)
    after = _wkv_routes()
    check(after[which] == before[which] + 1
          and sum(after.values()) == sum(before.values()) + 1,
          f"rwkv6_scan at S {r.shape[1]} did not take its route {which}: "
          f"{before} -> {after}")
    return which, out


def scan_parity() -> dict:
    """Each scan against its plain version evaluated in float64 on the
    same inputs.  rwkv6_scan through both routes, each checked by its
    route counter: the per-token route at S = 1 and 15, the chunked one
    at the shapes of tests/test_kernels.py, a ragged S of 1,000 and the
    serve shape; decays at full width, near 1, near 0 and at the edges
    (0, 1e-30, 1 - 1e-7, 1), carried and not (the serve shape at full
    width and at the edges).  mamba_scan at the shapes of
    tests/test_kernels.py, S = 1, ragged S, Di off the block grid, N < 16
    (both off the 16-byte grid, which the kernel stages by plain loads),
    its decay regimes and the serve shape in bf16 and f32.  Tolerances of
    tests/test_kernels.py (5e-4, 5e-5); a bf16 y is held to one bf16
    rounding of the exact y; at a large dt both add what float32 can give
    (``_large_dt_witness``).  Near-1 decays sum ~1,000 undecayed outer
    products into outputs of magnitude ~1,000, and float32 rounding of
    such sums reaches ~1e-3 whatever their order (the plain version's own
    float32 result, printed beside the kernel's, is as far from the exact
    one): that case is held to 5e-4 of its largest |value|."""
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.mamba_scan import ref as mref
    from repro_torch.kernels.rwkv6_scan import ref as wref
    err = {"rwkv6_scan": 0.0, "mamba_scan": 0.0, "mamba_scan_bf16": 0.0,
           "mamba_scan_large_dt": 0.0, "mamba_scan_bf16_large_dt": 0.0}
    tol = SCAN_TOL["rwkv6_scan"]
    b, s, h, d = WKV_SHAPE
    wkv_cases = [((bb, ss, hh, dd), "sweep", carried)
                 for bb, ss, hh, dd in [(1, 64, 1, 16), (2, 128, 2, 32),
                                        (1, 256, 4, 64), (2, 96, 2, 32)]
                 for carried in (True, False)]
    wkv_cases += [(shape, decays, carried)
                  for shape in [(b, 1, h, d), (2, 15, h, d), (2, 1000, h, d)]
                  for decays in DECAYS for carried in (True, False)]
    wkv_cases += [((b, s, h, d), decays, carried)
                  for decays in ("full_width", "edges")
                  for carried in (False, True)]
    wkv_cases += [((2, s, h, d), decays, True)
                  for decays in ("near_1", "near_0")]
    routes = {}
    for i, (shape, decays, carried) in enumerate(wkv_cases):
        r, k, v, w, u, s0 = _wkv_inputs(*shape, decays, 70 + i, carried)
        s_init = s0 if carried else torch.zeros(
            (shape[0], shape[2], shape[3], shape[3]), device="cuda")
        which, (y, sf) = _wkv_on_its_route(r, k, v, w, u, s0)
        routes[which] = routes.get(which, 0) + 1
        want_y, want_s = wref.wkv6(*_double(r, k, v, w, u, s_init))
        plain_y, _ = wref.wkv6(r, k, v, w, u, s_init)
        y, sf = y.double(), sf.double()
        torch.cuda.synchronize()
        e = max(float((y - want_y).abs().max()),
                float((sf - want_s).abs().max()))
        atol = tol * (float(want_y.abs().max()) if decays == "near_1"
                      else 1.0)
        check(bool(torch.isfinite(y).all() and torch.isfinite(sf).all())
              and torch.allclose(y, want_y, atol=atol, rtol=tol)
              and torch.allclose(sf, want_s, atol=atol, rtol=tol),
              f"rwkv6_scan differs from the plain version at {shape} "
              f"{decays} carried={carried} ({which}): max |err| {e}")
        err["rwkv6_scan"] = max(err["rwkv6_scan"], e)
        emit({"phase": "parity", "kernel": "rwkv6_scan", "route": which,
              "case": list(shape), "decays": decays,
              "w_min": float(w.min()), "carried": carried,
              "max_abs_err": e, "atol": atol, "rtol": tol,
              "plain_f32_max_abs_err": float(
                  (plain_y.double() - want_y).abs().max())})
        del r, k, v, w, y, sf, want_y, want_s, plain_y
    check(set(routes) == set(_wkv_routes()),
          f"rwkv6_scan parity missed a route: {routes}")
    err["rwkv6_scan_routes"] = routes

    tol = SCAN_TOL["mamba_scan"]
    b, s, di, n = SCAN_SHAPE
    f32, bf16 = torch.float32, torch.bfloat16
    scan_cases = [((bb, ss, dd, nn), f32, carried, "sweep")
                  for bb, ss, dd, nn in [(1, 64, 64, 8), (2, 128, 128, 16),
                                         (1, 96, 256, 16)]
                  for carried in (True, False)]
    scan_cases += [((2, 1000, di, n), dt, True, "sweep") for dt in (f32, bf16)]
    scan_cases += [((b, 1, di, n), bf16, True, "sweep"),
                   ((2, 65, 200, 5), bf16, True, "sweep"),
                   ((1, 33, 300, 8), f32, False, "sweep"),
                   ((2, 40, 1000, 16), bf16, True, "sweep")]
    scan_cases += [((2, 200, di, n), bf16, carried, decays)
                   for decays in DECAYS for carried in (True, False)]
    scan_cases += [((b, s, di, n), dt, True, "sweep") for dt in (bf16, f32)]
    scan_cases += [((2, 200, di, n), dt, carried, "large_dt")
                   for dt in (f32, bf16) for carried in (True, False)]
    for i, (shape, dtype, carried, decays) in enumerate(scan_cases):
        u, dt, a, bb, c, h0 = _scan_inputs(*shape, dtype, 90 + i, carried,
                                           decays)
        h_init = h0 if carried else torch.zeros(
            (shape[0], shape[2], shape[3]), device="cuda")
        y, hf = mk.selective_scan_3d(u, dt, a, bb, c, h0)
        check(y.dtype == dtype, f"mamba_scan: y in {y.dtype}, not {dtype}")
        exact_y, want_h = mref.selective_scan(*_double(u, dt, a, bb, c,
                                                       h_init))
        torch.cuda.synchronize()
        # a bf16 y against the exact y rounded to bf16
        want_y = exact_y.to(dtype).double()
        y, hf = y.double(), hf.double()
        e = max(float((y - want_y).abs().max()),
                float((hf - want_h).abs().max()))
        rtol = tol if dtype == f32 else 2 ** -7
        row = {"phase": "parity", "kernel": "mamba_scan",
               "case": list(shape), "dtype": str(dtype), "carried": carried,
               "decays": decays, "max_abs_err": e, "tol": tol,
               "y_rtol": rtol}
        y_tol = tol + rtol * want_y.abs()
        h_tol = tol + tol * want_h.abs()
        if decays == "large_dt":
            y_tol, h_tol, witness = _large_dt_witness(
                (u, dt, a, bb, c, h_init), exact_y, want_h, y, want_y,
                y_tol, h_tol, (1 + rtol) if dtype == bf16 else 1.0)
            row.update(witness)
        check(bool(torch.isfinite(y).all() and torch.isfinite(hf).all())
              and bool(((y - want_y).abs() <= y_tol).all())
              and bool(((hf - want_h).abs() <= h_tol).all()),
              f"mamba_scan differs from the plain version at {shape} "
              f"{dtype} carried={carried} {decays}: max |err| {e}")
        # the large-dt cases, held to a wider bound, apart
        key = ("mamba_scan" if dtype == f32 else "mamba_scan_bf16") + (
            "_large_dt" if decays == "large_dt" else "")
        err[key] = max(err[key], e)
        emit(row)
        del u, dt, bb, c, y, hf, want_y, want_h, exact_y
    return err


def _large_dt_witness(x, exact_y, exact_h, y, want_y, y_tol, h_tol,
                      widen: float):
    """At a large dt, y is a float32 sum of terms up to ~10^4 times its
    size, and no float32 evaluation meets 5e-5 everywhere.  The kernel
    and the plain float32 scans (exp, and exp2 as the kernel takes it)
    are each held to the tolerance plus ``ref.float32_error_bound`` (for
    a bf16 y, widened by one bf16 rounding of it).  The witness: how many
    outputs of each leave the plain tolerance, each one's largest error
    where the kernel's does, and each one's largest error over the bound
    (the kernel's in float32 only: a bf16 y's rounding is not in the
    bound).  Returns the widened tolerances of y and h and the witness."""
    from repro_torch.kernels.mamba_scan import ref as mref
    bound_y, bound_h = mref.float32_error_bound(*x)
    outside = (y - want_y).abs() > y_tol
    witness = {"kernel_y_outside_plain_tol": int(outside.sum())}
    if widen == 1.0:
        witness["kernel_err_over_bound"] = float(
            ((y - exact_y).abs() / bound_y).nan_to_num(nan=0.0).max())
    tol = SCAN_TOL["mamba_scan"]
    for name, scan in (("plain_f32", mref.selective_scan),
                       ("plain_f32_exp2", mref.selective_scan_exp2)):
        py, ph = (v.double() for v in scan(*x))
        ey = (py - exact_y).abs()
        plain_tol = tol + tol * exact_y.abs()
        check(bool((ey <= plain_tol + bound_y).all())
              and bool(((ph - exact_h).abs() <= h_tol + bound_h).all()),
              f"{name} leaves the float32 bound at a large dt")
        witness[f"{name}_max_abs_err"] = float(ey.max())
        witness[f"{name}_err_over_bound"] = float(
            (ey / bound_y).nan_to_num(nan=0.0).max())
        witness[f"{name}_y_outside_plain_tol"] = int((ey > plain_tol).sum())
        if outside.any():
            witness[f"{name}_err_where_kernel_outside"] = float(
                ey[outside].max())
    if outside.any():
        witness["kernel_err_where_outside"] = float(
            (y - want_y).abs()[outside].max())
    return y_tol + widen * bound_y, h_tol + bound_h, witness


# -- 7. serving Qwen2-1.5B at full width --------------------------------------------
def _serve_prompts(vocab: int = 151936):
    """Wave A: eight 1,024-token prompts (numpy seed 0); wave B: eight of
    600 to 1,000 tokens (seed 1), the longest 1,000, off the 128 grid."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(SEED)
    a = [rng.integers(0, vocab, WAVE_A_LEN).astype(np.int32)
         for _ in range(SERVE["max_batch"])]
    rng = np.random.default_rng(SEED + 1)
    lens = list(rng.integers(WAVE_B_LENS[0], WAVE_B_LENS[1],
                             SERVE["max_batch"] - 1)) + [WAVE_B_LENS[1]]
    bw = [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]
    wave = lambda ps, r0: [Request(r0 + i, p, SERVE["max_new_tokens"])  # noqa: E731
                           for i, p in enumerate(ps)]
    return wave(a, 0), wave(bw, len(a))


def _padded(requests) -> np.ndarray:
    plen = max(len(r.prompt) for r in requests)
    out = np.zeros((len(requests), plen), np.int32)
    for i, r in enumerate(requests):
        out[i, -len(r.prompt):] = r.prompt
    return out


def _rel(want: torch.Tensor, got: torch.Tensor) -> float:
    return float((want - got).abs().max() / want.abs().max())


def _rel_rows(want: torch.Tensor, got: torch.Tensor) -> list:
    """Each row's (batch entry's) max |diff| over the largest |logit|."""
    diff = (want - got).abs().reshape(want.shape[0], -1).amax(-1)
    return (diff / want.abs().max()).tolist()


def _decode_and_forward(session, wave, completions):
    """(a full forward's last logits, the session's last decode step's)
    over the padded prompts and the tokens generated before that step."""
    from repro_torch.models import registry
    toks = np.stack([c.tokens for c in completions])
    prompts = _padded(wave)
    seq = np.concatenate([prompts, toks[:, :-1]], axis=1)
    batch = session.frontend_batch(prompts)   # the stub frontend's inputs
    batch["tokens"] = torch.from_numpy(seq).cuda()
    logits, _ = registry.forward(session.params, batch, session.cfg)
    check(bool(torch.isfinite(logits).all()), "forward: non-finite logits")
    return logits[:, -1], session.last_logits


def _decode_vs_forward(session, wave, completions) -> float:
    """The session's last decode step against a full forward over the
    padded prompts and the tokens generated before it."""
    return _rel(*_decode_and_forward(session, wave, completions))


def _draw_params(cfg):
    from repro_torch.models import registry
    from repro_torch.sharding import logical as L
    return L.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                         registry.param_specs(cfg), "cuda")


def _unit_scale_attention(params, sub: str = "sub0") -> None:
    """``_unit_scale`` of the stacked attention mixer ``sub``."""
    _unit_scale(params["blocks"][sub]["mixer"])


def _unit_scale(m) -> None:
    """Rescale a stack of attention projections ``m``, in place, to the
    fan-in of the dimensions they contract.  The reference's ``_init_one`` takes the
    fan-in from a weight's second-to-last dimension, which for the
    (d_model, heads, head_dim) projections is the head count (12 or 2),
    not the 1,536 inputs they sum over: at full width q.k scores come out
    with a standard deviation of ~300, every softmax saturates, and the
    bf16 rounding of the scores (the plain path computes them in bf16)
    decides which key wins, so the two attention paths part by more than
    any logit bound.  After this, scores have unit scale, as in a trained
    model; the flash parity phase holds the kernel at the saturated
    scale."""
    for name in ("wq", "wk", "wv"):                  # (L, d, heads, dh)
        m[name] *= (m[name].shape[-2] / m[name].shape[1]) ** 0.5
    wo = m["wo"]                                     # (L, heads, dh, d)
    wo *= (wo.shape[-2] / (wo.shape[1] * wo.shape[2])) ** 0.5


def _flash_vs_plain_rows(session, prompts) -> list:
    """Last-token prefill logits of the flash session (its kernels)
    against the same params through the plain path (plain attention and
    the plain scans), max |diff| / max |logit| for each row."""
    from repro_torch.serve.engine import ServeSession
    flash = session.prefill(prompts)[0][:, -1]
    plain_cfg = dataclasses.replace(session.cfg, attn_impl="reference")
    plain = ServeSession(plain_cfg, session.params,
                         session.scfg).prefill(prompts)[0][:, -1]
    check(bool(torch.isfinite(flash).all() and torch.isfinite(plain).all()),
          "prefill: non-finite logits")
    return _rel_rows(plain, flash)


def serve_phase() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.models import registry
    from repro_torch.serve.engine import (Request, Scheduler, ServeConfig,
                                          ServeSession)
    from repro_torch._tree import tree_leaves
    cfg = registry.get_config("qwen2-1.5b", attn_impl="flash")
    check((cfg.num_layers, cfg.d_model, cfg.vocab_size) == (28, 1536, 151936),
          f"not the published width: {cfg}")
    wave_a, wave_b = _serve_prompts()
    prompts_a = _padded(wave_a)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _draw_params(cfg)
    _unit_scale_attention(params)
    check(all(t.dtype == torch.float32 and t.is_cuda
              for t in tree_leaves(params)), "params: f32 on the card")
    n_params = sum(t.numel() for t in tree_leaves(params))
    session = ServeSession(cfg, params, ServeConfig(**SERVE))
    del params                      # the session holds what it reads
    torch.cuda.synchronize()
    emit({"phase": "serve", "step": "load", "params": n_params,
          "param_bytes_f32": 4 * n_params,
          "seconds": time.perf_counter() - t0})
    # one short wave first: cuBLAS handles and the kernel's first launch
    session.run_wave([Request(100 + i, r.prompt[:128], 2)
                      for i, r in enumerate(wave_a)])

    def schedule(waves):
        sched = Scheduler(session)
        for wave in waves:
            for r in wave:
                sched.submit(r)
        return sched.run()

    fk.reset_launch_count()                   # the serve path starts here
    done = schedule([wave_a, wave_b])
    torch.cuda.synchronize()
    launches = fk.launches                    # ... and ends here
    routes = _route_counts()
    n = SERVE["max_batch"]
    done_a, done_b = done[:n], done[n:]
    rel_b = _decode_vs_forward(session, wave_b, done_b)
    again = schedule([wave_a])
    torch.cuda.synchronize()
    rel_a = _decode_vs_forward(session, wave_a, again)
    repeat = all(np.array_equal(x.tokens, y.tokens)
                 for x, y in zip(done_a, again))
    rel_prefill = max(_flash_vs_plain_rows(session, prompts_a))
    logits, cache, extras, pos0 = session.prefill(prompts_a)
    tok = logits[:, -1].argmax(-1).int().cpu().numpy()
    decode_card = _device_times(
        lambda: session.decode(tok, cache, pos0, extras))
    decode_card["busy_share"] = decode_card["device_us"] / decode_card[
        "wall_us"]
    del logits, cache
    torch.cuda.synchronize()
    waves = {}
    for name, comps, wave in (("A", done_a, wave_a), ("B", done_b, wave_b)):
        c = comps[0]
        new = SERVE["max_new_tokens"] - 1
        plen = int(_padded(wave).shape[1])
        waves[name] = {"prompt_len": plen,
                       "prefill_s": c.prefill_seconds,
                       "decode_s": c.decode_seconds,
                       "decode_steps": new,
                       "decode_tokens_per_s": n * new / c.decode_seconds,
                       "prefill_tokens_per_s": n * plen / c.prefill_seconds}
    waves["A_again"] = {"prefill_s": again[0].prefill_seconds,
                        "decode_s": again[0].decode_seconds}
    emit({"phase": "serve", "model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "serve_config": SERVE, "waves": waves,
          "flash_launches": launches, "flash_launches_by_route": routes,
          "flash_prefills": 2,
          "prefill_flash_vs_plain_rel": rel_prefill,
          "decode_vs_forward_rel": {"A": rel_a, "B": rel_b},
          "wave_a_repeatable": repeat,
          "decode_step_card": decode_card,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    check(launches == cfg.num_layers * 2,
          f"flash launches {launches} != 28 x 2 prefills")
    check(routes[fk.TENSOR_CORE] == launches,
          f"flash launches off the tensor-core route: {routes}")
    check(rel_prefill <= LOGIT_TOL,
          f"flash prefill vs plain attention: {rel_prefill}")
    check(rel_a <= LOGIT_TOL and rel_b <= LOGIT_TOL,
          f"decode vs forward: {rel_a}, {rel_b}")
    check(repeat, "wave A is not bitwise repeatable")
    check(bool(torch.isfinite(session.last_logits).all()),
          "non-finite logits")
    check(all(c.tokens.shape == (SERVE["max_new_tokens"],) for c in done),
          "completions: wrong token counts")
    emit({"phase": "serve", "checks": "passed"})
    return {"launches": launches,
            "prefill_s": {w: waves[w]["prefill_s"] for w in ("A", "B")}}


# -- 8b. serving seamless-m4t-medium at full width ---------------------------------
SEAMLESS_SHAPE = (8, WAVE_A_LEN, 16, 16, 64)   # B, S, Hq, Hkv, Dh


def serve_seamless_phase() -> dict:
    """seamless-m4t-medium (the encoder-decoder) at its published width,
    attn_impl="flash", float32 params drawn on the card from seed 0 with
    every attention block (the encoder's, the decoder's self- and
    cross-attention) at its true fan-in, served through ``Scheduler`` as
    phase 8 serves Qwen2 (waves A and B, 32 new tokens, the stub audio
    frontend's zero frames): the decoder's causal self-attention through
    the flash kernel's tensor-core route, 12 launches a prefill; the
    prefill against the plain path and the last decode step against a
    full forward through the plain path (the attention decode runs), 5e-2
    of the largest logit, row by row; prefill and decode seconds, decode
    tokens/s and peak device memory for each wave (and, apart, the
    checks' peak)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.models import registry
    from repro_torch.serve.engine import (Request, Scheduler, ServeConfig,
                                          ServeSession)
    cfg = registry.get_config("seamless-m4t-medium", attn_impl="flash")
    check((cfg.encoder_layers, cfg.num_layers, cfg.d_model, cfg.num_heads,
           cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size)
          == (12, 12, 1024, 16, 16, 64, 4096, 256206),
          f"not the published width: {cfg}")
    wave_a, wave_b = _serve_prompts(cfg.vocab_size)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _draw_params(cfg)
    for m in (params["enc_blocks"]["attn"], params["dec_blocks"]["self_attn"],
              params["dec_blocks"]["cross_attn"]):
        _unit_scale(m)
    n_params = sum(t.numel() for t in tree_leaves(params))
    session = ServeSession(cfg, params, ServeConfig(**SERVE))
    del params
    torch.cuda.synchronize()
    emit({"phase": "serve", "model": cfg.name, "step": "load",
          "params": n_params, "param_bytes_f32": 4 * n_params,
          "seconds": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated()})
    session.run_wave([Request(100 + i, r.prompt[:128], 2)
                      for i, r in enumerate(wave_a)])

    fk.reset_launch_count()                   # the serve path starts here
    done, peaks = [], {}
    for name, wave in (("A", wave_a), ("B", wave_b)):
        torch.cuda.reset_peak_memory_stats()
        sched = Scheduler(session)
        for r in wave:
            sched.submit(r)
        done += sched.run()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
    launches = fk.launches                    # ... and ends here
    routes = _route_counts()
    n = SERVE["max_batch"]
    last_logits = session.last_logits
    torch.cuda.reset_peak_memory_stats()
    plain = ServeSession(dataclasses.replace(cfg, attn_impl="reference"),
                         session.params, session.scfg)
    plain.last_logits = last_logits
    rel_decode = _rel_rows(*_decode_and_forward(plain, wave_b, done[n:]))
    del plain
    torch.cuda.empty_cache()
    rel_prefill = _flash_vs_plain_rows(session, _padded(wave_a))
    torch.cuda.synchronize()
    stats = {}
    for name, comps, wave in (("A", done[:n], wave_a),
                              ("B", done[n:], wave_b)):
        c = comps[0]
        steps = SERVE["max_new_tokens"] - 1
        plen = int(_padded(wave).shape[1])
        stats[name] = {"prompt_len": plen,
                       "frames": max(1, plen // cfg.src_ratio),
                       "max_memory_allocated": peaks[name],
                       "prefill_s": c.prefill_seconds,
                       "decode_s": c.decode_seconds, "decode_steps": steps,
                       "decode_tokens_per_s": n * steps / c.decode_seconds,
                       "prefill_tokens_per_s": n * plen / c.prefill_seconds}
    emit({"phase": "serve", "model": cfg.name,
          "encoder_layers": cfg.encoder_layers,
          "decoder_layers": cfg.num_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "params": n_params,
          "serve_config": SERVE, "waves": stats,
          "flash_launches": launches, "flash_launches_by_route": routes,
          "flash_prefills": 2,
          "prefill_flash_vs_plain_rel_by_row": rel_prefill,
          "decode_vs_forward_rel_by_row": rel_decode,
          "checks_max_memory_allocated": torch.cuda.max_memory_allocated()})
    check(launches == cfg.num_layers * 2,
          f"flash launches {launches} != 12 x 2 prefills")
    check(routes[fk.TENSOR_CORE] == launches,
          f"flash launches off the tensor-core route: {routes}")
    check(max(rel_prefill) <= LOGIT_TOL,
          f"{cfg.name}: flash prefill vs plain {rel_prefill}")
    check(max(rel_decode) <= LOGIT_TOL,
          f"{cfg.name}: decode vs forward {rel_decode}")
    check(bool(torch.isfinite(last_logits).all()), "non-finite logits")
    check(all(c.tokens.shape == (SERVE["max_new_tokens"],) for c in done),
          "completions: wrong token counts")
    emit({"phase": "serve", "model": cfg.name, "checks": "passed"})
    return {"launches": launches,
            "prefill_s": {k: v["prefill_s"] for k, v in stats.items()}}


# -- 9. serving RWKV6-7B and Jamba at full width ------------------------------------
def _float32_mask(tree, under: bool = False):
    """The tree's shape, True at each leaf ``place_params`` keeps in
    float32 (one under a name in ``lm.FLOAT32_LEAVES``)."""
    from repro_torch.models import lm
    if isinstance(tree, dict):
        return {k: _float32_mask(v, under or k in lm.FLOAT32_LEAVES)
                for k, v in tree.items()}
    return under


def _draw_placed(cfg):
    """The params of ``cfg`` as ``ServeSession`` holds them, drawn on the
    card from seed 0 leaf by leaf, in ``init_params``' order and with its
    numbers, each float32 draw cast at once to the compute dtype unless
    the model reads it in float32: one float32 leaf is alive at a time
    (Jamba's 13.3 B float32 params would not fit beside their bf16
    copy)."""
    from repro_torch import _tree
    from repro_torch.models import lm, registry
    from repro_torch.sharding import logical as L
    specs = registry.param_specs(cfg)
    leaves, treedef = _tree.tree_flatten(specs)
    keep = _tree.tree_leaves(_float32_mask(specs))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    placed = []
    for spec, f32 in zip(leaves, keep):
        t = L.init_params(gen, spec, "cuda")
        placed.append(t if f32 else t.to(lm.COMPUTE_DTYPE))
        del t
    return _tree.tree_unflatten(treedef, placed), sum(
        spec.num_params() for spec in leaves)


def _family_prompts(vocab: int, ragged: bool):
    """Wave A: eight 1,024-token prompts (numpy seed 0); with ``ragged``
    also wave B: eight of 600 to 1,000 tokens (seed 1) left-padded to
    1,000, as phase 8's waves."""
    from repro_torch.serve.engine import Request
    n, new = FAMILY_SERVE["max_batch"], FAMILY_SERVE["max_new_tokens"]
    rng = np.random.default_rng(SEED)
    waves = [[Request(i, rng.integers(0, vocab, WAVE_A_LEN).astype(np.int32),
                      new) for i in range(n)]]
    if ragged:
        rng = np.random.default_rng(SEED + 1)
        lens = list(rng.integers(WAVE_B_LENS[0], WAVE_B_LENS[1], n - 1)) + [
            WAVE_B_LENS[1]]
        waves.append([Request(n + i, rng.integers(0, vocab, int(m)).astype(
            np.int32), new) for i, m in enumerate(lens)])
    return waves


def _calm_weights(params) -> None:
    """Adjust the drawn params of the recurrent families in place, so
    that the logit checks measure the kernels and not the random model:
    - each recurrent mixer's output projection (RWKV6's time-mix ``wo``,
      Mamba's ``out_proj``) at a tenth.  With every projection at unit
      scale (the reference's initializer) the random model is chaotic at
      full width: differences at the level of float32 rounding in a scan
      grow from layer to layer until two paths' logits decorrelate.  The
      real RWKV6 initializer zeroes that projection;
    - every MoE router at zero: all experts tie and each token takes
      experts 0 and 1 (ties fall to the lower index in both paths), so a
      router near-tie cannot route a token otherwise on one path than on
      the other (routing is held to the reference on the CPU);
    - the attention projections at their true fan-in
      (``_unit_scale_attention``)."""
    for sub, p in params["blocks"].items():
        mixer, ffn = p["mixer"], p["ffn"]
        if "w_lora_a" in mixer:
            mixer["wo"] *= 0.1
        if "out_proj" in mixer:
            mixer["out_proj"] *= 0.1
        if "wq" in mixer:
            _unit_scale_attention(params, sub)
        if "router" in ffn:
            ffn["router"].zero_()


def _reset_model_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    for m in (fk, wk, mk):
        m.reset_launch_count()


def _model_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    return {"flash_attention": fk.launches,
            "flash_attention_tensor_core": fk.tensor_core_launches,
            "rwkv6_scan": wk.launches,
            "rwkv6_scan_chunked": wk.chunked_launches,
            "rwkv6_scan_per_token": wk.per_token_launches,
            "mamba_scan": mk.launches,
            "mamba_scan_prefill": mk.prefill_launches,
            "mamba_scan_decode": mk.decode_launches}


def family_serve_phase(arch: str, ragged: bool, must_launch,
                       **overrides) -> dict:
    """``arch`` at its published width (``overrides`` cut its depth only)
    with ``attn_impl="flash"``, its drawn params adjusted by
    ``_calm_weights``, served through ``Scheduler``: the waves of
    ``_family_prompts``, 16 new tokens each.  Checks the prefill through
    the kernels against the plain path's prefill (the plain scans and
    attention) and the last decode step against a full forward through
    the plain path (whose attention is the one decode runs), each within
    5e-2 of the largest logit, every logit finite, and each count of
    ``must_launch`` (a kernel, or a kernel's route) above 0 on this path;
    returns the path's launch counts and each wave's prefill seconds."""
    from repro_torch.models import registry
    from repro_torch.serve.engine import (Request, Scheduler, ServeConfig,
                                          ServeSession)
    cfg = registry.get_config(arch, attn_impl="flash", **overrides)
    waves = _family_prompts(cfg.vocab_size, ragged)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, n_params = _draw_placed(cfg)
    _calm_weights(params)
    session = ServeSession(cfg, params, ServeConfig(**FAMILY_SERVE))
    del params
    torch.cuda.synchronize()
    emit({"phase": "serve", "model": cfg.name, "step": "load",
          "params": n_params, "seconds": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated()})
    # one short wave first: cuBLAS handles and the kernels' first launches
    session.run_wave([Request(100 + i, r.prompt[:128], 2)
                      for i, r in enumerate(waves[0])])

    _reset_model_counts()                     # this serve path starts here
    sched = Scheduler(session)
    for wave in waves:
        for r in wave:
            sched.submit(r)
    done = sched.run()
    torch.cuda.synchronize()
    launches = _model_counts()                # ... and ends here
    last_logits = session.last_logits
    n = FAMILY_SERVE["max_batch"]
    plain = ServeSession(dataclasses.replace(cfg, attn_impl="reference"),
                         session.params, session.scfg)
    plain.last_logits = last_logits
    rel_decode = _rel_rows(*_decode_and_forward(plain, waves[-1],
                                                done[-n:]))
    del plain
    rel_prefill = _flash_vs_plain_rows(session, _padded(waves[0]))
    torch.cuda.synchronize()
    stats = {}
    for name, i in zip("AB", range(len(waves))):
        c = done[i * n]
        steps = FAMILY_SERVE["max_new_tokens"] - 1
        plen = int(_padded(waves[i]).shape[1])
        stats[name] = {"prompt_len": plen,
                       "prefill_s": c.prefill_seconds,
                       "decode_s": c.decode_seconds, "decode_steps": steps,
                       "decode_tokens_per_s": n * steps / c.decode_seconds,
                       "prefill_tokens_per_s": n * plen / c.prefill_seconds}
    emit({"phase": "serve", "model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "params": n_params, "serve_config": FAMILY_SERVE, "waves": stats,
          "launches": launches,
          "prefill_kernels_vs_plain_rel_by_row": rel_prefill,
          "decode_vs_forward_rel_by_row": rel_decode,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    for name in must_launch:
        check(launches[name] > 0, f"{cfg.name}: no {name} launch on its "
                                  f"serve path")
    check(launches["flash_attention_tensor_core"] ==
          launches["flash_attention"],
          f"{cfg.name}: flash launches off the tensor-core route: {launches}")
    check(max(rel_prefill) <= LOGIT_TOL,
          f"{cfg.name}: kernel prefill vs plain prefill {rel_prefill}")
    check(max(rel_decode) <= LOGIT_TOL,
          f"{cfg.name}: decode vs forward {rel_decode}")
    check(bool(torch.isfinite(last_logits).all()), "non-finite logits")
    check(all(c.tokens.shape == (FAMILY_SERVE["max_new_tokens"],)
              for c in done), "completions: wrong token counts")
    emit({"phase": "serve", "model": cfg.name, "checks": "passed"})
    return {**launches,
            "prefill_s": {k: v["prefill_s"] for k, v in stats.items()}}


# -- 8. the bdml island over the ICU feed -------------------------------------------
def _direct_score(loaded, vals) -> torch.Tensor:
    """The port's direct forward and mean next-token NLL of one window's
    rows, as the island must give them bitwise."""
    from repro_torch.models import registry
    from repro_torch.stream import ml
    cfg, params = loaded
    toks = ml.quantize(vals, cfg.vocab_size)
    t = torch.from_numpy(toks[None]).to(params["embed"]["embedding"].device)
    logits, _ = registry.forward(params, {"tokens": t}, cfg)
    logp = torch.log_softmax(logits[0, :-1].float(), -1)
    return -logp.gather(-1, t[0, 1:, None].long())[..., 0].mean()


def ml_phase() -> None:
    """Standing infer queries of the four model aliases over the ICU feed:
    ``lm`` and ``moe`` over one-minute windows every tick, ``rwkv6`` and
    ``mamba`` (Jamba), whose reduced configs run their plain scans token
    by token, over ten-second windows every fifth tick."""
    from repro_torch.core.api import default_deployment
    from repro_torch.data.mimic import stream_mimic_waveforms
    from repro_torch.models import registry
    from repro_torch.sharding import logical as L
    from repro_torch.stream import ml
    bd = default_deployment(stream_engines=1)
    queries = {"lm": (MINUTE, 1), "moe": (MINUTE, 1),
               "rwkv6": (ML_SCAN_WINDOW, ML_SCAN_EVERY),
               "mamba": (ML_SCAN_WINDOW, ML_SCAN_EVERY)}
    cqs, models = {}, {}
    for alias, (window, every) in queries.items():
        bd.register_model(alias)
        cqs[alias] = bd.register_continuous(
            f"bdml(infer(window({WAVE}, {window}), models.{alias}))", every,
            name=f"{alias}_score")
        cfg = registry.get_config(ml.resolve_arch(alias), reduced=True)
        models[alias] = (cfg, L.init_params(
            torch.Generator().manual_seed(SEED), registry.param_specs(cfg),
            bd.device))
    _reset_model_counts()
    s0 = ml.stats()
    scored = {alias: 0 for alias in queries}
    ticks_s = []
    t0 = time.perf_counter()
    for info in stream_mimic_waveforms(bd, batch_rows=MINUTE,
                                       num_batches=ML_BATCHES,
                                       capacity=WAVE_FEED["capacity"],
                                       seed=SEED):
        torch.cuda.synchronize()
        ticks_s.append(time.perf_counter() - t0)
        ran = {name for name, _ in info["ran"]}
        for alias, (window, every) in queries.items():
            cq = cqs[alias]
            check(cq.errors == 0, f"{alias}_score: {cq.last_error}")
            if f"{alias}_score" not in ran:
                continue
            rows = bd.engines["streamstore0"].get(WAVE).window(window)
            vals = rows.attrs["signal"].cpu().numpy().astype(np.float64)
            want = _direct_score(models[alias], vals)
            got = cq.last_value.columns["score"]
            check(got.shape == (1,) and torch.equal(got[0], want),
                  f"{alias} batch {info['batch']}: infer {float(got[0])} != "
                  f"direct {float(want)}")
            check(bool(torch.isfinite(got).all()), "non-finite score")
            scored[alias] += 1
        t0 = time.perf_counter()
    s1 = ml.stats()
    waves = s1["waves"] - s0["waves"]
    want_scored = {alias: ML_BATCHES // every
                   for alias, (_, every) in queries.items()}
    check(scored == want_scored and waves == ML_BATCHES,
          f"ml island: {scored} scored ticks (want {want_scored}), "
          f"{waves} waves")
    check(not any(_model_counts().values()),
          "the ml island launched a kernel")
    emit({"phase": "ml", "ticks": ML_BATCHES,
          "ring_capacity": WAVE_FEED["capacity"], "waves": waves,
          "queries": {alias: {"window_rows": w, "every_n_ticks": e,
                              "arch": ml.resolve_arch(alias),
                              "bitwise_ticks": scored[alias],
                              "metrics": cqs[alias].metrics()}
                      for alias, (w, e) in queries.items()},
          "tick_s": ticks_s, "tick_p50_s": float(np.median(ticks_s)),
          "kernels_launched": 0,
          "note": ("the island scores with the reduced configs and plain "
                   "attention and scans (attn_impl='reference'), as the "
                   "reference does: no kernel of the port runs in this "
                   "phase")})
    for alias in queries:
        bd.streams.deregister(f"{alias}_score")


# -- 9. kernel times --------------------------------------------------------------
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


# window_minmax's timed shapes: (W, size, copies, reps); the copies
# rotate past the 50 MB L2 together.  (1, 450,000): the one-hour max, 3.6
# MB a copy; (1, 7,500): the one-minute min, 60 KB a copy; (1024, 7,500):
# one-minute windows batched, 61 MB a copy.
MINMAX_TIMED = ((1, HOUR, 16, 20), (1, MINUTE, 1024, 2),
                (1024, MINUTE, 2, 20))
# join_bounds' timed shapes: (left key order, keys a side); right keys
# 0.25 after the left ones, tol 0.5, as the main path's join
JOIN_TIMED = (("arrival", HOUR), ("sorted", HOUR), ("shuffled", HOUR),
              ("sorted", 524288))


def minmax_inputs(w: int, size: int, copies: int) -> list:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    return [torch.randn((w, size), generator=gen, device="cuda",
                        dtype=torch.float64) for _ in range(copies)]


def join_inputs(order: str, n: int, copies: int = 8) -> list:
    """``copies`` sets of (lt, rs): right keys 0, 1, ... shifted 0.25
    (each set n further on), the left keys the same timestamps sorted, in
    arrival order (the order of ts + U(-jitter, jitter) with the paired
    feed's jitter) or shuffled; 8 copies of 450,000 keys a side rotate
    past L2."""
    rng = np.random.default_rng(SEED + 4)
    sets = []
    for i in range(copies):
        ts = np.arange(n, dtype=np.float64) + i * n
        if order == "arrival":
            jitter = PAIRED_FEED["jitter"]
            lt = ts[np.argsort(ts + rng.uniform(-jitter, jitter, n),
                               kind="stable")]
        elif order == "shuffled":
            lt = rng.permutation(ts)
        else:
            lt = ts
        sets.append((torch.from_numpy(lt).cuda(),
                     torch.from_numpy(ts + 0.25).cuda()))
    return sets


def stream_device_kernels() -> dict:
    """Device events (kernels, copies, fills) of one call of each
    streaming kernel at each timed shape, after a first, untimed one, as
    torch.profiler counts them: 1 each, or the phase fails.  Counted
    beside the stream path, in the same process state as its feeds'
    profiles."""
    from repro_torch.kernels.stream import ops
    from repro_torch.kernels.stream import stream as sk
    counts = {}
    for w, size, _, _ in MINMAX_TIMED:
        x = minmax_inputs(w, size, 1)[0]
        counts[f"window_minmax {w}x{size}"] = (
            lambda x=x: sk.window_minmax_2d(x, True))
    for order, n in JOIN_TIMED:
        lt, rs = join_inputs(order, n, 1)[0]
        counts[f"join_bounds {n}^2 {order}"] = (
            lambda lt=lt, rs=rs, n=n: sk.join_bounds_1d(lt, rs, 0.5,
                                                        ops.steps(n)))
    for name, fn in counts.items():
        fn()
        # a trace that caught no device event missed the call's launch
        # (the profiler sometimes does late in a long process): take it
        # again, at most three times
        for _ in range(3):
            counts[name] = _device_times(fn)["device_events"]
            if counts[name]:
                break
    emit({"phase": "stream", "device_kernels_per_call": counts})
    for name, count in counts.items():
        check(count == 1, f"{name}: {count} device kernels a call, not 1")
    return counts


def _minmax_times(w: int, size: int, copies: int, reps: int) -> dict:
    """window_minmax (max) at (w, size), its plain version and torch.amax,
    over ``copies`` rotating inputs."""
    from repro_torch.kernels.stream import ref
    from repro_torch.kernels.stream import stream as sk
    xs = minmax_inputs(w, size, copies)
    # torch.amax computes the same function on rows without a zero:
    # checked bitwise on these inputs before it is timed
    check(all(_same_bits(torch.amax(x, dim=1), sk.window_minmax_2d(x, True))
              for x in xs), "torch.amax differs from window_minmax")
    geo = sk.minmax_geometry(w, size, sk.load().repro_window_minmax_loads())
    out = {"shape": [w, size], "copies": copies,
           "ms": _graph_ms([lambda x=x: sk.window_minmax_2d(x, True)
                            for x in xs], reps),
           "plain_ms": _graph_ms([lambda x=x: ref.window_minmax(x, True)
                                  for x in xs], reps),
           "library_ms": _graph_ms([lambda x=x: torch.amax(x, dim=1)
                                    for x in xs], reps),
           "library": "torch.amax(x, dim=1)",
           "blocks": w * geo.chunks, "threads": geo.threads}
    # read every value once, write one a row; one compare-select a value
    out.update(_bound(8 * w * size + 8 * w, w * size))
    return out


def _join_times(order: str, n: int) -> dict:
    """join_bounds at n x n keys with the left keys in ``order``, its
    plain version and two torch.searchsorted, over 8 rotating sets; the
    routes its blocks take (the plain version of its algorithm)."""
    from repro_torch.kernels.stream import ops, ref
    from repro_torch.kernels.stream import stream as sk
    tol, steps = 0.5, ops.steps(n)
    sets = join_inputs(order, n)
    geo = sk.join_geometry(n, sk.load().repro_join_bounds_keys())
    lt, rs = sets[0]
    *_, routes = ref.join_bounds_narrowed(
        lt.cpu(), rs.cpu(), tol, geo.block,
        sk.load().repro_join_bounds_budget())
    out = {"shape": [n, n], "order": order, "steps": steps,
           "routes": routes,
           "ms": _graph_ms([lambda a=a, b=b: sk.join_bounds_1d(a, b, tol,
                                                                steps)
                            for a, b in sets]),
           "plain_ms": _graph_ms([lambda a=a, b=b: ref.join_bounds(a, b,
                                                                    tol)
                                  for a, b in sets]),
           "library_ms": _graph_ms([
               lambda a=a, b=b: (torch.searchsorted(b, a - tol),
                                 torch.searchsorted(b, a + tol, right=True))
               for a, b in sets]),
           "library": "torch.searchsorted x2 (two calls)",
           "blocks": geo.blocks}
    # read both key arrays, write lo and hi; per left key two roundings
    # and 2 * steps compares
    out.update(_bound(8 * n + 8 * n + 4 * n + 4 * n, n * (2 + 2 * steps)))
    return out


def stream_kernel_rows(launches: dict, err: dict, kernels: dict) -> list:
    """Both streaming kernels at every shape of MINMAX_TIMED and
    JOIN_TIMED (the first of each is the row's own), with their device
    kernels a call (``kernels``, stream_device_kernels), the launch
    floor (an empty kernel timed the same way), ptxas's registers and
    spills and their SASS hot loops."""
    from repro_torch.kernels.stream import stream as sk
    source = "src/repro_torch/kernels/stream/csrc/stream.cu"
    floor = _graph_ms([lambda: sk.empty_launch(torch.device("cuda"))],
                      reps=100)
    machine = {"ptxas": _ptxas("stream"),
               "sass": _sass("stream", sk.SOURCES)}
    minmax = [_minmax_times(*shape) for shape in MINMAX_TIMED]
    join = [_join_times(*shape) for shape in JOIN_TIMED]
    for t in minmax:
        t["device_kernels_per_call"] = kernels[
            "window_minmax {}x{}".format(*t["shape"])]
    for t in join:
        t["device_kernels_per_call"] = kernels[
            "join_bounds {}^2 {}".format(t["shape"][0], t["order"])]
    rows = []
    for name, times, line in (("window_minmax", minmax, 66),
                              ("join_bounds", join, 106)):
        rows.append({"name": f"stream.{name}", "route": "cuda",
                     "source": source,
                     "replaces": f"{STREAM_REPLACES}:{line}",
                     "launches": launches[name],
                     "max_abs_err": err[name], **times[0],
                     "other_shapes": times[1:],
                     "launch_floor_ms": floor, **machine})
    return rows


def _flash_bound(b, s, hq, hkv, dh) -> dict:
    """Read q, k and v once and write o, in bf16; QK^T and P.V over the
    causal half: 2 x 2 x Dh operations for each of Hq x S(S+1)/2 pairs,
    at the bf16 tensor-core rate."""
    nbytes = 2 * (2 * b * s * hq * dh + 2 * b * s * hkv * dh)
    ops = 4 * b * hq * dh * s * (s + 1) // 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops}


def _sm90_machine_code() -> dict:
    """The tensor-core kernel's ptxas report (registers, spills) and how
    many wgmma (HGMMA) and TMA load (UTMALDG) instructions
    ``cuobjdump -sass`` finds in its built library."""
    from repro_torch.kernels import _build, _sass
    from repro_torch.kernels.flash_attention import flash_attention as fk
    sass = _sass.disassemble(str(_build.library_path(
        "flash_attention_sm90", fk.SM90_SOURCES)))
    ptxas = [ln.strip() for ln in _build.BUILD_LOGS.get(
        "flash_attention_sm90", "").splitlines()
             if "registers" in ln or "spill" in ln]
    return {"ptxas": ptxas, "sass_HGMMA": sass.count("HGMMA"),
            "sass_UTMALDG": sass.count("UTMALDG")}


def flash_kernel_rows(launches: int, err: dict) -> list:
    """flash_attention's tensor-core route (the main path's) at the serve
    shape, at Jamba's (8, 1,024, 32/8, 128) and at seamless-m4t-medium's
    decoder's (8, 1,024, 16/16, 64), causal bf16, two input sets
    rotating past the L2: the kernel and scaled_dot_product_attention, each
    held against the plain version at that shape first (the library call is
    timed only, the port never calls it), and the plain version; the
    CUDA-core route in f32 at the serve shape; the tensor-core kernel's
    machine code."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ref
    b, s, hq, hkv, dh = SERVE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def draw(heads, kv_heads, dh, dt):
        return [[torch.randn(shape, generator=gen, device="cuda").to(dt)
                 for shape in ((b, s, heads, dh), (b, s, kv_heads, dh),
                               (b, s, kv_heads, dh))] for _ in range(2)]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    shapes = {"qwen2": (hq, hkv, dh), "jamba": (32, 8, dh),
              "seamless": SEAMLESS_SHAPE[2:]}
    times = {}
    for name, (heads, kv_heads, dh) in shapes.items():
        bf16 = draw(heads, kv_heads, dh, torch.bfloat16)
        check(fk.route(torch.bfloat16, dh) == fk.TENSOR_CORE,
              "the serve shape's bf16 does not route to the tensor cores")
        want = ref.gqa_attention(*bf16[0], causal=True).float()
        got = fk.flash_attention_4d(*bf16[0], True).float()
        check(torch.allclose(got, want, atol=FLASH_TOL[torch.bfloat16],
                             rtol=FLASH_TOL[torch.bfloat16]),
              f"flash_attention differs from the plain version at {name}'s "
              f"shape")
        check(torch.allclose(sdpa(*bf16[0]).float(), want,
                             atol=2e-2, rtol=2e-2),
              "scaled_dot_product_attention differs from the plain version")
        times[name] = {
            "shape": [b, s, heads, kv_heads, dh],
            "max_abs_err_at_shape": (got - want).abs().max().item(),
            "ms": _graph_ms([lambda x=x: fk.flash_attention_4d(*x, True)
                             for x in bf16]),
            "plain_ms": _graph_ms([lambda x=x: ref.gqa_attention(
                *x, causal=True) for x in bf16], reps=2),
            "library_ms": _graph_ms([lambda x=x: sdpa(*x) for x in bf16]),
            **_flash_bound(b, s, heads, kv_heads, dh)}
        del want, got
        if name == "qwen2":
            f32 = draw(heads, kv_heads, dh, torch.float32)
            check(fk.route(torch.float32, dh) == fk.CUDA_CORE,
                  "f32 does not route to the CUDA cores")
            times[name]["ms_f32"] = _graph_ms(
                [lambda x=x: fk.flash_attention_4d(*x, True) for x in f32])
            del f32
        del bf16
    serve = times.pop("qwen2")
    return [{"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention_sm90.cu",
             "source_cuda_core": "src/repro_torch/kernels/flash_attention/"
                                 "csrc/flash_attention.cu",
             "replaces": f"{FLASH_REPLACES}:31",
             "launches": launches, "max_abs_err": err[fk.TENSOR_CORE],
             "max_abs_err_cuda_core": err[fk.CUDA_CORE],
             **serve,
             "library": "scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True)",
             "dtype": "bfloat16", "jamba": times["jamba"],
             "seamless": times["seamless"],
             **_sm90_machine_code()}]


def _f32_bound(nbytes: int, ops: int) -> dict:
    """The least time for ``nbytes`` of device memory traffic and ``ops``
    float32 operations outside the tensor cores, and which bounds it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops}


def _kernel_name(mangled: str) -> str:
    """A scan or streaming kernel's mangled name as kernel<template
    argument>."""
    m = re.search(r"(?<=\d)((?:wkv6|scan)\w*?_kernel)I"
                  r"(Li(\d+)E|f|13__nv_bfloat16)", mangled)
    if m:
        arg = m.group(3) or ("float" if m.group(2) == "f" else "bfloat16")
        return f"{m.group(1)}<{arg}>"
    m = re.search(r"(?<=\d)(minmax_rows|join_bounds_blocks|empty_kernel)"
                  r"(?:ILb([01])E)?", mangled)
    if m:
        arg = {None: "", "0": "<false>", "1": "<true>"}[m.group(2)]
        return m.group(1) + arg
    return mangled


def _ptxas(library: str) -> dict:
    """ptxas's registers and spills for each kernel of a library built in
    this run."""
    from repro_torch.kernels import _build
    out, name = {}, None
    for ln in _build.BUILD_LOGS.get(library, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        elif name and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def _sass(library: str, sources) -> list:
    """repro_torch.kernels._sass's reading of a library built in this
    run: each kernel's instruction count, its hot loop's opcodes and
    instructions per MUFU.EX2."""
    from repro_torch.kernels import _build, _sass
    sass = _sass.disassemble(str(_build.library_path(library, sources)))
    return [{"kernel": _kernel_name(row["kernel"]),
             "instructions": row["instructions"], "hot_loop": row["hot_loop"]}
            for row in _sass.analyse(sass)]


def _clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi gives it."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(mhz.splitlines()[0]) * 1e6


def _scan_times(kernel, plain, sets, nbytes: int, ops: int) -> dict:
    return {"ms": _graph_ms([lambda x=x: kernel(*x) for x in sets]),
            "plain_ms": _graph_ms([lambda x=x: plain(*x) for x in sets],
                                  reps=1),
            **_f32_bound(nbytes, ops)}


def _decode_times(kernel, sets, nbytes: int) -> dict:
    """One S = 1 step's time over input sets that together exceed the 50
    MB L2 (as the states of a model's layers do), beside the time the
    state's bytes alone take."""
    return {"ms": _graph_ms([lambda x=x: kernel(*x) for x in sets]),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}


def scan_kernel_rows(launches: dict, err: dict, prefill_s: dict) -> list:
    """rwkv6_scan at RWKV6-7B's wave (8, 1,024, 64 heads of 64, float32,
    full-width decays; the chunked route) and mamba_scan at Jamba's (8,
    1,024, 8,192, N 16, bf16 as the model feeds it; f32 beside it), each
    over two input sets that rotate past the 50 MB L2, against its plain
    version; and each at a decode step, S = 1 (rwkv6_scan's per-token
    route), over eight sets.  No one PyTorch call computes either
    recurrence.  Beside each: its launches on the serve paths by route
    (prefill or decode), the model's prefill seconds, ptxas's registers
    and spills, its SASS (repro_torch.kernels._sass), and for mamba_scan
    the floor its exps set on the SFUs."""
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.mamba_scan import ref as mref
    from repro_torch.kernels.rwkv6_scan import ref as wref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    b, s, h, d = WKV_SHAPE
    check(wk.route(s) == wk.CHUNKED and wk.route(1) == wk.PER_TOKEN,
          "rwkv6_scan's routes at the serve shapes")
    sets = [_wkv_inputs(b, s, h, d, "full_width", 110 + i) for i in range(2)]
    chunks = b * h * -(-s // wk.CHUNK)
    c = wk.CHUNK
    # the chunked form's products in 3xTF32 (three TF32 products each):
    # y's inter-chunk term and the state update (2 c d^2 each), P V
    # (2 c^2 d) and P's three tensor-core levels (2 c 8 d each); on the
    # CUDA cores the factors (~10 an element) and P's 24 other entries
    tc_ops = 3 * chunks * (4 * c * d * d + 2 * c * c * d + 3 * 2 * c * 8 * d)
    cc_ops = chunks * (10 * c * d + 24 * 2 * d)
    nbytes = 4 * (5 * b * s * h * d + h * d + 2 * b * h * d * d)
    wkv = _scan_times(wk.wkv6_4d, wref.wkv6, sets, nbytes, tc_ops + cc_ops)
    ops_ms = (tc_ops / TF32_OPS_PER_S + cc_ops / F32_OPS_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    wkv.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               operations_tensor_core_tf32=tc_ops,
               operations_cuda_core=cc_ops)
    del sets
    dec = [_wkv_inputs(b, 1, h, d, "full_width", 130 + i) for i in range(8)]
    wkv_decode = _decode_times(wk.wkv6_4d, dec, 4 * (
        5 * b * h * d + h * d + 2 * b * h * d * d))
    wkv_decode["shape"] = [b, 1, h, d]
    del dec

    b, s, di, n = SCAN_SHAPE
    scan = {}
    for dtype in (torch.bfloat16, torch.float32):
        sets = [_scan_inputs(b, s, di, n, dtype, 120 + i) for i in range(2)]
        esize = torch.finfo(dtype).bits // 8
        # read u, dt, b, c, A and h0 once, write y and h; per (b, t, d)
        # dt u, and per state element dt A, its exp, the update (a
        # multiply and an FMA) and y's FMA: 7 N + 1 operations
        scan[dtype] = _scan_times(
            mk.selective_scan_3d, mref.selective_scan, sets,
            esize * (3 * b * s * di + 2 * b * s * n) + 4 * di * n
            + 8 * b * di * n, b * s * di * (7 * n + 1))
        del sets
    dec = [_scan_inputs(b, 1, di, n, torch.bfloat16, 140 + i)
           for i in range(8)]
    scan_decode = _decode_times(mk.selective_scan_3d, dec, 2 * (
        3 * b * di + 2 * b * n) + 4 * di * n + 8 * b * di * n)
    scan_decode["shape"] = [b, 1, di, n]
    del dec
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = _clock_hz()
    exp_floor_ms = b * s * di * n / (SFU_EX2_PER_CLOCK * sms * clock) * 1e3

    common = {"route": "cuda", "library_ms": None,
              "library": "none (no one call)"}
    return [
        {"name": "rwkv6_scan",
         "source": "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
         "replaces": f"{WKV_REPLACES}:33",
         "launches": launches["rwkv6_scan"], "max_abs_err": err["rwkv6_scan"],
         **common, **wkv,
         "shape": list(WKV_SHAPE), "dtype": "float32",
         "kernel_route": wk.CHUNKED,
         "launches_by_route": {
             wk.CHUNKED: launches["rwkv6_scan_chunked"],
             wk.PER_TOKEN: launches["rwkv6_scan_per_token"]},
         "parity_cases_by_route": err["rwkv6_scan_routes"],
         "decode": {**wkv_decode, "kernel_route": wk.PER_TOKEN},
         "rwkv6_7b_prefill_s": prefill_s["rwkv6-7b"],
         "ptxas": _ptxas("rwkv6_scan"),
         "sass": _sass("rwkv6_scan", wk.SOURCES)},
        {"name": "mamba_scan",
         "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
         "replaces": f"{SCAN_REPLACES}:31",
         "launches": launches["mamba_scan"], "max_abs_err": err["mamba_scan"],
         **common, **scan[torch.bfloat16],
         "shape": list(SCAN_SHAPE),
         "dtype": "bfloat16", "max_abs_err_bf16": err["mamba_scan_bf16"],
         "max_abs_err_large_dt": {
             "f32": err["mamba_scan_large_dt"],
             "bf16": err["mamba_scan_bf16_large_dt"]},
         "f32": scan[torch.float32],
         "exp_floor_ms": exp_floor_ms,
         "exp_floor": f"{b * s * di * n} MUFU.EX2 at "
                      f"{SFU_EX2_PER_CLOCK} a clock on {sms} SMs at "
                      f"{clock / 1e9:.3f} GHz",
         "launches_by_route": {
             "prefill": launches["mamba_scan_prefill"],
             "decode": launches["mamba_scan_decode"]},
         "decode": scan_decode,
         "jamba_prefill_s": prefill_s["jamba-v0.1-52b"],
         "ptxas": _ptxas("mamba_scan"),
         "sass": _sass("mamba_scan", mk.SOURCES)}]


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
    stream_kernels = stream_device_kernels()
    del join, bds
    torch.cuda.empty_cache()
    root = pathlib.Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="durable_feed_",
                                     dir=root) as tmp:
        durable = durable_feed(pathlib.Path(tmp))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="frontdoor_",
                                     dir=root) as tmp:
        door = frontdoor_feed(pathlib.Path(tmp))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="admin_", dir=root) as tmp:
        admin_phase(pathlib.Path(tmp))
    torch.cuda.empty_cache()

    flash_err = flash_parity()
    scan_err = scan_parity()
    serve = serve_phase()                     # resets and reads its counts
    torch.cuda.empty_cache()
    seamless = serve_seamless_phase()         # resets and reads its counts
    torch.cuda.empty_cache()
    # each family phase resets the model kernels' counts before its serve
    # path and reads them after it
    rwkv = family_serve_phase("rwkv6-7b", True,
                              ("rwkv6_scan", "rwkv6_scan_chunked",
                               "rwkv6_scan_per_token"))
    jamba = family_serve_phase("jamba-v0.1-52b", False,
                               ("mamba_scan", "mamba_scan_prefill",
                                "mamba_scan_decode", "flash_attention"),
                               num_layers=JAMBA_LAYERS)
    torch.cuda.empty_cache()
    ml_phase()
    torch.cuda.empty_cache()

    rows = quant_kernel_rows(launches, err)
    rows += stream_kernel_rows(
        {"window_minmax": stream_launches["window_minmax"]
         + durable["window_minmax"] + door["window_minmax"],
         "join_bounds": stream_launches["join_bounds"]
         + door["join_bounds"]}, stream_err, stream_kernels)
    rows[-2]["launches_by_path"] = {
        "stream": stream_launches["window_minmax"],
        "durable_feed": durable["window_minmax"],
        "durable_feed_after_recovery": durable["after_recovery"],
        "frontdoor": door["window_minmax"]}
    rows[-1]["launches_by_path"] = {
        "stream": stream_launches["join_bounds"],
        "frontdoor": door["join_bounds"]}
    rows += flash_kernel_rows(serve["launches"] + jamba["flash_attention"]
                              + seamless["launches"], flash_err)
    rows[-1]["launches_by_path"] = {"serve_qwen2": serve["launches"],
                                    "serve_jamba": jamba["flash_attention"],
                                    "serve_seamless": seamless["launches"]}
    rows[-1]["qwen2_prefill_s"] = serve["prefill_s"]
    rows[-1]["seamless_prefill_s"] = seamless["prefill_s"]
    rows += scan_kernel_rows(
        {**{k: v for k, v in rwkv.items() if k.startswith("rwkv6_scan")},
         **{k: v for k, v in jamba.items() if k.startswith("mamba_scan")}},
        scan_err, {"rwkv6-7b": rwkv["prefill_s"],
                   "jamba-v0.1-52b": jamba["prefill_s"]})
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
