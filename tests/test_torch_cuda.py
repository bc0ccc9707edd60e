"""The port's CUDA kernels (quant_cast, the streaming kernels, flash
attention and the two scans, rwkv6_scan and mamba_scan) on the card,
against their plain PyTorch versions.  Marked ``cuda``: without a CUDA device each test skips, since a
CUDA kernel has no CPU mode.  This file imports no JAX, so it runs on the
GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fk
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.quant_cast import ops, ref
from repro_torch.kernels.quant_cast import quant_cast as k
from repro_torch.kernels.stream import ops as sops
from repro_torch.kernels.stream import ref as sref
from repro_torch.kernels.stream import stream as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, seed):
    """Normal data whose 128-wide rows span twelve orders of magnitude."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    mags = 10.0 ** rng.integers(-6, 6, -(-flat.size // 128))
    flat *= np.repeat(mags, 128)[:flat.size].astype(np.float32)
    if flat.size > 128:
        flat[:128] = 0.0
    return x


@pytest.mark.parametrize("shape", [(1000,), (3, 7, 33), (8, 128),
                                   (8, 4096, 2, 128)])
def test_kernel_matches_plain_version_on_card(card, shape):
    x = torch.from_numpy(_inputs(shape, 5)).to(card)
    x2d = ops._pad_to_tiles(x.reshape(-1))
    q, scale = k.quantize_2d(x2d)
    qr, sr = ref.quantize_blocks(x2d)
    assert torch.equal(q, qr) and torch.equal(scale, sr)
    assert torch.equal(k.dequantize_2d(q, scale),
                       ref.dequantize_blocks(q, scale))


def test_nan_row_takes_the_plain_scale(card):
    x = torch.from_numpy(_inputs((8, 128), 6)).to(card)
    x[3, 7] = float("nan")
    q, scale = k.quantize_2d(x)
    qr, sr = ref.quantize_blocks(x)
    assert float(scale[3, 0]) == float(sr[3, 0]) == 1.0
    rows = [i for i in range(8) if i != 3]
    assert torch.equal(scale[rows], sr[rows]) and torch.equal(q[rows],
                                                              qr[rows])


def test_ops_route_cuda_tensors_to_the_kernel(card):
    x = torch.from_numpy(_inputs((5, 300), 7)).to(card)
    before = k.launch_counts()
    q, scale = ops.quantize(x)
    back = ops.dequantize(q, scale, x.shape)
    assert k.launch_counts() == {"quantize": before["quantize"] + 1,
                                 "dequantize": before["dequantize"] + 1}
    want = ops.dequantize(*ops.quantize(x.cpu()), x.shape)
    assert torch.equal(back.cpu(), want)


# -- the streaming kernels -------------------------------------------------------
def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal float64 bit patterns; any NaN equals any NaN."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int64),
                            b[~nan].view(torch.int64)))


def _rows(w, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((w, size))
    if w > 1:
        x[1, size // 2] = np.nan
    if w > 2:
        x[2] = -np.abs(x[2])
        x[2, ::2], x[2, 1::2] = 0.0, -0.0
    if w > 3:
        x[3] = -0.0
    return x


@pytest.mark.parametrize("is_max", [False, True], ids=["min", "max"])
@pytest.mark.parametrize("w,size", [(1, 1), (1, 8191), (1, 450000),
                                    (7, 8191), (13, 1), (13, 2049),
                                    (1024, 7500), (1, 7500), (1, 8192),
                                    (1, 8193), (13, 450000)])
def test_window_minmax_matches_plain_version_on_card(card, w, size, is_max):
    x = torch.from_numpy(_rows(w, size, w + size)).to(card)
    got = sk.window_minmax_2d(x, is_max)
    assert _same_bits(got, sref.window_minmax(x, is_max))
    # a row that starts 8 bytes off the 16-byte grid
    buf = torch.empty(size + 1, dtype=torch.float64, device=card)
    buf[1:] = x[-1]
    odd = buf[1:].reshape(1, size)
    assert _same_bits(sk.window_minmax_2d(odd, is_max),
                      sref.window_minmax(odd, is_max))


@pytest.mark.parametrize("nl,nr", [(1, 1), (7, 2), (1000, 1), (1001, 2),
                                   (450000, 450000), (524288, 524288)])
def test_join_bounds_matches_plain_version_on_card(card, nl, nr):
    rng = np.random.default_rng(nl + nr)
    tol = 0.5
    rs = np.sort(rng.integers(0, max(nr // 2, 4), nr) * 0.25)
    lt = rng.uniform(rs[0] - 1, rs[-1] + 1, nl)
    edge = rs[rng.integers(0, nr, nl)]
    lt[::3] = edge[::3] + tol
    lt[1::3] = edge[1::3] - tol
    lt_d = torch.from_numpy(lt).to(card)
    rs_d = torch.from_numpy(rs).to(card)
    lo, hi = sk.join_bounds_1d(lt_d, rs_d, tol, sops.steps(nr))
    want_lo, want_hi = sref.join_bounds(lt_d, rs_d, tol)
    assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)


def _join_keys(n, order, seed, bad=None):
    """Right keys 0.25 after the timestamps 0 .. n-1; left keys the
    timestamps sorted, in the paired feed's arrival order (within +-2 of
    sorted), or shuffled; ``bad`` (inf or nan) at a few left keys, both
    signs."""
    rng = np.random.default_rng(seed)
    ts = np.arange(n, dtype=np.float64)
    lt = {"sorted": ts.copy(),
          "arrival": ts[np.argsort(ts + rng.uniform(-2, 2, n),
                                   kind="stable")],
          "shuffled": rng.permutation(ts)}[order]
    if bad is not None:
        lt[[3, n // 2, n // 2 + 1, n - 1]] = [bad, -bad, bad, -bad]
    return lt, ts + 0.25


@pytest.mark.parametrize("order", ["sorted", "arrival", "shuffled"])
@pytest.mark.parametrize("bad", [None, np.inf], ids=["finite", "inf"])
def test_join_bounds_main_path_orders_on_card(card, order, bad):
    lt, rs = _join_keys(450000, order, 11, bad)
    lo, hi = sk.join_bounds_1d(torch.from_numpy(lt).to(card),
                               torch.from_numpy(rs).to(card), 0.5,
                               sops.steps(rs.size))
    np.testing.assert_array_equal(lo.cpu().numpy(),
                                  np.searchsorted(rs, lt - 0.5, "left"))
    np.testing.assert_array_equal(hi.cpu().numpy(),
                                  np.searchsorted(rs, lt + 0.5, "right"))


def test_join_bounds_takes_every_route_on_card(card):
    """Blocks whose slice fits the kernel's budget (staged in shared
    memory), passes it by one key or by many (searched in device memory),
    and a block holding a NaN key (all of rs), against the plain version
    of the kernel's algorithm (a NaN key finds 0, as the reference's
    kernel answers)."""
    budget = sk.load().repro_join_bounds_budget()
    block = sk.join_geometry(1).block
    lt, rs = _join_keys(6 * block + budget, "arrival", 12)
    # block 1's keys reach exactly `budget` right keys, block 2's one more
    # (tol 0.5 and right keys 0.25 after the timestamps: [t0, t0 + span)
    # reaches the span's keys)
    for b, span in ((1, budget), (2, budget + 1)):
        keys = lt[b * block:(b + 1) * block]
        keys[:] = b * block + np.linspace(0, span - 1, block)
    lt[3 * block:4 * block] = np.linspace(0, lt.size - 1, block)  # all of rs
    lt[4 * block + 7] = np.nan
    lo, hi = sk.join_bounds_1d(torch.from_numpy(lt).to(card),
                               torch.from_numpy(rs).to(card), 0.5,
                               sops.steps(rs.size))
    want_lo, want_hi, routes = sref.join_bounds_narrowed(
        torch.from_numpy(lt), torch.from_numpy(rs), 0.5, block, budget)
    assert torch.equal(lo.cpu(), want_lo) and torch.equal(hi.cpu(), want_hi)
    assert routes["staged"] >= 2 and routes["wide"] == 2
    assert routes["full"] == 1 and lo[4 * block + 7] == hi[4 * block + 7] == 0


def _identical(a: torch.Tensor, b: torch.Tensor) -> bool:
    return _same_bits(a, b) if a.is_floating_point() else torch.equal(a, b)


def _minmax_and_join(card):
    x = torch.from_numpy(_rows(3, 450000, 13)).to(card)
    lt, rs = _join_keys(450000, "arrival", 14)
    lt, rs = torch.from_numpy(lt).to(card), torch.from_numpy(rs).to(card)
    steps = sops.steps(rs.numel())
    return lambda: (sk.window_minmax_2d(x, True),
                    sk.window_minmax_2d(x[:1], False),
                    *sk.join_bounds_1d(lt, rs, 0.5, steps))


def test_stream_kernels_are_bitwise_repeatable(card):
    """1,000 calls back to back give the first call's bits: each launch of
    a split row leaves its arrival counters at 0 for the next."""
    run = _minmax_and_join(card)
    first = run()
    outs = [run() for _ in range(1000)]
    torch.cuda.synchronize()
    assert all(all(_identical(a, b) for a, b in zip(first, out))
               for out in outs)


def test_stream_kernels_launch_under_graph_capture(card):
    """Both kernels allocate nothing but their outputs and scratch in a
    launch (a split row's counters are the capture's own): a CUDA graph
    captures them, and its replays give the eager bits."""
    run = _minmax_and_join(card)
    want = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [run() for _ in range(4)]
    for _ in range(50):
        graph.replay()
        torch.cuda.synchronize()
        assert all(_identical(a, b) for out in outs
                   for a, b in zip(want, out))


def test_stream_kernels_on_two_streams_at_once(card):
    """Split rows launched on two streams at once, each with its own
    arrival counters, are right."""
    xs = [torch.from_numpy(_rows(2, 450000, 20 + i)).to(card)
          for i in range(2)]
    want = [sref.window_minmax(x, True) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(200):
        for i, (st, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(st):
                outs[i].append(sk.window_minmax_2d(x, True))
    torch.cuda.synchronize()
    assert all(_same_bits(o, want[i]) for i in range(2) for o in outs[i])


def _device_events(fn) -> int:
    """Device events (kernels, copies, fills) of one call, after a first,
    as torch.profiler counts them.  Each traced call must launch once (the
    wrapper's count); a trace that caught no device event at all missed
    that launch, as the profiler sometimes does late in a long process,
    and is taken again, at most three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        before = sum(sk.launch_counts().values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        assert sum(sk.launch_counts().values()) == before + 1
        events = sum(ev.count for ev in prof.key_averages()
                     if ev.device_type != DeviceType.CPU
                     and not ev.key.startswith("Activity Buffer")
                     and ev.self_device_time_total > 0)
        if events:
            return events
    return 0


@pytest.mark.parametrize("what", ["minmax_hour", "minmax_minute", "join"])
def test_stream_kernels_are_one_device_kernel_a_call(card, what):
    if what == "join":
        lt, rs = _join_keys(450000, "arrival", 15)
        lt, rs = torch.from_numpy(lt).to(card), torch.from_numpy(rs).to(card)
        fn = lambda: sk.join_bounds_1d(lt, rs, 0.5, 20)  # noqa: E731
    else:
        size = 450000 if what == "minmax_hour" else 7500
        x = torch.from_numpy(_rows(1, size, 16)).to(card)
        fn = lambda: sk.window_minmax_2d(x, True)  # noqa: E731
    assert _device_events(fn) == 1


def test_stream_ops_route_cuda_tensors_to_the_kernels(card):
    x = torch.from_numpy(_rows(3, 5000, 9)).to(card)
    before = sk.launch_counts()
    sops.window_minmax(x, True)
    sops.join_bounds(x[0], torch.sort(x[2]).values, 0.1)
    assert sk.launch_counts() == {
        "window_minmax": before["window_minmax"] + 1,
        "join_bounds": before["join_bounds"] + 1}


# -- flash attention ----------------------------------------------------------------
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py


def _qkv(card, b, s, t, hq, hkv, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card, dtype)
        for shape in ((b, s, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh))]


def _routes():
    return {fk.TENSOR_CORE: fk.tensor_core_launches,
            fk.CUDA_CORE: fk.cuda_core_launches}


def _flash_on_its_route(q, k, v, causal):
    """One launch of flash_attention_4d, checked to have gone through the
    kernel that its dtype and head dim route it to."""
    which = fk.route(q.dtype, q.shape[-1])
    before = _routes()
    got = fk.flash_attention_4d(q, k, v, causal)
    after = _routes()
    assert after[which] == before[which] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    return got


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,t,hq,hkv,dh", [
    (1, 128, 128, 4, 4, 64), (2, 256, 256, 4, 2, 64),
    (1, 512, 512, 8, 2, 128), (2, 128, 128, 6, 3, 32),
    (1, 384, 384, 2, 1, 128), (1, 100, 100, 2, 1, 16),
    (1, 1000, 1000, 12, 2, 128), (2, 200, 72, 4, 2, 64),
    (1, 72, 200, 4, 2, 32), (2, 1, 1, 4, 2, 128), (2, 63, 63, 4, 2, 128),
    (2, 65, 65, 4, 2, 64), (1, 2048, 2048, 4, 1, 128),
    (2, 256, 256, 32, 8, 128)])
def test_flash_attention_matches_plain_version_on_card(card, b, s, t, hq,
                                                      hkv, dh, dtype,
                                                      causal):
    q, k, v = _qkv(card, b, s, t, hq, hkv, dh, dtype, s + t + dh)
    got = _flash_on_its_route(q, k, v, causal)
    want = fref.gqa_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,t,hq,hkv,dh", [
    (2, 256, 256, 12, 2, 128), (1, 1000, 1000, 12, 2, 128),
    (2, 200, 72, 4, 2, 64), (2, 63, 63, 4, 2, 128),
    (1, 2048, 2048, 4, 1, 128)])
def test_flash_attention_holds_at_saturated_scores_on_card(card, b, s, t, hq,
                                                          hkv, dh, dtype,
                                                          causal):
    """Integer q and k in [-30, 30]: every q.k is exact in float32 on both
    sides and the scaled scores have a standard deviation of ~300, so each
    softmax row is near one-hot and an error in the running max or its
    rescale shows at the usual tolerance."""
    rng = np.random.default_rng(s + t + dh)
    q, k, v = [torch.from_numpy(x.astype(np.float32)).to(card, dtype)
               for x in (rng.integers(-30, 31, (b, s, hq, dh)),
                         rng.integers(-30, 31, (b, t, hkv, dh)),
                         rng.standard_normal((b, t, hkv, dh)))]
    got = _flash_on_its_route(q, k, v, causal)
    want = fref.gqa_attention(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_rejects_what_the_kernel_does_not_take(card):
    q, k, v = _qkv(card, 1, 64, 64, 4, 2, 64, torch.float32, 1)
    with pytest.raises(TypeError, match="dtype"):
        fk.flash_attention_4d(q.half(), k.half(), v.half(), True)
    with pytest.raises(TypeError, match="dtype"):
        fk.flash_attention_4d(q, k.bfloat16(), v, True)
    with pytest.raises(ValueError, match="contiguous"):
        fk.flash_attention_4d(q.transpose(1, 2), k, v, True)
    odd = _qkv(card, 1, 64, 64, 4, 2, 48, torch.float32, 2)
    with pytest.raises(ValueError, match="head dim"):
        fk.flash_attention_4d(*odd, True)
    with pytest.raises(ValueError, match="multiple"):
        fk.flash_attention_4d(*_qkv(card, 1, 64, 64, 4, 3, 64,
                                    torch.float32, 3), True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fk.flash_attention_4d(q.cpu(), k, v, True)


@pytest.mark.parametrize("dtype,dh,which", [
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 64, "tensor_core"),
    (torch.float32, 128, "cuda_core"), (torch.bfloat16, 32, "cuda_core"),
    (torch.float32, 32, "cuda_core")])
def test_flash_attention_routes_by_dtype_and_head_dim(card, dtype, dh,
                                                      which):
    q, k, v = _qkv(card, 2, 96, 96, 4, 2, dh, dtype, 5)
    assert fk.route(dtype, dh) == which
    before = _routes()
    fk.flash_attention_4d(q, k, v, True)
    after = _routes()
    assert after[which] == before[which] + 1
    assert sum(after.values()) == sum(before.values()) + 1


def test_flash_attention_launches_under_graph_capture(card):
    """Both routes build nothing and allocate nothing but the output in a
    launch, so a CUDA graph captures them and replays them on new
    inputs copied into the captured ones."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _qkv(card, 2, 256, 256, 4, 2, 128, dtype, 6)
        fk.flash_attention_4d(q, k, v, True)           # warm: build, attrs
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fk.flash_attention_4d(q, k, v, True)
        for seed in (7, 8):
            for dst, src in zip((q, k, v), _qkv(card, 2, 256, 256, 4, 2, 128,
                                                dtype, seed)):
                dst.copy_(src)
            graph.replay()
            torch.cuda.synchronize()
            tol = FLASH_TOL[dtype]
            torch.testing.assert_close(
                out.float(), fref.gqa_attention(q, k, v).float(), atol=tol,
                rtol=tol)


def test_flash_attention_is_bitwise_repeatable(card):
    q, k, v = _qkv(card, 8, 1024, 1024, 12, 2, 128, torch.bfloat16, 9)
    first = fk.flash_attention_4d(q, k, v, True)
    assert torch.equal(first, fk.flash_attention_4d(q, k, v, True))


def test_flash_ops_route_cuda_tensors_to_the_kernel(card):
    q, k, v = _qkv(card, 2, 96, 96, 4, 2, 64, torch.bfloat16, 4)
    before = fk.launches
    got = fops.flash_attention(q, k, v, causal=True)
    assert fk.launches == before + 1
    fops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True)
    assert fk.launches == before + 1
    fk.reset_launch_count()
    assert fk.launches == 0 and _routes() == {fk.TENSOR_CORE: 0,
                                              fk.CUDA_CORE: 0}
    torch.testing.assert_close(got.float(), fref.gqa_attention(
        q, k, v, causal=True).float(), atol=2e-2, rtol=2e-2)


# -- the scans ------------------------------------------------------------------------
WKV_TOL, SCAN_TOL = 5e-4, 5e-5                             # test_kernels.py


def _wkv(card, b, s, h, d, seed, decays="sweep", carried=True):
    """r, k, v standard normal; decays uniform in [0.85, 0.999] (the
    sweep's), as RWKV6-7B's initializer gives them at full width
    (exp(-exp(0.63 z))), or pinned at the edges of [0, 1]."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, d)) for _ in range(3))
    if decays == "sweep":
        w = rng.uniform(0.85, 0.999, (b, s, h, d))
    elif decays == "full_width":
        w = np.exp(-np.exp(0.63 * rng.standard_normal((b, s, h, d))))
    else:
        w = rng.choice([0.0, 1e-30, 1.0 - 1e-7, 1.0], (b, s, h, d))
    u = rng.standard_normal((h, d))
    s0 = rng.standard_normal((b, h, d, d)) * 0.3 if carried else None
    return [None if x is None else
            torch.from_numpy(np.asarray(x, np.float32)).to(card)
            for x in (r, k, v, w, u, s0)]


def _wkv_routes():
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
    assert after[which] == before[which] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    return out


@pytest.mark.parametrize("decays", ["sweep", "full_width", "edges"])
@pytest.mark.parametrize("b,s,h,d,carried", [
    (1, 64, 1, 16, True), (2, 128, 2, 32, True), (1, 256, 4, 64, True),
    (2, 96, 2, 32, True), (2, 96, 2, 32, False), (3, 1, 5, 64, True),
    (1, 1000, 3, 64, False), (2, 33, 64, 64, True), (2, 15, 3, 32, True),
    (2, 15, 3, 64, False), (1, 16, 2, 64, True), (1, 17, 2, 16, False)])
def test_wkv6_matches_plain_version_on_card(card, b, s, h, d, carried,
                                           decays):
    """Each case through the route its S picks (per-token below 16
    tokens, chunked from 16), checked by the route counters."""
    from repro_torch.kernels.rwkv6_scan import ref as wref
    r, k, v, w, u, s0 = _wkv(card, b, s, h, d, b * s + d, decays, carried)
    y, sf = _wkv_on_its_route(r, k, v, w, u, s0)
    want_y, want_s = wref.wkv6(r, k, v, w, u, s0 if carried else
                               torch.zeros((b, h, d, d), device=card))
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    torch.testing.assert_close(y, want_y, atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(sf, want_s, atol=WKV_TOL, rtol=WKV_TOL)


def _scan(card, b, s, di, n, dtype, seed, carried=True):
    rng = np.random.default_rng(seed)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(card)  # noqa: E731
    u = f(rng.standard_normal((b, s, di))).to(dtype)
    dt = f(rng.uniform(0.001, 0.1, (b, s, di))).to(dtype)
    a = f(-rng.uniform(0.5, 2.0, (di, n)))
    bb = f(rng.standard_normal((b, s, n))).to(dtype)
    c = f(rng.standard_normal((b, s, n))).to(dtype)
    h0 = f(rng.standard_normal((b, di, n)) * 0.2) if carried else None
    return u, dt, a, bb, c, h0


def assert_scan_close(y, h, want_y, want_h, dtype):
    """h (float32) within 5e-5; y within 5e-5 in f32, and in bf16 within
    one bf16 rounding of the plain version's float32 y (its last bit may
    flip where the two float32 sums round to either side of a bf16
    boundary)."""
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(h, want_h, atol=SCAN_TOL, rtol=SCAN_TOL)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want_y, atol=SCAN_TOL, rtol=SCAN_TOL)
    else:
        torch.testing.assert_close(y.float(), want_y.to(dtype).float(),
                                   atol=SCAN_TOL, rtol=2 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,di,n,carried", [
    (1, 64, 64, 8, True), (2, 128, 128, 16, True), (1, 96, 256, 16, True),
    (1, 96, 256, 16, False), (2, 1, 200, 16, True), (1, 1000, 300, 4, True),
    (3, 65, 8192, 16, True), (2, 40, 1000, 16, True), (2, 33, 300, 8, True),
    (1, 17, 129, 5, False), (2, 16, 8192, 12, True), (2, 1, 8200, 16, False)])
def test_selective_scan_matches_plain_version_on_card(card, b, s, di, n,
                                                     carried, dtype):
    """Shapes on and off the kernel's grid: Di off its 128-channel blocks
    and N < 16, rows on the 16-byte grid (staged by cp.async) and off it
    (staged by plain loads), S = 1 and ragged S."""
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.mamba_scan import ref as mref
    u, dt, a, bb, c, h0 = _scan(card, b, s, di, n, dtype, s + di, carried)
    y, h = mk.selective_scan_3d(u, dt, a, bb, c, h0)
    want_y, want_h = mref.selective_scan(
        u, dt, a, bb, c, h0 if carried else
        torch.zeros((b, di, n), device=card))
    assert_scan_close(y, h, want_y, want_h, dtype)


def test_scans_reject_what_the_kernels_do_not_take(card):
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    r, k, v, w, u, s0 = _wkv(card, 1, 8, 2, 32, 1)
    with pytest.raises(TypeError, match="float32"):
        wk.wkv6_4d(r.bfloat16(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="head dim"):
        wk.wkv6_4d(*_wkv(card, 1, 8, 2, 48, 2))
    with pytest.raises(ValueError, match="contiguous"):
        wk.wkv6_4d(r.transpose(1, 2), k, v, w, u, s0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wk.wkv6_4d(r, k, v, w, u.cpu(), s0)
    xs = _scan(card, 1, 8, 64, 8, torch.float32, 3)
    with pytest.raises(TypeError, match="one dtype"):
        mk.selective_scan_3d(xs[0].bfloat16(), *xs[1:])
    big = _scan(card, 1, 8, 64, 17, torch.float32, 4)
    with pytest.raises(ValueError, match="N <= 16"):
        mk.selective_scan_3d(*big)
    with pytest.raises(ValueError, match="contiguous"):
        mk.selective_scan_3d(xs[0], xs[1], xs[2], xs[3].transpose(0, 1),
                             *xs[4:])


def test_scan_ops_route_cuda_tensors_to_the_kernels(card):
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.mamba_scan import ops as mops
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    before = (wk.launches, mk.launches)
    r, k, v, w, u, _ = _wkv(card, 1, 5, 2, 16, 5, carried=False)
    y, sf = wops.wkv6(r, k, v, w, u)
    xs = _scan(card, 1, 5, 32, 8, torch.bfloat16, 6, carried=False)
    ys, hs = mops.selective_scan(*xs[:5])
    assert (wk.launches, mk.launches) == (before[0] + 1, before[1] + 1)
    want_y, want_s = wops.wkv6(*(x.cpu() for x in (r, k, v, w, u)))
    torch.testing.assert_close(y.cpu(), want_y, atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(sf.cpu(), want_s, atol=WKV_TOL, rtol=WKV_TOL)
    want_ys, want_hs = mops.selective_scan(*(x.cpu() for x in xs[:5]))
    assert want_ys.dtype == ys.dtype == torch.bfloat16
    torch.testing.assert_close(hs.cpu(), want_hs, atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    assert (wk.launches, mk.launches) == (before[0] + 1, before[1] + 1)
    wk.reset_launch_count()
    mk.reset_launch_count()
    assert (wk.launches, mk.launches) == (0, 0)
    assert _wkv_routes() == {wk.CHUNKED: 0, wk.PER_TOKEN: 0}
    assert (mk.prefill_launches, mk.decode_launches) == (0, 0)


@pytest.mark.parametrize("s,which", [(1, "per_token"), (15, "per_token"),
                                     (16, "chunked"), (1000, "chunked")])
def test_wkv6_routes_by_sequence_length(card, s, which):
    """S alone picks the kernel, whatever the head dim or state."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    assert wk.route(s) == which
    for d, carried in ((64, True), (16, False)):
        before = _wkv_routes()
        wk.wkv6_4d(*_wkv(card, 2, s, 3, d, s + d, "sweep", carried))
        after = _wkv_routes()
        assert after[which] == before[which] + 1
        assert sum(after.values()) == sum(before.values()) + 1


def test_mamba_scan_counts_prefill_and_decode(card):
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    before = (mk.prefill_launches, mk.decode_launches)
    mk.selective_scan_3d(*_scan(card, 2, 1, 256, 16, torch.bfloat16, 1))
    mk.selective_scan_3d(*_scan(card, 2, 7, 256, 16, torch.bfloat16, 2))
    assert (mk.prefill_launches, mk.decode_launches) == (before[0] + 1,
                                                         before[1] + 1)


def _scan_cases(card):
    """(kernel, inputs, check against the plain version) for each route
    at moderate shapes."""
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.mamba_scan import ref as mref
    from repro_torch.kernels.rwkv6_scan import ref as wref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk

    def wkv_check(x, out):
        want = wref.wkv6(*x)
        for got, w in zip(out, want):
            torch.testing.assert_close(got, w, atol=WKV_TOL, rtol=WKV_TOL)

    def scan_check(x, out):
        assert_scan_close(*out, *mref.selective_scan(*x), x[0].dtype)

    cases = [(wk.wkv6_4d, _wkv(card, 2, s, 8, 64, s, "full_width"),
              wkv_check) for s in (1000, 1)]
    cases += [(mk.selective_scan_3d, _scan(card, 2, s, 8192, 16, dtype, s),
               scan_check)
              for s, dtype in ((300, torch.bfloat16), (1, torch.bfloat16),
                               (100, torch.float32))]
    return cases


def test_scans_launch_under_graph_capture(card):
    """Both scans, through each route, build nothing and allocate nothing
    but their outputs in a launch: a CUDA graph captures them and replays
    them on new inputs copied into the captured ones."""
    for kernel, x, check in _scan_cases(card):
        kernel(*x)                                   # warm: build, attrs
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kernel(*x)
        for scale in (0.5, 2.0):
            for t in (x[0], x[-1]):
                t.mul_(scale)
            graph.replay()
            torch.cuda.synchronize()
            check(x, out)


def test_scans_are_bitwise_repeatable(card):
    """No atomics and a fixed order of every sum: two launches on the same
    inputs give the same bits."""
    for kernel, x, _ in _scan_cases(card):
        first = kernel(*x)
        again = kernel(*x)
        assert torch.equal(first[0], again[0])
        assert torch.equal(first[1], again[1])


# -- the training path ----------------------------------------------------------------
def test_kernels_refuse_inputs_that_require_grad(card):
    """Flash attention and the scans have no backward pass: under grad
    mode a CUDA input that requires grad raises, naming the kernel, and
    launches nothing; it never returns a detached output."""
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.mamba_scan import ops as mops
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as wk
    q, kk, v = _qkv(card, 1, 64, 64, 4, 2, 64, torch.bfloat16, 7)
    wkv = _wkv(card, 1, 16, 2, 16, 8, carried=False)[:5]
    scan = _scan(card, 1, 16, 32, 8, torch.float32, 9, carried=False)[:5]
    calls = {"flash_attention": (lambda *x: fops.flash_attention(
                 *x, causal=True), [q, kk, v], lambda: fk.launches),
             "rwkv6_scan": (wops.wkv6, wkv, lambda: wk.launches),
             "mamba_scan": (mops.selective_scan, scan, lambda: mk.launches)}
    for name, (fn, xs, count) in calls.items():
        for i in range(len(xs)):
            args = [x.clone().requires_grad_(j == i)
                    for j, x in enumerate(xs)]
            before = count()
            with pytest.raises(RuntimeError,
                               match=f"{name} has no backward pass"):
                fn(*args)
            assert count() == before, name
            with torch.no_grad():
                out = fn(*args)
            assert count() == before + 1, name
            outs = out if isinstance(out, tuple) else (out,)
            assert not any(o.requires_grad for o in outs), name


def _reduced_state(device):
    from repro_torch.models import registry
    from repro_torch.train.step import init_train_state
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, _to(state, device)


def _to(tree, device):
    from repro_torch import _tree
    return _tree.tree_map(lambda t: t.to(device), tree)


def test_moment_compression_on_the_card_is_the_plain_versions(card):
    """compress_moments_int8 launches quantize_2d once per v leaf; codes
    and scales bitwise the plain version's on the same v on the CPU; the
    round trip within half a scale (and a few float32 roundings)."""
    from repro_torch import _tree
    from repro_torch.optim import adamw
    _, state = _reduced_state(card)
    opt = dict(state["opt"])
    opt["v"] = _tree.tree_map(lambda p: p.abs() * 0.05, state["params"])
    leaves = _tree.tree_leaves(opt["v"])
    k.reset_launch_counts()
    comp = adamw.compress_moments_int8(opt)
    torch.cuda.synchronize()
    assert k.launch_counts() == {"quantize": len(leaves), "dequantize": 0}
    plain = adamw.compress_moments_int8(_to(opt, "cpu"))
    assert k.launch_counts()["quantize"] == len(leaves)
    treedef = _tree.tree_flatten(opt["v"])[1]
    pages = _tree.tree_flatten_up_to(treedef, comp["v"])
    for got, want in zip(pages,
                         _tree.tree_flatten_up_to(treedef, plain["v"])):
        assert torch.equal(got["q"].cpu(), want["q"])
        assert torch.equal(got["scale"].cpu(), want["scale"])
        assert got["shape"] == want["shape"]
    back = adamw.decompress_moments_int8(comp)
    assert k.launch_counts()["dequantize"] == len(leaves)
    for v0, v1, page in zip(leaves, _tree.tree_leaves(back["v"]), pages):
        scale = page["scale"].reshape(-1)
        n = v0.numel()
        per_elem = scale.repeat_interleave(k.BLOCK)[:n].reshape(v0.shape)
        assert bool(((v1 - v0).abs() <= per_elem * (0.5 + 2 ** -14)).all())


def test_reduced_train_step_on_the_card_matches_the_cpu(card):
    """Two steps of reduced Qwen2 from one state on one batch, on the card
    and on the CPU (TF32 off): the loss within 1e-3 and the grad norm
    within 5e-2 relative, the tolerances tests/test_torch_train.py holds
    the port to against the reference (bf16 products accumulated in
    another order)."""
    from repro_torch.models import registry
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg, cpu_state = _reduced_state("cpu")
    batch = registry.make_train_batch(cfg, 32, 4, device="cpu")
    step = make_train_step(cfg, TrainConfig(
        optimizer=AdamWConfig(total_steps=10, warmup_steps=2),
        microbatches=2))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card_state = _to(cpu_state, card)
        card_batch = _to(batch, card)
        for _ in range(2):
            cpu_state, want = step(cpu_state, batch)
            card_state, got = step(card_state, card_batch)
            assert float(got["loss"]) == pytest.approx(
                float(want["loss"]), rel=1e-3)
            assert float(got["grad_norm"]) == pytest.approx(
                float(want["grad_norm"]), rel=5e-2)
            assert float(got["lr"]) == float(want["lr"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert int(card_state["opt"]["step"]) == 2
