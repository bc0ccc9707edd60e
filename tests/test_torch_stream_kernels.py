"""The streaming kernels' plain versions (``kernels/stream/ref.py``) against
the JAX package's Pallas kernels (``repro.stream.kernels``), run as that
package's own tests run them on the CPU: in interpret mode, at float64
(inside ``jax.enable_x64``).  The same numpy-seeded inputs go to both;
results must be equal bit for bit (NaN equal to NaN, the sign of a zero
included).  The CUDA kernels themselves are held against these plain
versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.stream import kernels as jk
from repro_torch.kernels.stream import ops, ref
from repro_torch.kernels.stream import stream as k


def assert_bits(want, got, what):
    """Equal float64 bit patterns; any NaN equals any NaN."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape, what
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got)), what
    np.testing.assert_array_equal(want[~nan].view(np.int64),
                                  got[~nan].view(np.int64), err_msg=what)


def _windows(w, size, seed):
    """Normal rows with a NaN in the second row, and a row of mixed signed
    zeros below non-positive values, a row of all -0.0 and one of +0.0
    and -0.0 above negatives when there is room."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((w, size))
    if w > 1:
        x[1, size // 2] = np.nan
    if w > 2:
        x[2] = -np.abs(x[2])
        x[2, ::2] = 0.0
        x[2, 1::2] = -0.0
    if w > 3:
        x[3] = -0.0
    if w > 4 and size > 1:
        x[4] = np.abs(x[4])
        x[4, 0], x[4, -1] = -0.0, 0.0
    return x


def _pallas_minmax(x, is_max):
    with jax.enable_x64(True):
        out = jk.window_minmax(jnp.asarray(x), is_max)
        assert out.dtype == jnp.float64
        return np.asarray(out)


@pytest.mark.parametrize("is_max", [False, True], ids=["min", "max"])
@pytest.mark.parametrize("w,size", [(1, 1), (1, 8), (7, 33), (13, 100),
                                    (8, 1), (5, 257)])
def test_window_minmax_plain_version_matches_pallas(w, size, is_max):
    x = _windows(w, size, seed=w * 1000 + size)
    got = ref.window_minmax(torch.from_numpy(x), is_max)
    assert got.dtype == torch.float64 and got.shape == (w,)
    assert_bits(_pallas_minmax(x, is_max), got.numpy(), (w, size, is_max))


@pytest.mark.parametrize("row,is_max,negative", [
    ([-0.0, 0.0], True, False), ([0.0, -0.0], True, False),
    ([-0.0, 0.0], False, True), ([0.0, -0.0], False, True),
    ([-0.0, -0.0], True, True), ([0.0, 0.0], False, False),
    ([-1.0, -0.0, 0.0, -2.0], True, False),
    ([1.0, 0.0, -0.0, 2.0], False, True)])
def test_signed_zeros_follow_the_compiled_path(row, is_max, negative):
    """XLA orders -0 < +0 in any position; numpy (the reference's
    interpreter) keeps whichever zero comes last.  The port follows the
    compiled path."""
    x = np.array([row])
    want = _pallas_minmax(x, is_max)
    got = ref.window_minmax(torch.from_numpy(x), is_max).numpy()
    assert_bits(want, got, row)
    assert bool(np.signbit(got[0])) == negative


def test_window_minmax_nan_propagates():
    x = np.array([[1.0, np.nan, 5.0], [np.nan, np.nan, np.nan],
                  [-np.inf, 2.0, np.inf]])
    for is_max in (False, True):
        got = ref.window_minmax(torch.from_numpy(x), is_max).numpy()
        assert np.isnan(got[:2]).all()
        assert got[2] == (np.inf if is_max else -np.inf)


def _keys(nl, nr, seed):
    """Sorted right keys with duplicates, and left keys that land exactly
    on both edges of their ``±tol`` band."""
    rng = np.random.default_rng(seed)
    tol = 0.5
    rs = np.sort(rng.integers(0, 40, nr).astype(np.float64) * 0.25)
    lt = rng.uniform(-1.0, 11.0, nl)
    edge = rs[rng.integers(0, nr, nl)]
    lt[::3] = edge[::3] + tol           # lt - tol ties a right key
    lt[1::3] = edge[1::3] - tol         # lt + tol ties a right key
    return lt, rs, tol


@pytest.mark.parametrize("nl,nr", [(1, 1), (7, 1), (5, 2), (130, 64),
                                   (300, 1000), (129, 2)])
def test_join_bounds_plain_version_matches_pallas(nl, nr):
    lt, rs, tol = _keys(nl, nr, seed=nl * 7919 + nr)
    with jax.enable_x64(True):
        lo, hi = jk.join_bounds(jnp.asarray(lt), jnp.asarray(rs), tol)
        lo, hi = np.asarray(lo), np.asarray(hi)
    got_lo, got_hi = ref.join_bounds(torch.from_numpy(lt),
                                     torch.from_numpy(rs), tol)
    assert got_lo.dtype == got_hi.dtype == torch.int32
    np.testing.assert_array_equal(got_lo.numpy(), lo)
    np.testing.assert_array_equal(got_hi.numpy(), hi)
    np.testing.assert_array_equal(
        lo, np.searchsorted(rs, lt - tol, side="left"))
    np.testing.assert_array_equal(
        hi, np.searchsorted(rs, lt + tol, side="right"))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 127, 128, 129, 450000,
                               524288])
def test_steps_match_the_reference(n):
    assert ops.steps(n) == jk._steps(max(n, 2)) + 1


def test_cpu_tensors_take_the_plain_versions():
    before = k.launch_counts()
    x = torch.from_numpy(_windows(3, 9, 1))
    assert_bits(ops.window_minmax(x, True).numpy(),
                ref.window_minmax(x, True).numpy(), "max")
    lt, rs, tol = _keys(10, 20, 2)
    lo, hi = ops.join_bounds(torch.from_numpy(lt), torch.from_numpy(rs),
                             tol)
    want = ref.join_bounds(torch.from_numpy(lt), torch.from_numpy(rs), tol)
    assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
    assert k.launch_counts() == before


def test_other_devices_and_host_tensors_are_refused():
    meta = torch.empty((2, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.window_minmax(meta, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.join_bounds(meta[0], meta[1], 0.5)
    x = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k.window_minmax_2d(x, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k.join_bounds_1d(x[0], x[1], 0.5, 2)


# -- the CUDA kernels' algorithms, written out in plain versions ------------
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


def _jax_bounds(lt, rs, tol):
    """The reference's join_bounds_ref and its Pallas kernel (interpret
    mode), as numpy."""
    with jax.enable_x64(True):
        ref_b = jk.join_bounds_ref(jnp.asarray(lt), jnp.asarray(rs), tol)
        pallas_b = jk.join_bounds(jnp.asarray(lt), jnp.asarray(rs), tol)
        return ([np.asarray(v) for v in ref_b],
                [np.asarray(v) for v in pallas_b])


def _ordered(ts, order, rng):
    """Timestamps sorted, within +-2 places of sorted (arrival order under
    the paired feed's jitter), or shuffled."""
    if order == "jitter":
        return ts[np.argsort(np.arange(ts.size) + rng.uniform(-2, 2, ts.size),
                             kind="stable")]
    if order == "shuffled":
        return rng.permutation(ts)
    return ts


@st.composite
def _join_cases(draw):
    """Sorted right keys on a quarter grid, evenly spread with many
    duplicates or few, or skewed (so that a guess from the ends is far
    off); left keys spread over them, a third tied to a right key at the
    low edge of their band and a third at the high edge, in one of three
    orders, with +-inf keys or without; a tolerance of 0, positive or
    negative; the kernel's block (not a divisor of every nl) and
    shared-memory budget drawn small, so that small inputs take every
    route."""
    nr = draw(st.sampled_from([1, 2, 40, 150]))
    nl = draw(st.sampled_from([1, 31, 97, 200]))
    tol = draw(st.sampled_from([0.0, 0.25, 0.5, 2.0, -0.5]))
    order = draw(st.sampled_from(["sorted", "jitter", "shuffled"]))
    spread = draw(st.sampled_from(["dups", "even", "skewed"]))
    inf = draw(st.booleans())
    block = draw(st.sampled_from([8, 32, 64]))
    budget = draw(st.sampled_from([2, 3, 16, 64]))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    if spread == "skewed":
        rs = np.sort(np.round(np.exp(rng.uniform(0.0, 8.0, nr)) * 4) / 4)
    else:
        span = max(nr // 4, 1) if spread == "dups" else 4 * nr
        rs = np.sort(rng.integers(0, span, nr) * 0.25)
    ts = rng.uniform(rs[0] - 1.0, rs[-1] + 1.0, nl)
    edge = rs[rng.integers(0, nr, nl)]
    ts[::3] = edge[::3] + tol
    ts[1::3] = edge[1::3] - tol
    lt = _ordered(np.sort(ts), order, rng)
    if inf and nl > 1:
        lt[rng.integers(0, nl, 2)] = [np.inf, -np.inf]
    return lt, rs, tol, block, budget


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(_join_cases())
def test_narrowed_join_bounds_match_the_reference_bitwise(case):
    lt, rs, tol, block, budget = case
    lo, hi, routes = ref.join_bounds_narrowed(
        torch.from_numpy(lt), torch.from_numpy(rs), tol, block, budget)
    assert lo.dtype == hi.dtype == torch.int32
    assert sum(routes.values()) == -(-lt.size // block)
    (want_lo, want_hi), (p_lo, p_hi) = _jax_bounds(lt, rs, tol)
    for want in ((want_lo, want_hi), (p_lo, p_hi)):
        np.testing.assert_array_equal(lo.numpy(), want[0])
        np.testing.assert_array_equal(hi.numpy(), want[1])


@pytest.mark.parametrize("budget,route", [(64, "staged"), (63, "wide")])
def test_narrowed_join_bounds_at_the_budget_and_one_key_over(budget, route):
    """One block of 64 left keys 20 .. 83 under tol 0.5 reaches exactly
    the 64 right keys 20 .. 83: staged in a budget of 64, one key over a
    budget of 63 (the wide route)."""
    rs = np.arange(100, dtype=np.float64)
    lt = np.random.default_rng(3).permutation(np.arange(20.0, 84.0))
    lo, hi, routes = ref.join_bounds_narrowed(
        torch.from_numpy(lt), torch.from_numpy(rs), 0.5, 64, budget)
    assert routes == {"full": 0, "empty": 0, "staged": 0, "wide": 0,
                      route: 1}
    (want_lo, want_hi), (p_lo, p_hi) = _jax_bounds(lt, rs, 0.5)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), p_lo)


def test_narrowed_join_bounds_every_route_and_nan_keys():
    """Blocks that reach no right key, a short slice, a wide one, and one
    holding NaN keys, which search all of rs and find 0 as the
    reference's Pallas kernel answers (its searchsorted answers
    len(rs))."""
    rng = np.random.default_rng(4)
    rs = np.sort(rng.integers(0, 400, 300) * 0.5)
    lt = np.concatenate([np.full(16, -50.0),            # empty
                         np.sort(rng.uniform(10, 12, 16)),  # staged
                         rng.uniform(0, 200, 16),           # wide
                         rng.uniform(0, 200, 5)])           # full
    lt[-2] = np.nan
    lo, hi, routes = ref.join_bounds_narrowed(
        torch.from_numpy(lt), torch.from_numpy(rs), 0.5, 16, 32)
    assert routes == {"full": 1, "empty": 1, "staged": 1, "wide": 1}
    (want_lo, want_hi), (p_lo, p_hi) = _jax_bounds(lt, rs, 0.5)
    np.testing.assert_array_equal(lo.numpy(), p_lo)
    np.testing.assert_array_equal(hi.numpy(), p_hi)
    assert lo[-2] == hi[-2] == 0 and want_lo[-2] == rs.size
    fin = ~np.isnan(lt)
    np.testing.assert_array_equal(lo.numpy()[fin], want_lo[fin])
    np.testing.assert_array_equal(hi.numpy()[fin], want_hi[fin])


def _minmax_block_values(size, geo, part, loads=k.MINMAX_LOADS,
                         misaligned=False):
    """The values of a row that block ``part`` of a launch reads, by
    thread, in the kernel's (``minmax_rows``) arithmetic: where the row
    starts 8 bytes off the 16-byte grid, thread 0 takes the block's first
    value alone; then double2 ``j = l * threads + t`` for each of thread
    ``t``'s ``loads`` loads ``l``; the last thread takes an odd value
    left at the end."""
    begin = part * geo.chunk
    end = min(begin + geo.chunk, size)
    by_thread = [[] for _ in range(geo.threads)]
    i = begin
    if misaligned:
        by_thread[0].append(i)
        i += 1
    pairs = (end - i) // 2
    for t in range(geo.threads):
        for ld in range(loads):
            j = ld * geo.threads + t
            if j < pairs:
                by_thread[t] += [i + 2 * j, i + 2 * j + 1]
    if (end - i) % 2:
        by_thread[-1].append(end - 1)
    return by_thread


def _join_block_keys(nl, geo, block):
    """The left keys block ``block`` takes, by thread, in the kernel's
    (``join_bounds_blocks``) arithmetic: thread ``t``'s ``k``-th key is
    ``block * geo.block + k * threads + t``."""
    base = block * geo.block
    return [[base + kk * geo.threads + t for kk in range(geo.keys)
             if base + kk * geo.threads + t < nl]
            for t in range(geo.threads)]


@pytest.mark.parametrize("size", [1, 2, 2047, 2048, 2049, 7500, 8191, 8192,
                                  8193, 12345, 450000])
@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "unaligned"])
def test_minmax_geometry_reads_every_value_once(size, misaligned):
    """Every value of a row is read by exactly one thread of one block,
    no thread issues more than its loads (plus the block's lone first
    and last values), and a row that fits one block has no scratch and
    no counter."""
    geo = k.minmax_geometry(3, size)
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 512
    assert (geo.chunks - 1) * geo.chunk < size <= geo.chunks * geo.chunk
    if geo.chunks == 1:
        assert geo.scratch == geo.counters == 0
    else:
        assert geo.chunk % 2 == 0 and geo.threads == 256
        assert geo.scratch == 3 * geo.chunks and geo.counters == 3
    seen = np.zeros(size, np.int64)
    for part in range(geo.chunks):
        threads = _minmax_block_values(size, geo, part,
                                       misaligned=misaligned)
        assert len(threads) == geo.threads
        for t, values in enumerate(threads):
            lone = (t == 0 and misaligned) + (t == geo.threads - 1)
            assert len(values) <= 2 * k.MINMAX_LOADS + lone
            seen[values] += 1
    assert (seen == 1).all()
    if size <= 8192:
        assert geo.chunks == 1
    if size == 450000:
        assert geo.chunks == 110


@pytest.mark.parametrize("w,size,misaligned", [(5, 1, False),
                                               (5, 2049, True),
                                               (3, 5000, False),
                                               (2, 7500, True)])
@pytest.mark.parametrize("is_max", [False, True], ids=["min", "max"])
def test_minmax_split_rows_fold_to_the_reference_bits(w, size, misaligned,
                                                      is_max):
    """The kernel's split at one load a thread (so small rows split into
    blocks): each block's share reduced, the partials folded, bit for bit
    the reference's compiled min or max, signed zeros and NaN included."""
    x = _windows(w, size, seed=size)
    geo = k.minmax_geometry(w, size, loads=1)
    rows = torch.from_numpy(x)
    partials = []
    for part in range(geo.chunks):
        idx = [i for t in _minmax_block_values(size, geo, part, loads=1,
                                                 misaligned=misaligned)
               for i in t]
        partials.append(ref.window_minmax(rows[:, idx], is_max))
    got = ref.window_minmax(torch.stack(partials, 1), is_max)
    assert_bits(_pallas_minmax(x, is_max), got.numpy(), (w, size))


@pytest.mark.parametrize("nl", [1, 1023, 1024, 1025, 7500, 450000])
def test_join_geometry_takes_every_key_once(nl):
    geo = k.join_geometry(nl)
    assert geo.block == geo.threads * geo.keys
    assert (geo.blocks - 1) * geo.block < nl <= geo.blocks * geo.block
    seen = np.zeros(nl, np.int64)
    for b in range(geo.blocks):
        for keys in _join_block_keys(nl, geo, b):
            assert len(keys) <= geo.keys
            seen[keys] += 1
    assert (seen == 1).all()


def test_geometry_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        k.minmax_geometry(0, 5)
    with pytest.raises(ValueError):
        k.join_geometry(0)
