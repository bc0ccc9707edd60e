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
