"""The port's CUDA kernels (quant_cast and the streaming kernels) on the
card, against their plain PyTorch versions.  Marked ``cuda``: without a CUDA device each test skips, since a
CUDA kernel has no CPU mode.  This file imports no JAX, so it runs on the
GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

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
                                    (1024, 7500)])
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


def test_stream_ops_route_cuda_tensors_to_the_kernels(card):
    x = torch.from_numpy(_rows(3, 5000, 9)).to(card)
    before = sk.launch_counts()
    sops.window_minmax(x, True)
    sops.join_bounds(x[0], torch.sort(x[2]).values, 0.1)
    assert sk.launch_counts() == {
        "window_minmax": before["window_minmax"] + 1,
        "join_bounds": before["join_bounds"] + 1}
