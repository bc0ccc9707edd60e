"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Marked ``cuda``: without a CUDA device each test skips, since a
CUDA kernel has no CPU mode.  This file imports no JAX, so it runs on the
GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.quant_cast import ops, ref
from repro_torch.kernels.quant_cast import quant_cast as k

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
