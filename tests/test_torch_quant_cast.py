"""The port's quant_cast against the JAX package's, on the same
numpy-seeded inputs: q codes and scales bitwise, including padding, zero
blocks, rows of widely varying scale, and int8 pages carried across in
both directions.  The CUDA kernel itself is checked against the plain
version on the card in ``test_torch_cuda.py``."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_cast import ops as jops
from repro.kernels.quant_cast import quant_cast as jk
from repro.kernels.quant_cast import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels.quant_cast import ops, ref
from repro_torch.kernels.quant_cast import quant_cast as k

SHAPES = [(1000,), (64, 128), (3, 7, 33), (8, 128), (5, 1024)]


def _inputs(shape, seed):
    """Normal data whose rows span twelve orders of magnitude, with the
    first 128-wide row zeroed when the tensor has more than one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    mags = 10.0 ** rng.integers(-6, 6, -(-flat.size // 128))
    flat *= np.repeat(mags, 128)[:flat.size].astype(np.float32)
    if flat.size > 128:
        flat[:128] = 0.0
    return x


def _jax_pad(x):
    flat = jnp.asarray(x, jnp.float32).reshape(-1)
    x2d, _ = jops._pad_to_tiles(flat)
    return x2d


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_bitwise_vs_jax(shape, seed):
    x = _inputs(shape, seed)
    q, scale = ops.quantize(torch.from_numpy(x))
    x2d = _jax_pad(x)
    # the reference's compiled path: the kernel in interpret mode, and
    # the ops.quantize its Migrator calls
    for want_q, want_s in (jk.quantize_2d(x2d, interpret=True),
                           jops.quantize(jnp.asarray(x))):
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q),
                                      strict=True)
        np.testing.assert_array_equal(scale.numpy(), np.asarray(want_s),
                                      strict=True)
    # the eager jnp oracle divides absmax by 127 where XLA multiplies by
    # the f32 reciprocal: its scales may differ in the last bit only
    qr, sr = jref.quantize_blocks(x2d)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr), strict=True)
    np.testing.assert_array_max_ulp(scale.numpy(), np.asarray(sr), 1)
    # the padding rows quantize to zero codes with scale 1
    n = x.size
    assert not q.reshape(-1)[n:].any()
    assert q.shape[0] % k.ROWS == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_dequantize_bitwise_vs_jax(shape):
    x = _inputs(shape, 7)
    q, scale = ops.quantize(torch.from_numpy(x))
    back = ops.dequantize(q, scale, shape)
    jq, js = jops.quantize(jnp.asarray(x))
    jback = jops.dequantize(jq, js, shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback),
                                  strict=True)
    assert back.dtype == torch.float32 and tuple(back.shape) == shape


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_pages_carried_across(direction):
    """An int8 page written by one package dequantizes identically in the
    other."""
    shape = (4, 300)
    x = _inputs(shape, 11)
    if direction == "jax_to_torch":
        jq, js = jops.quantize(jnp.asarray(x))
        q, scale = torch.from_numpy(np.array(jq)), torch.from_numpy(
            np.array(js))
    else:
        q, scale = ops.quantize(torch.from_numpy(x))
        jq, js = jnp.asarray(q.numpy()), jnp.asarray(scale.numpy())
    np.testing.assert_array_equal(
        ops.dequantize(q, scale, shape).numpy(),
        np.asarray(jops.dequantize(jq, js, shape)), strict=True)


def test_zero_block_and_nan_row_scales():
    x = np.zeros((3, 128), np.float32)
    x[1] = np.linspace(-2, 2, 128, dtype=np.float32)
    x[2, 5] = np.nan
    q, scale = ref.quantize_blocks(torch.from_numpy(x))
    qr, sr = jk.quantize_2d(jnp.asarray(np.concatenate(
        [x, np.zeros((5, 128), np.float32)])), interpret=True)
    sr, qr = np.asarray(sr)[:3], np.asarray(qr)[:3]
    np.testing.assert_array_equal(scale.numpy(), np.asarray(sr),
                                  strict=True)
    assert scale[0, 0] == 1.0 and scale[2, 0] == 1.0
    np.testing.assert_array_equal(q[:2].numpy(), np.asarray(qr)[:2])
    assert not q[0].any()


def test_quant_roundtrip_error_bound():
    x = _inputs((64, 128), 3)
    q, scale = ops.quantize(torch.from_numpy(x))
    back = ops.dequantize(q, scale, x.shape).numpy()
    # per row: |err| <= scale / 2 (scale = absmax / 127) plus the f32
    # rounding of x / scale and q * scale: the 0.51 of tests/test_kernels.py
    rows = np.abs(back - x).reshape(-1, 128).max(axis=1)
    absmax = np.abs(x).reshape(-1, 128).max(axis=1)
    assert np.all(rows <= absmax / 127.0 * 0.51)


def test_wrappers_take_only_cuda_tensors():
    before = k.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        k.quantize_2d(torch.zeros(8, 128))
    with pytest.raises(ValueError, match="CUDA"):
        k.dequantize_2d(torch.zeros(8, 128, dtype=torch.int8),
                        torch.ones(8, 1))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.quantize(torch.zeros(4, device="meta"))
    assert k.launch_counts() == before


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    script = tmp_path / "fake-nvcc"
    script.write_text("#!/bin/sh\necho 'error: no such target' >&2\n"
                      "exit 2\n")
    script.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.BuildError, match="no such target"):
        _build.load_library("quant_cast", k.SOURCES)
    assert list((tmp_path / "build").iterdir()) == []


@pytest.mark.parametrize("block", [64, 256])
def test_quantize_rejects_other_block_widths(block):
    with pytest.raises(ValueError, match="128 wide"):
        ops.quantize(torch.zeros(256), block=block)


def test_build_dir_follows_env_then_checkout(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    assert _build._build_dir() == tmp_path / "b"
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR")
    root = pathlib.Path(_build.__file__).resolve().parents[3]
    assert _build._build_dir() == root / "build" / "repro_torch"
