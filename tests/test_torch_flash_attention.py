"""Flash attention's plain version (``kernels/flash_attention/ref.py``)
against the JAX package's Pallas kernel, run as that package's own tests
run it on the CPU (``ops.flash_attention``, interpret mode) and against
its oracle (``ref.gqa_attention``), on the same numpy-seeded inputs.

Tolerances are those of ``tests/test_kernels.py``: 2e-5 for float32 (the
softmax's exponentials and sums are taken in another order), 2e-2 for
bfloat16 (one bf16 rounding of outputs that differ in float32 by that
much).  The CUDA kernel itself is held against ``ref.py`` on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import flash_attention as k
from repro_torch.kernels.flash_attention import ops, ref

SWEEP = [(1, 128, 4, 4, 64), (2, 256, 4, 2, 64), (1, 512, 8, 2, 128),
         (2, 128, 6, 3, 32), (1, 384, 2, 1, 128)]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(b, s, t, hq, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, dh)).astype(np.float32),
            rng.standard_normal((b, t, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, t, hkv, dh)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(want, got, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,hq,hkv,dh", SWEEP)
def test_ref_matches_the_pallas_kernel(b, s, hq, hkv, dh, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, s, hq, hkv, dh, s + dh),
                                       dtype)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tq.shape
    _close(jops.flash_attention(jq, jk, jv, causal=True), got,
           DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,hq,hkv,dh", SWEEP)
def test_ref_matches_the_reference_oracle(b, s, hq, hkv, dh, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, s, hq, hkv, dh, dh), dtype)
    _close(jref.gqa_attention(jq, jk, jv, causal=True),
           ref.gqa_attention(tq, tk, tv, causal=True), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_non_causal(dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 128, 128, 2, 2, 64, 3), dtype)
    _close(jops.flash_attention(jq, jk, jv, causal=False),
           ops.flash_attention(tq, tk, tv, causal=False), DTYPES[dtype][2])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,t", [(100, 100), (200, 200), (200, 100),
                                 (100, 200)])
def test_ragged_lengths(s, t, causal):
    """Lengths off the 128 tile (the reference sends them to its oracle;
    the port's kernel takes them), S != T included: the causal mask is
    aligned at the top left in both packages."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, s, t, 4, 2, 64, s * t),
                                       "f32")
    _close(jops.flash_attention(jq, jk, jv, causal=causal),
           ops.flash_attention(tq, tk, tv, causal=causal), 2e-5)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    tq, tk, tv = (torch.from_numpy(a)
                  for a in _qkv(2, 64, 64, 4, 2, 32, 11))
    before = k.launches
    got = ops.flash_attention(tq, tk, tv)
    assert k.launches == before
    assert torch.equal(got, ref.gqa_attention(tq, tk, tv, causal=True))


def test_other_devices_raise():
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k.flash_attention_4d(q, q, q, True)
