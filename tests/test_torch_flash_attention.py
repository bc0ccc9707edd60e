"""Flash attention's plain version (``kernels/flash_attention/ref.py``)
against the JAX package's Pallas kernel, run as that package's own tests
run it on the CPU (``ops.flash_attention``, interpret mode) and against
its oracle (``ref.gqa_attention``), on the same numpy-seeded inputs.

Tolerances are those of ``tests/test_kernels.py``: 2e-5 for float32 (the
softmax's exponentials and sums are taken in another order), 2e-2 for
bfloat16 (one bf16 rounding of outputs that differ in float32 by that
much).  The CUDA kernels themselves are held against ``ref.py`` on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``; here the
tensor-core kernel's arithmetic (a bf16 P in its P.V) is emulated in
plain torch and held to the reference at the bf16 bound, and the choice
of kernel is checked as a function of dtype and head dim.
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


# -- the tensor-core kernel's arithmetic (csrc/flash_attention_sm90.cu) ---------
LOG2E = np.float32(1.4426950408889634)


def _emulate_tensor_core_kernel(q, kk, v, causal):
    """The tensor-core kernel's arithmetic in plain torch: 128-row q tiles
    and 128-key tiles (those past the causal diagonal skipped), float32
    scores, masked scores NEG_INF, the running max m in log2 units (the
    raw max times scale * log2(e)), p = exp2(s * scale * log2(e) - m) with
    the product and difference rounded once (the kernel's FFMA), float32
    l summed from the float32 p, P rounded to bf16 before a P.V
    accumulated in float32, and at the end acc / l (l == 0 -> 1) rounded
    to bf16."""
    b, s, hq, dh = q.shape
    t, hkv = kk.shape[1], kk.shape[2]
    group = hq // hkv
    scale_log2 = float(np.float32(np.float32(dh ** -0.5) * LOG2E))
    kf = kk.float().repeat_interleave(group, dim=2)      # (b, t, hq, dh)
    vf = v.float().repeat_interleave(group, dim=2)
    out = torch.empty_like(q)
    for q0 in range(0, s, 128):
        qt = q[:, q0:q0 + 128].float()                    # (b, r, hq, dh)
        rows = torch.arange(q0, q0 + qt.shape[1])
        m = torch.full((b, hq, qt.shape[1]), ref.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hq, qt.shape[1], dh))
        num_kb = -(-t // 128)
        if causal:
            num_kb = min(num_kb, (q0 + 127) // 128 + 1)
        for k0 in range(0, num_kb * 128, 128):
            cols = torch.arange(k0, min(k0 + 128, t))
            x = torch.einsum("brhd,bchd->bhrc", qt, kf[:, k0:k0 + 128])
            if causal:
                x = torch.where(cols[None, :] > rows[:, None], ref.NEG_INF,
                                x)
            m_new = torch.maximum(m, x.amax(-1) * scale_log2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2((x.double() * scale_log2
                            - m_new[..., None].double()).float())
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhrc,bchd->bhrd", p.bfloat16().float(), vf[:, k0:k0 + 128])
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        out[:, q0:q0 + 128] = (acc / l[..., None]).permute(0, 2, 1, 3).to(
            q.dtype)
    return out


def _qkv_saturated(b, s, t, hq, hkv, dh, seed):
    """Integer q and k in [-30, 30] (exact in bf16): scaled scores of
    standard deviation ~300, so each softmax row is near one-hot."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-30, 31, (b, s, hq, dh)).astype(np.float32),
            rng.integers(-30, 31, (b, t, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, t, hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("against", ["pallas", "oracle"])
@pytest.mark.parametrize("b,s,hq,hkv,dh,scores,causal", [
    (1, 256, 4, 1, 128, "unit", True),          # GQA 4:1, Dh 128
    (1, 256, 6, 1, 64, "unit", True),           # GQA 6:1, Dh 64
    (2, 200, 4, 1, 128, "unit", True),          # ragged S
    (1, 256, 4, 2, 64, "unit", False),
    (1, 256, 4, 1, 128, "saturated", True),
    (1, 200, 6, 1, 64, "saturated", True),
    (1, 256, 12, 2, 128, "saturated", False)])
def test_tensor_core_arithmetic_holds_the_bf16_bound(b, s, hq, hkv, dh,
                                                      scores, causal,
                                                      against):
    """A bf16 P before P.V keeps the kernel within the 2e-2 that bf16
    outputs are held to, at unit-scale scores and where every softmax row
    saturates (the winning key's p is exactly 1.0, which bf16 holds)."""
    arrays = (_qkv_saturated if scores == "saturated" else _qkv)(
        b, s, s, hq, hkv, dh, s + hq + dh)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "bf16")
    got = _emulate_tensor_core_kernel(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    want = (jops.flash_attention if against == "pallas"
            else jref.gqa_attention)(jq, jk, jv, causal=causal)
    _close(want, got, DTYPES["bf16"][2])


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 128, k.TENSOR_CORE), (torch.bfloat16, 64, k.TENSOR_CORE),
    (torch.bfloat16, 32, k.CUDA_CORE), (torch.bfloat16, 16, k.CUDA_CORE),
    (torch.float32, 128, k.CUDA_CORE), (torch.float32, 64, k.CUDA_CORE),
    (torch.float32, 16, k.CUDA_CORE)])
def test_route_follows_dtype_and_head_dim(dtype, dh, want):
    assert k.route(dtype, dh) == want


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 128),
                                      (torch.float32, 32)])
def test_cpu_tensors_launch_neither_route(dtype, dh):
    tq, tk, tv = (torch.from_numpy(a).to(dtype)
                  for a in _qkv(1, 64, 64, 4, 2, dh, 12))
    before = (k.launches, k.tensor_core_launches, k.cuda_core_launches)
    got = ops.flash_attention(tq, tk, tv)
    assert (k.launches, k.tensor_core_launches,
            k.cuda_core_launches) == before
    assert torch.equal(got, ref.gqa_attention(tq, tk, tv, causal=True))
