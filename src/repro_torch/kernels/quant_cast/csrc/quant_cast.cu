// Blockwise int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels _quant_kernel and _dequant_kernel of
// src/repro/kernels/quant_cast/quant_cast.py:21,30 (quantize_2d and
// dequantize_2d).  One f32 scale per 128-wide row:
//   scale = absmax > 0 ? absmax * f32(1/127) : 1
//   q     = clamp(round_half_even(x / scale), -127, 127)
//   x'    = q * scale
// bit for bit as the plain version (ref.py) and the reference's compiled
// path compute it (XLA turns `absmax / 127.0` into a multiply by the f32
// reciprocal): IEEE division for x / scale (__fdiv_rn), round half to
// even (__float2int_rn), no fast math.
//
// What bounds it: device-memory bandwidth.  Quantize reads 4 B and writes
// 1 + 4/128 B per element; dequantize reads 1 + 4/128 B and writes 4 B.
// Each does a handful of operations per element, far below the card's
// compute rate.  The design keeps every byte to one pass: one warp owns
// one row, each lane moves 16 B of f32 (float4) and 4 B of int8 (char4)
// in one coalesced access, and the row's absmax never leaves registers
// (a five-step warp-shuffle reduction).
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;             // values per row == quant block
constexpr int kLanes = 32;              // kBlock / 4 values per lane
constexpr int kWarpsPerCta = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ signed char quant1(float v, float s) {
  int r = __float2int_rn(__fdiv_rn(v, s));
  r = min(max(r, -127), 127);
  return static_cast<signed char>(r);
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
quantize_rows(const float4* __restrict__ x, char4* __restrict__ q,
              float* __restrict__ scale, long long nb) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= nb) return;                // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const float4 v = x[row * kLanes + lane];
  float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                  fmaxf(fabsf(v.z), fabsf(v.w)));
  bool nan = isnan(v.x) || isnan(v.y) || isnan(v.z) || isnan(v.w);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  // fmaxf drops a NaN where jnp.max and torch.amax keep it; a kept NaN
  // absmax fails `absmax > 0`, so the plain version's scale is 1.
  nan = __any_sync(kFull, nan);
  const float s = (!nan && m > 0.0f) ? __fmul_rn(m, kInv127) : 1.0f;
  q[row * kLanes + lane] = make_char4(quant1(v.x, s), quant1(v.y, s),
                                      quant1(v.z, s), quant1(v.w, s));
  if (lane == 0) scale[row] = s;
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
dequantize_rows(const char4* __restrict__ q, const float* __restrict__ scale,
                float4* __restrict__ x, long long nb) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const float s = scale[row];
  const char4 c = q[row * kLanes + lane];
  x[row * kLanes + lane] = make_float4(
      __fmul_rn(static_cast<float>(c.x), s),
      __fmul_rn(static_cast<float>(c.y), s),
      __fmul_rn(static_cast<float>(c.z), s),
      __fmul_rn(static_cast<float>(c.w), s));
}

unsigned grid_for(long long nb) {
  return static_cast<unsigned>((nb + kWarpsPerCta - 1) / kWarpsPerCta);
}

}  // namespace

static_assert(kBlock == 4 * kLanes, "one float4 per lane covers a row");

// x: (nb, 128) f32, 16-byte aligned -> q: (nb, 128) int8, scale: (nb,) f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_quantize_rows(const void* x, void* q, void* scale,
                                   long long nb, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows<<<grid_for(nb), kWarpsPerCta * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<char4*>(q),
      static_cast<float*>(scale), nb);
  return static_cast<int>(cudaGetLastError());
}

// q: (nb, 128) int8, scale: (nb,) f32 -> x: (nb, 128) f32.
extern "C" int repro_dequantize_rows(const void* q, const void* scale,
                                     void* x, long long nb, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dequantize_rows<<<grid_for(nb), kWarpsPerCta * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(q), static_cast<const float*>(scale),
      static_cast<float4*>(x), nb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
