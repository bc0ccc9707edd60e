// The Mamba-1 selective scan for Hopper (sm_90a), float32 math on the CUDA
// cores.
//
// Replaces the Pallas TPU kernel _scan_kernel of
// src/repro/kernels/mamba_scan/mamba_scan.py:31, launched by
// selective_scan_chunked (:76), with the initial state that its wrapper
// (mamba_scan/ops.py) folds in afterwards taken here as an input.  It
// computes the function of the reference's scan (mamba_scan/ref.py):
//   u, dt (B, S, Di) and b, c (B, S, N), float32 or bfloat16, read and
//   cast to float32; a (Di, N) float32; h_0 (B, Di, N) float32 or zero;
//   h_t = exp(dt_t a) h_{t-1} + (dt_t u_t) b_t,   y_t = h_t . c_t
// and returns y (B, S, Di) in u's type and the final h (B, Di, N)
// float32.  Every S >= 1, Di >= 1 and 1 <= N <= 16 (the reference sent S
// or Di off its block grid to its oracle).
//
// Design: one thread owns one (batch, channel d) and keeps h[0:N] and
// a[d, 0:N] in registers (Mamba-1's full (Di, N) decay leaves no matrix
// form, as the TPU kernel's note says).  A block of 128 threads covers
// 128 channels of one batch row; it stages b_t and c_t of 64 tokens at a
// time in shared memory, where every thread of the block reads them (one
// address a read: a broadcast), and each thread loads its own u and dt,
// coalesced along d, one token ahead of its arithmetic.
//
// What bounds it: at Jamba's serve shape (B 8, S 1,024, Di 8,192, N 16,
// bf16) the function reads 2 x 134 MB of u and dt and writes 134 MB of
// y (b, c, a, h_0 and h are ~9 MB): 0.41 GB, 0.12 ms at 3.35 TB/s.  It
// does 1.07 G state updates, each a multiply and an exp for the decay,
// a multiply and a fused multiply-add for the update and a fused
// multiply-add for y: 7 float32 operations counting an exp as one and
// an FMA as two, 7.5 G in all, 0.11 ms at 67 TFLOP/s.  The exps go to
// the SFUs (16 a cycle an SM, ~0.25 ms for 1.07 G), so the exp rate,
// not the memory, is the nearer limit of this form; 65,536 threads
// (2,048 warps) run 1,024 dependent steps each.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;           // channels of a block
constexpr int kChunk = 64;              // tokens of b and c staged at once
constexpr int kMaxN = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ a, const T* __restrict__ bmat,
            const T* __restrict__ cmat, const float* __restrict__ h0,
            T* __restrict__ y, float* __restrict__ h_out, int s, int di,
            int n) {
  __shared__ float bs[kChunk][kMaxN];
  __shared__ float cs[kChunk][kMaxN];

  const int bi = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;             // the last block's spare threads
                                        // stage b and c but own no channel

  float av[kMaxN], h[kMaxN];
  const long long state_off = (static_cast<long long>(bi) * di + d) * n;
#pragma unroll
  for (int m = 0; m < kMaxN; ++m) {
    av[m] = live && m < n ? a[static_cast<long long>(d) * n + m] : 0.0f;
    h[m] = live && m < n && h0 != nullptr ? h0[state_off + m] : 0.0f;
  }

  // element d of token t: (bi * s + t) * di + d
  long long off = static_cast<long long>(bi) * s * di + d;
  float un = live ? to_f32(u[off]) : 0.0f;
  float dtn = live ? to_f32(dt[off]) : 0.0f;
  const long long bc_row0 = static_cast<long long>(bi) * s * n;

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int len = min(kChunk, s - t0);
    __syncthreads();                    // the last chunk's reads are done
    for (int e = threadIdx.x; e < len * n; e += kThreads) {
      const long long g = bc_row0 + static_cast<long long>(t0) * n + e;
      bs[e / n][e % n] = to_f32(bmat[g]);
      cs[e / n][e % n] = to_f32(cmat[g]);
    }
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float ut = un, dtt = dtn;
      const long long cur = off;
      if (live && t0 + tt + 1 < s) {
        off += di;
        un = to_f32(u[off]);
        dtn = to_f32(dt[off]);
      }
      const float du = dtt * ut;
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < kMaxN; ++m) {
        if (m < n) {
          h[m] = fmaf(expf(dtt * av[m]), h[m], du * bs[tt][m]);
          acc = fmaf(h[m], cs[tt][m], acc);
        }
      }
      if (live) store(&y[cur], acc);
    }
  }

  if (live) {
#pragma unroll
    for (int m = 0; m < kMaxN; ++m)
      if (m < n) h_out[state_off + m] = h[m];
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* a,
                   const void* b, const void* c, const void* h0, void* y,
                   void* h_out, int bsz, int s, int di, int n,
                   cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, bsz);
  scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_out), s, di, n);
  return cudaGetLastError();
}

}  // namespace

// u, dt: (bsz, s, di) and b, c: (bsz, s, n), contiguous, all float32
// (is_bf16 = 0) or all bfloat16 (is_bf16 = 1); a: (di, n) float32; h0:
// (bsz, di, n) float32 or null (a zero initial state) -> y: (bsz, s, di)
// of u's type, h_out: (bsz, di, n) float32.  1 <= n <= 16 and bsz at
// most 65,535.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int repro_selective_scan(const void* u, const void* dt,
                                    const void* a, const void* b,
                                    const void* c, const void* h0, void* y,
                                    void* h_out, int bsz, int s, int di,
                                    int n, int is_bf16, void* stream) {
  if (bsz <= 0 || bsz > 65535 || s <= 0 || di <= 0 || n <= 0 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(u, dt, a, b, c, h0, y, h_out, bsz, s,
                                      di, n, st)
              : launch<float>(u, dt, a, b, c, h0, y, h_out, bsz, s, di, n,
                              st);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
