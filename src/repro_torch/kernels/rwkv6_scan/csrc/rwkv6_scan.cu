// WKV6 for Hopper (sm_90a): RWKV6's linear recurrence with per-channel,
// per-token decays, token by token, float32 math on the CUDA cores.
//
// Replaces the Pallas TPU kernel _wkv_kernel of
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py:33, launched by wkv6_chunked
// (:98), with the carry that its wrapper (rwkv6_scan/ops.py) folds in
// afterwards taken here as an input.  It computes the function of the
// reference's recurrence (rwkv6_scan/ref.py):
//   r, k, v, w (B, S, H, D) float32; u (H, D); S_0 (B, H, D, D) or zero;
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t
// and returns y (B, S, H, D) and the final S.
//
// Not the TPU kernel's chunked form.  That form factors the decay ratios
// of a chunk as exp(cumsum log w) and divides k by them: at RWKV6-7B's
// full width the reference's initializer gives decays down to ~3e-8, a
// 64-token chunk's cumulative log w falls below -87 in about a tenth of
// the channels, exp underflows float32 and k / A is infinite.  This
// kernel multiplies by w_t once a token, which is stable for any decay
// in [0, 1], and takes every S >= 1 (the reference sent S off its chunk
// grid to its oracle).
//
// Design: one block of D threads owns one (batch, head); thread j holds
// column j of S (D float32 values) in registers.  For each token the
// block stages r_t, k_t and w_t in shared memory (double-buffered, so
// one barrier a token suffices), each thread keeps v_t[j], and then
//   y_j = sum_i r_i (S_ij + u_i k_i v_j),   S_ij <- w_i S_ij + k_i v_j.
// The next token's four values are loaded into registers before this
// token's sums, so their latency hides behind the arithmetic; y's sum
// runs over four partial sums to shorten its chain of dependent adds.
//
// What bounds it: at the serve shape (B 8, S 1,024, H 64, D 64) the
// function reads 4 x 134 MB of r, k, v, w and writes 134 MB of y (S_0
// and S are 8.4 MB each): 0.69 GB, 0.21 ms at 3.35 TB/s; its 7 floating
// operations a state element a token (15.0 G) take 0.22 ms at the
// 67 TFLOP/s of float32 outside the tensor cores, so operations bound
// it, just.  One block a head runs its 1,024 tokens in order, each a
// barrier and a chain of 16 dependent adds: 512 blocks of two warps fill
// the card's SMs only four deep, so latency, not the card's peak, bounds
// this simple form.  The chunked form on the tensor cores, made stable
// (a per-chunk rescale), is later work.
#include <cuda_runtime.h>

namespace {

template <int kD>
__global__ void __launch_bounds__(kD)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int s, int h) {
  __shared__ float rs[2][kD];
  __shared__ float ks[2][kD];
  __shared__ float ws[2][kD];
  __shared__ float us[kD];

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh % h;
  const int j = threadIdx.x;

  // column j of this head's state, S[i][j] for i in [0, kD)
  float st[kD];
  const long long state_off = static_cast<long long>(bh) * kD * kD + j;
#pragma unroll
  for (int i = 0; i < kD; ++i)
    st[i] = s0 != nullptr ? s0[state_off + static_cast<long long>(i) * kD]
                          : 0.0f;
  us[j] = u[head * kD + j];

  // element j of token t: ((b * s + t) * h + head) * kD + j
  const long long row = static_cast<long long>(h) * kD;
  long long off = (static_cast<long long>(b) * s * h + head) * kD + j;
  float rn = r[off], kn = k[off], vn = v[off], wn = w[off];

  for (int t = 0; t < s; ++t) {
    const int buf = t & 1;
    rs[buf][j] = rn;
    ks[buf][j] = kn;
    ws[buf][j] = wn;
    const float vj = vn;
    const long long cur = off;
    if (t + 1 < s) {
      off += row;
      rn = r[off];
      kn = k[off];
      vn = v[off];
      wn = w[off];
    }
    // the buffer written two tokens ago was last read before the barrier
    // of the token between, so one barrier a token suffices
    __syncthreads();
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      const float kv = ks[buf][i] * vj;
      acc[i & 3] = fmaf(rs[buf][i], fmaf(us[i], kv, st[i]), acc[i & 3]);
      st[i] = fmaf(ws[buf][i], st[i], kv);
    }
    y[cur] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }

#pragma unroll
  for (int i = 0; i < kD; ++i)
    s_out[state_off + static_cast<long long>(i) * kD] = st[i];
}

template <int kD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* s_out, int b, int s, int h, cudaStream_t stream) {
  wkv6_kernel<kD><<<b * h, kD, 0, stream>>>(r, k, v, w, u, s0, y, s_out, s,
                                            h);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w: (b, s, h, d) float32, contiguous; u: (h, d); s0: (b, h, d, d)
// or null (a zero initial state) -> y: (b, s, h, d), s_out: (b, h, d, d).
// d is 16, 32 or 64; b * h is at most 2**31 - 1 blocks.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int b, int s, int h, int d,
                          void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 ||
      static_cast<long long>(b) * h > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  switch (d) {
    case 16:
      return static_cast<int>(launch<16>(f(r), f(k), f(v), f(w), f(u), f(s0),
                                         static_cast<float*>(y),
                                         static_cast<float*>(s_out), b, s, h,
                                         st));
    case 32:
      return static_cast<int>(launch<32>(f(r), f(k), f(v), f(w), f(u), f(s0),
                                         static_cast<float*>(y),
                                         static_cast<float*>(s_out), b, s, h,
                                         st));
    case 64:
      return static_cast<int>(launch<64>(f(r), f(k), f(v), f(w), f(u), f(s0),
                                         static_cast<float*>(y),
                                         static_cast<float*>(s_out), b, s, h,
                                         st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
