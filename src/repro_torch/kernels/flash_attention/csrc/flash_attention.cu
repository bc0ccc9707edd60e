// Flash attention for Hopper (sm_90a): causal or full GQA attention with a
// blockwise online softmax, float32 math on the CUDA cores.
//
// Replaces the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/flash_attention/flash_attention.py:31, launched by
// flash_attention (:102).  It computes what that kernel computes:
//   q (B, S, Hq, Dh), k and v (B, T, Hkv, Dh), f32 or bf16; q head h reads
//   kv head h / (Hq / Hkv); scores q.k * Dh**-0.5 in float32 from tiles
//   cast to float32; a causal mask aligned at the top left (key j is seen
//   by query i iff j <= i, whatever S and T are) whose masked scores take
//   NEG_INF = -1e30, not -inf; float32 m, l and acc carries; at the end
//   l == 0 becomes 1 and out = acc / l, rounded to the input type.
// Unlike the TPU kernel it takes every S and T: the ragged last tiles are
// masked here (no row past S is stored, no key past T is counted), where
// the reference sent such shapes to its oracle.
//
// Design: one block owns one (batch, q head, 64-row q tile); a loop inside
// the block walks the 64-key tiles in order (the TPU's sequential ki grid
// axis, its VMEM carries now registers), and stops at the diagonal under
// the causal mask, as `needed` skips the tiles above it.  The q tile is
// staged in shared memory once, transposed; each k and v tile is staged,
// cast to float32, then 256 threads (16 x 16) each compute a 4 x 4 piece
// of the 64 x 64 score tile, the row max and sum by shuffles across the 16
// threads that share a row, P to shared memory, and a 4 x (Dh / 16) piece
// of the output accumulator.  Heavy causal q tiles are launched first.
//
// What bounds it: at the serve shape (B 8, S = T 1,024, Hq 12, Hkv 2, Dh
// 128, bf16) the work is 25.8 GFLOP against 58.7 MB of inputs and outputs,
// so on the card's bf16 tensor cores it would be bound by operations (26.1
// us at 989 TFLOP/s).  This kernel does the math in float32 on the CUDA
// cores (67 TFLOP/s at most) because a bf16 P.V on the tensor cores would
// round P to bf16 and miss the float32 tolerance (2e-5) the reference
// holds, and its inner loops read both operands from shared memory (one
// vector and four or eight scalar loads per 16 or 32 FMAs), with up to
// 117 KB of shared memory per block so one block (8 warps) runs on an SM:
// it is bound by shared-memory bandwidth and latency, not by the card's
// peak, and is slow by design.  wgmma, TMA and a bf16 P.V are later work.
#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows of a block
constexpr int kBK = 64;                 // keys of a tile
constexpr int kThreads = 256;           // 16 x 16
constexpr int kQPad = kBQ + 4;          // transposed q and P rows (16-B aligned)
constexpr int kKPad = kBK + 1;          // transposed k rows (no bank conflicts)
constexpr float kNegInf = -1e30f;       // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int kDh>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kDh * kQPad + kDh * kKPad + kBK * kDh + kBK * kQPad);
}

// Copies rows [row0, row0 + 64) of one head of a (rows, heads, kDh) tensor
// into shared memory as float32, zero past `rows`; transposed (dst[d * pad
// + r]) when kTranspose, else row-major (dst[r * kDh + d]).
template <int kDh, bool kTranspose, typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int row0,
                                      int rows, long long row_stride,
                                      float* dst, int pad) {
  for (int e = threadIdx.x; e < kBQ * kDh; e += kThreads) {
    const int r = e / kDh;
    const int d = e % kDh;
    const int row = row0 + r;
    const float x = row < rows
                        ? to_f32(src[static_cast<long long>(row) *
                                         row_stride + d])
                        : 0.0f;
    if (kTranspose)
      dst[d * pad + r] = x;
    else
      dst[r * kDh + d] = x;
  }
}

template <int kDh, bool kCausal, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int s, int t,
             int hq, int hkv, float scale) {
  static_assert(kDh % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kCols = kDh / 16;        // output columns of a thread
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);  // [kDh][kQPad]
  float* const ks = qs + kDh * kQPad;                 // [kDh][kKPad]
  float* const vs = ks + kDh * kKPad;                 // [kBK][kDh]
  float* const ps = vs + kBK * kDh;                   // [kBK][kQPad]

  const int num_qb = gridDim.x;
  const int qb = num_qb - 1 - static_cast<int>(blockIdx.x);  // heavy first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qb * kBQ;
  const int ty = threadIdx.x / 16;       // rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % 16;       // key / column lanes tx + 16c

  const long long q_stride = static_cast<long long>(hq) * kDh;
  const long long kv_stride = static_cast<long long>(hkv) * kDh;
  const T* qh = q + (static_cast<long long>(b) * s) * q_stride +
                static_cast<long long>(h) * kDh;
  const T* kh = k + (static_cast<long long>(b) * t) * kv_stride +
                static_cast<long long>(hk) * kDh;
  const T* vh = v + (static_cast<long long>(b) * t) * kv_stride +
                static_cast<long long>(hk) * kDh;

  stage<kDh, true>(qh, q0, s, q_stride, qs, kQPad);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // tiles at or below the diagonal of this q tile (all under no mask),
  // and never past T
  int num_kb = (t + kBK - 1) / kBK;
  if (kCausal) num_kb = min(num_kb, (q0 + kBQ - 1) / kBK + 1);

  for (int kb = 0; kb < num_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();                     // the last tile's ks, vs, ps read
    stage<kDh, true>(kh, k0, t, kv_stride, ks, kKPad);
    stage<kDh, false>(vh, k0, t, kv_stride, vs, 0);
    __syncthreads();

    // scores of rows ty*4+i, keys tx+16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < kDh; ++d) {
      const float4 qv =
          *reinterpret_cast<const float4*>(&qs[d * kQPad + ty * 4]);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      float kr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kr[j] = ks[d * kKPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qr[i], kr[j], sc[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (kCausal && col > row) x = kNegInf;
        if (col >= t) x = kNegInf;       // not a key: p is zeroed below
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        p[i][j] = col < t ? expf(sc[i][j] - m_new) : 0.0f;
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&ps[(tx + 16 * j) * kQPad + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pv =
          *reinterpret_cast<const float4*>(&ps[j * kQPad + ty * 4]);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      float vr[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vr[c] = vs[j * kDh + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pr[i], vr[c], acc[i][c]);
    }
  }

  T* oh = o + (static_cast<long long>(b) * s) * q_stride +
          static_cast<long long>(h) * kDh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store(&oh[static_cast<long long>(row) * q_stride + tx + 16 * c],
            acc[i][c] / li);
  }
}

template <int kDh, bool kCausal, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int s, int t, int hq, int hkv, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<kDh>();
  auto* kernel = flash_kernel<kDh, kCausal, T>;
  // above 48 KB a kernel must be allowed its dynamic shared memory, once
  // per device; later launches (those a CUDA graph captures included)
  // make no call but the launch
  static std::atomic<unsigned long long> allowed{0};  // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  const dim3 grid((s + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, t, hq, hkv, scale);
  return cudaGetLastError();
}

template <int kDh, typename T>
cudaError_t dispatch_causal(const void* q, const void* k, const void* v,
                            void* o, int b, int s, int t, int hq, int hkv,
                            float scale, int causal, cudaStream_t stream) {
  return causal ? launch<kDh, true, T>(q, k, v, o, b, s, t, hq, hkv, scale,
                                       stream)
                : launch<kDh, false, T>(q, k, v, o, b, s, t, hq, hkv, scale,
                                        stream);
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o,
                        int b, int s, int t, int hq, int hkv, int dh,
                        float scale, int causal, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return dispatch_causal<16, T>(q, k, v, o, b, s, t, hq, hkv, scale,
                                    causal, stream);
    case 32:
      return dispatch_causal<32, T>(q, k, v, o, b, s, t, hq, hkv, scale,
                                    causal, stream);
    case 64:
      return dispatch_causal<64, T>(q, k, v, o, b, s, t, hq, hkv, scale,
                                    causal, stream);
    case 128:
      return dispatch_causal<128, T>(q, k, v, o, b, s, t, hq, hkv, scale,
                                     causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, s, hq, dh), k and v: (b, t, hkv, dh), contiguous, float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1) -> o: (b, s, hq, dh) of the same
// type.  dh is 16, 32, 64 or 128 and hq a multiple of hkv; scale is
// Dh**-0.5 rounded to float32, as the reference multiplies by it.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int s,
                                     int t, int hq, int hkv, int dh,
                                     float scale, int is_bf16, int causal,
                                     void* stream) {
  if (b <= 0 || s <= 0 || t <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 ||
      hq > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_dh<__nv_bfloat16>(q, k, v, o, b, s, t, hq, hkv, dh,
                                           scale, causal, st)
              : dispatch_dh<float>(q, k, v, o, b, s, t, hq, hkv, dh, scale,
                                   causal, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
