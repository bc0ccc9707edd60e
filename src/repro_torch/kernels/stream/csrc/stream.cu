// Streaming kernels for Hopper (sm_90a): the rolling min/max scan and the
// banded interval-join bound search of the compiled standing-query path.
//
// window_minmax replaces the Pallas TPU kernel _minmax_kernel of
// src/repro/stream/kernels.py:66 (window_minmax): per-row min or max of a
// (W, size) float64 block.  The result equals the reference's compiled
// path bit for bit: a NaN anywhere in a row propagates (as jnp.maximum /
// jnp.minimum do; fmax / fmin would drop it), and the two zeros are
// ordered -0 < +0 (XLA's max(-0, +0) is +0 and its min is -0, in either
// order), so min and max are exact and order-free and any split of a row
// gives the same bits.
//
// What bounds it: device-memory bandwidth, 8 bytes read per value and one
// compare-select per value, far below the f64 rate.  On the main path
// W = 1 and size = 450,000 (3.6 MB, about 1 us at 3.35 TB/s), so launch
// latency dominates; one block per row would leave 131 of 132 SMs idle.
// The design splits every row into kChunk-value chunks, one block each
// (about 220 blocks for the main path's row), reads each chunk once with
// coalesced 16-byte double2 loads through the read-only path, reduces in
// registers and with warp shuffles, and writes one partial per chunk; a
// second small launch folds each row's partials (skipped when a row fits
// one chunk, where the first launch writes the result directly).
//
// join_bounds replaces the Pallas TPU kernel _bounds_kernel of
// src/repro/stream/kernels.py:106 (join_bounds): for every left key lt[i]
// the [lo, hi) slice of the sorted right keys rs within [lt - tol,
// lt + tol], i.e. searchsorted(rs, lt - tol, left) and searchsorted(rs,
// lt + tol, right).  Each thread runs the reference's two branchless
// bisections of `steps` iterations on exact float64 compares (v < target
// for lo, v <= target for hi, with the mid < hi guard), with lt - tol and
// lt + tol rounded to nearest as the reference computes them (no fast
// math, no contraction).
//
// What bounds it: not its bytes (8 B per key in, 8 B out), but the
// latency of 2 * steps dependent loads per left key (steps = 20 at the
// main path's 450,000 right keys).  The design gives every left key its
// own thread so that enough independent chains are in flight to cover
// that latency, and reads the sorted keys through __ldg so the top levels
// of the implicit search tree stay in L1/L2 across threads.
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;            // values of one row per block
constexpr unsigned kFull = 0xffffffffu;

template <bool kMax>
__device__ __forceinline__ double pick(double a, double b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a == b) {
    // equal values differ at most in the sign of zero: max keeps +0,
    // min keeps -0
    const bool negative = signbit(a);
    return negative != kMax ? a : b;
  }
  return kMax ? (a > b ? a : b) : (a < b ? a : b);
}

template <bool kMax>
__device__ __forceinline__ double block_reduce(double acc) {
  __shared__ double warp_acc[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = pick<kMax>(acc, __shfl_xor_sync(kFull, acc, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_acc[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_acc[lane < kWarps ? lane : 0];
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      acc = pick<kMax>(acc, __shfl_xor_sync(kFull, acc, off));
  }
  return acc;                           // valid in thread 0
}

// Block b reduces chunk (b % chunks) of row (b / chunks) into dst[b].
template <bool kMax>
__global__ void __launch_bounds__(kThreads)
minmax_chunks(const double* __restrict__ x, double* __restrict__ dst,
              int size, int chunks) {
  const long long row = blockIdx.x / chunks;
  const int begin = (blockIdx.x % chunks) * kChunk;
  const int end = min(begin + kChunk, size);
  const double* p = x + row * size;
  double acc = kMax ? -CUDART_INF : CUDART_INF;
  int i = begin;
  // a row of odd length leaves every other row 8 bytes off the 16-byte
  // grid: take one value alone, then the rest as double2
  if (reinterpret_cast<uintptr_t>(p + i) & 15) {
    if (threadIdx.x == 0) acc = pick<kMax>(acc, __ldg(p + i));
    ++i;
  }
  const int pairs = (end - i) >> 1;
  const double2* v = reinterpret_cast<const double2*>(p + i);
  for (int j = threadIdx.x; j < pairs; j += kThreads) {
    const double2 d = __ldg(v + j);
    acc = pick<kMax>(acc, pick<kMax>(d.x, d.y));
  }
  if (((end - i) & 1) && threadIdx.x == kThreads - 1)
    acc = pick<kMax>(acc, __ldg(p + end - 1));
  acc = block_reduce<kMax>(acc);
  if (threadIdx.x == 0) dst[blockIdx.x] = acc;
}

// Block r folds the `chunks` partials of row r into out[r].
template <bool kMax>
__global__ void __launch_bounds__(kThreads)
minmax_fold(const double* __restrict__ partial, double* __restrict__ out,
            int chunks) {
  const double* p = partial + static_cast<long long>(blockIdx.x) * chunks;
  double acc = kMax ? -CUDART_INF : CUDART_INF;
  for (int j = threadIdx.x; j < chunks; j += kThreads)
    acc = pick<kMax>(acc, p[j]);
  acc = block_reduce<kMax>(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

template <bool kMax>
cudaError_t minmax_launch(const double* x, double* out, double* scratch,
                          int w, int size, int chunks, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(w) * chunks;
  if (chunks == 1) {
    minmax_chunks<kMax><<<blocks, kThreads, 0, stream>>>(x, out, size, 1);
    return cudaGetLastError();
  }
  minmax_chunks<kMax><<<blocks, kThreads, 0, stream>>>(x, scratch, size,
                                                        chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  minmax_fold<kMax><<<w, kThreads, 0, stream>>>(scratch, out, chunks);
  return cudaGetLastError();
}

// The reference's branchless searchsorted: ties go right iff kRight.
template <bool kRight>
__device__ __forceinline__ int bisect(const double* __restrict__ rs, int n,
                                      int steps, double target) {
  int lo = 0, hi = n;
  for (int s = 0; s < steps; ++s) {
    const int mid = (lo + hi) >> 1;
    const double v = __ldg(rs + min(mid, n - 1));
    const bool go = (kRight ? v <= target : v < target) && mid < hi;
    lo = go ? mid + 1 : lo;
    hi = go ? hi : mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
join_bounds_rows(const double* __restrict__ lt,
                 const double* __restrict__ rs, double tol, int nl, int nr,
                 int steps, int* __restrict__ lo, int* __restrict__ hi) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nl) return;
  const double t = lt[i];
  lo[i] = bisect<false>(rs, nr, steps, __dsub_rn(t, tol));
  hi[i] = bisect<true>(rs, nr, steps, __dadd_rn(t, tol));
}

}  // namespace

static_assert(kChunk % 2 == 0,
              "a chunk starts 16-byte aligned iff its row does");

// Values of one row a block reduces (the wrapper sizes its scratch from it).
extern "C" int repro_window_minmax_chunk() { return kChunk; }

// x: (w, size) f64, contiguous -> out: (w,) f64.  scratch holds at least
// w * ceil(size / kChunk) doubles when a row spans more than one chunk.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int repro_window_minmax_rows(const void* x, void* out,
                                        void* scratch, long long scratch_len,
                                        int w, int size, int is_max,
                                        void* stream) {
  if (w <= 0 || size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (size + kChunk - 1) / kChunk;
  if (chunks > 1 && scratch_len < static_cast<long long>(w) * chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xs = static_cast<const double*>(x);
  auto* o = static_cast<double*>(out);
  auto* s = static_cast<double*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_max ? minmax_launch<true>(xs, o, s, w, size, chunks, st)
             : minmax_launch<false>(xs, o, s, w, size, chunks, st);
  return static_cast<int>(err);
}

// lt: (nl,) f64, rs: (nr,) f64 sorted ascending -> lo, hi: (nl,) int32.
extern "C" int repro_join_bounds_rows(const void* lt, const void* rs,
                                      double tol, int nl, int nr, int steps,
                                      void* lo, void* hi, void* stream) {
  if (nl <= 0 || nr <= 0 || steps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((nl + kThreads - 1) /
                                                kThreads);
  join_bounds_rows<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(lt), static_cast<const double*>(rs), tol,
      nl, nr, steps, static_cast<int*>(lo), static_cast<int*>(hi));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
