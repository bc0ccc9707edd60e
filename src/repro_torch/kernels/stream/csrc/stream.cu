// Streaming kernels for Hopper (sm_90a): the rolling min/max scan and the
// banded interval-join bound search of the compiled standing-query path.
// Each is one launch per call.  The launch geometry (threads, values or
// keys a block, blocks a row, scratch) is computed in Python
// (stream.py: minmax_geometry, join_geometry) and checked here.
//
// window_minmax replaces the Pallas TPU kernel _minmax_kernel of
// src/repro/stream/kernels.py:66 (window_minmax): per-row min or max of a
// (W, size) float64 block.  The result equals the reference's compiled
// path bit for bit: a NaN anywhere in a row propagates (as jnp.maximum /
// jnp.minimum do; fmax / fmin would drop it), and the two zeros are
// ordered -0 < +0 (XLA's max(-0, +0) is +0 and its min is -0, in either
// order), so min and max are exact and order-free and any split of a row
// gives the same bits (pick).
//
// What bounds it: device memory, 8 bytes read per value, one compare-
// select per value.  On the main path a row is one hour (450,000 values,
// 3.6 MB, about 1 us at 3.35 TB/s) or one minute (7,500, 60 KB), W = 1:
// both are far below the volume that hides the memory's latency (by
// Little's law about 3 MB in flight at the full rate), so what costs is
// how many round trips to memory and how many launches a call takes.
// The design: every thread issues all of its loads (kMinmaxLoads 16-byte
// double2 loads, unrolled) before its first compare, so a block asks for
// its whole share of the row at once; a row of up to 2 x kMinmaxLoads x
// 512 values is one block's share (one launch, one round trip, no
// scratch); a longer row is split into blocks of 2 x kMinmaxLoads x 256
// values, all resident at once (110 blocks at 450,000), so the whole row
// is in flight.  The fold of a split row's partials is in the same
// launch: each block writes its partial, fences, and takes a ticket from
// the row's arrival counter; the block that arrives last folds the row's
// partials (read through L2) and writes the result, the partials ordered
// before the tickets and after the last one by acq_rel fences (a
// sequentially consistent __threadfence costs more).  atomicInc wraps the
// counter to 0 on the last arrival, so every launch leaves it zeroed for
// the next.  Why that is safe under streams and graphs: the wrapper holds
// one counter buffer per (device, stream), and launches on one stream run
// one after another; a launch captured into a CUDA graph gets a buffer of
// that capture's own, zeroed inside the graph, and CUDA never runs two
// launches of one graph at once.
//
// join_bounds replaces the Pallas TPU kernel _bounds_kernel of
// src/repro/stream/kernels.py:106 (join_bounds): for every left key lt[i]
// the [lo, hi) slice of the sorted right keys rs within [lt - tol,
// lt + tol], i.e. searchsorted(rs, lt - tol, left) and searchsorted(rs,
// lt + tol, right), with lt - tol and lt + tol rounded to nearest as the
// reference computes them (__dsub_rn, __dadd_rn: no contraction).  A
// searchsorted index is unique, so any exact lower and upper bound search
// gives the reference's bits.
//
// What bounds it: not its bytes (8 B per key in, 8 B per key out), but
// chains of dependent loads: a bisection over the 450,000 right keys of
// the main path is 20 levels deep, each a round trip to L2 or memory,
// and a key needs two.  The design shortens the chains.  A block takes
// kJoinBlock left keys (kJoinKeys a thread, coalesced) and reduces the
// smallest and largest of their targets; two warps find the slice [L, H)
// of rs that holds every answer (warp_bound: 32 probes around a guess at
// the place from rs's ends, then 32-way narrowing, two rounds for the
// main path's keys).  Keys near one
// another in time, as the main path's are, need a short slice: when it
// holds at most kJoinBudget keys, the block stages it in shared memory
// with cp.async; a wider one (keys far apart, as when shuffled) stays in
// device memory.  In the slice each lower bound starts from a guess at
// its place from the slice's ends (timestamps are nearly evenly spaced)
// and gallops towards the bound (1, 2, 4, ... keys away), and each upper
// bound gallops on from its key's lower bound (every key before it lies
// below lt - tol <= lt + tol, and a band holds few keys); both bisect the
// last step, the thread's kJoinKeys chains in flight together.  A poor
// guess costs probes, never another answer.  A block whose targets are
// not all finite bisects the whole of rs twice with the reference's
// `steps` levels, so NaN and +-inf keys keep the answers the reference's
// kernel gives them (a NaN target finds 0).  Every route searches the same
// sorted keys for the same unique index; which one a block takes depends
// on its data.  64 registers a thread let the main path's 440 blocks be
// resident at once, four an SM.
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// -- window_minmax -----------------------------------------------------------
constexpr int kMinmaxLoads = 8;         // double2 loads a thread, in flight
constexpr int kMinmaxMaxThreads = 512;
constexpr int kFoldLoads = 4;           // partials a lane of the fold loads

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

// The block's min or max, valid in warp 0 (any blockDim that is a
// multiple of 32).
template <bool kMax>
__device__ __forceinline__ double block_pick(double acc) {
  __shared__ double warp_acc[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = pick<kMax>(acc, __shfl_xor_sync(kFull, acc, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_acc[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_acc[lane < (blockDim.x >> 5) ? lane : 0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = pick<kMax>(acc, __shfl_xor_sync(kFull, acc, off));
  }
  return acc;
}

// Block b reduces values [part * chunk, part * chunk + chunk) of row
// b / chunks (part = b % chunks).  With one block a row it writes the
// row's result; otherwise its partial, and warp 0 of the last of the
// row's blocks to arrive folds the partials into out.
template <bool kMax>
__global__ void __launch_bounds__(kMinmaxMaxThreads)
minmax_rows(const double* __restrict__ x, double* __restrict__ out,
            double* __restrict__ partial, unsigned* __restrict__ arrivals,
            int size, int chunk, int chunks) {
  const int row = blockIdx.x / chunks;
  const int part = blockIdx.x - row * chunks;
  const int begin = part * chunk;
  const int end = min(begin + chunk, size);
  const double* p = x + static_cast<long long>(row) * size;
  const double none = kMax ? -CUDART_INF : CUDART_INF;
  double acc = none;
  int i = begin;
  // a row of odd length leaves every other row 8 bytes off the 16-byte
  // grid (chunk is even, so every block of a row shares its row's
  // alignment): take one value alone, then the rest as double2
  if (reinterpret_cast<uintptr_t>(p + i) & 15) {
    if (threadIdx.x == 0) acc = __ldg(p + i);
    ++i;
  }
  const int pairs = (end - i) >> 1;
  const double2* v = reinterpret_cast<const double2*>(p + i);
  double2 d[kMinmaxLoads];
#pragma unroll
  for (int l = 0; l < kMinmaxLoads; ++l) {
    const int j = l * blockDim.x + threadIdx.x;
    d[l] = j < pairs ? __ldg(v + j) : make_double2(none, none);
  }
  if (((end - i) & 1) && threadIdx.x == blockDim.x - 1)
    acc = pick<kMax>(acc, __ldg(p + end - 1));
#pragma unroll
  for (int l = 0; l < kMinmaxLoads; ++l)
    acc = pick<kMax>(acc, pick<kMax>(d[l].x, d[l].y));
  acc = block_pick<kMax>(acc);
  if (threadIdx.x >= 32) return;        // the block's value is in warp 0
  if (chunks == 1) {
    if (threadIdx.x == 0) out[row] = acc;
    return;
  }
  // publish the partial, then take a ticket: the release fence orders
  // the partial before the ticket, the acquire fence the last block's
  // reads after it; the chunks-th arrival finds chunks - 1 and wraps the
  // counter to 0
  unsigned ticket = 0;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = acc;
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    ticket = atomicInc(arrivals + row, chunks - 1);
  }
  if (__shfl_sync(kFull, ticket, 0) != chunks - 1u) return;
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  // every lane takes the same number of rounds (no lane diverges into a
  // loop of dependent loads), each round's loads in flight together
  const double* q = partial + static_cast<long long>(row) * chunks;
  acc = none;
  for (int j0 = 0; j0 < chunks; j0 += 32 * kFoldLoads) {
    double v[kFoldLoads];
#pragma unroll
    for (int r = 0; r < kFoldLoads; ++r) {
      const int j = j0 + 32 * r + threadIdx.x;
      v[r] = j < chunks ? __ldcg(q + j) : none;
    }
#pragma unroll
    for (int r = 0; r < kFoldLoads; ++r) acc = pick<kMax>(acc, v[r]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = pick<kMax>(acc, __shfl_xor_sync(kFull, acc, off));
  if (threadIdx.x == 0) out[row] = acc;
}

// -- join_bounds -------------------------------------------------------------
constexpr int kJoinThreads = 256;
constexpr int kJoinKeys = 4;            // left keys a thread
constexpr int kJoinBlock = kJoinThreads * kJoinKeys;
constexpr int kJoinWarps = kJoinThreads / 32;
// right keys a block stages in shared memory (32 KB)
constexpr int kJoinBudget = 4096;
// 4 blocks an SM (at most 64 registers a thread): the main path's 440
// blocks all resident at once, none waiting for a second wave
constexpr int kJoinBlocksPerSM = 4;

// v lies before the bound: v < t for a lower bound, v <= t for an upper
template <bool kRight>
__device__ __forceinline__ bool before(double v, double t) {
  return kRight ? v <= t : v < t;
}

template <bool kShared>
__device__ __forceinline__ double fetch(const double* s, int i) {
  return kShared ? s[i] : __ldg(s + i);
}

// The length of the prefix of sorted rs[0, n) before t, found by one
// warp from a guess g in [0, n): first the lanes probe keys 0, 1, 3, 7,
// ... 32,767 after g and 1, 2, 4, ... 32,768 before it (a good guess
// leaves the bound between two neighbouring probes), then, while the
// range left is open, keys evenly spaced over it; each level the ballot
// of the probes before t narrows the range (32-fold once it is even; the
// probes cover every key once it is 32 wide).  Every lane returns it.
template <bool kRight>
__device__ int warp_bound(const double* __restrict__ rs, int n, double t,
                          int g) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;                   // the prefix ends in [lo, hi]
  int q = g + (lane < 16 ? -(1 << (15 - lane)) : (1 << (lane - 16)) - 1);
  q = min(max(q, 0), n - 1);
  for (;;) {
    const unsigned ahead =
        __ballot_sync(kFull, before<kRight>(__ldg(rs + q), t));
    const int c = __popc(ahead);        // lanes 0 .. c - 1: rs is sorted
    if (c > 0) lo = __shfl_sync(kFull, q, c - 1) + 1;
    if (c < 32) hi = __shfl_sync(kFull, q, c);
    if (lo >= hi) return lo;
    q = lo + static_cast<int>((static_cast<long long>(hi - lo) * lane) >> 5);
  }
}

// The place of t among n sorted keys running from r0 to r1, guessed as if
// they were evenly spaced: a float32 guess in [0, n), an end for NaN,
// infinite or out-of-range values.
__device__ __forceinline__ int guess_place(double t, double r0, double r1,
                                           int n) {
  const float scale =
      r1 > r0 ? __fdividef(static_cast<float>(n - 1),
                           static_cast<float>(r1 - r0))
              : 0.0f;
  const float at = static_cast<float>(t - r0) * scale;
  return at > 0.0f ? min(static_cast<int>(fminf(at, 2e9f)), n - 1) : 0;
}

// The reference's branchless searchsorted, `steps` levels, for each of N
// targets t[k] over its own range [lo[k], hi[k]) of s[0, m), m >= 1 (the
// answer known to lie in [lo[k], hi[k]]); all N chains advance together,
// and a chain whose range is at most 2^(steps - 1) long ends exact
// (lo[k] == hi[k]).
template <bool kRight, bool kShared, int N>
__device__ __forceinline__ void bisect(const double* s, int m, int steps,
                                       const double (&t)[N], int (&lo)[N],
                                       int (&hi)[N]) {
  for (int level = 0; level < steps; ++level) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int mid = static_cast<int>(
          (static_cast<unsigned>(lo[k]) + static_cast<unsigned>(hi[k])) >> 1);
      const bool go = before<kRight>(fetch<kShared>(s, min(mid, m - 1)),
                                     t[k]) && mid < hi[k];
      lo[k] = go ? mid + 1 : lo[k];
      hi[k] = go ? hi[k] : mid;
    }
  }
}

// ceil(log2(max(m, 2))) + 1, the reference's levels for m keys
__device__ __forceinline__ int levels(int m) {
  return 33 - __clz(max(m, 2) - 1);
}

// How far a gallop's probe reaches into the open range [lo, hi): step
// keys, at most the range (step < 2^31, as every range is).
__device__ __forceinline__ int reach(unsigned step, int lo, int hi) {
  return static_cast<int>(min(step, static_cast<unsigned>(hi - lo)));
}

// The lower bounds l[k] of a[k] in sorted s[0, m), m >= 1: each key's
// place is guessed from the slice's ends (guess_place; timestamps are
// nearly evenly spaced), then the search gallops from the guess
// towards the bound (probes 1, 2, 4, ... keys away, the thread's chains
// in flight together) and bisects the last step.  A poor guess costs
// more probes, never another answer.
template <bool kShared>
__device__ __forceinline__ void lower_bounds(const double* s, int m,
                                             const double (&a)[kJoinKeys],
                                             int (&l)[kJoinKeys]) {
  const double s0 = fetch<kShared>(s, 0), s1 = fetch<kShared>(s, m - 1);
  int e[kJoinKeys];
  bool right[kJoinKeys], open[kJoinKeys], any = false;
  double v[kJoinKeys];
#pragma unroll
  for (int k = 0; k < kJoinKeys; ++k) {
    e[k] = guess_place(a[k], s0, s1, m);
    v[k] = fetch<kShared>(s, e[k]);
  }
#pragma unroll
  for (int k = 0; k < kJoinKeys; ++k) {
    // the bound lies after the guess e[k], or at it or before
    right[k] = v[k] < a[k];
    l[k] = right[k] ? e[k] + 1 : 0;
    e[k] = right[k] ? m : e[k];
    open[k] = l[k] < e[k];
    any = any || open[k];
  }
  for (unsigned step = 1; any; step <<= 1) {
#pragma unroll
    for (int k = 0; k < kJoinKeys; ++k) {
      const int r = reach(step, l[k], e[k]);
      v[k] = open[k] ? fetch<kShared>(s, right[k] ? l[k] + r - 1 : e[k] - r)
                     : 0.0;
    }
    any = false;
#pragma unroll
    for (int k = 0; k < kJoinKeys; ++k) {
      if (!open[k]) continue;
      const int r = reach(step, l[k], e[k]);
      const int probe = right[k] ? l[k] + r - 1 : e[k] - r;
      if (v[k] < a[k]) {
        l[k] = probe + 1;
        open[k] = right[k] && l[k] < e[k];
      } else {
        e[k] = probe;
        open[k] = !right[k] && l[k] < e[k];
      }
      any = any || open[k];
    }
  }
  int span = 0;
#pragma unroll
  for (int k = 0; k < kJoinKeys; ++k) span = max(span, e[k] - l[k]);
  bisect<false, kShared>(s, m, levels(span), a, l, e);
}

// The upper bounds h[k] of b[k] in sorted s[0, m), given l[k], the lower
// bounds of a[k] <= b[k]: every key before l[k] is below a[k], so the
// answer is at or after it, and a band [a, b] holds few keys: gallop from
// l[k] (probes 1, 2, 4, ... keys on, in its cache line for a band of a
// few keys; the thread's chains in flight together), then bisect the
// last step.  For b < a (a negative tolerance) the answer is at or
// before l[k].
template <bool kShared>
__device__ __forceinline__ void upper_bounds(const double* s, int m,
                                             const double (&a)[kJoinKeys],
                                             const double (&b)[kJoinKeys],
                                             const int (&l)[kJoinKeys],
                                             int (&h)[kJoinKeys]) {
  int e[kJoinKeys];
  bool open[kJoinKeys], any = false;
#pragma unroll
  for (int k = 0; k < kJoinKeys; ++k) {
    const bool up = b[k] >= a[k];
    h[k] = up ? l[k] : 0;
    e[k] = up ? m : l[k];
    open[k] = up && h[k] < e[k];
    any = any || open[k];
  }
  for (unsigned step = 1; any; step <<= 1) {
    double v[kJoinKeys];
#pragma unroll
    for (int k = 0; k < kJoinKeys; ++k)
      v[k] = open[k] ? fetch<kShared>(s, h[k] + reach(step, h[k], e[k]) - 1)
                     : 0.0;
    any = false;
#pragma unroll
    for (int k = 0; k < kJoinKeys; ++k) {
      if (!open[k]) continue;
      const int probe = h[k] + reach(step, h[k], e[k]) - 1;
      if (v[k] <= b[k]) {
        h[k] = probe + 1;
        open[k] = h[k] < e[k];
      } else {
        e[k] = probe;
        open[k] = false;
      }
      any = any || open[k];
    }
  }
  int span = 0;
#pragma unroll
  for (int k = 0; k < kJoinKeys; ++k) span = max(span, e[k] - h[k]);
  bisect<true, kShared>(s, m, levels(span), b, h, e);
}

// Copy rs[0, m) into shared memory, all of the block's copies in flight.
__device__ __forceinline__ void stage(double* dst, const double* rs, int m) {
  for (int j = threadIdx.x; j < m; j += kJoinThreads) {
    const unsigned to =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + j));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(to), "l"(rs + j));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

__global__ void __launch_bounds__(kJoinThreads, kJoinBlocksPerSM)
join_bounds_blocks(const double* __restrict__ lt,
                   const double* __restrict__ rs, double tol, int nl,
                   int nr, int steps, int* __restrict__ lo,
                   int* __restrict__ hi) {
  // rs[L, H) when it fits: kJoinBudget keys, dynamic (on an H100 a static
  // array of that size ran the staged route ~1 % slower)
  extern __shared__ double slice[];
  __shared__ double warp_min[kJoinWarps], warp_max[kJoinWarps];
  __shared__ int warp_finite[kJoinWarps], range[2];
  const int base = blockIdx.x * kJoinBlock + threadIdx.x;
  // rs's ends, for the guesses of the block's range, read while the keys
  // are on their way
  const double r0 = __ldg(rs), r1 = __ldg(rs + nr - 1);
  double a[kJoinKeys], b[kJoinKeys];
  bool valid[kJoinKeys];
  double tmin = CUDART_INF, tmax = -CUDART_INF;
  bool finite = true;
#pragma unroll
  for (int k = 0; k < kJoinKeys; ++k) {
    const int i = base + k * kJoinThreads;
    valid[k] = i < nl;
    const double t = valid[k] ? __ldg(lt + i) : 0.0;
    a[k] = __dsub_rn(t, tol);
    b[k] = __dadd_rn(t, tol);
    if (valid[k]) {
      finite = finite && isfinite(a[k]) && isfinite(b[k]);
      tmin = fmin(tmin, fmin(a[k], b[k]));
      tmax = fmax(tmax, fmax(a[k], b[k]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    tmin = fmin(tmin, __shfl_xor_sync(kFull, tmin, off));
    tmax = fmax(tmax, __shfl_xor_sync(kFull, tmax, off));
  }
  finite = __all_sync(kFull, finite);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    warp_min[warp] = tmin;
    warp_max[warp] = tmax;
    warp_finite[warp] = finite;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kJoinWarps; ++w) {
    tmin = fmin(tmin, warp_min[w]);
    tmax = fmax(tmax, warp_max[w]);
    finite = finite && warp_finite[w];
  }
  int l[kJoinKeys], u[kJoinKeys], h[kJoinKeys];
  int first = 0;                        // rs index of the searched range
  if (!finite) {
    // the reference's two bisections over all of rs, as its kernel
#pragma unroll
    for (int k = 0; k < kJoinKeys; ++k) {
      l[k] = h[k] = 0;
      u[k] = nr;
    }
    bisect<false, false>(rs, nr, steps, a, l, u);
#pragma unroll
    for (int k = 0; k < kJoinKeys; ++k) u[k] = nr;
    bisect<true, false>(rs, nr, steps, b, h, u);
  } else {
    // every answer lies in [L, H]: L bounds the smallest target from
    // below, H the largest from above
    if (warp < 2) {
      const int at =
          warp == 0 ? warp_bound<false>(rs, nr, tmin,
                                        guess_place(tmin, r0, r1, nr))
                    : warp_bound<true>(rs, nr, tmax,
                                       guess_place(tmax, r0, r1, nr));
      if (lane == 0) range[warp] = at;
    }
    __syncthreads();
    first = range[0];
    const int m = range[1] - first;
    const double* rm = rs + first;
    if (m > 0 && m <= kJoinBudget) {
      stage(slice, rm, m);
      lower_bounds<true>(slice, m, a, l);
      upper_bounds<true>(slice, m, a, b, l, h);
    } else if (m > 0) {
      lower_bounds<false>(rm, m, a, l);
      upper_bounds<false>(rm, m, a, b, l, h);
    } else {
#pragma unroll
      for (int k = 0; k < kJoinKeys; ++k) l[k] = h[k] = 0;
    }
  }
#pragma unroll
  for (int k = 0; k < kJoinKeys; ++k) {
    const int i = base + k * kJoinThreads;
    if (valid[k]) {
      lo[i] = first + l[k];
      hi[i] = first + h[k];
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Double2 loads a thread of window_minmax issues (the wrapper's geometry
// is computed from it).
extern "C" int repro_window_minmax_loads() { return kMinmaxLoads; }

// Left keys a thread of join_bounds takes.
extern "C" int repro_join_bounds_keys() { return kJoinKeys; }

// Right keys a block of join_bounds stages in shared memory.
extern "C" int repro_join_bounds_budget() { return kJoinBudget; }

// x: (w, size) f64, contiguous -> out: (w,) f64, in blocks of `threads`
// threads, `chunks` blocks a row, each over `chunk` values.  With
// chunks > 1, partial holds w * chunks doubles and arrivals w counters,
// all 0.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_window_minmax_rows(const void* x, void* out,
                                        void* partial, void* arrivals,
                                        int w, int size, int chunk,
                                        int chunks, int threads, int is_max,
                                        void* stream) {
  const bool split = chunks > 1;
  if (w <= 0 || size <= 0 || chunk <= 0 || chunks <= 0 ||
      threads < 32 || threads > kMinmaxMaxThreads || threads % 32 ||
      chunk > 2 * kMinmaxLoads * threads ||
      static_cast<long long>(chunks - 1) * chunk >= size ||
      static_cast<long long>(chunks) * chunk < size ||
      static_cast<long long>(w) * chunks > 0x7fffffffLL ||
      (split && (chunk % 2 || partial == nullptr || arrivals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(w) * chunks;
  const auto* xs = static_cast<const double*>(x);
  auto* o = static_cast<double*>(out);
  auto* pp = static_cast<double*>(partial);
  auto* ap = static_cast<unsigned*>(arrivals);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_max)
    minmax_rows<true><<<blocks, threads, 0, st>>>(xs, o, pp, ap, size,
                                                  chunk, chunks);
  else
    minmax_rows<false><<<blocks, threads, 0, st>>>(xs, o, pp, ap, size,
                                                   chunk, chunks);
  return static_cast<int>(cudaGetLastError());
}

// lt: (nl,) f64, rs: (nr,) f64 sorted ascending -> lo, hi: (nl,) int32,
// in `blocks` blocks of kJoinThreads threads (`threads` must say so),
// each over kJoinBlock left keys.
extern "C" int repro_join_bounds_rows(const void* lt, const void* rs,
                                      double tol, int nl, int nr, int steps,
                                      int blocks, int threads, void* lo,
                                      void* hi, void* stream) {
  if (nl <= 0 || nr <= 0 || steps <= 0 || threads != kJoinThreads ||
      static_cast<long long>(blocks) * kJoinBlock < nl ||
      static_cast<long long>(blocks - 1) * kJoinBlock >= nl)
    return static_cast<int>(cudaErrorInvalidValue);
  join_bounds_blocks<<<blocks, kJoinThreads, kJoinBudget * sizeof(double),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(lt), static_cast<const double*>(rs), tol,
      nl, nr, steps, static_cast<int*>(lo), static_cast<int*>(hi));
  return static_cast<int>(cudaGetLastError());
}

// The capture in progress on `stream` (its id), or 0 when none is.
extern "C" unsigned long long repro_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                               &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}

// One launch of an empty kernel: the least a launch costs (measurement).
extern "C" int repro_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
