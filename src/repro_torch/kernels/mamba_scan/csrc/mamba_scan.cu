// The Mamba-1 selective scan for Hopper (sm_90a): staged tiles, exp2 on
// the SFU, one thread a channel.
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
// or Di off its block grid to its oracle).  Mamba-1's full (Di, N) decay
// leaves no matrix form (the TPU kernel's note says as much), so the
// scan stays a recurrence on the CUDA cores.
//
// Design:
// - Exponent: a is scaled by log2(e) once, at the block's start, and
//   each decay is ex2.approx.ftz(dt a'): one multiply and one MUFU.EX2 an
//   update, in place of expf's accurate routine (a range reduction on the
//   FMA pipe around its MUFU.EX2: ~21 instructions an update in the old
//   token loop's SASS, ~6.5 now, as repro_torch/kernels/_sass.py counts
//   them).
//   ex2.approx's relative error, ~2^-22, keeps the scan within the 5e-5
//   it is held to (ref.selective_scan_exp2 is the plain version;
//   tests/test_torch_scans.py holds it to the float64 scan).  Every exp
//   is computed once.
// - Work: a block of 128 threads owns 128 channels of one batch row,
//   one thread a channel with its N <= 16 states and decays in
//   registers: 16 independent chains a token, no shuffle, and the
//   token's shared loads (u, dt, and b and c as four 16-byte broadcasts
//   each) spread over 16 updates.  Splitting a channel's states over
//   lanes would double the warps in flight, but each lane would repeat
//   the token's loads for its share of the updates.
// - Memory: u and dt as [16 tokens x 128 channels] tiles and the
//   chunk's rows of b and c come into shared memory by cp.async, 16
//   bytes at a time, in a 2-stage ring (the next chunk's loads in flight
//   during this one's arithmetic; a third stage gained nothing and cost
//   float32 a block an SM); b and c are widened to float32 once a chunk;
//   y goes out through shared memory in 16-byte stores; h_0, a and h in
//   16-byte pieces.  Where a row does not lie on the 16-byte grid (Di or
//   N x the element size not a multiple of 16, or an unaligned tensor)
//   the same tiles are staged by plain loads.
//
// What bounds it: at Jamba's serve shape (B 8, S 1,024, Di 8,192, N 16,
// bf16) the function reads 2 x 134 MB of u and dt and writes 134 MB of
// y (b, c, a, h_0 and h are ~9 MB): 0.41 GB, 0.123 ms at 3.35 TB/s.  Its
// 1.07 G state updates need one exp each; the SFU gives 16 a cycle an
// SM, so with every exp on it the floor is ~0.256 ms at 1.98 GHz, above
// the bytes bound: the exp rate, not the memory, bounds this form.
//
// What holds it back, as measured (PERF.md): issue and latency more
// than the SFU.  The token loop issues ~104 instructions for its 16
// updates, as many as the SFU needs cycles for their 16 EX2; 512 blocks
// of four warps leave ~15.5 warps an SM to cover the MUFU and shared-
// load latencies and the chunk's three barriers; and with the exp made
// an FMA (a diagnostic variant of scan_variants.py) the kernel gains
// only ~10 %.  A
// polynomial exp2 on the FMA pipe for a share of the states would lower
// the SFU floor but add issue, which is as near.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kCh = 128;                // channels (threads) of a block
constexpr int kMinBlocks = 4;           // blocks an SM (caps registers)
constexpr int kT = 16;                  // tokens of a chunk
constexpr int kStages = 2;              // chunks in the ring
constexpr int kMaxN = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

template <typename T>
struct Smem {
  T u[kStages][kT][kCh];
  T dt[kStages][kT][kCh];
  T b[kStages][kT * kMaxN];             // the chunk's rows, N apart
  T c[kStages][kT * kMaxN];
  float4 bf[kT][kMaxN / 4];             // b, c widened, zero past N
  float4 cf[kT][kMaxN / 4];
  T y[kT][kCh];
};

template <typename T>
__global__ void __launch_bounds__(kCh, kMinBlocks)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ a, const T* __restrict__ bmat,
            const T* __restrict__ cmat, const float* __restrict__ h0,
            T* __restrict__ y, float* __restrict__ h_out, int s, int di,
            int n, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  constexpr int kE = 16 / sizeof(T);    // elements of a 16-byte piece

  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + tid;
  const bool live = d < di;             // the last block's spare channels
                                        // stage and compute on zeros
  const int nchunks = (s + kT - 1) / kT;
  const long long row0 = static_cast<long long>(bi) * s;      // token rows

  // u, dt: rows of kCh channels; b, c: kT * n contiguous values.  Every
  // loop over a tile runs a fixed count, so its index math folds.
  constexpr int kRow = kCh / kE;        // 16-byte pieces of a tile row
  constexpr int kTile = kT * kRow;      // ... of a u (or dt) tile
  constexpr int kBc = kT * kMaxN / kE;  // ... of the chunk's b, at most
  static_assert(kTile % kCh == 0, "whole tiles a pass");
  auto load_chunk = [&](int ch, int stage) {
    const int t0 = ch * kT;
    const int len = min(kT, s - t0);
    if (vec) {
      // a thread copies the same pieces of the u and dt tiles
#pragma unroll
      for (int it = 0; it < kTile / kCh; ++it) {
        const int e = tid + it * kCh;
        const int t = e / kRow, dd = (e % kRow) * kE;
        const bool valid = t < len && d0 + dd < di;
        const long long off = valid ? (row0 + t0 + t) * di + d0 + dd : 0;
        cp_async16(&sm.u[stage][t][dd], u + off, valid);
        cp_async16(&sm.dt[stage][t][dd], dt + off, valid);
      }
      // b's pieces on threads [0, kBc), c's on [kBc, 2 kBc)
      const int bc = len * n;           // the chunk's values of b (or c)
#pragma unroll
      for (int it = 0; it < (2 * kBc + kCh - 1) / kCh; ++it) {
        const int e = tid + it * kCh;
        const bool is_b = e < kBc;
        const int off = (is_b ? e : e - kBc) * kE;
        const bool valid = off < bc;
        const T* src = is_b ? bmat : cmat;
        const T* g = valid ? src + (row0 + t0) * n + off : src;
        if (e < 2 * kBc)
          cp_async16(is_b ? &sm.b[stage][off] : &sm.c[stage][off], g, valid);
      }
    } else {
      T zero;
      from_f32(&zero, 0.0f);
      for (int e = tid; e < 2 * kT * kCh; e += kCh) {
        const int which = e / (kT * kCh), rem = e % (kT * kCh);
        const int t = rem / kCh, dd = rem % kCh;
        const bool valid = t < len && d0 + dd < di;
        const T* src = which == 0 ? u : dt;
        const T x = valid ? src[(row0 + t0 + t) * di + d0 + dd] : zero;
        (which == 0 ? sm.u : sm.dt)[stage][t][dd] = x;
      }
      for (int e = tid; e < 2 * kT * n; e += kCh) {
        const int which = e / (kT * n), off = e % (kT * n);
        const T* src = which == 0 ? bmat : cmat;
        const T x = off < len * n ? src[(row0 + t0) * n + off] : zero;
        (which == 0 ? sm.b : sm.c)[stage][off] = x;
      }
    }
  };

  // this channel's states and its a in log2 units.  Where rows lie on
  // the 16-byte grid (n a multiple of 4), four states a load.
  float a2[kMaxN], h[kMaxN];
  const long long state_off = (static_cast<long long>(bi) * di + d) * n;
  const long long a_off = static_cast<long long>(d) * n;
  if (vec) {
#pragma unroll
    for (int f = 0; f < kMaxN / 4; ++f) {
      const int m = 4 * f;
      const bool on = live && m < n;
      const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 a4 =
          on ? *reinterpret_cast<const float4*>(a + a_off + m) : zero4;
      const float4 h4 =
          on && h0 != nullptr
              ? *reinterpret_cast<const float4*>(h0 + state_off + m)
              : zero4;
      a2[4 * f] = a4.x * kLog2e;
      a2[4 * f + 1] = a4.y * kLog2e;
      a2[4 * f + 2] = a4.z * kLog2e;
      a2[4 * f + 3] = a4.w * kLog2e;
      h[4 * f] = h4.x;
      h[4 * f + 1] = h4.y;
      h[4 * f + 2] = h4.z;
      h[4 * f + 3] = h4.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) {
      const bool on = live && m < n;
      a2[m] = on ? a[a_off + m] * kLog2e : 0.0f;
      h[m] = on && h0 != nullptr ? h0[state_off + m] : 0.0f;
    }
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nchunks) load_chunk(st, st);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int ch = 0; ch < nchunks; ++ch) {
    const int stage = ch % kStages;
    // the stage refilled here was last read in chunk ch - 1, before its
    // closing barrier
    if (ch + kStages - 1 < nchunks)
      load_chunk(ch + kStages - 1, (ch + kStages - 1) % kStages);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncthreads();                    // chunk ch is in, for every thread
    const int t0 = ch * kT;
    const int len = min(kT, s - t0);

    // b and c widened once for every lane (zero past N)
#pragma unroll
    for (int it = 0; it < 2 * kT * kMaxN / kCh; ++it) {
      const int e = tid + it * kCh;
      const int which = e / (kT * kMaxN), rem = e % (kT * kMaxN);
      const int t = rem / kMaxN, m = rem % kMaxN;
      const T* src = which == 0 ? sm.b[stage] : sm.c[stage];
      const float x = m < n && t < len ? to_f32(src[t * n + m]) : 0.0f;
      float* dst = reinterpret_cast<float*>(which == 0 ? sm.bf : sm.cf);
      dst[t * kMaxN + m] = x;
    }
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      const float dtt = to_f32(sm.dt[stage][t][tid]);
      const float du = dtt * to_f32(sm.u[stage][t][tid]);
      float acc[2] = {0.0f, 0.0f};
#pragma unroll
      for (int f = 0; f < kMaxN / 4; ++f) {
        const float4 b4 = sm.bf[t][f];
        const float4 c4 = sm.cf[t][f];
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float& hq = h[4 * f + q];
          hq = fmaf(ex2(dtt * a2[4 * f + q]), hq, du * bv[q]);
          acc[q & 1] = fmaf(hq, cv[q], acc[q & 1]);
        }
      }
      from_f32(&sm.y[t][tid], acc[0] + acc[1]);
    }
    __syncthreads();                    // y's tile is whole; stage read

    if (vec) {
#pragma unroll
      for (int it = 0; it < (kTile + kCh - 1) / kCh; ++it) {
        const int e = tid + it * kCh;
        const int t = e / kRow, dd = (e % kRow) * kE;
        if (e < kTile && t < len && d0 + dd < di)
          *reinterpret_cast<uint4*>(y + (row0 + t0 + t) * di + d0 + dd) =
              *reinterpret_cast<const uint4*>(&sm.y[t][dd]);
      }
    } else {
      for (int e = tid; e < len * kCh; e += kCh) {
        const int t = e / kCh, dd = e % kCh;
        if (d0 + dd < di) y[(row0 + t0 + t) * di + d0 + dd] = sm.y[t][dd];
      }
    }
  }

  if (live && vec) {
#pragma unroll
    for (int f = 0; f < kMaxN / 4; ++f) {
      const int m = 4 * f;
      if (m < n)
        *reinterpret_cast<float4*>(h_out + state_off + m) =
            make_float4(h[4 * f], h[4 * f + 1], h[4 * f + 2], h[4 * f + 3]);
    }
  } else if (live) {
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) {
      if (m < n) h_out[state_off + m] = h[m];
    }
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* a,
                   const void* b, const void* c, const void* h0, void* y,
                   void* h_out, int bsz, int s, int di, int n,
                   cudaStream_t stream) {
  // 16-byte pieces need every row on the 16-byte grid
  // (and the float32 state rows, n a multiple of 4 then)
  const bool vec = (di * sizeof(T)) % 16 == 0 && (n * sizeof(T)) % 16 == 0 &&
                   aligned(u) && aligned(dt) && aligned(b) && aligned(c) &&
                   aligned(y) && aligned(a) && aligned(h_out) &&
                   (h0 == nullptr || aligned(h0));
  auto* kernel = scan_kernel<T>;
  constexpr int bytes = sizeof(Smem<T>);
  // above 48 KB (float32) a kernel must be allowed its dynamic shared
  // memory, once per device; later launches (those a CUDA graph captures
  // included) make no call but the launch
  if (bytes > 48 * 1024) {
    static std::atomic<unsigned long long> allowed{0};  // bit d: device d
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (!(allowed.load() & bit)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      allowed.fetch_or(bit);
    }
  }
  const dim3 grid((di + kCh - 1) / kCh, bsz);
  kernel<<<grid, kCh, bytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_out), s, di, n, vec);
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
