// WKV6 for Hopper (sm_90a): RWKV6's linear recurrence with per-channel,
// per-token decays, in two routes chosen by the wrapper from S alone.
//
// Replaces the Pallas TPU kernel _wkv_kernel of
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py:33, launched by wkv6_chunked
// (:98), with the carry that its wrapper (rwkv6_scan/ops.py) folds in
// afterwards taken here as an input.  It computes the function of the
// reference's recurrence (rwkv6_scan/ref.py):
//   r, k, v, w (B, S, H, D) float32; u (H, D); S_0 (B, H, D, D) or zero;
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t
// and returns y (B, S, H, D) and the final S.  D is 16, 32 or 64.
//
// Route "chunked" (S >= 16: every prefill): a stable chunked form whose
// products run on the tensor cores.  Each (b, h) sequence is cut into
// chunks of C = 16 tokens; the last, ragged chunk is padded inside the
// kernel with r = k = v = 0 and w = 1, which leave y and S as they are.
// (ref.wkv6_chunked is the plain version of this form.)
// For a chunk with state S_0 at its start, token t (0-based in it) and
// channel i, write
//   A_t[i] = prod_{q < t} w_q[i]          (from the chunk's start to t)
//   B_s[i] = prod_{s < q < C} w_q[i]      (from s to the chunk's end)
// Then, exactly,
//   y_t = (r_t . A_t) S_0 + sum_{s <= t} P[t][s] v_s,
//   P[t][s] = sum_i r_t[i] k_s[i] prod_{s < q < t} w_q[i]     (s < t),
//   P[t][t] = r_t . (u . k_t)                                  (the bonus),
//   S_C = diag(A_C) S_0 + (k . B)^T V.
// P's strictly lower entries are built level by level: level l cuts
// the chunk into segments of 16 >> l tokens (16, 8, 4, 2), and a pair s
// < t whose smallest common segment has midpoint m (s < m <= t) is
//   P[t][s] = (r_t . prod_{m <= q < t} w_q) . (k_s . prod_{s < q < m} w_q).
// Each token's factor for each of levels 0-2 is a running product kept
// in shared memory (F_l), and level l's 64, 32 or 16 entries are one
// product F_l F_l^T over the 8 tokens that open a lower half, on the
// tensor cores (a warp a level); level 3 (s = t - 1, both products
// empty) and the diagonal are 24 dot products on the CUDA cores.
// Stability: every decay factor above is a running product of decays in
// [0, 1] over the tokens between a reference point and a token, where
// the reference point lies between the two tokens it links (the chunk's
// start for y's r side, its end for the state's k side, the pair's
// segment midpoint for P): every factor is in [0, 1].  No factor is a
// quotient of two products (the TPU kernel's k / A, infinite once A
// underflows at RWKV6-7B's decays, down to ~1e-8), and none is exp of a
// difference of cumulative log w sums (at those decays a 64-token sum
// reaches ~-1,100, where float32's spacing is 1.2e-4, and log 0 = -inf
// makes -inf - -inf NaN).  A product that underflows to 0 is exact
// enough, since its true value lies below float32's range too; a decay
// of exactly 0 or 1 is an ordinary factor.  The ragged tail goes through
// this route too: its padding is exact.
//
// Tensor cores: the products (y's inter-chunk term, P V, the state
// update and P's levels) run as mma.sync m16n8k8 TF32 in 3xTF32: each
// float32 operand x is split into hi = x with its low 13 mantissa bits
// cleared and lo = (x - hi) cleared likewise, and a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in float32 (plain TF32
// would round each operand by up to 2^-11 ~ 4.9e-4, the tolerance
// itself).  A block of 2D threads owns one (b, h); warp w owns the value
// columns j in [16w, 16w + 16), and holds S^T's rows j as mma
// accumulators in registers for the whole sequence: the accumulator
// fragment of S^T is, with the k index permuted inside each 8-wide step
// (k = i order does not change a sum), the A fragment of S^T for the
// next chunk's y, so the state never leaves registers.  The chunk's r,
// k, v and w tiles (16 KB at D 64) come in by cp.async into a two-stage
// ring, the next chunk's loads in flight during this one's products; y
// goes out through shared memory in 16-byte stores.
//
// Route "per_token" (S < 16: every S = 1 decode step): one block of D
// threads owns one (b, h); thread j holds column j of S in registers; a
// token a barrier, with the bonus factored out of the sum,
//   y_j = sum_i r_i S_ij + v_j (r . (u . k)),  S_ij <- w_i S_ij + k_i v_j,
// two FMAs and a multiply a state element.
//
// What bounds it: at RWKV6-7B's prefill (B 8, S 1,024, H 64, D 64) the
// function reads 4 x 134 MB of r, k, v, w and writes 134 MB of y (S_0
// and S are 8.4 MB each): 0.69 GB, 0.21 ms at 3.35 TB/s.  The chunked
// form's products are 34 GFLOP in 3xTF32, 0.07 ms at 495 TFLOP/s, and
// its factors ~0.4 GFLOP on the CUDA cores: bytes bound it.  At S = 1
// the state's 16.8 MB read and written bound it (5.0 us).
//
// What holds it back, as measured (PERF.md has the numbers): the
// chunked route is issue- and latency-bound, not bytes-bound.  512
// blocks of four warps are ~15.5 warps an SM (four blocks an SM, held
// there by 56 KB of shared memory and ~120 registers), each walking its
// 64 chunks in order through three barriers a chunk; a warp issues ~1,230
// instructions a chunk, ~130 of them mma.sync and ~350 the operand
// splits of 3xTF32 (LOP3, FADD), which each warp repeats for the tiles
// all four share.  The per-token route at S = 1 is one block a head,
// its state's column loads in flight, a launch of latency.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kChunk = 16;              // tokens of a chunk
constexpr int kPad = 8;                 // row padding of r . A and k . B
constexpr int kPRow = kChunk + 4;       // row stride of P

// ---- the per-token route --------------------------------------------------
template <int kD>
__global__ void __launch_bounds__(kD)
wkv6_token_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_out, int s,
                  int h) {
  constexpr int kWarps = kD / 32 > 0 ? kD / 32 : 1;
  constexpr int kWidth = kD < 32 ? kD : 32;         // lanes of a warp
  constexpr unsigned kMask = kD < 32 ? (1u << kD) - 1u : 0xffffffffu;
  __shared__ __align__(16) float rs[2][kD];
  __shared__ __align__(16) float ks[2][kD];
  __shared__ __align__(16) float ws[2][kD];
  __shared__ float bonus[2][kWarps];

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
  const float uj = u[head * kD + j];

  // element j of token t: ((b * s + t) * h + head) * kD + j
  const long long row = static_cast<long long>(h) * kD;
  long long off = (static_cast<long long>(b) * s * h + head) * kD + j;
  float rn = r[off], kn = k[off], vn = v[off], wn = w[off];

  for (int t = 0; t < s; ++t) {
    const int buf = t & 1;
    rs[buf][j] = rn;
    ks[buf][j] = kn;
    ws[buf][j] = wn;
    // r . (u . k), summed over the block: a warp's share by shuffles
    float part = rn * uj * kn;
#pragma unroll
    for (int o = kWidth / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(kMask, part, o);
    if ((j & 31) == 0) bonus[buf][j / 32] = part;
    const float vj = vn;
    const long long cur = off;
    if (t + 1 < s) {
      off += row;
      rn = r[off];
      kn = k[off];
      vn = v[off];
      wn = w[off];
    }
    // the buffers written two tokens ago were last read before the
    // barrier of the token between, so one barrier a token suffices
    __syncthreads();
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kD; i += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(&rs[buf][i]);
      const float4 k4 = *reinterpret_cast<const float4*>(&ks[buf][i]);
      const float4 w4 = *reinterpret_cast<const float4*>(&ws[buf][i]);
      acc[0] = fmaf(r4.x, st[i], acc[0]);
      acc[1] = fmaf(r4.y, st[i + 1], acc[1]);
      acc[2] = fmaf(r4.z, st[i + 2], acc[2]);
      acc[3] = fmaf(r4.w, st[i + 3], acc[3]);
      st[i] = fmaf(w4.x, st[i], k4.x * vj);
      st[i + 1] = fmaf(w4.y, st[i + 1], k4.y * vj);
      st[i + 2] = fmaf(w4.z, st[i + 2], k4.z * vj);
      st[i + 3] = fmaf(w4.w, st[i + 3], k4.w * vj);
    }
    float bsum = 0.0f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) bsum += bonus[buf][q];
    y[cur] = fmaf(vj, bsum, (acc[0] + acc[1]) + (acc[2] + acc[3]));
  }

#pragma unroll
  for (int i = 0; i < kD; ++i)
    s_out[state_off + static_cast<long long>(i) * kD] = st[i];
}

// ---- the chunked route ------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// x = hi + lo, both TF32 (low 13 mantissa bits clear); lo truncated
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, the small terms first; b is (b0, b1) as float32
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, l0, l1);
  mma_tf32(d, ah, h0, h1);
}

// one level of P's factors for channel i: in each segment of kSeg tokens
// with midpoint m, the upper half's r_t prod_{m <= q < t} w_q (kUpper) or
// the lower half's k_s prod_{s < q < m} w_q, into f[t][i] (row stride ld)
template <int kSeg, bool kUpper>
__device__ __forceinline__ void level_factors(float* f,
                                              const float (&x)[kChunk],
                                              const float (&wv)[kChunk],
                                              int i, int ld) {
#pragma unroll
  for (int a0 = 0; a0 < kChunk; a0 += kSeg) {
    float p = 1.0f;
#pragma unroll
    for (int q = 0; q < kSeg / 2; ++q) {
      const int t = kUpper ? a0 + kSeg / 2 + q : a0 + kSeg / 2 - 1 - q;
      f[t * ld + i] = x[t] * p;
      p *= wv[t];
    }
  }
}

template <int kD>
struct ChunkSmem {
  static constexpr int kTile = kChunk * kD;        // a staged [16][kD] tile
  static constexpr int kLd = kD + kPad;            // rd, kd row stride
  static constexpr int kFLd = kD + 4;              // F and y row stride
  static constexpr int kLevels = 3;                // F's levels (of 4)
  // stage[2][4 tensors], rd, kd, P, F (or y), A_C, u
  static constexpr int kFloats = 2 * 4 * kTile + 2 * kChunk * kLd +
                                 kChunk * kPRow + kLevels * kChunk * kFLd +
                                 2 * kD;
  static constexpr int kBytes = kFloats * 4;
};

template <int kD>
__global__ void __launch_bounds__(2 * kD, kD == 64 ? 4 : 1)
wkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_out, int s,
                  int h) {
  using L = ChunkSmem<kD>;
  constexpr int kThreads = 2 * kD;
  constexpr int kLd = L::kLd, kFLd = L::kFLd;
  constexpr int kNT = kD / 8;           // 8-wide steps over the channels
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                               // [2][4][16][kD]
  float* rd = stage + 2 * 4 * L::kTile;              // r . A     [16][kLd]
  float* kd = rd + kChunk * kLd;                     // k . B     [16][kLd]
  float* pm = kd + kChunk * kLd;                     // P         [16][kPRow]
  float* fl = pm + kChunk * kPRow;                   // F [3][16][kFLd]
  float* yt = fl;                                    // y [16][kFLd] (F's
                                                     // room once P is made)
  float* ac = fl + L::kLevels * kChunk * kFLd;       // A_C       [kD]
  float* us = ac + kD;                               // u         [kD]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh % h;
  const long long row = static_cast<long long>(h) * kD;    // token stride
  const long long base = (static_cast<long long>(b) * s * h + head) * kD;
  const int nchunks = (s + kChunk - 1) / kChunk;

  constexpr int kPieces = kD / 4;       // 16-byte pieces of a token row
  // a thread copies the same pieces of the four tensors' tiles
  auto load_stage = [&](int c, int buf) {
    const int t0 = c * kChunk;
#pragma unroll
    for (int it = 0; it < kChunk * kPieces / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int t = e / kPieces, piece = e % kPieces;
      const bool valid = t0 + t < s;
      const long long off = valid ? base + (t0 + t) * row + piece * 4 : 0;
      float* dst = stage + buf * 4 * L::kTile + t * kD + piece * 4;
      cp_async16(dst, r + off, valid);
      cp_async16(dst + L::kTile, k + off, valid);
      cp_async16(dst + 2 * L::kTile, v + off, valid);
      cp_async16(dst + 3 * L::kTile, w + off, valid);
    }
  };

  load_stage(0, 0);
  cp_async_commit();

  for (int e = tid; e < kChunk * kPRow; e += kThreads) pm[e] = 0.0f;
  for (int e = tid; e < kD; e += kThreads) us[e] = u[head * kD + e];

  // the warp's rows of S^T: j0 = 16 warp + g and j1 = j0 + 8; per 8-wide
  // step nt over i, st[nt] = {S[i][j0], S[i+1][j0], S[i][j1], S[i+1][j1]}
  // at i = 8 nt + 2 tg (the mma accumulator layout)
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int j0 = 16 * warp + g, j1 = j0 + 8;
  float st[kNT][4];
  {
    const long long so = static_cast<long long>(bh) * kD * kD;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int i = 8 * nt + 2 * tg;
      const bool any = s0 != nullptr;
      st[nt][0] = any ? s0[so + i * kD + j0] : 0.0f;
      st[nt][1] = any ? s0[so + (i + 1) * kD + j0] : 0.0f;
      st[nt][2] = any ? s0[so + i * kD + j1] : 0.0f;
      st[nt][3] = any ? s0[so + (i + 1) * kD + j1] : 0.0f;
    }
  }

  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < nchunks) load_stage(c + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();                // chunk c has landed
    __syncthreads();                    // ... for every thread
    const int len = min(kChunk, s - c * kChunk);
    const float* R = stage + (buf * 4 + 0) * L::kTile;
    const float* K = stage + (buf * 4 + 1) * L::kTile;
    const float* V = stage + (buf * 4 + 2) * L::kTile;
    const float* W = stage + (buf * 4 + 3) * L::kTile;

    // Channel i's running products, its values read into registers first
    // (a store between two reads would serialise them).  Padded tokens
    // (t >= len) have r = k = v = 0 and count w as 1 where a product runs
    // to the chunk's end.
    //  - r . A_t and A_C from the chunk's start; k . B_s from its end;
    //  - F, P's factors: level l cuts the chunk into segments of 16 >> l
    //    tokens; a token in a segment's upper half gets r_t times the
    //    product from the segment's midpoint m to t, one in its lower
    //    half k_s times the product from s to m (both exclusive of the
    //    token).  A pair s < t whose smallest common segment is at level
    //    l has P[t][s] = F[l][t] . F[l][s]; at level 3 (s = t - 1, both
    //    products empty) that is r_t . k_s itself.
    // Threads [0, kD) take the r side, [kD, 2 kD) the k side.
    {
      const int i = tid % kD;
      const bool r_side = tid < kD;
      const float* X = r_side ? R : K;
      float xv[kChunk], wv[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        xv[t] = X[t * kD + i];
        wv[t] = W[t * kD + i];
      }
      if (r_side) {
        float a = 1.0f;
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          rd[t * kLd + i] = xv[t] * a;
          a *= t < len ? wv[t] : 1.0f;
        }
        ac[i] = a;
        level_factors<16, true>(fl, xv, wv, i, kFLd);
        level_factors<8, true>(fl + kChunk * kFLd, xv, wv, i, kFLd);
        level_factors<4, true>(fl + 2 * kChunk * kFLd, xv, wv, i, kFLd);
      } else {
        float bb = 1.0f;
#pragma unroll
        for (int t = kChunk - 1; t >= 0; --t) {
          kd[t * kLd + i] = xv[t] * bb;
          bb *= t < len ? wv[t] : 1.0f;
        }
        level_factors<16, false>(fl, xv, wv, i, kFLd);
        level_factors<8, false>(fl + kChunk * kFLd, xv, wv, i, kFLd);
        level_factors<4, false>(fl + 2 * kChunk * kFLd, xv, wv, i, kFLd);
      }
    }
    __syncthreads();

    // P.  Its diagonal (the bonus r_t . (u . k_t)) and its level-3
    // entries (s = t - 1, t odd) on the CUDA cores: 24 dot products, each
    // split over kD / 16 threads of 16 channels.
    {
      constexpr int kSplit = kD / 16;
      const int e = min(tid / kSplit, 23), part = tid % kSplit;
      const bool diag = e < kChunk;
      const int t = diag ? e : 2 * (e - kChunk) + 1;
      const int sidx = diag ? t : t - 1;
      const float* x = R + t * kD + 16 * part;
      const float* z = K + sidx * kD + 16 * part;
      const float* uu = us + 16 * part;
      float q0 = 0.0f, q1 = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; i += 4) {
        float4 a4 = *reinterpret_cast<const float4*>(x + i);
        const float4 b4 = *reinterpret_cast<const float4*>(z + i);
        if (diag) {
          const float4 u4 = *reinterpret_cast<const float4*>(uu + i);
          a4.x *= u4.x;
          a4.y *= u4.y;
          a4.z *= u4.z;
          a4.w *= u4.w;
        }
        q0 = fmaf(a4.x, b4.x, q0);
        q1 = fmaf(a4.y, b4.y, q1);
        q0 = fmaf(a4.z, b4.z, q0);
        q1 = fmaf(a4.w, b4.w, q1);
      }
      float q = q0 + q1;
#pragma unroll
      for (int o = kSplit / 2; o > 0; o >>= 1)
        q += __shfl_xor_sync(0xffffffffu, q, o);
      if (part == 0 && tid / kSplit < 24) pm[t * kPRow + sidx] = q;
    }
    // Levels 0-2 on the tensor cores, a warp a level: F_l (16 tokens x
    // D) times F_l^T restricted to the 8 tokens that open a lower half
    // (column n is token (n mod h) + 2h (n div h), h the half-segment),
    // of which the entries with t in the upper half of s's segment are P's.
    for (int lv = warp; lv < L::kLevels; lv += kThreads / 32) {
      const float* f = fl + lv * kChunk * kFLd;
      const int lg = 4 - lv;                      // log2 of the segment
      const int hh = 1 << (lg - 1);               // half a segment
      const int scol = (g & (hh - 1)) + ((g >> (lg - 1)) << lg);
      float pa[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kNT; ++ks) {
        const float* a0 = f + g * kFLd + 8 * ks + tg;
        const float* a1 = a0 + 8 * kFLd;
        uint32_t ah[4], al[4];
        split(a0[0], ah[0], al[0]);
        split(a1[0], ah[1], al[1]);
        split(a0[4], ah[2], al[2]);
        split(a1[4], ah[3], al[3]);
        const float* bcol = f + scol * kFLd + 8 * ks + tg;
        mma3(pa[ks & 1], ah, al, bcol[0], bcol[4]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = g + 8 * (q >> 1);
        const int n = 2 * tg + (q & 1);
        const int sidx = (n & (hh - 1)) + ((n >> (lg - 1)) << lg);
        if ((t >> lg) == (sidx >> lg) && (t & (2 * hh - 1)) >= hh)
          pm[t * kPRow + sidx] = pa[0][q] + pa[1][q];
      }
    }
    __syncthreads();

    // V^T's A fragments (rows j, k = token s), split once for both uses
    uint32_t vh[2][4], vl[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int s_lo = 8 * ks + tg, s_hi = s_lo + 4;
      split(V[s_lo * kD + j0], vh[ks][0], vl[ks][0]);
      split(V[s_lo * kD + j1], vh[ks][1], vl[ks][1]);
      split(V[s_hi * kD + j0], vh[ks][2], vl[ks][2]);
      split(V[s_hi * kD + j1], vh[ks][3], vl[ks][3]);
    }

    // y^T (j x t) = S^T (r . A)^T + V^T P^T, in two accumulators for each
    // 8 tokens (even and odd k steps) to halve the chains of dependent mma
    float ya[2][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < kNT; ++ks) {
      // slot tg holds i = 8 ks + 2 tg, slot tg + 4 holds i + 1
      uint32_t ah[4], al[4];
      split(st[ks][0], ah[0], al[0]);
      split(st[ks][2], ah[1], al[1]);
      split(st[ks][1], ah[2], al[2]);
      split(st[ks][3], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(
            rd + (8 * nt + g) * kLd + 8 * ks + 2 * tg);
        mma3(ya[nt][ks & 1], ah, al, bv.x, bv.y);
      }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* prow = pm + (8 * nt + g) * kPRow + 8 * ks + tg;
        mma3(ya[nt][ks], vh[ks], vl[ks], prow[0], prow[4]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int t = 8 * nt + 2 * tg;
      yt[t * kFLd + j0] = ya[nt][0][0] + ya[nt][1][0];
      yt[(t + 1) * kFLd + j0] = ya[nt][0][1] + ya[nt][1][1];
      yt[t * kFLd + j1] = ya[nt][0][2] + ya[nt][1][2];
      yt[(t + 1) * kFLd + j1] = ya[nt][0][3] + ya[nt][1][3];
    }

    // S^T <- S^T diag(A_C) + V^T (k . B).  The chunk's V^T (k . B) is
    // summed from zero and added to the state by FMA, rounded once to
    // nearest: accumulated onto the state inside the mma, whose adds do
    // not round to nearest, it drifts with the state's magnitude (decays
    // near 1 grow the state ~S-fold).
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float2 a2 =
          *reinterpret_cast<const float2*>(ac + 8 * nt + 2 * tg);
      float kv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float* kcol = kd + (8 * ks + tg) * kLd + 8 * nt + g;
        mma3(kv, vh[ks], vl[ks], kcol[0], kcol[4 * kLd]);
      }
      st[nt][0] = fmaf(st[nt][0], a2.x, kv[0]);
      st[nt][1] = fmaf(st[nt][1], a2.y, kv[1]);
      st[nt][2] = fmaf(st[nt][2], a2.x, kv[2]);
      st[nt][3] = fmaf(st[nt][3], a2.y, kv[3]);
    }
    __syncthreads();                    // y's tile is whole; stage c read

#pragma unroll
    for (int it = 0; it < kChunk * kPieces / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int t = e / kPieces, piece = e % kPieces;
      if (t < len)
        *reinterpret_cast<float4*>(y + base + (c * kChunk + t) * row +
                                   piece * 4) =
            *reinterpret_cast<const float4*>(yt + t * kFLd + piece * 4);
    }
  }

  const long long so = static_cast<long long>(bh) * kD * kD;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int i = 8 * nt + 2 * tg;
    s_out[so + i * kD + j0] = st[nt][0];
    s_out[so + (i + 1) * kD + j0] = st[nt][1];
    s_out[so + i * kD + j1] = st[nt][2];
    s_out[so + (i + 1) * kD + j1] = st[nt][3];
  }
}

// above 48 KB a kernel must be allowed its dynamic shared memory, once per
// device; later launches (those a CUDA graph captures included) make no
// call but the launch
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       std::atomic<unsigned long long>& allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (allowed.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  // all of the SM's L1/shared room as shared memory, so four blocks fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err == cudaSuccess) allowed.fetch_or(bit);
  return err;
}

template <int kD>
cudaError_t launch(bool chunked, const float* r, const float* k,
                   const float* v, const float* w, const float* u,
                   const float* s0, float* y, float* s_out, int b, int s,
                   int h, cudaStream_t stream) {
  if (!chunked) {
    wkv6_token_kernel<kD><<<b * h, kD, 0, stream>>>(r, k, v, w, u, s0, y,
                                                    s_out, s, h);
    return cudaGetLastError();
  }
  static std::atomic<unsigned long long> allowed{0};
  constexpr int bytes = ChunkSmem<kD>::kBytes;
  const cudaError_t err = allow_smem(wkv6_chunk_kernel<kD>, bytes, allowed);
  if (err != cudaSuccess) return err;
  wkv6_chunk_kernel<kD><<<b * h, 2 * kD, bytes, stream>>>(r, k, v, w, u, s0,
                                                          y, s_out, s, h);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w: (b, s, h, d) float32, contiguous, 16-byte aligned; u: (h,
// d); s0: (b, h, d, d) or null (a zero initial state) -> y: (b, s, h, d),
// s_out: (b, h, d, d).  chunked = 1 runs the chunked tensor-core route,
// 0 the per-token route; d is 16, 32 or 64; b * h is at most 2**31 - 1
// blocks.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int b, int s, int h, int d,
                          int chunked, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 ||
      static_cast<long long>(b) * h > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  switch (d) {
    case 16:
      return static_cast<int>(launch<16>(chunked != 0, f(r), f(k), f(v),
                                         f(w), f(u), f(s0), o(y), o(s_out),
                                         b, s, h, st));
    case 32:
      return static_cast<int>(launch<32>(chunked != 0, f(r), f(k), f(v),
                                         f(w), f(u), f(s0), o(y), o(s_out),
                                         b, s, h, st));
    case 64:
      return static_cast<int>(launch<64>(chunked != 0, f(r), f(k), f(v),
                                         f(w), f(u), f(s0), o(y), o(s_out),
                                         b, s, h, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
