// Flash attention on Hopper's tensor cores (sm_90a): bf16 causal or full
// GQA attention whose two products run on wgmma over tiles that TMA loads
// into shared memory.
//
// Replaces, for bf16 inputs with head dim 64 or 128, the Pallas TPU kernel
// _flash_kernel of src/repro/kernels/flash_attention/flash_attention.py:31,
// launched by flash_attention (:102).  It computes what that kernel
// computes: q (B, S, Hq, Dh), k and v (B, T, Hkv, Dh); q head h reads kv
// head h / (Hq / Hkv); scores q.k * Dh**-0.5 accumulated in float32; a
// causal mask aligned at the top left (key j is seen by query i iff j <= i)
// whose masked scores take NEG_INF = -1e30, not -inf; float32 m, l and
// output accumulator; at the end l == 0 becomes 1 and out = acc / l,
// rounded to bf16.  Ragged S and T are taken here: rows past S are loaded
// as zeros and not stored, keys past T get p = 0 by their index.  One
// rounding is new against the CUDA-core kernel (flash_attention.cu, which
// float32 inputs and head dims 16 and 32 keep): P is rounded to bf16 for
// the P.V product, a relative error of at most 2**-9 a weight, inside the
// 2e-2 that bf16 outputs are held to.
//
// What bounds it: at the serve shape (B 8, S = T 1,024, Hq 12, Hkv 2, Dh
// 128, causal) the work is 25.8 GFLOP against 58.7 MB of inputs and
// outputs, so the card's bf16 tensor cores bound it: 0.026 ms at 989
// TFLOP/s.  The design keeps both products on the tensor cores, feeds them
// without the load units, and keeps them busy through the softmax:
// - persistent blocks, one an SM (the shared memory allows no second),
//   walk the (q head, batch, 128-row q tile) tiles, heaviest causal tiles
//   first, dealt in rounds with every other round reversed; each tile's
//   key tiles are summed in order inside one block, so no sum is split
//   across blocks and the result is bitwise repeatable;
// - warpgroup 0 is the producer: after giving up its registers
//   (setmaxnreg) one thread issues every TMA load, the Q tile and K and V
//   tiles of 128 keys into a ring of kStages stages, each behind a "full"
//   mbarrier that the copy completes and an "empty" one the consumers
//   release (K once its Q.K^T is done, V once its P.V is), running ahead
//   into the next q tile while this one finishes; tensor maps give each
//   tensor a batch dimension of its own, so a ragged last tile is filled
//   with zeros, and 64-column boxes under 128-byte swizzle lay tiles out as
//   wgmma reads them; tiles above the diagonal are never loaded;
// - warpgroups 1 and 2 are consumers of 64 q rows each (setmaxnreg gives
//   them 232 registers a thread): S = Q.K^T is wgmma m64n128k16 with both
//   operands in shared memory (K as stored is K-major for K^T); the online
//   softmax runs on the float32 accumulator fragment (a row spread over
//   the 4 threads of a quad: two shuffles; scale * log2(e) folded into
//   the FFMA before each exp2; masks only on the diagonal and ragged
//   tiles); P is rounded to bf16 in registers, where the accumulator's
//   layout is already the A fragment of wgmma's register form, and O +=
//   P.V is wgmma m64nDhk16 with V as stored (MN-major: the transpose-B
//   immediate);
// - the softmax hides under the products twice over: a consumer issues
//   key tile i's Q.K^T and tile i - 1's P.V together and runs tile i's
//   softmax while they run, and the two consumers take turns to issue
//   (named barriers), so one's softmax runs under the other's products;
// - the epilogue scales by 1 / l into a swizzled output tile in shared
//   memory that one TMA store writes out (rows past S are not), so the
//   consumer goes on to its next tile at once.  Nothing is allocated and
//   nothing synchronises the host.
#include <algorithm>
#include <atomic>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;                // q rows of a block
constexpr int kBK = 128;                // keys of a tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kConsumers = 2;           // warpgroups of 64 q rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBox = 64;                // bf16 columns of a TMA box (128 B)
constexpr int kRowBytes = 2 * kBox;     // one 128-byte swizzle row
constexpr int kProducerRegs = 40;       // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232;      //   = 384 x 168 registers
constexpr float kNegInf = -1e30f;       // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of a block, in bytes from a 1,024-byte aligned base (the
// 128-byte swizzle repeats every 1,024 bytes): the Q tile, kStages K and V
// tiles and the output tile, each as kDh / 64 boxes of (rows, 64) bf16
// (the output's a pair of 64-row halves, one a consumer), then the
// mbarriers.
template <int kDh>
struct Smem {
  static constexpr int kQTile = kBQ * kDh * 2;
  static constexpr int kKVTile = kBK * kDh * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kO = kV + kStages * kKVTile;
  static constexpr int kOHalf = 64 * kDh * 2;   // one consumer's rows
  static constexpr int kBar = kO + 2 * kOHalf;
  static constexpr int kBars = 2 + 4 * kStages;  // full, empty q, k, v
  static constexpr int kAlloc = kBar + 8 * kBars + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------
// one box of a 3-d tensor map (columns, rows, batch) into shared memory at
// `dst`, completing `bar`'s transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(batch)
      : "memory");
}

// one box of shared memory at `src` out to a 3-d tensor map; rows past
// the map's end are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------
// Shared-memory matrix descriptor under 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (Q, K): rows of 128 bytes, 8-row groups 1,024 bytes
// apart; the leading offset is not read under this swizzle
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 8 * kRowBytes);
}

// MN-major operand (V for P.V): the 8-row groups along K 1,024 bytes
// apart, the 64-column boxes along N `box_bytes` apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr,
                                                 uint32_t box_bytes) {
  return sw128_desc(addr, box_bytes, 8 * kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most kPending committed groups are still running
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// ties the accumulator registers to the asm around them, so the compiler
// neither reads them before wgmma.wait_group nor moves writes past a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A.B^T for a 64 x 128 D, A and B K-major in shared memory (their
// descriptors); D is overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (+)= A.B for a 64 x N D, A's 64 x 16 bf16 fragment in registers, B
// MN-major in shared memory (the transpose-B immediate set); N = 64, 128
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D += A.B, A (64 x 16) in registers, B MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db, 1);
  else
    wgmma_rs_n128(d, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile on S's accumulator fragment, in
// place: entry e of sc is row row0 + 8 * ((e / 2) % 2), key k0 + 8 * (e /
// 4) + col0 + e % 2.  Masked scores take NEG_INF; m, the running max, is
// kept in log2 units (the raw max times scale * log2(e), the scale being
// positive), and each score becomes p = exp2(s * scale * log2(e) - m), one
// FFMA and an exp2; keys past T get p = 0.  Sets each row's alpha =
// exp2(m_old - m_new) and folds it and this tile's p into the thread's
// share of l.
template <int kN, bool kCausal>
__device__ __forceinline__ void softmax_tile(float (&sc)[kN / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool masked, int k0, int row0,
                                             int col0, int t,
                                             float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
    if (masked) {
      const int col = k0 + 8 * (e / 4) + col0 + e % 2;
      const int row = row0 + 8 * ((e / 2) % 2);
      if ((kCausal && col > row) || col >= t) sc[e] = kNegInf;
    }
    mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], sc[e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    mx[r] = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
    float p = ex2(fmaf(sc[e], scale_log2, -m[(e / 2) % 2]));
    if (masked && k0 + 8 * (e / 4) + col0 + e % 2 >= t) p = 0.0f;
    sc[e] = p;
    l[(e / 2) % 2] += p;
  }
}

// One q tile of the work: 128 rows of one (batch, q head).
struct Tile {
  int h, b, q0, num_kb;
};

// The n-th tile block `blk` of `blocks` takes.  Tiles are ranked heaviest
// first (the q tile's index from the last, then batch, then head) and
// dealt in rounds of `blocks`, every other round in reverse, so each block
// gets a like share of the causal work; h < 0 when none is left.
template <bool kCausal>
__device__ __forceinline__ Tile tile_at(int n, int blk, int blocks, int s,
                                        int t, int hq, int batch) {
  const int num_qb = (s + kBQ - 1) / kBQ;
  const int per_qb = hq * batch;
  const int w = n * blocks + (n % 2 == 0 ? blk : blocks - 1 - blk);
  Tile tile;
  if (w >= num_qb * per_qb) {
    tile.h = -1;
    return tile;
  }
  tile.q0 = (num_qb - 1 - w / per_qb) * kBQ;
  tile.h = (w % per_qb) % hq;
  tile.b = (w % per_qb) / hq;
  // key tiles at or below the tile's diagonal (all without the mask),
  // never past T
  tile.num_kb = (t + kBK - 1) / kBK;
  if (kCausal) tile.num_kb = min(tile.num_kb, (tile.q0 + kBQ - 1) / kBK + 1);
  return tile;
}

// q, k, v, o as (B, rows, heads * kDh) bf16; see the note at the top
template <int kDh, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to, int s, int t,
                  int hq, int hkv, int batch, float scale_log2) {
  static_assert(kDh % kBox == 0, "head dim must be 64 or 128");
  using L = Smem<kDh>;
  constexpr int kBoxes = kDh / kBox;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ;
  const uint32_t sk = base + L::kK;
  const uint32_t sv = base + L::kV;
  // mbarriers, 8 bytes each: the Q tile's, then one of each a stage
  const uint32_t full_q = base + L::kBar;
  const uint32_t empty_q = full_q + 8;
  const uint32_t full_k = empty_q + 8;
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;
  const int group = hq / hkv;
  const int blk = blockIdx.x;
  const int blocks = gridDim.x;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 4 * kConsumers);           // one arrival a warp
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty_k + 8 * st, 4 * kConsumers);
      mbar_init(empty_v + 8 * st, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: one thread issues every load, a tile ahead where the
    // ring allows, so the next tile's Q and first keys land while the
    // consumers finish this one ---------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;                        // key tiles loaded so far
      for (int n = 0;; ++n) {
        const Tile tile = tile_at<kCausal>(n, blk, blocks, s, t, hq, batch);
        if (tile.h < 0) break;
        const int hk = tile.h / group;
        // the Q buffer is refilled once both consumers have read the last
        // tile's Q for the last time
        if (n > 0) mbar_wait(empty_q, (n - 1) & 1);
        mbar_expect_tx(full_q, L::kQTile);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(sq + x * kBQ * kRowBytes, &tq, full_q,
                   tile.h * kDh + x * kBox, tile.q0, tile.b);
        for (int i = 0; i < tile.num_kb; ++i, ++it) {
          const int st = it % kStages;
          // a stage is refilled once both consumers have released the
          // tile it held (it - kStages): K after its Q.K^T, V after P.V
          const uint32_t parity = ((it / kStages) - 1) & 1;
          if (it >= kStages) mbar_wait(empty_k + 8 * st, parity);
          mbar_expect_tx(full_k + 8 * st, L::kKVTile);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
            tma_load(sk + st * L::kKVTile + x * kBK * kRowBytes, &tk,
                     full_k + 8 * st, hk * kDh + x * kBox, i * kBK, tile.b);
          if (it >= kStages) mbar_wait(empty_v + 8 * st, parity);
          mbar_expect_tx(full_v + 8 * st, L::kKVTile);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
            tma_load(sv + st * L::kKVTile + x * kBK * kRowBytes, &tv,
                     full_v + 8 * st, hk * kDh + x * kBox, i * kBK, tile.b);
        }
      }
    }
  } else {
    // -- consumers: 64 q rows each ----------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int g = __shfl_sync(kFull, wg, 0) - 1;   // warp-uniform
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    // this thread's rows of a tile: row0 and row0 + 8 past q0 (accumulator
    // halves 0 and 1); its columns of each 8-wide block: col0 and col0 + 1
    const int row0 = 64 * g + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t so = base + L::kO + g * L::kOHalf;   // this one's output

    // S = Q.K^T of ring slot `it` on the tensor cores (issued, not waited)
    auto issue_qk = [&](float (&sc)[kBK / 2], int it) {
      const int st = it % kStages;
      mbar_wait(full_k + 8 * st, (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns of a box
        wgmma_ss_n128(sc,
                      kmajor_desc(sq + (kk / 4) * kBQ * kRowBytes +
                                  g * 64 * kRowBytes + off),
                      kmajor_desc(sk + st * L::kKVTile +
                                  (kk / 4) * kBK * kRowBytes + off),
                      kk > 0);
      }
      wgmma_commit();
    };
    // O += P.V of ring slot `it` on the tensor cores (issued, not waited)
    auto issue_pv = [&](float (&acc)[kDh / 2],
                        const uint32_t (&pa)[kBK / 16][4], int it) {
      const int st = it % kStages;
      mbar_wait(full_v + 8 * st, (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        wgmma_rs<kDh>(acc, pa[j],
                      mnmajor_desc(sv + st * L::kKVTile + j * 16 * kRowBytes,
                                   kBK * kRowBytes));
      wgmma_commit();
    };
    // this warp is done with a buffer (the Q tile, or a stage's K or V)
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // the two consumers take turns to issue their products (named
    // barriers 1 and 2 of 256 threads: this warpgroup's sync meets the
    // other's arrive), so one's softmax runs under the other's products
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + g) : "memory");
    };
    auto your_turn = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - g) : "memory");
    };
    if (g == 0)   // the first consumer goes first
      asm volatile("bar.arrive 1, 256;\n" ::: "memory");

    float acc[kDh / 2];
    float m[2], l[2], alpha[2];   // running max (log2 units), sum share
    float sc[kBK / 2];
    uint32_t pa[kBK / 16][4];     // P of the last key tile, bf16 pairs
    // P in bf16: entries 8j .. 8j + 7 of sc are wgmma's A fragment of
    // keys 16j .. 16j + 15
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
    };

    int it = 0;                   // key tiles consumed so far
    for (int n = 0;; ++n) {
      const Tile tile = tile_at<kCausal>(n, blk, blocks, s, t, hq, batch);
      if (tile.h < 0) break;
      const int rows = tile.q0 + row0;
      const int num_kb = tile.num_kb;
      // a key tile that ends at or below this warpgroup's first row needs
      // no causal mask; the ragged last one always does
      auto needs_mask = [&](int i) {
        return (kCausal && (i + 1) * kBK - 1 > tile.q0 + 64 * g) ||
               (i + 1) * kBK > t;
      };
#pragma unroll
      for (int e = 0; e < kDh / 2; ++e) acc[e] = 0.0f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.0f;

      mbar_wait(full_q, n & 1);
      // key tile 0: its scores, then its softmax (acc is still zero)
      my_turn();
      issue_qk(sc, it);
      your_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      release(empty_k + 8 * (it % kStages));
      if (num_kb == 1) release(empty_q);
      softmax_tile<kBK, kCausal>(sc, m, l, alpha, needs_mask(0), 0, rows,
                                 col0, t, scale_log2);
      pack_p();
      // key tile i's scores and tile i - 1's P.V run on the tensor cores
      // while tile i's softmax runs here; acc takes tile i's alpha once
      // its P.V has landed
      for (int i = 1; i < num_kb; ++i) {
        fence_regs(acc);
        my_turn();
        issue_qk(sc, it + i);
        issue_pv(acc, pa, it + i - 1);
        your_turn();
        wgmma_wait<1>();                 // Q.K^T of tile i done
        fence_regs(sc);
        release(empty_k + 8 * ((it + i) % kStages));
        if (i == num_kb - 1) release(empty_q);
        softmax_tile<kBK, kCausal>(sc, m, l, alpha, needs_mask(i), i * kBK,
                                   rows, col0, t, scale_log2);
        wgmma_wait<0>();                 // P.V of tile i - 1 done
        fence_regs(acc);
        release(empty_v + 8 * ((it + i - 1) % kStages));
#pragma unroll
        for (int e = 0; e < kDh / 2; ++e) acc[e] *= alpha[(e / 2) % 2];
        pack_p();
      }
      fence_regs(acc);
      my_turn();
      issue_pv(acc, pa, it + num_kb - 1);
      your_turn();
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_v + 8 * ((it + num_kb - 1) % kStages));
      it += num_kb;

      // out = acc / l, l == 0 -> 1, in bf16 to this consumer's output
      // tile (laid out as TMA stores it, 128-byte swizzle), then one TMA
      // store a box; rows past S are not written.  The tile is rewritten
      // only once the last tile's store has read it.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(kFull, l[r], 1);
        l[r] += __shfl_xor_sync(kFull, l[r], 2);
        l[r] = __frcp_rn(l[r] == 0.0f ? 1.0f : l[r]);
      }
      if (tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + g) : "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + lane / 4 + 8 * r;   // of this half
#pragma unroll
        for (int j = 0; j < kDh / 8; ++j) {
          const uint32_t chunk = (j % 8) ^ (row % 8);
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * j + 2 * r] * l[r], acc[4 * j + 2 * r + 1] * l[r]);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           so + (j / 8) * 64 * kRowBytes + row * kRowBytes +
                           chunk * 16 + col0 * 2),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
      }
      // the stores are seen by the TMA unit (the async proxy) once every
      // thread of this consumer has made them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + g) : "memory");
      if (tid == 0 && tile.q0 + 64 * g < s) {
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_store(&to, so + x * 64 * kRowBytes, tile.h * kDh + x * kBox,
                    tile.q0 + 64 * g, tile.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    // the block's shared memory outlives the last store's read of it
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// -- host --------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (so the library needs no -lcuda); null if the driver lacks it
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a (batch, rows, cols) bf16 tensor as a 3-d map of (64, box_rows, 1)
// boxes under 128-byte swizzle; rows past `rows` of a box read as zeros
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
              int batch, int rows, int cols, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {2ull * cols, 2ull * cols * rows};
  const cuuint32_t box[3] = {kBox, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kDh, bool kCausal>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& to, int b,
                   int s, int t,
                   int hq, int hkv, float scale_log2, long long num_tiles,
                   cudaStream_t stream) {
  constexpr int bytes = Smem<kDh>::kAlloc;
  auto* kernel = flash_sm90_kernel<kDh, kCausal>;
  // above 48 KB a kernel must be allowed its dynamic shared memory, once
  // per device; later launches (those a CUDA graph captures included)
  // make no call but the launch
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
  // one block an SM (its shared memory allows no second), each walking
  // its share of the tiles
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = static_cast<int>(std::min<long long>(num_tiles, sms));
  kernel<<<blocks, kThreads, bytes, stream>>>(
      tq, tk, tv, to, s, t, hq, hkv, b, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q: (b, s, hq, dh), k and v: (b, t, hkv, dh), contiguous bf16, each
// 16-byte aligned -> o: (b, s, hq, dh) bf16.  dh is 64 or 128 and hq a
// multiple of hkv; scale is Dh**-0.5 rounded to float32.  Returns 0 on
// success, else a cudaError_t: the launch's (cudaGetLastError()), or
// cudaErrorInvalidValue for arguments the kernel does not take or a
// tensor map the driver refuses, cudaErrorSymbolNotFound if the driver
// has no cuTensorMapEncodeTiled.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k,
                                          const void* v, void* o, int b,
                                          int s, int t, int hq, int hkv,
                                          int dh, float scale, int causal,
                                          void* stream) {
  const long long num_tiles =
      static_cast<long long>((s + kBQ - 1) / kBQ) * hq * b;
  if (b <= 0 || s <= 0 || t <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 ||
      num_tiles >= (1ll << 31) || (dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, encode, q, b, s, hq * dh, kBQ) ||
      !make_map(&to, encode, o, b, s, hq * dh, 64) ||
      !make_map(&tk, encode, k, b, t, hkv * dh, kBK) ||
      !make_map(&tv, encode, v, b, t, hkv * dh, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * kLog2e;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh == 64)
    err = causal ? launch<64, true>(tq, tk, tv, to, b, s, t, hq, hkv,
                                    scale_log2, num_tiles, st)
                 : launch<64, false>(tq, tk, tv, to, b, s, t, hq, hkv,
                                     scale_log2, num_tiles, st);
  else
    err = causal ? launch<128, true>(tq, tk, tv, to, b, s, t, hq, hkv,
                                     scale_log2, num_tiles, st)
                 : launch<128, false>(tq, tk, tv, to, b, s, t, hq, hkv,
                                      scale_log2, num_tiles, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
