// B10 on Hopper's tensor cores: GQA flash-attention forward (causal,
// optional window) for bf16 inputs, sm_90a.
//
// Replaces the Pallas kernel `src/repro/kernels/flash_attn.py:84 flash_fwd`
// (`_flash_fwd_kernel`), oracle `src/repro/kernels/ref.py: flash_reference`,
// for the inputs `kernels/flash_attn.py: kernel_for` sends here: bf16 q, k,
// v with Dh a multiple of 16 (<= 256), G <= 64, 16-byte aligned. Everything
// else stays on the f32 FMA kernel of `flash_attn.cu`. The contract is that
// kernel's: q (B, Sq, H, Dh) against k/v (B, Sk, K, Dh), query head
// h = kv * G + g with kv head kv, scores scaled by f32(1/sqrt(Dh)), with a
// logit softcap c > 0 an unmasked key's scaled score s becomes
// c * tanhf(s / c) (the masked value is never capped: -c would weigh
// exp(-c - m), not 0), masked scores at -1e30 (a row's fully masked leading
// tiles are wiped by corr = 0), keys past a ragged Sk at -inf,
// o = acc / max(l, 1e-30) rounded to bf16 (round to nearest even).
//
// Why the tensor cores keep that contract:
//   * Q K^T: a product of two bf16 values has at most 16 significant bits,
//     so it is exact in f32; bf16 `wgmma` with an f32 accumulator forms the
//     same products as the TPU kernel's f32 product of q and k widened to
//     f32, and sums them in f32 in another order.
//   * P V: p is f32. Rounding it once to bf16 breaks B10's one-bf16-step
//     tolerance (|d| <= 2^-7 |plain| + 1e-6) wherever positive and negative
//     v cancel. Two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi),
//     carry p to 2^-18 and still put a few outputs of short rows out of it
//     (chip_smoke.py's flash phase counts them, by a torch emulation of the
//     split, on its cases). Three terms do not: p = p_hi + p_mid + p_lo,
//     each the bf16 rounding of what the terms before it leave (exact
//     remainders in f32), carry p to 2^-26, and O += p_hi V + p_mid V +
//     p_lo V runs into one f32 accumulator. l sums the f32 p.
//   * the cap is `tanhf` (a few ulp), applied to the scaled score before
//     the log2 e fold below; `tanh.approx.f32` (~2^-11 relative) would move
//     a score by up to ~0.025 at c = 50;
//   * exp(x - m) is computed as ex2((x - m) * log2 e) by `ex2.approx`
//     (~2 ulp), a rounding-level difference; x - m is taken first, so a
//     masked score against a masked maximum gives exp(0) = 1 exactly. The
//     output is acc times the reciprocal of max(l, 1e-30), within an f32
//     ulp of the quotient.
//
// What bounds it: operations. At the serving path's prefill (B 4, S 2048,
// H 16, K 8, Dh 128, causal) the causal band holds 68.75 GFLOP of Q K^T
// and P V, 69.5 us at the bf16 tensor-core peak of 989 TFLOP/s, against
// 30.0 us for its 100.7 MB of q/k/v/o at 3.35 TB/s. The three-term split
// runs P V three times, 2x the band's tensor work: a floor of ~139 us for
// this design (more with the diagonal tiles' masked half).
//
// The design:
//   * one CTA per (batch, kv head, 128 query rows), a row being a (position,
//     query head g) pair of that kv head taken position-major, so one K/V
//     tile serves all G query heads (the TPU grid (B*K, G, Sq/bq) shares
//     one kv stream likewise); a 1-d grid puts the longest row tiles first
//     across all batches and heads, so the last CTAs to start are short;
//   * three warpgroups: two consumers of 64 rows each (`wgmma`'s M) and one
//     producer, whose one thread keeps a ring of kStages K/V tiles of 64
//     keys filled by TMA (`cp.async.bulk.tensor`, 4-d maps (Dh, K, Sk, B)
//     with 128-byte swizzle), under full/empty mbarriers, so the next tiles
//     load while the current one is multiplied. `setmaxnreg` gives the
//     producer 24 registers and the consumers 240;
//   * Q is loaded once by the consumers into bf16 shared memory in the same
//     128-byte-swizzled layout (64-column chunks of 64 rows x 128 bytes);
//     K, V and Q stay bf16 in shared memory (160 KB at Dh 128, 4 stages);
//   * S = Q K^T by `wgmma.mma_async m64n64k16 .f32.bf16.bf16` with both
//     operands in shared memory, 4 steps per 64 columns of Dh (zeros past
//     Dh: a branch between the steps makes ptxas serialize them); the
//     online softmax runs on the accumulator registers (row max over the 4
//     lanes of a row by shuffles, per-thread partial sums reduced once at
//     the end); the mask is applied only on tiles that cross the band's
//     edge or the ragged Sk;
//   * P V by `wgmma` with A from registers: the S accumulator's layout is
//     the A fragment's, so the three terms are packed in place; V is read
//     through a transposed (MN-major) descriptor, m64n128k16 at Dh > 64;
//   * per consumer, tile i + 1's Q K^T goes to the tensor cores (into a
//     second score buffer) before tile i's rescale and split, and tile i's
//     softmax runs while tile i - 1's P V is on them; consumer 1 starts
//     one softmax after consumer 0. (Strict turn-taking between the two
//     consumers' products, as FlashAttention-3 does, was slower here:
//     issuing a consumer's products stalled it about as long as they ran,
//     so each turn lasted the whole product.)
//   * tiles outside the CTA's causal/window band are skipped when every row
//     has a key in its band, as in the FMA kernel;
//   * the epilogue stages the bf16 output in the warpgroup's Q tile and
//     writes it with 16-byte stores.
// Three instances (`Tiling`), each with and without the cap (`kCap`, so
// that the uncapped code is unchanged): Dh <= 64 and Dh <= 128 as above; Dh 129-256
// (recurrentgemma's 256) keeps the design with K/V tiles of 32 keys, as
// FlashAttention-3 fits head dim 256 into two consumer warpgroups. Its
// output accumulator is 128 f32 registers a consumer thread (4 chunks of
// 64 columns); 32-key tiles halve the two score buffers (16 registers each)
// and the three bf16 terms of p (8 each), so all of it fits the consumers'
// 240. Q K^T is `wgmma m64n32k16` over 16 steps, P V two m64n128k16 halves
// a term and k-step. Shared memory: Q 64 KB, a 4-deep ring of 32-key K/V
// tiles 128 KB, 197,696 bytes with barriers and slack (64-key tiles would
// need 328,704 at 4 stages); each instance checks its bytes at compile
// time. The 256 instance is a first, simple one: PERF.md holds its time.
// A tile's zero fill past Sk or Dh comes from TMA's out-of-bounds fill: B
// has its own dimension in the maps, so a ragged edge never reads the next
// batch's rows.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kWgRows = 64;                // rows per consumer warpgroup (wgmma M)
constexpr int kRows = kConsumers * kWgRows;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kChunk = 64;                 // Dh columns per 128-byte swizzle span
constexpr int kChunkBytes = 64 * 128;      // 64 rows x 128 bytes
constexpr int kMaxGroups = 64;
constexpr int kMaxRows = 0x7FFFFFFF - kRows;  // Sq * G: rows are indexed in 32 bits
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;           // dynamic shared memory a block may use

// The instances: Dh <= 64 and Dh <= 128 take K/V tiles of 64 keys in a ring
// of 4; Dh 256 takes tiles of 32 keys (half the score and p registers) in a
// ring of 4, its 128 accumulator registers beside them.
template <int NCHUNK>
struct Tiling {
  static constexpr int kKeys = NCHUNK == 4 ? 32 : 64;  // keys per K/V tile
  static constexpr int kStages = 4;                    // K/V ring depth
  static constexpr int kKvChunkBytes = kKeys * 128;    // kKeys rows x 128 bytes
  static constexpr int kKvTileBytes = NCHUNK * kKvChunkBytes;
  static constexpr int kQTileBytes = NCHUNK * kChunkBytes;  // one consumer's 64 rows
  // 1024 of alignment slack, Q of both consumers, K and V rings, barriers
  static constexpr int kSmemBytes =
      1024 + kConsumers * kQTileBytes + 2 * kStages * kKvTileBytes + 2 * kStages * 8;
  static_assert(kSmemBytes <= kMaxSmem, "the instance's tiles exceed a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers --
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// -------------------------------------------------------------------- wgmma --
// Shared-memory matrix descriptor, 128-byte swizzle: start >> 4 in bits 0-13,
// leading byte offset >> 4 in 16-29, stride byte offset >> 4 in 32-45,
// layout type 1 (B128) in 62-63.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers the asynchronous wgmma reads or writes at this point of the
// program, so the compiler neither reads an accumulator before the wait nor
// reuses an A fragment's register while the product may still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define REPRO_ACC32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16, K-major in shared memory) B (16 x 64,
// K-major in shared memory); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32, f32) (+)= A (64 x 16, K-major in shared memory) B (16 x 32,
// K-major in shared memory); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16 bf16, four registers a thread) B (16 x 64,
// MN-major in shared memory, i.e. transposed).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same with N = 128: d0 takes columns 0-63, d1 columns 64-127 (B's two
// 64-column chunks, `lbo` bytes apart in the descriptor).
__device__ __forceinline__ void wgmma_rs_t128(float (&d0)[32], float (&d1)[32], const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d0), REPRO_ACC32(d1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef REPRO_ACC32

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The logit softcap of a scaled score (none without kCap).
template <bool kCap>
__device__ __forceinline__ float cap_score(float x, float softcap) {
  if constexpr (kCap) return softcap * tanhf(x / softcap);
  return x;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_elem, float hi_elem) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_elem, hi_elem);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One term of a bf16 split: returns (bf16(x0), bf16(x1)) packed as an A
// fragment register (x0 in the low half) and leaves the remainders
// x - bf16(x), exact in f32, in x0 and x1.
__device__ __forceinline__ uint32_t split_bf16(float& x0, float& x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  x0 -= f.x;
  x1 -= f.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Byte offset of 16-byte unit u (columns 8u..8u+7) of row r in a tile of
// 64-column chunks, 128-byte swizzle: the layout TMA writes and wgmma reads.
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return (u >> 3) * kChunkBytes + r * 128 + (((u & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int NCHUNK, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int B, int Sq, int Sk, int H, int K, int Dh,
                    int window, int causal, float scale, float softcap) {
  using T = Tiling<NCHUNK>;
  constexpr int kKeys = T::kKeys, kStages = T::kStages;
  constexpr int kS = kKeys / 2;  // score accumulator registers a thread (m64 x kKeys)
  constexpr int kP = kKeys / 4;  // A-fragment registers of one bf16 term of p
  constexpr int kTileBytes = T::kKvTileBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kConsumers * T::kQTileBytes;
  const uint32_t sV = sK + kStages * kTileBytes;
  const uint32_t bar_full = sV + kStages * kTileBytes;
  const uint32_t bar_empty = bar_full + kStages * 8;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));

  const int G = H / K;
  // one block index over (row tile, batch, kv head), row tiles longest
  // (latest) first across the whole grid, so the last blocks to start are
  // the shortest
  const int n_row_tiles = (Sq * G + kRows - 1) / kRows;
  const unsigned bk = static_cast<unsigned>(B) * K;  // < 2^31: the entry point checks the grid
  const int tile = n_row_tiles - 1 - static_cast<int>(blockIdx.x / bk);
  const int kv = static_cast<int>(blockIdx.x % K);
  const int b = static_cast<int>(blockIdx.x / K % B);
  const int row0 = tile * kRows;  // row = position * G + g (< 2^31: the entry point checks)
  const int rows_total = Sq * G;

  // Key tiles: all of them, or only the CTA's band when every row has a key
  // in its own band (position < Sk; window >= 1 is checked by the wrapper).
  const int n_kt = (Sk + kKeys - 1) / kKeys;
  const int pos_lo = row0 / G;
  const int pos_hi = min((row0 + kRows - 1) / G, Sq - 1);
  int kt_begin = 0, kt_end = n_kt;
  if (pos_hi < Sk) {
    if (causal) kt_end = min(n_kt, pos_hi / kKeys + 1);
    if (window > 0) kt_begin = max(0, pos_lo - window + 1) / kKeys;
  }
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kConsumers * 128) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(bar_empty + 8 * st, ((i / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * kTileBytes);
        const int k0 = (kt_begin + i) * kKeys;
#pragma unroll
        for (int c = 0; c < NCHUNK; ++c) {
          tma_load_4d(sK + st * kTileBytes + c * T::kKvChunkBytes, &map_k, full, c * kChunk, kv, k0, b);
          tma_load_4d(sV + st * kTileBytes + c * T::kKvChunkBytes, &map_v, full, c * kChunk, kv, k0, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int wrow0 = row0 + wg * kWgRows;
    const uint32_t sQw = sQ + wg * T::kQTileBytes;
    unsigned char* tile_q = smem + (sQw - base);
    const int units = Dh / 8;  // 16-byte units of a row
    const long long q_batch = static_cast<long long>(b) * Sq;

    // Q: this warpgroup's 64 rows, bf16, swizzled; rows past the end and
    // columns past Dh are 0 (K's are TMA's zero fill), so Q K^T always runs
    // NCHUNK * 4 steps: no branch between the wgmmas of a product
    for (int idx = t; idx < kWgRows * NCHUNK * 8; idx += 128) {
      const int r = idx / (NCHUNK * 8), u = idx % (NCHUNK * 8);
      const int gr = wrow0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (gr < rows_total && u < units) {
        const int pos = gr / G, g = gr - pos * G;
        x = *reinterpret_cast<const uint4*>(q + ((q_batch + pos) * H + kv * G + g) * Dh + u * 8);
      }
      *reinterpret_cast<uint4*>(tile_q + swz(r, u)) = x;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
    named_sync(1 + wg, 128);

    // This thread's rows: ra (accumulator elements e with e & 2 == 0) and
    // ra + 8; its columns 8 (e / 4) + 2 (lane % 4) + (e & 1). Keys in
    // [lo, hi] are in a row's band; hi <= Sk - 1.
    const int col = 2 * (lane & 3);
    int band[4];  // lo_a, hi_a, lo_b, hi_b
    {
      const int ra = wrow0 + warp * 16 + lane / 4;
      const int pa = ra / G, pb = (ra + 8) / G;
      band[0] = window > 0 ? pa - window + 1 : 0;
      band[1] = causal ? min(pa, Sk - 1) : Sk - 1;
      band[2] = window > 0 ? pb - window + 1 : 0;
      band[3] = causal ? min(pb, Sk - 1) : Sk - 1;
    }
    // a tile needs the mask when it crosses the band of some row of the
    // warpgroup: past the first row's hi or before the last row's lo
    const int wg_hi = causal ? min(wrow0 / G, Sk - 1) : Sk - 1;
    const int wg_lo = window > 0 ? (wrow0 + kWgRows - 1) / G - window + 1 : 0;

    float acc[NCHUNK][32];
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    float sa[kS], sb[kS];  // two score tiles: one in the softmax, the next on the tensor cores
#pragma unroll
    for (int e = 0; e < kS; ++e) sa[e] = sb[e] = 0.f;
    uint32_t p_hi[kP], p_mid[kP], p_lo[kP];
    float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;
    float corr_a = 1.f, corr_b = 1.f;

    // S = Q K^T of tile i into s (issued and committed, not waited)
    auto issue_qk = [&](int i, float (&s)[kS]) {
      const int st = i % kStages;
      mbar_wait(bar_full + 8 * st, (i / kStages) & 1);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NCHUNK * 4; ++ks) {
        const uint32_t col = (ks % 4) * 32;  // 16 columns of the 64-column chunk ks / 4
        wgmma_ss(s, desc_b128(sQw + (ks / 4) * kChunkBytes + col, 0, 1024),
                 desc_b128(sK + st * kTileBytes + (ks / 4) * T::kKvChunkBytes + col, 0, 1024), ks);
      }
      wgmma_commit();
    };
    // The online softmax of tile i's scores in s: s becomes p = exp(x - m)
    // (f32), l and m move on, corr = exp(m_old - m_new)
    auto softmax = [&](int i, float (&s)[kS]) {
      const int k0 = (kt_begin + i) * kKeys;
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
      if (k0 + kKeys - 1 > wg_hi || k0 < wg_lo) {
#pragma unroll
        for (int e = 0; e < kS; ++e) {
          const int key = k0 + 8 * (e / 4) + col + (e & 1);
          const int lo = band[(e & 2) ? 2 : 0], hi = band[(e & 2) ? 3 : 1];
          const float x = key >= Sk ? -CUDART_INF_F
                                    : (key >= lo && key <= hi ? cap_score<kCap>(s[e] * scale, softcap)
                                                              : kMasked);
          s[e] = x;
          if (e & 2) mx_b = fmaxf(mx_b, x); else mx_a = fmaxf(mx_a, x);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kS; ++e) {
          s[e] = cap_score<kCap>(s[e] * scale, softcap);
          if (e & 2) mx_b = fmaxf(mx_b, s[e]); else mx_a = fmaxf(mx_a, s[e]);
        }
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      corr_a = ex2((m_a - mn_a) * kLog2e);
      corr_b = ex2((m_b - mn_b) * kLog2e);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int e = 0; e < kS; ++e) {
        // subtract first: x = m = -1e30 must give exp(0) = 1 exactly
        s[e] = ex2((s[e] - ((e & 2) ? mn_b : mn_a)) * kLog2e);
        if (e & 2) sum_b += s[e]; else sum_a += s[e];
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
    };
    auto rescale = [&]() {
#pragma unroll
      for (int c = 0; c < NCHUNK; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] *= (e & 2) ? corr_b : corr_a;
    };
    // O += p_hi V + p_mid V + p_lo V for tile i, p = p_hi + p_mid + p_lo in
    // bf16 to 2^-26 of p (fragment register r of k-step kk holds
    // accumulator elements 8 kk + 2 r and 8 kk + 2 r + 1)
    auto issue_pv = [&](int i, const float (&s)[kS]) {
#pragma unroll
      for (int e = 0; e < kS; e += 2) {
        float r0 = s[e], r1 = s[e + 1];
        p_hi[e / 2] = split_bf16(r0, r1);
        p_mid[e / 2] = split_bf16(r0, r1);
        p_lo[e / 2] = pack_bf16(r0, r1);
      }
#pragma unroll
      for (int c = 0; c < NCHUNK; ++c) fence_regs(acc[c]);
      fence_regs(p_hi);
      fence_regs(p_mid);
      fence_regs(p_lo);
      wgmma_fence();
      const uint32_t tV = sV + (i % kStages) * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        // 16 keys: rows kk*16.. of 128 bytes, 8-row groups 1024 apart, the
        // next 64 columns of V a chunk (kKvChunkBytes) on
        const uint64_t dv = desc_b128(tV + kk * 2048, T::kKvChunkBytes, 1024);
        if constexpr (NCHUNK == 4) {  // two N = 128 halves: columns 0-127, then 128-255
          const uint64_t dv2 = desc_b128(tV + 2 * T::kKvChunkBytes + kk * 2048, T::kKvChunkBytes, 1024);
          wgmma_rs_t128(acc[0], acc[1], p_hi + 4 * kk, dv);
          wgmma_rs_t128(acc[2], acc[3], p_hi + 4 * kk, dv2);
          wgmma_rs_t128(acc[0], acc[1], p_mid + 4 * kk, dv);
          wgmma_rs_t128(acc[2], acc[3], p_mid + 4 * kk, dv2);
          wgmma_rs_t128(acc[0], acc[1], p_lo + 4 * kk, dv);
          wgmma_rs_t128(acc[2], acc[3], p_lo + 4 * kk, dv2);
        } else if constexpr (NCHUNK == 2) {
          wgmma_rs_t128(acc[0], acc[1], p_hi + 4 * kk, dv);
          wgmma_rs_t128(acc[0], acc[1], p_mid + 4 * kk, dv);
          wgmma_rs_t128(acc[0], acc[1], p_lo + 4 * kk, dv);
        } else {
          wgmma_rs_t(acc[0], p_hi + 4 * kk, dv);
          wgmma_rs_t(acc[0], p_mid + 4 * kk, dv);
          wgmma_rs_t(acc[0], p_lo + 4 * kk, dv);
        }
      }
      wgmma_commit();
    };
    // tile i - 1's P V is done: its K/V stage goes back to the producer
    auto release = [&](int i) {
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NCHUNK; ++c) fence_regs(acc[c]);
      fence_regs(p_hi);
      fence_regs(p_mid);
      fence_regs(p_lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * ((i - 1) % kStages));
    };
    // Tile i: its softmax overlaps tile i - 1's P V on the tensor cores,
    // and tile i + 1's Q K^T runs there while this consumer rescales and
    // splits.
    auto step = [&](int i, float (&cur)[kS], float (&next)[kS]) {
      wgmma_wait<1>();  // tile i's Q K^T
      fence_regs(cur);
      softmax(i, cur);
      release(i);
      if (i + 1 < n_tiles) issue_qk(i + 1, next);
      rescale();
      issue_pv(i, cur);
    };

    // Consumer 1 starts once consumer 0 has its first p, so the two
    // consumers' softmaxes fall between each other's products.
    if (wg == 1) named_sync(3, 256);
    issue_qk(0, sa);
    wgmma_wait<0>();
    fence_regs(sa);
    softmax(0, sa);
    if (n_tiles > 1) issue_qk(1, sb);
    issue_pv(0, sa);
    if (wg == 0) named_arrive(3, 256);
    int i = 1;
    for (; i + 1 < n_tiles; i += 2) {
      step(i, sb, sa);
      step(i + 1, sa, sb);
    }
    if (i < n_tiles) step(i, sb, sa);
    release(n_tiles);

    // l: the four lanes of a row hold partial sums
    l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, 1);
    l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, 2);
    l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, 1);
    l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, 2);
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
    // each row's log-sum-exp for the backward, (B, H, Sq): one lane of its 4
    if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gr = wrow0 + warp * 16 + lane / 4 + 8 * half;
        if (gr < rows_total) {
          const int pos = gr / G, g = gr - pos * G;
          lse[(static_cast<long long>(b) * H + kv * G + g) * Sq + pos] =
              half ? m_b + logf(fmaxf(l_b, 1e-30f)) : m_a + logf(fmaxf(l_a, 1e-30f));
        }
      }
    }

    // o = acc / max(l, 1e-30) (as acc times the reciprocal) in bf16, staged
    // in this warpgroup's Q tile (its last read by wgmma has completed),
    // then 16-byte stores
    const int r_a = warp * 16 + lane / 4;
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const float inv = (e & 2) ? inv_b : inv_a;
        const int r = r_a + ((e & 2) ? 8 : 0);
        *reinterpret_cast<uint32_t*>(tile_q + swz(r, c * 8 + e / 4) + col * 2) =
            pack_bf16(acc[c][e] * inv, acc[c][e + 1] * inv);
      }
    }
    named_sync(1 + wg, 128);
    for (int idx = t; idx < kWgRows * units; idx += 128) {
      const int r = idx / units, u = idx - r * units;
      const int gr = wrow0 + r;
      if (gr >= rows_total) continue;
      const int pos = gr / G, g = gr - pos * G;
      *reinterpret_cast<uint4*>(o + ((q_batch + pos) * H + kv * G + g) * Dh + u * 8) =
          *reinterpret_cast<const uint4*>(tile_q + swz(r, u));
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda's), found through the runtime's entry-point
// query, so the library needs no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Errors the tensor-map encoder reports come back as 100000 + CUresult.
constexpr int kEncodeError = 100000;

// A map of k or v (B, Sk, K, Dh) bf16 as the 4-d tensor (Dh, K, Sk, B),
// boxes of 64 columns x 1 head x `keys` keys x 1 batch, 128-byte swizzle,
// zero fill out of bounds.
int encode_kv(CUtensorMap* map, const void* ptr, int B, int Sk, int K, int Dh, int keys) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Dh), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(Sk), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(Dh) * 2;
  const cuuint64_t strides[3] = {row, row * K, row * K * Sk};
  const cuuint32_t box[4] = {kChunk, 1, static_cast<cuuint32_t>(keys), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int NCHUNK, bool kCap>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Sk,
           int H, int K, int Dh, int window, int causal, float scale, float softcap,
           cudaStream_t stream) {
  CUtensorMap map_k, map_v;
  int err = encode_kv(&map_k, k, B, Sk, K, Dh, Tiling<NCHUNK>::kKeys);
  if (err == 0) err = encode_kv(&map_v, v, B, Sk, K, Dh, Tiling<NCHUNK>::kKeys);
  if (err != 0) return err;
  const size_t bytes = Tiling<NCHUNK>::kSmemBytes;
  const cudaError_t attr = repro::allow_smem(flash_fwd_tc_kernel<NCHUNK, kCap>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long rows = static_cast<long long>(Sq) * (H / K);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows * B * K));
  flash_fwd_tc_kernel<NCHUNK, kCap><<<grid, kThreads, bytes, stream>>>(
      map_k, map_v, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), lse, B, Sq,
      Sk, H, K, Dh, window, causal, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int NCHUNK>
int launch_cap(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
               int Sk, int H, int K, int Dh, int window, int causal, float scale, float softcap,
               cudaStream_t stream) {
  return softcap > 0.f
             ? launch<NCHUNK, true>(q, k, v, o, lse, B, Sq, Sk, H, K, Dh, window, causal, scale, softcap,
                                    stream)
             : launch<NCHUNK, false>(q, k, v, o, lse, B, Sq, Sk, H, K, Dh, window, causal, scale, 0.f,
                                     stream);
}

}  // namespace

// q (B, Sq, H, Dh), k/v (B, Sk, K, Dh) -> o (B, Sq, H, Dh): contiguous bf16,
// 16-byte aligned, H % K == 0, H / K <= 64, Sq * (H / K) < 2^31 - 128,
// Dh % 16 == 0 and 16 <= Dh <= 256, window <= 0 for none, softcap <= 0 for
// none (else finite); Sq, Sk and B >= 1. With a non-null `lse`, also each
// row's log-sum-exp m + log(max(l, 1e-30)) as f32 (B, H, Sq); o is the same
// with or without it. The wrapper checks the shapes. Returns a cudaError_t,
// or 100000 + the CUresult of a refused tensor map.
extern "C" int repro_flash_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int B, int Sq, int Sk, int H, int K, int Dh, int window,
                                  int causal, float scale, float softcap, void* stream) {
  if (Dh < 16 || Dh > 4 * kChunk || Dh % 16 != 0 || K < 1 || H % K != 0 || H / K > kMaxGroups ||
      static_cast<long long>(Sq) * (H / K) > kMaxRows ||
      (static_cast<long long>(Sq) * (H / K) + kRows - 1) / kRows * B * K > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const float c = softcap > 0.f ? softcap : 0.f;
  if (Dh <= kChunk) return launch_cap<1>(q, k, v, o, l, B, Sq, Sk, H, K, Dh, window, causal, scale, c, s);
  if (Dh <= 2 * kChunk) return launch_cap<2>(q, k, v, o, l, B, Sq, Sk, H, K, Dh, window, causal, scale, c, s);
  return launch_cap<4>(q, k, v, o, l, B, Sq, Sk, H, K, Dh, window, causal, scale, c, s);
}

// Dynamic shared memory a launch at head_dim `Dh` requests, in bytes.
extern "C" int repro_flash_fwd_tc_smem(int Dh) {
  return Dh <= kChunk       ? Tiling<1>::kSmemBytes
         : Dh <= 2 * kChunk ? Tiling<2>::kSmemBytes
                            : Tiling<4>::kSmemBytes;
}
