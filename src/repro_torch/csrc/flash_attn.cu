// B10: GQA flash-attention forward (causal, optional window), for Hopper
// (sm_90a), on the f32 FMA units.
//
// Replaces the Pallas kernel `src/repro/kernels/flash_attn.py:84 flash_fwd`
// (`_flash_fwd_kernel`), oracle `src/repro/kernels/ref.py: flash_reference`.
// q (B, Sq, H, Dh), k and v (B, Sk, K, Dh), all bf16 or all f32; o (B, Sq,
// H, Dh) in q's type. Query head h = kv * G + g attends with kv head kv
// (G = H / K), query position p with keys at positions 0..Sk-1. Per row, in
// f32 on inputs converted to f32:
//   s = (q . k) * scale                    scale = f32(1 / sqrt(Dh))
//   with a logit softcap c > 0, an unmasked key's s = c * tanhf(s / c)
//   masked (k_pos > p when causal; k_pos <= p - window with a window): -1e30
//   running (m, l, acc) over tiles of 64 keys, as the TPU kernel's fori_loop
//   o = acc / max(l, 1e-30), rounded to q's type (round to nearest even).
// The mask value is -1e30, not -inf: a row whose first tiles are all masked
// then sums exp(0) = 1 per masked key, and the first unmasked key wipes that
// out with corr = exp(-1e30 - m) = 0, as in the TPU kernel. Keys past Sk (the
// ragged last tile) are -inf instead, so they weigh 0 in every row. The cap
// (the reference's `_chunk_attn_update`: scale, cap, then mask) never
// touches the masked value: capped, -1e30 would become -c, and a masked key
// would weigh exp(-c - m) instead of 0. A capped score lies in (-c, c), so
// the first unmasked key still wipes out the masked leading tiles.
//
// What bounds it: operations. At the serving path's prefill (B 4, S 2048,
// H 16, K 8, Dh 128, causal, bf16) the band holds 68.7 GFLOP (QK^T and PV,
// 2 flops per multiply-add), ~69.5 us at the bf16 tensor-core peak of 989
// TFLOP/s, against ~30 us for its 100.7 MB of q/k/v/o at 3.35 TB/s. This
// first kernel keeps B10's f32 contract and so does not use the tensor
// cores (bf16 `mma` would round p before the PV product): its floor is the
// 67 TFLOP/s f32 FMA rate, ~1 ms per call. What the design does:
//   * one CTA per (batch, kv head, 64 query rows), a row being a (position,
//     query head) pair of that kv head taken position-major, so each K/V
//     tile loaded into shared memory serves all G query heads of its kv
//     head, as the TPU kernel's (B*K, G, Sq/bq) grid shares one kv stream;
//   * 128 threads, each owning a 4 x 8 block of the 64 x 64 score tile
//     (float4 reads along Dh from padded rows, no bank conflicts) and a
//     4 x 16 block of the output accumulator in registers; row max and row
//     sum combine over the 8 lanes of a row group by shuffles;
//   * tiles wholly outside the CTA's causal/window band are skipped when
//     every row of the CTA has a key in its band (the result is the same:
//     a masked key after the band weighs exp(-1e30 - m) = 0, one before it
//     is wiped by corr = 0), and CTAs start longest first;
//   * the score tile's shared memory is reused for p once the scores are in
//     registers: 100,352 bytes at Dh 128, two CTAs per SM;
//   * heads wider than 128 (up to 256, recurrentgemma's) run a second
//     instance whose threads own 4 x 32 accumulator columns: 198,656 bytes
//     of shared memory at Dh 256, one CTA per SM. The same f32 arithmetic,
//     so the same 2e-4 contract.
// bf16 inputs with Dh a multiple of 16 run on the tensor-core kernel of
// `flash_attn_tc.cu` instead (`kernels/flash_attn.py: kernel_for`); this
// kernel takes float32 and the shapes outside that rule. PERF.md holds the
// times of both.

#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kRows = 64;      // (position, head) query rows per CTA
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kMaxDh = 256;
constexpr int kPStride = kKeys + 4;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Columns d..d+3 of a row as f32, zero past Dh.
template <typename T>
__device__ __forceinline__ float4 load4(const T* row, int d, int Dh) {
  return make_float4(d < Dh ? to_f32(row[d]) : 0.f, d + 1 < Dh ? to_f32(row[d + 1]) : 0.f,
                     d + 2 < Dh ? to_f32(row[d + 2]) : 0.f, d + 3 < Dh ? to_f32(row[d + 3]) : 0.f);
}

__device__ __forceinline__ float comp(const float4& a, int e) {
  return e == 0 ? a.x : (e == 1 ? a.y : (e == 2 ? a.z : a.w));
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Floats of dynamic shared memory: Q rows, the K tile (reused for p), V.
__host__ __device__ __forceinline__ int smem_floats(int dh) {
  const int qk = round4(dh) + 4;
  const int k_region = kKeys * qk > kRows * kPStride ? kKeys * qk : kRows * kPStride;
  return kRows * qk + k_region + kKeys * round4(dh);
}

// MAXDH (128 or 256) sizes the output accumulator: a thread owns MAXDH / 8
// columns of each of its 4 rows.
template <typename T, int MAXDH>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int K,
                 int Dh, int window, int causal, float scale, float softcap) {
  constexpr int kAccPerRow = MAXDH / 8;  // output columns a thread owns per row
  extern __shared__ float4 smem4[];
  const int dpad = round4(Dh);
  const int qk = dpad + 4;  // padded row: float4 reads of 4 rows hit 4 bank groups
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kRows * qk;
  float* sP = sK;  // p overwrites the K tile once the scores are in registers
  const int k_region = kKeys * qk > kRows * kPStride ? kKeys * qk : kRows * kPStride;
  float* sV = sK + k_region;

  const int G = H / K;
  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest (latest) rows first
  const int kv = blockIdx.y;
  const long long b = blockIdx.z;
  const long long row0 = static_cast<long long>(tile) * kRows;  // row = position * G + g
  const long long rows_total = static_cast<long long>(Sq) * G;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;

  // Tile loads: each thread moves 4 consecutive columns of a row per pass
  // (coalesced along Dh), `pass_rows` rows apart, zero past Dh.
  const int cols4 = dpad >> 2;
  const int ld_row = tid / cols4;
  const int ld_col = (tid - ld_row * cols4) * 4;
  const int pass_rows = kThreads / cols4;
  const bool loads = ld_row < pass_rows;
  if (loads) {
    for (int r = ld_row; r < kRows; r += pass_rows) {
      const long long gr = row0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < rows_total) {
        const long long pos = gr / G;
        const int g = static_cast<int>(gr - pos * G);
        x = load4(q + ((b * Sq + pos) * H + kv * G + g) * Dh, ld_col, Dh);
      }
      *reinterpret_cast<float4*>(&sQ[r * qk + ld_col]) = x;
    }
  }

  // Key tiles: all of them, or only the CTA's band when every row has a key
  // in its own band (position < Sk; window >= 1 is checked by the wrapper).
  const int n_kt = (Sk + kKeys - 1) / kKeys;
  const int pos_lo = static_cast<int>(row0 / G);
  const long long last = (row0 + kRows - 1) / G;
  const int pos_hi = static_cast<int>(last < Sq - 1 ? last : Sq - 1);
  int kt_begin = 0, kt_end = n_kt;
  if (pos_hi < Sk) {
    if (causal) kt_end = min(n_kt, pos_hi / kKeys + 1);
    if (window > 0) kt_begin = max(0, pos_lo - window + 1) / kKeys;
  }

  int pos_i[4];
  float m[4], l[4], acc[4][kAccPerRow];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pos_i[i] = static_cast<int>((row0 + ty + 16 * i) / G);
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kAccPerRow; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile's p and V reads are done
    if (loads) {
      for (int c = ld_row; c < kKeys; c += pass_rows) {
        const int kp = k0 + c;
        float4 xk = make_float4(0.f, 0.f, 0.f, 0.f), xv = xk;
        if (kp < Sk) {
          const long long off = ((b * Sk + kp) * K + kv) * static_cast<long long>(Dh);
          xk = load4(k + off, ld_col, Dh);
          xv = load4(v + off, ld_col, Dh);
        }
        *reinterpret_cast<float4*>(&sK[c * qk + ld_col]) = xk;
        *reinterpret_cast<float4*>(&sV[c * dpad + ld_col]) = xv;
      }
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dpad; d += 4) {
      float4 qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * qk + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&sK[(tx + 8 * j) * qk + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kb[j].x, t);
          t = fmaf(qa[i].y, kb[j].y, t);
          t = fmaf(qa[i].z, kb[j].z, t);
          t = fmaf(qa[i].w, kb[j].w, t);
          s[i][j] = t;
        }
    }
    __syncthreads();  // every thread's reads of the K tile are done: p may overwrite it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pos_i[i];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        const bool ok = (!causal || kp <= p) && (window <= 0 || kp > p - window);
        float x = kp >= Sk ? -CUDART_INF_F : kMasked;
        if (kp < Sk && ok) {
          x = s[i][j] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * kPStride + tx + 8 * j] = pj;
        sum += pj;
      }
      sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
      sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 2);
      sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kAccPerRow; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kKeys; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&sP[(ty + 16 * i) * kPStride + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < kAccPerRow / 4; ++jj) {
          const int d = tx * 4 + 32 * jj;
          if (d >= dpad) continue;
          const float4 vb = *reinterpret_cast<const float4*>(&sV[(c + cc) * dpad + d]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = comp(pa[i], cc);
            acc[i][jj * 4 + 0] = fmaf(pv, vb.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(pv, vb.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(pv, vb.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(pv, vb.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gr = row0 + ty + 16 * i;
    if (gr >= rows_total) continue;
    const long long pos = gr / G;
    const int g = static_cast<int>(gr - pos * G);
    T* orow = o + ((b * Sq + pos) * H + kv * G + g) * static_cast<long long>(Dh);
    const float den = fmaxf(l[i], 1e-30f);
    // the row's log-sum-exp for the backward, (B, H, Sq): one lane of its 8
    if (lse != nullptr && tx == 0) lse[(b * H + kv * G + g) * Sq + pos] = m[i] + logf(den);
#pragma unroll
    for (int jj = 0; jj < kAccPerRow / 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 32 * jj + e;
        if (d < Dh) store(&orow[d], acc[i][jj * 4 + e] / den);
      }
    }
  }
}

template <typename T, int MAXDH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Sk,
           int H, int K, int Dh, int window, int causal, float scale, float softcap,
           cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(smem_floats(Dh)) * sizeof(float);
  cudaError_t err = repro::allow_smem(flash_fwd_kernel<T, MAXDH>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(Sq) * (H / K);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), K, B);
  flash_fwd_kernel<T, MAXDH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, H, K, Dh, window, causal, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, Dh), k/v (B, Sk, K, Dh) -> o (B, Sq, H, Dh), contiguous, all
// bf16 (is_bf16 = 1) or all f32. H % K == 0, 1 <= Dh <= 256, window <= 0
// for none, softcap <= 0 for none (else finite). With a non-null `lse`, also
// each row's log-sum-exp m + log(max(l, 1e-30)) as f32 (B, H, Sq); o is the
// same with or without it. The wrapper checks the shapes; Sq, Sk and B are
// >= 1.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int Sq, int Sk, int H, int K, int Dh, int window,
                               int causal, int is_bf16, float scale, float softcap, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || K < 1 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const float c = softcap > 0.f ? softcap : 0.f;
  if (Dh <= 128)
    return is_bf16
               ? launch<__nv_bfloat16, 128>(q, k, v, o, l, B, Sq, Sk, H, K, Dh, window, causal, scale, c, s)
               : launch<float, 128>(q, k, v, o, l, B, Sq, Sk, H, K, Dh, window, causal, scale, c, s);
  return is_bf16
             ? launch<__nv_bfloat16, 256>(q, k, v, o, l, B, Sq, Sk, H, K, Dh, window, causal, scale, c, s)
             : launch<float, 256>(q, k, v, o, l, B, Sq, Sk, H, K, Dh, window, causal, scale, c, s);
}
