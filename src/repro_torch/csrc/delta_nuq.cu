// B6/B7: block ADPCM (delta + mu-law NUQ) encode and decode, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels `src/repro/kernels/delta_nuq.py: encode` and
// `decode` (`_encode_kernel`, `_decode_kernel`), oracles
// `src/repro/kernels/ref.py: delta_nuq_encode_ref` / `_decode_ref`. Four
// entry points, two forms of the same recurrence:
//
//   * the Pallas contract (repro_adpcm_tile_encode / _decode): (S, T) float32
//     substreams cut into tiles of t_tile; each tile starts from its raw
//     sample, bit-cast into code[0]; later samples carry the code of the
//     clipped delta against the running reconstruction, dequantized without
//     integer snapping. One thread per (row, tile) walks a chain of
//     t_tile - 1 steps.
//   * the codec form (repro_adpcm_lane_encode / _decode) of
//     `src/repro/core/algorithms/adpcm.py`: C blocks (C, L, B) of uint32
//     tuples, one thread per lane walking its C*B tuples with the
//     reconstruction `xhat` and the `init` flag carried in and out. The
//     input clips to vmax, a fresh lane's first symbol is the raw 32-bit
//     tuple, dequantized deltas snap to integers, `xhat` clips to
//     [0, vmax], and the decode rounds to uint32 with saturation. Codes are
//     written as the codec's (C, L, B, 2) symbol slots and (C, L, B) bitlens.
//
// The mu-law quantizer is two host-built tables (core/algorithms/nuq.py):
// `thr` (levels float32: the smallest input of each code 1..levels) and
// `dec` (levels + 1 float32: each magnitude code's value). Encoding a
// magnitude is an upper-bound binary search in `thr`, decoding a lookup in
// `dec`, so no transcendental runs here and the card reproduces the plain
// versions bit for bit. The tables sit in shared memory when the magnitude
// width is at most 13 bits (qbits <= 14: 64 KiB together); wider tables are
// read from global memory through L1 (`__ldg`). The only arithmetic on the
// chain is one subtraction and one addition per step, written as
// `__fsub_rn`/`__fadd_rn` so nvcc cannot fuse or reorder them.
//
// What bounds it: neither bytes nor operations but the chain's latency.
// Each step depends on the previous step's `xhat` through a clip, a binary
// search of log2(levels) dependent shared-memory loads, a lookup and an
// add. The contract form at S=1024, T=4096, t_tile=128 has 32,768 threads
// of 127 steps; the codec form has as many threads as lanes (4 at the
// executor's default geometry), each walking C*B = 65,536 steps per
// 128-block chunk: the paper's private per-lane state, with nothing for the
// card to overlap but the lanes themselves. Decode has no search on its
// chain (the lookups depend only on the codes), only the add and the clip.

#include "common.cuh"

namespace {

constexpr int kTileThreads = 128;
constexpr int kLaneThreads = 32;
constexpr int kSmemMagBits = 13;

// Number of thresholds <= a (thr ascending): the magnitude code of a.
__device__ __forceinline__ uint32_t count_le(const float* __restrict__ thr, int n, float a) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (thr[mid] <= a) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return static_cast<uint32_t>(lo);
}

// jnp.clip(v, lo, hi) == minimum(maximum(v, lo), hi)
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

struct Quantizer {
  const float* thr;
  const float* dec;
  int levels;  // 2^(qbits-1) - 1
  int qbits;

  // Signed code of a delta d and its dequantized value.
  __device__ __forceinline__ uint32_t encode(float d, float* dq) const {
    const bool neg = d < 0.0f;
    const uint32_t mag = count_le(thr, levels, fabsf(d));
    const float m = dec[mag];
    *dq = neg ? -m : m;
    return (static_cast<uint32_t>(neg) << (qbits - 1)) | mag;
  }

  __device__ __forceinline__ float decode(uint32_t code) const {
    const float m = dec[code & static_cast<uint32_t>(levels)];
    return ((code >> (qbits - 1)) & 1u) ? -m : m;
  }
};

// Stage the tables in shared memory when they fit; every thread of the
// block must call it (it synchronises).
__device__ __forceinline__ Quantizer load_quantizer(const float* thr, const float* dec,
                                                    int qbits, float* smem) {
  const int levels = (1 << (qbits - 1)) - 1;
  if (qbits - 1 > kSmemMagBits) return Quantizer{thr, dec, levels, qbits};
  for (int i = threadIdx.x; i < levels; i += blockDim.x) smem[i] = __ldg(thr + i);
  for (int i = threadIdx.x; i <= levels; i += blockDim.x) smem[levels + i] = __ldg(dec + i);
  __syncthreads();
  return Quantizer{smem, smem + levels, levels, qbits};
}

size_t smem_bytes(int qbits) {
  const int levels = (1 << (qbits - 1)) - 1;
  return qbits - 1 > kSmemMagBits ? 0 : sizeof(float) * (2 * static_cast<size_t>(levels) + 1);
}

__global__ void __launch_bounds__(kTileThreads)
tile_encode_kernel(const float* __restrict__ x, int rows, int t, int t_tile, float dmax,
                   const float* __restrict__ thr, const float* __restrict__ dec, int qbits,
                   uint32_t* __restrict__ codes) {
  extern __shared__ float smem[];
  const Quantizer q = load_quantizer(thr, dec, qbits, smem);
  const int tiles = t / t_tile;
  const long long i = static_cast<long long>(blockIdx.x) * kTileThreads + threadIdx.x;
  if (i >= static_cast<long long>(rows) * tiles) return;
  const long long off = (i / tiles) * t + (i % tiles) * t_tile;
  const float* row = x + off;
  uint32_t* out = codes + off;
  float xhat = row[0];
  out[0] = __float_as_uint(xhat);  // the tile's raw reference sample
  for (int k = 1; k < t_tile; ++k) {
    const float d = clip(__fsub_rn(row[k], xhat), -dmax, dmax);
    float dq;
    out[k] = q.encode(d, &dq);
    xhat = __fadd_rn(xhat, dq);
  }
}

__global__ void __launch_bounds__(kTileThreads)
tile_decode_kernel(const uint32_t* __restrict__ codes, int rows, int t, int t_tile,
                   const float* __restrict__ thr, const float* __restrict__ dec, int qbits,
                   float* __restrict__ x) {
  extern __shared__ float smem[];
  const Quantizer q = load_quantizer(thr, dec, qbits, smem);
  const int tiles = t / t_tile;
  const long long i = static_cast<long long>(blockIdx.x) * kTileThreads + threadIdx.x;
  if (i >= static_cast<long long>(rows) * tiles) return;
  const long long off = (i / tiles) * t + (i % tiles) * t_tile;
  const uint32_t* in = codes + off;
  float* out = x + off;
  float xhat = __uint_as_float(in[0]);
  out[0] = xhat;
  for (int k = 1; k < t_tile; ++k) {
    xhat = __fadd_rn(xhat, q.decode(in[k]));
    out[k] = xhat;
  }
}

__global__ void __launch_bounds__(kLaneThreads)
lane_encode_kernel(const uint32_t* __restrict__ blocks, int chunks, int lanes, int b,
                   float* __restrict__ xhat_io, uint8_t* __restrict__ init_io,
                   uint32_t vmax_u, float vmax, float dmax, const float* __restrict__ thr,
                   const float* __restrict__ dec, int qbits, int width,
                   uint32_t* __restrict__ codes, int* __restrict__ bitlen) {
  extern __shared__ float smem[];
  const Quantizer q = load_quantizer(thr, dec, qbits, smem);
  const int lane = blockIdx.x * kLaneThreads + threadIdx.x;
  if (lane >= lanes) return;
  float xhat = xhat_io[lane];
  bool fresh = init_io[lane] == 0;
  for (int c = 0; c < chunks; ++c) {
    const long long base = (static_cast<long long>(c) * lanes + lane) * b;
#pragma unroll 4
    for (int k = 0; k < b; ++k) {
      const uint32_t v = blocks[base + k];
      const float xf = __uint2float_rn(min(v, vmax_u));
      if (fresh) xhat = xf;  // predictor bootstrap from the raw sample
      const float d = clip(__fsub_rn(xf, xhat), -dmax, dmax);
      float dq;
      uint32_t code = q.encode(d, &dq);
      xhat = clip(__fadd_rn(xhat, dq), 0.0f, vmax);
      int blen = width;
      if (fresh) {  // the raw 32-bit reference symbol
        code = v;
        blen = 32;
        fresh = false;
      }
      codes[2 * (base + k)] = code;
      codes[2 * (base + k) + 1] = 0u;
      bitlen[base + k] = blen;
    }
  }
  xhat_io[lane] = xhat;
  init_io[lane] = 1;
}

__global__ void __launch_bounds__(kLaneThreads)
lane_decode_kernel(const uint32_t* __restrict__ codes, int chunks, int lanes, int b,
                   float* __restrict__ xhat_io, uint8_t* __restrict__ init_io,
                   uint32_t vmax_u, float vmax, const float* __restrict__ thr,
                   const float* __restrict__ dec, int qbits, uint32_t* __restrict__ out) {
  extern __shared__ float smem[];
  const Quantizer q = load_quantizer(thr, dec, qbits, smem);
  const int lane = blockIdx.x * kLaneThreads + threadIdx.x;
  if (lane >= lanes) return;
  float xhat = xhat_io[lane];
  bool fresh = init_io[lane] == 0;
  for (int c = 0; c < chunks; ++c) {
    const long long base = (static_cast<long long>(c) * lanes + lane) * b;
#pragma unroll 4
    for (int k = 0; k < b; ++k) {
      const uint32_t code = codes[2 * (base + k)];
      float dq;
      if (fresh) {  // raw reference symbol: restart the reconstruction
        xhat = __uint2float_rn(min(code, vmax_u));
        dq = 0.0f;
        fresh = false;
      } else {
        dq = q.decode(code);
      }
      xhat = clip(__fadd_rn(xhat, dq), 0.0f, vmax);
      const float r = rintf(xhat);  // jnp.round: half to even
      out[base + k] = r >= 4294967296.0f ? 0xFFFFFFFFu : static_cast<uint32_t>(r);
    }
  }
  xhat_io[lane] = xhat;
  init_io[lane] = 1;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int qbits, size_t* smem) {
  *smem = smem_bytes(qbits);
  return repro::allow_smem(kernel, *smem);
}

}  // namespace

// x float32[rows, t] -> codes uint32[rows, t]; t % t_tile == 0. thr float32
// [levels], dec float32[levels + 1] with levels = 2^(qbits-1) - 1.
extern "C" int repro_adpcm_tile_encode(const void* x, int rows, int t, int t_tile, float dmax,
                                       const void* thr, const void* dec, int qbits,
                                       void* codes, void* stream) {
  const long long threads = static_cast<long long>(rows) * (t / t_tile);
  if (threads == 0) return 0;
  size_t smem;
  cudaError_t err = prepare(tile_encode_kernel, qbits, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((threads + kTileThreads - 1) / kTileThreads);
  tile_encode_kernel<<<grid, kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, t, t_tile, dmax, static_cast<const float*>(thr),
      static_cast<const float*>(dec), qbits, static_cast<uint32_t*>(codes));
  return static_cast<int>(cudaGetLastError());
}

// codes uint32[rows, t] -> x float32[rows, t].
extern "C" int repro_adpcm_tile_decode(const void* codes, int rows, int t, int t_tile,
                                       const void* thr, const void* dec, int qbits, void* x,
                                       void* stream) {
  const long long threads = static_cast<long long>(rows) * (t / t_tile);
  if (threads == 0) return 0;
  size_t smem;
  cudaError_t err = prepare(tile_decode_kernel, qbits, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((threads + kTileThreads - 1) / kTileThreads);
  tile_decode_kernel<<<grid, kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes), rows, t, t_tile, static_cast<const float*>(thr),
      static_cast<const float*>(dec), qbits, static_cast<float*>(x));
  return static_cast<int>(cudaGetLastError());
}

// blocks uint32[chunks, lanes, b], xhat float32[lanes] and init uint8[lanes]
// (updated in place) -> codes uint32[chunks, lanes, b, 2], bitlen
// int32[chunks, lanes, b].
extern "C" int repro_adpcm_lane_encode(const void* blocks, int chunks, int lanes, int b,
                                       void* xhat, void* init, unsigned vmax_u, float vmax,
                                       float dmax, const void* thr, const void* dec, int qbits,
                                       int width, void* codes, void* bitlen, void* stream) {
  if (lanes == 0) return 0;
  size_t smem;
  cudaError_t err = prepare(lane_encode_kernel, qbits, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((lanes + kLaneThreads - 1) / kLaneThreads);
  lane_encode_kernel<<<grid, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), chunks, lanes, b, static_cast<float*>(xhat),
      static_cast<uint8_t*>(init), vmax_u, vmax, dmax, static_cast<const float*>(thr),
      static_cast<const float*>(dec), qbits, width, static_cast<uint32_t*>(codes),
      static_cast<int*>(bitlen));
  return static_cast<int>(cudaGetLastError());
}

// codes uint32[chunks, lanes, b, 2] (word 0 read), xhat/init as above ->
// out uint32[chunks, lanes, b].
extern "C" int repro_adpcm_lane_decode(const void* codes, int chunks, int lanes, int b,
                                       void* xhat, void* init, unsigned vmax_u, float vmax,
                                       const void* thr, const void* dec, int qbits, void* out,
                                       void* stream) {
  if (lanes == 0) return 0;
  size_t smem;
  cudaError_t err = prepare(lane_decode_kernel, qbits, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((lanes + kLaneThreads - 1) / kLaneThreads);
  lane_decode_kernel<<<grid, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes), chunks, lanes, b, static_cast<float*>(xhat),
      static_cast<uint8_t*>(init), vmax_u, vmax, static_cast<const float*>(thr),
      static_cast<const float*>(dec), qbits, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
