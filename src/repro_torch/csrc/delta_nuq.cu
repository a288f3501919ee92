// B6/B7: block ADPCM (delta + mu-law NUQ) encode and decode, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels `src/repro/kernels/delta_nuq.py: encode` and
// `decode` (`_encode_kernel`, `_decode_kernel`), oracles
// `src/repro/kernels/ref.py: delta_nuq_encode_ref` / `_decode_ref`. Two
// forms of the same recurrence:
//
//   * the Pallas contract (repro_adpcm_tile_encode / _decode): (S, T) float32
//     substreams cut into tiles of t_tile; each tile starts from its raw
//     sample, bit-cast into code[0]; later samples carry the code of the
//     clipped delta against the running reconstruction, dequantized without
//     integer snapping. One thread per (row, tile) walks a chain of
//     t_tile - 1 steps.
//   * the codec form of `src/repro/core/algorithms/adpcm.py`: C blocks
//     (C, L, B) of uint32 tuples, one walk per lane over its C*B tuples
//     (block c's row of the lane, then block c + 1's) with the
//     reconstruction `xhat` and the `init` flag carried in and out. The
//     input clips to vmax, a fresh lane's first symbol is the raw 32-bit
//     tuple, dequantized deltas snap to integers, `xhat` clips to
//     [0, vmax], and the decode rounds to uint32 with saturation. Codes are
//     written as the codec's (C, L, B, 2) symbol slots and (C, L, B) bitlens.
//     Four entry points:
//       - repro_adpcm_lane_encode: the speculative segmented encode (below);
//       - repro_adpcm_lane_decode: the clamp-add scan decode (below), for
//         parameters inside the integer rule of
//         `kernels/delta_nuq.py: decode_kernel_for`;
//       - repro_adpcm_lane_encode_serial / _decode_serial: one thread per
//         lane walking its tuples in order. The serial decode takes the
//         parameters outside the rule; the serial encode is on no path and
//         stays as the card-side oracle of the speculative one.
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
// What bounds the codec form: neither bytes nor operations but the chain's
// latency. A lane's walk is one dependent chain of C*B = 65,536 steps per
// 128-block chunk at the executor's default geometry (4 lanes), each step a
// clip, a quantizer search, a lookup and an add. The serial kernels walk it
// as it stands, 4 threads on the card. The redesign cuts the chain:
//
//   * Encode: the state is one float32, and two walks whose state bits
//     agree at a step agree from then on. A lane's walk is cut into
//     segments of kSeg tuples, one thread each, kSpecTile tuples per CTA.
//     Segment 0 of the lane starts from the carried state; every other
//     segment from a guess, the clipped raw sample kWarm tuples before it
//     walked forward over those kWarm tuples. Each thread walks its segment
//     and stores its codes. Then rounds until a fixed point: a segment
//     whose start bits differ from its predecessor's end re-walks from that
//     end, replaying its own stored trajectory beside it (the decode step
//     of its codes), and stops where the two states' bits agree, since its
//     codes from there on stand. Across CTAs, the last CTA of a lane to
//     finish (a counter, no spin) walks the chain of tile boundaries and
//     resolves again, from the true start, each tile whose first segment
//     started elsewhere. On a stream whose guesses never converge the
//     rounds degrade to a serial walk, still exact. Inputs and codes go
//     through shared memory (padded one word in 64 against bank
//     conflicts), loaded with many 16-byte loads in flight and stored
//     coalesced. Where vmax and dmax are integers (dmax < kDirectMax), the
//     walk from an integer state is an integer walk: one lookup of the
//     clipped delta's code and dequantized value and an integer clamp-add
//     per step, the float32 walk's exact result (`IntWalk`); any other
//     state walks in float32 with the binary search.
//   * Decode: `xhat <- clip(xhat + dq, 0, vmax)` is a clamp-add map, and two
//     clamp-add maps compose into one, (D, lo, hi) with D clamped to
//     [-vmax, vmax] on the domain [0, vmax]. Under the integer rule (every
//     dequantized value an integer, vmax an integer in [1, 2^24]) each
//     float32 add of the walk is exact or lands beyond a bound it clips to,
//     so the int32 maps give the walk's states exactly. One CTA per block
//     row composes its row's maps (a block scan of one map per thread), the
//     last CTA of the lane to finish scans the rows' maps into each row's
//     start state, and a second launch scans each row again from its start
//     and writes the values. A carried state that is not an integer in
//     [0, vmax] (or is -0.0) is checked on the card and its lane walked
//     serially.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kTileThreads = 128;
constexpr int kLaneThreads = 32;
constexpr int kSmemMagBits = 13;
// speculative encode: tuples per segment (one thread), warm-up tuples of a
// segment's guess, threads per CTA, and the integer magnitudes of the
// direct code table
constexpr int kSeg = 64;
constexpr int kWarm = 32;
constexpr int kSpecThreads = 128;
constexpr int kSpecTile = kSpecThreads * kSeg;
constexpr int kDirectMax = 1024;  // the integer walk's table takes dmax < kDirectMax
// loads a thread keeps in flight when it fills a tile (each a global round
// trip; the kernels have 4 warps per SM to hide them)
constexpr int kLoadBatch = 16;
// padded shared-memory slots of a tile's inputs (with the warm-up) and codes
constexpr int kXSlots = kWarm + kSpecTile + (kWarm + kSpecTile) / 64 + 4;
constexpr int kCSlots = kSpecTile + kSpecTile / 64 + 4;
// scan decode: threads per CTA (one CTA per block row)
constexpr int kScanThreads = 128;

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

// ------------------------------------------------------------ codec form --

// Tuple t of a lane's walk sits at block t / b, position t % b.
__device__ __forceinline__ long long lane_slot(int t, int lanes, int b, int lane) {
  const int c = t / b;
  return (static_cast<long long>(c) * lanes + lane) * b + (t - c * b);
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// The codec's decode of one code against the reconstruction (also the
// encode's state update: the encode's dq is the decode of its code).
__device__ __forceinline__ float decode_step(const Quantizer& q, uint32_t code, float xhat,
                                             float vmax) {
  return clip(__fadd_rn(xhat, q.decode(code)), 0.0f, vmax);
}

// The serial walk of one lane's C*B tuples, encode; returns the final xhat.
__device__ float serial_encode_lane(const uint32_t* __restrict__ blocks, int chunks, int lanes,
                                    int b, int lane, float xhat, bool fresh, uint32_t vmax_u,
                                    float vmax, float dmax, const Quantizer& q, int width,
                                    uint32_t* __restrict__ codes, int* __restrict__ bitlen) {
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
  return xhat;
}

// The serial walk of one lane, decode; returns the final xhat.
__device__ float serial_decode_lane(const uint32_t* __restrict__ codes, int chunks, int lanes,
                                    int b, int lane, float xhat, bool fresh, uint32_t vmax_u,
                                    float vmax, const Quantizer& q, uint32_t* __restrict__ out) {
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
  return xhat;
}

__global__ void __launch_bounds__(kLaneThreads)
serial_encode_kernel(const uint32_t* __restrict__ blocks, int chunks, int lanes, int b,
                     float* __restrict__ xhat_io, uint8_t* __restrict__ init_io,
                     uint32_t vmax_u, float vmax, float dmax, const float* __restrict__ thr,
                     const float* __restrict__ dec, int qbits, int width,
                     uint32_t* __restrict__ codes, int* __restrict__ bitlen) {
  extern __shared__ float smem[];
  const Quantizer q = load_quantizer(thr, dec, qbits, smem);
  const int lane = blockIdx.x * kLaneThreads + threadIdx.x;
  if (lane >= lanes) return;
  xhat_io[lane] = serial_encode_lane(blocks, chunks, lanes, b, lane, xhat_io[lane],
                                     init_io[lane] == 0, vmax_u, vmax, dmax, q, width, codes,
                                     bitlen);
  init_io[lane] = 1;
}

__global__ void __launch_bounds__(kLaneThreads)
serial_decode_kernel(const uint32_t* __restrict__ codes, int chunks, int lanes, int b,
                     float* __restrict__ xhat_io, uint8_t* __restrict__ init_io,
                     uint32_t vmax_u, float vmax, const float* __restrict__ thr,
                     const float* __restrict__ dec, int qbits, uint32_t* __restrict__ out) {
  extern __shared__ float smem[];
  const Quantizer q = load_quantizer(thr, dec, qbits, smem);
  const int lane = blockIdx.x * kLaneThreads + threadIdx.x;
  if (lane >= lanes) return;
  xhat_io[lane] = serial_decode_lane(codes, chunks, lanes, b, lane, xhat_io[lane],
                                     init_io[lane] == 0, vmax_u, vmax, q, out);
  init_io[lane] = 1;
}

// -------------------------------------------------- speculative encode (B6) --

// One step of the float walk (any state): the serial kernel's step.
__device__ __forceinline__ float encode_step(const Quantizer& q, float xf, float xhat, float dmax,
                                             float vmax, uint32_t* code) {
  const float d = clip(__fsub_rn(xf, xhat), -dmax, dmax);
  float dq;
  *code = q.encode(d, &dq);
  return clip(__fadd_rn(xhat, dq), 0.0f, vmax);
}

// The integer walk. With vmax an integer V in [1, 2^24] (and the input
// clip equal to it), dmax an integer D < kDirectMax and the dequantized
// value of every integer delta in [-D, D] an integer, a walk from an
// integer state in [0, V] stays on integers: each float32 operation of
// `encode_step` is exact or clips, so the step is an integer clamp-add
// through one lookup of the delta's (signed code, dequantized value).
struct IntWalk {
  const int2* tab;  // tab[D + d] for d in [-D, D]
  int D, V;
  bool on;

  __device__ __forceinline__ int step(int xi, int x, uint32_t* code) const {
    const int2 e = tab[D + min(max(xi - x, -D), D)];
    *code = static_cast<uint32_t>(e.x);
    return min(max(x + e.y, 0), V);
  }

  // A float state the integer walk can start from: an integer in [0, V],
  // not -0.0.
  __device__ __forceinline__ bool holds(float x) const {
    return on && x >= 0.0f && x <= static_cast<float>(V) && x == truncf(x) &&
           __float_as_uint(x) != 0x80000000u;
  }
};

__device__ __forceinline__ int pad64(int i) { return i + (i >> 6); }

// One CTA's tile of a lane's walk in shared memory.
struct SpecTile {
  float* x;        // clipped inputs: x[pad64(kWarm + i)] is the tile's tuple i
  uint32_t* code;  // code[pad64(i)]
  float* start;    // per segment: the state its codes start from
  float* end;      // and the state they end in
};

// Walk `len` tuples from the state x, inputs from x[pad64(xi0 + k)], the
// codes stored at code[pad64(ci0 + k)] when `store`; returns the end state.
__device__ __forceinline__ float walk(const SpecTile& s, int xi0, int ci0, int len, bool store,
                                      float x, const Quantizer& q, const IntWalk& iw, float dmax,
                                      float vmax) {
  if (iw.holds(x)) {
    int xs = static_cast<int>(x);
    for (int k = 0; k < len; ++k) {
      uint32_t c;
      xs = iw.step(static_cast<int>(s.x[pad64(xi0 + k)]), xs, &c);
      if (store) s.code[pad64(ci0 + k)] = c;
    }
    return static_cast<float>(xs);
  }
  for (int k = 0; k < len; ++k) {
    uint32_t c;
    x = encode_step(q, s.x[pad64(xi0 + k)], x, dmax, vmax, &c);
    if (store) s.code[pad64(ci0 + k)] = c;
  }
  return x;
}

// Fill x[pad64(i)] for i in [lo, hi) with the clipped inputs of the lane's
// tuples t0 - kWarm + i, many loads in flight per thread: 16-byte loads of
// 4 tuples when b, lo and hi are multiples of 4 (t0 is), else 4-byte ones.
__device__ __forceinline__ void load_inputs(const SpecTile& s, const uint32_t* __restrict__ blocks,
                                            int lanes, int b, int lane, int t0, int lo, int hi,
                                            uint32_t vmax_u) {
  if (b % 4 == 0 && lo % 4 == 0 && hi % 4 == 0) {
    for (int i0 = lo; i0 < hi; i0 += 4 * kSpecThreads * kLoadBatch) {
      uint4 v[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + 4 * (u * kSpecThreads + threadIdx.x);
        v[u] = i < hi ? __ldg(reinterpret_cast<const uint4*>(blocks + lane_slot(t0 - kWarm + i, lanes, b, lane)))
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + 4 * (u * kSpecThreads + threadIdx.x);
        if (i < hi) {
          s.x[pad64(i)] = __uint2float_rn(min(v[u].x, vmax_u));
          s.x[pad64(i + 1)] = __uint2float_rn(min(v[u].y, vmax_u));
          s.x[pad64(i + 2)] = __uint2float_rn(min(v[u].z, vmax_u));
          s.x[pad64(i + 3)] = __uint2float_rn(min(v[u].w, vmax_u));
        }
      }
    }
    return;
  }
  for (int i0 = lo; i0 < hi; i0 += kSpecThreads * kLoadBatch) {
    uint32_t v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kSpecThreads + threadIdx.x;
      v[u] = i < hi ? __ldg(blocks + lane_slot(t0 - kWarm + i, lanes, b, lane)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kSpecThreads + threadIdx.x;
      if (i < hi) s.x[pad64(i)] = __uint2float_rn(min(v[u], vmax_u));
    }
  }
}

// Fill code[pad64(i)], i in [0, len), with word 0 of the lane's stored
// symbols t0 + i (written by other CTAs of this launch: read past L1).
__device__ __forceinline__ void load_codes(const SpecTile& s, const uint32_t* codes, int lanes,
                                           int b, int lane, int t0, int len) {
  for (int i0 = 0; i0 < len; i0 += kSpecThreads * kLoadBatch) {
    uint32_t v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kSpecThreads + threadIdx.x;
      v[u] = i < len ? __ldcg(codes + 2 * lane_slot(t0 + i, lanes, b, lane)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kSpecThreads + threadIdx.x;
      if (i < len) s.code[pad64(i)] = v[u];
    }
  }
}

// Rounds until every segment of the tile starts where its predecessor ends.
// Segment 0 starts from `head` when `use_head`, else stays where it is. A
// segment whose start bits differ from its predecessor's end re-walks from
// that end beside a replay of its stored trajectory (the decode of its
// codes), and stops where the two states' bits agree (its codes from there
// on stand, and so does its end). Every thread of the block calls it; it
// ends on a barrier.
__device__ void resolve(const SpecTile& s, int nseg, int len, bool use_head, float head,
                        const Quantizer& q, const IntWalk& iw, float dmax, float vmax) {
  const int j = threadIdx.x;
  const int s0 = j * kSeg;
  const int slen = j < nseg ? min(kSeg, len - s0) : 0;
  for (;;) {
    __syncthreads();
    float pred = 0.0f;
    if (j < nseg) pred = j == 0 ? (use_head ? head : s.start[0]) : s.end[j - 1];
    __syncthreads();
    bool changed = false;
    if (slen > 0 && !same_bits(pred, s.start[j])) {
      float end;
      if (iw.holds(pred) && iw.holds(s.start[j])) {  // integers: == is bit equality
        int now = static_cast<int>(pred), spec = static_cast<int>(s.start[j]);
        for (int k = 0; k < slen && now != spec; ++k) {
          const int ci = pad64(s0 + k);
          spec = min(max(spec + static_cast<int>(q.decode(s.code[ci])), 0), iw.V);
          uint32_t c;
          now = iw.step(static_cast<int>(s.x[pad64(kWarm + s0 + k)]), now, &c);
          s.code[ci] = c;
        }
        changed = now != spec;  // not converged within the segment: its end moves
        end = static_cast<float>(now);
      } else {
        float now = pred, spec = s.start[j];
        for (int k = 0; k < slen && !same_bits(now, spec); ++k) {
          const int ci = pad64(s0 + k);
          spec = decode_step(q, s.code[ci], spec, vmax);
          uint32_t c;
          now = encode_step(q, s.x[pad64(kWarm + s0 + k)], now, dmax, vmax, &c);
          s.code[ci] = c;
        }
        changed = !same_bits(now, spec);  // spec has come to the old end
        end = now;
      }
      s.start[j] = pred;
      if (changed) s.end[j] = end;
    }
    if (!__syncthreads_or(changed)) break;
  }
}

__global__ void __launch_bounds__(kSpecThreads)
spec_encode_kernel(const uint32_t* __restrict__ blocks, int chunks, int lanes, int b,
                   float* __restrict__ xhat_io, uint8_t* __restrict__ init_io, uint32_t vmax_u,
                   float vmax, float dmax, const float* __restrict__ thr,
                   const float* __restrict__ dec, int qbits, int width, int int_d,
                   uint32_t* __restrict__ codes, int* __restrict__ bitlen,
                   float2* __restrict__ segs, int* __restrict__ done) {
  extern __shared__ __align__(16) unsigned char spec_smem[];
  int2* tab = reinterpret_cast<int2*>(spec_smem);
  SpecTile s;
  s.x = reinterpret_cast<float*>(tab + 2 * max(int_d, 0) + 1);
  s.code = reinterpret_cast<uint32_t*>(s.x + kXSlots);
  s.start = reinterpret_cast<float*>(s.code + kCSlots);
  s.end = s.start + kSpecThreads;
  float* chain_start = s.end + kSpecThreads;  // tiles' first and last states, for the chain
  float* chain_end = chain_start + kSpecThreads;
  int* last = reinterpret_cast<int*>(chain_end + kSpecThreads);
  const int tile = blockIdx.x, tiles = gridDim.x, lane = blockIdx.y;
  const int n = chunks * b;  // tuples of the lane's walk
  const int t0 = tile * kSpecTile;
  const int len = min(kSpecTile, n - t0);
  const int nseg = (len + kSeg - 1) / kSeg;
  load_inputs(s, blocks, lanes, b, lane, t0, tile == 0 ? kWarm : 0, kWarm + len, vmax_u);
  const Quantizer q = load_quantizer(thr, dec, qbits, reinterpret_cast<float*>(last + 4));
  bool integral = true;
  for (int d = threadIdx.x; d <= int_d; d += kSpecThreads) {
    const uint32_t mag = count_le(q.thr, q.levels, static_cast<float>(d));
    const float m = q.dec[mag];
    integral &= m == truncf(m) && m <= 16777216.0f;
    tab[int_d + d] = make_int2(static_cast<int>(mag), static_cast<int>(m));
    if (d > 0) tab[int_d - d] = make_int2(static_cast<int>(mag | (1u << (qbits - 1))), -static_cast<int>(m));
  }
  const IntWalk iw{tab, int_d, int_d >= 0 ? static_cast<int>(vmax) : 0,
                   __syncthreads_and(integral) && int_d >= 0};
  const bool fresh = init_io[lane] == 0;

  // the speculative pass: each segment from its guess (the lane's first
  // from the true state)
  const int j = threadIdx.x, s0 = j * kSeg;
  if (j < nseg) {
    float x;
    if (tile == 0 && j == 0) {
      x = fresh ? s.x[pad64(kWarm)] : xhat_io[lane];
    } else {
      x = walk(s, s0, 0, kWarm, false, s.x[pad64(s0)], q, iw, dmax, vmax);
    }
    s.start[j] = x;
    s.end[j] = walk(s, kWarm + s0, s0, min(kSeg, len - s0), true, x, q, iw, dmax, vmax);
  }
  resolve(s, nseg, len, false, 0.0f, q, iw, dmax, vmax);

  if (b % 4 == 0) {  // 16-byte stores of 4 symbols' slots and bitlens
    for (int i = 4 * threadIdx.x; i < len; i += 4 * kSpecThreads) {
      const long long g = lane_slot(t0 + i, lanes, b, lane);
      uint32_t c0 = s.code[pad64(i)];
      int4 blen = make_int4(width, width, width, width);
      if (t0 + i == 0 && fresh) {  // the raw 32-bit reference symbol
        c0 = __ldg(blocks + g);
        blen.x = 32;
      }
      uint4* slot = reinterpret_cast<uint4*>(codes + 2 * g);
      slot[0] = make_uint4(c0, 0u, s.code[pad64(i + 1)], 0u);
      slot[1] = make_uint4(s.code[pad64(i + 2)], 0u, s.code[pad64(i + 3)], 0u);
      *reinterpret_cast<int4*>(bitlen + g) = blen;
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kSpecThreads) {
      const long long g = lane_slot(t0 + i, lanes, b, lane);
      uint32_t c = s.code[pad64(i)];
      int blen = width;
      if (t0 + i == 0 && fresh) {
        c = __ldg(blocks + g);
        blen = 32;
      }
      reinterpret_cast<uint2*>(codes)[g] = make_uint2(c, 0u);
      bitlen[g] = blen;
    }
  }
  float2* lane_segs = segs + static_cast<long long>(lane) * tiles * kSpecThreads;
  if (j < nseg) lane_segs[tile * kSpecThreads + j] = make_float2(s.start[j], s.end[j]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(done + lane, 1) == tiles - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();

  // the lane's last CTA to finish: the chain of tile boundaries, from the
  // true end of tile 0, each group of kSpecThreads tiles' first start and
  // last end fetched at once
  float x = __ldcg(lane_segs + (min(kSpecTile, n) + kSeg - 1) / kSeg - 1).y;
  for (int p = 1; p < tiles; ++p) {
    const int tp = p * kSpecTile;
    const int lenp = min(kSpecTile, n - tp);
    const int nsegp = (lenp + kSeg - 1) / kSeg;
    const float2* ps = lane_segs + p * kSpecThreads;
    if ((p - 1) % kSpecThreads == 0) {
      __syncthreads();
      const int r = p + threadIdx.x;
      if (r < tiles) {
        const float2* rs = lane_segs + r * kSpecThreads;
        chain_start[threadIdx.x] = __ldcg(rs).x;
        chain_end[threadIdx.x] = __ldcg(rs + (min(kSpecTile, n - r * kSpecTile) + kSeg - 1) / kSeg - 1).y;
      }
      __syncthreads();
    }
    if (same_bits(x, chain_start[(p - 1) % kSpecThreads])) {
      x = chain_end[(p - 1) % kSpecThreads];
      continue;
    }
    __syncthreads();  // the shared tile is free
    load_inputs(s, blocks, lanes, b, lane, tp, kWarm, kWarm + lenp, vmax_u);
    load_codes(s, codes, lanes, b, lane, tp, lenp);
    if (threadIdx.x < nsegp) {
      const float2 e = __ldcg(ps + threadIdx.x);
      s.start[threadIdx.x] = e.x;
      s.end[threadIdx.x] = e.y;
    }
    resolve(s, nsegp, lenp, true, x, q, iw, dmax, vmax);
    for (int i = threadIdx.x; i < lenp; i += kSpecThreads) {
      codes[2 * lane_slot(tp + i, lanes, b, lane)] = s.code[pad64(i)];
    }
    x = s.end[nsegp - 1];
  }
  if (threadIdx.x == 0) {
    xhat_io[lane] = x;
    init_io[lane] = 1;
  }
}

// ------------------------------------------------------ scan decode (B7) --

// The map x -> clamp(x + d, lo, hi) on [0, vmax], lo <= hi in [0, vmax].
struct ClampAdd {
  int d, lo, hi;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ ClampAdd identity_map(int v) { return ClampAdd{0, 0, v}; }

// a, then b
__device__ __forceinline__ ClampAdd then(const ClampAdd& a, const ClampAdd& b, int v) {
  return ClampAdd{clampi(a.d + b.d, -v, v), clampi(a.lo + b.d, b.lo, b.hi),
                  clampi(a.hi + b.d, b.lo, b.hi)};
}

__device__ __forceinline__ int apply(const ClampAdd& m, int x) {
  return clampi(x + m.d, m.lo, m.hi);
}

// The map of tuple k of a row: a fresh lane's first symbol restarts the
// reconstruction at its raw value; any other adds its integer dq.
__device__ __forceinline__ ClampAdd symbol_map(const Quantizer& q, uint32_t code, bool restart,
                                               uint32_t vmax_u, float vmax, int v) {
  if (restart) {
    const int r = static_cast<int>(min(code, vmax_u));
    return ClampAdd{0, r, r};
  }
  return ClampAdd{static_cast<int>(clip(q.decode(code), -vmax, vmax)), 0, v};
}

// Exclusive prefix (in thread order) of one map per thread over the block;
// `total` gets the whole block's composition. Every thread calls it.
__device__ ClampAdd block_scan_maps(ClampAdd m, int v, ClampAdd* warp_tot, ClampAdd* total) {
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  ClampAdd inc = m;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const ClampAdd o{__shfl_up_sync(0xFFFFFFFFu, inc.d, off),
                     __shfl_up_sync(0xFFFFFFFFu, inc.lo, off),
                     __shfl_up_sync(0xFFFFFFFFu, inc.hi, off)};
    if (l >= off) inc = then(o, inc, v);
  }
  ClampAdd ex{__shfl_up_sync(0xFFFFFFFFu, inc.d, 1), __shfl_up_sync(0xFFFFFFFFu, inc.lo, 1),
              __shfl_up_sync(0xFFFFFFFFu, inc.hi, 1)};
  if (l == 0) ex = identity_map(v);
  if (l == 31) warp_tot[w] = inc;
  __syncthreads();
  ClampAdd before = identity_map(v), all = identity_map(v);
#pragma unroll
  for (int i = 0; i < kScanThreads / 32; ++i) {
    if (i < w) before = then(before, warp_tot[i], v);
    all = then(all, warp_tot[i], v);
  }
  __syncthreads();
  *total = all;
  return then(before, ex, v);
}

constexpr int kShareBatch = 4;

// Word 0 of the symbols k..k + kShareBatch - 1 below k1 (all loads in flight).
__device__ __forceinline__ void load_share(const uint32_t* __restrict__ codes, long long base,
                                           int k, int k1, uint32_t* c) {
#pragma unroll
  for (int u = 0; u < kShareBatch; ++u) c[u] = k + u < k1 ? __ldg(codes + 2 * (base + k + u)) : 0u;
}

// The composed map of this thread's contiguous share [k0, k1) of a row.
__device__ ClampAdd share_map(const uint32_t* __restrict__ codes, long long base, int k0, int k1,
                              bool restart_head, const Quantizer& q, uint32_t vmax_u, float vmax,
                              int v) {
  ClampAdd m = identity_map(v);
  for (int k = k0; k < k1; k += kShareBatch) {
    uint32_t c[kShareBatch];
    load_share(codes, base, k, k1, c);
#pragma unroll
    for (int u = 0; u < kShareBatch; ++u) {
      if (k + u < k1) m = then(m, symbol_map(q, c[u], restart_head && k + u == 0, vmax_u, vmax, v), v);
    }
  }
  return m;
}

// Per lane: fresh, walked serially (the carried state outside the rule).
struct LaneRecord {
  int fresh, serial;
};

// Launch 1 of 2: one CTA per (block row c, lane) composes the row's map;
// the lane's last CTA to finish scans the rows' maps into each row's start
// state, or walks the lane serially when its carried state is outside the
// rule.
__global__ void __launch_bounds__(kScanThreads)
scan_decode_rows_kernel(const uint32_t* __restrict__ codes, int lanes, int b,
                        float* __restrict__ xhat_io, uint8_t* __restrict__ init_io,
                        uint32_t vmax_u, float vmax, const float* __restrict__ thr,
                        const float* __restrict__ dec, int qbits, uint32_t* __restrict__ out,
                        ClampAdd* __restrict__ rows, int* __restrict__ row_in,
                        LaneRecord* __restrict__ lane_rec, int* __restrict__ done) {
  extern __shared__ float scan_smem[];
  __shared__ ClampAdd warp_tot[kScanThreads / 32];
  __shared__ int last;
  const Quantizer q = load_quantizer(thr, dec, qbits, scan_smem);
  const int c = blockIdx.x, chunks = gridDim.x, lane = blockIdx.y;
  const int v = static_cast<int>(vmax);
  const bool fresh = init_io[lane] == 0;
  const int per = (b + kScanThreads - 1) / kScanThreads;
  const int k0 = min(b, threadIdx.x * per), k1 = min(b, k0 + per);
  const long long base = (static_cast<long long>(c) * lanes + lane) * b;
  ClampAdd row;
  block_scan_maps(share_map(codes, base, k0, k1, c == 0 && fresh, q, vmax_u, vmax, v), v,
                  warp_tot, &row);
  if (threadIdx.x == 0) rows[c * lanes + lane] = row;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + lane, 1) == chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  const float x0 = xhat_io[lane];
  const bool in_rule = x0 >= 0.0f && x0 <= vmax && x0 == rintf(x0) && __float_as_uint(x0) != 0x80000000u;
  const bool serial = !fresh && !in_rule;
  if (threadIdx.x == 0) lane_rec[lane] = LaneRecord{fresh, serial};
  if (serial) {
    if (threadIdx.x == 0) {
      xhat_io[lane] = serial_decode_lane(codes, chunks, lanes, b, lane, x0, false, vmax_u, vmax,
                                         q, out);
      init_io[lane] = 1;
    }
    return;
  }
  const int x = fresh ? 0 : static_cast<int>(x0);  // a fresh lane's row 0 restarts
  ClampAdd carry = identity_map(v);
  for (int r0 = 0; r0 < chunks; r0 += kScanThreads) {
    const int r = r0 + threadIdx.x;
    ClampAdd m = identity_map(v);
    if (r < chunks) {
      const int* p = reinterpret_cast<const int*>(rows + r * lanes + lane);
      m = ClampAdd{__ldcg(p), __ldcg(p + 1), __ldcg(p + 2)};
    }
    ClampAdd all;
    const ClampAdd ex = block_scan_maps(m, v, warp_tot, &all);
    if (r < chunks) row_in[r * lanes + lane] = apply(then(carry, ex, v), x);
    carry = then(carry, all, v);
  }
}

// Launch 2 of 2: one CTA per (block row, lane) scans its row from the row's
// start state and writes the values; the last row writes the lane's state.
__global__ void __launch_bounds__(kScanThreads)
scan_decode_apply_kernel(const uint32_t* __restrict__ codes, int lanes, int b,
                         float* __restrict__ xhat_io, uint8_t* __restrict__ init_io,
                         uint32_t vmax_u, float vmax, const float* __restrict__ thr,
                         const float* __restrict__ dec, int qbits, uint32_t* __restrict__ out,
                         const int* __restrict__ row_in, const LaneRecord* __restrict__ lane_rec) {
  extern __shared__ float scan_smem[];
  __shared__ ClampAdd warp_tot[kScanThreads / 32];
  const Quantizer q = load_quantizer(thr, dec, qbits, scan_smem);
  const int c = blockIdx.x, chunks = gridDim.x, lane = blockIdx.y;
  const LaneRecord rec = lane_rec[lane];
  if (rec.serial) return;  // walked by launch 1
  const int v = static_cast<int>(vmax);
  const int per = (b + kScanThreads - 1) / kScanThreads;
  const int k0 = min(b, threadIdx.x * per), k1 = min(b, k0 + per);
  const long long base = (static_cast<long long>(c) * lanes + lane) * b;
  const bool restart = c == 0 && rec.fresh;
  ClampAdd all;
  const ClampAdd ex = block_scan_maps(share_map(codes, base, k0, k1, restart, q, vmax_u, vmax, v),
                                      v, warp_tot, &all);
  int x = apply(ex, row_in[c * lanes + lane]);
  for (int k = k0; k < k1; k += kShareBatch) {
    uint32_t cs[kShareBatch];
    load_share(codes, base, k, k1, cs);
#pragma unroll
    for (int u = 0; u < kShareBatch; ++u) {
      if (k + u < k1) {
        x = apply(symbol_map(q, cs[u], restart && k + u == 0, vmax_u, vmax, v), x);
        out[base + k + u] = static_cast<uint32_t>(x);
      }
    }
  }
  if (c == chunks - 1 && k0 < k1 && k1 == b) {
    xhat_io[lane] = __int2float_rn(x);
    init_io[lane] = 1;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int qbits, size_t* smem) {
  *smem = smem_bytes(qbits);
  return repro::allow_smem(kernel, *smem);
}

int spec_tiles(int chunks, int b) {
  const long long n = static_cast<long long>(chunks) * b;
  return static_cast<int>((n + kSpecTile - 1) / kSpecTile);
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

// int32 words of scratch the speculative encode of (chunks, lanes, b)
// needs: each segment's start and end state, and one counter per lane
// (which must be zero on entry).
extern "C" long long repro_adpcm_lane_encode_scratch(int chunks, int lanes, int b) {
  return static_cast<long long>(lanes) * spec_tiles(chunks, b) * kSpecThreads * 2 + lanes;
}

// blocks uint32[chunks, lanes, b], xhat float32[lanes] and init uint8[lanes]
// (updated in place) -> codes uint32[chunks, lanes, b, 2], bitlen
// int32[chunks, lanes, b]: the speculative segmented encode. `scratch` holds
// repro_adpcm_lane_encode_scratch words, zero.
extern "C" int repro_adpcm_lane_encode(const void* blocks, int chunks, int lanes, int b,
                                       void* xhat, void* init, unsigned vmax_u, float vmax,
                                       float dmax, const void* thr, const void* dec, int qbits,
                                       int width, void* codes, void* bitlen, void* scratch,
                                       void* stream) {
  const long long n = static_cast<long long>(chunks) * b;
  if (lanes == 0 || n == 0) return 0;
  if (n > INT_MAX - kSpecTile || lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = spec_tiles(chunks, b);
  // the integer walk's table half-width, or -1 (no integer walk)
  const bool int_walk = vmax >= 1.0f && vmax <= 16777216.0f && vmax == rintf(vmax) &&
                        vmax_u == static_cast<unsigned>(vmax) && dmax >= 0.0f &&
                        dmax < static_cast<float>(kDirectMax) && dmax == rintf(dmax);
  const int int_d = int_walk ? static_cast<int>(dmax) : -1;
  const size_t smem = sizeof(int2) * (2 * max(int_d, 0) + 1) +
                      sizeof(float) * (kXSlots + kCSlots + 4 * kSpecThreads + 4) + smem_bytes(qbits);
  cudaError_t err = repro::allow_smem(spec_encode_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float2* segs = static_cast<float2*>(scratch);
  int* done = reinterpret_cast<int*>(segs + static_cast<long long>(lanes) * tiles * kSpecThreads);
  spec_encode_kernel<<<dim3(tiles, lanes), kSpecThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), chunks, lanes, b, static_cast<float*>(xhat),
      static_cast<uint8_t*>(init), vmax_u, vmax, dmax, static_cast<const float*>(thr),
      static_cast<const float*>(dec), qbits, width, int_d, static_cast<uint32_t*>(codes),
      static_cast<int*>(bitlen), segs, done);
  return static_cast<int>(cudaGetLastError());
}

// The same function by the serial walk, one thread per lane.
extern "C" int repro_adpcm_lane_encode_serial(const void* blocks, int chunks, int lanes, int b,
                                              void* xhat, void* init, unsigned vmax_u,
                                              float vmax, float dmax, const void* thr,
                                              const void* dec, int qbits, int width,
                                              void* codes, void* bitlen, void* stream) {
  if (lanes == 0) return 0;
  size_t smem;
  cudaError_t err = prepare(serial_encode_kernel, qbits, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((lanes + kLaneThreads - 1) / kLaneThreads);
  serial_encode_kernel<<<grid, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), chunks, lanes, b, static_cast<float*>(xhat),
      static_cast<uint8_t*>(init), vmax_u, vmax, dmax, static_cast<const float*>(thr),
      static_cast<const float*>(dec), qbits, width, static_cast<uint32_t*>(codes),
      static_cast<int*>(bitlen));
  return static_cast<int>(cudaGetLastError());
}

// int32 words of scratch the scan decode of (chunks, lanes) needs: each
// row's map and start state, each lane's record and counter (zero on
// entry).
extern "C" long long repro_adpcm_lane_decode_scratch(int chunks, int lanes) {
  return static_cast<long long>(chunks) * lanes * 4 + static_cast<long long>(lanes) * 3;
}

// codes uint32[chunks, lanes, b, 2] (word 0 read), xhat/init as above ->
// out uint32[chunks, lanes, b]: the clamp-add scan decode, for vmax an
// integer in [1, 2^24] and an integral dequantization table (the caller's
// rule). `scratch` holds repro_adpcm_lane_decode_scratch words, zero.
extern "C" int repro_adpcm_lane_decode(const void* codes, int chunks, int lanes, int b,
                                       void* xhat, void* init, unsigned vmax_u, float vmax,
                                       const void* thr, const void* dec, int qbits, void* out,
                                       void* scratch, void* stream) {
  if (lanes == 0 || chunks == 0 || b == 0) return 0;
  if (lanes > 65535 || !(vmax >= 1.0f && vmax <= 16777216.0f && vmax == rintf(vmax)))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem;
  cudaError_t err = prepare(scan_decode_rows_kernel, qbits, &smem);
  if (err == cudaSuccess) err = prepare(scan_decode_apply_kernel, qbits, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nrows = static_cast<long long>(chunks) * lanes;
  ClampAdd* rows = static_cast<ClampAdd*>(scratch);
  int* row_in = reinterpret_cast<int*>(rows + nrows);
  LaneRecord* rec = reinterpret_cast<LaneRecord*>(row_in + nrows);
  int* done = reinterpret_cast<int*>(rec + lanes);
  const dim3 grid(chunks, lanes);
  const auto s = static_cast<cudaStream_t>(stream);
  scan_decode_rows_kernel<<<grid, kScanThreads, smem, s>>>(
      static_cast<const uint32_t*>(codes), lanes, b, static_cast<float*>(xhat),
      static_cast<uint8_t*>(init), vmax_u, vmax, static_cast<const float*>(thr),
      static_cast<const float*>(dec), qbits, static_cast<uint32_t*>(out), rows, row_in, rec, done);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_decode_apply_kernel<<<grid, kScanThreads, smem, s>>>(
      static_cast<const uint32_t*>(codes), lanes, b, static_cast<float*>(xhat),
      static_cast<uint8_t*>(init), vmax_u, vmax, static_cast<const float*>(thr),
      static_cast<const float*>(dec), qbits, static_cast<uint32_t*>(out), row_in, rec);
  return static_cast<int>(cudaGetLastError());
}

// The same function by the serial walk, one thread per lane, for any
// parameters.
extern "C" int repro_adpcm_lane_decode_serial(const void* codes, int chunks, int lanes, int b,
                                              void* xhat, void* init, unsigned vmax_u,
                                              float vmax, const void* thr, const void* dec,
                                              int qbits, void* out, void* stream) {
  if (lanes == 0) return 0;
  size_t smem;
  cudaError_t err = prepare(serial_decode_kernel, qbits, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((lanes + kLaneThreads - 1) / kLaneThreads);
  serial_decode_kernel<<<grid, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes), chunks, lanes, b, static_cast<float*>(xhat),
      static_cast<uint8_t*>(init), vmax_u, vmax, static_cast<const float*>(thr),
      static_cast<const float*>(dec), qbits, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
