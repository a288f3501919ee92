// B8 in its section form: a frame section's bytes in, the rANS stage's lane
// states, lane counts and packed u16 stream out, for Hopper (sm_90a).
//
// Replaces, on the entropy stage's path, the Pallas kernel of
// `src/repro/kernels/rans.py` (`encode_rows`, `_enc_kernel`) together with
// its caller's stream assembly (`src/repro/core/entropy.py: _encode_device`).
// The plain version is `kernels/ref.py: rans_section_encode_ref`
// (`rans_encode_ref` on the section's chunk grid, then `assemble_stream`).
// The contract kernel `csrc/rans.cu: rans_encode` stays, for the Pallas
// contract's (C, T, 8) int32 grids.
//
// The coder: a section of n bytes is C = ceil(n / 4096) chunks; lane j of
// chunk c owns bytes c*4096 + 8t + j (t < 512) and walks them from its last
// real row down to row 0 (a ragged last chunk's missing rows are identity
// steps), 12-bit probabilities, 16-bit renormalisation. Its u16 emissions,
// read in row order, are its stream; the streams follow one another in
// (chunk, lane) order.
//
// What bounds it: bytes (n in, 2 per emitted u16 out, a state and a count per
// lane), and the chain: 512 dependent steps per lane. Two launches:
//   * `rans_section_walk_kernel`, one thread per (chunk, lane), 32 chunks per
//     CTA. The table is built per CTA in shared memory: frequency (0 read as
//     1), exclusive cumulative frequency by a block scan, and an exact
//     division by the frequency as a multiply-high (Granlund-Montgomery's
//     round-up form for 32-bit numerators, q = (t + ((x - t) >> 1)) >> (l -
//     1) with t = mulhi(x, m) and l = ceil(log2 f), taken here as the 33-bit
//     sum (t + x) >> l, which is the same number and also exact for f = 1,
//     where l = 0 and m = 1), one 16-byte entry per symbol (m, f, cum, l;
//     an 8-byte entry packing f, cum and l, which needs a quantized table,
//     was no faster).
//     The new state is x + q*(4096 - f) + cum, which equals (q << 12) + x % f
//     + cum modulo 2^32. The CTA stages its chunks' bytes in shared memory a
//     quarter chunk (128 rows) at a time, double-buffered: the next
//     quarter's 16-byte asynchronous copies (`cp.async`) run under this
//     quarter's walk, so no global load is on a step's chain; the byte and
//     its table entry depend only on the row and are fetched ahead by the
//     unrolled loop. The i-th emission of the walk goes to slot 511 - i of
//     the lane's 512-slot u16 area, collected eight at a time in a register
//     quad; a whole quad goes to the lane's ring of 8 quads in shared
//     memory, and every 64 rows the warp flushes its lanes' new quads to
//     global memory together, 8 threads per lane, so each lane's quads leave
//     as one contiguous run of up to 128 bytes (a quad stored by its own
//     thread as soon as it is whole, one scattered 16-byte store per quad,
//     cost ~10 us more on the heavy section, scripts/bitpack_ab.py against a
//     tree with that change). The lane's stream is then slots
//     [512 - count, 512) in order. The lane writes its last, partial quad,
//     its state and its count last.
//   * `rans_section_copy_kernel`, one warp per lane: the lane's run to its
//     offset (the exclusive scan of the counts, taken by the wrapper with
//     `torch.cumsum` in int64, as the reference's caller takes it) in the
//     packed stream, which is a little-endian u16 array: two u16 to a word,
//     low half first. Lane i of the warp writes the i-th aligned 8-slot
//     (16-byte) group of the run's destination, from the two aligned
//     source groups it straddles, shifted by the run's relative offset
//     mod 8 slots (the same for the whole warp); the two end groups, shared
//     with the neighbouring runs, take u16 stores of this run's slots. The
//     last lane zeroes the odd pad half.
// The renorm test keeps the reference's overflow-safe spelling
// `(x >> 20) >= f`.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;
constexpr int kRows = 512;
constexpr int kChunkBytes = kRows * kLanes;
constexpr int kChunksPerCta = kThreads / kLanes;  // 32
constexpr int kParts = 4;  // a chunk is staged a quarter (128 rows) at a time
constexpr int kPartRows = kRows / kParts;
constexpr int kPartBytes = kPartRows * kLanes;  // 1,024
// a chunk's stride in a stage buffer: 16 bytes of pad put the four chunks a
// warp reads at each row in different banks
constexpr int kStride = kPartBytes + 16;
constexpr int kBufBytes = kChunksPerCta * kStride;
constexpr int kStageBytes = 2 * kBufBytes;  // double-buffered
constexpr int kRingQuads = 8;  // a lane's completed quads between two warp flushes
constexpr int kSmemBytes = kStageBytes + kThreads * kRingQuads * 16;
constexpr int kFlushRows = 64;  // rows walked between two flushes: at most 8 quads
constexpr uint32_t kProbScale = 1u << 12;
constexpr uint32_t kRansL = 1u << 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One symbol's coding constants: the frequency (0 read as 1), the
// cumulative frequency, the multiply-high magic and the shift l.
struct Sym {
  uint32_t magic, f, cum, l;
};

__device__ __forceinline__ Sym sym_at(const uint4* __restrict__ tab, int s) {
  const uint4 e = tab[s];
  return {e.x, e.y, e.z, e.w};
}

// One encode step of state x on symbol constants e; an emission is shifted
// into the quad `acc` (newest in the low half of acc.x), stored every eighth.
__device__ __forceinline__ void step(uint32_t& x, int& cnt, uint4& acc, const Sym& e,
                                     uint4* __restrict__ ring, int& fresh) {
  if ((x >> 20) >= e.f) {  // x >= f * 2^20, without overflow
    acc.w = __funnelshift_l(acc.z, acc.w, 16);
    acc.z = __funnelshift_l(acc.y, acc.z, 16);
    acc.y = __funnelshift_l(acc.x, acc.y, 16);
    acc.x = (acc.x << 16) | (x & 0xFFFFu);
    if ((++cnt & 7) == 0) {
      ring[((kRows - cnt) >> 3) & (kRingQuads - 1)] = acc;
      ++fresh;
    }
    x >>= 16;
  }
  // q = floor((mulhi(x, magic) + x) / 2^l), the sum taken in 33 bits
  const uint32_t t = __umulhi(x, e.magic);
  const uint32_t q = static_cast<uint32_t>((static_cast<uint64_t>(t) + x) >> e.l);
  x += q * (kProbScale - e.f) + e.cum;
}

// Walk rows [lo, hi] of the lane's staged part, last row first.
__device__ __forceinline__ void walk(const uint8_t* __restrict__ col, int lo, int hi,
                                     const uint4* __restrict__ tab, uint32_t& x, int& cnt,
                                     uint4& acc, uint4* __restrict__ ring, int& fresh) {
  int t = hi;
  for (; ((t - lo + 1) & 7) != 0; --t) {
    step(x, cnt, acc, sym_at(tab, col[t * kLanes]), ring, fresh);
  }
  for (; t >= lo; t -= 8) {
    Sym e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = sym_at(tab, col[(t - k) * kLanes]);
#pragma unroll
    for (int k = 0; k < 8; ++k) step(x, cnt, acc, e[k], ring, fresh);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 16 : 0));
}

// Issue the copy of part `part` (rows [128*part, 128*part + 128)) of the
// CTA's chunks into `buf`: 16-byte asynchronous copies (zeros past byte n)
// when the data is 16-byte aligned, else byte loads; one commit group.
__device__ __forceinline__ void stage_part(uint8_t* buf, const uint8_t* __restrict__ data,
                                           long long n, long long chunk0, int part, bool vec) {
  for (int v = threadIdx.x; v < kChunksPerCta * kPartBytes / 16; v += kThreads) {
    const int c = v / (kPartBytes / 16), o = (v % (kPartBytes / 16)) * 16;
    const long long src = (chunk0 + c) * kChunkBytes + part * kPartBytes + o;
    uint8_t* dst = buf + c * kStride + o;
    if (vec) {
      cp_async16(dst, data + (src < n ? src : 0), src < n);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b) dst[b] = src + b < n ? data[src + b] : 0;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The warp's lanes' fresh quads (the `fresh` newest, quads [64 - cnt/8,
// 64 - cnt/8 + fresh) of each lane's area) from their rings to global
// memory: 8 threads per lane, 4 lanes per store instruction, each lane's
// quads one contiguous run of up to 128 bytes.
__device__ __forceinline__ void flush_warp(const uint4* __restrict__ rings,
                                           uint4* __restrict__ areas, int cnt, int& fresh) {
  const int lane = threadIdx.x & 31, s = lane & 7;
  const int first = kRows / 8 - (cnt >> 3);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int src = 4 * m + (lane >> 3);
    const int q = __shfl_sync(kFull, first, src) + s;
    if (s < __shfl_sync(kFull, fresh, src)) {
      areas[src * (kRows / 8) + q] = rings[src * kRingQuads + (q & (kRingQuads - 1))];
    }
  }
  fresh = 0;
  __syncwarp();  // every ring slot read before its owner writes it again
}

__global__ void __launch_bounds__(kThreads)
rans_section_walk_kernel(const uint8_t* __restrict__ data, long long n,
                         const uint32_t* __restrict__ freqs, long long n_streams,
                         uint32_t* __restrict__ states, int* __restrict__ counts,
                         long long* __restrict__ counts64, uint4* __restrict__ scratch) {
  extern __shared__ __align__(16) uint8_t stage[];
  __shared__ uint4 tab[256];
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long chunk0 = static_cast<long long>(blockIdx.x) * kChunksPerCta;
  const bool vec = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  stage_part(stage + ((kParts - 1) & 1) * kBufBytes, data, n, chunk0, kParts - 1, vec);

  // the table: cumulative frequencies by a block scan (mod 2^32), then each
  // symbol's divisor constants
  const uint32_t f = freqs[tid];
  uint32_t inc = f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  uint32_t cum = inc - f;
  for (int w = 0; w < warp; ++w) cum += warp_sums[w];
  const uint32_t fs = f ? f : 1u;
  const uint32_t l = 32u - static_cast<uint32_t>(__clz(fs - 1u));  // ceil(log2 fs)
  const uint32_t magic = static_cast<uint32_t>(((((1ull << l) - fs) << 32) / fs) + 1ull);
  tab[tid] = make_uint4(magic, fs, cum, l);

  const long long g = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const int c_local = tid / kLanes, j = tid % kLanes;
  // the lane's real rows: byte c*4096 + 8t + j < n
  const long long left = n - (chunk0 + c_local) * kChunkBytes - j;
  const int rows = left <= 0 ? 0 : static_cast<int>(min(static_cast<long long>(kRows), (left + 7) / 8));
  uint32_t x = kRansL;
  int cnt = 0;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  uint4* __restrict__ area = scratch + g * (kRows / 8);
  // the warp's rings and areas (lane 0's), and this lane's ring
  uint4* rings = reinterpret_cast<uint4*>(stage + kStageBytes) + (tid & ~31) * kRingQuads;
  uint4* __restrict__ areas = scratch + (g - lane) * (kRows / 8);
  uint4* ring = rings + lane * kRingQuads;
  int fresh = 0;

  for (int part = kParts - 1; part >= 0; --part) {
    if (part > 0) {  // the next part's copy runs under this part's walk
      stage_part(stage + ((part - 1) & 1) * kBufBytes, data, n, chunk0, part - 1, vec);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int hi = min(rows, (part + 1) * kPartRows) - 1 - part * kPartRows;
    const uint8_t* col = stage + (part & 1) * kBufBytes + c_local * kStride + j;
    for (int lo = kPartRows - kFlushRows; lo >= 0; lo -= kFlushRows) {
      const int top = min(hi, lo + kFlushRows - 1);
      if (g < n_streams && top >= lo) {
        walk(col, lo, top, tab, x, cnt, acc, ring, fresh);
      }
      __syncwarp();
      flush_warp(rings, areas, cnt, fresh);
    }
    __syncthreads();  // every walk is done with the buffer before it is refilled
  }
  if (g >= n_streams) return;
  if (cnt & 7) {  // the last, partial quad: its emissions in the quad's top slots
    for (int k = cnt & 7; k < 8; ++k) {
      acc.w = __funnelshift_l(acc.z, acc.w, 16);
      acc.z = __funnelshift_l(acc.y, acc.z, 16);
      acc.y = __funnelshift_l(acc.x, acc.y, 16);
      acc.x <<= 16;
    }
    area[(kRows - cnt) >> 3] = acc;
  }
  states[g] = x;
  counts[g] = cnt;
  counts64[g] = cnt;
}

// Destination u32 i (of 4) of an 8-slot group whose source slots start `r`
// slots into the 16-slot window w[0..7] (two aligned source quads).
__device__ __forceinline__ uint32_t window_word(const uint32_t (&w)[8], int i, int r) {
  const int m = r >> 1;
  return (r & 1) ? __funnelshift_r(w[i + m], w[i + m + 1], 16) : w[i + m];
}

template <int R>
__device__ __forceinline__ uint4 window(const uint4& a, const uint4& b) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return make_uint4(window_word(w, 0, R), window_word(w, 1, R), window_word(w, 2, R),
                    window_word(w, 3, R));
}

// Aligned 8-slot source group `q`, or zeros when it holds no slot of [lo, hi).
__device__ __forceinline__ uint4 group_in(const uint4* __restrict__ base, long long q,
                                          long long lo, long long hi) {
  return (8 * q + 7 >= lo && 8 * q < hi) ? base[q] : make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(kThreads)
rans_section_copy_kernel(const uint4* __restrict__ scratch, const int* __restrict__ counts,
                         const long long* __restrict__ ends, long long n_streams,
                         uint16_t* __restrict__ out) {
  const long long w = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n_streams) return;
  const int cnt = counts[w];
  const long long end = ends[w];
  if (w == n_streams - 1 && lane == 0 && (end & 1)) out[end] = 0;  // the odd pad half
  if (cnt == 0) return;
  // slots from each array's 16-byte-aligned base: the lane's run [s0, s0 + cnt)
  // goes to [d0, d1)
  const int om = static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 1) & 7);
  uint16_t* o16 = out - om;
  uint4* o128 = reinterpret_cast<uint4*>(o16);
  const long long s0 = w * kRows + (kRows - cnt), s1 = s0 + cnt;
  const long long d0 = om + end - cnt, d1 = d0 + cnt;
  const long long delta = s0 - d0;
  const long long dq = delta >> 3;  // floor
  const int r = static_cast<int>(delta & 7);
  for (long long g = (d0 >> 3) + lane; g <= (d1 - 1) >> 3; g += 32) {
    const uint4 a = group_in(scratch, g + dq, s0, s1);
    const uint4 b = r ? group_in(scratch, g + dq + 1, s0, s1) : make_uint4(0u, 0u, 0u, 0u);
    uint4 v;
    switch (r) {  // the same for the whole warp: one lane stream
      case 0: v = a; break;
      case 1: v = window<1>(a, b); break;
      case 2: v = window<2>(a, b); break;
      case 3: v = window<3>(a, b); break;
      case 4: v = window<4>(a, b); break;
      case 5: v = window<5>(a, b); break;
      case 6: v = window<6>(a, b); break;
      default: v = window<7>(a, b); break;
    }
    if (8 * g >= d0 && 8 * g + 8 <= d1) {
      o128[g] = v;
    } else {  // a group shared with a neighbouring run: only this run's slots
      const uint32_t vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long s = 8 * g + k;
        if (s >= d0 && s < d1) o16[s] = static_cast<uint16_t>(vs[k >> 1] >> (16 * (k & 1)));
      }
    }
  }
}

}  // namespace

// data uint8[n], freqs uint32[256] -> states uint32[C, 8], counts int32[C, 8]
// (and int64 in counts64, for the scan), and each lane's emissions in
// scratch u16[C*8, 512] slots [512 - count, 512); C = ceil(n / 4096).
extern "C" int repro_rans_section_walk(const void* data, long long n, const void* freqs,
                                       void* states, void* counts, void* counts64, void* scratch,
                                       void* stream) {
  const long long chunks = (n + kChunkBytes - 1) / kChunkBytes;
  if (chunks == 0) return 0;
  cudaError_t err = repro::allow_smem(rans_section_walk_kernel, kSmemBytes);
  // without it the shared-memory carveout may fit only one CTA per SM
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(rans_section_walk_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((chunks + kChunksPerCta - 1) / kChunksPerCta);
  rans_section_walk_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, static_cast<const uint32_t*>(freqs), chunks * kLanes,
      static_cast<uint32_t*>(states), static_cast<int*>(counts), static_cast<long long*>(counts64),
      static_cast<uint4*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// scratch and counts from the walk, ends int64[C*8] (inclusive sums of the
// counts) -> out u16[>= ends[-1] + 1], the packed stream with the odd pad
// half zero.
extern "C" int repro_rans_section_copy(const void* scratch, const void* counts, const void* ends,
                                       long long n_streams, void* out, void* stream) {
  if (n_streams == 0) return 0;
  const unsigned grid = static_cast<unsigned>((n_streams + kThreads / 32 - 1) / (kThreads / 32));
  rans_section_copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(scratch), static_cast<const int*>(counts),
      static_cast<const long long*>(ends), n_streams, static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
