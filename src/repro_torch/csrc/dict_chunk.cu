// B5 in the Tdic32 codec's form: the frozen-mode, private-state walk of a
// whole chunk of blocks, encode and decode, for Hopper (sm_90a).
//
// Replaces, for a chunk of C blocks (C, L, B), C launches of the probe
// `src/repro/kernels/dict_hash.py: probe` (csrc/dict_probe.cu) each
// followed by the codec's last-writer-wins merge
// (`src/repro/core/algorithms/dictionary.py: _encode_frozen`,
// `_merge_updates`), and on decode C rounds of `_decode_frozen`. Oracles:
// `kernels/ref.py: dict_chunk_encode_ref` / `dict_chunk_decode_ref`, the
// same per-block walk in plain torch. Per block j, in order:
//   1. each tuple against the table as it stood after block j-1:
//      encode: h = (x * 2654435761) >> (32 - idx_bits) (uint32),
//              hit = valid[h] && table[h] == x, and B5's symbol
//              (hit: c0 = 1 | h << 1, c1 = 0, bitlen 1 + idx_bits;
//               miss: c0 = x << 1, c1 = x >> 31, bitlen 33);
//      decode: x = (c0 & 1) ? table[(c0 >> 1) & (2^idx_bits - 1)]
//                            : (c0 >> 1) | (c1 << 31);
//   2. the block's merge on h = hash(x): each slot that some tuple of the
//      block hashes to takes the block's last such tuple t: table = x,
//      valid = 1, ts = clock + j*B + t. At the end clock += C*B.
//
// Design. One CTA per lane walks the lane's C blocks in order, with the
// lane's table (uint32), write timestamps (int32) and valid mask (uint8),
// 13 bytes a slot (52 KiB at idx_bits 12), in shared memory from the first
// block to the last: loaded once, written back once. The winner of each
// slot is a shared int32[2^idx_bits] set to -1 once per chunk: block j's
// tuple t claims its slot with atomicMax(&winner[h], j*B + t), and after a
// barrier it owns the slot exactly when winner[h] == j*B + t. The key grows
// from block to block, so nothing is cleared between blocks, and the max
// does not depend on the order the threads run in. Two barriers a block:
// one after the probe (or the decode's gather) and the claims, which the
// claims share since they touch only `winner`; one after the owners'
// writes. Each thread handles the tuples t = tid, tid + T, ... of every
// block; its own tuples of the next kStages - 1 blocks are in flight by
// `cp.async` into its own slots of a shared ring, so no barrier guards the
// ring. Symbols (int2 per tuple) and values are stored straight to global
// memory, neighbouring threads on neighbouring words.
//
// What bounds it: neither bytes nor operations but the chain. At the main
// path's shape (4 lanes x 512 tuples, idx_bits 12, 128 blocks) the
// function moves ~4.5 MB (encode; ~3.4 MB decode), ~1.3 us at 3.35 TB/s,
// while the walk is 4 CTAs each running 128 blocks x 2 barriers one after
// the other, and each block costs the latency of its shared-memory
// round trips and barriers whatever else the CTA does: on the card, a
// deeper ring, slot ranges split over several CTAs per lane, no global
// stores at all, loads into registers instead of `cp.async`, and fewer
// threads each left the time per block as it was or made it longer (see
// PERF.md, PR 17). Shared memory bounds the table: the wrapper's rule
// (`kernels/dict_hash.py: chunk_kernel_for`) admits a table and ring that
// fit in 227 KB.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kStages = 4;  // blocks in flight in the ring, kernels/dict_hash.py CHUNK_STAGES
constexpr uint32_t kKnuth = 2654435761u;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kDecode = false: in = blocks uint32[C, L, B], out = codes uint32[C, L, B, 2]
// plus bitlen int32[C, L, B]. kDecode = true: in = codes uint32[C, L, B, 2],
// out = values uint32[C, L, B]. The state: table uint32, valid uint8, ts
// int32 [L, 2^idx_bits] and clock int32[L], read from *_in, written to *_out.
template <bool kDecode>
__global__ void __launch_bounds__(kMaxThreads)
dict_chunk_kernel(const uint32_t* __restrict__ in, const uint32_t* __restrict__ table_in,
                  const uint8_t* __restrict__ valid_in, const int* __restrict__ ts_in,
                  const int* __restrict__ clock_in, int chunks, int lanes, int b, int idx_bits,
                  uint32_t* __restrict__ out, int* __restrict__ bitlen,
                  uint32_t* __restrict__ table_out, uint8_t* __restrict__ valid_out,
                  int* __restrict__ ts_out, int* __restrict__ clock_out) {
  constexpr int kWords = kDecode ? 2 : 1;  // input words per tuple
  const int lane = blockIdx.x;
  const int slots = 1 << idx_bits;
  const int shift = 32 - idx_bits;
  const int words = b * kWords;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* table = smem;
  int* tstamp = reinterpret_cast<int*>(table + slots);
  int* winner = tstamp + slots;
  uint32_t* ring = reinterpret_cast<uint32_t*>(winner + slots);
  uint32_t* xs = ring + kStages * words;  // decode: the block's values
  uint8_t* valid = reinterpret_cast<uint8_t*>(xs + (kDecode ? b : 0));

  // this thread's tuples of block j into ring slot j % kStages (one group
  // per block, empty past the last block, so the wait count stays fixed)
  auto fetch = [&](int j) {
    if (j < chunks) {
      const uint32_t* src = in + (static_cast<long long>(j) * lanes + lane) * words;
      uint32_t* dst = ring + (j % kStages) * words;
      for (int t = threadIdx.x; t < b; t += blockDim.x) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) cp_async4(dst + kWords * t + w, src + kWords * t + w);
      }
    }
    cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) fetch(j);

  const long long base = static_cast<long long>(lane) << idx_bits;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    table[i] = table_in[base + i];
    tstamp[i] = ts_in[base + i];
    valid[i] = valid_in[base + i];
    winner[i] = -1;
  }
  const uint32_t clock = static_cast<uint32_t>(clock_in[lane]);
  __syncthreads();

  for (int j = 0; j < chunks; ++j) {
    fetch(j + kStages - 1);
    cp_async_wait<kStages - 1>();  // this thread's tuples of block j have landed
    uint32_t* st = ring + (j % kStages) * words;
    const long long row = (static_cast<long long>(j) * lanes + lane) * b;
    const int key0 = j * b;
    // 1. probe (decode: gather) against the table after block j-1; claim
    for (int t = threadIdx.x; t < b; t += blockDim.x) {
      uint32_t x;
      if constexpr (kDecode) {
        const uint32_t c0 = st[2 * t], c1 = st[2 * t + 1];
        x = (c0 & 1u) ? table[(c0 >> 1) & static_cast<uint32_t>(slots - 1)]
                      : ((c0 >> 1) | (c1 << 31));
        out[row + t] = x;
        xs[t] = x;  // phase 2 reads it back: the table may change under it
      } else {
        x = st[t];
        const uint32_t h = (x * kKnuth) >> shift;
        const bool hit = valid[h] != 0 && table[h] == x;
        reinterpret_cast<uint2*>(out)[row + t] =
            hit ? make_uint2(1u | (h << 1), 0u) : make_uint2(x << 1, x >> 31);
        bitlen[row + t] = hit ? 1 + idx_bits : 33;
      }
      atomicMax(&winner[(x * kKnuth) >> shift], key0 + t);
    }
    __syncthreads();
    // 2. each slot's last writer of the block writes it
    for (int t = threadIdx.x; t < b; t += blockDim.x) {
      const uint32_t x = kDecode ? xs[t] : st[t];
      const uint32_t h = (x * kKnuth) >> shift;
      if (winner[h] == key0 + t) {
        table[h] = x;
        valid[h] = 1;
        tstamp[h] = static_cast<int>(clock + static_cast<uint32_t>(key0 + t));
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    table_out[base + i] = table[i];
    ts_out[base + i] = tstamp[i];
    valid_out[base + i] = valid[i];
  }
  if (threadIdx.x == 0) {
    const uint32_t tuples = static_cast<uint32_t>(chunks) * static_cast<uint32_t>(b);
    clock_out[lane] = static_cast<int>(clock + tuples);
  }
}

size_t smem_bytes(int idx_bits, int b, bool decode) {
  const size_t slots = size_t{1} << idx_bits;
  return slots * 13 + static_cast<size_t>(b) * (decode ? kStages * 8 + 4 : kStages * 4);
}

template <bool kDecode>
int launch(const void* in, const void* table, const void* valid, const void* ts,
           const void* clock, int chunks, int lanes, int b, int idx_bits, void* out,
           void* bitlen, void* table_out, void* valid_out, void* ts_out, void* clock_out,
           void* stream) {
  if (lanes == 0) return 0;
  if (idx_bits < 1 || idx_bits > 20 || chunks < 0 || b < 0 ||
      static_cast<long long>(chunks) * b > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(idx_bits, b, kDecode);
  cudaError_t err = repro::allow_smem(dict_chunk_kernel<kDecode>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = b >= kMaxThreads ? kMaxThreads : max(32, (b + 31) / 32 * 32);
  dict_chunk_kernel<kDecode><<<lanes, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<const uint32_t*>(table),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(ts),
      static_cast<const int*>(clock), chunks, lanes, b, idx_bits, static_cast<uint32_t*>(out),
      static_cast<int*>(bitlen), static_cast<uint32_t*>(table_out),
      static_cast<uint8_t*>(valid_out), static_cast<int*>(ts_out), static_cast<int*>(clock_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks uint32[chunks, lanes, b], state table uint32 / valid uint8 / ts
// int32 [lanes, 2^idx_bits], clock int32[lanes] -> codes uint32[chunks,
// lanes, b, 2], bitlen int32[chunks, lanes, b] and the state after the
// chunk in the *_out tensors (none aliasing an input).
extern "C" int repro_dict_chunk_encode(const void* blocks, const void* table, const void* valid,
                                       const void* ts, const void* clock, int chunks, int lanes,
                                       int b, int idx_bits, void* codes, void* bitlen,
                                       void* table_out, void* valid_out, void* ts_out,
                                       void* clock_out, void* stream) {
  return launch<false>(blocks, table, valid, ts, clock, chunks, lanes, b, idx_bits, codes,
                       bitlen, table_out, valid_out, ts_out, clock_out, stream);
}

// codes uint32[chunks, lanes, b, 2] and the state -> values uint32[chunks,
// lanes, b] and the state after the chunk.
extern "C" int repro_dict_chunk_decode(const void* codes, const void* table, const void* valid,
                                       const void* ts, const void* clock, int chunks, int lanes,
                                       int b, int idx_bits, void* values, void* table_out,
                                       void* valid_out, void* ts_out, void* clock_out,
                                       void* stream) {
  return launch<true>(codes, table, valid, ts, clock, chunks, lanes, b, idx_bits, values,
                      nullptr, table_out, valid_out, ts_out, clock_out, stream);
}
