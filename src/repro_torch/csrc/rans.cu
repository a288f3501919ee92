// B8 and B9: the interleaved rANS entropy stage, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of `src/repro/kernels/rans.py`:
//   * B8 `encode_rows` (`_enc_kernel`), plain version `kernels/ref.py:
//     rans_encode_ref`: 8-lane interleaved rANS encode of a 4 KiB chunk's
//     (T=512, 8) byte grid, rows walked in reverse, 12-bit probabilities,
//     16-bit renormalisation. Outputs the lane states (8,) and, at the
//     ORIGINAL row, each step's emission flag and u16 value (T, 8).
//   * B9 `decode_rows` (`_dec_kernel`), plain version `kernels/ref.py:
//     rans_decode_ref`: the forward decode, each lane starting from its
//     own absolute offset into the shared u16 stream.
// Both take all C chunks of a section in one launch, as the reference
// batches its scan with vmap: (C, T, 8) grids, (C, 8) states.
//
// What bounds them: the stage needs about 1 byte in and, per emission, a
// u16 out per input byte (plus a state and a count per lane stream), and
// 6-7 integer operations per byte; at this card's rates the bytes are the
// larger bound (`chip_smoke.py` computes both). This first design does
// not come near it. It moves ~13 bytes per input byte (int32 symbols, a
// mask byte, and for encode an int32 flag and value per step, the Pallas
// contract's grids), and each thread runs a serial chain of T steps with
// a 32-bit division (encode) or a multiply and a table lookup (decode) per
// step, with too few threads per SM to hide that chain's latency. Narrow
// grids and compacted emissions are later work. The TPU kernel walks the
// rows as its sequential grid, carrying the 8 lane states in an output
// block and looking tables up by one-hot folds. Here one thread owns one
// (chunk, lane) stream and walks its rows in a register loop; the chunks
// give the parallelism (a 35 MB section is ~8,400 chunks, ~68,000
// threads). The frequency and cumulative tables (and, for decode, the
// 4096-entry slot table) are read into shared memory once per CTA, so
// every lookup is a shared-memory load.
// Division is the hardware's unsigned 32-bit division, and the renorm test
// keeps the reference's overflow-safe spelling `(x >> 20) >= f`. Decode
// reads are clipped to [0, cap-1] of a stream that is zero past its
// stored `stream_len` entries, exactly as the reference's padded stream.
// Byte values outside [0, 255] are clamped before a table lookup, so a bad
// input cannot read outside the tables.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;
constexpr int kProbBits = 12;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 16;

__device__ __forceinline__ int clamp_byte(int s) { return s < 0 ? 0 : (s > 255 ? 255 : s); }

__global__ void __launch_bounds__(kThreads)
rans_encode_kernel(const int* __restrict__ syms, const uint8_t* __restrict__ mask,
                   const uint32_t* __restrict__ freqs, const uint32_t* __restrict__ cums,
                   long long n_streams, int t_rows, uint32_t* __restrict__ states,
                   int* __restrict__ flags, uint32_t* __restrict__ vals) {
  __shared__ uint32_t fr[256];
  __shared__ uint32_t cu[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    fr[i] = freqs[i];
    cu[i] = cums[i];
  }
  __syncthreads();
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n_streams) return;
  const long long base = (g / kLanes) * t_rows * kLanes + (g % kLanes);
  uint32_t x = kRansL;
  for (int t = t_rows - 1; t >= 0; --t) {  // reverse, so decode runs forward
    const long long k = base + static_cast<long long>(t) * kLanes;
    int flag = 0;
    uint32_t val = 0u;
    if (mask[k]) {
      const int s = clamp_byte(syms[k]);
      const uint32_t f = fr[s] > 0u ? fr[s] : 1u;
      if ((x >> 20) >= f) {  // x >= f * 2^20, without overflow
        flag = 1;
        val = x & 0xFFFFu;
        x >>= 16;
      }
      x = ((x / f) << kProbBits) + (x % f) + cu[s];
    }
    flags[k] = flag;
    vals[k] = val;
  }
  states[g] = x;
}

__global__ void __launch_bounds__(kThreads)
rans_decode_kernel(const uint32_t* __restrict__ stream, long long stream_len, long long cap,
                   const uint32_t* __restrict__ freqs, const uint32_t* __restrict__ cums,
                   const int* __restrict__ lut, const uint32_t* __restrict__ states,
                   const int* __restrict__ offsets, const uint8_t* __restrict__ mask,
                   long long n_streams, int t_rows, int* __restrict__ syms) {
  __shared__ uint32_t fr[256];
  __shared__ uint32_t cu[256];
  __shared__ uint8_t lu[kProbScale];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    fr[i] = freqs[i];
    cu[i] = cums[i];
  }
  for (int i = threadIdx.x; i < static_cast<int>(kProbScale); i += kThreads) {
    lu[i] = static_cast<uint8_t>(clamp_byte(lut[i]));
  }
  __syncthreads();
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n_streams) return;
  const long long base = (g / kLanes) * t_rows * kLanes + (g % kLanes);
  uint32_t x = states[g];
  long long p = offsets[g];
  for (int t = 0; t < t_rows; ++t) {
    const long long k = base + static_cast<long long>(t) * kLanes;
    int out = 0;
    if (mask[k]) {
      const uint32_t slot = x & (kProbScale - 1u);
      const int s = lu[slot];
      uint32_t x2 = fr[s] * (x >> kProbBits) + slot - cu[s];
      if (x2 < kRansL) {
        const long long q = p < 0 ? 0 : (p > cap - 1 ? cap - 1 : p);
        const uint32_t w = q < stream_len ? stream[q] : 0u;
        x2 = (x2 << 16) | w;
        ++p;
      }
      x = x2;
      out = s;
    }
    syms[k] = out;
  }
}

}  // namespace

// syms int32[chunks, t_rows, 8], mask uint8[chunks, t_rows, 8], freqs and
// cums uint32[256] -> states uint32[chunks, 8], flags int32 and vals uint32
// [chunks, t_rows, 8].
extern "C" int repro_rans_encode(const void* syms, const void* mask, const void* freqs,
                                 const void* cums, int chunks, int t_rows, void* states,
                                 void* flags, void* vals, void* stream) {
  const long long n_streams = static_cast<long long>(chunks) * kLanes;
  if (n_streams == 0) return 0;
  const unsigned grid = static_cast<unsigned>((n_streams + kThreads - 1) / kThreads);
  rans_encode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(syms), static_cast<const uint8_t*>(mask),
      static_cast<const uint32_t*>(freqs), static_cast<const uint32_t*>(cums), n_streams,
      t_rows, static_cast<uint32_t*>(states), static_cast<int*>(flags),
      static_cast<uint32_t*>(vals));
  return static_cast<int>(cudaGetLastError());
}

// stream uint32[stream_len] (u16 values, zero past stream_len up to cap),
// freqs and cums uint32[256], lut int32[4096], states uint32[chunks, 8],
// offsets int32[chunks, 8], mask uint8[chunks, t_rows, 8] -> syms int32
// [chunks, t_rows, 8].
extern "C" int repro_rans_decode(const void* stream_words, long long stream_len, long long cap,
                                 const void* freqs, const void* cums, const void* lut,
                                 const void* states, const void* offsets, const void* mask,
                                 int chunks, int t_rows, void* syms, void* stream) {
  const long long n_streams = static_cast<long long>(chunks) * kLanes;
  if (n_streams == 0) return 0;
  const unsigned grid = static_cast<unsigned>((n_streams + kThreads - 1) / kThreads);
  rans_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(stream_words), stream_len, cap,
      static_cast<const uint32_t*>(freqs), static_cast<const uint32_t*>(cums),
      static_cast<const int*>(lut), static_cast<const uint32_t*>(states),
      static_cast<const int*>(offsets), static_cast<const uint8_t*>(mask), n_streams, t_rows,
      static_cast<int*>(syms));
  return static_cast<int>(cudaGetLastError());
}
