// Kernel B5: narrow windows out of a table of 32-bit words.
//
// Replaces urmap_tpu/kernels/lane_rotate.py:rotate_narrow_pallas (body
// _kernel) together with the row gathers in front of it
// (urmap_tpu/map/seed.py:_row128_fetch,
// urmap_tpu/genome_pack.py:row128_window_fetch). The row128 layouts keep
// the CSR positions and the interleaved genome planes as 128-word rows; a
// fetch wants `width` consecutive words beginning at an arbitrary word
// `start`. The TPU version gathers one to three whole rows per start into a
// [N, W] buffer (W = 128, 256 or 384) and then rotates every row left by
// start mod 128, because a gather there moves whole lane tiles and the
// rotate written as array ops costs many times the gather. Two of its
// devices answer limits of that machine and have no counterpart here: the
// rotated rows are written over the gathered buffer (input_output_aliases)
// because a narrow [N, width] output would be padded back to full lane
// tiles, and the offsets travel as int8 because an [N, 1] int32 operand is
// padded 128-fold.
//
// On this card a thread addresses single words, so the gathered buffer is
// never built: one pass reads each window straight from the table and
// writes `width` words per output row. What bounds it is bytes: a warp's
// load of a 16-word window touches one or two 32-byte sectors more than
// the words it keeps, and nothing is computed. Design: one thread per
// output word, output words numbered row-major, so the threads of a warp
// cover 32/width neighbouring windows and both the loads inside a window
// and the stores are contiguous; the start of a row is read once per
// thread and served from L1. Row and word indexes are 64-bit: a table of
// a human genome passes 2^31 words.
//
// The kernel indexes the table flat, so it takes the table's length M in
// words and the width rw of a row, not a [R, 128] view: the 128 is the
// TPU's lane tile. A row128 table comes with rw = 128; the aligned CSR
// layout, whose runs never cross a row of rw = 16 or more words, with its
// own rw; the window entry knows no rows at all. So every table on the
// card, 1-D or 2-D, of any length, is read by this kernel.
//
// The fused entries. Under XLA the arithmetic around the fetch of a genome
// window (the funnel shift by the start's offset inside its word, the
// unpack of 2-bit lanes to byte codes, the XOR and popcount against a read)
// fuses into the programs around the TPU kernel. In PyTorch each of those
// array ops is a launch of its own, some 40 for a window of byte codes and
// some 70 for a mismatch count, and a step makes them ten times: what is
// scarce on this card is launches, not the rotate. So two entries go in one
// pass from the interleaved genome planes (word 2w = sixteen 2-bit codes,
// word 2w + 1 = their is-N lanes) to the final result, and equal on every
// lane the window entry followed by those array ops, for any start:
// w0 = floor(start / 16) + base_off, r = start - 16 * floor(start / 16) in
// 0..15, the word start 2 * w0 clipped to [0, M - width] like the window
// entry's, the funnel by the unclipped r (a shift of 0 takes the low word).
// Both are bound by bytes (starts and used words in, codes or counts out).
//   window_codes: one thread per 16 output bases. It reads four table words
//       (code and N plane, low and high), funnels, spreads the 2-bit lanes
//       to bytes and stores one 16-byte vector where the row stride allows
//       (length a multiple of 16: 192 and 1,200 are), so neighbouring
//       threads read neighbouring words and the stores of a warp are
//       contiguous.
//   window_mismatches: a group of 16 lanes per row, one read word per lane
//       and step; XOR, N planes, tail mask by length, popcount, then a
//       shuffle reduction over the group.
//
// Entry points (the clamps are the reference's):
//   urmap_row128_fetch, window = 0: one table row per start. s is taken as
//       uint32, row = min(s / rw, M / rw - 1), lane = s % rw + j; lanes
//       past the row's end hold SENTINEL (the fill of the reference's
//       funnel);
//   urmap_row128_fetch, window = 1: the start is clipped to
//       [0, M - width], then table[s + j]: never past the table, so the
//       reference's clip of each row index changes no lane;
//   urmap_rotate_narrow: the literal TPU function on rows already
//       gathered, out[i, j] = rows[i, (j + off[i]) % W];
//   urmap_window_codes, urmap_window_mismatches: the fused entries above;
//       starts are bases, int32 or int64 (starts64), widened here.

#include <cstdint>
#include <cuda_runtime.h>

#include "urmap_kernels.h"

namespace {

constexpr int kSentinel = 0x7FFFFFF0;
constexpr int kThreads = 256;

template <bool WINDOW>
__global__ void row128_fetch_kernel(const int32_t* __restrict__ table,
                                    long long M, int rw,
                                    const long long* __restrict__ starts,
                                    int32_t* __restrict__ out, long long total,
                                    int width) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long i = t / width;
  const int j = (int)(t - i * width);
  long long s = starts[i];
  if (WINDOW) {
    const long long hi = M - width;
    s = s < 0 ? 0 : (s > hi ? hi : s);
    out[t] = table[s + j];
  } else {
    s &= 0xFFFFFFFFLL;
    const long long last = M / rw - 1;
    long long r = s / rw;
    if (r > last) r = last;
    const int lane = (int)(s - (s / rw) * rw) + j;
    out[t] = lane < rw ? table[r * rw + lane] : kSentinel;
  }
}

__global__ void rotate_narrow_kernel(const int32_t* __restrict__ rows,
                                     const int32_t* __restrict__ off,
                                     int32_t* __restrict__ out,
                                     long long total, int W, int width) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long i = t / width;
  const int j = (int)(t - i * width);
  int lane = j + off[i];
  lane %= W;
  if (lane < 0) lane += W;
  out[t] = rows[i * W + lane];
}

// Where window i begins: the clipped word start and the funnel shift.
template <typename S>
__device__ __forceinline__ void window_origin(const S* __restrict__ starts,
                                              long long i, long long base_off,
                                              long long M, int width,
                                              long long* ws, int* sh) {
  const long long s = (long long)starts[i];
  const long long q = s >> 4;  // floor(s / 16), for negative starts too
  *sh = 2 * (int)(s - q * 16);
  const long long hi = M - width;
  const long long w = 2 * (q + base_off);
  *ws = w < 0 ? 0 : (w > hi ? hi : w);
}

// (lo >> sh) | (hi << (32 - sh)); lo where sh == 0
__device__ __forceinline__ uint32_t funnel(uint32_t lo, uint32_t hi, int sh) {
  return __funnelshift_r(lo, hi, sh);
}

// four 2-bit lanes (the low byte of x) → four bytes
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  return (x | (x << 6)) & 0x03030303u;
}

// bases 4q..4q+3 of a word pair → four byte codes, genome N as 4
__device__ __forceinline__ uint32_t codes4(uint32_t code, uint32_t nbits,
                                           int q) {
  const uint32_t c = spread4((code >> (8 * q)) & 0xFFu);
  const uint32_t n = spread4((nbits >> (8 * q)) & 0xFFu) & 0x01010101u;
  return (c & ~(n * 0xFFu)) | (n << 2);
}

template <typename S>
__global__ void window_codes_kernel(const uint32_t* __restrict__ table,
                                    long long M, long long base_off,
                                    const S* __restrict__ starts,
                                    uint8_t* __restrict__ out,
                                    long long total, int nw, int length) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long i = t / nw;
  const int j = (int)(t - i * nw);
  long long ws;
  int sh;
  window_origin(starts, i, base_off, M, 2 * (nw + 1), &ws, &sh);
  const uint32_t* w = table + ws + 2 * j;
  const uint32_t code = funnel(w[0], w[2], sh);
  const uint32_t nbits = funnel(w[1], w[3], sh);
  uint8_t* dst = out + i * length + 16 * j;
  if ((length & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(codes4(code, nbits, 0), codes4(code, nbits, 1),
                   codes4(code, nbits, 2), codes4(code, nbits, 3));
  } else {
    const int left = min(16, length - 16 * j);
    for (int b = 0; b < left; ++b)
      dst[b] = (nbits >> (2 * b)) & 1u ? 4 : (code >> (2 * b)) & 3u;
  }
}

constexpr int kRowLanes = 16;  // lanes per row of window_mismatches

template <typename S>
__global__ void window_mismatches_kernel(
    const uint32_t* __restrict__ table, long long M, long long base_off,
    const S* __restrict__ starts, const uint32_t* __restrict__ rp,
    const uint32_t* __restrict__ rn, const int32_t* __restrict__ lengths,
    int32_t* __restrict__ out, long long n, int nw) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = t / kRowLanes;
  const int lane = (int)(t % kRowLanes);
  int count = 0;
  if (i < n) {
    long long ws;
    int sh;
    window_origin(starts, i, base_off, M, 2 * (nw + 1), &ws, &sh);
    const int len = lengths[i];
    for (int j = lane; j < nw; j += kRowLanes) {
      const uint32_t* w = table + ws + 2 * j;
      const uint32_t x = funnel(w[0], w[2], sh) ^ rp[i * nw + j];
      const uint32_t bits =
          ((x | (x >> 1)) | funnel(w[1], w[3], sh) | rn[i * nw + j]) &
          0x55555555u;
      const int rem = min(max(len - 16 * j, 0), 16);
      const uint32_t tail = rem >= 16 ? 0xFFFFFFFFu : (1u << (2 * rem)) - 1u;
      count += __popc(bits & tail);
    }
  }
  // every lane of the warp arrives here: rows past n add 0
  for (int d = kRowLanes / 2; d > 0; d >>= 1)
    count += __shfl_xor_sync(0xFFFFFFFFu, count, d, kRowLanes);
  if (i < n && lane == 0) out[i] = count;
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int urmap_row128_fetch(const void* table, long long M, int rw,
                                  const void* starts, void* out, long long n,
                                  int width, int window, void* stream) {
  const long long total = n * width;
  if (total <= 0) return (int)cudaGetLastError();
  if (width <= 0 || (window ? M < width : (rw <= 0 || M < rw)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* tb = (const int32_t*)table;
  const auto* st = (const long long*)starts;
  if (window) {
    row128_fetch_kernel<true><<<blocks_for(total), kThreads, 0, s>>>(
        tb, M, rw, st, (int32_t*)out, total, width);
  } else {
    row128_fetch_kernel<false><<<blocks_for(total), kThreads, 0, s>>>(
        tb, M, rw, st, (int32_t*)out, total, width);
  }
  return (int)cudaGetLastError();
}

extern "C" int urmap_rotate_narrow(const void* rows, const void* off,
                                   void* out, long long n, int W, int width,
                                   void* stream) {
  const long long total = n * width;
  if (total <= 0) return (int)cudaGetLastError();
  if (W <= 0 || width <= 0 || width > W) return (int)cudaErrorInvalidValue;
  rotate_narrow_kernel<<<blocks_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)off, (int32_t*)out, total, W,
      width);
  return (int)cudaGetLastError();
}

extern "C" int urmap_window_codes(const void* table, long long M,
                                  long long base_off, const void* starts,
                                  int starts64, void* out, long long n,
                                  int length, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int nw = (length + 15) / 16;
  if (length <= 0 || M < 2 * (nw + 1)) return (int)cudaErrorInvalidValue;
  const long long total = n * nw;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* tb = (const uint32_t*)table;
  if (starts64) {
    window_codes_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        tb, M, base_off, (const long long*)starts, (uint8_t*)out, total, nw,
        length);
  } else {
    window_codes_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        tb, M, base_off, (const int32_t*)starts, (uint8_t*)out, total, nw,
        length);
  }
  return (int)cudaGetLastError();
}

extern "C" int urmap_window_mismatches(const void* table, long long M,
                                       long long base_off, const void* starts,
                                       int starts64, const void* rp,
                                       const void* rn, const void* lengths,
                                       void* out, long long n, int nw,
                                       void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (nw <= 0 || M < 2 * (nw + 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* tb = (const uint32_t*)table;
  const auto* p = (const uint32_t*)rp;
  const auto* q = (const uint32_t*)rn;
  const auto* ln = (const int32_t*)lengths;
  const unsigned blocks = blocks_for(n * kRowLanes);
  if (starts64) {
    window_mismatches_kernel<<<blocks, kThreads, 0, s>>>(
        tb, M, base_off, (const long long*)starts, p, q, ln, (int32_t*)out, n,
        nw);
  } else {
    window_mismatches_kernel<<<blocks, kThreads, 0, s>>>(
        tb, M, base_off, (const int32_t*)starts, p, q, ln, (int32_t*)out, n,
        nw);
  }
  return (int)cudaGetLastError();
}
