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
// Entry points (the clamps are the reference's):
//   urmap_row128_fetch, window = 0: one table row per start. s is taken as
//       uint32, row = min(s / rw, M / rw - 1), lane = s % rw + j; lanes
//       past the row's end hold SENTINEL (the fill of the reference's
//       funnel);
//   urmap_row128_fetch, window = 1: the start is clipped to
//       [0, M - width], then table[s + j]: never past the table, so the
//       reference's clip of each row index changes no lane;
//   urmap_rotate_narrow: the literal TPU function on rows already
//       gathered, out[i, j] = rows[i, (j + off[i]) % W].

#include <cstdint>
#include <cuda_runtime.h>

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
