// Kernel B8: rounds of uint32 multiply, xor-shift and add on every word.
//
// Replaces the Pallas kernel of tools/bench_microvpu.py (f_pallas, kernel
// body `kernel`): that tool's question was whether unfused elementwise
// array code or one hand kernel sets the pace of the same integer work.
// Round i (0-based) of `body` maps a word h to
//     h = h * (0x9E3779B1 + 2i + 1);  h ^= h >> 15 (logical);  h += 0x85EBCA6B
// every step modulo 2^32. The TPU kernel runs it over blocks of 2,048 rows
// in VMEM with grid N / 2,048, so rows past the last whole block are never
// written; here every word of any [N, W] is computed. The rounds are a run
// time argument (the tool's PASSES = 24).
//
// What bounds it on this card: the input read once and the output written
// once (8 bytes a word) against two int32 ALU instructions a round and word
// (SHF for the shift, LOP3 for the xor; the multiply and the add of the
// round before fold into one IMAD on the FMA pipe). At 24 rounds the two
// are near each other (0.020 ms of bytes, 0.024 ms of instructions for
// 8,388,608 words). Design: the words are read and written as 16-byte
// vectors, four a thread, neighbouring threads on neighbouring vectors, and
// the four words' rounds interleave as four independent chains. A
// grid-stride loop takes any length; the last group of fewer than four
// words, and tensors whose base is not 16-byte aligned, go word by word.

#include <cstdint>
#include <cuda_runtime.h>

#include "urmap_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;
constexpr uint32_t kMul = 0x9E3779B1u;  // round i multiplies by kMul + 2i + 1
constexpr uint32_t kAdd = 0x85EBCA6Bu;

__global__ void __launch_bounds__(kThreads)
    micro_passes_kernel(const uint32_t* __restrict__ x,
                        uint32_t* __restrict__ out, long long n, int passes,
                        int vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       4 * g < n; g += stride) {
    const long long e = 4 * g;
    const bool full = vec && e + 4 <= n;
    uint32_t h[4];
    if (full) {
      const uint4 v = *reinterpret_cast<const uint4*>(x + e);
      h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) h[k] = e + k < n ? x[e + k] : 0u;
    }
    uint32_t c = kMul + 1u;
#pragma unroll 4
    for (int i = 0; i < passes; ++i, c += 2u) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        h[k] *= c;
        h[k] ^= h[k] >> 15;
        h[k] += kAdd;
      }
    }
    if (full) {
      *reinterpret_cast<uint4*>(out + e) = make_uint4(h[0], h[1], h[2], h[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (e + k < n) out[e + k] = h[k];
    }
  }
}

}  // namespace

extern "C" int urmap_micro_passes(const void* x, void* out, long long n,
                                  int passes, void* stream) {
  if (n < 0 || passes < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const long long groups = (n + 3) / 4;
    long long blocks = (groups + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    const int vec =
        (((uintptr_t)x | (uintptr_t)out) & 15) == 0 ? 1 : 0;
    micro_passes_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, n, passes, vec);
  }
  return (int)cudaGetLastError();
}
