// Kernel B3: seed slots from the 2-bit read word planes.
//
// Replaces urmap_tpu/kernels/seed_slots.py:seed_slots_words_pallas
// (body _make_kernel). Computes, for each read and each of its Q seed
// offsets o (map/seed.py seed_offsets, clipped to [0, L-k]), the k-mer at
// o read straight from the word planes (word o/16 and the next two,
// funnel-shifted by 2*(o%16)), its 2-bit lanes reversed to
// first-base-most-significant order, hashed with murmur3-fmix32 in uint32
// arithmetic (wraparound multiplies, logical shifts) to slot_bits bits.
// valid = no N base in the k-mer and len >= k. Two guard words past the
// planes read as code 0 / all-N (0x55555555), as the reference pads them.
//
// What bounds it on the card: nothing much — per (read, seed) it reads
// three words of each plane (24 bytes) and does ~40 integer ops; 2B x Q
// = 262,144 threads at the slice's shapes. Memory latency dominates.
// Design: one thread per (read, seed), indexing the words directly. The
// TPU kernel computed every dense offset through MXU expansion matmuls (a
// Mosaic workaround for the missing sublane repeat); only Q = 8 k-mers
// per read are used, so the GPU computes just those.

#include <cstdint>
#include <cuda_runtime.h>

#include "urmap_kernels.h"

namespace {

__device__ __forceinline__ uint32_t rev2bit(uint32_t x) {
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  return (x << 16) | (x >> 16);
}

__device__ __forceinline__ uint32_t funnel(uint32_t lo, uint32_t hi,
                                           uint32_t sh) {
  return sh == 0 ? lo : (lo >> sh) | (hi << (32u - sh));
}

__device__ __forceinline__ uint32_t hash_words(uint32_t lo, uint32_t hi) {
  uint32_t h = lo * 0x9E3779B1u;
  h ^= hi * 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__global__ void seed_slots_kernel(const uint32_t* __restrict__ rp,
                                  const uint32_t* __restrict__ rn,
                                  const int32_t* __restrict__ lengths,
                                  int32_t* __restrict__ slots,
                                  int32_t* __restrict__ offs,
                                  bool* __restrict__ valid, int n, int nw,
                                  int L, int k, int q, int slot_bits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * q) return;
  const int row = (int)(t / q);
  const int qi = (int)(t % q);
  const int len = lengths[row];
  const int span = len - k > 0 ? len - k : 0;
  const int off = q == 1 ? 0 : (qi * span) / (q - 1);
  const int m = L - k + 1;
  const int oc = off < 0 ? 0 : (off > m - 1 ? m - 1 : off);
  const int w = oc >> 4;
  const uint32_t sh = 2u * (uint32_t)(oc & 15);
  const uint32_t* cw = rp + (long long)row * nw;
  const uint32_t* nwp = rn + (long long)row * nw;
  uint32_t c[3], nn[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const bool in = w + d < nw;
    c[d] = in ? cw[w + d] : 0u;
    nn[d] = in ? nwp[w + d] : 0x55555555u;
  }
  const uint32_t A = funnel(c[0], c[1], sh), nA = funnel(nn[0], nn[1], sh);
  const uint32_t B = funnel(c[1], c[2], sh), nB = funnel(nn[1], nn[2], sh);
  uint32_t lo, hi, okbits;
  if (k <= 16) {
    lo = k == 16 ? rev2bit(A) : rev2bit(A) >> (32 - 2 * k);
    hi = 0u;
    okbits = k == 16 ? nA : nA & ((1u << (2 * k)) - 1u);
  } else if (k == 32) {
    hi = rev2bit(A);
    lo = rev2bit(B);
    okbits = nA | nB;
  } else {
    const uint32_t ra = rev2bit(A), rb = rev2bit(B);
    const int hb = 2 * (k - 16);
    hi = ra >> (32 - hb);
    lo = (ra << hb) | (rb >> (32 - hb));
    okbits = nA | (nB & ((1u << hb) - 1u));
  }
  const uint32_t mask =
      slot_bits >= 32 ? 0xFFFFFFFFu : ((1u << slot_bits) - 1u);
  slots[t] = (int32_t)(hash_words(lo, hi) & mask);
  offs[t] = off;
  valid[t] = okbits == 0u && len >= k;
}

}  // namespace

extern "C" int urmap_seed_slots(const void* rp, const void* rn,
                                const void* lengths, void* slots, void* offs,
                                void* valid, int n, int nw, int L, int k,
                                int q, int slot_bits, void* stream) {
  const long long total = (long long)n * q;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    seed_slots_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rp, (const uint32_t*)rn, (const int32_t*)lengths,
        (int32_t*)slots, (int32_t*)offs, (bool*)valid, n, nw, L, k, q,
        slot_bits);
  }
  return (int)cudaGetLastError();
}
