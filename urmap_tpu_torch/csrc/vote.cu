// Kernel B4: candidate diagonal vote (sort + run-length + top-V).
//
// Replaces urmap_tpu/kernels/vote.py:vote_pallas (body _make_kernel).
// Per read: sort the M <= 128 candidate starts ascending (padded to 128
// with SENTINEL, which sorts last and carries no votes), give every run
// head a vote count equal to its run length (SENTINEL runs get 0), and
// pick the top V heads by votes, ties to the lowest sorted position —
// the order of jax.lax.top_k in the reference. A pick with 0 votes
// outputs (SENTINEL, 0).
//
// What bounds it on the card: shared-memory traffic and warp syncs of
// the 28-stage bitonic network (64 compare-exchanges per stage) for
// 2B = 32,768 reads at the slice's shapes; each read's 512 input bytes
// are read once. Design: one warp per read, the 128 values in shared
// memory (each lane owns 2 of the 64 pairs per stage), run lengths by a
// binary search for each head's run end, then V rounds of a warp argmax
// (__shfl_xor_sync) that prefers the lower index on equal votes.

#include <cstdint>
#include <cuda_runtime.h>

#include "urmap_kernels.h"

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = 4;  // reads per block
constexpr int32_t kSentinel = 0x7FFFFFF0;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void vote_kernel(const int32_t* __restrict__ cand,
                            int32_t* __restrict__ top,
                            int32_t* __restrict__ votes, int n, int m,
                            int v) {
  __shared__ int32_t sx[kWarps][kLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= n) return;  // the whole warp leaves together
  int32_t* x = sx[warp];
  const int32_t* c = cand + row * m;
  for (int i = lane; i < kLanes; i += 32) x[i] = i < m ? c[i] : kSentinel;
  __syncwarp();

  // bitonic sort, ascending
  for (int size = 2; size <= kLanes; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < kLanes / 2; t += 32) {
        const int i = 2 * stride * (t / stride) + (t % stride);
        const int j = i + stride;
        const bool asc = (i & size) == 0;
        const int32_t a = x[i], b = x[j];
        if ((a > b) == asc) {
          x[i] = b;
          x[j] = a;
        }
      }
      __syncwarp();
    }
  }

  // run-length votes at run heads: run end = upper bound of the value
  int key[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = lane + 32 * t;
    const int32_t val = x[i];
    const bool head = i == 0 || x[i - 1] != val;
    key[t] = 0;
    if (head && val != kSentinel) {
      int lo = i + 1, hi = kLanes;  // first index with x > val
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (x[mid] > val) hi = mid; else lo = mid + 1;
      }
      key[t] = lo - i;
    }
  }

  // top-V: max votes, ties to the lowest index
  for (int r = 0; r < v; ++r) {
    int best = -1, bi = kLanes;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (key[t] > best) {
        best = key[t];
        bi = lane + 32 * t;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (lane + 32 * t == bi) key[t] = -1;
    }
    if (lane == 0) {
      top[row * v + r] = best > 0 ? x[bi] : kSentinel;
      votes[row * v + r] = best > 0 ? best : 0;
    }
  }
}

}  // namespace

extern "C" int urmap_vote(const void* cand, void* top, void* votes, int n,
                          int m, int v, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
    vote_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cand, (int32_t*)top, (int32_t*)votes, n, m, v);
  }
  return (int)cudaGetLastError();
}
