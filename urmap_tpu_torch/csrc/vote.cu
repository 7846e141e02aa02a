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
// What bounds it on the card: integer ALU work. The least the function
// needs per read is the 28-stage bitonic network's 28 x 64
// compare-exchanges (a min and a max each), a head test per value and V
// maxima over 128 keys; each read's 512 input bytes are read once. 2B =
// 32,768 reads at the slice's shapes, so parallelism is plentiful and
// instructions and their latency set the pace. Design: one warp per
// read with the 128 values in registers, four a lane, value k * 32 +
// lane in x[k] (no shared memory, no index arithmetic):
//   - the network is unrolled, every partner and direction a constant
//     of the stage: strides 64 and 32 exchange between a lane's own
//     registers (a min and a max), strides 16 .. 1 take the partner by
//     __shfl_xor_sync and keep the min or the max (a compare whose
//     predicate folds the direction, and a select);
//   - run heads come from one neighbour shuffle per register and four
//     __ballot_sync, which make a 128-bit head mask; a head's run ends
//     at the next set bit (__ffs on its word, else the first set bit of
//     the words above, which every lane computes once);
//   - each top-V round is one __reduce_max_sync over keys votes * 128 +
//     (127 - index): the larger key is the lower index on equal votes,
//     the reference's order; the lane that owns the pick writes it and
//     clears its key.
// Above 128 candidates (Q x P up to 8 x 256 = 2,048 at the index's
// largest slot cap, and on to kMaxM) a read no longer fits a warp's
// registers: vote_smem_kernel gives each read a block of 256 threads and
// sorts its values, padded to the next power of two MP with SENTINEL, in
// shared memory (the same bitonic network, a stage per barrier). A run
// head e then finds its run's end by a binary search for the first value
// above x[e] (log2 MP steps), and the top-V rounds are block-wide maxima
// over the same keys, votes * MP + (MP - 1 - e): the same tie orders.

#include <cstdint>
#include <cuda_runtime.h>

#include "urmap_kernels.h"

namespace {

constexpr int kLanes = 128;
constexpr int kSmemThreads = 256;  // threads per read above kLanes
constexpr int kMaxM = 4096;        // the most candidates a read takes
constexpr int kWarps = 4;  // reads per block
constexpr int32_t kSentinel = 0x7FFFFFF0;
constexpr unsigned kFull = 0xFFFFFFFFu;

// First set bit of a 32-bit word at index base, or `none` if it is 0.
__device__ __forceinline__ int first_bit(unsigned w, int base, int none) {
  return w ? base + __ffs(w) - 1 : none;
}

__global__ void __launch_bounds__(kWarps * 32)
    vote_kernel(const int32_t* __restrict__ cand, int32_t* __restrict__ top,
                int32_t* __restrict__ votes, int n, int m, int v) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together
  const int32_t* c = cand + row * m;
  int x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = k * 32 + lane;
    x[k] = e < m ? c[e] : kSentinel;
  }

  // bitonic sort, ascending: element e meets e ^ stride; the lower of
  // the two keeps the min where (e & size) == 0, else the max
#pragma unroll
  for (int size = 2; size <= kLanes; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int s = stride >> 5;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k & s) continue;
          const bool asc = ((k * 32) & size) == 0;
          const int lo = min(x[k], x[k | s]), hi = max(x[k], x[k | s]);
          x[k] = asc ? lo : hi;
          x[k | s] = asc ? hi : lo;
        }
      } else {
        const bool upper = (lane & stride) != 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool desc = size < 32 ? (lane & size) != 0
                                      : ((k * 32) & size) != 0;
          const bool take_min = upper == desc;
          const int y = __shfl_xor_sync(kFull, x[k], stride);
          x[k] = (y < x[k]) == take_min ? y : x[k];
        }
      }
    }
  }

  // run heads: e == 0 or x[e - 1] != x[e]; the mask holds every head,
  // SENTINEL's too, since a run ends where the next value starts
  unsigned hm[4];
  int prev_last = 0;  // x[k - 1] of lane 31
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int up = __shfl_up_sync(kFull, x[k], 1);
    const bool head = lane == 0 ? (k == 0 || prev_last != x[k]) : up != x[k];
    hm[k] = __ballot_sync(kFull, head);
    prev_last = __shfl_sync(kFull, x[k], 31);
  }
  // the first head at or above word k + 1 (lane-uniform)
  int above[4];
  above[3] = kLanes;
#pragma unroll
  for (int k = 2; k >= 0; --k) above[k] = first_bit(hm[k + 1], 32 * (k + 1),
                                                    above[k + 1]);
  int key[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = k * 32 + lane;
    // heads strictly above e in word k (lane 31: none)
    const unsigned later = lane == 31 ? 0u : hm[k] & (~0u << (lane + 1));
    const int next = first_bit(later, 32 * k, above[k]);
    const bool head = (hm[k] >> lane) & 1u;
    const int vts = head && x[k] != kSentinel ? next - e : 0;
    key[k] = vts * kLanes + (kLanes - 1 - e);
  }

  // top-V: the largest key, then its owner clears it
  for (int r = 0; r < v; ++r) {
    const int best = __reduce_max_sync(
        kFull, max(max(key[0], key[1]), max(key[2], key[3])));
    const int e = kLanes - 1 - (best & (kLanes - 1));
    const int vts = best >> 7;
    if (lane == (e & 31)) {
      const int k = e >> 5;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j == k) {
          top[row * v + r] = vts > 0 ? x[j] : kSentinel;
          votes[row * v + r] = vts;
          key[j] = -1;
        }
      }
    }
  }
}

__device__ __forceinline__ int block_max(int x, int* red) {
  x = __reduce_max_sync(kFull, x);
  const int w = threadIdx.x >> 5;
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[w] = x;
  __syncthreads();
  int m = red[0];
#pragma unroll
  for (int i = 1; i < kSmemThreads / 32; ++i) m = max(m, red[i]);
  return m;
}

// One block per read, MP = the next power of two >= m (<= kMaxM).
__global__ void __launch_bounds__(kSmemThreads)
    vote_smem_kernel(const int32_t* __restrict__ cand,
                     int32_t* __restrict__ top, int32_t* __restrict__ votes,
                     int m, int mp, int v) {
  __shared__ int x[kMaxM];
  __shared__ int red[kSmemThreads / 32];
  const long long row = blockIdx.x;
  const int32_t* c = cand + row * m;
  for (int e = threadIdx.x; e < mp; e += kSmemThreads)
    x[e] = e < m ? c[e] : kSentinel;
  __syncthreads();
  // bitonic sort, ascending: element e meets e ^ stride; the lower of the
  // two keeps the min where (e & size) == 0, else the max
  for (int size = 2; size <= mp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < mp / 2; p += kSmemThreads) {
        const int e = 2 * p - (p & (stride - 1));  // e has bit `stride` 0
        const int f = e + stride;
        const int a = x[e], b = x[f];
        const bool asc = (e & size) == 0;
        if ((a > b) == asc) {
          x[e] = b;
          x[f] = a;
        }
      }
      __syncthreads();
    }
  }
  // keys of the values this thread holds: heads by run length, the rest
  // and SENTINEL's run 0 votes
  int best_key = -1;
  constexpr int kPer = kMaxM / kSmemThreads;
  int key[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kSmemThreads;
    key[j] = -1;
    if (e < mp) {
      const int val = x[e];
      int vts = 0;
      if ((e == 0 || x[e - 1] != val) && val != kSentinel) {
        int lo = e, hi = mp;  // the first index above e holding more
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (x[mid] > val) hi = mid; else lo = mid + 1;
        }
        vts = lo - e;
      }
      key[j] = vts * mp + (mp - 1 - e);
      best_key = max(best_key, key[j]);
    }
  }
  // top-V: the largest key, then its owner clears it
  for (int r = 0; r < v; ++r) {
    const int best = block_max(best_key, red);
    const int e = mp - 1 - best % mp;
    const int vts = best / mp;
    if ((int)threadIdx.x == e % kSmemThreads) {
      top[row * v + r] = vts > 0 ? x[e] : kSentinel;
      votes[row * v + r] = vts;
      best_key = -1;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (j == e / kSmemThreads) key[j] = -1;
        best_key = max(best_key, key[j]);
      }
    }
  }
}

}  // namespace

extern "C" int urmap_vote(const void* cand, void* top, void* votes, int n,
                          int m, int v, void* stream) {
  if (m < 1 || m > kMaxM || v < 1 || v > m) return (int)cudaErrorInvalidValue;
  if (n > 0 && m <= kLanes) {
    const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
    vote_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cand, (int32_t*)top, (int32_t*)votes, n, m, v);
  } else if (n > 0) {
    int mp = kLanes;
    while (mp < m) mp <<= 1;
    vote_smem_kernel<<<(unsigned)n, kSmemThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cand, (int32_t*)top, (int32_t*)votes, m, mp, v);
  }
  return (int)cudaGetLastError();
}
