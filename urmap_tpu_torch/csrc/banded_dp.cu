// Kernels B1 and B1': banded semi-global affine-gap DP.
//
// B1 replaces urmap_tpu/kernels/banded_dp.py:pallas_from_windows (body
// _make_kernel), over pre-gathered windows. B1' replaces
// banded_semiglobal_pallas of the same file: the same DP with the window
// read per cell from the byte genome, genome[clamp(cand - hw + c, 0, G-1)],
// so no [N, L + 2*hw] window tensor is gathered first. The DP body is one
// template; where the window bytes come from is its parameter (WindowRows,
// ByteGenome below). B1' also differs in two outputs, as the reference's
// function does: the ungapped score is re-read from the genome at
// POS = cand + d0 with the same clamp (in clip mode POS may lie outside the
// band, where B1 gives 0), and the third output is the reference span
// lengths + d1 - d0 in place of d1.
//
// For each candidate: windows[N, L + 2*hw] (genome from
// cand - hw, genome N = 4), reads[N, L] (read N = 5), lengths[N]. The band
// holds W = 2*hw + 1 diagonals; scores ride packed with the start cell,
// packed = score * S + b0, so every max tie-breaks toward the larger
// start. Outputs, each int32[N]:
//   scores = floor(packed / S)   (packed goes negative: floor division,
//                                 not C's truncation)
//   d0     = b0 - hw             (b0 = packed - scores * S, in [0, S))
//   d1     = first band cell holding the last-row maximum, minus hw
//   ung    = straight-diagonal score at cell b0 over the read (0 when
//            b0 >= W, which only the clip mode can give)
// CLIP (compile-time): every row may open a fresh alignment (read prefix
// clipped, clip_open charged once) and the running best early exit
// (suffix clipped, clip_open charged) competes with the last row; S then
// widens to L + 2*hw + 1.
//
// What bounds it on the card: integer ALU work. With add+max fused
// (VIADDMNMX) a band cell of a read row takes at least 6 instructions
// on the int32 ALU pipe (E, T, the running max and H one each, the
// substitution's compare and select) and one plain add: 33 x 150 x 6 =
// ~30k per candidate, 32,768 candidates per DP bucket round at the
// slice's shapes; the windows and reads (352 bytes per candidate) are
// read once. Design: one thread per
// candidate, the band's H, E and window bytes in registers (W is a
// template parameter, so the band loops unroll), the deletion chain as a
// sequential running max along the band (exactly the reference's
// exclusive max-scan), and the loop stops at the read's length: rows past
// it change neither the last-row cells nor the early exit. Lengths outside
// [0, L] are taken as the reference takes them: below 0 as 0, above L as
// a read whose last row is never reached. The TPU
// kernel's f32 division (a Mosaic limit) is plain integer floor division
// here, and its per-cell ungapped accumulators become one pass over the
// winning diagonal after the DP.

#include <cstdint>
#include <cuda_runtime.h>

#include "urmap_kernels.h"

namespace {

constexpr int kNeg = -(1 << 20);

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Pre-gathered windows uint8[N, wlen]: column c of candidate t.
struct WindowRows {
  static constexpr bool kByteGenome = false;
  const uint8_t* win;
  int wlen;
  struct Row {
    const uint8_t* w;
    int wlen;
    __device__ __forceinline__ int at(int c) const {
      return c < wlen ? w[c] : 0;
    }
  };
  __device__ __forceinline__ Row row(long long t, int) const {
    return Row{win + t * wlen, wlen};
  }
};

// The byte genome uint8[G]: column c of candidate t is the base at
// cand[t] - hw + c, each index clamped to [0, G-1] on its own.
struct ByteGenome {
  static constexpr bool kByteGenome = true;
  const uint8_t* genome;
  long long G;
  const int32_t* cand;
  struct Row {
    const uint8_t* g;
    long long last;
    long long base;
    __device__ __forceinline__ int at(int c) const {
      long long p = base + c;
      p = p < 0 ? 0 : (p > last ? last : p);
      return g[p];
    }
  };
  __device__ __forceinline__ Row row(long long t, int hw) const {
    return Row{genome, G - 1, (long long)cand[t] - hw};
  }
};

template <int HW, bool CLIP, class Win>
__global__ void banded_dp_kernel(const Win src,
                                 const uint8_t* __restrict__ reads,
                                 const int32_t* __restrict__ lengths,
                                 int32_t* __restrict__ scores,
                                 int32_t* __restrict__ d0out,
                                 int32_t* __restrict__ d1out,
                                 int32_t* __restrict__ ung, int n, int L,
                                 int match, int mismatch, int gap_open,
                                 int gap_extend, int clip_open) {
  constexpr int W = 2 * HW + 1;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int S = CLIP ? (L + 2 * HW + 1) : (W + 1);
  const int negp = kNeg * S;
  const int open_s = gap_open * S, ext_s = gap_extend * S;
  const int match_s = match * S, mis_s = mismatch * S;
  const int clip_s = clip_open * S;
  // E's last cell reads the band's fill value through both terms
  const int e_last = max(negp + open_s, negp + ext_s);
  const typename Win::Row w = src.row(t, HW);
  const uint8_t* r = reads + t * L;
  const int len = lengths[t];
  const int rows = len < 0 ? 0 : (len > L ? L : len);

  int H[W], E[W], wr[W];
#pragma unroll
  for (int b = 0; b < W; ++b) {
    H[b] = b;  // score 0, start cell b
    E[b] = negp;
    wr[b] = w.at(b);
  }
  int early = negp;
  for (int i = 0; i < rows; ++i) {
    if (CLIP) {
#pragma unroll
      for (int b = 0; b < W; ++b) {
        const int fresh = i == 0 ? b : clip_s + b + i;
        H[b] = max(H[b], fresh);
      }
    }
    const int rd = r[i];
#pragma unroll
    for (int b = 0; b < W - 1; ++b) {
      E[b] = max(H[b + 1] + open_s, E[b + 1] + ext_s);
    }
    E[W - 1] = e_last;
    // T = max(diag, E) into H, then the deletion chain:
    // F[b] = max_{c<b}(T[c] - (c+1)*ext) + open + b*ext
    int run = negp;
#pragma unroll
    for (int b = 0; b < W; ++b) {
      const int T = max(H[b] + (wr[b] == rd ? match_s : mis_s), E[b]);
      const int F = run + open_s + b * ext_s;
      run = max(run, T - (b + 1) * ext_s);
      H[b] = max(T, F);
    }
    if (CLIP) {
      int row_best = negp;
      if (i + 1 < len) {
#pragma unroll
        for (int b = 0; b < W; ++b) row_best = max(row_best, H[b]);
      }
      early = max(early, row_best + clip_s);
    }
#pragma unroll
    for (int b = 0; b < W - 1; ++b) wr[b] = wr[b + 1];
    // column i + W is the last cell of row i + 1; past the last row it
    // is never compared
    wr[W - 1] = w.at(i + W);
  }

  // a length above L has no last row among the L that exist: the
  // reference then keeps the initial row (score 0 at the last band cell),
  // while its fresh starts and early exits have run over all L rows
  if (len > L) {
#pragma unroll
    for (int b = 0; b < W; ++b) H[b] = b;
  }
  int best = H[0], bend = 0;
#pragma unroll
  for (int b = 1; b < W; ++b) {
    if (H[b] > best) {
      best = H[b];
      bend = b;
    }
  }
  if (CLIP) best = max(best, early);
  const int sc = floordiv(best, S);
  const int b0 = best - sc * S;
  // straight-diagonal score from column b0 on: read base i against the
  // base at cand - hw + b0 + i = POS + i
  int u = 0;
  if (Win::kByteGenome || b0 < W) {
    for (int i = 0; i < rows; ++i) u += w.at(i + b0) == r[i] ? match : mismatch;
  }
  scores[t] = sc;
  d0out[t] = b0 - HW;
  d1out[t] = Win::kByteGenome ? len + bend - b0 : bend - HW;
  ung[t] = u;
}

template <int HW, class Win>
void launch(bool clip, dim3 grid, dim3 block, cudaStream_t s, const Win& src,
            const uint8_t* reads, const int32_t* lengths, int32_t* scores,
            int32_t* d0, int32_t* d1, int32_t* ung, int n, int L, int match,
            int mismatch, int gap_open, int gap_extend, int clip_open) {
  if (clip) {
    banded_dp_kernel<HW, true, Win><<<grid, block, 0, s>>>(
        src, reads, lengths, scores, d0, d1, ung, n, L, match, mismatch,
        gap_open, gap_extend, clip_open);
  } else {
    banded_dp_kernel<HW, false, Win><<<grid, block, 0, s>>>(
        src, reads, lengths, scores, d0, d1, ung, n, L, match, mismatch,
        gap_open, gap_extend, clip_open);
  }
}

// Band half-widths with a compiled kernel (the wrapper checks first).
template <class Win>
int dispatch(const Win& src, const void* reads, const void* lengths,
             void* scores, void* d0, void* d1, void* ung, int n, int L,
             int hw, int match, int mismatch, int gap_open, int gap_extend,
             int clip, int clip_open, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const dim3 block(128);
  const dim3 grid((unsigned)((n + 127) / 128));
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* r = (const uint8_t*)reads;
  const auto* ln = (const int32_t*)lengths;
  auto* o0 = (int32_t*)scores;
  auto* o1 = (int32_t*)d0;
  auto* o2 = (int32_t*)d1;
  auto* o3 = (int32_t*)ung;
  switch (hw) {
    case 8:
      launch<8>(clip != 0, grid, block, s, src, r, ln, o0, o1, o2, o3, n, L,
                match, mismatch, gap_open, gap_extend, clip_open);
      break;
    case 16:
      launch<16>(clip != 0, grid, block, s, src, r, ln, o0, o1, o2, o3, n, L,
                 match, mismatch, gap_open, gap_extend, clip_open);
      break;
    case 32:
      launch<32>(clip != 0, grid, block, s, src, r, ln, o0, o1, o2, o3, n, L,
                 match, mismatch, gap_open, gap_extend, clip_open);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int urmap_banded_dp(const void* win, const void* reads,
                               const void* lengths, void* scores, void* d0,
                               void* d1, void* ung, int n, int L, int hw,
                               int match, int mismatch, int gap_open,
                               int gap_extend, int clip, int clip_open,
                               void* stream) {
  const WindowRows src{(const uint8_t*)win, L + 2 * hw};
  return dispatch(src, reads, lengths, scores, d0, d1, ung, n, L, hw, match,
                  mismatch, gap_open, gap_extend, clip, clip_open, stream);
}

// B1': outputs scores, d0, ungapped at POS, span = lengths + d1 - d0.
extern "C" int urmap_banded_semiglobal(const void* genome, long long G,
                                       const void* cand, const void* reads,
                                       const void* lengths, void* scores,
                                       void* d0, void* ung, void* span, int n,
                                       int L, int hw, int match, int mismatch,
                                       int gap_open, int gap_extend, int clip,
                                       int clip_open, void* stream) {
  if (G <= 0) return (int)cudaErrorInvalidValue;
  const ByteGenome src{(const uint8_t*)genome, G, (const int32_t*)cand};
  return dispatch(src, reads, lengths, scores, d0, span, ung, n, L, hw, match,
                  mismatch, gap_open, gap_extend, clip, clip_open, stream);
}
