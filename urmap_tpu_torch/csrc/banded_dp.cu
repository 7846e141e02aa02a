// Kernels B1 and B1': banded semi-global affine-gap DP.
//
// B1 replaces urmap_tpu/kernels/banded_dp.py:pallas_from_windows (body
// _make_kernel), over pre-gathered windows. B1' replaces
// banded_semiglobal_pallas of the same file: the same DP with the window
// read from the byte genome, genome[clamp(cand - hw + c, 0, G-1)], so no
// [N, L + 2*hw] window tensor is gathered first. The DP body is one
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
// widens to L + 2*hw + 1. Lengths outside [0, L] are taken as the
// reference takes them: below 0 as 0, above L as a read whose last row is
// never reached (the initial row stands; fresh starts and early exits
// run over all L rows). The TPU kernel's f32 division (a Mosaic limit) is
// plain integer floor division here. Window and read bytes are codes
// (genome 0-4, reads 0-3 and 5), but any byte is taken as it is: a
// window byte matches a read byte where the two are equal.
//
// What bounds it on the card: integer ALU work, ~6 instructions on the
// int32 pipe per band cell and read row (7.5 in clip mode; 3 in plain
// mode, where one instruction takes two 16-bit cells), 33 x 150
// cells per candidate at the slice's shapes: 32,768 candidates in plain
// mode, 8,192 in clip mode. The windows and reads (352 bytes per
// candidate) are read once.
//
// Design:
//   - K lanes per candidate (K a template parameter, 2 or 4), the band
//     cut into K runs of CPL = ceil(W / K) neighbouring cells, so that a
//     small N still fills the card: one thread per candidate put 8,192
//     clip-mode candidates on 64 of 132 SMs, one warp a scheduler.
//     launch_lanes below picks K: for B1 the fewest lanes that put 65,536
//     threads on the card, 2 from 32,768 candidates and 4 below; for B1'
//     4 at every N (its staging, a clamped byte loop, weighs more).
//     Measured on an H100 at both shapes (PERF.md), 1 lane tied with 2
//     (fewer instructions, fewer warps) and 8 with 4 (the lane's fixed
//     cost per row grows with K), so only 2 and 4 are compiled. Cells
//     past the band's end (K * CPL > W) are computed and never read:
//     only cell W - 1 takes E from a higher cell, and it takes the fill
//     value.
//   - The one cross-lane term of E per row is max(H + open, E + ext) of
//     the next lane's first cell: one __shfl_down_sync. The deletion
//     chain is a prefix maximum over segments of SEG cells (short serial
//     chains side by side), then an exclusive max-scan over the K lanes
//     (log2 K + 1 shuffles).
//   - Every value of row i at band cell b is kept less
//     (2 (i + 1) + b) * ext (exact: a multiple of S): E, the diagonal and
//     the deletion chain then each move by one uniform constant, so a
//     cell is E 1, the match bit 2 (shift, and), T 1 (after a
//     multiply-add), the chain 1 and H 1, each an add+max or a
//     three-input max of Hopper's DPX (__viaddmax_s32, __vimax3_s32).
//     Clip mode adds the fresh start (1) and each cell's running maximum
//     over the rows that may exit early (1), combined over the cells once,
//     after the last row.
//   - No load on a row's critical path: the block stages its windows and
//     reads in shared memory (16 or 4 bytes a thread, coalesced), then
//     builds six bit planes per window (bit c of word w of plane p: the
//     byte at column 32 w + c is p) by __ballot_sync. A row costs each
//     lane one byte load, NE + 1 word loads and NE funnel shifts for its
//     cells' match bits, loaded a row ahead. A read byte above 5, which
//     no read of the port holds, is compared with the window's bytes
//     instead; the row loop is compiled twice so that only a block whose
//     reads hold such a byte pays for the test (a test in the one loop
//     cost B1 ~17% on an H100). Per-candidate strides are padded against
//     bank conflicts.
//   - The last-row maximum, its first cell, the early exit and the
//     ungapped pass (rows split over the lanes) combine across the
//     group once, after the last row. The lanes of a warp step through
//     the rows together, to the longest read's last row.
//   - Plain mode takes two candidates a thread in 16-bit halves
//     (banded_dp16_kernel: the s16x2 forms of the same DPX instructions,
//     at the same issue rate, so a row costs about half) wherever
//     fits16 shows the values stay inside int16 (reads up to ~300 codes
//     at hw 16 with the default scores); the 32-bit body takes the rest
//     and clip mode, whose S = L + 2 hw + 1 does not fit.
//   - Band half-widths: kernels are compiled for hw 8, 16 and 32 (the
//     band's cells known to the compiler). Any other hw runs the body
//     compiled for HW' = 16 (hw 1-15), 32 (hw 17-31) or 271 (hw 33-271,
//     32 lanes of 17 cells) with hw a runtime value (the template's RT):
//     the band is the first W = 2 hw + 1 of the HW' cells, and the cells
//     above it run on as an extension of the band that nothing of the
//     band reads, as the cells past W already do in the compiled bodies.
//     Only cell W - 1's E reads a cell above the band, and it takes the
//     fill value, now at a band cell known at run time (a compare and
//     select per cell and row). Plain mode keeps the 16-bit pairs there
//     wherever fits16 holds at hw's S over the HW' cells.
//   - Long reads: where the block's kThreads / K candidates (pairs in
//     the 16-bit body) do not fit the 227 KB of shared memory a block
//     may hold, the RT body runs with K = 4 and fewer candidates a
//     block, halved at launch until they fit, the slots past them idle;
//     one candidate is the limit (kernels/banded_dp.py max_read_len
//     counts the same bytes: ~2.75 bytes a read base, ~80,000 bases).
//     The compiled bodies (hw = HW, a full block) take both at compile
//     time, so the runtime half-width costs the default paths nothing.
// What is left (PERF.md): the rows are issue-bound at 16 int32 lanes a
// clock per scheduler; each lane pays ~35 instructions a row for its
// match bits, shuffles and scan.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "urmap_kernels.h"

namespace {

constexpr int kNeg = -(1 << 20);
constexpr int kThreads = 64;  // threads per block
constexpr int kPlanes = 6;    // bit planes of window codes 0-5
constexpr int SEG = 8;        // band cells per segment of the F chain
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Shared memory of a block, per candidate: the bit planes, then the
// window bytes (the planes' reach, 32 * nwb columns), then the read
// bytes. Each per-candidate stride is padded so that the candidates of a
// warp fall in different banks: an odd number of words for the planes
// and the reads (read every row), 4 mod 8 words for the window (read in
// the ungapped pass only; its rows stay 16-byte aligned).
struct Smem {
  int nwb;  // words per plane: columns up to L + K * CPL, and one more
  int pw;   // plane words per candidate
  int ws;   // window bytes per candidate
  int rs;   // read bytes per candidate
  __host__ __device__ Smem(int L, int cells)
      : nwb((L + cells) / 32 + 2),
        pw((kPlanes * nwb) | 1),
        ws(32 * nwb + 16),
        rs((((L + 3) / 4) | 1) * 4) {}
  // Where the window bytes start, past the planes of gpb candidates:
  // 16-byte aligned for the 16-byte staging (a multiple of 64 already
  // for the 16 or 32 candidates of a full block; 1 or 2 candidates' odd
  // plane strides end on 4 or 8 bytes).
  __host__ __device__ int win_off(int gpb) const {
    return (gpb * 4 * pw + 15) & ~15;
  }
  __host__ __device__ size_t bytes(int gpb) const {
    return (size_t)win_off(gpb) + (size_t)gpb * (ws + rs);
  }
};

// Rows [first, first + gpb) of a uint8 [n, len] array into shared rows of
// `stride` bytes, `fill` past len and for rows past n. Every thread of
// the block takes part, neighbouring threads on neighbouring addresses,
// 16 or 4 bytes a thread where the rows allow it, else one, unrolled so
// that several loads are in flight.
template <int V>
__device__ __forceinline__ void stage_rows_by(uint8_t* dst, int stride,
                                              const uint8_t* src, int len,
                                              long long first, int n,
                                              int gpb, uint8_t fill) {
  using Vec = typename std::conditional<
      V == 16, uint4, typename std::conditional<V == 4, uint32_t,
                                                uint8_t>::type>::type;
  const int per = stride / V;
  // x / per as a multiply-high: exact for x < 2^32 / per
  const unsigned magic = 0xFFFFFFFFu / per + 1;
  Vec f;
  uint8_t* fb = (uint8_t*)&f;
#pragma unroll
  for (int j = 0; j < V; ++j) fb[j] = fill;
#pragma unroll 4
  for (int x = threadIdx.x; x < gpb * per; x += kThreads) {
    const int g = __umulhi(x, magic), col = V * (x - g * per);
    const long long t = first + g;
    ((Vec*)dst)[x] =
        t < n && col < len ? *(const Vec*)(src + t * len + col) : f;
  }
}

__device__ __forceinline__ void stage_rows(uint8_t* dst, int stride,
                                           const uint8_t* src, int len,
                                           long long first, int n, int gpb,
                                           uint8_t fill) {
  const uintptr_t a = (uintptr_t)src;
  if (len % 16 == 0 && stride % 16 == 0 && a % 16 == 0) {
    stage_rows_by<16>(dst, stride, src, len, first, n, gpb, fill);
  } else if (len % 4 == 0 && stride % 4 == 0 && a % 4 == 0) {
    stage_rows_by<4>(dst, stride, src, len, first, n, gpb, fill);
  } else {
    stage_rows_by<1>(dst, stride, src, len, first, n, gpb, fill);
  }
}

// Pre-gathered windows uint8[N, wlen]: column c of candidate t (0 past
// the window's end).
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
  __device__ __forceinline__ void stage(uint8_t* dst, int ws, long long first,
                                        int n, int gpb, int) const {
    stage_rows(dst, ws, win, wlen, first, n, gpb, 0);
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
  __device__ __forceinline__ void stage(uint8_t* dst, int ws, long long first,
                                        int n, int gpb, int hw) const {
    const unsigned magic = 0xFFFFFFFFu / ws + 1;  // x / ws, as above
#pragma unroll 8
    for (int x = threadIdx.x; x < gpb * ws; x += kThreads) {
      const int g = __umulhi(x, magic), col = x - g * ws;
      const long long t = first + g;
      dst[x] = t < n ? row(t, hw).at(col) : 0;
    }
  }
};

// Stages candidates [first, first + ncand) of the block: their windows
// (at win_all, past the planes) and reads into shared memory, then the
// windows' bit planes. Ends with
// a barrier, which returns whether a read byte of the block lies above 5.
template <class Win>
__device__ __forceinline__ bool stage_block(const Win& src,
                                            const uint8_t* reads, int n,
                                            int L, int hw, long long first,
                                            int ncand, const Smem& lay,
                                            uint32_t* smem,
                                            uint8_t* win_all) {
  const int nwb = lay.nwb, ws = lay.ws;
  uint8_t* read_all = win_all + ncand * ws;
  src.stage(win_all, ws, first, n, ncand, hw);
  stage_rows(read_all, lay.rs, reads, L, first, n, ncand, 5);
  __syncthreads();
  int big = 0;
  for (int x = threadIdx.x; x < ncand * lay.rs / 4; x += kThreads)
    big |= __vcmpgtu4(((const uint32_t*)read_all)[x], 0x05050505u);
  const int wl = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < ncand; g += kThreads / 32) {
    for (int w = 0; w < nwb; ++w) {
      const int v = win_all[g * ws + 32 * w + wl];
      uint32_t* pl = smem + g * lay.pw + w;
#pragma unroll
      for (int c = 0; c < kPlanes; ++c) {
        const unsigned m = __ballot_sync(kFull, v == c);
        if (wl == c) pl[c * nwb] = m;
      }
    }
  }
  return __syncthreads_or(big) != 0;
}

// Match bits of CPL band cells for read byte rd at row i: bit k of
// e[k / 32] is window[c0 + k] == rd, c0 = i + the lane's first cell.
// Codes 0-5 come from their bit planes; any other byte (only where ANY:
// the block holds one) from the staged window bytes, one by one.
template <int CPL, bool ANY, int NE>
__device__ __forceinline__ void match_bits(const uint32_t* planes, int nwb,
                                           const uint8_t* win_s, int c0,
                                           int rd, uint32_t (&e)[NE]) {
  if (!ANY || rd < kPlanes) {
    const uint32_t* pl = planes + rd * nwb + (c0 >> 5);
    const int sh = c0 & 31;
#pragma unroll
    for (int j = 0; j < NE; ++j) e[j] = __funnelshift_r(pl[j], pl[j + 1], sh);
  } else {
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      uint32_t m = 0;
#pragma unroll 1
      for (int k = 32 * j; k < CPL && k < 32 * j + 32; ++k)
        m |= (uint32_t)(win_s[c0 + k] == rd) << (k - 32 * j);
      e[j] = m;
    }
  }
}

// Outputs of B1 and B1', each int32[N].
struct Outs {
  int32_t* scores;
  int32_t* d0;
  int32_t* d1;  // B1': the span
  int32_t* ung;
};

// The group's result for candidate t once its rows are done. Each lane
// brings its first last-row maximum (lbest at band cell lbend) and, in
// clip mode, the group's early exit (else INT_MIN): the larger value
// wins, then the lower cell. With no last row among the rows that exist
// (length 0 or above L) the initial row stands, score 0 at the last
// band cell. Then the straight-diagonal score from the start cell b0c:
// read base i against the base at cand - hw + b0c + i = POS + i, rows
// split over the lanes; lane 0 writes.
template <int K, class Win>
__device__ __forceinline__ void finish(const Win& src, long long t, int n,
                                       int hw, int len, int rows, int L,
                                       int S,
                                       int lbest, int lbend, int early,
                                       const uint8_t* win_s, int ws,
                                       const uint8_t* read_s, int lane,
                                       int match, int mismatch,
                                       const Outs& out) {
  const int W = 2 * hw + 1;
#pragma unroll
  for (int d = K / 2; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(kFull, lbest, d, K);
    const int ob = __shfl_xor_sync(kFull, lbend, d, K);
    if (ov > lbest || (ov == lbest && ob < lbend)) {
      lbest = ov;
      lbend = ob;
    }
  }
  if (rows == 0 || len > L) {
    lbest = W - 1;
    lbend = W - 1;
  }
  const int best = max(lbest, early);
  const int sc = floordiv(best, S);
  const int b0c = best - sc * S;
  int u = 0;
  if (t < n && (Win::kByteGenome || b0c < W)) {
    const typename Win::Row w = src.row(t, hw);
#pragma unroll 4
    for (int i = lane; i < rows; i += K) {
      // past the staged columns only in B1's clip mode over the genome
      const int c = i + b0c;
      u += (c < ws ? win_s[c] : w.at(c)) == read_s[i] ? match : mismatch;
    }
  }
#pragma unroll
  for (int d = K / 2; d > 0; d >>= 1) u += __shfl_xor_sync(kFull, u, d, K);
  if (lane == 0 && t < n) {
    out.scores[t] = sc;
    out.d0[t] = b0c - hw;
    out.d1[t] = Win::kByteGenome ? len + lbend - b0c : lbend - hw;
    out.ung[t] = u;
  }
}

// RT: the half-width `hw_rt` at run time (1 <= hw <= HW; the band on
// the first W of the cells compiled for HW, see the header) and
// `gpb_rt` candidates a block, at most kThreads / K, the slots past them
// idle. Otherwise hw = HW and kThreads / K candidates, as compiled.
template <int HW, bool CLIP, int K, bool RT, class Win>
__global__ void __launch_bounds__(kThreads)
    banded_dp_kernel(const Win src, const uint8_t* __restrict__ reads,
                     const int32_t* __restrict__ lengths, const Outs out,
                     int n, int L, int hw_rt, int gpb_rt, int match,
                     int mismatch, int gap_open, int gap_extend,
                     int clip_open) {
  const int hw = RT ? hw_rt : HW;
  const int W = 2 * hw + 1;
  constexpr int CPL = (2 * HW + K) / K;  // band cells per lane
  constexpr int NE = (CPL + 31) / 32;    // match-bit words per lane
  const int gpb = RT ? gpb_rt : kThreads / K;  // candidates per block
  constexpr int LANE_LAST = 2 * HW / CPL;  // where cell 2 HW lives
  constexpr int K_LAST = 2 * HW % CPL;
  static_assert(K >= 2, "cell W - 1 takes its fill where the next lane's E "
                        "would come in");
  extern __shared__ uint32_t smem[];
  const Smem lay(L, K * CPL);
  const int nwb = lay.nwb;
  const int ws = lay.ws;
  const long long first = (long long)blockIdx.x * gpb;
  // the windows past the planes (a full block's planes end on 64 bytes)
  uint8_t* win_all = RT ? (uint8_t*)smem + lay.win_off(gpb)
                        : (uint8_t*)(smem + gpb * lay.pw);
  const bool big =
      stage_block(src, reads, n, L, hw, first, gpb, lay, smem, win_all);
  uint8_t* read_all = win_all + gpb * ws;

  const int g = threadIdx.x / K;
  const int lane = threadIdx.x % K;
  // an idle slot reads candidate 0's bytes and is past n: writes nothing
  const bool idle = RT && g >= gpb;
  const int gs = idle ? 0 : g;
  const long long t = idle ? (long long)n : first + g;
  const int b0 = lane * CPL;
  const int k_top = W - 1 - b0;  // RT: cell W - 1, if this lane holds it
  const uint32_t* planes = smem + gs * lay.pw;
  const uint8_t* win_s = win_all + gs * ws;
  const uint8_t* read_s = read_all + gs * lay.rs;
  const int len = t < n ? lengths[t] : 0;
  const int rows = len < 0 ? 0 : (len > L ? L : len);

  const int S = CLIP ? (L + 2 * hw + 1) : (W + 1);
  const int negp = kNeg * S;
  const int open_s = gap_open * S, ext_s = gap_extend * S;
  const int match_s = match * S, mis_s = mismatch * S;
  const int clip_s = clip_open * S;
  // Values computed in row i at band cell b are kept less
  // (2 (i + 1) + b) * ext_s (the row before row 0: less b * ext_s). Then
  // E, the diagonal and the deletion chain each move by one uniform
  // constant, and a cell costs one add+max for each.
  const int oe = open_s - ext_s;        // E from H; F from T
  const int mis_o = mis_s - 2 * ext_s;  // the diagonal
  const int diff = match_s - mis_s;
  const int ome = 1 - ext_s;            // a fresh start, per band cell
  // E's last cell reads the band's fill value through both terms
  const int e_last = max(negp + open_s, negp + ext_s);

  int H[CPL], E[CPL];
  int fr[CLIP ? CPL : 1], M[CLIP ? CPL : 1];  // clip: fresh starts, row maxima
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int b = b0 + k;
    H[k] = b * ome;  // score 0, start cell b
    E[k] = negp - b * ext_s;
    if (CLIP) {
      fr[k] = b * ome;
      M[k] = INT_MIN / 4;  // below every value, NEG * S included
    }
  }
  int lbest = INT_MIN, lbend = W;  // this lane's first last-row maximum
  const int warp_rows = __reduce_max_sync(kFull, rows);
  int fill = e_last - (W + 1) * ext_s;  // E's fill at cell W - 1, row 0
  int phi = negp + open_s - 2 * ext_s;  // F's NEG floor, row 0
  // The rows, with this lane's match bits loaded a row ahead. The loop
  // is compiled twice: the block takes the copy that compares bytes only
  // if one of its reads holds a byte above 5.
  auto run_rows = [&](auto any) {
    constexpr bool ANY = decltype(any)::value;
    uint32_t e_next[NE];
    match_bits<CPL, ANY>(planes, nwb, win_s, b0, read_s[0], e_next);
    for (int i = 0; i < warp_rows; ++i) {
      uint32_t e[NE];
#pragma unroll
      for (int j = 0; j < NE; ++j) e[j] = e_next[j];
      const int nx = min(i + 1, L - 1);
      match_bits<CPL, ANY>(planes, nwb, win_s, nx + b0, read_s[nx], e_next);

      if (CLIP && i > 0) {
        // a fresh start at row i: clip_s + b + i (row 0: the initial row)
        const int q = clip_s + i * (1 - 2 * ext_s);
#pragma unroll
        for (int k = 0; k < CPL; ++k) H[k] = __viaddmax_s32(fr[k], q, H[k]);
      }
      // E[b] = max(H[b + 1] + open, E[b + 1] + ext)
      const int y = __viaddmax_s32(H[0], oe, E[0]);
#pragma unroll
      for (int k = 0; k < CPL - 1; ++k)
        E[k] = __viaddmax_s32(H[k + 1], oe, E[k + 1]);
      E[CPL - 1] = __shfl_down_sync(kFull, y, 1, K);
      if (RT) {
#pragma unroll
        for (int k = 0; k < CPL; ++k)
          if (k == k_top) E[k] = fill;
      } else if (lane == LANE_LAST) {
        E[K_LAST] = fill;
      }
      // T = max(diag, E), kept in H (the diagonal was its last reader)
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int bit = (e[k >> 5] >> (k & 31)) & 1u;
        H[k] = __viaddmax_s32(H[k] + bit * diff, mis_o, E[k]);
      }
      // F[b] = max(NEG + open + b*ext, max_{c<b}(T[c] + open + (b-c-1)*ext)),
      // here max(phi, max_{c<b}(T[c] + oe)); H = max(T, F). P[k] is the
      // maximum of T + oe over cells up to k of k's segment (SEG cells, so
      // that the serial chains are short and run side by side); the lanes
      // below this one, and phi, come in by an exclusive max-scan.
      int P[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        P[k] = k % SEG == 0 ? H[k] + oe : __viaddmax_s32(H[k], oe, P[k - 1]);
      int total = P[CPL - 1];
#pragma unroll
      for (int k = SEG - 1; k < CPL - 1; k += SEG) total = max(total, P[k]);
      int run = __shfl_up_sync(kFull, total, 1, K);
      if (lane == 0) run = phi;
#pragma unroll
      for (int s = 1; s < K; s <<= 1)
        run = max(run, __shfl_up_sync(kFull, run, s, K));
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        if (k % SEG == 0) {
          if (k > 0) run = max(run, P[k - 1]);
          H[k] = max(H[k], run);
        } else {
          H[k] = __vimax3_s32(H[k], run, P[k - 1]);
        }
      }
      if (CLIP && i + 1 < len) {
        // each cell's maximum over the rows that may exit early, less b*ext
        const int rc = 2 * (i + 1) * ext_s;
#pragma unroll
        for (int k = 0; k < CPL; ++k) M[k] = __viaddmax_s32(H[k], rc, M[k]);
      }
      if (i + 1 == rows) {  // the last row: this lane's first maximum
        const int base = (2 * rows + b0) * ext_s;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int h = H[k] + base + k * ext_s;
          if (b0 + k < W && h > lbest) {
            lbest = h;
            lbend = b0 + k;
          }
        }
      }
      fill -= 2 * ext_s;
      phi -= 2 * ext_s;
    }
  };
  if (big) {
    run_rows(std::true_type{});
  } else {
    run_rows(std::false_type{});
  }
  // the early exit: the best row maximum over the group's band cells,
  // plus clip_open (NEG * S is its floor, and the floor's own exit where
  // a row may exit early at all); none in plain mode
  int early = INT_MIN;
  if (CLIP) {
    early = negp;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (b0 + k < W) early = max(early, M[k] + (b0 + k) * ext_s + clip_s);
    }
    if (rows >= 1 && len >= 2) early = max(early, negp + clip_s);
#pragma unroll
    for (int d = K / 2; d > 0; d >>= 1)
      early = max(early, __shfl_xor_sync(kFull, early, d, K));
  }
  finish<K>(src, t, n, hw, len, rows, L, S, lbest, lbend, early, win_s, ws,
            read_s, lane, match, mismatch, out);
}

// ---- plain mode in 16-bit pairs ----------------------------------------
//
// Two candidates a thread: candidate first + g in the low halves of each
// value, first + gpb + g in the high halves, and every cell update is the
// s16x2 form of the same DPX instruction (same issue rate, two cells).
// Exact where fits16 below holds: every value that derives from the
// initial row stays inside int16 at its row-and-column offset, and the
// packed substitution cannot carry from the low half into the high one.
// The NEG fill becomes -32768 per half. That is exact because no fill
// value is ever added to (E's chain, the chain's floor and cell W - 1's
// E take part in maxima only) and every maximum that reaches an output
// holds a value from the initial row (H >= T >= the diagonal), which in
// both widths lies above every fill value.

__device__ __forceinline__ uint32_t pk(int x) {
  return ((uint32_t)x & 0xFFFFu) | ((uint32_t)x << 16);
}

constexpr uint32_t kNeg2 = 0x80008000u;  // -32768 in both halves

// Both candidates' match bits for read bytes r0 (low) and r1 (high),
// packed: bit k of c[j] is cell 16 j + k of the low candidate, bit
// 16 + k the same cell of the high one.
template <int CPL, bool ANY, int NC>
__device__ __forceinline__ void pair_match_bits(
    const uint32_t* const (&planes)[2], int nwb,
    const uint8_t* const (&win_s)[2], int c0, int r0, int r1,
    uint32_t (&c)[NC]) {
  constexpr int NE = (CPL + 31) / 32;
  uint32_t e[2][NE];
  match_bits<CPL, ANY>(planes[0], nwb, win_s[0], c0, r0, e[0]);
  match_bits<CPL, ANY>(planes[1], nwb, win_s[1], c0, r1, e[1]);
#pragma unroll
  for (int j = 0; j < NC; ++j)
    c[j] = __byte_perm(e[0][j / 2], e[1][j / 2], j % 2 ? 0x7632 : 0x5410);
}

// RT: the half-width `hw_rt` at run time, 1 <= hw <= HW, as in
// banded_dp_kernel; a block always stages kThreads / K pairs.
template <int HW, int K, bool RT, class Win>
__global__ void __launch_bounds__(kThreads)
    banded_dp16_kernel(const Win src, const uint8_t* __restrict__ reads,
                       const int32_t* __restrict__ lengths, const Outs out,
                       int n, int L, int match, int mismatch, int gap_open,
                       int gap_extend, int hw_rt) {
  // hw_rt last: an int before `match` splits the 8-byte loads of the
  // parameter pairs and changes the compiled bodies' code
  const int hw = RT ? hw_rt : HW;
  const int W = 2 * hw + 1;
  constexpr int CPL = (2 * HW + K) / K;
  constexpr int NC = (CPL + 15) / 16;  // packed match-bit words
  constexpr int GPB = kThreads / K;    // candidate pairs per block
  constexpr int LANE_LAST = 2 * HW / CPL;
  constexpr int K_LAST = 2 * HW % CPL;
  static_assert(K >= 2, "cell W - 1 takes its fill where the next lane's E "
                        "would come in");
  extern __shared__ uint32_t smem[];
  const Smem lay(L, K * CPL);
  const int nwb = lay.nwb, ws = lay.ws;
  const long long first = (long long)blockIdx.x * (2 * GPB);
  const bool big =
      stage_block(src, reads, n, L, hw, first, 2 * GPB, lay, smem,
                  (uint8_t*)(smem + 2 * GPB * lay.pw));
  const uint8_t* win_all = (const uint8_t*)(smem + 2 * GPB * lay.pw);
  const uint8_t* read_all = win_all + 2 * GPB * ws;

  const int g = threadIdx.x / K;
  const int lane = threadIdx.x % K;
  const int b0 = lane * CPL;
  const int k_top = W - 1 - b0;  // RT: cell W - 1, if this lane holds it
  long long t[2];
  int len[2], rows[2];
  const uint32_t* planes[2];
  const uint8_t* win_s[2];
  const uint8_t* read_s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = g + h * GPB;
    t[h] = first + c;
    planes[h] = smem + c * lay.pw;
    win_s[h] = win_all + c * ws;
    read_s[h] = read_all + c * lay.rs;
    len[h] = t[h] < n ? lengths[t[h]] : 0;
    rows[h] = len[h] < 0 ? 0 : (len[h] > L ? L : len[h]);
  }

  const int S = W + 1;
  const int open_s = gap_open * S, ext_s = gap_extend * S;
  const int match_s = match * S, mis_s = mismatch * S;
  const uint32_t oe2 = pk(open_s - ext_s);
  const uint32_t mis2 = pk(mis_s - 2 * ext_s);
  const uint32_t diff = (uint32_t)(match_s - mis_s);
  const int ome = 1 - ext_s;

  uint32_t H[CPL], E[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    H[k] = pk((b0 + k) * ome);  // score 0, start cell b
    E[k] = kNeg2;
  }
  int lbest[2] = {INT_MIN, INT_MIN}, lbend[2] = {W, W};
  const int warp_rows = __reduce_max_sync(kFull, max(rows[0], rows[1]));
  // the rows, compiled twice as in banded_dp_kernel
  auto run_rows = [&](auto any) {
    constexpr bool ANY = decltype(any)::value;
    auto pair_bits = [&](int i, uint32_t(&c)[NC]) {
      pair_match_bits<CPL, ANY>(planes, nwb, win_s, i + b0, read_s[0][i],
                                read_s[1][i], c);
    };
    uint32_t c_next[NC];
    pair_bits(0, c_next);
    for (int i = 0; i < warp_rows; ++i) {
      uint32_t c[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) c[j] = c_next[j];
      pair_bits(min(i + 1, L - 1), c_next);

      const uint32_t y = __viaddmax_s16x2(H[0], oe2, E[0]);
#pragma unroll
      for (int k = 0; k < CPL - 1; ++k)
        E[k] = __viaddmax_s16x2(H[k + 1], oe2, E[k + 1]);
      E[CPL - 1] = __shfl_down_sync(kFull, y, 1, K);
      if (RT) {
#pragma unroll
        for (int k = 0; k < CPL; ++k)
          if (k == k_top) E[k] = kNeg2;
      } else if (lane == LANE_LAST) {
        E[K_LAST] = kNeg2;
      }
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const uint32_t sel =
            ((c[k >> 4] >> (k & 15)) & 0x00010001u) * diff + mis2;
        H[k] = __viaddmax_s16x2(H[k], sel, E[k]);
      }
      uint32_t P[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        P[k] = __viaddmax_s16x2(H[k], oe2, k % SEG == 0 ? kNeg2 : P[k - 1]);
      uint32_t total = P[CPL - 1];
#pragma unroll
      for (int k = SEG - 1; k < CPL - 1; k += SEG)
        total = __vmaxs2(total, P[k]);
      uint32_t run = __shfl_up_sync(kFull, total, 1, K);
      if (lane == 0) run = kNeg2;
#pragma unroll
      for (int s = 1; s < K; s <<= 1)
        run = __vmaxs2(run, __shfl_up_sync(kFull, run, s, K));
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        if (k % SEG == 0) {
          if (k > 0) run = __vmaxs2(run, P[k - 1]);
          H[k] = __vmaxs2(H[k], run);
        } else {
          H[k] = __vimax3_s16x2(H[k], run, P[k - 1]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (i + 1 == rows[h]) {  // the last row: this lane's first maximum
          const int base = (2 * rows[h] + b0) * ext_s;
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            const int v = h ? (int)H[k] >> 16 : (int)(int16_t)(H[k] & 0xFFFFu);
            const int hv = v + base + k * ext_s;
            if (b0 + k < W && hv > lbest[h]) {
              lbest[h] = hv;
              lbend[h] = b0 + k;
            }
          }
        }
      }
    }
  };
  if (big) {
    run_rows(std::true_type{});
  } else {
    run_rows(std::false_type{});
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
    finish<K>(src, t[h], n, hw, len[h], rows[h], L, S, lbest[h], lbend[h],
              INT_MIN, win_s[h], ws, read_s[h], lane, match, mismatch, out);
}

// Whether banded_dp16_kernel is exact for these reads and scores: the
// substitution's packed add carries no bit between the halves, and the
// values that derive from the initial row, at their row-and-column
// offsets, stay inside int16. From row i a cell holds at most
// i * match * S + S and at least i * mismatch * S (its straight
// diagonal), E, T and P that less open - ext and plus match, and the
// offsets add up to (2 L + cells) * |ext| * S.
bool fits16(int L, int hw, int cells, int match, int mismatch, int gap_open,
            int gap_extend) {
  const long long S = 2 * hw + 2;
  if (!(match > mismatch && match >= 0 && mismatch <= 0 && gap_open <= 0 &&
        gap_extend < 0))
    return false;
  const long long mis_o = (mismatch - 2LL * gap_extend) * S;
  const long long match_o = (match - 2LL * gap_extend) * S;
  if ((mis_o < 0) != (match_o < 0)) return false;  // the low half carries
  const long long ext = -gap_extend * S, open = -gap_open * S;
  const long long lo = -((L + 2LL) * -mismatch * S + 2 * open + ext);
  const long long hi = (L + 2LL) * match * S + S + open +
                       (2LL * L + cells + 2) * ext;
  return lo > -32768 && hi < 32767;
}

constexpr int kMaxSmem = 227 * 1024;  // an H100 block's most

// Candidates a block stages: `most`, halved until their shared memory
// fits; 0 if one does not.
int fit_block(const Smem& lay, int most) {
  for (int g = most; g >= 1; g >>= 1)
    if (lay.bytes(g) <= (size_t)kMaxSmem) return g;
  return 0;
}

template <class Kernel>
int opt_in(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;  // a long read: above the default
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HW, bool CLIP, int K, bool RT, class Win>
int launch_one(cudaStream_t s, const Win& src, const uint8_t* reads,
               const int32_t* lengths, const Outs& out, int n, int L, int hw,
               int gpb, int match, int mismatch, int gap_open,
               int gap_extend, int clip_open) {
  constexpr int CPL = (2 * HW + K) / K;
  const size_t bytes = Smem(L, K * CPL).bytes(gpb);
  auto kern = banded_dp_kernel<HW, CLIP, K, RT, Win>;
  const int err = opt_in(kern, bytes);
  if (err) return err;
  const unsigned grid = (unsigned)((n + gpb - 1) / gpb);
  kern<<<grid, kThreads, bytes, s>>>(src, reads, lengths, out, n, L, hw, gpb,
                                     match, mismatch, gap_open, gap_extend,
                                     clip_open);
  return (int)cudaGetLastError();
}

// The 16-bit body, if fits16 holds at hw over the HW cells and a full
// block of pairs fits; else it launches nothing and `launched` is false
// (the caller takes the 32-bit body).
template <int HW, int K, bool RT, class Win>
int launch16(cudaStream_t s, const Win& src, const uint8_t* reads,
             const int32_t* lengths, const Outs& out, int n, int L, int hw,
             int match, int mismatch, int gap_open, int gap_extend,
             bool& launched) {
  constexpr int CPL = (2 * HW + K) / K;
  constexpr int PAIRS = 2 * (kThreads / K);  // candidates per block
  launched = false;
  const size_t bytes = Smem(L, K * CPL).bytes(PAIRS);
  if (bytes > (size_t)kMaxSmem ||
      !fits16(L, hw, K * CPL, match, mismatch, gap_open, gap_extend))
    return 0;
  auto kern = banded_dp16_kernel<HW, K, RT, Win>;
  const int err = opt_in(kern, bytes);
  if (err) return err;
  const unsigned grid = (unsigned)((n + PAIRS - 1) / PAIRS);
  kern<<<grid, kThreads, bytes, s>>>(src, reads, lengths, out, n, L, match,
                                     mismatch, gap_open, gap_extend, hw);
  launched = true;
  return (int)cudaGetLastError();
}

// Plain mode in 16-bit pairs where they fit, else the 32-bit body; clip
// mode in 32 bits. RT: hw at run time and the candidates a block fitted
// to shared memory (none fits: cudaErrorInvalidValue).
template <int HW, int K, bool RT, class Win>
int launch_mode(bool clip, cudaStream_t s, const Win& src,
                const uint8_t* reads, const int32_t* lengths,
                const Outs& out, int n, int L, int hw, int match,
                int mismatch, int gap_open, int gap_extend, int clip_open) {
  if constexpr (HW <= 32) {  // no 16-bit body above
    if (!clip) {
      bool launched = false;
      const int err = launch16<HW, K, RT>(s, src, reads, lengths, out, n, L,
                                          hw, match, mismatch, gap_open,
                                          gap_extend, launched);
      if (err || launched) return err;
    }
  }
  constexpr int CPL = (2 * HW + K) / K;
  const int gpb = RT ? fit_block(Smem(L, K * CPL), kThreads / K)
                     : kThreads / K;
  if (gpb == 0) return (int)cudaErrorInvalidValue;
  return clip ? launch_one<HW, true, K, RT>(s, src, reads, lengths, out, n, L,
                                            hw, gpb, match, mismatch,
                                            gap_open, gap_extend, clip_open)
              : launch_one<HW, false, K, RT>(s, src, reads, lengths, out, n,
                                             L, hw, gpb, match, mismatch,
                                             gap_open, gap_extend, clip_open);
}

// Lanes per candidate (see the header): B1 the fewest that put
// kFullThreads threads on the card, ~4 warps for each of the H100's 528
// schedulers; B1' always 4.
constexpr long long kFullThreads = 1 << 16;

template <int HW, class Win>
int launch_lanes(bool clip, cudaStream_t s, const Win& src,
                 const uint8_t* r, const int32_t* ln, const Outs& out, int n,
                 int L, int match, int mismatch, int gap_open, int gap_extend,
                 int clip_open) {
  if constexpr (!Win::kByteGenome) {
    if (2LL * n >= kFullThreads)
      return launch_mode<HW, 2, false>(clip, s, src, r, ln, out, n, L, HW,
                                       match, mismatch, gap_open, gap_extend,
                                       clip_open);
  }
  return launch_mode<HW, 4, false>(clip, s, src, r, ln, out, n, L, HW, match,
                                   mismatch, gap_open, gap_extend, clip_open);
}

// Whether a full block of the compiled 32-bit body (kThreads / K
// candidates, K as launch_lanes picks it) fits shared memory.
template <int HW>
bool full_block_fits(bool byte_genome, int n, int L) {
  const int K = !byte_genome && 2LL * n >= kFullThreads ? 2 : 4;
  const int CPL = (2 * HW + K) / K;
  return Smem(L, K * CPL).bytes(kThreads / K) <= (size_t)kMaxSmem;
}

// Compiled half-widths 8, 16 and 32 where a full block fits; every other
// hw from 1 to 271, and long reads, on the RT body of HW' = 16, 32 or
// 271 (27 compiled kernels and 16 RT ones, B1 and B1' together).
template <class Win>
int dispatch(const Win& src, const void* reads, const void* lengths,
             void* scores, void* d0, void* d1, void* ung, int n, int L,
             int hw, int match, int mismatch, int gap_open, int gap_extend,
             int clip, int clip_open, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* r = (const uint8_t*)reads;
  const auto* ln = (const int32_t*)lengths;
  const Outs out{(int32_t*)scores, (int32_t*)d0, (int32_t*)d1,
                 (int32_t*)ung};
  const bool c = clip != 0;
  const bool bg = Win::kByteGenome;
  if (hw == 8 && full_block_fits<8>(bg, n, L))
    return launch_lanes<8>(c, s, src, r, ln, out, n, L, match, mismatch,
                           gap_open, gap_extend, clip_open);
  if (hw == 16 && full_block_fits<16>(bg, n, L))
    return launch_lanes<16>(c, s, src, r, ln, out, n, L, match, mismatch,
                            gap_open, gap_extend, clip_open);
  if (hw == 32 && full_block_fits<32>(bg, n, L))
    return launch_lanes<32>(c, s, src, r, ln, out, n, L, match, mismatch,
                            gap_open, gap_extend, clip_open);
  if (hw < 1) return (int)cudaErrorInvalidValue;
  if (hw <= 16)
    return launch_mode<16, 4, true>(c, s, src, r, ln, out, n, L, hw, match,
                                    mismatch, gap_open, gap_extend,
                                    clip_open);
  if (hw <= 32)
    return launch_mode<32, 4, true>(c, s, src, r, ln, out, n, L, hw, match,
                                    mismatch, gap_open, gap_extend,
                                    clip_open);
  if (hw <= 271)
    return launch_mode<271, 32, true>(c, s, src, r, ln, out, n, L, hw, match,
                                      mismatch, gap_open, gap_extend,
                                      clip_open);
  return (int)cudaErrorInvalidValue;
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
