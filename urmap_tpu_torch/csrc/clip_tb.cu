// The clip traceback: the clip-mode traceback of the clip-rescued gapped
// winners, over the host's whole window.
//
// Replaces no TPU kernel: the reference runs this DP on the host
// (urmap_tpu/io/native/codecs.cpp urmap_traceback_batch with use_clip = 1,
// called from map/cigar.py cigars_nm_blob for the clip-rescued rows). The
// card runs it and walks it, and the host replays one record a read row
// (io/native/replay.cpp). Plain version and semantics: map/clip_tb.py,
// bit-equal on every output. Per winner: windows[N, L + 48] (the genome
// from POS, genome N = 4), reads[N, L] (strand applied, read N = 5),
// lengths[N], widths[N] (the window's real width, clamped at the genome's
// end). The full (len + 1) x (width + 1) rectangle, no band: H[0, 0] = 0;
// after each row 1..len-1 column 0 is raised to clip_open (the start clip);
// the end is the first maximum of row len, or an end clip after an earlier
// row if its score plus clip_open is strictly above it; every cell gets a
// 4-bit code in the host walk's tie order (hc: diagonal, E, F; at column 0
// the start-clip entry, E, none; ee; fe), and the walk emits rec_i =
// d | I << 6 | S << 7 per read row, four a word, [DWP, N].
//
// What bounds it on the card: integer ALU work. A winner at L = 150 is
// 150 x 199 cells of ~16 int32 instructions (E and ee 2, the substitution
// 2, T 1, the deletion chain's running maximum and F 2, H 1, hc 4, fe 1,
// the nibble 2, the end-clip scan 1), ~0.48 M instructions, against 348
// bytes in and 152 bytes of records out. The deletion chain serialises
// along a row; the host runs it column by column, ~105 us a winner on one
// CPU thread.
//
// Design: one warp a winner, one winner a block. The row's columns are cut
// into strips of kCols = 8 neighbouring columns, lane l holding columns
// 8l .. 8l + 7 (256 columns, so L + 49 <= 256: reads up to 207 bases), its
// cells of the row above in registers.
//   - per row, H of the column left of the strip (row above) comes from
//     the previous lane by __shfl_up_sync; E is the lane's own column;
//   - F[j] = max_{k<j}(T[k] - (k+1) ext) + open + j ext: a running maximum
//     over the lane's strip, then a prefix maximum over the lanes in five
//     steps of __shfl_up_sync (the form map/cigar.py traceback uses);
//   - the codes of a row are one 32-bit word a lane (8 nibbles), stored to
//     shared memory, [L][32] words: 19.2 KB at L = 150, so ~11 winners an
//     SM;
//   - the end-clip scan and the last row's maximum are kept per lane in
//     registers as the rows pass, then reduced over the warp by shuffles
//     (value, then row, then column);
//   - lane 0 walks the codes back from the end, one shared-memory word a
//     step, writing the records to shared memory; the warp writes them out.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "urmap_kernels.h"

namespace {

constexpr int kNeg = -(1 << 28);     // the host DP's fill
constexpr int kLow = -(1 << 30);     // below every score
constexpr int kPad = 48;             // window bases past the read
constexpr int kCols = 8;             // columns a lane
constexpr int kSpan = 32 * kCols;    // columns a winner
constexpr int kMaxDel = 63;          // a record's deletion run
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32)
clip_tb_kernel(const uint8_t* __restrict__ win,
               const uint8_t* __restrict__ reads,
               const int32_t* __restrict__ lengths,
               const int32_t* __restrict__ widths,
               int32_t* __restrict__ score_out, uint8_t* __restrict__ ok_out,
               uint32_t* __restrict__ recs, int n, int L, int dwp, int match,
               int mismatch, int gap_open, int gap_ext, int clip_open) {
  extern __shared__ uint32_t smem[];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int WL = L + kPad;
  const int DW = (L + 3) >> 2;
  uint32_t* codes = smem;                               // [L][32] words
  uint8_t* rd = reinterpret_cast<uint8_t*>(smem + 32 * L);
  uint8_t* rec = rd + 4 * DW;                           // 4 * DW bytes
  const int len = lengths[t];
  const int wid = min(widths[t], WL);
  if (len < 1 || len > L || wid < 1) {
    for (int w = lane; w < dwp; w += 32) recs[(size_t)w * n + t] = 0u;
    if (lane == 0) {
      score_out[t] = 0;
      ok_out[t] = 0;
    }
    return;
  }
  for (int i = lane; i < L; i += 32) rd[i] = reads[(size_t)t * L + i];
  const int j0 = lane * kCols;
  uint8_t g[kCols];
  int Hp[kCols], Ep[kCols];
#pragma unroll
  for (int s = 0; s < kCols; ++s) {
    const int j = j0 + s;
    // column j compares window byte j - 1; past the window a byte that
    // equals no read code (those columns are never read)
    g[s] = (j >= 1 && j <= WL) ? win[(size_t)t * WL + j - 1] : 0xFF;
    Hp[s] = j == 0 ? 0 : kNeg;
    Ep[s] = kNeg;
  }
  __syncwarp();

  int lv = kLow, lj = INT_MAX;                  // row len: first maximum
  int bv = kLow, bi = INT_MAX, bj = INT_MAX;    // the end-clip scan
  for (int ii = 1; ii <= len; ++ii) {
    const int r = rd[ii - 1];
    const int hl = __shfl_up_sync(kFull, Hp[kCols - 1], 1);
    int E[kCols], D[kCols], T[kCols], P[kCols];
    uint32_t ee = 0;
    int run = kLow;
#pragma unroll
    for (int s = 0; s < kCols; ++s) {
      const int j = j0 + s;
      const int eo = Hp[s] + gap_open;
      E[s] = max(eo, Ep[s] + gap_ext);
      ee |= (uint32_t)(eo != E[s]) << s;
      D[s] = (s == 0 ? hl : Hp[s - 1]) + (g[s] == r ? match : mismatch);
      T[s] = j == 0 ? E[s] : max(D[s], E[s]);
      run = max(run, T[s] - (j + 1) * gap_ext);
      P[s] = run;
    }
    int x = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x = max(x, y);
    }
    int ex = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) ex = kLow;
    int H[kCols], F[kCols];
#pragma unroll
    for (int s = 0; s < kCols; ++s) {
      const int j = j0 + s;
      const int excl = s == 0 ? ex : max(ex, P[s - 1]);
      F[s] = j == 0 ? kNeg : excl + gap_open + j * gap_ext;
      H[s] = j == 0 ? E[s] : max(T[s], F[s]);
    }
    // column 0: the start-clip state after rows 1..len-1
    const bool inject = ii <= len - 1;
    if (lane == 0 && inject && H[0] < clip_open) H[0] = clip_open;
    const int hlp = __shfl_up_sync(kFull, H[kCols - 1], 1);
    uint32_t code = 0;
#pragma unroll
    for (int s = 0; s < kCols; ++s) {
      const int j = j0 + s;
      uint32_t hc, fe = 0;
      if (j == 0) {
        hc = (inject && H[0] == clip_open) ? 0u : (H[0] == E[0] ? 1u : 3u);
      } else {
        hc = H[s] == D[s] ? 0u : (H[s] == E[s] ? 1u : 2u);
        fe = F[s] != (s == 0 ? hlp : H[s - 1]) + gap_open;
      }
      code |= (hc | (((ee >> s) & 1u) << 2) | (fe << 3)) << (4 * s);
      if (inject && j >= 1 && j <= wid && H[s] > bv) {
        bv = H[s];
        bi = ii;
        bj = j;
      }
      if (ii == len && j <= wid && H[s] > lv) {
        lv = H[s];
        lj = j;
      }
      Hp[s] = H[s];
      Ep[s] = E[s];
    }
    codes[(ii - 1) * 32 + lane] = code;
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, lv, off);
    const int oj = __shfl_xor_sync(kFull, lj, off);
    if (ov > lv || (ov == lv && oj < lj)) {
      lv = ov;
      lj = oj;
    }
    const int cv = __shfl_xor_sync(kFull, bv, off);
    const int ci = __shfl_xor_sync(kFull, bi, off);
    const int cj = __shfl_xor_sync(kFull, bj, off);
    if (cv > bv || (cv == bv && (ci < bi || (ci == bi && cj < bj)))) {
      bv = cv;
      bi = ci;
      bj = cj;
    }
  }
  const bool end_clip = bv > kLow && bv + clip_open > lv;
  const int score = end_clip ? bv + clip_open : lv;
  const int iend = end_clip ? bi : len;
  const int jend = end_clip ? bj : lj;
  for (int i = lane; i < 4 * DW; i += 32)
    rec[i] = (i >= iend && i < len) ? 0x80 : 0;
  __syncwarp();

  // the host's walk, in its tie order
  __shared__ int fail_s;
  if (lane == 0) {
    int ii = iend, j = jend, st = 0, dc = 0;
    bool fail = false;
    while (ii > 0 || j > 0) {
      if (ii == 0) {
        fail = true;
        break;
      }
      const uint32_t c =
          (codes[(ii - 1) * 32 + (j >> 3)] >> (4 * (j & 7))) & 0xFu;
      if (st == 0) {
        const uint32_t hc = c & 3u;
        if (hc == 0u) {
          if (dc > kMaxDel) {
            fail = true;
            break;
          }
          if (j == 0) {        // the start-clip entry: rows [0, ii) are S
            rec[ii - 1] = (uint8_t)(0x80 | dc);
            for (int a = 0; a < ii - 1; ++a) rec[a] = 0x80;
            break;
          }
          rec[ii - 1] = (uint8_t)dc;
          dc = 0;
          --ii;
          --j;
        } else if (hc == 1u) {
          st = 1;
        } else if (hc == 2u && j > 0) {
          st = 2;
        } else {
          fail = true;
          break;
        }
      } else if (st == 1) {
        if (dc > kMaxDel) {
          fail = true;
          break;
        }
        rec[ii - 1] = (uint8_t)(0x40 | dc);
        dc = 0;
        if (!((c >> 2) & 1u)) st = 0;
        --ii;
      } else {
        if (j == 0) {
          fail = true;
          break;
        }
        ++dc;
        if (!((c >> 3) & 1u)) st = 0;
        --j;
      }
    }
    fail_s = fail;
    score_out[t] = score;
    ok_out[t] = fail ? 0 : 1;
  }
  __syncwarp();
  const bool fail = fail_s;
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(rec);
  for (int w = lane; w < dwp; w += 32)
    recs[(size_t)w * n + t] = (fail || w >= DW) ? 0u : rw[w];
}

}  // namespace

// ok as bytes 0/1. L 1-207 and gap_open <= gap_extend (the binding
// checks); cudaErrorInvalidValue outside them.
extern "C" int urmap_clip_tb(const void* win, const void* reads,
                             const void* lengths, const void* widths,
                             void* score, void* ok, void* recs, int n, int L,
                             int match, int mismatch, int gap_open,
                             int gap_extend, int clip_open, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (L < 1 || L + kPad + 1 > kSpan || gap_open > gap_extend)
    return (int)cudaErrorInvalidValue;
  const int dw = (L + 3) >> 2;
  const int dwp = (dw + 7) / 8 * 8;
  const size_t bytes = 4 * (size_t)(32 * L + 2 * dw);
  clip_tb_kernel<<<(unsigned)n, 32, bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)win, (const uint8_t*)reads, (const int32_t*)lengths,
      (const int32_t*)widths, (int32_t*)score, (uint8_t*)ok,
      (uint32_t*)recs, n, L, dwp, match, mismatch, gap_open, gap_extend,
      clip_open);
  return (int)cudaGetLastError();
}
