// Kernels B6 and B7: the traceback DP of the gapped winners.
//
// Replaces urmap_tpu/kernels/tb_dp.py:tb_dops_from_windows_pallas (B6,
// body _make_dops_kernel) and tb_from_windows_pallas (B7, body
// _make_tb_kernel). For each winner: windows[N, L + 2*hw] (genome from
// pos - hw, genome N = 4), reads[N, L] (strand-applied, read N = 5),
// lengths[N]. The banded affine DP runs with the start FORCED at the band
// centre (H0 = 0 at b == hw, NEG elsewhere) on plain int32 scores, and
// every cell gets a 4-bit code: hc (0 diag, 1 E, 2 F; diag > E > F on
// ties), ee << 2 and fe << 3 (the gap is extended only where extending
// strictly beats opening). Codes of unreachable cells come from the same
// additions on NEG as the reference's, with no saturation.
//
// Both kernels share one forward pass (`forward` below); they differ in
// what they keep of it:
//   - B6 (tb_dops_kernel) keeps the codes in shared memory and walks them
//     backwards from (lengths - 1, bend), bend the first band cell holding
//     the maximum of row lengths - 1, emitting one record per read row,
//     rec_i = d | op << 6 (op 1 = insertion, d = deletions after row i),
//     rec_i at byte i % 4 of word i / 4 of dops[DWP, N], and walk_ok = the
//     walk ended at b == hw in state H and lengths > 0. Cells outside the
//     band read as code 0, as the reference's one-hot selects give. It
//     runs the rows below the read's length only, since the walk reads no
//     later row. A length above L has no last row: score 0, and the walk
//     starts at band cell 0 with every row live, as the reference's does.
//     hw <= 31: a record holds the deletion run in 6 bits (d <= 2 hw).
//   - B7 (tb_bits_kernel) writes the codes out, int32 [NWORDS, N]: 8 read
//     rows per word, row i of group g at nibble hi - 1 - i (hi =
//     min(8g + 8, L)); band cell b of group g is row g * WP + b (WP = W
//     rounded up to 8, pad rows zero). It runs all L rows whatever the
//     length and gives score and bend. The mapping path never calls it.
//
// What bounds them on the card: integer ALU work, ~15 instructions on the
// int32 pipe per band cell and read row (E and the ee compare 2; the
// substitution 2; T 1; the running max and H 2; the fe compare 1; hc 4;
// the nibble 3) over 33 x 160 cells, against 356 bytes in and 160 bytes of
// records out per winner. But a batch has 2,048 winners (128 at the
// least), and with one thread per winner that is 64 warps on a card of 528
// warp schedulers, each thread a chain of ~100k dependent instructions:
// latency, not throughput, with seven of eight schedulers idle. So the
// design spreads ONE winner over a group of G lanes of a warp, the band
// across the lanes, CPL neighbouring cells per lane. G = 8 (5 cells a
// lane at W = 33, four winners a warp): a row costs ~65 instructions a
// lane and ~25 more a cell, so fewer lanes mean fewer instructions per
// winner. Measured on an H100 against 16 and 32 lanes, 8 tied within 5%
// at 128 and 2,048 winners and won at 16,384 (0.238 ms against 0.274 and
// 0.366).
//   - per read row, H and E of cell b + 1 come from the next lane by
//     __shfl_down_sync; the deletion chain, which serialises along the
//     band, is the running maximum max_{c<b}(T[c] - (c + 1) * ext): a
//     serial maximum over the lane's own cells and a prefix maximum over
//     the lanes in log2(G) steps of __shfl_up_sync; H of cell b - 1 (for
//     the fe bit) comes from the previous lane;
//   - the shuffles name the whole warp and move within segments of G
//     lanes, and the winners of a warp step through the rows together,
//     to the longest one's last row;
//   - window and read bytes are loaded once by the group, neighbouring
//     lanes neighbouring bytes, into shared memory;
//   - B6: the per-cell codes (8 rows per word as in B7's layout, word
//     g * G * CPL + b for band cell b) stay in shared memory, ~3-5 KB per
//     winner; lane 0 of the group walks back through them, keeping the
//     word of its band cell in a register while the path stays on the
//     diagonal; a group of 8 rows whose codes on the path are all
//     diagonal is taken in one step (most of a read: the walk of a clean
//     read is 20 steps, not 160); the records are gathered in shared
//     memory and written by the whole block, the winners of a block side
//     by side along N;
//   - B7: each lane stores its cells' words of a group of 8 rows as the
//     group ends; no codes in shared memory.
// Band half-widths. A variant is compiled for a capacity of G * CPL band
// cells. At hw 8 and 16 (HWC, the band's cells known to the compiler) the
// cells past the band's end are computed and never read: only cell W - 1
// looks at a higher cell, and takes NEG there. Any other hw runs on the
// smallest variant that holds W = 2 hw + 1 cells with hw a runtime value:
// the band is cells 0 .. W - 1 and every cell above it is set back to NEG
// (H and E) after each row, so cell W - 1 reads exactly the reference's
// NEG fill, and the chain, which only moves up the band, carries nothing
// down into it. Capacities: 24 cells (hw <= 11), 40 (<= 19), 72 (<= 35)
// at 8 lanes; B7 also 544 at 32 lanes (hw <= 271).
// Winners per block: 16 (8 lanes) or 4 (32 lanes), halved at launch until
// their shared memory fits the 227 KB a block may hold; a block keeps its
// 128 threads and the slots past the winners stay idle. One winner a
// block is the limit (kernels/tb_dp.py max_read_len counts the same
// bytes): B6 at hw 16 takes ~23 bytes a read base, ~10,000 bases.
// What is left: at 2,048 winners the card holds one warp per scheduler,
// and a row is ~185 instructions with five dependent shuffles among them,
// so the kernels run at one warp's pace (~0.25 us a row). A wavefront over
// anti-diagonals (a lane per read row, no scan) was built and measured
// slower here at 128, 2,048 and 16,384 winners: a step of one cell still
// takes ~60 instructions.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "urmap_kernels.h"

namespace {

constexpr int kNeg = -(1 << 20);
constexpr int kThreads = 128;         // threads per block of both kernels
constexpr int kMaxSmem = 227 * 1024;  // an H100 block's most
constexpr unsigned kWarp = 0xFFFFFFFFu;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// One compiled variant: G lanes a winner, CPL band cells a lane, HWC the
// compiled half-width or 0 (hw at run time, W <= G * CPL).
template <int G_, int CPL_, int HWC_>
struct Band {
  static constexpr int G = G_, CPL = CPL_, HWC = HWC_;
  static constexpr int WS = G * CPL;          // cells of the variant
  static constexpr int SLOTS = kThreads / G;  // winners a block at most
  static_assert(HWC == 0 || 2 * HWC + 1 <= WS, "band wider than the lanes");
};

// Shared memory of a block, per winner, in 32-bit words: B6's codes and
// records (none for B7), the window bytes and the read bytes.
struct TbSmem {
  int code_words, rec_words, win_words, read_words;
  __host__ __device__ TbSmem(int L, int ws, bool dops) {
    code_words = dops ? (L + 7) / 8 * ws : 0;
    rec_words = dops ? round_up((L + 3) / 4, 8) : 0;
    // a cell past the band's end reads up to ws - 1 bytes past row i
    win_words = round_up(L + ws - 1, 4) / 4;
    read_words = round_up(L, 4) / 4;
  }
  __host__ __device__ int words_per_winner() const {
    return code_words + rec_words + win_words + read_words;
  }
};

// Winners a block for these shapes: SLOTS halved until they fit, 0 if
// one winner does not.
template <class Bd>
int winners_per_block(int L, bool dops) {
  const size_t per = 4 * (size_t)TbSmem(L, Bd::WS, dops).words_per_winner();
  for (int w = Bd::SLOTS; w >= 1; w >>= 1)
    if ((size_t)w * per <= (size_t)kMaxSmem) return w;
  return 0;
}

// The forward pass of one winner, run by its G lanes (lane = this lane's
// place in the group). win_s / read_s: the winner's bytes in shared
// memory. The warp runs to the largest `nrows` of its winners; each
// winner's codes of rows below its own `nrows` go to `store(g, k, word)`
// (band cell lane * CPL + k of group g), a group at its last row, the
// nibbles of rows past nrows zero. `last`: the row whose first maximum
// becomes (best, bend), or -1 for none (then 0 at the centre). Returns
// with (best, bend) the group's.
template <class Bd, class Store>
__device__ __forceinline__ void forward(const uint8_t* win_s,
                                        const uint8_t* read_s, int L, int hw,
                                        int nrows, int last, int lane,
                                        int match, int mismatch, int gap_open,
                                        int gap_extend, int& best_out,
                                        int& bend_out, Store store) {
  constexpr int G = Bd::G, CPL = Bd::CPL, HWC = Bd::HWC;
  const int W = HWC ? 2 * HWC + 1 : 2 * hw + 1;
  const int centre = HWC ? HWC : hw;
  // the compiled band's last cell: where it lives
  constexpr int K_LAST = HWC ? (2 * HWC) % CPL : 0;
  constexpr int LANE_LAST = HWC ? (2 * HWC) / CPL : -1;
  const int b0 = lane * CPL;
  int H[CPL], E[CPL];
  uint32_t acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    H[k] = b0 + k == centre ? 0 : kNeg;
    E[k] = kNeg;
    acc[k] = 0u;
  }
  // this lane's first maximum over its cells of the last row
  int best = INT_MIN, bend = W;
  const int warp_rows = __reduce_max_sync(kWarp, nrows);
  for (int i = 0; i < warp_rows; ++i) {
    const int rd = read_s[i];  // past this winner's rows: computed, unused
    int hnext = __shfl_down_sync(kWarp, H[0], 1, G);
    int enext = __shfl_down_sync(kWarp, E[0], 1, G);
    if (lane == G - 1) hnext = enext = kNeg;
    uint32_t code[CPL];
    int diag[CPL], T[CPL];
    int lane_max = INT_MIN;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      int hb = k + 1 < CPL ? H[k + 1] : hnext;
      int eb = k + 1 < CPL ? E[k + 1] : enext;
      if (HWC && k == K_LAST && lane == LANE_LAST) hb = eb = kNeg;
      const int eo = hb + gap_open;
      const int en = max(eo, eb + gap_extend);
      code[k] = eo != en ? 4u : 0u;
      E[k] = en;
      diag[k] = H[k] + (win_s[i + b0 + k] == rd ? match : mismatch);
      T[k] = max(diag[k], en);
      lane_max = max(lane_max, T[k] - (b0 + k + 1) * gap_extend);
    }
    // F[b] = max(NEG, max_{c<b}(T[c] - (c+1)*ext)) + open + b*ext: the
    // maximum over the lower lanes, then serially over this lane's cells
    int run = lane_max;
#pragma unroll
    for (int s = 1; s < G; s <<= 1)  // a lane below s gets its own value
      run = max(run, __shfl_up_sync(kWarp, run, s, G));
    run = __shfl_up_sync(kWarp, run, 1, G);
    run = lane == 0 ? kNeg : max(run, kNeg);
    int hn[CPL], F[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      F[k] = run + gap_open + (b0 + k) * gap_extend;
      run = max(run, T[k] - (b0 + k + 1) * gap_extend);
      hn[k] = max(T[k], F[k]);
      code[k] |= hn[k] == diag[k] ? 0u : (hn[k] == E[k] ? 1u : 2u);
    }
    int hprev = __shfl_up_sync(kWarp, hn[CPL - 1], 1, G);
    if (lane == 0) hprev = kNeg;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      code[k] |= hprev + gap_open != F[k] ? 8u : 0u;
      hprev = hn[k];
      H[k] = hn[k];
      acc[k] = (acc[k] << 4) | code[k];
      if (!HWC && b0 + k >= W) {  // past the band: the NEG fill again
        H[k] = kNeg;
        E[k] = kNeg;
      }
    }
    if (i == last) {  // the last row: this lane's first maximum
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        if (b0 + k < W && H[k] > best) {
          best = H[k];
          bend = b0 + k;
        }
      }
    }
    if (i < nrows && ((i & 7) == 7 || i + 1 == nrows)) {
      // rows cut off after nrows leave their nibbles zero
      const int g = i >> 3;
      const int cut = 4 * (min(8 * g + 8, L) - (i + 1));
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        store(g, k, acc[k] << cut);
        acc[k] = 0u;
      }
    }
  }
  // the group's first maximum: the larger value, then the lower cell
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(kWarp, best, d, G);
    const int ob = __shfl_xor_sync(kWarp, bend, d, G);
    if (ov > best || (ov == best && ob < bend)) {
      best = ov;
      bend = ob;
    }
  }
  if (last < 0) {  // no row is the last: the forced start
    best = 0;
    bend = centre;
  }
  best_out = best;
  bend_out = bend;
}

// The winner of slot `slot` of this block: its bytes into shared memory
// (window zero past its end, read bytes below `rows`), by its G lanes.
__device__ __forceinline__ void stage_winner(uint8_t* win_s, uint8_t* read_s,
                                             const TbSmem& lay,
                                             const uint8_t* win,
                                             const uint8_t* reads, long long t,
                                             int L, int hw, int rows,
                                             int lane, int G) {
  const int wlen = L + 2 * hw;
  const uint8_t* w = win + t * wlen;
  const uint8_t* r = reads + t * L;
  for (int x = lane; x < 4 * lay.win_words; x += G)
    win_s[x] = x < wlen ? w[x] : 0;
  for (int x = lane; x < rows; x += G) read_s[x] = r[x];
}

template <class Bd>
__global__ void __launch_bounds__(kThreads)
    tb_dops_kernel(const uint8_t* __restrict__ win,
                   const uint8_t* __restrict__ reads,
                   const int32_t* __restrict__ lengths,
                   int32_t* __restrict__ score_out,
                   uint8_t* __restrict__ ok_out, uint32_t* __restrict__ dops,
                   int n, int L, int hw, int wpb, int match, int mismatch,
                   int gap_open, int gap_extend) {
  constexpr int G = Bd::G, WS = Bd::WS;
  extern __shared__ uint32_t smem[];
  const int W = Bd::HWC ? 2 * Bd::HWC + 1 : 2 * hw + 1;
  const int centre = Bd::HWC ? Bd::HWC : hw;
  const int slot = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  // slots past the block's winners run along with an empty read (the
  // shuffles name the whole warp) over slot 0's bytes and write nothing
  const bool live_slot = slot < wpb;
  const long long t = (long long)blockIdx.x * wpb + slot;
  const bool act = live_slot && t < n;
  const TbSmem lay(L, WS, true);
  // records of all winners first ([word][slot], the order they leave in),
  // then each winner's codes, window and read
  uint32_t* recs = smem;
  uint32_t* codes = smem + wpb * lay.rec_words +
                    (live_slot ? slot : 0) *
                        (lay.code_words + lay.win_words + lay.read_words);
  uint8_t* win_s = (uint8_t*)(codes + lay.code_words);
  uint8_t* read_s = win_s + 4 * lay.win_words;

  const int len = act ? lengths[t] : 0;
  const int rows = min(max(len, 0), L);
  if (act) stage_winner(win_s, read_s, lay, win, reads, t, L, hw, rows, lane,
                        G);
  if (live_slot)
    for (int x = lane; x < lay.rec_words; x += G) recs[x * wpb + slot] = 0u;
  __syncwarp();

  int best, bend;
  forward<Bd>(win_s, read_s, L, hw, rows,
              len >= 1 && len <= L ? len - 1 : -1, lane, match, mismatch,
              gap_open, gap_extend, best, bend,
              [&](int g, int k, uint32_t word) {
                codes[g * WS + lane * Bd::CPL + k] = word;
              });
  __syncwarp();

  // ---- backward walk, lane 0 of the group, over shared memory ----
  if (lane == 0 && act) {
    auto word = [&](int g, int bb) -> uint32_t {
      return (bb < 0 || bb >= W) ? 0u : codes[g * WS + bb];
    };
    int b = (len >= 1 && len <= L) ? bend : 0;
    int st = 0;
    uint32_t recw = 0u;
    // the word of (group cg, cell cb): 8 rows of the cell the path is on
    int cg = -1, cb = 0;
    uint32_t cw = 0u;
    int i = rows - 1;
    while (i >= 0) {
      const int g = i >> 3;
      if (g != cg || b != cb) {
        cw = word(g, b);
        cg = g;
        cb = b;
      }
      if (st == 0 && (i & 7) == 7 && (cw & 0x33333333u) == 0u) {
        // eight diagonal rows: records 0 (set before), b and st stay
        i -= 8;
        continue;
      }
      const int sh = 4 * (min(8 * g + 8, L) - 1 - i);
      auto code = [&](int bb) -> uint32_t { return (word(g, bb) >> sh) & 15u; };
      const uint32_t c0 = (cw >> sh) & 15u;
      uint32_t rec = 0u;
      if (st == 1) {
        rec = 1u << 6;
        st = (c0 >> 2) & 1;
        b += 1;
      } else if ((c0 & 3u) != 0u) {
        int d = 0;
        uint32_t cl = c0;
        if ((c0 & 3u) == 2u) {
          // chain length 1 + run of link(bb) = fe(bb) | hc(bb-1) == 2
          d = 1;
          uint32_t cc = c0;
          for (int bb = b; bb >= 0; --bb) {
            const uint32_t cm = code(bb - 1);
            if (!(((cc >> 3) & 1u) | ((cm & 3u) == 2u ? 1u : 0u))) break;
            ++d;
            cc = cm;
          }
          cl = code(b - d);
        }
        const int bl = b - d;
        const uint32_t op = (cl & 3u) == 1u ? 1u : 0u;
        rec = (uint32_t)d | (op << 6);
        st = op ? (int)((cl >> 2) & 1u) : 0;
        b = op ? bl + 1 : bl;
      }  // else a diagonal step: record 0, b and st stay
      recw = recw * 256u + rec;
      if ((i & 3) == 0) {
        recs[(i >> 2) * wpb + slot] = recw;
        recw = 0u;
      }
      --i;
    }
    score_out[t] = best;
    ok_out[t] = (b == centre && st == 0 && len > 0) ? 1 : 0;
  }
  __syncthreads();
  // the records leave with the block's winners side by side along N
  const long long first = (long long)blockIdx.x * wpb;
  for (int x = threadIdx.x; x < lay.rec_words * wpb; x += kThreads) {
    const long long tt = first + x % wpb;
    if (tt < n) dops[(size_t)(x / wpb) * n + tt] = recs[x];
  }
}

template <class Bd>
__global__ void __launch_bounds__(kThreads)
    tb_bits_kernel(const uint8_t* __restrict__ win,
                   const uint8_t* __restrict__ reads,
                   const int32_t* __restrict__ lengths,
                   int32_t* __restrict__ score_out,
                   int32_t* __restrict__ bend_out,
                   uint32_t* __restrict__ bits, int n, int L, int hw, int wpb,
                   int match, int mismatch, int gap_open, int gap_extend) {
  constexpr int G = Bd::G;
  extern __shared__ uint32_t smem[];
  const int W = Bd::HWC ? 2 * Bd::HWC + 1 : 2 * hw + 1;
  const int WP = round_up(W, 8);
  const int slot = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const bool live_slot = slot < wpb;
  const long long t = (long long)blockIdx.x * wpb + slot;
  const bool act = live_slot && t < n;
  const TbSmem lay(L, Bd::WS, false);
  uint8_t* win_s = (uint8_t*)(smem + (live_slot ? slot : 0) *
                                         (lay.win_words + lay.read_words));
  uint8_t* read_s = win_s + 4 * lay.win_words;
  const int len = act ? lengths[t] : 0;
  if (act) stage_winner(win_s, read_s, lay, win, reads, t, L, hw, L, lane, G);
  __syncwarp();

  int best, bend;
  forward<Bd>(win_s, read_s, L, hw, act ? L : 0,
              len >= 1 && len <= L ? len - 1 : -1, lane, match, mismatch,
              gap_open, gap_extend, best, bend,
              [&](int g, int k, uint32_t word) {
                // band cell b of group g is row g * WP + b, pad rows zero
                const int b = lane * Bd::CPL + k;
                if (b < WP)
                  bits[(size_t)(g * WP + b) * n + t] = b < W ? word : 0u;
              });
  if (lane == 0 && act) {
    score_out[t] = best;
    bend_out[t] = bend;
  }
}

// Above 48 KB a kernel opts in, once per device and kernel: the attribute
// is set to the most at the first such launch there and kept.
template <class Kernel>
int opt_in(Kernel kernel, size_t bytes, std::atomic<bool>* opted) {
  constexpr int kMaxDevices = 64;
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted[dev].store(true, std::memory_order_release);
  }
  return 0;
}

struct TbArgs {
  const uint8_t* win;
  const uint8_t* reads;
  const int32_t* lengths;
  int n, L, hw, match, mismatch, gap_open, gap_extend;
  cudaStream_t s;
};

template <class Bd>
int launch_dops(const TbArgs& a, int32_t* score, uint8_t* ok,
                uint32_t* dops) {
  static std::atomic<bool> opted[64];
  const int wpb = winners_per_block<Bd>(a.L, true);
  if (wpb == 0) return (int)cudaErrorInvalidValue;
  const size_t bytes =
      4 * (size_t)wpb * TbSmem(a.L, Bd::WS, true).words_per_winner();
  const auto kernel = tb_dops_kernel<Bd>;
  const int err = opt_in(kernel, bytes, opted);
  if (err) return err;
  kernel<<<(unsigned)((a.n + wpb - 1) / wpb), kThreads, bytes, a.s>>>(
      a.win, a.reads, a.lengths, score, ok, dops, a.n, a.L, a.hw, wpb,
      a.match, a.mismatch, a.gap_open, a.gap_extend);
  return (int)cudaGetLastError();
}

template <class Bd>
int launch_bits(const TbArgs& a, int32_t* score, int32_t* bend,
                uint32_t* bits) {
  static std::atomic<bool> opted[64];
  const int wpb = winners_per_block<Bd>(a.L, false);
  if (wpb == 0) return (int)cudaErrorInvalidValue;
  const size_t bytes =
      4 * (size_t)wpb * TbSmem(a.L, Bd::WS, false).words_per_winner();
  const auto kernel = tb_bits_kernel<Bd>;
  const int err = opt_in(kernel, bytes, opted);
  if (err) return err;
  kernel<<<(unsigned)((a.n + wpb - 1) / wpb), kThreads, bytes, a.s>>>(
      a.win, a.reads, a.lengths, score, bend, bits, a.n, a.L, a.hw, wpb,
      a.match, a.mismatch, a.gap_open, a.gap_extend);
  return (int)cudaGetLastError();
}

// The variants, smallest first; `fn` runs the first that takes hw (the
// compiled half-widths first). B6 (DOPS) has no 32-lane variant: its
// records stop at hw 31.
template <bool DOPS, class Fn>
int dispatch(int hw, Fn fn) {
  if (hw == 8) return fn(Band<8, 3, 8>{});
  if (hw == 16) return fn(Band<8, 5, 16>{});
  const int W = 2 * hw + 1;
  if (hw < 1) return (int)cudaErrorInvalidValue;
  if (W <= 24) return fn(Band<8, 3, 0>{});
  if (W <= 40) return fn(Band<8, 5, 0>{});
  if (W <= 72) return fn(Band<8, 9, 0>{});
  if constexpr (!DOPS) {
    if (W <= 544) return fn(Band<32, 17, 0>{});
  }
  return (int)cudaErrorInvalidValue;
}

TbArgs args_of(const void* win, const void* reads, const void* lengths,
               int n, int L, int hw, int match, int mismatch, int gap_open,
               int gap_extend, void* stream) {
  return TbArgs{(const uint8_t*)win, (const uint8_t*)reads,
                (const int32_t*)lengths, n, L, hw, match, mismatch,
                gap_open, gap_extend, (cudaStream_t)stream};
}

}  // namespace

// ok = walk_ok as bytes 0/1. hw 1-31 (the binding checks); L up to what
// one winner a block holds (cudaErrorInvalidValue above).
extern "C" int urmap_tb_dops(const void* win, const void* reads,
                             const void* lengths, void* score, void* ok,
                             void* dops, int n, int L, int hw, int match,
                             int mismatch, int gap_open, int gap_extend,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const TbArgs a = args_of(win, reads, lengths, n, L, hw, match, mismatch,
                           gap_open, gap_extend, stream);
  return dispatch<true>(hw, [&](auto bd) {
    return launch_dops<decltype(bd)>(a, (int32_t*)score, (uint8_t*)ok,
                                     (uint32_t*)dops);
  });
}

extern "C" int urmap_tb_bits(const void* win, const void* reads,
                             const void* lengths, void* score, void* bend,
                             void* bits, int n, int L, int hw, int match,
                             int mismatch, int gap_open, int gap_extend,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const TbArgs a = args_of(win, reads, lengths, n, L, hw, match, mismatch,
                           gap_open, gap_extend, stream);
  return dispatch<false>(hw, [&](auto bd) {
    return launch_bits<decltype(bd)>(a, (int32_t*)score, (int32_t*)bend,
                                     (uint32_t*)bits);
  });
}
