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
// B6 (tb_dops_kernel) then walks the codes backwards from (lengths - 1,
// bend), bend the first band cell holding the maximum of row lengths - 1,
// and emits one record per read row, rec_i = d | op << 6 (op 1 =
// insertion, d = deletions after row i), rec_i at byte i % 4 of word i / 4
// of dops[DWP, N], and walk_ok = the walk ended at b == hw in state H and
// lengths > 0. Cells outside the band read as code 0, as the reference's
// one-hot selects give. It runs the rows below the read's length only,
// since the walk reads no later row. A length above L has no last row:
// score 0, and the walk starts at band cell 0 with every row live, as the
// reference's does.
//
// B7 (tb_bits_kernel) keeps the codes as its output, int32 [NWORDS, N]: 8
// read rows per word, row i of group g at nibble hi - 1 - i (hi =
// min(8g + 8, L)); band cell b of group g is row g * WP + b (WP = W
// rounded up to 8, pad rows zero). It runs all L rows whatever the length
// and gives score and bend. The mapping path never calls it.
//
// What bounds B6 on the card: integer ALU work, ~15 instructions on the
// int32 pipe per band cell and read row (E and the ee compare 2; the
// substitution 2; T 1; the running max and H 2; the fe compare 1; hc 4;
// the nibble 3) over 33 x 160 cells, against 356 bytes in and 160 bytes of
// records out per winner. But a batch has 2,048 winners (128 at the
// least), and with one thread per winner that is 64 warps on a card of 528
// warp schedulers, each thread a chain of ~100k dependent instructions
// followed by 160 dependent loads from a scratch tensor in global memory:
// latency, not throughput, with seven of eight schedulers idle. So the
// design spreads ONE winner over a group of G lanes of a warp, the band
// across the lanes, CPL = ceil(W / G) neighbouring cells per lane. G = 8
// (5 cells a lane at W = 33, four winners a warp): a row costs ~65
// instructions a lane and ~25 more a cell, so fewer lanes mean fewer
// instructions per winner. Measured on an H100 against 16 and 32 lanes,
// 8 tied within 5% at 128 and 2,048 winners and won at 16,384 (0.238 ms
// against 0.274 and 0.366), so 8 is the one variant compiled.
//   - per read row, H and E of cell b + 1 come from the next lane by
//     __shfl_down_sync; the deletion chain, which serialises along the
//     band, is the running maximum max_{c<b}(T[c] - (c + 1) * ext): a
//     serial maximum over the lane's own cells and a prefix maximum over
//     the lanes in log2(G) steps of __shfl_up_sync; H of cell b - 1 (for
//     the fe bit) comes from the previous lane;
//   - the shuffles name the whole warp and move within segments of G
//     lanes, and the winners of a warp step through the rows together,
//     to the longest one's last row;
//   - cells past the band's end (G * CPL > W) are computed and never
//     read: only cell W - 1 looks at a higher cell, and takes NEG there;
//   - window and read bytes are loaded once by the group, neighbouring
//     lanes neighbouring bytes, into shared memory;
//   - the per-cell codes (8 rows per word as in B7's layout, word
//     g * G * CPL + b for band cell b) stay in shared memory, ~3-5 KB
//     per winner; the wrapper allocates no scratch;
//   - lane 0 of the group walks back through shared memory, keeping the
//     word of its band cell in a register while the path stays on the
//     diagonal; a group of 8 rows whose codes on the path are all
//     diagonal is taken in one step (most of a read: the walk of a clean
//     read is 20 steps, not 160);
//   - the records are gathered in shared memory and written by the whole
//     block, the winners of a block side by side along N.
// What is left: at 2,048 winners the card holds one warp per scheduler,
// and a row is ~185 instructions with five dependent shuffles among them,
// so the kernel runs at one warp's pace (~0.25 us a row). A wavefront over
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
constexpr int kDopsThreads = 128;  // threads per block of tb_dops_kernel
constexpr int kDopsLanes = 8;      // lanes of a warp per winner (G)

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of tb_dops_kernel, per block of WPB = kDopsThreads / G
// winners, in 32-bit words: codes, records, window bytes, read bytes.
struct DopsSmem {
  int code_words, rec_words, win_words, read_words;
  __host__ __device__ DopsSmem(int L, int hw) {
    constexpr int G = kDopsLanes;
    const int W = 2 * hw + 1;
    const int ws = G * ((W + G - 1) / G);
    code_words = (L + 7) / 8 * ws;
    rec_words = round_up((L + 3) / 4, 8);
    // a cell past the band's end reads up to ws - W bytes past the window
    win_words = round_up(L + 2 * hw + ws - W, 4) / 4;
    read_words = round_up(L, 4) / 4;
  }
  __host__ __device__ int words_per_winner() const {
    return code_words + rec_words + win_words + read_words;
  }
};

template <int HW>
__global__ void __launch_bounds__(kDopsThreads)
    tb_dops_kernel(const uint8_t* __restrict__ win,
                   const uint8_t* __restrict__ reads,
                   const int32_t* __restrict__ lengths,
                   int32_t* __restrict__ score_out,
                   uint8_t* __restrict__ ok_out, uint32_t* __restrict__ dops,
                   int n, int L, int match, int mismatch, int gap_open,
                   int gap_extend) {
  constexpr int G = kDopsLanes;
  constexpr int W = 2 * HW + 1;
  constexpr int CPL = (W + G - 1) / G;  // band cells per lane
  constexpr int WS = G * CPL;           // code words per group of 8 rows
  constexpr int WPB = kDopsThreads / G;
  constexpr int K_LAST = (W - 1) % CPL;  // where cell W - 1 lives
  constexpr int LANE_LAST = (W - 1) / CPL;
  extern __shared__ uint32_t smem[];

  const int slot = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int t = blockIdx.x * WPB + slot;
  // The shuffles name the whole warp and move within segments of G
  // lanes, and the warp's winners step through the rows together: with
  // a mask per group the compiler checks the mask before every row's
  // shuffles (MATCH.ANY), which costs more than the rows a shorter read
  // waits for a longer one.
  constexpr unsigned kWarp = 0xFFFFFFFFu;
  const DopsSmem lay(L, HW);
  // records of all winners first ([word][slot], the order they leave in),
  // then each winner's codes, window and read
  uint32_t* recs = smem;
  uint32_t* codes = smem + WPB * lay.rec_words +
                    slot * (lay.code_words + lay.win_words + lay.read_words);
  uint8_t* win_s = (uint8_t*)(codes + lay.code_words);
  uint8_t* read_s = win_s + 4 * lay.win_words;

  const int wlen = L + 2 * HW;
  const int len = t < n ? lengths[t] : 0;
  const int rows = min(max(len, 0), L);
  if (t < n) {
    const uint8_t* w = win + (size_t)t * wlen;
    const uint8_t* r = reads + (size_t)t * L;
    for (int x = lane; x < 4 * lay.win_words; x += G)
      win_s[x] = x < wlen ? w[x] : 0;
    for (int x = lane; x < rows; x += G) read_s[x] = r[x];
  }
  for (int x = lane; x < lay.rec_words; x += G) recs[x * WPB + slot] = 0u;
  __syncwarp();

  // ---- forward pass: this lane's cells b0 .. b0 + CPL - 1 ----
  const int b0 = lane * CPL;
  int H[CPL], E[CPL];
  uint32_t acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    H[k] = b0 + k == HW ? 0 : kNeg;
    E[k] = kNeg;
    acc[k] = 0u;
  }
  // this lane's first maximum over its cells of the last row
  int best = INT_MIN, bend = W;
  const int warp_rows = __reduce_max_sync(kWarp, rows);
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
      if (k == K_LAST && lane == LANE_LAST) hb = eb = kNeg;  // cell W - 1
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
    }
    if (i + 1 == rows) {  // the last row: this lane's first maximum
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        if (b0 + k < W && H[k] > best) {
          best = H[k];
          bend = b0 + k;
        }
      }
    }
    if (i < rows && ((i & 7) == 7 || i + 1 == rows)) {
      // rows cut off after the read's end leave their nibbles zero
      const int g = i >> 3;
      const int cut = 4 * (min(8 * g + 8, L) - (i + 1));
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        codes[g * WS + b0 + k] = acc[k] << cut;
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
  if (len < 1 || len > L) {  // no row is the last: the forced start
    best = 0;
    bend = HW;
  }
  __syncwarp();

  // ---- backward walk, lane 0 of the group, over shared memory ----
  if (lane == 0 && t < n) {
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
        recs[(i >> 2) * WPB + slot] = recw;
        recw = 0u;
      }
      --i;
    }
    score_out[t] = best;
    ok_out[t] = (b == HW && st == 0 && len > 0) ? 1 : 0;
  }
  __syncthreads();
  // the records leave with the block's winners side by side along N
  const int first = blockIdx.x * WPB;
  for (int x = threadIdx.x; x < lay.rec_words * WPB; x += kDopsThreads) {
    const int tt = first + x % WPB;
    if (tt < n) dops[(size_t)(x / WPB) * n + tt] = recs[x];
  }
}

template <int HW>
__global__ void tb_bits_kernel(const uint8_t* __restrict__ win,
                               const uint8_t* __restrict__ reads,
                               const int32_t* __restrict__ lengths,
                               int32_t* __restrict__ score_out,
                               int32_t* __restrict__ bend_out,
                               uint32_t* __restrict__ bits, int n, int L,
                               int match, int mismatch, int gap_open,
                               int gap_extend) {
  // one thread per winner: the band's H, E, window bytes and the group's
  // code words in registers (the band loops unroll), the deletion chain
  // as a running max along the band; the store of a group is coalesced
  // across the block (N is the fast axis)
  constexpr int W = 2 * HW + 1;
  constexpr int WP = (W + 7) / 8 * 8;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int wlen = L + 2 * HW;
  const uint8_t* w = win + (size_t)t * wlen;
  const uint8_t* r = reads + (size_t)t * L;
  const int len = lengths[t];
  const int groups = (L + 7) / 8;
  // the last band cell's E reads the fill value through both terms
  const int eo_last = kNeg + gap_open;
  const int e_last = max(eo_last, kNeg + gap_extend);
  const uint32_t ee_last = eo_last != e_last ? 4u : 0u;

  int H[W], E[W], wr[W];
  uint32_t acc[W];
#pragma unroll
  for (int b = 0; b < W; ++b) {
    H[b] = b == HW ? 0 : kNeg;
    E[b] = kNeg;
    wr[b] = w[b];
  }
  // the last row's cells stay the forced start when no row is the last
  int best = 0, bend = HW;
  for (int g = 0; g < groups; ++g) {
    const int hi = min(8 * g + 8, L);
#pragma unroll
    for (int b = 0; b < W; ++b) acc[b] = 0;
    for (int i = 8 * g; i < hi; ++i) {
      const int rd = r[i];
#pragma unroll
      for (int b = 0; b < W - 1; ++b) {
        const int eo = H[b + 1] + gap_open;
        const int en = max(eo, E[b + 1] + gap_extend);
        acc[b] = (acc[b] << 4) | (eo != en ? 4u : 0u);
        E[b] = en;
      }
      acc[W - 1] = (acc[W - 1] << 4) | ee_last;
      E[W - 1] = e_last;
      // F[b] = max(NEG, max_{c<b}(T[c] - (c+1)*ext)) + open + b*ext
      int run = kNeg, hprev = kNeg;
#pragma unroll
      for (int b = 0; b < W; ++b) {
        const int diag = H[b] + (wr[b] == rd ? match : mismatch);
        const int T = max(diag, E[b]);
        const int F = run + gap_open + b * gap_extend;
        run = max(run, T - (b + 1) * gap_extend);
        const int hn = max(T, F);
        const uint32_t hc = hn == diag ? 0u : (hn == E[b] ? 1u : 2u);
        acc[b] |= hc | (hprev + gap_open != F ? 8u : 0u);
        hprev = hn;
        H[b] = hn;
      }
      if (i + 1 == len) {
        best = H[0];
        bend = 0;
#pragma unroll
        for (int b = 1; b < W; ++b) {
          if (H[b] > best) {
            best = H[b];
            bend = b;
          }
        }
      }
#pragma unroll
      for (int b = 0; b < W - 1; ++b) wr[b] = wr[b + 1];
      wr[W - 1] = i + W < wlen ? w[i + W] : 0;
    }
    uint32_t* dst = bits + (size_t)g * WP * n + t;
#pragma unroll
    for (int b = 0; b < W; ++b) dst[(size_t)b * n] = acc[b];
#pragma unroll
    for (int b = W; b < WP; ++b) dst[(size_t)b * n] = 0u;
  }
  score_out[t] = best;
  bend_out[t] = bend;
}

template <int HW>
int launch_dops(int n, cudaStream_t s, const uint8_t* win,
                const uint8_t* reads, const int32_t* lengths, int32_t* score,
                uint8_t* ok, uint32_t* dops, int L, int match, int mismatch,
                int gap_open, int gap_extend) {
  constexpr int WPB = kDopsThreads / kDopsLanes;
  constexpr int kMaxSmem = 227 * 1024;  // an H100 block's most
  constexpr int kMaxDevices = 64;
  const size_t bytes = 4 * (size_t)WPB * DopsSmem(L, HW).words_per_winner();
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const auto kernel = tb_dops_kernel<HW>;
  if (bytes > 48 * 1024) {
    // above 48 KB a kernel opts in, once per device: the attribute is set
    // to the most at the first such launch there and kept
    static std::atomic<bool> opted[kMaxDevices];
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
  }
  kernel<<<(unsigned)((n + WPB - 1) / WPB), kDopsThreads, bytes, s>>>(
      win, reads, lengths, score, ok, dops, n, L, match, mismatch, gap_open,
      gap_extend);
  return (int)cudaGetLastError();
}

}  // namespace

// Band half-widths with a compiled kernel: 8 and 16 (the operator checks).
// ok = walk_ok as bytes 0/1.
extern "C" int urmap_tb_dops(const void* win, const void* reads,
                             const void* lengths, void* score, void* ok,
                             void* dops, int n, int L, int hw, int match,
                             int mismatch, int gap_open, int gap_extend,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* w = (const uint8_t*)win;
  const auto* r = (const uint8_t*)reads;
  const auto* ln = (const int32_t*)lengths;
  switch (hw) {
    case 8:
      return launch_dops<8>(n, s, w, r, ln, (int32_t*)score, (uint8_t*)ok,
                            (uint32_t*)dops, L, match, mismatch, gap_open,
                            gap_extend);
    case 16:
      return launch_dops<16>(n, s, w, r, ln, (int32_t*)score, (uint8_t*)ok,
                             (uint32_t*)dops, L, match, mismatch, gap_open,
                             gap_extend);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int urmap_tb_bits(const void* win, const void* reads,
                             const void* lengths, void* score, void* bend,
                             void* bits, int n, int L, int hw, int match,
                             int mismatch, int gap_open, int gap_extend,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(32);
  const dim3 grid((unsigned)((n + 31) / 32));
  switch (hw) {
    case 8:
      tb_bits_kernel<8><<<grid, block, 0, s>>>(
          (const uint8_t*)win, (const uint8_t*)reads,
          (const int32_t*)lengths, (int32_t*)score, (int32_t*)bend,
          (uint32_t*)bits, n, L, match, mismatch, gap_open, gap_extend);
      break;
    case 16:
      tb_bits_kernel<16><<<grid, block, 0, s>>>(
          (const uint8_t*)win, (const uint8_t*)reads,
          (const int32_t*)lengths, (int32_t*)score, (int32_t*)bend,
          (uint32_t*)bits, n, L, match, mismatch, gap_open, gap_extend);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
