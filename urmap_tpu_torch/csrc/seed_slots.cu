// Kernel B3, redesigned as the seed front: from the read upload to each
// seed's CSR run in one launch.
//
// Replaces urmap_tpu/kernels/seed_slots.py:seed_slots_words_pallas
// (body _make_kernel) and the array ops around it. The seeds: for each
// read strand and each of its Q seed offsets o (map/seed.py
// seed_offsets, clipped to [0, L-k]), the k-mer at o read straight from
// the word planes (word o/16 and the next two, funnel-shifted by
// 2*(o%16)), its 2-bit lanes reversed to first-base-most-significant
// order, hashed with murmur3-fmix32 in uint32 arithmetic (wraparound
// multiplies, logical shifts) to slot_bits bits; valid = no N base in the
// k-mer and len >= k. Two guard words past the planes read as code 0 /
// all-N (0x55555555), as the reference pads them. The TPU kernel computed
// every dense offset through MXU expansion matmuls (a Mosaic workaround
// for the missing sublane repeat); only Q = 8 k-mers per read are used,
// so the card computes just those.
//
// Why a front: on the TPU, XLA fused everything between the read upload
// and the table fetch into one computation around the Pallas kernel; in
// eager PyTorch each step of it was its own launch: the upload's byte
// packing and the Morton spread of its N plane
// (genome_pack.read_words_from_upload), the word-space reverse complement
// with a tail mask built on the host and copied up on every call
// (revcomp_words), the stacking of both strands (torch.cat) and the CSR
// offset decode (map/seed.py decode_offsets): ~160 launches around the
// first seed kernel (one thread per (read, seed), ~0.004 ms a batch, near
// a launch's floor). The front is one launch that does all of it, bit for
// bit:
//   in:  the forward read words, from the upload blocks (packed uint8
//        [B, >= 4 nw], 4 bases a byte; nmask uint8 [B, >= 2 nw], 8 N bits
//        a byte; lanes past each length forced to N) or as word planes
//        int32 [B, nw]; lengths; the CSR offsets (uint32 [S + 1], or the
//        packed row128 form: two uint16 slot entries a word and obase
//        [S >> block_bits]);
//   out: rpacked2 and rnplane2 int32 [2B, nw] (forward rows, then the
//        reverse-complement rows), offs int32 and valid bool [2B, Q], and
//        per (read-strand, seed) start int64 and cnt int32 of its CSR run;
//        in slots mode (offsets nullptr) the seed's slot int32 [2B, Q] in
//        place of cnt and no start: the output of the TPU kernel itself,
//        which the sharded routes take (a rank holds one slot range of
//        the offsets, so the run is decoded where the slot is owned).
// Design: one warp per read. The lanes load the read's upload bytes or
// words once (neighbouring lanes neighbouring words), build the forward
// planes into registers and shared memory, write them, then build the
// reverse-complement words from the forward words in shared memory (the
// same word gather and funnel shift as revcomp_words, the tail masks
// computed in place), then take the read's 2Q seeds, one to a lane:
// three words of each plane from shared memory, the hash, and the seed's
// offset-table words with one dependent load (two for the packed form:
// the half-word and its block base). What bounds it on the card: bytes,
// ~6 nw bytes of upload a read in, 16 nw bytes of words and ~17 Q bytes
// of seeds out, two table words a seed, and ~60 integer instructions a
// seed; the offset loads are random reads of a table of 2^slot_bits
// entries.

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

// The k-mer of k <= 32 bases at a seed offset: A, B = bases 0-15 and
// 16-31 (and their N planes nA, nB) funnel-shifted out of the words, each
// 2-bit-lane reversed to first-base-most-significant order → (lo, hi)
// hash words and okbits (0: no N base).
__device__ __forceinline__ void kmer_words(int k, uint32_t A, uint32_t nA,
                                           uint32_t B, uint32_t nB,
                                           uint32_t& lo, uint32_t& hi,
                                           uint32_t& okbits) {
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
}

constexpr int kFrontWarps = 4;  // reads per block of seed_front_kernel

// x mod 16 and x / 16 rounded down, for any sign (torch's floor forms)
__device__ __forceinline__ int floor_div16(int x) { return x >> 4; }

// 01 in every 2-bit lane of word w at base index >= len
__device__ __forceinline__ uint32_t tail_n_mask(int len, int w) {
  const int rem = min(max(len - 16 * w, 0), 16);
  const uint32_t kept = rem >= 16 ? 0xFFFFFFFFu : (1u << (2 * rem)) - 1u;
  return 0x55555555u & ~kept;
}

struct FrontIn {
  const uint8_t* packed;  // upload blocks, or nullptr: word planes
  const uint8_t* nmask;
  int pk_cols, nm_cols;   // bytes a row of each block
  const uint32_t* rp;     // word planes [B, nw]
  const uint32_t* rn;
  const int32_t* lengths;
  const uint32_t* offsets;  // [S + 1], or the packed [ceil(S / 2)]
  const uint32_t* obase;    // packed form only, else nullptr
  int cnt_bits, block_bits;
};

struct FrontOut {
  uint32_t* rp2;
  uint32_t* rn2;
  int32_t* offs;
  bool* valid;
  long long* start;
  int32_t* cnt;
};

__global__ void __launch_bounds__(kFrontWarps * 32)
    seed_front_kernel(const FrontIn in, const FrontOut out, int B, int nw,
                      int L, int k, int q, int slot_bits) {
  extern __shared__ uint32_t fsm[];
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kFrontWarps + wi;
  if (r >= B) return;  // the whole warp leaves together
  // this warp's planes: forward words at fp[1 + w] with a zero word at
  // each end (revcomp_words' padding), reverse-complement words at rc[u]
  uint32_t* fp = fsm + wi * 4 * (nw + 2);
  uint32_t* fn = fp + (nw + 2);
  uint32_t* rcp = fn + (nw + 2);
  uint32_t* rcn = rcp + (nw + 2);
  const int len = in.lengths[r];

  for (int w = lane; w < nw; w += 32) {
    uint32_t c, nb;
    if (in.packed) {
      // the 4-base upload bytes are the word's bytes, little-endian; the
      // 1-bit N plane spreads to the 2-bit lanes (a Morton expand)
      const uint8_t* pk = in.packed + r * in.pk_cols;
      const uint8_t* nm = in.nmask + r * in.nm_cols;
      c = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c |= (uint32_t)(4 * w + j < in.pk_cols ? pk[4 * w + j] : 0) << (8 * j);
      uint32_t x = (uint32_t)(2 * w < in.nm_cols ? nm[2 * w] : 0) |
                   ((uint32_t)(2 * w + 1 < in.nm_cols ? nm[2 * w + 1] : 0)
                    << 8);
      x = (x | (x << 8)) & 0x00FF00FFu;
      x = (x | (x << 4)) & 0x0F0F0F0Fu;
      x = (x | (x << 2)) & 0x33333333u;
      x = (x | (x << 1)) & 0x55555555u;
      nb = x | tail_n_mask(len, w);
    } else {
      c = in.rp[r * nw + w];
      nb = in.rn[r * nw + w];
    }
    out.rp2[r * nw + w] = c;
    out.rn2[r * nw + w] = nb;
    fp[1 + w] = c;
    fn[1 + w] = nb;
  }
  if (lane == 0) fp[0] = fn[0] = fp[nw + 1] = fn[nw + 1] = 0u;
  __syncwarp();

  // the reverse complement, word u: forward bases from len - 16 (u + 1),
  // a word gather and a funnel shift by 2 (len mod 16), the 2-bit lanes
  // reversed, complemented, N lanes forced to 01; lanes >= L code 00
  const uint32_t sh = 2u * (uint32_t)(((len % 16) + 16) % 16);
  for (int u = lane; u < nw; u += 32) {
    const int w0 = min(max(floor_div16(len - 16 * (u + 1)) + 1, 0), nw);
    const uint32_t code = rev2bit(funnel(fp[w0], fp[w0 + 1], sh));
    const uint32_t nbit = rev2bit(funnel(fn[w0], fn[w0 + 1], sh));
    const uint32_t nm2 = nbit | tail_n_mask(len, u);
    uint32_t rc = (~code & ~(nm2 | (nm2 << 1))) | nm2;
    const int kept = min(max(L - 16 * u, 0), 16);
    if (kept < 16) rc &= (1u << (2 * kept)) - 1u;
    out.rp2[(B + r) * nw + u] = rc;
    out.rn2[(B + r) * nw + u] = nm2;
    rcp[u] = rc;
    rcn[u] = nm2;
  }
  __syncwarp();

  // the 2Q seeds of the read, one to a lane: strand s, seed qi
  const int span = len - k > 0 ? len - k : 0;
  const int m = L - k + 1;
  const uint32_t mask =
      slot_bits >= 32 ? 0xFFFFFFFFu : ((1u << slot_bits) - 1u);
  for (int j = lane; j < 2 * q; j += 32) {
    const int s = j / q, qi = j - s * q;
    const uint32_t* cw = s ? rcp : fp + 1;
    const uint32_t* nwp = s ? rcn : fn + 1;
    const int off = q == 1 ? 0 : (qi * span) / (q - 1);
    const int oc = off < 0 ? 0 : (off > m - 1 ? m - 1 : off);
    const int w = oc >> 4;
    const uint32_t wsh = 2u * (uint32_t)(oc & 15);
    uint32_t c[3], nn[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const bool inw = w + d < nw;
      c[d] = inw ? cw[w + d] : 0u;
      nn[d] = inw ? nwp[w + d] : 0x55555555u;
    }
    uint32_t lo, hi, okbits;
    kmer_words(k, funnel(c[0], c[1], wsh), funnel(nn[0], nn[1], wsh),
               funnel(c[1], c[2], wsh), funnel(nn[1], nn[2], wsh), lo, hi,
               okbits);
    const uint32_t slot = hash_words(lo, hi) & mask;
    const long long o = ((long long)s * B + r) * q + qi;
    if (!in.offsets) {
      // slots mode: the slot itself (a uint32 bit pattern) in place of
      // the run, for a caller whose table holds one slot range only
      out.cnt[o] = (int32_t)slot;
    } else {
      // the seed's CSR run: plain offsets, or the packed half-word and
      // its block's base (start = base + delta, in 64 bits)
      long long st;
      uint32_t n_run;
      if (in.obase) {
        const uint32_t wd = in.offsets[slot >> 1];
        const uint32_t u = (slot & 1u ? wd >> 16 : wd) & 0xFFFFu;
        st = (long long)in.obase[slot >> in.block_bits] + (u >> in.cnt_bits);
        n_run = u & ((1u << in.cnt_bits) - 1u);
      } else {
        const uint32_t a = in.offsets[slot];
        st = a;
        n_run = in.offsets[slot + 1] - a;
      }
      out.start[o] = st;
      out.cnt[o] = (int32_t)n_run;
    }
    out.offs[o] = off;
    out.valid[o] = okbits == 0u && len >= k;
  }
}

}  // namespace

extern "C" int urmap_seed_front(const void* packed, const void* nmask,
                                int pk_cols, int nm_cols, const void* rp,
                                const void* rn, const void* lengths,
                                const void* offsets, const void* obase,
                                int cnt_bits, int block_bits, void* rp2,
                                void* rn2, void* offs, void* valid,
                                void* start, void* cnt, int B, int nw, int L,
                                int k, int q, int slot_bits, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const FrontIn in{(const uint8_t*)packed, (const uint8_t*)nmask, pk_cols,
                   nm_cols, (const uint32_t*)rp, (const uint32_t*)rn,
                   (const int32_t*)lengths, (const uint32_t*)offsets,
                   (const uint32_t*)obase, cnt_bits, block_bits};
  const FrontOut out{(uint32_t*)rp2, (uint32_t*)rn2, (int32_t*)offs,
                     (bool*)valid, (long long*)start, (int32_t*)cnt};
  const size_t bytes = (size_t)kFrontWarps * 4 * (nw + 2) * 4;
  if (bytes > 48 * 1024) {  // a long read: opt in above the default
    const cudaError_t err = cudaFuncSetAttribute(
        seed_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((B + kFrontWarps - 1) / kFrontWarps);
  seed_front_kernel<<<blocks, kFrontWarps * 32, bytes,
                      (cudaStream_t)stream>>>(in, out, B, nw, L, k, q,
                                              slot_bits);
  return (int)cudaGetLastError();
}
