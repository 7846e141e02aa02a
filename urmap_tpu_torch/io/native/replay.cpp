// The host replay of the clip traceback's records (map/clip_tb.py,
// csrc/clip_tb.cu): the card ran the clip-mode traceback of
// urmap_traceback_batch (codecs.cpp) and walked it, one byte per read
// row, rec_i = d | I << 6 | S << 7 at byte i % 4 of word i / 4 (d the
// deletions after row i's op; I an insertion; S a soft-clipped row;
// neither a diagonal step, M or X by comparing the genome). Forward ops:
// for i ascending, op_i then d_i 'D's. The tail (leading and trailing
// I -> S, NM, span, X -> M, run-length encoding) is the host
// traceback's, so a row's CIGAR, NM and span equal
// urmap_traceback_batch(use_clip = 1)'s byte for byte. O(L) a row.
//
// recs: [nrows, ncols] int32 row-major; row i uses column cols[i], its
// genome from starts[i], its strand-applied read at reads + i *
// read_stride. ok_out[i] = 0 marks a row the records do not serve (the
// caller runs the host DP); its cigar entry is empty. Returns 0, or -1 if
// cig_cap was too small (the caller doubles it).
//
// A separate file: io/native/codecs.cpp is a byte-equal copy of the
// reference's and takes no port-only routine.

#include <cstdint>
#include <cstdio>
#include <vector>

extern "C" int64_t urmap_clip_replay_batch(
    const int32_t* recs, int64_t nrows, int64_t ncols, const int32_t* cols,
    const int32_t* lengths, const uint8_t* genome, int64_t G,
    const int64_t* starts, const uint8_t* reads, int64_t read_stride,
    int64_t n, char* cig, int64_t cig_cap, int64_t* cig_off,
    int32_t* nm_out, int32_t* span_out, uint8_t* ok_out) {
  char* o = cig;
  char* const oend = cig + cig_cap;
  cig_off[0] = 0;
  int32_t maxL = 0;
  for (int64_t i = 0; i < n; ++i)
    if (lengths[i] > maxL) maxL = lengths[i];
  std::vector<char> buf(64 * ((size_t)maxL + 2));
  char* const ops = buf.data();
  for (int64_t i = 0; i < n; ++i) {
    const int32_t L = lengths[i];
    const int64_t col = cols[i];
    const uint8_t* r = reads + i * read_stride;
    int64_t gi = starts[i];
    int64_t no = 0;
    bool ok = (L >= 1 && col >= 0 && col < ncols &&
               ((L + 3) >> 2) <= nrows && gi >= 0);
    for (int32_t ii = 0; ok && ii < L; ++ii) {
      const int32_t rec =
          (recs[(int64_t)(ii >> 2) * ncols + col] >> (8 * (ii & 3))) & 0xFF;
      const int32_t d = rec & 63;
      if (rec & 0x80) {
        ops[no++] = 'S';
      } else if (rec & 0x40) {
        ops[no++] = 'I';
      } else {
        if (gi >= G) { ok = false; break; }
        ops[no++] = (genome[gi] == r[ii]) ? 'M' : 'X';
        ++gi;
      }
      for (int32_t a = 0; a < d; ++a) ops[no++] = 'D';
      gi += d;
      if (gi > G) ok = false;
    }
    if (!ok) {
      ok_out[i] = 0;
      cig_off[i + 1] = o - cig;
      nm_out[i] = -1;
      span_out[i] = 0;
      continue;
    }
    // the host traceback's tail (codecs.cpp urmap_traceback_batch)
    int64_t s0 = 0, e0p = no;
    while (s0 < e0p && ops[s0] == 'I') ops[s0++] = 'S';
    while (e0p > s0 && ops[e0p - 1] == 'I') ops[--e0p] = 'S';
    int32_t nm = 0, span = 0;
    for (int64_t a = 0; a < no; ++a) {
      if (ops[a] == 'X' || ops[a] == 'I' || ops[a] == 'D') ++nm;
      if (ops[a] == 'M' || ops[a] == 'X' || ops[a] == 'D') ++span;
      if (ops[a] == 'X') ops[a] = 'M';
    }
    if (oend - o < 2 * no + 16) return -1;
    int64_t a = 0;
    while (a < no) {
      int64_t z = a;
      while (z < no && ops[z] == ops[a]) ++z;
      o += sprintf(o, "%lld%c", (long long)(z - a), ops[a]);
      a = z;
    }
    ok_out[i] = 1;
    cig_off[i + 1] = o - cig;
    nm_out[i] = nm;
    span_out[i] = span;
  }
  return 0;
}
