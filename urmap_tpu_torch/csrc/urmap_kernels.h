// The kernels' plain C entry points, one prototype each.
//
// Every kernel source (csrc/*.cu) includes this header and defines its
// entry points; the binding (csrc/ops.cpp) includes it and calls them. A
// definition whose parameter list differs from its prototype here does not
// compile (two C functions of one name cannot differ), so the two sides
// cannot drift apart. No torch header, no CUDA header: pointers are void*,
// the stream is a cudaStream_t passed as void*. An entry point returns
// cudaGetLastError() after its launch (0 = launched).

#pragma once

#ifdef __cplusplus
extern "C" {
#endif

// B3, redesigned as the seed front, seed_slots.cu. packed/nmask: the upload
// blocks (rp/rn nullptr), or rp/rn the word planes (packed nullptr);
// obase nullptr for plain offsets; offsets nullptr for the slots mode (the
// slot written to cnt, start untouched).
int urmap_seed_front(const void* packed, const void* nmask, int pk_cols,
                     int nm_cols, const void* rp, const void* rn,
                     const void* lengths, const void* offsets,
                     const void* obase, int cnt_bits, int block_bits,
                     void* rp2, void* rn2, void* offs, void* valid,
                     void* start, void* cnt, int B, int nw, int L, int k,
                     int q, int slot_bits, void* stream);
// B4, vote.cu
int urmap_vote(const void* cand, void* top, void* votes, int n, int m, int v,
               void* stream);
// B1 and B1', banded_dp.cu
int urmap_banded_dp(const void* win, const void* reads, const void* lengths,
                    void* scores, void* d0, void* d1, void* ung, int n, int L,
                    int hw, int match, int mismatch, int gap_open,
                    int gap_extend, int clip, int clip_open, void* stream);
int urmap_banded_semiglobal(const void* genome, long long G, const void* cand,
                            const void* reads, const void* lengths,
                            void* scores, void* d0, void* ung, void* span,
                            int n, int L, int hw, int match, int mismatch,
                            int gap_open, int gap_extend, int clip,
                            int clip_open, void* stream);
// B6 and B7, tb_dp.cu
int urmap_tb_dops(const void* win, const void* reads, const void* lengths,
                  void* score, void* ok, void* dops, int n, int L, int hw,
                  int match, int mismatch, int gap_open, int gap_extend,
                  void* stream);
int urmap_tb_bits(const void* win, const void* reads, const void* lengths,
                  void* score, void* bend, void* bits, int n, int L, int hw,
                  int match, int mismatch, int gap_open, int gap_extend,
                  void* stream);
// B5, lane_rotate.cu
int urmap_row128_fetch(const void* table, long long M, int rw,
                       const void* starts, void* out, long long n, int width,
                       int window, void* stream);
int urmap_rotate_narrow(const void* rows, const void* off, void* out,
                        long long n, int W, int width, void* stream);
int urmap_window_codes(const void* table, long long M, long long base_off,
                       const void* starts, int starts64, void* out,
                       long long n, int length, void* stream);
int urmap_window_mismatches(const void* table, long long M,
                            long long base_off, const void* starts,
                            int starts64, const void* rp, const void* rn,
                            const void* lengths, void* out, long long n,
                            int nw, void* stream);
// B8, micro_passes.cu: `passes` rounds of the tools/bench_microvpu.py mix
// on each of n words, x → out
int urmap_micro_passes(const void* x, void* out, long long n, int passes,
                       void* stream);

#ifdef __cplusplus
}
#endif
