"""Smoke run of urmap_tpu_torch on one CUDA card: builds the kernels,
holds each against its plain PyTorch version, maps a chromosome-scale
read set through the port's Mapper on the aligned and on the row128
table layout and a paired read set through its PairedMapper, drives the
command line (python -m urmap_tpu_torch), and checks the results.

    python3 chip_smoke.py [--seed 0] [--reads 131072] [--pairs 65536]

Phases, each printing one JSON line:
  1. device  — the card (torch and nvidia-smi); exits 1 without CUDA;
  2. build   — nvcc builds csrc/*.cu for sm_90a and the operator
               binding csrc/ops.cpp against torch's headers, one per
               source side by side; torch.ops.load_library loads it;
  3. kernels — B4 vote, B1 banded DP (plain and clip mode; clip also
               at the end-clip main DP's N = 32,768), B5 dense-row
               fetch (row entry at W = 128, window
               entry at W = 256 and 384, the literal rotate, and the
               fused entries window_codes at 192 and 1,200 bases and
               window_mismatches at 10 read words, each over a 1-D and
               a [R, 128] genome table with starts before the table,
               in its guard words and past its end), B1' the
               byte-genome DP (plain and clip mode), B6 traceback
               records (N = 2,048, and 128 and 16,384) and B7 traceback
               bits at the paths' shapes; the seed front (2B = 32,768
               read-strands, Q = 8, plain and packed offsets over 2^27
               slots) and its slots mode (no offsets: the sharded
               routes' front); the shapes past the default: B1 (both modes) and
               B1' at band half-widths 12, 24 and 40, B6 and B7 at 12, 24
               and 31, B6 and B1 on read blocks of 700 and 2,000, B4 at
               256 and 2,048 candidates a read; the clip traceback at
               se150_adapters' shape (8,192 lanes, reads of 150 in a
               block of 160); kernel vs plain version
               on the card, exact equality (integer outputs, tolerance
               0), median times of synchronised runs beside each
               kernel's bound;
  4. slice   — a 46,709,983-base synthetic genome (GRCh38 chr21's
               length, with N runs; 1% SNPs, 5% indels, 1% adapter
               tails, 1% junk) → FASTA → index (port host build) →
               planted FASTQ → FastqReader → Mapper(cuda), the default
               MapConfig with the device traceback on → run_stream →
               cigars_nm_blob (replaying the device records) →
               format_single_end → SAM, over the first half of the
               reads on the aligned layout; checks kernel launch counts
               (tb_dops = batches), zero plain-version calls, that at
               least 0.9 of the gapped unclipped winners decode from
               device records (the fallbacks printed by reason), the
               correct fraction, reads/s after a warm batch, peak memory;
  profile  — one batch timed by stage (host clock), with the traceback
             on and off in turns, and by kernel (torch.profiler; the
             full table in build/chip_smoke/);
  5. cpu     — the first 4096 reads again: on the card with the
               traceback on and with tb_bits=False (same SAM bytes), and
               on a CPU Mapper (plain versions) with the traceback on:
               MapResult, tb dict and SAM bytes must be identical;
  6. row128  — the same index prepared in the dense-row layout with
               packed offsets (URMAP_ROW128_BYTES forces it), all reads:
               the slice's checks, every table fetch through kernel B5,
               and MapResult, live traceback records and SAM bytes equal
               to the aligned slice's on the reads both mapped;
  7. paired  — planted FR pairs (150 bp, fragments of 200-600, 1% SNPs,
               5% with a small indel, 5% with one mate mutated every
               15th base so that only the rescue scan places it, 1%
               junk) through PairedMapper over the row128 tables →
               cigars_nm_blob per mate → format_paired: correct mates,
               proper pairs, rescued mates, the 1,200-base rescue
               window fetched by window_codes,
               tb_dops = batches, per-stage times, and PairResult and
               SAM bytes equal to a CPU PairedMapper's on the first
               2048 pairs;
  8. semiglobal — B1' on real work: the first 4096 winners of phase 6
               re-aligned over the byte genome at their POS, kernel
               against plain version on the card, exact;
  9. shapes  — a Mapper over the aligned tables at band_halfwidth 24 and
               max_read_len 704 with the device traceback on: 16,384
               planted reads of 250-700 bases (1% SNPs, 5% with a 1-24 bp
               indel, 1% with a long random tail, 1% junk), batch 4,096;
               the slice's checks (tb_dops = batches, no plain call), and
               the first 1,024 reads on a CPU Mapper: MapResult, tb dict
               and SAM bytes equal to the card's;
 10. cli     — the command line, in-process through
               urmap_tpu_torch.cli.main (the counters read around each
               -map): -make_ufi over the genome's FASTA and -ufistats;
               -map -batch 16,384 over phase 4's reads, whose SAM body
               must equal phase 4's (tb_dops = batches, no plain call);
               the default batch with the card's auto-fit and -batch
               16,384 / 131,072 over the reads 8 times, each twice in
               turns (reads/s, peak memory), and the memory a batch
               takes at 160 and 704 bases, single-end and paired;
               -endclip (B1 clip at N = 32,768 on the main DP, no B6,
               correct fraction, the host's clip-mode DP a batch; card =
               CPU Mapper on 2,048 reads) and -reverse -endclip (card =
               CPU PairedMapper on 1,024 pairs); -secondpass 32 over
               16,384 reads (the plain
               run's SAM; its CPU calls counted as host-pass calls); and
               one `python -m urmap_tpu_torch -map` of 4,096 reads;
 11. tier    — URMAP_TIER_GATHER=1 over phase 4's aligned tables (the
               tier prepare_tables picked, or 4 set here): phase 4's
               reads with MapResult, live traceback records and SAM bytes
               equal to phase 4's, B5's row entry at the tier width once
               a batch plus one full-width launch an overflow round
               (rounds a batch, the share of seeds over the tier), device
               busy ms and launches of one batch tier against untiered in
               turns, and the host syncs of that batch and of its gather
               alone each way, by site, counted under
               torch.cuda.set_sync_debug_mode; the first 2,048 pairs of phase
               7 through a PairedMapper on the aligned tables, tiered =
               untiered;
 12. spill   — phase 4's index built again through the disk radix spill
               (spill_threshold 2^20 words) under build/chip_smoke/spill,
               in one host chunk and in chunks of 2^23 words: offsets and
               positions equal to the in-RAM build's, each build's
               seconds, the bytes on disk, the directory empty;
 13. scale   — a 2^31 + 2^26-base genome built in memory: eight N
               chromosomes up to 2^31 - 2^24 (sequence the time limit
               cannot index), then ~84 Mbp of phase 4's generator in
               three chromosomes, the first straddling 2^31; the spill
               build at slot_bits 27, the layout prepare_tables picks
               (row128), 65,536 reads with phase 4's mix (256 pinned
               across 2^31): the slice's checks, the correct fraction
               past 2^31, card = CPU Mapper on the first 1,024 reads;
               set-up seconds by stage, card bytes, peak host RSS.
Phase 3 also holds B5's row entry at the tier widths 4 and 8 and over a
table of 2^31 + 2^24 words (8.7 GB, freed before phase 4), and the seed
front with packed offsets whose obase passes 2^31.
Phase 14, mesh (after the scale phase): 14a, this process joins a
world of one rank over NCCL and a ShardedMapper at mesh 1 x 1 (routes
a2a and psum) maps phase 4's reads, equal to phase 4 in results, live
traceback records and SAM bytes; 14b, four rank processes share the card
over gloo with CUDA tensors (python3 chip_smoke.py --mesh-rank DIR,
started by the smoke with torchrun's environment): meshes 1 x 4 and
2 x 2 on both routes over phase 4's first 16,384 reads and phase 7's
first 2,048 pairs (row128 tables), and one a2a run at lane slack 0.3
(overflow rounds), each equal to the single-card runs, the kernels
launched on every rank and no plain call; each rank's collectives, a2a
rounds and bytes a batch and one profiled batch are printed; 14c, the
command line as processes on the card: data-parallel -map over 2 (the
merged body equals phase 10's) and -mesh 2x2 -route a2a over 4,
single-end and -reverse (the single-process records, in the ranks' row
order), with wall times and reads/s.
Phase 15, device_build (after phase 14): phase 4's index built on the
card (build_index's backend="device": k-mers extracted, hashed and
sorted with torch ops, no hand kernel) in one chunk, timed in turns with
the host build; in chunks of 2^23 words, merged in RAM; and through the
disk radix spill in chunks of 2^23 words, each equal to phase 4's host
build; one chunk on the card equal to the same on CPU tensors, numbered
past 2^31, at slot_bits 30 and 31; `-make_ufi -device_build` equal to
phase 10's directory byte for byte; one chunk of each size profiled by
stage (extract + hash, sort, trim, device → host copy).
Phase 16, repeats (after phase 15): a genome of chr21's length with 25%
repeat families (tools/accuracy.py's plant_repeat_families: SINE- and
LINE-like families, exact segmental duplications, tandem runs) from its
own stream, -make_ufi through cli.main; 65,536 simulate() reads
(tools/accuracy.py's, 150 bp, 1% SNPs, 10% with an indel) through the
default Mapper: the ROC by MAPQ (0, 1, 10, 20, 30, 40, 42), the weak,
suspect and clip-rescued counts (the gates fire, their caps hold), card
= CPU on the first 2,048 reads, one batch profiled; 4,096 FR pairs
through PairedMapper (card = CPU on 512, weak-capped mates counted);
-make_ufi -veryfast (auto + 2 slot_bits) over the genome's first
quarter (a cut: 27 bits, not the whole genome's 29) with a Mapper under
VERYFAST_MAP_OVERRIDES (B4 at 64 candidates a read, B5's row entry at
8) over 65,536 reads of the quarter (card = CPU on 2,048; its ROC beside
the quarter's default index's) and -map on that index equal to it;
second_pass_p 32 with the suspects it recovers.
The SAM writer raises on reads in tandem runs whose banded DP score the
host DP at POS does not reproduce, as urmap_tpu's does (ROADMAP C.3):
the phase counts them, holds card = CPU on which they are, writes them
unmapped where it compares SAM bytes and leaves them out of -map's
input.
Phase 3 also holds B4 at 64 candidates a read and B5's row entry at
positions_per_seed 8 over the aligned layout's 16-word rows, the
-veryfast path's shapes.
Phase 17, tools (after phase 16): the port's tools as a user calls
them (urmap_tpu_torch/tools/). (a) suspect_sweep over phase 16's index
(--index-cache, 65,536 reads, batch 16,384, 8 positions a seed), its
table printed, and its premise: a Mapper with the gate on gives the
MAPQs of the host's re-application at mismatch_equiv(6); (b)
a2a_rounds at 8 shards, 16 batches of 8,192 reads over that index (B3's
slots mode), and card = --cpu on 2 batches at the adaptive slack and at
URMAP_A2A_SLACK=0.3; (c) make_verify_corpus, then -map single-end and
-reverse through cli.main (counted) and python -m urmap_tpu_torch (the
same bodies), every plant at its POS and strand, the indel reads with I
or D, the junk unmapped, every mate placed and proper, the rescue pairs
placed, and the single-end body equal to a CPU run's; (d)
make_g38_corpus with 65,536 reads over phase 10's index of the setup
genome, -map single-end and -reverse, scored by tools/check_sam_truth.py
(run as a script), correct >= 0.99 over the reads whose planted span
holds no genome N; (e) bench_microvpu at the source's defaults (N
65,536, W 128, 10 iterations): kernel B8 (csrc/micro_passes.cu, the
Pallas kernel of tools/bench_microvpu.py) against the torch ops it
fuses, the two rows' sums equal to a numpy uint32 computation, its
launches counted under the path "microvpu". Phase 3 holds B8 against
its plain version at [65,536, 128], [1,000, 127] and [3, 1].
Then a "kernels" JSON line, the nvidia-smi name/power-limit line, and
the final {"ok": true, ...} line. Any failed check exits non-zero.
Scratch files go to build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHR21_LEN = 46_709_983          # GRCh38 chr21 (BASELINE.json config 3)
READ_LEN = 150
B = 16384                        # reads per batch (pairs: B // 2)
K, Q, P, V, HW, L_MAX = 24, 8, 16, 8, 16, 160
VERYFAST_P = 8                   # VERYFAST_MAP_OVERRIDES' positions_per_seed
TB_C = 2048                      # traceback lanes per batch (tb_cols)
RESCUE_W = 1200                  # MapConfig.rescue_window
N_CPU = 4096                     # reads mapped again on the CPU
N_CPU_PAIRS = 2048
# the shapes phase: band half-width 24, reads of 250-700 bases
SHAPES_HW, SHAPES_L, SHAPES_BATCH = 24, 704, 4096
N_SHAPES, N_SHAPES_CPU = 16384, 1024
# The card's peaks for the kernels' bounds (NVIDIA's H100 SXM data
# sheet): 3.35 TB/s of HBM; 67 TFLOP/s of float32 outside the tensor
# cores = 128 lanes per SM at 2 flops per FMA, and an SM has 64 lanes
# of int32 ALU (min and max, compare, select, logic), so 67e12 / 4 such
# instructions per second. Every kernel here is integer work, and its
# operations are counted as the instructions that pipe must take at the
# least: an add feeding a max is one (Hopper's VIADDMNMX), a three-input
# max is one, constants fold, and a plain add or shift-add is none,
# since it can issue as an IMAD on the FMA pipe beside them (as nvcc
# compiles these kernels). Counting those too, no kernel here comes
# near the issue limit of 128 lanes per SM and clock.
HBM_BYTES_PER_S = 3.35e12
INT32_INSTR_PER_S = 67e12 / 4


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, dev, reps: int = 7) -> float:
    """Median ms of ``reps`` synchronised runs after one warm run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(dev)
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    import torch

    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(w.shape)} {w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


# ---- phase 3: kernel vs plain version ---------------------------------

CLIP_TB_N = 8192                 # tb_cols of a 65,536-read batch


def clip_tb_inputs(rng, n: int):
    """The clip traceback's inputs at se150_adapters' shape: ``n`` lanes,
    a read block of L_MAX, reads of READ_LEN against a window from POS
    of L_MAX + 48 bases (windows, reads, lengths, widths). Reads with a
    65-75 base adapter tail, some with a random head, a 1-8 base indel,
    read N; some shorter reads, some windows cut short (the genome's
    end), and lanes of length 0, above the block and of width 0."""
    wl = L_MAX + 48
    g = rng.integers(0, 4, size=(n, wl + 16)).astype(np.uint8)
    g[rng.random(g.shape) < 0.002] = 4                      # genome N
    win = g[:, :wl].copy()
    reads = np.full((n, L_MAX), 5, np.uint8)
    lens = np.full(n, READ_LEN, np.int32)
    lens[1::16] = rng.integers(24, READ_LEN, size=len(lens[1::16]))
    widths = np.minimum(lens + 48, wl).astype(np.int32)
    widths[2::64] = rng.integers(1, READ_LEN, size=len(widths[2::64]))
    for i in range(n):
        ln = int(lens[i])
        r = g[i, : ln + 16].copy()
        kind = i % 6
        if kind == 1:                                       # deletion
            o, d = int(rng.integers(8, ln - 8)), int(rng.integers(1, 9))
            r = np.concatenate([r[:o], g[i, o + d : ln + 16]])
        elif kind == 2:                                     # insertion
            o, d = int(rng.integers(8, ln - 8)), int(rng.integers(1, 9))
            r = np.concatenate([r[:o], rng.integers(0, 4, d), r[o:]])
        r = r[:ln].astype(np.uint8)
        t = min(int(rng.integers(65, 76)), ln // 2)
        r[ln - t :] = rng.integers(0, 4, t)                 # adapter tail
        if kind == 3:
            r[: int(rng.integers(1, 30))] = rng.integers(0, 4)  # a head
        r[rng.random(ln) < 0.005] = 5                       # read N
        reads[i, :ln] = r
    lens[-3:] = [0, L_MAX + 5, READ_LEN]
    widths[-1] = 0
    return win, reads, lens, widths


def kernel_inputs(rng, n_reads: int, n_dp: int, n_clip: int):
    """Numpy inputs at the slice's shapes, with the awkward cases."""
    from urmap_tpu_torch.map.seed import SENTINEL, POS_BIAS

    # B3: 2B reads of L_MAX codes, 1% read-N, mixed lengths
    codes = rng.integers(0, 4, size=(n_reads, L_MAX)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 5
    lengths = np.full(n_reads, READ_LEN, np.int32)
    lengths[: n_reads // 8] = L_MAX
    lengths[n_reads // 8 : n_reads // 8 + 64] = rng.integers(0, K, 64)
    lengths[-32:] = 0
    codes[64:128] = 5                                       # all-N reads
    codes[np.arange(L_MAX)[None, :] >= lengths[:, None]] = 5

    # B4: biased-coordinate candidate starts with vote runs
    base = (-POS_BIAS + rng.integers(0, CHR21_LEN, size=(n_reads, 8))
            ).astype(np.int64)
    cand = base[np.arange(n_reads)[:, None],
                rng.integers(0, 8, size=(n_reads, Q * P))]
    cand = (cand + rng.integers(0, 2, size=cand.shape)).astype(np.int32)
    cand[rng.random(cand.shape) < 0.6] = SENTINEL
    cand[:256] = SENTINEL                                   # all invalid
    cand[256:512] = -POS_BIAS + 77                          # one run
    for i in range(512, 1024):                              # equal runs
        a, b2 = sorted(rng.integers(0, 10_000, size=2))
        cand[i] = SENTINEL
        cand[i, :5] = a - POS_BIAS
        cand[i, 5:10] = b2 + 1 - POS_BIAS
        cand[i, 10:15] = b2 + 3 - POS_BIAS

    def dp_inputs(n, tail_lo, tail_hi):
        wlen = L_MAX + 2 * HW
        g = rng.integers(0, 4, size=(n, wlen + 8)).astype(np.uint8)
        g[rng.random(g.shape) < 0.002] = 4                 # genome N
        win = g[:, :wlen].copy()
        shift = rng.integers(-HW + 1, HW, size=n)
        reads = np.full((n, L_MAX), 5, np.uint8)
        for i in range(n):
            s = HW + shift[i]
            r = g[i, s : s + L_MAX].copy()
            kind = i % 8
            if kind == 1:                                   # deletion
                o, d = rng.integers(8, 140), rng.integers(1, 9)
                r = np.concatenate([r[:o], g[i, s + o + d : s + L_MAX + d]])
            elif kind == 2:                                 # insertion
                o, d = rng.integers(8, 140), rng.integers(1, 9)
                r = np.concatenate([r[:o], rng.integers(0, 4, d), r[o:]])
            elif kind == 3:                                 # unrelated
                r = rng.integers(0, 4, L_MAX)
            r = r[:L_MAX].astype(np.uint8)
            if tail_hi:                                     # adapter tail
                t = rng.integers(tail_lo, tail_hi + 1)
                r[READ_LEN - t : READ_LEN] = rng.integers(0, 4, t)
            r[rng.random(L_MAX) < 0.01] = 5
            reads[i] = np.where(r == 4, 5, r)
        lens = np.full(n, READ_LEN, np.int32)
        lens[::16] = L_MAX
        lens[1::64] = rng.integers(0, K, len(lens[1::64]))
        lens[2::512] = 0
        reads[np.arange(L_MAX)[None, :] >= lens[:, None]] = 5
        return win, reads, lens

    def tb_inputs(n):
        """Winners re-anchored at POS: planted indels, anchors drifted
        until the path leaves the band, unrelated and all-N reads,
        lengths 0, 1, 159, 160; odd rows come as sequenced from the
        reverse strand (``strand`` 1: the device takes the reverse
        complement back, as tb_pass_device does)."""
        wlen = L_MAX + 2 * HW
        g = rng.integers(0, 4, size=(n, wlen + 64)).astype(np.uint8)
        g[rng.random(g.shape) < 0.002] = 4                 # genome N
        win = g[:, 24 : 24 + wlen].copy()
        reads = np.full((n, L_MAX), 5, np.uint8)
        lens = np.full(n, READ_LEN, np.int32)
        lens[::16] = L_MAX
        lens[5::128] = 0
        lens[6::128] = 1
        lens[7::128] = L_MAX - 1
        for i in range(n):
            kind = (i // 2) % 8
            s = 24 + HW                                     # POS in g
            if kind == 4:                                   # drifted anchor
                s += int(rng.choice([-1, 1]) * rng.integers(HW - 3, HW + 8))
            r = g[i, s : s + L_MAX + 24].copy()
            if kind in (1, 5, 7):                           # deletion
                o, d = rng.integers(8, 140), rng.integers(1, 9)
                r = np.concatenate([r[:o], r[o + d :]])
            if kind in (2, 5, 7):                           # insertion
                o, d = rng.integers(8, 140), rng.integers(1, 9)
                r = np.concatenate([r[:o], rng.integers(0, 4, d), r[o:]])
            if kind == 3:                                   # unrelated
                r = rng.integers(0, 4, L_MAX)
            r = r[:L_MAX].astype(np.uint8)
            r[rng.random(L_MAX) < 0.01] = 5
            if kind == 6:                                   # all-N read
                r[:] = 5
            reads[i] = np.where(r == 4, 5, r)
        reads[np.arange(L_MAX)[None, :] >= lens[:, None]] = 5
        strand = (np.arange(n) % 2).astype(np.int32)
        comp = np.array([3, 2, 1, 0, 4, 5], np.uint8)
        seq = reads.copy()                                  # as sequenced
        for i in np.nonzero(strand)[0]:
            seq[i, : lens[i]] = comp[reads[i, : lens[i]][::-1]]
        return win, seq, lens, strand

    def fetch_inputs(rows):
        """A [rows, 128] table (SENTINEL pads between short runs) and
        starts for the row entry (anywhere, past the end too) and the
        window entry (both ends, negative, past the end)."""
        table = rng.integers(-(1 << 31), 1 << 31, size=(rows, 128),
                             dtype=np.int64).astype(np.int32)
        table[rng.random(table.shape) < 0.05] = SENTINEL
        M = rows * 128

        def starts(n):
            st = rng.integers(0, M, size=n).astype(np.int64)
            st[:8] = [0, 127, 128, M - 1, M, M + 12345, M - 16, 1]
            return st

        def wstarts(n, width):
            st = 2 * rng.integers(0, M // 2, size=n).astype(np.int64)
            st[:8] = [0, M - width, M - width + 2, M, M + 999, -2, -4096,
                      126]
            return st

        return table, starts, wstarts

    def sg_inputs(n, G=8_000_000):
        """B1' inputs: a byte genome, candidates (the ends included) and
        reads drawn near them with indels, random tails and junk."""
        g = rng.integers(0, 4, size=G).astype(np.uint8)
        g[rng.random(G) < 0.002] = 4
        cand = rng.integers(0, G - L_MAX - 64, size=n).astype(np.int32)
        cand[:8] = [0, 3, -5, -HW - 40, G - L_MAX, G - 20, G + 100, 1]
        reads = np.full((n, L_MAX), 5, np.uint8)
        lens = np.full(n, READ_LEN, np.int32)
        lens[::16] = L_MAX
        lens[1::64] = rng.integers(0, K, len(lens[1::64]))
        lens[2::512] = 0
        shift = rng.integers(-HW + 1, HW, size=n)
        for i in range(n):
            s = int(np.clip(int(cand[i]) + shift[i], 0, G - L_MAX - 16))
            r = g[s : s + L_MAX + 8].copy()
            kind = i % 8
            if kind == 1:
                o, d = rng.integers(8, 140), rng.integers(1, 9)
                r = np.concatenate([r[:o], r[o + d :]])
            elif kind == 2:
                o, d = rng.integers(8, 140), rng.integers(1, 9)
                r = np.concatenate([r[:o], rng.integers(0, 4, d), r[o:]])
            elif kind == 3:
                r = rng.integers(0, 4, L_MAX)
            elif kind == 4:
                t = rng.integers(30, 76)
                r[READ_LEN - t : READ_LEN] = rng.integers(0, 4, t)
            r = r[:L_MAX].astype(np.uint8)
            reads[i] = np.where(r == 4, 5, r)
        reads[np.arange(L_MAX)[None, :] >= lens[:, None]] = 5
        return g, cand, reads, lens

    return {"codes": codes, "lengths": lengths, "cand": cand,
            "dp": dp_inputs(n_dp, 0, 0), "clip": dp_inputs(n_clip, 30, 50),
            "tb": tb_inputs(TB_C), "tb_few": tb_inputs(TB_C // 16),
            "tb_many": tb_inputs(8 * TB_C), "fetch": fetch_inputs(1 << 18),
            "sg": sg_inputs(n_dp)}


def nbytes(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def shape_dp_inputs(rng, n: int, L: int, hw: int):
    """numpy (windows, reads, lengths) for B1, B6 and B7 at any band
    half-width and read block: reads drawn from their windows at a band
    offset, with a deletion or an insertion of up to min(hw, 24) bases,
    unrelated and all-N reads, 1% read-N, genome N, and the lengths that
    pin the edges (0, 1, L - 1, L) among L and L - 10 (vectorised)."""
    wlen = L + 2 * hw
    g = rng.integers(0, 4, size=(n, wlen + 32)).astype(np.uint8)
    g[rng.random(g.shape) < 0.002] = 4
    win = g[:, :wlen].copy()
    col = np.arange(L)[None, :]
    start = hw + rng.integers(-(hw // 2), hw // 2 + 1, size=n)[:, None]
    o = rng.integers(4, max(L - 8, 5), size=n)[:, None]
    d = rng.integers(1, max(min(hw, 24), 1) + 1, size=n)[:, None]
    kind = np.arange(n)[:, None] % 8
    src = start + col
    src = np.where((kind == 1) & (col >= o), src + d, src)      # deletion
    src = np.where((kind == 2) & (col >= o), src - d, src)      # insertion
    reads = np.take_along_axis(g, np.clip(src, 0, wlen + 31), 1)
    junk = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    ins = (kind == 2) & (col >= o) & (col < o + d)
    reads = np.where(ins | (kind == 3), junk, reads)            # unrelated
    reads = np.where(reads == 4, 5, reads)
    reads[rng.random(reads.shape) < 0.01] = 5
    reads[kind[:, 0] == 6] = 5                                   # all-N
    lens = np.full(n, L, np.int32)
    lens[1::3] = L - 10
    lens[::61] = np.resize([0, 1, L - 1, L], len(lens[::61]))
    reads[col >= lens[:, None]] = 5
    return win, reads.astype(np.uint8), lens


def vote_inputs(rng, n: int, m: int):
    """int32[n, m] biased candidate starts with vote runs, as phase 3's
    B4 case at 128, with all-invalid, one-run and equal-run rows."""
    from urmap_tpu_torch.map.seed import SENTINEL, POS_BIAS

    base = (-POS_BIAS + rng.integers(0, CHR21_LEN, size=(n, 8))
            ).astype(np.int64)
    cand = base[np.arange(n)[:, None], rng.integers(0, 8, size=(n, m))]
    cand = (cand + rng.integers(0, 2, size=cand.shape)).astype(np.int32)
    cand[rng.random(cand.shape) < 0.6] = SENTINEL
    cand[:256] = SENTINEL
    cand[256:512] = -POS_BIAS + 77
    k = m // 3
    cand[512:1024] = SENTINEL
    cand[512:1024, :k] = -POS_BIAS + 5
    cand[512:1024, k : 2 * k] = -POS_BIAS + 9
    return cand


def front_tables(rng, slot_bits: int, dev):
    """A CSR offsets table of 2^slot_bits slots with 0-4 entries each, as
    uint32 bit patterns on ``dev``, and its packed row128 form
    (index.store.pack_offsets_row128 at P = 16)."""
    import torch

    from urmap_tpu_torch._bits import as_i32
    from urmap_tpu_torch.index.store import pack_offsets_row128

    S = 1 << slot_bits
    off = np.zeros(S + 1, np.uint32)
    np.cumsum(rng.integers(0, 5, size=S, dtype=np.uint8), dtype=np.uint32,
              out=off[1:])
    pk = pack_offsets_row128(off, P)
    check(pk is not None, "the synthetic offsets do not pack")

    def put(a):
        return torch.from_numpy(as_i32(a)).to(dev)

    return {"plain": (put(off), None, (0, 0)),
            "packed": (put(pk["opacked"]), put(pk["obase"]),
                       (pk["cnt_bits"], pk["block_bits"]))}


def fits16(L: int, hw: int, cells: int, sc) -> bool:
    """Whether plain-mode values over ``cells`` band cells stay inside
    int16 (csrc/banded_dp.cu fits16): where they do, the least work takes
    two cells an instruction."""
    S = 2 * hw + 2
    m, x, o, e = sc.match, sc.mismatch, sc.gap_open, sc.gap_extend
    if not (m > x and m >= 0 and x <= 0 and o <= 0 and e < 0):
        return False
    if ((x - 2 * e) * S < 0) != ((m - 2 * e) * S < 0):
        return False
    ext, opn = -e * S, -o * S
    lo = -((L + 2) * -x * S + 2 * opn + ext)
    hi = (L + 2) * m * S + S + opn + (2 * L + cells + 2) * ext
    return lo > -32768 and hi < 32767


def shape_cases(dev, rng, n_reads: int, sc) -> dict:
    """Phase 3's cases of the shapes the card takes since the seed front
    and the band half-widths, long reads and candidate counts past the
    default: name → (kernel, plain version, inputs, integer instructions
    [, bytes]), as in phase_kernels."""
    import torch

    from urmap_tpu_torch import genome_pack as gpk
    from urmap_tpu_torch.kernels import banded_dp, seed_slots, tb_dp, vote
    from urmap_tpu_torch.map import dp as dpmod
    from urmap_tpu_torch.map import seed as seedmod
    from urmap_tpu_torch.map import tb as tbmod

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = {}
    # B1 (both modes) and B1' at hw 12, 24, 40 (the runtime body), B1 at
    # L = 700 and 2,000 (fewer candidates a block), with the cell counts
    # of phase_kernels: plain mode 3 per cell in 16-bit pairs wherever
    # fits16 holds over the band's own cells (hw 12 and 24 at L_MAX), else
    # 6 in 32 bits; clip mode 7.5.
    for name, hw, L, clip in (("hw12", 12, L_MAX, False),
                              ("hw24", 24, L_MAX, False),
                              ("hw40", 40, L_MAX, False),
                              ("hw12_clip", 12, L_MAX, True),
                              ("hw24_clip", 24, L_MAX, True),
                              ("hw40_clip", 40, L_MAX, True),
                              ("L700", HW, 700, False),
                              ("L2000", HW, 2000, False)):
        w, r, ln = (put(a) for a in shape_dp_inputs(rng, n_reads, L, hw))
        co = sc.clip_open if clip else None
        rows = int(ln.clamp(0, L).sum())
        cells = 2 * hw + 1
        per_cell = 7.5 if clip else (3 if fits16(L, hw, cells, sc) else 6)
        cases[f"banded_dp_{name}"] = (
            lambda w=w, r=r, ln=ln, hw=hw, co=co: banded_dp.banded_from_windows(
                w, r, ln, hw=hw, sc=sc, clip_open=co),
            lambda w=w, r=r, ln=ln, hw=hw, co=co: dpmod.banded_from_windows(
                w, r, ln, hw=hw, sc=sc, clip_open=co),
            (w, r, ln), rows * (cells * per_cell + 3))
        if L == L_MAX and not clip:
            # B1' over a byte genome holding these windows end to end
            g = w.reshape(-1)
            cand = (torch.arange(n_reads, dtype=torch.int32, device=dev)
                    * (L + 2 * hw) + hw)
            cases[f"banded_semiglobal_{name}"] = (
                lambda g=g, c=cand, r=r, ln=ln, hw=hw:
                    banded_dp.banded_semiglobal(g, c, r, ln, hw=hw, sc=sc),
                lambda g=g, c=cand, r=r, ln=ln, hw=hw:
                    dpmod.banded_semiglobal(g, c, r, ln, hw=hw, sc=sc),
                (g, cand, r, ln), rows * (cells * per_cell + 3 + 2 + 4)
                + n_reads * cells * 2,
                n_reads * ((L + 2 * hw) + L + 4 + 4 + 16))
    # B6 and B7 at hw 12, 24, 31 (the runtime body's variants), B6 at L =
    # 700 and 2,000; 15 per cell as in phase_kernels (B6: the rows below
    # each length and ~12 a row for the walk; B7: all L rows)
    for name, hw, L in (("hw12", 12, L_MAX), ("hw24", 24, L_MAX),
                        ("hw31", 31, L_MAX), ("L700", HW, 700),
                        ("L2000", HW, 2000)):
        args = tuple(put(a) for a in shape_dp_inputs(rng, TB_C, L, hw))
        cells = 2 * hw + 1
        cases[f"tb_dops_{name}"] = (
            lambda a=args, hw=hw: tb_dp.tb_dops_from_windows(*a, hw=hw, sc=sc),
            lambda a=args, hw=hw: tbmod.tb_dops_from_windows(*a, hw=hw,
                                                             sc=sc),
            args, int(args[2].clamp(0, L).sum()) * (cells * 15 + 12))
        if L == L_MAX:
            cases[f"tb_bits_{name}"] = (
                lambda a=args, hw=hw: tb_dp.tb_from_windows(*a, hw=hw, sc=sc),
                lambda a=args, hw=hw: tbmod.tb_from_windows(*a, hw=hw, sc=sc),
                args, TB_C * L * cells * 15)
    # B4 at Q x P = 64 (the -veryfast path's 8 x VERYFAST_P, the register
    # body), 256 and 2,048 (the shared-memory body): the bitonic
    # network's s (s + 1) / 2 stages of MP / 2 compare-exchanges (2
    # each), a head test per value, V maxima over MP keys in three-input
    # maxima
    for m in (Q * VERYFAST_P, 256, 2048):
        c = put(vote_inputs(rng, n_reads, m))
        lg = m.bit_length() - 1
        cases[f"vote_m{m}"] = (
            lambda c=c: vote.vote(c, v=V),
            lambda c=c: seedmod.vote_top_candidates(c, v=V), (c,),
            n_reads * (lg * (lg + 1) // 2 * m + m + V * m // 2))
    # the seed front at the path's shapes: B = n_reads / 2 forward reads
    # from their upload blocks → 2B read-strands x Q seeds, over a table
    # of 2^27 slots (the slice's), in both offsets forms. Per read: ~15
    # instructions a forward word (byte merge, Morton spread, tail mask),
    # ~55 a reverse-complement word (word select, two funnels, two lane
    # reversals, complement and masks), and per seed B3's 40 and 4 for
    # the decode; bytes: the upload and lengths in, the words, seeds and
    # runs out, and two table words a seed.
    codes = rng.integers(0, 4, size=(n_reads // 2, L_MAX)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 5
    lens = np.full(n_reads // 2, READ_LEN, np.int32)
    lens[::9] = np.resize([0, 5, K, L_MAX], len(lens[::9]))
    codes[np.arange(L_MAX)[None, :] >= lens[:, None]] = 5
    pk, nm = (put(a) for a in gpk.pack_read_codes_host(codes))
    fl = put(lens)
    nw = -(-L_MAX // 16)
    tabs = front_tables(rng, 27 if n_reads >= 2 * B else 20, dev)
    # the packed offsets of a table past 2^31 words: the same deltas over
    # block bases raised by 2^31 (uint32), so every decoded start passes
    # 2^31 and must come out as a uint32 value
    off, ob, bits = tabs["packed"]
    tabs["packed_past_2^31"] = (off, (ob.long() + (1 << 31)).to(torch.int32),
                                bits)
    for name, key in (("seed_front", "plain"),
                      ("seed_front_packed", "packed"),
                      ("seed_front_obase_past_2^31", "packed_past_2^31")):
        off, ob, (cb, bb) = tabs[key]
        kw = dict(k=K, q=Q, slot_bits=27 if n_reads >= 2 * B else 20,
                  offsets=off, obase=ob, cnt_bits=cb, block_bits=bb)
        nr = n_reads // 2
        cases[name] = (
            lambda kw=kw: seed_slots.seed_front(pk, nm, fl, L_MAX, **kw),
            lambda kw=kw: seedmod.seed_front_plain(pk, nm, fl, L_MAX, **kw),
            (pk, nm, fl), nr * (nw * (15 + 55) + 2 * Q * 44),
            nbytes((pk, nm, fl)) + nr * (2 * nw * 4 * 2 + 2 * Q * 17)
            + nr * 2 * Q * 8)
    # the slots mode (the sharded routes' front) on the same reads: no
    # offsets table and no decode (B3's 40 a seed); out the words and per
    # seed the slot, offs and valid (9 bytes)
    kw = dict(k=K, q=Q, slot_bits=27 if n_reads >= 2 * B else 20,
              offsets=None)
    nr = n_reads // 2
    cases["seed_front_slots"] = (
        lambda: seed_slots.seed_front(pk, nm, fl, L_MAX, **kw),
        lambda: seedmod.seed_front_plain(pk, nm, fl, L_MAX, **kw),
        (pk, nm, fl), nr * (nw * (15 + 55) + 2 * Q * 40),
        nbytes((pk, nm, fl)) + nr * (2 * nw * 4 * 2 + 2 * Q * 9))
    return cases


def phase_kernels(dev, rng, n_reads: int, n_dp: int, n_clip: int) -> dict:
    """Each kernel against its plain version on ``dev`` → per-kernel
    records: max_abs_err, ms, plain_ms and the bound. ``bound_ms`` is
    the larger of the bytes the function must move (each input read
    once, each output written once; for the table fetches the words
    these starts use, not the whole table) over the HBM rate and the
    int32 ALU instructions these inputs need at the least over that
    pipe's rate; the counts per unit of work are stated beside each
    case. ``library_ms`` times the nearest single PyTorch call for the
    three plain entries of B5 (an indexed ``unfold`` view,
    ``torch.gather``); it is None elsewhere: no single PyTorch call
    computes the seed slots, the vote, the banded DP, the traceback DP,
    a fused fetch (its plain version is ~40 to ~70 calls) or B8's rounds
    (some 120 calls)."""
    import torch

    from urmap_tpu_torch import _bits
    from urmap_tpu_torch.config import ScoreConfig
    from urmap_tpu_torch import genome_pack as gpk
    from urmap_tpu_torch.kernels import banded_dp, lane_rotate, tb_dp, vote
    from urmap_tpu_torch.map import dp as dpmod
    from urmap_tpu_torch.map import seed as seedmod
    from urmap_tpu_torch.map import tb as tbmod

    sc = ScoreConfig()
    x = kernel_inputs(rng, n_reads, n_dp, n_clip)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pk, nm = gpk.pack_read_codes_host(x["codes"])
    lens = put(x["lengths"])
    nw = -(-L_MAX // 16)
    rp, rn = gpk.read_words_from_upload(put(pk), put(nm), lens, nw)
    cand = put(x["cand"])
    W = 2 * HW + 1
    # name → (kernel, plain version, input tensors, integer instructions
    # [, bytes where they are not the inputs' and outputs' sizes])
    cases = {
        # per read, the least the function needs whatever computes it:
        # the 28-stage bitonic network's 64 compare-exchanges a stage
        # (min and max: 2), a head test per value (1 x 128) and V maxima
        # over 128 keys in three-input maxes (64 each)
        "vote": (lambda: vote.vote(cand, v=V),
                 lambda: seedmod.vote_top_candidates(cand, v=V), (cand,),
                 n_reads * (28 * 64 * 2 + 128 + V * 64)),
    }
    # per band cell and read row: E (add+max), the substitution
    # (compare, select), T (add+max), the running max (add+max), H over
    # F (add+max): 6 (and one plain add), plus 3 per row; the rows stop
    # at the read's length. Clip mode adds the fresh start (add+max) and
    # its share of the row maximum in three-input maxes (1/2): 7.5.
    # Plain mode's values fit 16 bits at these shapes, and the same
    # instructions take two cells at once in their s16x2 forms: 3.
    for name, key, clip, per_cell in (("banded_dp", "dp", None, 3),
                                      ("banded_dp_clip", "clip",
                                       sc.clip_open, 7.5),
                                      ("banded_dp_clip_n32768", "dp",
                                       sc.clip_open, 7.5)):
        w, r, ln = (put(a) for a in x[key])
        rows = int(ln.clamp(0, L_MAX).sum())
        cases[name] = (
            lambda w=w, r=r, ln=ln, clip=clip: banded_dp.banded_from_windows(
                w, r, ln, hw=HW, sc=sc, clip_open=clip),
            lambda w=w, r=r, ln=ln, clip=clip: dpmod.banded_from_windows(
                w, r, ln, hw=HW, sc=sc, clip_open=clip),
            (w, r, ln), rows * (W * per_cell + 3))
    # B1': B1's cells, a clamp (min, max: 2) for each window byte it
    # loads (W + one per row) and for each base of the ungapped
    # re-read, whose compare and select add 2 more per row. It must
    # read L + 2*hw genome bytes per candidate, not the whole genome.
    g, sg_cand, sg_reads, sg_lens = (put(a) for a in x["sg"])
    sg_rows = int(sg_lens.clamp(0, L_MAX).sum())
    sg_n = sg_cand.shape[0]
    sg_bytes = sg_n * ((L_MAX + 2 * HW) + L_MAX + 4 + 4 + 16)
    for name, clip, per_cell in (("banded_semiglobal", None, 3),
                                 ("banded_semiglobal_clip", sc.clip_open,
                                  7.5)):
        cases[name] = (
            lambda clip=clip: banded_dp.banded_semiglobal(
                g, sg_cand, sg_reads, sg_lens, hw=HW, sc=sc, clip_open=clip),
            lambda clip=clip: dpmod.banded_semiglobal(
                g, sg_cand, sg_reads, sg_lens, hw=HW, sc=sc, clip_open=clip),
            (g, sg_cand, sg_reads, sg_lens),
            sg_rows * (W * per_cell + 3 + 2 + 4) + sg_n * W * 2, sg_bytes)
    # B5 computes nothing: bytes. One thread per output word reads only
    # the words it keeps, so the function must move the starts, every
    # used word once in and once out. ``rows_touched`` (the 512-byte
    # table rows these starts reach) is information only. ``library``
    # holds the one PyTorch call that comes closest to each entry, timed
    # as library_ms and used nowhere in the port: an indexed ``unfold``
    # view for the fetches (its index clamped beforehand; the row entry's
    # SENTINEL fill past a row's end left out), ``torch.gather`` with the
    # index made beforehand for the rotate.
    table_np, starts_of, wstarts_of = x["fetch"]
    table = put(table_np)
    R = table.shape[0]
    fetch_shapes = {}
    library = {}

    def fetch_case(name, width, st, window):
        n = st.shape[0]
        if window:
            s = st.clamp(0, R * 128 - width)
            rows = (s >> 7)[:, None] + torch.arange(
                -(-width // 128) + 1, device=dev)[None, :]
            touched = torch.unique(
                rows[rows <= ((s + width - 1) >> 7)[:, None]]).numel()
            used = n * width
            kern, plain = (lane_rotate.row128_window_fetch,
                           gpk.row128_window_fetch)
        else:
            s = st.clamp(max=R * 128 - width)
            touched = torch.unique((st >> 7).clamp(max=R - 1)).numel()
            used = int((128 - (st & 127)).clamp(max=width).sum())
            kern, plain = lane_rotate.row128_fetch, seedmod._row128_fetch
        cases[name] = (lambda: (kern(table, st, width),),
                       lambda: (plain(table, st, width),), (table, st), 0,
                       n * 8 + used * 4 + n * width * 4)
        views = table.view(-1).unfold(0, width, 1)
        library[name] = lambda: (views[s],)
        if window:
            check(torch.equal(views[s], plain(table, st, width)),
                  f"{name}: the library call differs from the plain version")
        fetch_shapes[name] = {"width": width, "rows_touched": touched,
                              "used_words_read": used}

    # the CSR fetch: one start per (read, seed), P entries each
    fetch_case("row128_fetch", P, put(starts_of(n_reads * Q)), False)
    # the verify window (2*(nw+1) words, a capacity round of the 2B*V
    # candidates), the DP window and the mate-rescue window (B/2 pairs,
    # B/2/32 rescue lanes)
    w_verify = 2 * (nw + 1)
    w_dp = 2 * (-(-(L_MAX + 2 * HW) // 16) + 1)
    w_rescue = 2 * (-(-RESCUE_W // 16) + 1)
    fetch_case("row128_window_fetch", w_verify,
               put(wstarts_of(n_reads * V // 8, w_verify)), True)
    fetch_case(f"row128_window_fetch_w{w_dp}", w_dp,
               put(wstarts_of(n_dp, w_dp)), True)
    fetch_case(f"row128_window_fetch_w{w_rescue}", w_rescue,
               put(wstarts_of(max(n_reads // 4 // 32, 1), w_rescue)), True)
    # the literal rotate on gathered rows, at the DP window's shape: an
    # add and a wrap per output word; it must move the offsets and the
    # used words of each row, once in and once out
    rot_rows = table[: n_dp].repeat(1, 2).contiguous()
    rot_off = put(rng.integers(0, 128, size=n_dp).astype(np.int32))
    rot_idx = (rot_off.long()[:, None]
               + torch.arange(w_dp, device=dev)[None, :]) % rot_rows.shape[1]
    cases["rotate_narrow"] = (
        lambda: (lane_rotate.rotate_narrow(rot_rows, rot_off, w_dp),),
        lambda: (lane_rotate.rotate_narrow_plain(rot_rows, rot_off, w_dp),),
        (rot_rows, rot_off), n_dp * w_dp * 2,
        n_dp * 4 + 2 * n_dp * w_dp * 4)
    library["rotate_narrow"] = lambda: (torch.gather(rot_rows, 1, rot_idx),)
    check(torch.equal(torch.gather(rot_rows, 1, rot_idx),
                      lane_rotate.rotate_narrow_plain(rot_rows, rot_off,
                                                      w_dp)),
          "rotate_narrow: the library call differs from the plain version")
    # The fused fetches over the interleaved genome planes: a 1-D table
    # (the aligned layout's) and its [R, 128] view (row128), base starts
    # as int32 on the one and int64 on the other. The plain version is
    # the window entry's plain version followed by the array ops, which
    # the entry must equal on every lane: starts before the table, in
    # the guard words and past its end are among them. Bytes: the
    # starts, the table words under the window's bases, the read's words
    # and length for the mismatch count; the codes or counts out.
    ginter_np, base_off = gpk.pack_genome(x["sg"][0])
    ginter = put(_bits.as_i32(ginter_np))
    n_bases = x["sg"][0].shape[0]
    tables = {"": ginter, "_row128": ginter.view(-1, 128)}

    def base_starts(n, length, dtype):
        st = rng.integers(0, n_bases - length, size=n)
        st[:12] = [0, 15, 16, -1, -16, -17, -5000, n_bases - 7,
                   n_bases + 3000, n_bases + 10_000_000, 2**31 - 5000,
                   -(2**31)]
        return put(st.astype(dtype))

    def used_words(st, lens):
        """Table words under bases [start, start + len) of each row."""
        r = st.long() % 16
        return int((2 * ((r + lens.long() + 15) // 16)).sum())

    def codes_case(name, n, length, table, dtype):
        st = base_starts(n, length, dtype)
        cases[name] = (
            lambda: (lane_rotate.window_codes(table, base_off, st, length),),
            lambda: (gpk.gather_codes_plain(table, base_off, st, length,
                                            fetch=gpk.row128_window_fetch),),
            (table, st), 0,
            nbytes((st,)) + 4 * used_words(st, torch.full_like(st, length))
            + n * length)

    mm_n = n_reads * V // 8
    mm_sel = torch.arange(mm_n, device=dev) % n_reads
    mm_rp, mm_rn, mm_len = rp[mm_sel], rn[mm_sel], lens[mm_sel]
    for suffix, table in tables.items():
        dtype = np.int64 if suffix else np.int32
        codes_case("window_codes" + suffix, n_dp, L_MAX + 2 * HW, table,
                   dtype)
        st = base_starts(mm_n, L_MAX, dtype)
        cases["window_mismatches" + suffix] = (
            lambda table=table, st=st: (lane_rotate.window_mismatches(
                table, base_off, st, mm_rp, mm_rn, mm_len),),
            lambda table=table, st=st: (gpk.mismatch_counts_plain(
                table, base_off, st, mm_rp, mm_rn, mm_len,
                fetch=gpk.row128_window_fetch),),
            (table, st), 0,
            nbytes((st, mm_rp, mm_rn, mm_len))
            + 4 * used_words(st, mm_len.clamp(0, 16 * nw)) + mm_n * 4)
    codes_case(f"window_codes_w{RESCUE_W}", max(n_reads // 4 // 32, 1),
               RESCUE_W, tables["_row128"], np.int32)
    # traceback DP, per band cell and read row: E (add+max) and the ee
    # compare 2; the substitution 2; T (max; diag is compared again, so
    # its add stays plain) 1; the running max (add+max) and H (max) 2;
    # the fe compare 1; hc (2 compares, 2 selects) 4; the nibble (2
    # selects, merge) 3: 15 (and five plain adds: 20 issued). B7 runs
    # all L rows, its output holds them; B6 needs only the rows below
    # each length, and its walk ~12 more per such row.
    def tb_args(key):
        win, seq, ln, strand = (put(a) for a in x[key])
        srp, srn = gpk.pack_reads(seq, ln, nw)
        rrp, rrn = gpk.revcomp_words(srp, srn, ln, L_MAX)
        st1 = (strand == 1)[:, None]
        return win, gpk.unpack_words_to_codes(
            torch.where(st1, rrp, srp), torch.where(st1, rrn, srn),
            L_MAX), ln

    # B6 at the path's 2,048 lanes, at the least tb_cols (128) and at
    # 16,384
    for name, key in (("tb_dops", "tb"), ("tb_dops_n128", "tb_few"),
                      ("tb_dops_n16384", "tb_many")):
        args = tb_args(key)
        cases[name] = (
            lambda args=args: tb_dp.tb_dops_from_windows(*args, hw=HW, sc=sc),
            lambda args=args: tbmod.tb_dops_from_windows(*args, hw=HW, sc=sc),
            args, int(args[2].clamp(0, L_MAX).sum()) * (W * 15 + 12))
    win, tb_reads, ln = tb_args("tb")
    cases["tb_bits"] = (
        lambda: tb_dp.tb_from_windows(win, tb_reads, ln, hw=HW, sc=sc),
        lambda: tbmod.tb_from_windows(win, tb_reads, ln, hw=HW, sc=sc),
        (win, tb_reads, ln), TB_C * L_MAX * W * 15)
    cases.update(shape_cases(dev, rng, n_reads, sc))

    # The row entry as the tiered gather's first pass runs it: the 1-D
    # (aligned) table at width = row_words = 4 and 8, one start a seed
    # (2B x Q); beside it ``row128_fetch`` above, the untiered width 16.
    # Then a [R, 128] table of 2^31 + 2^24 words (8.7 GB, a human
    # genome's row128 positions) filled on the card from this phase's
    # generator, a third of the starts past 2^31 and some in the last
    # row. Bytes: the starts, the used words and the output.
    def row_case(name, tab, st, width, rw):
        n, M = st.shape[0], tab.numel()
        s = st & 0xFFFF_FFFF
        used = int((rw - s % rw).clamp(max=width).sum())
        cases[name] = (
            lambda: (lane_rotate.row128_fetch(tab, st, width, row_words=rw),),
            lambda: (seedmod._aligned_rows_fetch(tab.reshape(-1), st, width,
                                                 rw),),
            (tab, st), 0, n * 8 + used * 4 + n * width * 4)
        views = tab.view(-1).unfold(0, width, 1)
        sk = s.clamp(max=M - width)
        library[name] = lambda: (views[sk],)
        fetch_shapes[name] = {"width": width, "row_words": rw,
                              "table_words": M, "used_words_read": used}

    tier_starts = put(starts_of(n_reads * Q))
    for t in (4, 8):
        row_case(f"row128_fetch_tier{t}", table.view(-1), tier_starts, t, t)
    # the row entry as the -veryfast path runs it (positions_per_seed
    # VERYFAST_P over the aligned layout's rows of align_row_words(8) = 16
    # words): one start a seed, 2B x Q
    row_case(f"row128_fetch_p{VERYFAST_P}", table.view(-1), tier_starts,
             VERYFAST_P, seedmod.align_row_words(VERYFAST_P))
    M2 = (1 << 31) + (1 << 24)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 62)))
    big = torch.randint(-(1 << 31), (1 << 31) - 1, (M2 // 128, 128),
                        dtype=torch.int32, device=dev, generator=gen)
    nb = n_reads * Q
    st = rng.integers(0, M2, size=nb)
    st[: nb // 3] = rng.integers(1 << 31, M2, size=nb // 3)
    st[-64:] = rng.integers(M2 - 128, M2, size=64)
    st[:6] = [(1 << 31) - 1, 1 << 31, (1 << 31) + 127, M2 - 1, M2 - 16, 0]
    big_starts = put(st.astype(np.int64))
    row_case("row128_fetch_past_2^31", big, big_starts, P, 128)
    fetch_shapes["row128_fetch_past_2^31"]["starts_past_2^31"] = int(
        (big_starts >= (1 << 31)).sum())
    # B8, the micro-benchmark's kernel (tools/bench_microvpu.py; no
    # mapping path runs it), drawn last so that the cases above keep
    # their inputs: the tool's [65,536, 128], then 1,000 rows (a tail no
    # 2,048-row block covers) of an odd width, and three words. Per word
    # and round two int32 ALU instructions (the shift and the xor; the
    # multiply and the add fold into one IMAD); bytes: the words in and
    # out. No single PyTorch call computes it.
    from urmap_tpu_torch.kernels import micro

    for name, shape in (("micro_passes", (65_536, 128)),
                        ("micro_passes_1000x127", (1000, 127)),
                        ("micro_passes_3x1", (3, 1))):
        mx = put(rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
                 .view(np.int32))
        cases[name] = (lambda mx=mx: (micro.passes(mx),),
                       lambda mx=mx: (micro.plain_passes(mx),), (mx,),
                       2 * micro.PASSES * mx.numel())
    # The clip traceback (no TPU kernel: the reference's host clip DP) at
    # se150_adapters' shape, drawn after B8. Per cell of the full window
    # (length x (width + 1)): E (add+max) and the ee compare 2; the
    # substitution (compare, select) 2; T 1; the deletion chain's running
    # max (add+max) and F (add+max) 2; H 1; hc (2 compares, 2 selects) 4;
    # the fe compare 1; the nibble (shift-or, merge) 2; the end-clip scan
    # (a compare, its selects fold into it) 1: 16; the walk ~12 a row.
    from urmap_tpu_torch.kernels import clip_tb
    from urmap_tpu_torch.map import clip_tb as clipmod

    cw, cr, cl, cwid = (put(a) for a in clip_tb_inputs(rng, CLIP_TB_N))
    live = (cl >= 1) & (cl <= L_MAX) & (cwid >= 1)
    cells = int(torch.where(live, cl.long() * (cwid.long() + 1), 0).sum())
    cases["clip_tb"] = (
        lambda: clip_tb.clip_tb(cw, cr, cl, cwid, sc=sc,
                                clip_open=sc.clip_open),
        lambda: clipmod.clip_tb_from_windows(cw, cr, cl, cwid, sc=sc,
                                             clip_open=sc.clip_open),
        (cw, cr, cl, cwid),
        cells * 16 + int(torch.where(live, cl, 0).sum()) * 12)
    recs = {}
    for name, (kern, plain, inputs, ops, *moved) in cases.items():
        got = kern()
        t0 = time.perf_counter()
        want = plain()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        plain_s = time.perf_counter() - t0
        err = max_abs_err(got, want)
        nb = moved[0] if moved else nbytes(inputs + tuple(got))
        by_bytes = nb / HBM_BYTES_PER_S * 1e3
        by_ops = ops / INT32_INSTR_PER_S * 1e3
        rec = {"max_abs_err": err, "ms": time_ms(kern, dev),
               # a plain version of seconds is timed once, not seven times
               "plain_ms": time_ms(plain, dev, 7 if plain_s < 1.0 else 1),
               "bound_ms": max(by_bytes, by_ops),
               "bound_by": "bytes" if by_bytes > by_ops else "operations",
               "library_ms": time_ms(library[name], dev)
               if name in library else None, "n": int(got[0].shape[0]),
               **fetch_shapes.get(name, {})}
        if name.startswith("banded_"):
            s = want[0]
            rec["negative_scores"] = int((s < 0).sum())
        if name in ("banded_dp", "banded_dp_clip"):
            # the same call with no rows to run: the host's enqueue, the
            # staging, the bit planes and the outputs
            no_rows = (inputs[0], inputs[1], torch.zeros_like(inputs[2]),
                       sc.clip_open if name.endswith("_clip") else None)
            rec["ms_no_rows"] = time_ms(
                lambda a=no_rows: banded_dp.banded_from_windows(
                    *a[:3], hw=HW, sc=sc, clip_open=a[3]), dev)
        if name.startswith("banded_semiglobal"):
            rec["gapped"] = int((want[2] < want[0]).sum())
        if name == "clip_tb":
            rec["ok"] = int(want[2].sum())
            # lanes whose records hold an S row: a start or an end clip
            s_rows = torch.zeros_like(want[1], dtype=torch.bool)
            for b in range(4):
                s_rows |= ((want[1] >> (8 * b + 7)) & 1).bool()
            rec["clipped"] = int(s_rows.any(0).sum())
        if name.startswith("tb_dops"):
            rec["walk_ok"] = int(want[2].sum())
            rec["gapped"] = int((want[1] & 0x7F7F7F7F).ne(0).any(0).sum())
        recs[name] = rec
        check(err == 0, f"{name}: kernel differs from plain (max abs err "
              f"{err})")
    return recs


# ---- phase 4: the slice -----------------------------------------------

def make_genome(rng, n: int) -> np.ndarray:
    """Random ACGT codes with a few N runs (a long leading one, as on
    chr21, and short interior ones)."""
    g = rng.integers(0, 4, size=n, dtype=np.uint8)
    g[: 500_000] = 4
    for s in rng.integers(1_000_000, n - 1_000_000, size=6):
        g[s : s + int(rng.integers(1_000, 100_000))] = 4
    return g


def write_fasta(path: str, codes: np.ndarray, label: str = "chr21") -> None:
    chars = np.frombuffer(b"ACGTN", np.uint8)[codes]
    width = 80
    full = len(chars) // width * width
    lines = chars[:full].reshape(-1, width)
    nl = np.full((len(lines), 1), ord("\n"), np.uint8)
    with open(path, "wb") as f:
        f.write(f">{label}\n".encode())
        f.write(np.hstack([lines, nl]).tobytes())
        f.write(chars[full:].tobytes() + b"\n")


def plant_reads(rng, db, n: int, span=None, pin=None):
    """Planted 150 bp reads from both strands: 1% SNPs per base, 5% with
    a 1-8 bp indel, 1% with a 65-75 bp adapter tail, 1% random junk,
    inside the first chromosome or the global range ``span`` (lo, hi),
    away from N runs and separators; the first len(``pin``) reads start
    at the global positions ``pin``.
    Returns (codes uint8[n, 150], truth_pos int64 (-1 junk), strand).

    The tails are long enough that the full-read score falls below
    min_score_frac and the clip-rescue lane maps them. Tails of 30-55 bp
    mostly map without it through gapped full-read alignments, and for
    10-30% of those the host traceback (which a row meets with tb_bits
    off, or when the gapped winners outnumber the traceback lanes) finds
    a better unbanded path than the banded device DP and cigars_nm_blob
    raises — in urmap_tpu as in the port (ROADMAP.md, section C)."""
    from urmap_tpu_torch import alphabet

    g = db.codes
    lo, hi = span or (int(db.starts[0]), int(db.starts[0] + db.lengths[0]))
    kind = rng.choice(4, size=n, p=[0.93, 0.05, 0.01, 0.01])
    pos = np.zeros(n, np.int64)
    todo = np.arange(n)
    while todo.size:
        p = rng.integers(lo, hi - READ_LEN - 16, size=todo.size)
        ok = ~(g[p[:, None] + np.arange(READ_LEN + 16)[None, :]] >= 4) \
            .any(axis=1)
        pos[todo[ok]] = p[ok]
        todo = todo[~ok]
    if pin is not None:
        pos[: len(pin)] = pin
    idx = pos[:, None] + np.arange(READ_LEN)[None, :]
    codes = g[idx].copy()
    for i in np.nonzero(kind == 1)[0]:
        o, d = int(rng.integers(8, READ_LEN - 8)), int(rng.integers(1, 9))
        seg = g[pos[i] : pos[i] + READ_LEN + d]
        if rng.random() < 0.5:
            r = np.concatenate([seg[:o], seg[o + d :]])
        else:
            r = np.concatenate([seg[:o], rng.integers(0, 4, d), seg[o:]])
        codes[i] = r[:READ_LEN]
    for i in np.nonzero(kind == 2)[0]:
        t = int(rng.integers(65, 76))
        codes[i, READ_LEN - t :] = rng.integers(0, 4, t)
    snp = (rng.random(codes.shape) < 0.01) & (kind != 3)[:, None]
    codes[snp] = (codes[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    junk = kind == 3
    codes[junk] = rng.integers(0, 4, (int(junk.sum()), READ_LEN))
    strand = rng.integers(0, 2, size=n).astype(np.int32)
    rc = alphabet.COMP_CODE[codes[:, ::-1]]
    codes = np.where(strand[:, None] == 1, rc, codes).astype(np.uint8)
    return codes, np.where(junk, -1, pos), strand


def write_fastq(path: str, codes: np.ndarray) -> None:
    chars = np.frombuffer(b"ACGTNN", np.uint8)[codes]
    qual = b"I" * codes.shape[1]
    with open(path, "wb") as f:
        for s in range(0, len(codes), 65536):
            f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (s + i, row.tobytes(),
                                                        qual)
                             for i, row in enumerate(chars[s : s + 65536])))


def c3_prone(genome, raw_codes, res, sc) -> np.ndarray:
    """bool per row: a mapped, gapped, unclipped winner whose score the
    host DP at its POS does not reproduce (map.cigar's
    traceback_batch_native finds another). These are reads in tandem
    runs whose banded main-DP path is not the best one at that POS. The
    SAM writer (map.cigar.cigars_nm_blob, as urmap_tpu's) raises
    "native traceback score mismatch" on any of them that reaches its
    host DP, and in the runs so far each did: the traceback kernel,
    re-centred at POS, scored it differently, so its records were stale
    (ROADMAP C.3)."""
    from urmap_tpu_torch.map.cigar import (strand_codes_subset,
                                           traceback_batch_native)

    out = np.zeros(len(res.mapped), bool)
    rows = np.nonzero(res.mapped & res.gapped & ~res.clipped)[0]
    if rows.size:
        lens = res.lengths[rows]
        sub = strand_codes_subset(raw_codes[rows], res.strand[rows], lens)
        nat = traceback_batch_native(genome, res.pos[rows], sub, lens, sc,
                                     raw=True)
        check(nat is not None, "the native traceback is unavailable")
        out[rows[nat[3] != res.score[rows]]] = True
    return out


def map_fastq(mapper, db, fq: str, batch: int, sam_path: str | None,
              c3: list | None = None):
    """FastqReader → Mapper → run_stream → cigars_nm_blob (in clip mode
    under end_clip, as the CLI runs it) → format_single_end. Returns
    (list of MapResult, SAM record bytes). With a list ``c3``, each
    batch's c3_prone rows are appended to it and written unmapped
    (ROADMAP C.3: the SAM writer raises on them)."""
    from urmap_tpu_torch.io.fastq import FastqReader, PrefetchIterator
    from urmap_tpu_torch.io import sam_native
    from urmap_tpu_torch.utils.stream import run_stream
    from urmap_tpu_torch.map.cigar import cigars_nm_blob

    reader = FastqReader(fq, batch_size=batch,
                         max_read_len=mapper.mcfg.max_read_len)
    check(reader.native and sam_native.available(),
          "native FASTQ/SAM codecs unavailable (g++ build failed)")
    items = PrefetchIterator(
        reader, transform=lambda b: (b, mapper.prepack(b.codes, b.lengths)))
    results, chunks = [], []

    def start(item):
        b, pk = item
        return mapper.start_batch(b.codes, b.lengths, prepacked=pk)

    def sync(item, handle):
        return mapper.finish_batch(handle, item[0].lengths)

    def fmt(item, res):
        b = item[0]
        out = res
        if c3 is not None:
            prone = c3_prone(db.codes, b.codes, res, mapper.sc)
            out = dataclasses.replace(res, mapped=res.mapped & ~prone)
        blob, off, nm, _span = cigars_nm_blob(
            db.codes, b.codes, out, mapper.sc, raw_lengths=b.seq_len,
            clip_open=clip_of(mapper), clip_rows=out.clipped)
        return res, sam_native.format_single_end(b, out, (blob, off), nm,
                                                 db), \
            (None if c3 is None else prone)

    def write(out):
        results.append(out[0])
        chunks.append(out[1])
        if c3 is not None:
            c3.append(out[2])

    run_stream(items, start, sync, fmt, write, inflight=1, workers=2)
    data = b"".join(chunks)
    if sam_path is not None:
        from urmap_tpu_torch.io import sam as samio

        with open(sam_path, "wb") as f:
            f.write(samio.sam_header(db, "chip_smoke").encode("ascii"))
            f.write(data)
    return results, data


def clip_of(mapper):
    """The host traceback's clip_open: the CLI's rule (end_clip only)."""
    return mapper.sc.clip_open if mapper.mcfg.end_clip else None


def concat_results(results):
    from urmap_tpu_torch.map.pipeline import MapResult

    fields = ("mapped", "pos", "strand", "score", "second", "mapq",
              "gapped", "ungapped", "clipped", "suspect", "lengths")
    return MapResult(**{f: np.concatenate([getattr(r, f) for r in results])
                        for f in fields})


def tb_coverage(results) -> dict:
    """How the gapped, unclipped winners of each batch got their CIGAR:
    decoded from the device records (cigar._tb_select), or fallen back
    to the host DP, by reason: more winners than traceback lanes, a
    device walk that ended off the band centre (walk_ok false), or
    records whose score, pos or strand is not the result's (a path that
    left the re-anchored band scores below the winner)."""
    from urmap_tpu_torch.map.cigar import _tb_select

    tot = {"winners": 0, "from_device": 0, "lane_overflow": 0,
           "walk_not_ok": 0, "stale_score": 0, "stale_pos": 0,
           "stale_strand": 0}
    for res in results:
        check(res.tb is not None, "a batch came back without tb records")
        rows = np.nonzero(res.mapped & res.gapped & ~res.clipped)[0]
        use, _ti = _tb_select(res, rows, res.clipped)
        lanes = res.tb["dops"].shape[1]
        live = min(rows.size, lanes)
        tbr = res.tb["rows"]
        tot["winners"] += int(rows.size)
        tot["from_device"] += int(use.size)
        tot["lane_overflow"] += int(rows.size - live)
        tot["walk_not_ok"] += int(live - tbr.size)
        for key in ("score", "pos", "strand"):
            tot[f"stale_{key}"] += int(
                (res.tb[key] != np.asarray(getattr(res, key))[tbr]).sum())
    tot["from_device_frac"] = (tot["from_device"] / tot["winners"]
                               if tot["winners"] else 1.0)
    return tot


def plant_pairs(rng, db, n: int):
    """Planted FR pairs of 150 bp mates from fragments of 200-600 bases:
    1% SNPs per base, 5% of pairs with a 1-8 bp indel in one mate, 5%
    with one mate mutated every 15th base (no seed of it survives: only
    the rescue scan off the other mate places it), 1% junk (both mates
    random). Which mate is R1 is drawn per pair.
    Returns (codes1, codes2, truth) with truth = dict(pos1, pos2 int64
    (-1 junk), strand1, strand2, kind, mutated (1 or 2: the mate))."""
    from urmap_tpu_torch import alphabet

    g = db.codes
    lo, hi = int(db.starts[0]), int(db.starts[0] + db.lengths[0])
    isn = np.concatenate([[0], np.cumsum(g >= 4)])
    kind = rng.choice(4, size=n, p=[0.89, 0.05, 0.05, 0.01])
    frag = rng.integers(200, 601, size=n)
    fs = np.zeros(n, np.int64)
    todo = np.arange(n)
    while todo.size:
        p = rng.integers(lo, hi - 640, size=todo.size)
        ok = isn[p + 632] - isn[p] == 0
        fs[todo[ok]] = p[ok]
        todo = todo[~ok]
    pos = np.stack([fs, fs + frag - READ_LEN])          # left, right mate
    mates = [g[pp[:, None] + np.arange(READ_LEN)[None, :]].copy()
             for pp in pos]
    which = rng.integers(0, 2, size=n)                  # the altered mate
    for i in np.nonzero(kind == 1)[0]:
        m = which[i]
        o, d = int(rng.integers(8, READ_LEN - 8)), int(rng.integers(1, 9))
        seg = g[pos[m, i] : pos[m, i] + READ_LEN + d]
        if rng.random() < 0.5:
            r = np.concatenate([seg[:o], seg[o + d :]])
        else:
            r = np.concatenate([seg[:o], rng.integers(0, 4, d), seg[o:]])
        mates[m][i] = r[:READ_LEN]
    junk = kind == 3
    for m in (0, 1):
        c = mates[m]
        snp = (rng.random(c.shape) < 0.01) & ~junk[:, None]
        c[snp] = (c[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        mut = (kind == 2) & (which == m)
        grid = np.arange(7, READ_LEN, 15)
        c[np.ix_(mut, grid)] = (c[np.ix_(mut, grid)] + rng.integers(
            1, 4, (int(mut.sum()), grid.size))) % 4
        c[junk] = rng.integers(0, 4, (int(junk.sum()), READ_LEN))
    left, right = mates[0], alphabet.COMP_CODE[mates[1][:, ::-1]]
    r1_left = rng.integers(0, 2, size=n).astype(bool)
    c1 = np.where(r1_left[:, None], left, right).astype(np.uint8)
    c2 = np.where(r1_left[:, None], right, left).astype(np.uint8)
    truth = {
        "pos1": np.where(junk, -1, np.where(r1_left, pos[0], pos[1])),
        "pos2": np.where(junk, -1, np.where(r1_left, pos[1], pos[0])),
        "strand1": (~r1_left).astype(np.int32),
        "strand2": r1_left.astype(np.int32),
        "kind": kind,
        # the altered mate is left (0) or right (1); as R1/R2:
        "mutated": np.where((which == 0) == r1_left, 1, 2),
    }
    return c1, c2, truth


def make_world(rng, work: str, n_reads: int, n_half: int, n_pairs: int,
               genome_len: int) -> dict:
    """Genome → FASTA → index; the tables prepared in the layout the
    index asks for (aligned here) and in the row128 layout; the planted
    reads and pairs with their FASTQ files."""
    from urmap_tpu_torch.config import MapConfig
    from urmap_tpu_torch.io.fasta import SeqDB
    from urmap_tpu_torch.index import build_index
    from urmap_tpu_torch.index.store import prepare_tables

    t0 = time.perf_counter()
    fa = os.path.join(work, "genome.fa")
    write_fasta(fa, make_genome(rng, genome_len))
    db = SeqDB.from_fasta(fa)
    index = build_index(db, backend="host")
    p = MapConfig().positions_per_seed
    prepared = prepare_tables(index, p)
    check(prepared[1]["layout"] in ("classic", "aligned"),
          f"layout {prepared[1]['layout']}")
    t1 = time.perf_counter()
    os.environ["URMAP_ROW128_BYTES"] = "1"
    prepared128 = prepare_tables(index, p)
    del os.environ["URMAP_ROW128_BYTES"]
    check(prepared128[1]["layout"] == "row128"
          and prepared128[1]["off_bits"] is not None,
          f"row128 tables: {prepared128[1]}")
    t2 = time.perf_counter()
    codes, truth, strand = plant_reads(rng, db, n_reads)
    w = {"db": db, "fasta": fa, "index": index, "prepared": prepared,
         "prepared128": prepared128, "codes": codes, "truth": truth,
         "strand": strand, "n_half": n_half}
    for name, sub in (("reads", codes), ("reads_half", codes[:n_half]),
                      ("reads_cpu", codes[:N_CPU])):
        w[name] = os.path.join(work, f"{name}.fq")
        write_fastq(w[name], sub)
    c1, c2, w["pair_truth"] = plant_pairs(rng, db, n_pairs)
    for name, sub in (("r1", c1), ("r2", c2), ("r1_cpu", c1[:N_CPU_PAIRS]),
                      ("r2_cpu", c2[:N_CPU_PAIRS])):
        w[name] = os.path.join(work, f"{name}.fq")
        write_fastq(w[name], sub)
    w["setup_s"] = {"index_and_tables": t1 - t0, "row128_tables": t2 - t1,
                    "reads_and_pairs": time.perf_counter() - t2}
    return w


def read_counters() -> dict:
    from urmap_tpu_torch.kernels import counters

    return {c.name: {"launches": c.launches, "plain_calls": c.plain_calls,
                     **({"host_pass_calls": c.host_pass_calls}
                        if c.host_pass_calls else {}),
                     **({"widths": dict(c.widths)} if c.widths else {})}
            for c in counters()}


def reset_counters() -> None:
    from urmap_tpu_torch.kernels import counters, tier_rounds

    for c in counters():
        c.reset()
    tier_rounds.reset()


def check_counters(counts: dict, what: str, end_clip: bool = False) -> None:
    """Every kernel of the mapping path launched (the clip traceback
    where the path had clip-rescued gapped winners), no plain version ran
    (outside the wide second pass's host_pass); under end_clip the
    kernels that path does not run were not launched either."""
    from urmap_tpu_torch.kernels import (OFF_PATH, OFF_PATH_END_CLIP,
                                         ON_CLIP_ROWS)

    off = OFF_PATH_END_CLIP if end_clip else OFF_PATH
    for name, c in counts.items():
        check(c["launches"] > 0 or name in off or name in ON_CLIP_ROWS,
              f"{name}: no kernel launch in {what}")
        check(c["plain_calls"] == 0, f"{name}: plain version ran in {what}")
    if end_clip:
        for name in set(OFF_PATH_END_CLIP) - set(OFF_PATH):
            check(counts[name]["launches"] == 0,
                  f"{name}: launched in {what} under end_clip")


FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect")


def differing(a, b, n=None):
    return [f for f in FIELDS
            if not np.array_equal(getattr(a, f)[:n], getattr(b, f)[:n])]


def tb_differing(a: dict, b: dict) -> list:
    """Keys of two traceback dicts that differ; of the dops matrix only
    the live lanes: a fill lane's records come from a window past the
    table's end, where the layouts' fetches clamp differently, and are
    never read."""
    out = []
    for k in a:
        x, y = a[k], b[k]
        if k == "dops":
            x, y = x[:, a["cols"]], y[:, b["cols"]]
        if not np.array_equal(x, y):
            out.append(k)
    return out


def run_single_end(dev, w: dict, mapper, phase: str, fq: str, n: int,
                   batch: int, smi: str, sam_path: str) -> dict:
    """One single-end run of the slice through ``mapper`` over the first
    ``n`` reads, with the slice's checks."""
    import torch

    db = w["db"]
    lens = np.full(min(batch, n), READ_LEN, np.int32)
    torch.cuda.reset_peak_memory_stats(dev)
    mapper.map_codes(w["codes"][: len(lens)], lens)       # warm batch
    reset_counters()
    t1 = time.perf_counter()
    results, sam = map_fastq(mapper, db, fq, batch, sam_path)
    torch.cuda.synchronize(dev)
    map_s = time.perf_counter() - t1
    counts = read_counters()
    res = concat_results(results)
    check(len(res.mapped) == n, "result count")
    cover = tb_coverage(results)
    truth, strand = w["truth"][:n], w["strand"][:n]
    planted = truth >= 0
    correct = res.mapped & (res.pos == truth) & (res.strand == strand)
    frac = float(correct[planted].mean())
    junk_unmapped = float((~res.mapped[~planted]).mean())
    emit({"phase": phase, "device": str(dev), "gpu": smi,
          "genome_bases": int(db.total_len),
          "slot_bits": w["index"].config.slot_bits,
          "layout": "row128" if mapper.row128 else
          ("aligned" if mapper.csr_aligned else "classic"),
          "off_bits": mapper.off_bits,
          "positions": w["index"].num_positions, "reads": n,
          "batch": batch, "map_s": map_s, "reads_per_s": n / map_s,
          "correct_frac": frac, "junk_unmapped_frac": junk_unmapped,
          "mapped_frac": float(res.mapped.mean()),
          "gapped": int(res.gapped.sum()),
          "clipped": int(res.clipped.sum()), "batches": len(results),
          "traceback": cover, "counters": counts,
          "max_memory_allocated": torch.cuda.max_memory_allocated(dev)})
    check_counters(counts, phase)
    check(counts["tb_dops"]["launches"] == len(results),
          f"tb_dops launches {counts['tb_dops']['launches']} != batches "
          f"{len(results)}")
    check(cover["from_device_frac"] >= 0.9,
          f"only {cover['from_device_frac']} of the gapped unclipped "
          "winners decode from device records")
    check(frac >= 0.99, f"correct fraction {frac} < 0.99")
    check(junk_unmapped >= 0.99, f"junk unmapped {junk_unmapped} < 0.99")
    return {"results": results, "sam": sam, "res": res, "counts": counts}


def profile_call(fn, table_path: str, tries: int = 3) -> dict:
    """torch.profiler over one call of ``fn`` (ended by a synchronise):
    wall and device-busy ms, the idle share (the profiler's overhead
    inflates the wall), the top device kernels, the port's own kernels
    (device ms in all and launches: a launch of a few microseconds is
    invisible to phase 3's event timing, which then shows the enqueue)
    and the host ops with the most self time; ``complete``: the trace
    holds a device kernel for each host launch. The full table goes to
    ``table_path``. ``fn`` runs twice a try (a warm-up, then the
    recorded call), in up to ``tries`` tries: ranks that must call
    their collectives alike take one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    # a trace now and then comes back with device records dropped (seen
    # in a process that has profiled before): the schedule runs one call
    # as warm-up before the one it records (chunk_stage_ms does the
    # same), and a trace is taken again, up to three times, until it
    # holds a device kernel for each host launch; the schedule's own
    # ProfilerStep span is left out of both counts
    for _ in range(tries):
        got = {}

        def ready(p):
            got["ka"] = p.key_averages()

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=ready) as prof:
            for _step in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                prof.step()
        ka = [e for e in got["ka"] if not e.key.startswith("ProfilerStep")]
        # device-side events only (kernels, copies): the CPU-side op
        # rows carry the same device time again
        on_dev = [e for e in ka if e.device_type == DeviceType.CUDA]
        host_launches = sum(e.count for e in ka
                            if e.device_type == DeviceType.CPU
                            and e.key.startswith(("cudaLaunchKernel",
                                                  "cuLaunchKernel")))
        device_kernels = sum(e.count for e in on_dev if not e.key.startswith(
            ("Memcpy", "Memset")))
        if on_dev and device_kernels >= host_launches:
            break
    on_host = [e for e in ka if e.device_type == DeviceType.CPU]

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    def own_name(key: str) -> str:
        key = key.replace("(anonymous namespace)::", "")
        return key.removeprefix("void ").split("(")[0][:60]

    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    with open(table_path, "w") as f:
        f.write(got["ka"].table(sort_by="self_device_time_total",
                                row_limit=60))
    return {
        "complete": bool(on_dev) and device_kernels >= host_launches,
        "host_launches": host_launches,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "device_launches": sum(e.count for e in on_dev),
        "top_device_ms": [[e.key[:60], dev_us(e) / 1e3, e.count]
                          for e in sorted(on_dev, key=dev_us,
                                          reverse=True)[:15]],
        "port_kernels_device_ms": {
            own_name(e.key): [dev_us(e) / 1e3, e.count] for e in on_dev
            if "_kernel" in e.key and "at::" not in e.key},
        "top_host_self_ms": [[e.key[:40], e.self_cpu_time_total / 1e3,
                              e.count]
                             for e in sorted(
                                 on_host, key=lambda e: e.self_cpu_time_total,
                                 reverse=True)[:12]]}


def phase_profile(mappers: dict, db, fq: str, batch: int,
                  work: str) -> None:
    """Where one batch's time goes: host-clock stage times (each ended
    by a synchronise) for the aligned layout with the traceback on
    ("on") and off ("off") and for the row128 layout ("row128"), in
    turns within this one run (medians of three); then torch.profiler's
    device time by kernel for start_batch + finish_batch on the aligned
    layout with the traceback on; the full table goes to profile.txt."""
    import torch

    from urmap_tpu_torch.io import sam_native
    from urmap_tpu_torch.io.fastq import FastqReader
    from urmap_tpu_torch.map.cigar import _tb_select, cigars_nm_blob

    b = next(iter(FastqReader(fq, batch_size=batch)))

    def stages_of(m) -> dict:
        stages = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name] = (time.perf_counter() - t0) * 1e3
            return out

        pk = timed("prepack", lambda: m.prepack(b.codes, b.lengths))
        h = timed("start_batch",
                  lambda: m.start_batch(b.codes, b.lengths, prepacked=pk))
        res = timed("finish_batch", lambda: m.finish_batch(h, b.lengths))
        blob, off, nm, _ = timed("cigars", lambda: cigars_nm_blob(
            db.codes, b.codes, res, m.sc, raw_lengths=b.seq_len,
            clip_rows=res.clipped))
        timed("format_sam", lambda: sam_native.format_single_end(
            b, res, (blob, off), nm, db))
        # the same call less the clip-rescued rows, which always take
        # the host's clip-mode DP (the device traceback leaves them out)
        unclipped = dataclasses.replace(res,
                                        mapped=res.mapped & ~res.clipped)
        timed("cigars_less_clip_rows", lambda: cigars_nm_blob(
            db.codes, b.codes, unclipped, m.sc, raw_lengths=b.seq_len,
            clip_rows=np.zeros_like(res.clipped)))
        rows = np.nonzero(res.mapped & res.gapped & ~res.clipped)[0]
        replayed = _tb_select(res, rows, res.clipped)[0].size
        stages["rows"] = {"replayed": int(replayed),
                          "host_dp": int(rows.size - replayed),
                          "host_dp_clip": int((res.mapped & res.gapped
                                               & res.clipped).sum())}
        return stages

    runs = {k: [] for k in mappers}
    for which in ("on", "off", "row128", "row128", "off", "on", "on", "off",
                  "row128"):
        runs[which].append(stages_of(mappers[which]))
    med = {w: {k: (runs[w][0][k] if k == "rows"
                   else statistics.median(r[k] for r in runs[w]))
               for k in runs[w][0]} for w in runs}
    mapper = mappers["on"]
    pk = mapper.prepack(b.codes, b.lengths)
    emit({"phase": "profile", "reads": len(b), "stages_ms": med["on"],
          "stages_tb_off_ms": med["off"], "stages_row128_ms": med["row128"],
          **profile_call(lambda: mapper.finish_batch(
              mapper.start_batch(b.codes, b.lengths, prepacked=pk),
              b.lengths), os.path.join(work, "profile.txt"))})


def phase_cpu(w: dict, mappers: dict, main_sam: bytes, batch: int) -> None:
    """Phase 5: the first N_CPU reads again, three ways."""
    from urmap_tpu_torch.map import Mapper

    db, fq_cpu = w["db"], w["reads_cpu"]
    mapper, off_mapper = mappers["on"], mappers["off"]
    on_results, on_sam = map_fastq(mapper, db, fq_cpu, batch, None)
    on_res = concat_results(on_results)
    main_lines = b"\n".join(main_sam.split(b"\n")[:N_CPU]) + b"\n"
    check(on_sam == main_lines,
          "the first reads map differently alone and in the full run")
    # the card with the traceback off: same result, same SAM bytes
    t2 = time.perf_counter()
    off_results, off_sam = map_fastq(off_mapper, db, fq_cpu, batch, None)
    off_diff = differing(concat_results(off_results), on_res)
    emit({"phase": "tb_off", "reads": N_CPU, "fields_differing": off_diff,
          "sam_identical": off_sam == on_sam,
          "map_s": time.perf_counter() - t2})
    check(not off_diff, f"traceback on and off differ in {off_diff}")
    check(off_sam == on_sam, "traceback on and off: SAM bytes differ")
    # a CPU Mapper (plain versions) with the traceback on
    t3 = time.perf_counter()
    cpu_mapper = Mapper(w["index"], mapper.mcfg, mapper.sc, device="cpu",
                        prepared=w["prepared"])
    cpu_results, cpu_sam = map_fastq(cpu_mapper, db, fq_cpu, batch, None)
    diff = differing(concat_results(cpu_results), on_res)
    check(len(cpu_results) == len(on_results), "batch counts differ")
    tb_diff = sorted({k for a, b in zip(cpu_results, on_results)
                      for k in tb_differing(a.tb, b.tb)})
    emit({"phase": "cpu", "reads": N_CPU, "fields_differing": diff,
          "tb_keys_differing": tb_diff, "sam_identical": cpu_sam == on_sam,
          "cpu_map_s": time.perf_counter() - t3})
    check(not diff, f"card and CPU differ in {diff}")
    check(not tb_diff, f"card and CPU tb records differ in {tb_diff}")
    check(cpu_sam == on_sam, "card and CPU SAM bytes differ")


def phase_row128(dev, w: dict, mapper128, aligned: dict, batch: int,
                 smi: str, work: str) -> dict:
    """Phase 6: all reads over the row128 tables; equal to the aligned
    slice on the reads both mapped."""
    n_half = w["n_half"]
    check(mapper128.row128 and mapper128.off_bits is not None
          and mapper128.tables["positions"].dim() == 2
          and mapper128.tables["ginter"].dim() == 2,
          "the row128 Mapper does not run the dense-row layout with "
          "packed offsets")
    run = run_single_end(dev, w, mapper128, "row128", w["reads"],
                         len(w["codes"]), batch, smi,
                         os.path.join(work, "out_row128.sam"))
    diff = differing(run["res"], aligned["res"], n_half)
    nb = len(aligned["results"])
    tb_diff = sorted({k for a, b in zip(run["results"][:nb],
                                        aligned["results"])
                      for k in tb_differing(a.tb, b.tb)})
    head = b"\n".join(run["sam"].split(b"\n")[:n_half]) + b"\n"
    emit({"phase": "row128_vs_aligned", "reads": n_half,
          "fields_differing": diff, "tb_keys_differing": tb_diff,
          "sam_identical": head == aligned["sam"]})
    check(not diff, f"row128 and aligned differ in {diff}")
    check(not tb_diff, f"row128 and aligned tb records differ in {tb_diff}")
    check(head == aligned["sam"], "row128 and aligned: SAM bytes differ")
    return run


def map_pairs_fastq(pm, db, fq1: str, fq2: str, c3: list | None = None):
    """FastqReader (paired) → PairedMapper → run_stream → cigars_nm_blob
    per mate → format_paired. Returns (list of PairResult, SAM bytes).
    With a list ``c3``, as map_fastq: each batch's (mate 1, mate 2)
    c3_prone rows, written unmapped."""
    from urmap_tpu_torch.io.fastq import FastqReader, PrefetchIterator
    from urmap_tpu_torch.utils.stream import run_stream

    reader = FastqReader(fq1, fq2, batch_size=pm.pair_batch,
                         max_read_len=pm.mcfg.max_read_len)
    items = PrefetchIterator(reader, transform=lambda bb: (bb, pm.prepack(
        bb[0].codes, bb[0].lengths, bb[1].codes, bb[1].lengths)))
    results, chunks = [], []

    def start(item):
        (b1, b2), pk = item
        return pm.start_batch(b1.codes, b1.lengths, b2.codes, b2.lengths,
                              prepacked=pk)

    def sync(item, handle):
        b1, b2 = item[0]
        return pm.finish_batch(handle, b1.lengths, b2.lengths)

    def fmt(item, res):
        if c3 is None:
            return res, format_pairs(pm, db, *item[0], res), None
        prone = [c3_prone(db.codes, b.codes, m, pm.sc)
                 for b, m in zip(item[0], (res.m1, res.m2))]
        out = dataclasses.replace(
            res, m1=dataclasses.replace(res.m1,
                                        mapped=res.m1.mapped & ~prone[0]),
            m2=dataclasses.replace(res.m2, mapped=res.m2.mapped & ~prone[1]))
        return res, format_pairs(pm, db, *item[0], out), prone

    def write(out):
        results.append(out[0])
        chunks.append(out[1])
        if c3 is not None:
            c3.append(out[2])

    run_stream(items, start, sync, fmt, write, inflight=1, workers=2)
    return results, b"".join(chunks)


def pair_cigars(pm, db, b1, b2, res):
    from urmap_tpu_torch.map.cigar import cigars_nm_blob

    return [cigars_nm_blob(db.codes, b.codes, m, pm.sc,
                           raw_lengths=b.seq_len, clip_open=clip_of(pm),
                           clip_rows=m.clipped)
            for b, m in ((b1, res.m1), (b2, res.m2))]


def format_pairs(pm, db, b1, b2, res, cig=None) -> bytes:
    from urmap_tpu_torch.io import sam_native

    (bl1, o1, nm1, sp1), (bl2, o2, nm2, sp2) = cig or pair_cigars(
        pm, db, b1, b2, res)
    return sam_native.format_paired(b1, b2, res, (bl1, o1), nm1, sp1,
                                    (bl2, o2), nm2, sp2, db)


def concat_pairs(results):
    return (concat_results([r.m1 for r in results]),
            concat_results([r.m2 for r in results]),
            np.concatenate([r.proper for r in results]))


def phase_paired(dev, w: dict, mapper128, smi: str, work: str) -> dict:
    """Phase 7: the planted pairs through PairedMapper over the row128
    tables, then the first N_CPU_PAIRS pairs again on a CPU
    PairedMapper."""
    import torch

    from urmap_tpu_torch.io.fastq import FastqReader
    from urmap_tpu_torch.map import Mapper
    from urmap_tpu_torch.map.pair import PairedMapper

    db, truth = w["db"], w["pair_truth"]
    n = len(truth["kind"])
    pm = PairedMapper(mapper128)
    check(pm.pair_batch == mapper128.mcfg.batch_size // 2 and pm.tb,
          "PairedMapper: pair batch or traceback switch")
    b1, b2 = next(iter(FastqReader(w["r1"], w["r2"],
                                   batch_size=pm.pair_batch)))
    torch.cuda.reset_peak_memory_stats(dev)
    pm.map_pair_codes(b1.codes, b1.lengths, b2.codes, b2.lengths)   # warm
    reset_counters()
    pm.stats.update(rescue_rounds=0, batches=0)
    t0 = time.perf_counter()
    results, sam = map_pairs_fastq(pm, db, w["r1"], w["r2"])
    torch.cuda.synchronize(dev)
    map_s = time.perf_counter() - t0
    counts = read_counters()
    stats = dict(pm.stats)
    m1, m2, proper = concat_pairs(results)
    check(len(proper) == n and sam.count(b"\n") == 2 * n, "pair count")
    planted = truth["kind"] != 3
    ok1 = m1.mapped & (m1.pos == truth["pos1"]) \
        & (m1.strand == truth["strand1"])
    ok2 = m2.mapped & (m2.pos == truth["pos2"]) \
        & (m2.strand == truth["strand2"])
    frac = float(np.concatenate([ok1[planted], ok2[planted]]).mean())
    proper_frac = float(proper[planted].mean())
    mut = truth["kind"] == 2
    rescued = int((np.where(truth["mutated"] == 1, ok1, ok2) & mut).sum())
    junk_unmapped = float(np.concatenate([~m1.mapped[~planted],
                                          ~m2.mapped[~planted]]).mean())
    cover = tb_coverage([r.m1 for r in results] + [r.m2 for r in results])

    # one pair batch by stage, host clock, medians of three
    def stages_of() -> dict:
        st = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            st[name] = (time.perf_counter() - t) * 1e3
            return out

        pk = timed("prepack", lambda: pm.prepack(b1.codes, b1.lengths,
                                                 b2.codes, b2.lengths))
        h = timed("start_batch", lambda: pm.start_batch(
            b1.codes, b1.lengths, b2.codes, b2.lengths, prepacked=pk))
        res = timed("finish_batch",
                    lambda: pm.finish_batch(h, b1.lengths, b2.lengths))
        cig = timed("cigars", lambda: pair_cigars(pm, db, b1, b2, res))
        timed("format_paired", lambda: format_pairs(pm, db, b1, b2, res, cig))
        return st

    runs = [stages_of() for _ in range(3)]
    stages = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    pk = pm.prepack(b1.codes, b1.lengths, b2.codes, b2.lengths)
    prof = profile_call(lambda: pm.finish_batch(pm.start_batch(
        b1.codes, b1.lengths, b2.codes, b2.lengths, prepacked=pk),
        b1.lengths, b2.lengths), os.path.join(work, "profile_paired.txt"))
    emit({"phase": "paired", "device": str(dev), "gpu": smi,
          "layout": "row128", "pairs": n, "pair_batch": pm.pair_batch,
          "map_s": map_s, "pairs_per_s": n / map_s,
          "correct_mate_frac": frac, "proper_frac": proper_frac,
          "mutated_mates": int(mut.sum()), "rescued_mates": rescued,
          "junk_unmapped_frac": junk_unmapped,
          "batches": stats["batches"],
          "rescue_rounds_per_batch": stats["rescue_rounds"]
          / max(stats["batches"], 1),
          "gapped": int(m1.gapped.sum() + m2.gapped.sum()),
          "clipped": int(m1.clipped.sum() + m2.clipped.sum()),
          "traceback": cover, "counters": counts, "stages_ms": stages,
          "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
          "profile": prof})
    check_counters(counts, "the paired run")
    check(counts["window_codes"].get("widths", {}).get(
        pm.mcfg.rescue_window, 0) > 0,
        f"no window_codes launch of {pm.mcfg.rescue_window} bases (the "
        "rescue window)")
    check(stats["rescue_rounds"] > 0 and rescued > 0,
          f"no mate rescued ({stats}, {rescued})")
    check(counts["tb_dops"]["launches"] == stats["batches"] == len(results),
          f"tb_dops launches {counts['tb_dops']['launches']} != batches "
          f"{stats['batches']}")
    check(frac >= 0.99, f"correct mates {frac} < 0.99")
    check(proper_frac >= 0.95, f"proper pairs {proper_frac} < 0.95")
    check(cover["from_device_frac"] >= 0.9,
          f"only {cover['from_device_frac']} of the gapped unclipped mates "
          "decode from device records")

    # the first pairs again: the card against a CPU PairedMapper
    t1 = time.perf_counter()
    on_results, on_sam = map_pairs_fastq(pm, db, w["r1_cpu"], w["r2_cpu"])
    # the single-card run phase 14 holds its sharded pair runs to
    w["paired_head"] = {"results": on_results, "sam": on_sam}
    cpu_pm = PairedMapper(Mapper(w["index"], mapper128.mcfg, mapper128.sc,
                                 device="cpu", prepared=w["prepared128"]))
    cpu_results, cpu_sam = map_pairs_fastq(cpu_pm, db, w["r1_cpu"],
                                           w["r2_cpu"])
    check(len(cpu_results) == len(on_results), "pair batch counts differ")
    a1, a2, ap = concat_pairs(on_results)
    c1, c2, cp = concat_pairs(cpu_results)
    diff = [f"m1.{f}" for f in differing(a1, c1)] \
        + [f"m2.{f}" for f in differing(a2, c2)] \
        + ([] if np.array_equal(ap, cp) else ["proper"])
    tb_diff = sorted({f"{m}.{k}" for a, b in zip(cpu_results, on_results)
                      for m in ("m1", "m2")
                      for k in tb_differing(getattr(a, m).tb,
                                            getattr(b, m).tb)})
    emit({"phase": "paired_cpu", "pairs": N_CPU_PAIRS,
          "fields_differing": diff, "tb_keys_differing": tb_diff,
          "sam_identical": cpu_sam == on_sam,
          "seconds": time.perf_counter() - t1})
    check(not diff, f"paired: card and CPU differ in {diff}")
    check(not tb_diff, f"paired: card and CPU tb records differ in {tb_diff}")
    check(cpu_sam == on_sam, "paired: card and CPU SAM bytes differ")
    return counts


def phase_semiglobal(dev, w: dict, run: dict, n: int) -> dict:
    """Phase 8: kernel B1' on the row128 slice's first ``n`` winners.
    Each is re-aligned over the byte genome with its POS as the
    candidate: the kernel's four outputs must equal the plain version's
    on the card. The band is re-centred on POS, so a few scores may
    differ from the slice's: the share that agrees is printed."""
    import torch

    from urmap_tpu_torch.config import ScoreConfig
    from urmap_tpu_torch.map import dp as dpmod
    from urmap_tpu_torch.map.pipeline import revcomp_strand_codes

    res = run["res"]
    rows = np.nonzero(res.mapped)[0][:n]
    sub = dataclasses.replace(
        res, **{f: getattr(res, f)[rows] for f in FIELDS + ("lengths",)})
    codes = np.full((len(rows), L_MAX), 5, np.uint8)
    codes[:, :READ_LEN] = w["codes"][rows]
    codes = revcomp_strand_codes(codes, sub)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    genome = put(w["db"].codes)
    args = (genome, put(sub.pos.astype(np.int32)), put(codes),
            put(sub.lengths.astype(np.int32)))
    sc = ScoreConfig()
    reset_counters()
    got = dpmod.banded_dispatch(*args, hw=HW, sc=sc)
    torch.cuda.synchronize(dev)
    counts = read_counters()
    want = dpmod.banded_semiglobal(*args, hw=HW, sc=sc)
    err = max_abs_err(got, want)
    unclipped = ~sub.clipped
    same = (got[0].cpu().numpy() == sub.score)[unclipped]
    emit({"phase": "semiglobal", "winners": len(rows), "max_abs_err": err,
          "launches": counts["banded_semiglobal"]["launches"],
          "unclipped": int(unclipped.sum()),
          "score_equals_slice_frac": float(same.mean()),
          "d0_zero_frac": float((got[1] == 0).float().mean())})
    check(err == 0, f"banded_semiglobal differs from plain on the winners "
          f"(max abs err {err})")
    check(counts["banded_semiglobal"]["launches"] == 1
          and counts["banded_semiglobal"]["plain_calls"] == 0,
          f"banded_semiglobal on the winners: {counts['banded_semiglobal']}")
    return counts


def plant_long_reads(rng, db, n: int, lo: int, hi: int, max_indel: int):
    """Planted reads of lo-hi bases from both strands, the slice's mix:
    1% SNPs per base, 5% with a 1-max_indel bp indel, 1% with a random
    tail of 55-65% of the read (the clip-rescue lane maps them), 1% junk.
    Returns (list of codes arrays, truth_pos int64 (-1 junk), strand)."""
    from urmap_tpu_torch import alphabet

    g = db.codes
    start, end = int(db.starts[0]), int(db.starts[0] + db.lengths[0])
    isn = np.concatenate([[0], np.cumsum(g >= 4)])
    lens = rng.integers(lo, hi + 1, size=n)
    kind = rng.choice(4, size=n, p=[0.93, 0.05, 0.01, 0.01])
    pos = np.zeros(n, np.int64)
    todo = np.arange(n)
    while todo.size:
        p = rng.integers(start, end - hi - max_indel - 16, size=todo.size)
        span = lens[todo] + max_indel + 16
        ok = isn[p + span] - isn[p] == 0
        pos[todo[ok]] = p[ok]
        todo = todo[~ok]
    strand = rng.integers(0, 2, size=n).astype(np.int32)
    reads = []
    for i in range(n):
        ln = int(lens[i])
        seg = g[pos[i] : pos[i] + ln + max_indel]
        r = seg[:ln].copy()
        if kind[i] == 1:
            o = int(rng.integers(8, ln - 8))
            d = int(rng.integers(1, max_indel + 1))
            r = (np.concatenate([seg[:o], seg[o + d : ln + d]])
                 if rng.random() < 0.5 else
                 np.concatenate([seg[:o], rng.integers(0, 4, d), seg[o:]]))
            r = r[:ln].astype(np.uint8)
        elif kind[i] == 2:
            t = int(ln * rng.uniform(0.55, 0.65))
            r[ln - t :] = rng.integers(0, 4, t)
        elif kind[i] == 3:
            r = rng.integers(0, 4, ln).astype(np.uint8)
        if kind[i] != 3:
            snp = rng.random(ln) < 0.01
            r[snp] = (r[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        if strand[i]:
            r = alphabet.COMP_CODE[r[::-1]]
        reads.append(r.astype(np.uint8))
    return reads, np.where(kind == 3, -1, pos), strand


def write_fastq_rows(path: str, reads) -> None:
    chars = np.frombuffer(b"ACGTNN", np.uint8)
    with open(path, "wb") as f:
        f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, chars[r].tobytes(),
                                                    b"I" * len(r))
                         for i, r in enumerate(reads)))


def phase_shapes(dev, w: dict, smi: str, work: str, n: int) -> dict:
    """A Mapper over the slice's aligned tables at band_halfwidth 24 and
    max_read_len 704 (shapes the card refused before) with the device
    traceback on: n planted reads of 250-700 bases with indels up to 24
    bases; the slice's checks; then the first N_SHAPES_CPU reads on the
    card and on a CPU Mapper: MapResult, tb dict and SAM bytes equal."""
    import torch

    from urmap_tpu_torch.config import MapConfig, ScoreConfig
    from urmap_tpu_torch.map import Mapper

    db = w["db"]
    mcfg = MapConfig(batch_size=SHAPES_BATCH, band_halfwidth=SHAPES_HW,
                     max_read_len=SHAPES_L, rescue_window=2 * SHAPES_L + 1200)
    check(mcfg.tb_bits, "the shapes config has the traceback on")
    sc = ScoreConfig()
    rng = np.random.default_rng([w["seed"], 2])
    reads, truth, strand = plant_long_reads(rng, db, n, 250, 700, SHAPES_HW)
    fq, fq_cpu = (os.path.join(work, f) for f in ("shapes.fq",
                                                  "shapes_cpu.fq"))
    write_fastq_rows(fq, reads)
    write_fastq_rows(fq_cpu, reads[:N_SHAPES_CPU])
    mapper = Mapper(w["index"], mcfg, sc, device=dev, prepared=w["prepared"])
    check(mapper.tb, "the shapes Mapper has the traceback on")
    reset_counters()
    t0 = time.perf_counter()
    results, sam = map_fastq(mapper, db, fq, SHAPES_BATCH, None)
    torch.cuda.synchronize(dev)
    map_s = time.perf_counter() - t0
    counts = read_counters()
    res = concat_results(results)
    planted = truth >= 0
    correct = res.mapped & (res.pos == truth) & (res.strand == strand)
    frac = float(correct[planted].mean())
    junk_unmapped = float((~res.mapped[~planted]).mean())
    cover = tb_coverage(results)
    # the first reads again, on the card and on a CPU Mapper
    on_results, on_sam = map_fastq(mapper, db, fq_cpu, SHAPES_BATCH, None)
    t1 = time.perf_counter()
    cpu_mapper = Mapper(w["index"], mcfg, sc, device="cpu",
                        prepared=w["prepared"])
    cpu_results, cpu_sam = map_fastq(cpu_mapper, db, fq_cpu, SHAPES_BATCH,
                                     None)
    diff = differing(concat_results(cpu_results), concat_results(on_results))
    tb_diff = sorted({k for a, b in zip(cpu_results, on_results)
                      for k in tb_differing(a.tb, b.tb)})
    emit({"phase": "shapes", "device": str(dev), "gpu": smi,
          "band_halfwidth": SHAPES_HW, "max_read_len": SHAPES_L,
          "reads": n, "read_lengths": [250, 700], "batch": SHAPES_BATCH,
          "batches": len(results), "map_s": map_s,
          "reads_per_s": n / map_s, "correct_frac": frac,
          "junk_unmapped_frac": junk_unmapped,
          "gapped": int(res.gapped.sum()), "clipped": int(res.clipped.sum()),
          "traceback": cover, "counters": counts,
          "cpu_reads": N_SHAPES_CPU, "cpu_fields_differing": diff,
          "cpu_tb_keys_differing": tb_diff,
          "cpu_sam_identical": cpu_sam == on_sam,
          "cpu_map_s": time.perf_counter() - t1})
    check_counters(counts, "shapes")
    check(counts["tb_dops"]["launches"] == len(results),
          f"shapes: tb_dops launches {counts['tb_dops']['launches']} != "
          f"batches {len(results)}")
    check(frac >= 0.99, f"shapes: correct fraction {frac} < 0.99")
    check(junk_unmapped >= 0.99,
          f"shapes: junk unmapped {junk_unmapped} < 0.99")
    check(len(cpu_results) == len(on_results), "shapes: batch counts differ")
    check(not diff, f"shapes: card and CPU differ in {diff}")
    check(not tb_diff, f"shapes: card and CPU tb records differ in {tb_diff}")
    check(cpu_sam == on_sam, "shapes: card and CPU SAM bytes differ")
    check(sam.startswith(on_sam), "shapes: the first reads map differently "
          "alone and in the full run")
    return counts


# ---- phase 10: the command line ------------------------------------------

SWEEP = (16_384, 131_072)        # -batch values timed beside the default
SWEEP_COPIES = 8                 # the sweep maps the reads this many times
MEM_BATCHES = (16_384, 65_536)   # batch sizes of the memory fit
N_EC_CPU, N_EC_CPU_PAIRS = 2048, 1024
N_SECOND, N_SUB = 16_384, 4096


def cpu_model() -> str:
    """The host CPU as lscpu describes it: its model name, or, where the
    machine reports none (a virtual machine may mask it), vendor, family and
    model number."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60)
    f = {}
    for line in out.stdout.splitlines():
        key, _, value = line.partition(":")
        f.setdefault(key.strip(), value.strip())
    name = f.get("Model name", "")
    if name not in ("", "unknown", "-"):
        return name
    return (f"{f.get('Vendor ID', '?')} family {f.get('CPU family', '?')} "
            f"model {f.get('Model', '?')} (no model name reported)")


def cli_map(dev, args: list) -> dict:
    """urmap_tpu_torch.cli.main(args, device=dev) in this process (so the
    kernel counters can be read), under sys.argv = ["urmap", *args] for
    the @PG line: wall seconds (index load and table upload included),
    the CLI's own summary (reads/s of its map loop), the auto-fit's
    batch where it printed one, and peak memory."""
    import contextlib
    import io
    import re

    import torch

    from urmap_tpu_torch import cli

    err = io.StringIO()
    torch.cuda.synchronize(dev)
    # the allocator's cache from earlier phases out, so that the peak
    # reserved less the peak allocated is this run's own slack
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    argv, sys.argv = sys.argv, ["urmap", *args]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(args, device=dev)
        torch.cuda.synchronize(dev)
    finally:
        sys.argv = argv
    wall = time.perf_counter() - t0
    text = err.getvalue()
    check(rc == 0, f"cli.main {args}: exit {rc}")
    m = re.search(r"([\d,]+) reads, [\d,]+ mapped \(([\d.]+)%\), "
                  r"([\d.]+)s \(([\d,]+) reads/s\)", text)
    check(m is not None, f"cli.main {args}: no summary in {text[-400:]!r}")
    auto = re.search(r"auto batch \d+ → (\d+)", text)
    return {"wall_s": wall, "reads": int(m.group(1).replace(",", "")),
            "mapped_pct": float(m.group(2)), "cli_map_s": float(m.group(3)),
            "cli_reads_per_s": int(m.group(4).replace(",", "")),
            "reads_per_wall_s": int(m.group(1).replace(",", "")) / wall,
            "auto_batch": int(auto.group(1)) if auto else None,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "max_memory_reserved": torch.cuda.max_memory_reserved(dev)}


def sam_records(path: str) -> list:
    """The SAM file's record lines (no header), newline kept."""
    with open(path, "rb") as f:
        return [ln for ln in f if not ln.startswith(b"@")]


def sam_calls(records: list, starts) -> dict:
    """Per record: read index (QNAME r<i>), first mate, mapped, strand,
    the leading soft clip, and the global POS less that clip."""
    import re

    n = len(records)
    out = {k: np.zeros(n, np.int64) for k in ("i", "first", "mapped",
                                               "strand", "pos", "lead")}
    for j, ln in enumerate(records):
        f = ln.split(b"\t", 6)
        flag = int(f[1])
        lead = re.match(rb"(\d+)S", f[5])
        out["i"][j] = int(f[0][1:])
        out["first"][j] = not flag & 0x80
        out["mapped"][j] = not flag & 4
        out["strand"][j] = bool(flag & 16)
        out["lead"][j] = int(lead.group(1)) if lead else 0
        out["pos"][j] = int(starts[0]) + int(f[3]) - 1 - out["lead"][j]
    return out


def long_pairs(rng, db, n: int, ln: int):
    """n FR pairs of ln-base mates from fragments of ln-1,000 bases in
    N-free stretches, the memory fit's reads at a long block, with the
    slice's mix: 1% SNPs, 5% with mate 2 mutated every 15th base (the
    rescue scan), 1% with a random tail of 60% on mate 1 (the clip
    lane), 1% junk."""
    from urmap_tpu_torch import alphabet

    g = db.codes
    lo, hi = int(db.starts[0]), int(db.starts[0] + db.lengths[0])
    isn = np.concatenate([[0], np.cumsum(g >= 4)])
    pos = np.zeros(n, np.int64)
    todo = np.arange(n)
    while todo.size:
        p = rng.integers(lo, hi - 1_100, size=todo.size)
        ok = isn[p + 1_100] - isn[p] == 0
        pos[todo[ok]] = p[ok]
        todo = todo[~ok]
    frag = rng.integers(ln, 1_001, size=n)
    col = np.arange(ln)[None, :]
    m1 = g[pos[:, None] + col]
    m2 = alphabet.COMP_CODE[g[(pos + frag - ln)[:, None] + col][:, ::-1]]
    for m in (m1, m2):
        snp = rng.random(m.shape) < 0.01
        m[snp] = (m[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    kind = rng.choice(4, size=n, p=[0.93, 0.05, 0.01, 0.01])
    grid = np.arange(7, ln, 15)
    mut = np.ix_(kind == 1, grid)
    m2[mut] = (m2[mut] + rng.integers(1, 4, m2[mut].shape)) % 4
    t = int(ln * 0.6)
    m1[kind == 2, ln - t :] = rng.integers(0, 4, (int((kind == 2).sum()), t))
    for m in (m1, m2):
        m[kind == 3] = rng.integers(0, 4, (int((kind == 3).sum()), ln))
    return m1.astype(np.uint8), m2.astype(np.uint8)


def batch_peak_bytes(dev, mapper, mcfg, c1, c2=None) -> int:
    """Bytes one batch (c1; with c2 a pair batch) allocates on the card
    above what it held before: torch.cuda.max_memory_allocated() less
    memory_allocated() before (the tables and every earlier object)."""
    import torch

    from urmap_tpu_torch.map.pair import PairedMapper

    mapper.mcfg = mcfg           # the tables do not depend on the batch
    lens = np.full(len(c1), c1.shape[1], np.int32)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    if c2 is None:
        mapper.map_codes(c1, lens)
    else:
        PairedMapper(mapper).map_pair_codes(c1, lens, c2, lens)
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - base


def phase_memory(dev, w: dict) -> dict:
    """The card memory of one map batch as a function of the batch and
    max_read_len, single-end and paired (pair batches of batch // 2
    pairs): the slope between MEM_BATCHES at L_MAX (the slice's reads
    and pairs) and SHAPES_L (planted pairs of 700 bases, rescue_window as
    the shapes phase), fitted as a + b * max_read_len bytes a read; the
    intercepts, and the CUDA context's and the allocator's share."""
    import torch

    from urmap_tpu_torch.config import MapConfig
    from urmap_tpu_torch.io.fastq import FastqReader
    from urmap_tpu_torch.map import Mapper

    mm = Mapper(w["index"], MapConfig(batch_size=B), device=dev,
                prepared=w["prepared"])
    tables = nbytes([t for t in mm.tables.values() if torch.is_tensor(t)])
    nmax = max(MEM_BATCHES)
    p1, p2 = next(iter(FastqReader(w["r1"], w["r2"], batch_size=nmax // 2)))
    l1, l2 = long_pairs(np.random.default_rng([w["seed"], 3]), w["db"],
                        nmax // 4, SHAPES_L - 4)
    reads = {L_MAX: (w["codes"], p1.codes, p2.codes),
             SHAPES_L: (np.tile(l1, (4, 1)), l1, l2)}
    fit, raw = {}, {}
    for paired in (False, True):
        slope = {}
        for L in (L_MAX, SHAPES_L):
            peaks = []
            for bs in MEM_BATCHES:
                mcfg = MapConfig(batch_size=bs, max_read_len=L,
                                 rescue_window=max(1200, 2 * L + 1200))
                se, m1, m2 = reads[L]
                peaks.append(batch_peak_bytes(
                    dev, mm, mcfg, m1[: bs // 2] if paired else se[:bs],
                    m2[: bs // 2] if paired else None))
            raw[f"{'paired' if paired else 'single'}_L{L}"] = peaks
            slope[L] = (peaks[1] - peaks[0]) / (MEM_BATCHES[1]
                                                - MEM_BATCHES[0])
            fit[f"intercept_{'paired' if paired else 'single'}_L{L}"] = \
                peaks[0] - slope[L] * MEM_BATCHES[0]
        b = (slope[SHAPES_L] - slope[L_MAX]) / (SHAPES_L - L_MAX)
        key = "paired" if paired else "single"
        fit[f"bytes_per_read_{key}"] = {str(L): slope[L] for L in slope}
        fit[f"fit_{key}"] = [slope[L_MAX] - b * L_MAX, b]
    free, total = torch.cuda.mem_get_info(dev)
    return {"tables_bytes": tables, "peaks_above_base": raw, **fit,
            "cuda_context_bytes": total - free
            - torch.cuda.memory_reserved(dev),
            "total_memory": total}


def phase_cli(dev, w: dict, aligned: dict, smi: str, work: str) -> dict:
    """Phase 10: the command line, in this process through
    urmap_tpu_torch.cli.main (the counters are read around each -map),
    and once as ``python -m urmap_tpu_torch``. Returns the counts of its
    paths: cli (-batch 16,384 over the slice's reads), endclip, endclip
    paired and secondpass."""
    import contextlib
    import io
    import shutil

    import torch

    from urmap_tpu_torch import cli
    from urmap_tpu_torch.config import MapConfig
    from urmap_tpu_torch.index import UfiIndex
    from urmap_tpu_torch.io.fastq import FastqReader
    from urmap_tpu_torch.map import Mapper
    from urmap_tpu_torch.map.cigar import cigars_nm_blob
    from urmap_tpu_torch.map.pair import PairedMapper

    db, paths = w["db"], {}
    ufi = os.path.join(work, "cli.ufi")
    sam = os.path.join(work, "cli.sam")
    shutil.rmtree(ufi, ignore_errors=True)
    # 1. the index from the FASTA, and its statistics
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        check(cli.main(["-make_ufi", w["fasta"], "-output", ufi]) == 0,
              "-make_ufi")
    t1 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(cli.main(["-ufistats", ufi]) == 0, "-ufistats")
    index_bytes = sum(os.path.getsize(os.path.join(d, n))
                      for d, _, names in os.walk(ufi) for n in names)
    emit({"phase": "cli_index", "make_ufi_s": t1 - t0,
          "ufistats_s": time.perf_counter() - t1, "index_bytes": index_bytes,
          "ufistats": out.getvalue().splitlines()[:4]})

    # 2. -map at -batch B over the slice's reads: phase 4's SAM body
    reset_counters()
    run = cli_map(dev, ["-map", w["reads_half"], "-ufi", ufi, "-samout", sam,
                        "-batch", str(B), "-quiet"])
    paths["cli"] = counts = read_counters()
    body = sam_records(sam)
    nb = -(-w["n_half"] // B)
    emit({"phase": "cli", "gpu": smi, "host_cpu": cpu_model(),
          "batch": B, **run, "batches": nb, "counters": counts,
          "sam_equals_phase4": b"".join(body) == aligned["sam"]})
    check(b"".join(body) == aligned["sam"],
          "cli -map: the SAM body differs from phase 4's")
    check_counters(counts, "cli -map")
    check(counts["tb_dops"]["launches"] == nb,
          f"cli -map: tb_dops launches {counts['tb_dops']['launches']} != "
          f"batches {nb}")

    # 3. the default batch with the auto-fit, then the sweep, over the
    # reads SWEEP_COPIES times; a warm run at the default batch first,
    # then each batch twice, in turns
    sweep_fq = os.path.join(work, "reads_sweep.fq")
    with open(w["reads"], "rb") as f:
        data = f.read()
    with open(sweep_fq, "wb") as f:
        for _ in range(SWEEP_COPIES):
            f.write(data)
    fit_batch = cli._auto_batch({}, UfiIndex.load(ufi),
                                MapConfig(batch_size=65_536), True,
                                dev).batch_size
    sweep_out = os.path.join(work, "cli_sweep.sam")
    cli_map(dev, ["-map", w["reads_half"], "-ufi", ufi, "-samout",
                  sweep_out, "-quiet"])
    sweep = {}
    for bs in (None,) + SWEEP + SWEEP[::-1] + (None,):
        extra = [] if bs is None else ["-batch", str(bs), "-quiet"]
        sweep.setdefault("default" if bs is None else str(bs), []).append(
            cli_map(dev, ["-map", sweep_fq, "-ufi", ufi, "-samout",
                          sweep_out, *extra]))
    emit({"phase": "cli_batch", "gpu": smi, "host_cpu": cpu_model(),
          "cpu_count": os.cpu_count(),
          "reads": SWEEP_COPIES * len(w["codes"]),
          "auto_fit_batch": fit_batch, "runs": sweep})
    check(fit_batch == 65_536, f"the auto-fit took {fit_batch} on the card")
    mem = phase_memory(dev, w)
    emit({"phase": "cli_memory", "gpu": smi, **mem,
          "allocator_slack_bytes": {
              k: max(r["max_memory_reserved"] - r["max_memory_allocated"]
                     for r in v) for k, v in sweep.items()}})

    # 4. -endclip over the slice's reads
    mcfg_ec = MapConfig(batch_size=B, end_clip=True)
    reset_counters()
    ec_sam = os.path.join(work, "cli_endclip.sam")
    run = cli_map(dev, ["-map", w["reads_half"], "-ufi", ufi, "-samout",
                        ec_sam, "-batch", str(B), "-endclip", "-quiet"])
    paths["endclip"] = counts = read_counters()
    recs = sam_records(ec_sam)
    calls = sam_calls(recs, db.starts)
    n = w["n_half"]
    truth, strand = w["truth"][:n], w["strand"][:n]
    planted = truth >= 0
    ok = (calls["mapped"] == 1) & (calls["strand"] == strand) \
        & (calls["pos"] == truth)
    frac = float(ok[planted].mean())
    # the first reads on a CPU Mapper, and on the card through the Mapper
    card = Mapper(w["index"], mcfg_ec, device=dev, prepared=w["prepared"])
    cpu = Mapper(w["index"], mcfg_ec, device="cpu", prepared=w["prepared"])
    fq_ec = os.path.join(work, "reads_ec_cpu.fq")
    write_fastq(fq_ec, w["codes"][:N_EC_CPU])
    t2 = time.perf_counter()
    cpu_results, cpu_sam = map_fastq(cpu, db, fq_ec, B, None)
    cpu_s = time.perf_counter() - t2
    card_results, _ = map_fastq(card, db, fq_ec, B, None)
    diff = differing(concat_results(cpu_results),
                     concat_results(card_results))
    same_sam = cpu_sam == b"".join(recs[:N_EC_CPU])
    # the host's clip-mode DP on one batch of the card's calls
    b = next(iter(FastqReader(w["reads_half"], batch_size=B)))
    res = card.map_codes(b.codes, b.lengths)
    clip_ms = []
    for _ in range(3):
        t3 = time.perf_counter()
        cigars_nm_blob(db.codes, b.codes, res, card.sc,
                       raw_lengths=b.seq_len, clip_open=card.sc.clip_open,
                       clip_rows=res.clipped)
        clip_ms.append((time.perf_counter() - t3) * 1e3)
    # one end-clip batch under torch.profiler: device time by kernel
    pk = card.prepack(b.codes, b.lengths)
    prof = profile_call(lambda: card.finish_batch(card.start_batch(
        b.codes, b.lengths, prepacked=pk), b.lengths),
        os.path.join(work, "profile_endclip.txt"))
    emit({"phase": "cli_endclip", "gpu": smi, "host_cpu": cpu_model(),
          **run, "batches": nb, "correct_frac": frac,
          "correct_rule": "mapped, strand as planted, SAM POS less the "
                          "leading soft clip = the planted start",
          "leading_clips": int((calls["lead"] > 0).sum()),
          "soft_clipped": int(sum(b"S" in ln.split(b"\t")[5]
                                  for ln in recs)),
          "junk_unmapped_frac": float(
              (calls["mapped"][~planted] == 0).mean()),
          "counters": counts,
          "kernel_launches_per_batch": sum(c["launches"]
                                           for c in counts.values()) / nb,
          "host_clip_dp_ms_per_batch": statistics.median(clip_ms),
          "host_clip_dp_rows": int((res.mapped & res.gapped).sum()),
          "cpu_reads": N_EC_CPU, "cpu_fields_differing": diff,
          "cpu_sam_identical": same_sam, "cpu_map_s": cpu_s,
          "profile": {k: prof[k] for k in (
              "profiled_wall_ms", "device_busy_ms", "device_idle_share",
              "device_launches", "port_kernels_device_ms")}})
    check_counters(counts, "cli -endclip", end_clip=True)
    check(counts["banded_dp_clip"].get("widths", {}).get(
        2 * (B // mcfg_ec.dp_capacity_frac) * V, 0) > 0,
        "cli -endclip: no B1 clip launch at the main DP's shape")
    check(frac >= 0.99, f"cli -endclip: correct fraction {frac} < 0.99")
    check(not diff, f"cli -endclip: card and CPU differ in {diff}")
    check(same_sam, "cli -endclip: card and CPU SAM bytes differ")

    # 5. -reverse -endclip over the paired phase's pairs
    reset_counters()
    pe_sam = os.path.join(work, "cli_endclip_pe.sam")
    run = cli_map(dev, ["-map", w["r1"], "-reverse", w["r2"], "-ufi", ufi,
                        "-samout", pe_sam, "-batch", str(B), "-endclip",
                        "-quiet"])
    paths["endclip_paired"] = counts = read_counters()
    recs = sam_records(pe_sam)
    calls = sam_calls(recs, db.starts)
    t = w["pair_truth"]
    first = calls["first"] == 1
    i = calls["i"]
    tpos = np.where(first, t["pos1"][i], t["pos2"][i])
    tst = np.where(first, t["strand1"][i], t["strand2"][i])
    pl = t["kind"][i] != 3
    ok = (calls["mapped"] == 1) & (calls["strand"] == tst) \
        & (calls["pos"] == tpos)
    frac = float(ok[pl].mean())
    cpm = PairedMapper(Mapper(w["index"], mcfg_ec, device="cpu",
                              prepared=w["prepared"]))
    gpm = PairedMapper(card)
    b1, b2 = next(iter(FastqReader(w["r1_cpu"], w["r2_cpu"],
                                   batch_size=N_EC_CPU_PAIRS)))
    t2 = time.perf_counter()
    cres = cpm.map_pair_codes(b1.codes, b1.lengths, b2.codes, b2.lengths)
    cpu_s = time.perf_counter() - t2
    gres = gpm.map_pair_codes(b1.codes, b1.lengths, b2.codes, b2.lengths)
    diff = [f"m1.{f}" for f in differing(cres.m1, gres.m1)] \
        + [f"m2.{f}" for f in differing(cres.m2, gres.m2)] \
        + ([] if np.array_equal(cres.proper, gres.proper) else ["proper"])
    # a pair batch's SAM holds its mate-1 records, then its mate-2
    # records: the first pairs' records in file order are both blocks
    head = b"".join(r for r, k in zip(recs, i) if k < N_EC_CPU_PAIRS)
    same_sam = format_pairs(cpm, db, b1, b2, cres) == head
    emit({"phase": "cli_endclip_paired", "gpu": smi, **run,
          "pair_batch": B // 2, "correct_mate_frac": frac,
          "counters": counts, "cpu_pairs": N_EC_CPU_PAIRS,
          "cpu_fields_differing": diff, "cpu_sam_identical": same_sam,
          "cpu_map_s": cpu_s})
    check_counters(counts, "cli -reverse -endclip", end_clip=True)
    check(frac >= 0.99, f"cli -reverse -endclip: correct mates {frac}")
    check(not diff, f"cli -reverse -endclip: card and CPU differ in {diff}")
    check(same_sam, "cli -reverse -endclip: card and CPU SAM bytes differ")

    # 6. -secondpass 32: on this corpus the plain run's SAM
    fq_sp = os.path.join(work, "reads_second.fq")
    write_fastq(fq_sp, w["codes"][:N_SECOND])
    sp_sam = os.path.join(work, "cli_second.sam")
    reset_counters()
    run = cli_map(dev, ["-map", fq_sp, "-ufi", ufi, "-samout", sp_sam,
                        "-batch", str(B), "-secondpass", "32", "-quiet"])
    paths["secondpass"] = counts = read_counters()
    same = b"".join(sam_records(sp_sam)) == b"".join(body[:N_SECOND])
    host_calls = sum(c.get("host_pass_calls", 0) for c in counts.values())
    emit({"phase": "cli_secondpass", "gpu": smi, **run,
          "sam_equals_plain": same, "host_pass_calls": host_calls,
          "counters": counts})
    check_counters(counts, "cli -secondpass")
    check(host_calls > 0, "cli -secondpass: the second pass ran nothing")
    check(same, "cli -secondpass 32: SAM differs from the plain run's")

    # 7. python -m urmap_tpu_torch in a process of its own
    fq_sub = os.path.join(work, "reads_sub.fq")
    write_fastq(fq_sub, w["codes"][:N_SUB])
    sub_sam = os.path.join(work, "cli_sub.sam")
    t2 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "urmap_tpu_torch", "-map", fq_sub, "-ufi",
         ufi, "-samout", sub_sam, "-batch", str(B), "-quiet"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    same = proc.returncode == 0 and \
        b"".join(sam_records(sub_sam)) == b"".join(body[:N_SUB])
    emit({"phase": "cli_subprocess", "rc": proc.returncode,
          "seconds": time.perf_counter() - t2, "sam_identical": same,
          "stderr": proc.stderr[-300:]})
    check(same, "python -m urmap_tpu_torch -map: SAM differs")
    torch.cuda.synchronize(dev)
    return paths


# ---- phases 11-13: the tiered gather, the spill build, past 2^31 --------

def read_tier_rounds() -> dict:
    from urmap_tpu_torch.kernels import tier_rounds

    return {"calls": tier_rounds.calls, "rounds": tier_rounds.rounds}


def count_syncs(fn) -> dict:
    """The host syncs one call of ``fn`` makes, as the card reports them
    under torch.cuda.set_sync_debug_mode("warn"), by site ("file:line"
    of the Python line that made each): each synchronizing operation (a
    tensor read back by the host, a nonzero, a blocking copy to the
    host) warns once."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for c in caught:
        if "synchronizing CUDA operation" in str(c.message):
            at = f"{os.path.relpath(c.filename, ROOT)}:{c.lineno}"
            sites[at] = sites.get(at, 0) + 1
    return sites


def batch_profile_turns(mappers: dict, b, order, work: str) -> dict:
    """torch.profiler over one start_batch + finish_batch of each named
    Mapper, in the turns ``order`` → name → list of (device busy ms,
    device launches)."""
    out = {k: [] for k in mappers}
    for i, name in enumerate(order):
        m = mappers[name]
        pk = m.prepack(b.codes, b.lengths)
        prof = profile_call(lambda: m.finish_batch(
            m.start_batch(b.codes, b.lengths, prepacked=pk), b.lengths),
            os.path.join(work, f"profile_{name}_{i}.txt"))
        out[name].append([prof["device_busy_ms"], prof["device_launches"]])
    return out


def phase_tier(dev, w: dict, aligned: dict, untiered, smi: str,
               work: str) -> dict:
    """Phase 11: the tiered gather (URMAP_TIER_GATHER=1) over phase 4's
    aligned tables and reads, and over the first N_CPU_PAIRS pairs of
    phase 7 on the aligned tables: results, live traceback records and
    SAM bytes equal to the untiered runs'; B5 at the tier width once a
    batch plus one full-width launch an overflow round."""
    import torch

    from urmap_tpu_torch.io.fastq import FastqReader
    from urmap_tpu_torch.kernels import seed_slots
    from urmap_tpu_torch.map import Mapper
    from urmap_tpu_torch.map.pair import PairedMapper
    from urmap_tpu_torch.map.seed import gather_runs

    ht, meta = w["prepared"]
    check(meta["layout"] == "aligned", f"phase 4's layout {meta['layout']}")
    tier, forced = meta["gather_tier"], meta["gather_tier"] is None
    if forced:
        # as tests/integration/test_torch_pipeline.py sets it
        tier, meta = 4, {**meta, "gather_tier": 4}
    os.environ["URMAP_TIER_GATHER"] = "1"
    try:
        mapper = Mapper(w["index"], untiered.mcfg, untiered.sc, device=dev,
                        prepared=(ht, meta))
    finally:
        del os.environ["URMAP_TIER_GATHER"]
    check(mapper.gather_tier == tier and untiered.gather_tier is None,
          "the tier switch of the Mappers")
    n = w["n_half"]
    run = run_single_end(dev, w, mapper, "tier", w["reads_half"], n, B, smi,
                         os.path.join(work, "out_tier.sam"))
    rounds = read_tier_rounds()
    counts = run["counts"]
    nb = len(run["results"])
    widths = counts["row128_fetch"].get("widths", {})
    diff = differing(run["res"], aligned["res"])
    tb_diff = sorted({k for a, b in zip(run["results"], aligned["results"])
                      for k in tb_differing(a.tb, b.tb)})
    # the share of valid seeds over the tier, from the seed front of the
    # first batch (a launch outside the counted run)
    b = next(iter(FastqReader(w["reads_half"], batch_size=B)))
    pk, nm, lens, _ = mapper.prepack(b.codes, b.lengths)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    _rp, _rn, offs, valid, start, cnt = seed_slots.seed_front(
        put(pk), put(nm), put(lens), mapper.mcfg.max_read_len, k=K, q=Q,
        slot_bits=w["index"].config.slot_bits,
        offsets=mapper.tables["offsets"])
    over = float(((cnt > tier) & valid).sum() / valid.sum())
    prof = batch_profile_turns({"untiered": untiered, "tier": mapper}, b,
                               ("untiered", "tier", "tier", "untiered"),
                               work)
    # the host syncs of that batch and of its gather alone, each way, and
    # the tier's rounds in each
    syncs = {}
    for name, m in (("untiered", untiered), ("tier", mapper)):
        pk1 = m.prepack(b.codes, b.lengths)
        reset_counters()
        sites = count_syncs(lambda: m.finish_batch(
            m.start_batch(b.codes, b.lengths, prepacked=pk1), b.lengths))
        syncs[name] = sum(sites.values())
        syncs[f"{name}_sites"] = sites
    syncs["tier_rounds"] = read_tier_rounds()["rounds"]
    for name, t in (("untiered", None), ("tier", tier)):
        reset_counters()
        sites = count_syncs(lambda: gather_runs(
            mapper.tables["positions"], start, cnt, offs, valid, p=P,
            csr_aligned=True, tier=t))
        syncs[f"gather_{name}"] = sum(sites.values())
        syncs[f"gather_{name}_sites"] = sites
    syncs["gather_tier_rounds"] = read_tier_rounds()["rounds"]

    # the first pairs of phase 7 through PairedMapper on the aligned
    # tables, tiered and untiered
    reset_counters()
    pt, pt_sam = map_pairs_fastq(PairedMapper(mapper), w["db"], w["r1_cpu"],
                                 w["r2_cpu"])
    pair_rounds = read_tier_rounds()
    pair_counts = read_counters()
    pu, pu_sam = map_pairs_fastq(PairedMapper(untiered), w["db"],
                                 w["r1_cpu"], w["r2_cpu"])
    a1, a2, ap = concat_pairs(pt)
    c1, c2, cp = concat_pairs(pu)
    pdiff = [f"m1.{f}" for f in differing(a1, c1)] \
        + [f"m2.{f}" for f in differing(a2, c2)] \
        + ([] if np.array_equal(ap, cp) else ["proper"])
    ptb = sorted({f"{m}.{k}" for x, y in zip(pt, pu) for m in ("m1", "m2")
                  for k in tb_differing(getattr(x, m).tb, getattr(y, m).tb)})
    emit({"phase": "tier_vs_untiered", "gpu": smi, "tier": tier,
          "tier_set_by_smoke": forced, "reads": n, "batches": nb,
          "fields_differing": diff, "tb_keys_differing": tb_diff,
          "sam_identical": run["sam"] == aligned["sam"],
          "row128_fetch_widths": widths,
          "overflow_rounds_per_batch": rounds["rounds"] / nb,
          "host_syncs_one_batch": syncs,
          "seeds_over_tier_share": over,
          "profile_busy_ms_launches": prof,
          "pairs": N_CPU_PAIRS, "pair_fields_differing": pdiff,
          "pair_tb_keys_differing": ptb, "pair_sam_identical": pt_sam == pu_sam,
          "pair_overflow_rounds_per_batch": pair_rounds["rounds"]
          / max(pair_rounds["calls"], 1),
          "pair_row128_fetch_widths": pair_counts["row128_fetch"].get(
              "widths", {})})
    check(not diff, f"tier and untiered differ in {diff}")
    check(not tb_diff, f"tier and untiered tb records differ in {tb_diff}")
    check(run["sam"] == aligned["sam"], "tier and untiered: SAM bytes differ")
    check(rounds["calls"] == nb, f"tier calls {rounds} != batches {nb}")
    check(widths.get(tier, 0) == nb
          and counts["row128_fetch"]["launches"] == nb + rounds["rounds"]
          and widths.get(P, 0) == rounds["rounds"],
          f"row128_fetch launches {counts['row128_fetch']} against {nb} "
          f"batches and {rounds['rounds']} overflow rounds")
    check(not pdiff and not ptb, f"paired tier and untiered differ in "
          f"{pdiff + ptb}")
    check(pt_sam == pu_sam, "paired tier and untiered: SAM bytes differ")
    check_counters(pair_counts, "the paired tier run")
    return {"counts": counts, "batches": nb, **rounds,
            "host_syncs_one_batch": syncs}


# phase 12's small chunk: the chr21-length genome in several chunks
SPILL_SMALL_CHUNK = 1 << 23


def phase_spill(w: dict, work: str) -> None:
    """Phase 12: phase 4's index built again through the disk radix spill
    (spill_threshold 2^20 words, 256 buckets on disk), in one host chunk
    and in chunks of SPILL_SMALL_CHUNK words, each equal to the in-RAM
    build; the bytes the buckets held on disk, and the spill directory
    gone afterwards."""
    import shutil

    from urmap_tpu_torch.index import build as bmod

    spill_dir = os.path.join(work, "spill")
    shutil.rmtree(spill_dir, ignore_errors=True)
    os.makedirs(spill_dir)
    cfg = w["index"].config
    t0 = time.perf_counter()
    inram = bmod.build_index(w["db"], cfg, backend="host")
    inram_s = time.perf_counter() - t0
    on_disk = []
    real = bmod._RadixSpill.finalize

    def measured(self, *a):
        for f in self.files:
            f.flush()
        on_disk.append(sum(os.path.getsize(p) for p in self.paths))
        return real(self, *a)

    chunks = []
    real_add = bmod._RadixSpill.add_partitioned

    def counted(self, *a):
        chunks[-1] += 1
        return real_add(self, *a)

    bmod._RadixSpill.finalize = measured
    bmod._RadixSpill.add_partitioned = counted
    spilled, seconds, same = {}, {}, {}
    try:
        # the default chunk (one), then SPILL_SMALL_CHUNK words a chunk
        for name, chunk in (("one_chunk", bmod.HOST_CHUNK),
                            ("chunked", SPILL_SMALL_CHUNK)):
            chunks.append(0)
            t1 = time.perf_counter()
            spilled[name] = bmod.build_index(
                w["db"], cfg, chunk=chunk, spill_threshold=1 << 20,
                spill_dir=spill_dir, backend="host")
            seconds[name] = time.perf_counter() - t1
            same[name] = (
                np.array_equal(spilled[name].offsets, w["index"].offsets)
                and np.array_equal(spilled[name].positions,
                                   w["index"].positions))
    finally:
        bmod._RadixSpill.finalize = real
        bmod._RadixSpill.add_partitioned = real_add
    inram_same = np.array_equal(inram.positions, w["index"].positions)
    left = os.listdir(spill_dir)
    emit({"phase": "spill", "genome_bases": int(w["db"].total_len),
          "slot_bits": cfg.slot_bits, "inram_build_s": inram_s,
          "spill_build_s": seconds, "chunks": chunks,
          "spill_bytes": on_disk,
          "positions": int(spilled["one_chunk"].num_positions),
          "equal_to_inram": same, "inram_equal_to_phase4": inram_same,
          "spill_dir_left": left})
    check(len(on_disk) == 2 and min(on_disk) > 0,
          "the spill path did not run")
    check(chunks[0] == 1 and chunks[1] > 1, f"spill chunks {chunks}")
    check(all(same.values()) and inram_same,
          f"the spill build differs from the in-RAM build: {same}")
    check(not left, f"the spill left {left}")


# phase 13's genome: 2^31 + 2^26 bases, the real sequence from
# SCALE_REAL_START on (three chromosomes), N chromosomes before it;
# SCALE_POINT is the coordinate its checks count reads past
SCALE_POINT = 1 << 31
SCALE_TOTAL = SCALE_POINT + (1 << 26)
SCALE_REAL_START = SCALE_POINT - (1 << 24)
SCALE_N_CHROMS = 8
SCALE_REAL_CHROMS = 3


def scale_seqdb(rng):
    """A SeqDB of SCALE_TOTAL bases built in memory: SCALE_N_CHROMS
    chromosomes of N up to SCALE_REAL_START, then SCALE_REAL_CHROMS of
    make_genome's sequence, the first straddling global position 2^31
    (kept free of N there). Separators between all of them, as
    SeqDB.from_seqs lays them out."""
    from urmap_tpu_torch import alphabet
    from urmap_tpu_torch.io.fasta import SEPARATOR_LEN, SeqDB
    from urmap_tpu_torch.utils.bigmem import big_empty

    sep = SEPARATOR_LEN
    codes = big_empty(SCALE_TOTAL, np.uint8)
    codes[...] = alphabet.GENOME_N
    n_len = (SCALE_REAL_START - sep) // SCALE_N_CHROMS - sep
    r_len = (SCALE_TOTAL - SCALE_REAL_START) // SCALE_REAL_CHROMS - sep
    starts, lengths, labels = [], [], []
    pos = sep
    for i in range(SCALE_N_CHROMS + SCALE_REAL_CHROMS):
        real = i >= SCALE_N_CHROMS
        if real and pos < SCALE_REAL_START:
            pos = SCALE_REAL_START
        ln = r_len if real else n_len
        if real:
            codes[pos : pos + ln] = make_genome(rng, ln)
        starts.append(pos)
        lengths.append(ln)
        labels.append(f"chr{i + 1}" if real else f"chrN{i + 1}")
        pos += ln + sep
    a = SCALE_POINT
    check(pos <= SCALE_TOTAL and starts[SCALE_N_CHROMS] < a
          < starts[SCALE_N_CHROMS] + lengths[SCALE_N_CHROMS],
          "the scale genome's layout")
    codes[a - 1000 : a + 1000] = rng.integers(0, 4, 2000, dtype=np.uint8)
    return SeqDB(labels=labels, starts=np.asarray(starts, np.int64),
                 lengths=np.asarray(lengths, np.int64), codes=codes)


def peak_rss_bytes() -> int:
    """This process's peak resident set so far (getrusage)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def phase_scale(dev, mcfg, sc, smi: str, work: str, seed: int,
                n_reads: int = 65_536, n_cpu: int = 1024) -> dict:
    """Phase 13: genome coordinates past 2^31 on the main path. The
    genome (scale_seqdb) is built in memory; its 2.2G words take
    build_index's spill path by themselves; prepare_tables picks the
    layout; reads planted in the real chromosomes (some straddling 2^31)
    map through the card's Mapper with the slice's checks, counted
    apart past 2^31; the first n_cpu reads again on a CPU Mapper over
    the same tables: MapResult, tb records and SAM bytes identical."""
    import torch

    from urmap_tpu_torch.config import IndexConfig
    from urmap_tpu_torch.index import build_index
    from urmap_tpu_torch.index import build as bmod
    from urmap_tpu_torch.index.store import prepare_tables
    from urmap_tpu_torch.map import Mapper

    rng = np.random.default_rng([seed, 13])
    rss_before = peak_rss_bytes()
    t0 = time.perf_counter()
    db = scale_seqdb(rng)
    t1 = time.perf_counter()
    check(db.codes.shape[0] - K + 1 > bmod.SPILL_THRESHOLD,
          "the scale genome does not pass the spill threshold")
    index = build_index(db, IndexConfig(slot_bits=27), backend="host")
    t2 = time.perf_counter()
    prepared = prepare_tables(index, P)
    t3 = time.perf_counter()
    mapper = Mapper(index, mcfg, sc, device=dev, prepared=prepared)
    torch.cuda.synchronize(dev)
    t4 = time.perf_counter()
    card_bytes = sum(v.numel() * v.element_size()
                     for v in mapper.tables.values()
                     if isinstance(v, torch.Tensor))
    lo = int(db.starts[SCALE_N_CHROMS])
    hi = int(db.starts[-1] + db.lengths[-1])
    a = SCALE_POINT
    pin = a - rng.integers(1, READ_LEN, size=256)
    codes, truth, strand = plant_reads(rng, db, n_reads, span=(lo, hi),
                                       pin=pin)
    fq = os.path.join(work, "scale.fq")
    fq_cpu = os.path.join(work, "scale_cpu.fq")
    write_fastq(fq, codes)
    write_fastq(fq_cpu, codes[:n_cpu])
    w = {"db": db, "index": index, "codes": codes, "truth": truth,
         "strand": strand}
    run = run_single_end(dev, w, mapper, "scale", fq, n_reads, B, smi,
                         os.path.join(work, "out_scale.sam"))
    res = run["res"]
    planted = truth >= 0
    correct = res.mapped & (res.pos == truth) & (res.strand == strand)
    past = planted & (truth >= a)
    straddle = planted & (truth < a) & (truth + READ_LEN > a)
    frac_past = float(correct[past].mean())
    # the first reads on the card alone and on a CPU Mapper
    on_results, on_sam = map_fastq(mapper, db, fq_cpu, B, None)
    cpu = Mapper(index, mcfg, sc, device="cpu", prepared=prepared)
    cpu_results, cpu_sam = map_fastq(cpu, db, fq_cpu, B, None)
    diff = differing(concat_results(cpu_results),
                     concat_results(on_results))
    tb_diff = sorted({k for x, y in zip(cpu_results, on_results)
                      for k in tb_differing(x.tb, y.tb)})
    head = b"\n".join(run["sam"].split(b"\n")[:n_cpu]) + b"\n"
    meta = prepared[1]
    emit({"phase": "scale_result", "gpu": smi,
          "genome_bases": int(db.total_len), "chromosomes": len(db.labels),
          "real_span": [lo, hi], "slot_bits": 27,
          "layout": meta["layout"], "off_bits": meta["off_bits"],
          "positions": int(index.num_positions),
          "table_words": int(prepared[0]["positions"].size),
          "setup_s": {"genome": t1 - t0, "build": t2 - t1,
                      "prepare": t3 - t2, "upload": t4 - t3},
          "card_table_bytes": card_bytes,
          "peak_rss_bytes": peak_rss_bytes(),
          "peak_rss_before_phase_bytes": rss_before,
          "reads_past_2^31": int(past.sum()),
          "correct_frac_past_2^31": frac_past,
          "straddling_2^31": int(straddle.sum()),
          "correct_straddling": int(correct[straddle].sum()),
          "max_pos": int(res.pos[res.mapped].max()),
          "cpu_reads": n_cpu, "fields_differing": diff,
          "tb_keys_differing": tb_diff, "sam_identical": cpu_sam == on_sam,
          "alone_equals_full_run": on_sam == head})
    check(meta["layout"] == "row128", f"layout {meta['layout']}")
    check(past.sum() > n_reads // 2 and straddle.sum() > 0,
          "too few reads past 2^31")
    check(frac_past >= 0.99, f"correct fraction past 2^31 {frac_past}")
    check(not diff, f"scale: card and CPU differ in {diff}")
    check(not tb_diff, f"scale: card and CPU tb records differ in {tb_diff}")
    check(cpu_sam == on_sam, "scale: card and CPU SAM bytes differ")
    check(on_sam == head, "scale: the first reads map differently alone")
    return run["counts"]


# ---- phase 14: multi-device mapping -------------------------------------

N_MESH, N_MESH_PAIRS = 16_384, N_CPU_PAIRS    # phase 14b's reads and pairs
MESH4 = ((1, 4), (2, 2))                      # (data, index) of 14b
MESH_TIMEOUT_S = 420


def save_prepared_arrays(prepared, d: str) -> None:
    """Prepared tables (host arrays and meta) as .npy files and a pickle
    of the rest, for rank processes to map in (memory-mapped)."""
    import pickle

    ht, meta = prepared
    os.makedirs(d, exist_ok=True)
    arrays = [k for k, v in ht.items() if isinstance(v, np.ndarray)]
    for k in arrays:
        np.save(os.path.join(d, f"{k}.npy"), ht[k])
    rest = {k: v for k, v in ht.items() if k not in arrays}
    with open(os.path.join(d, "meta.pkl"), "wb") as f:
        pickle.dump((meta, rest, arrays), f)


def load_prepared_arrays(d: str):
    import pickle

    with open(os.path.join(d, "meta.pkl"), "rb") as f:
        meta, rest, arrays = pickle.load(f)
    ht = {k: np.load(os.path.join(d, f"{k}.npy"), mmap_mode="r")
          for k in arrays}
    ht.update(rest)
    return ht, meta


def add_counts(total: dict, counts: dict) -> dict:
    """Kernel counters summed (launches, plain calls, widths)."""
    for name, c in counts.items():
        t = total.setdefault(name, {"launches": 0, "plain_calls": 0})
        t["launches"] += c["launches"]
        t["plain_calls"] += c["plain_calls"]
        for wd, n in c.get("widths", {}).items():
            t.setdefault("widths", {})     # (JSON made the keys strings)
            t["widths"][int(wd)] = t["widths"].get(int(wd), 0) + n
    return total


def check_mesh_counters(counts: dict, what: str) -> None:
    """The sharded path's kernels: the seed front's slots mode (never the
    front proper), B5's row entry, B4, B1 and B6 launched; no plain
    version ran."""
    for name in ("seed_front_slots", "row128_fetch", "vote", "banded_dp",
                 "tb_dops"):
        check(counts[name]["launches"] > 0,
              f"{what}: {name} not launched")
    check(counts["seed_front"]["launches"] == 0,
          f"{what}: the seed front proper ran on the sharded path")
    for name, c in counts.items():
        check(c["plain_calls"] == 0, f"{what}: {name} plain version ran")


def live_tb_differing(a: dict, b: dict) -> list:
    """Keys of two traceback dicts whose live records differ: rows,
    score, pos, strand and the dops words of the live lanes. The lanes'
    column numbers are not compared: a sharded batch puts each rank's
    lanes in a block of its own."""
    out = [k for k in ("rows", "score", "pos", "strand")
           if not np.array_equal(a[k], b[k])]
    if not np.array_equal(a["dops"][:, a["cols"]], b["dops"][:, b["cols"]]):
        out.append("dops")
    return out


def same_results(a: list, b: list, what: str) -> None:
    """Per-batch MapResults: every field and the live traceback records."""
    check(len(a) == len(b), f"{what}: {len(a)} batches vs {len(b)}")
    diff = sorted({f for x, y in zip(a, b) for f in differing(x, y)})
    tb_diff = sorted({k for x, y in zip(a, b)
                      for k in live_tb_differing(x.tb, y.tb)})
    check(not diff, f"{what}: fields differ: {diff}")
    check(not tb_diff, f"{what}: traceback records differ: {tb_diff}")


def per_batch(comm: dict, batches: int) -> dict:
    return {"collectives": {k: v / batches for k, v in comm["calls"].items()},
            "bytes_sent": {k: v / batches for k, v in comm["bytes"].items()},
            "a2a_rounds": comm["a2a_rounds"] / batches,
            "a2a_loops": comm["a2a_loops"] / batches}


def mesh_rank_main(mdir: str) -> int:
    """One rank of phase 14b, started by the smoke with torchrun's
    environment (python3 chip_smoke.py --mesh-rank DIR): every mesh and
    route of the spec over the same reads and pairs; rank 0 writes the
    results and SAM bytes, every rank its counters, collectives and one
    profiled batch."""
    import pickle

    import torch

    from urmap_tpu_torch.config import MapConfig
    from urmap_tpu_torch.dist import multihost as mh
    from urmap_tpu_torch.dist import sharded as sh
    from urmap_tpu_torch.index import UfiIndex
    from urmap_tpu_torch.index.store import load_prepared
    from urmap_tpu_torch.io.fastq import FastqReader

    with open(os.path.join(mdir, "spec.json")) as f:
        spec = json.load(f)
    backend = mh.init_distributed("cuda")
    dev = mh.rank_device("cuda")
    rank = mh.process_index()
    index = UfiIndex.load(spec["ufi"])
    db = index.seqdb
    mcfg = MapConfig(batch_size=B)
    tables = {"aligned": load_prepared(index, mcfg.positions_per_seed),
              "row128": load_prepared_arrays(spec["prepared128"])}
    check(tables["aligned"][1]["layout"] == "aligned", "14b: aligned tables")
    b = next(iter(FastqReader(spec["reads"], batch_size=B)))
    out = {"rank": rank, "backend": backend, "device": str(dev),
           "staged_by_port": [], "cases": {}}
    results = {}
    for name, d, i, route, slack in spec["cases"]:
        if slack is not None:
            os.environ["URMAP_A2A_SLACK"] = str(slack)
        mesh = sh.make_mesh(data=d, index=i)
        m = sh.ShardedMapper(index, mesh, mcfg, route=route, device=dev,
                             prepared=tables["aligned"])
        os.environ.pop("URMAP_A2A_SLACK", None)
        m.map_codes(b.codes[:2048], b.lengths[:2048])           # warm
        reset_counters()
        m.comm.reset()
        t0 = time.perf_counter()
        se, se_sam = map_fastq(m, db, spec["reads"], B, None)
        torch.cuda.synchronize(dev)
        rec = {"se_map_s": time.perf_counter() - t0,
               "se_counters": read_counters(),
               "se_per_batch": per_batch(m.comm.snapshot(), len(se)),
               "a2a_slack": m.a2a_slack}
        if slack is None:
            # a pair batch of the pairs there are, so that every rank maps
            # some (a batch of phase 7's 8,192 would leave three ranks of
            # a 1 x 4 mesh with padding only)
            pm = sh.ShardedPairedMapper(sh.ShardedMapper(
                index, mesh, MapConfig(batch_size=2 * N_MESH_PAIRS),
                route=route, device=dev, prepared=tables["row128"]))
            reset_counters()
            pm.mapper.comm.reset()
            t0 = time.perf_counter()
            pe, pe_sam = map_pairs_fastq(pm, db, spec["r1"], spec["r2"])
            torch.cuda.synchronize(dev)
            rec.update(pe_map_s=time.perf_counter() - t0,
                       pe_counters=read_counters(),
                       pe_per_batch=per_batch(pm.mapper.comm.snapshot(),
                                              len(pe)))
            # one single-end batch under the profiler, on every rank
            m.comm.reset()
            prof = profile_call(
                lambda: m.finish_batch(m.start_batch(b.codes, b.lengths),
                                       b.lengths),
                os.path.join(mdir, f"profile_{name}_rank{rank}.txt"),
                tries=1)
            rec["profile_one_batch"] = {
                k: prof[k] for k in ("profiled_wall_ms", "device_busy_ms",
                                     "device_idle_share",
                                     "device_launches",
                                     "port_kernels_device_ms")}
            results[name] = {"se": se, "se_sam": se_sam, "pe": pe,
                             "pe_sam": pe_sam}
        else:
            results[name] = {"se": se, "se_sam": se_sam}
        out["cases"][name] = rec
        mh.barrier(name)
    with open(os.path.join(mdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if rank == 0:
        with open(os.path.join(mdir, "results.pkl"), "wb") as f:
            pickle.dump(results, f)
    mh.barrier("done")
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(n: int, cmd: list, log_dir: str) -> list:
    """n processes of ``cmd`` with torchrun's environment, all on this
    card, stdout and stderr to log files; waits for all (killing every
    one on a failure or past MESH_TIMEOUT_S) → their wall seconds."""
    port = str(free_port())
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(n):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="localhost", MASTER_PORT=port)
            log = open(os.path.join(log_dir, f"rank{r}.log"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                          stdout=log, stderr=log))
        for p in procs:
            p.wait(timeout=max(1.0, MESH_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(log_dir, f"rank{r}.log"), "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            check(False, f"rank {r} of {n} ({' '.join(cmd[-8:])}) exited "
                  f"{p.returncode}:\n{tail}")
    return wall


def phase_mesh(dev, w: dict, aligned: dict, smi: str, work: str) -> dict:
    """Phase 14: multi-device mapping on the one card.

    14a mesh1: this process joins a world of one rank over NCCL; a
    ShardedMapper at mesh 1 x 1, route a2a and then psum, maps phase 4's
    reads: results, live records and SAM bytes equal phase 4's.
    14b mesh4: four rank processes share the card over gloo with CUDA
    tensors: meshes 1 x 4 and 2 x 2, both routes, over phase 4's first
    16,384 reads (aligned tables) and phase 7's first 2,048 pairs (row128
    tables), and one a2a run with the lane slack at 0.3 (overflow
    rounds): equal to the single-card runs, the kernels launched on
    every rank and no plain call.
    14c cli_mp: the command line as 2 processes (data-parallel -map over
    phase 10's FASTQ: the merged body equals phase 10's) and as 4 at
    -mesh 2x2 -route a2a, single-end and -reverse (the bodies hold the
    single-process records, in the order of the ranks' rows).
    Returns the kernel counts of the sharded runs and the a2a rounds."""
    import pickle

    import torch
    import torch.distributed as dist

    from urmap_tpu_torch.config import MapConfig
    from urmap_tpu_torch.dist import multihost as mh
    from urmap_tpu_torch.dist import sharded as sh

    mdir = os.path.join(work, "mesh")
    os.makedirs(mdir, exist_ok=True)
    mcfg = MapConfig(batch_size=B)
    total = {}
    rounds = {"a2a_loops": 0, "a2a_rounds": 0}

    # 14a: a world of one rank over NCCL
    t0 = time.perf_counter()
    backend = mh.init_distributed(dev)
    check(backend == "nccl", f"14a: backend {backend}, expected nccl")
    mesh = sh.make_mesh()
    rec = {"phase": "mesh1", "gpu": smi, "backend": backend,
           "world": dist.get_world_size(), "mesh": mesh.shape, "routes": {}}
    for route in ("a2a", "psum"):
        m = sh.ShardedMapper(w["index"], mesh, mcfg, route=route, device=dev,
                             prepared=w["prepared"])
        reset_counters()
        m.comm.reset()
        t1 = time.perf_counter()
        results, sam = map_fastq(m, w["db"], w["reads_half"], B, None)
        torch.cuda.synchronize(dev)
        map_s = time.perf_counter() - t1
        counts = read_counters()
        comm = m.comm.snapshot()
        same_results(results, aligned["results"], f"14a {route}")
        check(sam == aligned["sam"], f"14a {route}: SAM bytes differ")
        check_mesh_counters(counts, f"14a {route}")
        add_counts(total, counts)
        rounds["a2a_loops"] += comm["a2a_loops"]
        rounds["a2a_rounds"] += comm["a2a_rounds"]
        rec["routes"][route] = {
            "reads": w["n_half"], "batches": len(results), "map_s": map_s,
            "reads_per_s": w["n_half"] / map_s,
            "per_batch": per_batch(comm, len(results)),
            "equal_to_phase4": True}
        del m
    dist.destroy_process_group()
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)

    # 14b: four ranks on the card over gloo
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    reads_fq = os.path.join(mdir, "reads_mesh.fq")
    write_fastq(reads_fq, w["codes"][:N_MESH])
    save_prepared_arrays(w["prepared128"], os.path.join(mdir, "prep128"))
    cases = [[f"{r}_{d}x{i}", d, i, r, None] for d, i in MESH4
             for r in ("a2a", "psum")] + [["a2a_1x4_slack0.3", 1, 4, "a2a",
                                          0.3]]
    spec = {"ufi": os.path.join(work, "cli.ufi"), "reads": reads_fq,
            "r1": w["r1_cpu"], "r2": w["r2_cpu"],
            "prepared128": os.path.join(mdir, "prep128"), "cases": cases}
    with open(os.path.join(mdir, "spec.json"), "w") as f:
        json.dump(spec, f)
    for r in range(4):
        for f in (f"rank{r}.json",):
            if os.path.exists(os.path.join(mdir, f)):
                os.remove(os.path.join(mdir, f))
    wall = launch_ranks(4, [sys.executable, os.path.abspath(__file__),
                            "--mesh-rank", mdir], mdir)
    ranks = []
    for r in range(4):
        with open(os.path.join(mdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    with open(os.path.join(mdir, "results.pkl"), "rb") as f:
        results = pickle.load(f)
    head_se = aligned["results"][0]
    n_se = N_MESH
    head_sam = b"".join(aligned["sam"].splitlines(keepends=True)[:n_se])
    pe_ref = w["paired_head"]
    for name, *_ in cases:
        got = results[name]
        same_results(got["se"], [head_se], f"14b {name} single-end")
        check(got["se_sam"] == head_sam, f"14b {name}: SAM bytes differ")
        if "pe" in got:
            check(len(got["pe"]) == len(pe_ref["results"]),
                  f"14b {name}: pair batches")
            for x, y in zip(got["pe"], pe_ref["results"]):
                same_results([x.m1, x.m2], [y.m1, y.m2], f"14b {name} pairs")
                check(np.array_equal(x.proper, y.proper),
                      f"14b {name}: proper flags differ")
            check(got["pe_sam"] == pe_ref["sam"],
                  f"14b {name}: paired SAM bytes differ")
    for rk in ranks:
        check(rk["backend"] == "gloo", f"14b rank {rk['rank']}: backend "
              f"{rk['backend']}")
        for name, c in rk["cases"].items():
            for key in ("se_counters", "pe_counters"):
                if key in c:
                    check_mesh_counters(c[key], f"14b rank {rk['rank']} "
                                        f"{name} {key[:2]}")
                    add_counts(total, c[key])
            for key in ("se_per_batch", "pe_per_batch"):
                if key in c:
                    rounds["a2a_loops"] += c[key]["a2a_loops"]
                    rounds["a2a_rounds"] += c[key]["a2a_rounds"]
        emit({"phase": "mesh4_rank", "gpu": smi, **{
            k: rk[k] for k in ("rank", "backend", "device",
                               "staged_by_port")},
            "gloo_note": "gloo copies CUDA tensors through host memory "
                         "inside its own collectives",
            "cases": {n: {k: v for k, v in c.items()
                          if not k.endswith("_counters")}
                      for n, c in rk["cases"].items()},
            "counters_1x4_a2a_se": {
                k: v["launches"]
                for k, v in rk["cases"]["a2a_1x4"]["se_counters"].items()
                if v["launches"]}})
    over = ranks[0]["cases"]["a2a_1x4_slack0.3"]["se_per_batch"]
    check(over["a2a_rounds"] > over["a2a_loops"],
          f"14b: slack 0.3 took no overflow round ({over})")
    emit({"phase": "mesh4", "gpu": smi, "ranks": 4, "cases": len(cases),
          "reads": n_se, "pairs": N_MESH_PAIRS, "wall_s": wall,
          "equal_to_single_card": True,
          "seconds": time.perf_counter() - t0})

    # 14c: the command line as several processes
    t0 = time.perf_counter()
    ufi = os.path.join(work, "cli.ufi")
    runs = {}

    def cli_procs(n, name, args):
        out = os.path.join(mdir, f"{name}.sam")
        d = os.path.join(mdir, name)
        os.makedirs(d, exist_ok=True)
        wall = launch_ranks(n, [sys.executable, "-m", "urmap_tpu_torch",
                                "-map", *args, "-ufi", ufi, "-samout", out,
                                "-batch", str(B), "-quiet"], d)
        return out, wall

    out, wall = cli_procs(2, "dp2", [w["reads_half"]])
    body = sam_records(out)
    check(b"".join(body) == aligned["sam"],
          "14c: the data-parallel SAM body differs from phase 10's")
    runs["dp2"] = {"procs": 2, "reads": w["n_half"], "wall_s": wall,
                   "reads_per_wall_s": w["n_half"] / wall}
    out, wall = cli_procs(4, "mesh22", [reads_fq, "-mesh", "2x2", "-route",
                                        "a2a"])
    body = sam_records(out)
    check(sorted(body) == sorted(head_sam.splitlines(keepends=True)),
          "14c: -mesh 2x2 single-end records differ from the single run's")
    runs["mesh22_se"] = {"procs": 4, "reads": n_se, "wall_s": wall,
                         "reads_per_wall_s": n_se / wall,
                         "body_in_input_order": b"".join(body) == head_sam}
    pe_one = os.path.join(mdir, "pe_one.sam")
    one = cli_map(dev, ["-map", w["r1_cpu"], "-reverse", w["r2_cpu"], "-ufi",
                        ufi, "-samout", pe_one, "-batch", str(B), "-quiet"])
    out, wall = cli_procs(4, "mesh22_pe", [w["r1_cpu"], "-reverse",
                                           w["r2_cpu"], "-mesh", "2x2",
                                           "-route", "a2a"])
    check(sorted(sam_records(out)) == sorted(sam_records(pe_one)),
          "14c: -mesh 2x2 -reverse records differ from the single run's")
    runs["mesh22_pe"] = {"procs": 4, "reads": 2 * N_MESH_PAIRS,
                         "wall_s": wall,
                         "reads_per_wall_s": 2 * N_MESH_PAIRS / wall,
                         "single_process_wall_s": one["wall_s"]}
    emit({"phase": "cli_mp", "gpu": smi, "runs": runs,
          "seconds": time.perf_counter() - t0})
    return {"counts": total, **rounds}


# ---- phase 15: the device index build ------------------------------------

# (d)'s chunk: SPILL_SMALL_CHUNK words from here, numbered as if they lay
# past 2^31 (GRCh38's chunk starts run to ~3.1e9)
DEVICE_BUILD_BASE = 3_000_000_000


def chunk_stage_ms(dev, codes, k: int, slot_bits: int, table_path: str):
    """One _chunk_sorted_slots call on ``codes`` (already on the card)
    under torch.profiler: device ms by stage, told apart by kernel name
    and order. The sort's kernels are cub's radix sort ("sort" or
    "radix" in the name); extract_hash is every kernel before the first
    of them (extract_words, the hash, the sentinel, the sort's index
    fill and key copy); trim_narrow every kernel after the last (the valid count, the
    narrowing to 32 bits); copy the device → host copies.

    The profiler's schedule runs one call as warm-up before the call it
    records (its CUDA activity buffers are set up by then), and a trace
    counts only when it holds at least as many device kernels as the
    host made kernel launches in it: a trace that dropped device records
    (seen in a process that had profiled before) is taken again, up to
    three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from urmap_tpu_torch.index import build as bmod

    def launches_on_host(evs) -> int:
        return sum(e.device_type == DeviceType.CPU and e.name.startswith(
            ("cudaLaunchKernel", "cuLaunchKernel")) for e in evs)

    def on_device(e) -> bool:    # kernels and copies, not the step's span
        return e.device_type == DeviceType.CUDA \
            and not e.name.startswith("ProfilerStep")

    def is_kernel(e) -> bool:
        return on_device(e) and not e.name.startswith(("Memcpy", "Memset"))

    bmod._chunk_sorted_slots(codes, 0, k, slot_bits)        # warm
    tries = []
    for _ in range(3):
        got = {}

        def ready(p):
            got["events"] = list(p.events())
            got["table"] = p.key_averages().table(
                sort_by="self_device_time_total", row_limit=40)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=ready) as prof:
            for _step in range(2):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                bmod._chunk_sorted_slots(codes, 0, k, slot_bits)
                torch.cuda.synchronize(dev)
                wall_ms = (time.perf_counter() - t0) * 1e3
                prof.step()
        evs = got.get("events", [])
        host_n = launches_on_host(evs)
        dev_n = sum(is_kernel(e) for e in evs)
        tries.append([host_n, dev_n])
        if host_n and dev_n >= host_n:
            break
    check(host_n and dev_n >= host_n,
          f"phase 15: no complete trace (host launches, device kernels) "
          f"in 3 tries: {tries}")
    with open(table_path, "w") as f:
        f.write(got["table"])
    evs = sorted(filter(on_device, evs), key=lambda e: e.time_range.start)

    def is_sort(e) -> bool:
        return "sort" in e.name.lower() or "radix" in e.name.lower()

    first = next((i for i, e in enumerate(evs) if is_sort(e)), None)
    last = max((i for i, e in enumerate(evs) if is_sort(e)), default=None)
    check(first is not None, "phase 15: no sort kernel in the profile: "
          f"{sorted({e.name[:50] for e in evs})}")
    stages = {s: [0.0, 0] for s in ("extract_hash", "sort", "trim_narrow",
                                    "copy_to_host")}
    for i, e in enumerate(evs):
        if "Memcpy DtoH" in e.name:
            st = "copy_to_host"
        elif i < first:
            st = "extract_hash"
        elif i <= last:
            st = "sort"
        else:
            st = "trim_narrow"
        stages[st][0] += e.time_range.elapsed_us() / 1e3
        stages[st][1] += 1
    busy = sum(v[0] for v in stages.values())
    return {"words": int(codes.shape[0]) - k + 1, "wall_ms": wall_ms,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
            "launches": len(evs), "kernel_launches": dev_n,
            "profile_tries": len(tries), "stages_ms_launches": stages}


def phase_device_build(dev, w: dict, smi: str, work: str) -> dict:
    """Phase 15: phase 4's index built on the card (build_index's
    backend="device"): (a) in one chunk in RAM, timed in turns with the
    host build of the same genome (host, card, card, host); (b) in chunks
    of SPILL_SMALL_CHUNK words in RAM (the sorted runs merged on the
    host); (c) through the disk radix spill (spill_threshold 2^20
    words) in chunks of SPILL_SMALL_CHUNK words, each handed to the
    spill slot-sorted. Each must equal phase 4's host build, and the
    spill leave nothing. (d) _chunk_sorted_slots on the card equals the
    same function on CPU tensors, for a chunk numbered past 2^31, at
    slot_bits 30 and 31. (e) -make_ufi -device_build writes phase 10's
    -make_ufi directory byte for byte. One chunk of each size is
    profiled by stage."""
    import contextlib
    import filecmp
    import io
    import shutil

    import torch

    from urmap_tpu_torch import cli
    from urmap_tpu_torch.index import build as bmod

    t_phase = time.perf_counter()
    db, want, cfg = w["db"], w["index"], w["index"].config
    n_words = len(db.codes) - cfg.k + 1

    def same(idx) -> bool:
        return (np.array_equal(idx.offsets, want.offsets)
                and np.array_equal(idx.positions, want.positions))

    def timed(**kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        idx = bmod.build_index(db, cfg, **kw)
        return idx, time.perf_counter() - t0

    # (a) one chunk (DEFAULT_CHUNK > the genome's words), host and card
    # in turns
    check(n_words <= bmod.DEFAULT_CHUNK, "phase 15: (a) is not one chunk")
    walls = {"host": [], "device": []}
    equal = {}
    for name in ("host", "device", "device", "host"):
        kw = ({"backend": "device", "device": dev} if name == "device"
              else {"backend": "host"})
        idx, sec = timed(**kw)
        walls[name].append(sec)
        equal.setdefault(f"one_chunk_{name}", True)
        equal[f"one_chunk_{name}"] &= same(idx)
        del idx
    # (b) SPILL_SMALL_CHUNK words a chunk, in RAM
    runs = []
    real_merge = bmod._merge_sorted_runs

    def merge(r):
        runs.append(len(r))
        return real_merge(r)

    bmod._merge_sorted_runs = merge
    try:
        idx, walls["device_chunked"] = timed(
            backend="device", device=dev, chunk=SPILL_SMALL_CHUNK)
    finally:
        bmod._merge_sorted_runs = real_merge
    equal["chunked"] = same(idx)
    del idx
    # (c) through the spill, slot-sorted chunks
    spill_dir = os.path.join(work, "device_spill")
    shutil.rmtree(spill_dir, ignore_errors=True)
    os.makedirs(spill_dir)
    adds, on_disk = [], []
    real_add, real_fin = bmod._RadixSpill.add, bmod._RadixSpill.finalize

    def add(self, sl, po, sorted_by_slot=False):
        adds.append(sorted_by_slot)
        return real_add(self, sl, po, sorted_by_slot)

    def finalize(self, *a):
        for f in self.files:
            f.flush()
        on_disk.append(sum(os.path.getsize(p) for p in self.paths))
        return real_fin(self, *a)

    bmod._RadixSpill.add, bmod._RadixSpill.finalize = add, finalize
    try:
        idx, walls["device_spill"] = timed(
            backend="device", device=dev, chunk=SPILL_SMALL_CHUNK,
            spill_threshold=1 << 20, spill_dir=spill_dir)
    finally:
        bmod._RadixSpill.add, bmod._RadixSpill.finalize = real_add, real_fin
    equal["spill"] = same(idx)
    del idx
    left = os.listdir(spill_dir)
    # (d) card = CPU tensors, a chunk numbered past 2^31
    mid = len(db.codes) // 2
    sub = np.ascontiguousarray(
        db.codes[mid : mid + SPILL_SMALL_CHUNK + cfg.k - 1])
    d_equal = {}
    for bits in (30, 31):
        got = bmod._chunk_sorted_slots(torch.from_numpy(sub).to(dev),
                                       DEVICE_BUILD_BASE, cfg.k, bits)
        ref = bmod._chunk_sorted_slots(torch.from_numpy(sub),
                                       DEVICE_BUILD_BASE, cfg.k, bits)
        d_equal[bits] = (all(np.array_equal(a, b) for a, b in zip(got, ref))
                         and got[0].dtype == got[1].dtype == np.uint32
                         and int(got[1].min()) >= DEVICE_BUILD_BASE
                         and len(got[0]) > 0)
    # (e) the command line, against phase 10's directory
    ufi = os.path.join(work, "cli_device.ufi")
    shutil.rmtree(ufi, ignore_errors=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        check(cli.main(["-make_ufi", w["fasta"], "-output", ufi,
                        "-device_build"]) == 0, "-make_ufi -device_build")
    cli_s = time.perf_counter() - t0
    host_ufi = os.path.join(work, "cli.ufi")
    files = sorted(os.path.relpath(os.path.join(d, n), ufi)
                   for d, _, names in os.walk(ufi) for n in names)
    theirs = sorted(os.path.relpath(os.path.join(d, n), host_ufi)
                    for d, _, names in os.walk(host_ufi) for n in names)
    _m, mismatch, errors = filecmp.cmpfiles(host_ufi, ufi, files,
                                            shallow=False)
    # one chunk of each size, profiled by stage
    whole = torch.from_numpy(np.ascontiguousarray(db.codes)).to(dev)
    stage = {
        "one_chunk": chunk_stage_ms(dev, whole, cfg.k, cfg.slot_bits,
                                    os.path.join(work, "profile_build.txt")),
        "chunk_2^23": chunk_stage_ms(
            dev, whole[: SPILL_SMALL_CHUNK + cfg.k - 1], cfg.k,
            cfg.slot_bits, os.path.join(work, "profile_build_2^23.txt"))}
    del whole
    torch.cuda.empty_cache()
    emit({"phase": "device_build", "gpu": smi, "host_cpu": cpu_model(),
          "genome_bases": int(db.total_len), "words": n_words,
          "slot_bits": cfg.slot_bits, "positions": int(want.num_positions),
          "build_s": walls, "equal_to_host_build": equal,
          "merged_runs": runs, "spill_adds_sorted_by_slot": adds,
          "spill_bytes": on_disk, "spill_dir_left": left,
          "card_equal_cpu_past_2^31": d_equal,
          "cli_make_ufi_device_s": cli_s, "cli_files": len(files),
          "cli_mismatch": mismatch + errors, "chunk_stages": stage,
          "seconds": time.perf_counter() - t_phase})
    n_chunks = -(-n_words // SPILL_SMALL_CHUNK)
    check(all(equal.values()), f"phase 15: a build differs: {equal}")
    check(runs == [n_chunks] and n_chunks > 4,
          f"phase 15: (b) merged {runs} runs, not {n_chunks}")
    check(adds == [True] * n_chunks and n_chunks >= 4 and len(on_disk) == 1
          and on_disk[0] > 0, f"phase 15: (c) spill adds {adds}")
    check(not left, f"phase 15: the spill left {left}")
    check(all(d_equal.values()), f"phase 15: (d) card != CPU: {d_equal}")
    check(files == theirs and len(files) > 3 and not mismatch
          and not errors,
          f"phase 15: (e) -device_build's directory differs: "
          f"{mismatch + errors}, {len(files)} vs {len(theirs)} files")
    return stage


# ---- phase 16: repeat-laden genomes --------------------------------------

N_REP, N_REP_CPU = 65_536, 2048          # single-end reads; on the CPU too
N_REP_PAIRS, N_REP_CPU_PAIRS = 4096, 512
REP_FRAC = 0.25                           # of the genome in repeat families
ROC_MAPQ = (0, 1, 10, 20, 30, 40, 42)     # tools/accuracy.py's thresholds
ROC_SLOP = 5                              # tools/accuracy.py's --slop


def roc_of(mapped, mapq, correct, n: int) -> list:
    """Precision and recall by MAPQ threshold as tools/accuracy.py
    counts them, unrounded: a call at threshold q is a mapped read with
    MAPQ >= q; precision is the correct share of the calls, recall the
    correct calls over ``n`` reads."""
    out = []
    for q in ROC_MAPQ:
        called = mapped & (mapq >= q)
        nc, ok = int(called.sum()), int((called & correct).sum())
        out.append({"mapq": q, "called": nc, "correct": ok,
                    "precision": ok / max(nc, 1), "recall": ok / n})
    return out


class GateSpy:
    """``with GateSpy() as spy:`` keeps each batch's weak flags and
    saturated-seed counts from map.pipeline.candidates_batch_device, the
    inputs of the weak and suspect MAPQ gates, which a MapResult does
    not carry (single-end batches through map_batch_device, pair batches
    through map.pair.map_pairs_device: rows [0, P) mate 1, [P, 2P) mate
    2). It copies two small tensors a batch and launches no kernel."""

    def __init__(self):
        self.batches = []

    def __enter__(self):
        from urmap_tpu_torch.map import pair, pipeline

        real = pipeline.candidates_batch_device

        def spy(*a, **kw):
            c = real(*a, **kw)
            self.batches.append((c["weak"].clone(), c["nsat"].clone()))
            return c

        self._undo = [(m, real) for m in (pipeline, pair)]
        for m, _ in self._undo:
            m.candidates_batch_device = spy
        return self

    def __exit__(self, *exc):
        for m, real in self._undo:
            m.candidates_batch_device = real

    def reads(self, sizes) -> tuple:
        """(weak, nsat) per read of single-end batches of ``sizes``
        reads."""
        check(len(self.batches) == len(sizes), "a batch went unseen")
        weak = [w.cpu().numpy()[:k] for (w, _), k in zip(self.batches, sizes)]
        nsat = [n.cpu().numpy()[:k] for (_, n), k in zip(self.batches, sizes)]
        return np.concatenate(weak), np.concatenate(nsat)

    def mates(self, sizes, rows: int) -> tuple:
        """The weak flags of mate 1 and of mate 2 of pair batches of
        ``sizes`` pairs, ``rows`` rows a mate."""
        check(len(self.batches) == len(sizes), "a batch went unseen")
        w = [bt[0].cpu().numpy() for bt in self.batches]
        return (np.concatenate([x[:k] for x, k in zip(w, sizes)]),
                np.concatenate([x[rows : rows + k] for x, k in zip(w, sizes)]))


def gate_counts(res, weak, nsat, mcfg, sc) -> dict:
    """The repeat machinery's counts over one run's calls: weak-fallback
    winners, winners on saturated evidence, those the suspect gate
    capped, the suspects (exported to the second pass) and the
    clip-rescued; each gate's cap is checked on its rows."""
    from urmap_tpu_torch.config import resolve_suspect_deficits

    gate, _remap = resolve_suspect_deficits(mcfg, sc)
    weak = weak & res.mapped
    sat = res.mapped & (nsat > 0) & ~res.clipped
    capped = sat & (res.lengths * sc.match - res.score > gate)
    check(bool((res.mapq[weak] <= mcfg.weak_mapq_cap).all()),
          "a weak-fallback winner above weak_mapq_cap")
    check(bool((res.mapq[capped] <= mcfg.suspect_mapq_cap).all()),
          "a gated winner above suspect_mapq_cap")
    return {"weak": int(weak.sum()), "saturated": int(sat.sum()),
            "suspect_capped": int(capped.sum()),
            "suspect": int(res.suspect.sum()),
            "clip_rescued": int((res.clipped & res.mapped).sum()),
            "mapq0": int((res.mapped & (res.mapq == 0)).sum())}


def card_equals_cpu(card, cpu, db, fq: str, what: str) -> dict:
    """The reads of ``fq`` through a card and a CPU Mapper: differing
    MapResult fields and traceback keys, whether the c3_prone rows and
    the SAM bytes (those rows written unmapped) are equal; each must
    be."""
    t0 = time.perf_counter()
    c3a, c3b = [], []
    a, sam_a = map_fastq(card, db, fq, card.mcfg.batch_size, None, c3a)
    b, sam_b = map_fastq(cpu, db, fq, cpu.mcfg.batch_size, None, c3b)
    diff = differing(concat_results(a), concat_results(b))
    tb_diff = sorted({k for x, y in zip(a, b) for k in tb_differing(x.tb,
                                                                    y.tb)})
    same_c3 = np.array_equal(np.concatenate(c3a), np.concatenate(c3b))
    out = {"reads": int(sum(len(r.mapped) for r in a)),
           "fields_differing": diff, "tb_keys_differing": tb_diff,
           "c3_prone": int(np.concatenate(c3a).sum()),
           "c3_identical": same_c3, "sam_identical": sam_a == sam_b,
           "seconds": time.perf_counter() - t0, "sam": sam_a}
    check(not diff, f"16 {what}: card and CPU differ in {diff}")
    check(not tb_diff, f"16 {what}: card and CPU tb records differ in "
          f"{tb_diff}")
    check(same_c3, f"16 {what}: card and CPU c3_prone rows differ")
    check(sam_a == sam_b, f"16 {what}: card and CPU SAM bytes differ")
    return out


def head_lines(sam: bytes, n: int) -> bytes:
    return b"\n".join(sam.split(b"\n")[:n]) + b"\n"


def phase_repeats(dev, smi: str, work: str, seed: int) -> dict:
    """Phase 16: a repeat-laden genome of chr21's length (its own stream,
    tools/accuracy.py's plant_repeat_families at REP_FRAC: SINE- and
    LINE-like families, exact segmental duplications, tandem runs), where
    the weak and suspect MAPQ gates decide calls. -make_ufi (auto
    slot_bits) through cli.main; N_REP simulate() reads (tools/
    accuracy.py's: 150 bp, 1% SNPs, 10% with an indel) through the
    default Mapper: the ROC by MAPQ, the gate counts, card = CPU on the
    first N_REP_CPU reads, one batch profiled; N_REP_PAIRS FR pairs
    through PairedMapper (card = CPU on N_REP_CPU_PAIRS); on the
    genome's first quarter, -make_ufi and -make_ufi -veryfast (auto + 2
    slot_bits), a Mapper with VERYFAST_MAP_OVERRIDES over N_REP reads of
    it beside the default's (card = CPU on N_REP_CPU reads), and -map on
    the -veryfast index, whose SAM equals the Mapper's; second_pass_p 32 (what
    -secondpass 32 sets) over the reads, with the suspects it recovers.
    The SAM writer raises on c3_prone rows, in urmap_tpu as here
    (ROADMAP C.3): they are counted, must be the same rows on the card
    and the CPU, and are written unmapped wherever SAM bytes are
    compared; -map runs on the reads without them. Returns the counts of
    the paths repeats, repeats_paired and veryfast."""
    import contextlib
    import io
    import shutil

    import torch

    from urmap_tpu_torch import cli
    from urmap_tpu_torch.config import (VERYFAST_MAP_OVERRIDES, IndexConfig,
                                        MapConfig)
    from urmap_tpu_torch.index import UfiIndex
    from urmap_tpu_torch.io.fastq import FastqReader
    from urmap_tpu_torch.map import Mapper
    from urmap_tpu_torch.map.pair import PairedMapper
    from urmap_tpu_torch.tools.accuracy import (plant_repeat_families,
                                                simulate)

    check(VERYFAST_MAP_OVERRIDES["positions_per_seed"] == VERYFAST_P,
          "VERYFAST_P is not VERYFAST_MAP_OVERRIDES' positions_per_seed")
    t_phase = time.perf_counter()
    rdir = os.path.join(work, "repeats")
    shutil.rmtree(rdir, ignore_errors=True)
    os.makedirs(rdir)
    setup = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 16])
    seq = rng.integers(0, 4, size=CHR21_LEN, dtype=np.uint8)
    plant_repeat_families(rng, seq, REP_FRAC)
    fa = os.path.join(rdir, "genome.fa")
    qfa = os.path.join(rdir, "quarter.fa")
    write_fasta(fa, seq)
    write_fasta(qfa, seq[: CHR21_LEN // 4])
    del seq
    setup["genome_s"] = time.perf_counter() - t0

    def make_ufi(src: str, out: str, *extra) -> float:
        t = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            check(cli.main(["-make_ufi", src, "-output", out, *extra]) == 0,
                  f"16: -make_ufi {extra}")
        return time.perf_counter() - t

    ufi = os.path.join(rdir, "g.ufi")
    setup["make_ufi_s"] = make_ufi(fa, ufi)
    index = UfiIndex.load(ufi)
    db = index.seqdb
    t0 = time.perf_counter()
    codes, tpos, tstrand = simulate(np.random.default_rng([seed, 16, 1]), db,
                                    N_REP, READ_LEN, 0.01, 0.10)
    fq = os.path.join(rdir, "reads.fq")
    fq_cpu = os.path.join(rdir, "reads_cpu.fq")
    write_fastq(fq, codes)
    write_fastq(fq_cpu, codes[:N_REP_CPU])
    setup["reads_s"] = time.perf_counter() - t0
    lens = np.full(B, READ_LEN, np.int32)
    paths = {}

    def correct_of(res, tp=tpos, ts=tstrand):
        return res.mapped & (np.abs(res.pos - tp) <= ROC_SLOP) \
            & (res.strand == ts)

    def layout_of(m):
        return ("row128" if m.row128 else
                "aligned" if m.csr_aligned else "classic")

    # 1. single-end through the default Mapper
    mcfg = MapConfig(batch_size=B)
    mapper = Mapper(index, mcfg, device=dev)
    mapper.map_codes(codes[:B], lens)                     # warm
    c3 = []
    reset_counters()
    t0 = time.perf_counter()
    with GateSpy() as spy:
        results, sam = map_fastq(mapper, db, fq, B, None, c3)
    torch.cuda.synchronize(dev)
    map_s = time.perf_counter() - t0
    paths["repeats"] = counts = read_counters()
    res = concat_results(results)
    check(len(res.mapped) == N_REP, "16: result count")
    weak, nsat = spy.reads([len(r.mapped) for r in results])
    gates = gate_counts(res, weak, nsat, mcfg, mapper.sc)
    c3 = np.concatenate(c3)
    correct = correct_of(res)
    roc = roc_of(res.mapped, res.mapq, correct, N_REP)
    nb = len(results)
    emit({"phase": "repeats", "gpu": smi, "genome_bases": int(db.total_len),
          "repeat_frac": REP_FRAC, "slot_bits": index.config.slot_bits,
          "positions": index.num_positions, "layout": layout_of(mapper),
          "setup_s": setup, "reads": N_REP, "batch": B, "batches": nb,
          "map_s": map_s, "reads_per_s": N_REP / map_s,
          "mapped_frac": float(res.mapped.mean()),
          "correct_frac": float(correct.mean()),
          "correct_rule": f"mapped, |POS - planted| <= {ROC_SLOP}, strand "
                          "as planted (tools/accuracy.py)",
          "roc": roc, "gates": gates, "c3_prone": int(c3.sum()),
          "c3_prone_correct": int((c3 & correct).sum()),
          "traceback": tb_coverage(results), "counters": counts})
    check_counters(counts, "16 repeats")
    check(counts["tb_dops"]["launches"] == nb,
          f"16: tb_dops launches {counts['tb_dops']['launches']} != {nb}")
    check(counts["vote"].get("widths") == {Q * P: nb},
          f"16: vote widths {counts['vote'].get('widths')}")
    check(gates["weak"] > 0 and gates["suspect"] > 0,
          f"16: the gates never fired: {gates}")

    # the first reads alone, on the card and on a CPU Mapper
    cpu_mapper = Mapper(index, mcfg, device="cpu")
    head = card_equals_cpu(mapper, cpu_mapper, db, fq_cpu, "single-end")
    same_head = head.pop("sam") == head_lines(sam, N_REP_CPU)
    emit({"phase": "repeats_cpu", **head, "equals_full_run": same_head})
    check(same_head, "16: the first reads map differently alone")

    # one batch under torch.profiler: launches and device busy time
    b = next(iter(FastqReader(fq, batch_size=B)))
    pk = mapper.prepack(b.codes, b.lengths)
    prof = profile_call(lambda: mapper.finish_batch(
        mapper.start_batch(b.codes, b.lengths, prepacked=pk), b.lengths),
        os.path.join(work, "profile_repeats.txt"))
    emit({"phase": "repeats_profile", "gpu": smi, "reads": len(b),
          **{k: prof[k] for k in ("complete", "host_launches",
                                  "profiled_wall_ms", "device_busy_ms",
                                  "device_idle_share", "device_launches",
                                  "port_kernels_device_ms")}})

    # 2. FR pairs through PairedMapper
    c1, c2, pt = plant_pairs(np.random.default_rng([seed, 16, 2]), db,
                             N_REP_PAIRS)
    f1, f2 = os.path.join(rdir, "r1.fq"), os.path.join(rdir, "r2.fq")
    f1c, f2c = os.path.join(rdir, "r1_cpu.fq"), os.path.join(rdir, "r2_cpu.fq")
    for path, sub in ((f1, c1), (f2, c2), (f1c, c1[:N_REP_CPU_PAIRS]),
                      (f2c, c2[:N_REP_CPU_PAIRS])):
        write_fastq(path, sub)
    pm = PairedMapper(mapper)
    pl = np.full(N_REP_CPU_PAIRS, READ_LEN, np.int32)
    pm.map_pair_codes(c1[: len(pl)], pl, c2[: len(pl)], pl)   # warm
    pc3 = []
    reset_counters()
    t0 = time.perf_counter()
    with GateSpy() as spy:
        presults, _psam = map_pairs_fastq(pm, db, f1, f2, pc3)
    torch.cuda.synchronize(dev)
    pmap_s = time.perf_counter() - t0
    paths["repeats_paired"] = pcounts = read_counters()
    m1, m2, proper = concat_pairs(presults)
    w1, w2 = spy.mates([len(r.proper) for r in presults], pm.pair_batch)
    planted = pt["kind"] != 3
    ok1 = m1.mapped & (m1.pos == pt["pos1"]) & (m1.strand == pt["strand1"])
    ok2 = m2.mapped & (m2.pos == pt["pos2"]) & (m2.strand == pt["strand2"])
    weak_mates = (w1 & m1.mapped, w2 & m2.mapped)
    # a weak mate of a proper pair whose other mate is not weak keeps
    # rescue-grade confidence (map.pair's RESCUE_MAPQ_CAP); the others
    # take weak_mapq_cap
    anchored = (weak_mates[0] & proper & ~w2, weak_mates[1] & proper & ~w1)
    nbp = len(presults)
    emit({"phase": "repeats_paired", "gpu": smi, "pairs": N_REP_PAIRS,
          "pair_batch": pm.pair_batch, "batches": nbp, "map_s": pmap_s,
          "pairs_per_s": N_REP_PAIRS / pmap_s,
          "correct_mate_frac": float(np.concatenate(
              [ok1[planted], ok2[planted]]).mean()),
          "proper_frac": float(proper[planted].mean()),
          "weak_capped_mates": int(sum(x.sum() for x in weak_mates)),
          "weak_mates_in_anchored_pairs": int(sum(x.sum()
                                                  for x in anchored)),
          "suspect_mates": int(m1.suspect.sum() + m2.suspect.sum()),
          "c3_prone_mates": int(sum(x[0].sum() + x[1].sum() for x in pc3)),
          "roc_mates": roc_of(np.concatenate([m1.mapped, m2.mapped]),
                              np.concatenate([m1.mapq, m2.mapq]),
                              np.concatenate([ok1, ok2]),
                              2 * int(planted.sum())),
          "counters": pcounts})
    check_counters(pcounts, "16 repeats_paired")
    check(pcounts["tb_dops"]["launches"] == nbp,
          f"16: paired tb_dops launches {pcounts['tb_dops']['launches']}")
    t0 = time.perf_counter()
    on_c3, cpu_c3 = [], []
    on_p, on_psam = map_pairs_fastq(pm, db, f1c, f2c, on_c3)
    cpu_p, cpu_psam = map_pairs_fastq(PairedMapper(cpu_mapper), db, f1c,
                                      f2c, cpu_c3)
    a1, a2, ap = concat_pairs(on_p)
    b1_, b2_, bp = concat_pairs(cpu_p)
    pdiff = [f"m1.{f}" for f in differing(a1, b1_)] \
        + [f"m2.{f}" for f in differing(a2, b2_)] \
        + ([] if np.array_equal(ap, bp) else ["proper"])
    ptb = sorted({f"{m}.{k}" for x, y in zip(on_p, cpu_p)
                  for m in ("m1", "m2")
                  for k in tb_differing(getattr(x, m).tb, getattr(y, m).tb)})
    same_pc3 = all(np.array_equal(x[j], y[j])
                   for x, y in zip(on_c3, cpu_c3) for j in (0, 1))
    emit({"phase": "repeats_paired_cpu", "pairs": N_REP_CPU_PAIRS,
          "fields_differing": pdiff, "tb_keys_differing": ptb,
          "c3_identical": same_pc3, "sam_identical": on_psam == cpu_psam,
          "seconds": time.perf_counter() - t0})
    check(not pdiff, f"16 paired: card and CPU differ in {pdiff}")
    check(not ptb, f"16 paired: card and CPU tb records differ in {ptb}")
    check(same_pc3, "16 paired: card and CPU c3_prone rows differ")
    check(on_psam == cpu_psam, "16 paired: card and CPU SAM bytes differ")

    # 3. -veryfast on the genome's first quarter (auto 25 + 2 = 27
    # slot_bits: the whole genome's 29-bit build took 85-104 s on the
    # host of an NVIDIA H100 80GB HBM3 with 8 CPUs, which took the smoke
    # past half its time limit), beside that quarter's
    # default index: N_REP reads of the quarter through a Mapper with
    # VERYFAST_MAP_OVERRIDES (card = CPU on N_REP_CPU) and through the
    # default Mapper, and -map (which reads the index's flag) over the
    # reads that are not c3_prone there
    qufi = os.path.join(rdir, "quarter.ufi")
    vufi = os.path.join(rdir, "quarter_vf.ufi")
    qbuild_s = make_ufi(qfa, qufi)
    vbuild_s = make_ufi(qfa, vufi, "-veryfast")
    qidx, vidx = UfiIndex.load(qufi), UfiIndex.load(vufi)
    qdb = qidx.seqdb
    auto = IndexConfig.auto_slot_bits(qdb.total_len)
    check(not qidx.config.veryfast and qidx.config.slot_bits == auto
          and vidx.config.veryfast
          and vidx.config.slot_bits == min(auto + 2, 30),
          f"16: the quarter's index configs {qidx.config} {vidx.config}")
    qcodes, qtpos, qtstrand = simulate(np.random.default_rng(
        [seed, 16, 3]), qdb, N_REP, READ_LEN, 0.01, 0.10)
    fq_q = os.path.join(rdir, "quarter.fq")
    fq_q_cpu = os.path.join(rdir, "quarter_cpu.fq")
    write_fastq(fq_q, qcodes)
    write_fastq(fq_q_cpu, qcodes[:N_REP_CPU])
    qres = Mapper(qidx, mcfg, device=dev).map_codes(
        qcodes, np.full(N_REP, READ_LEN, np.int32))
    qcorrect = correct_of(qres, qtpos, qtstrand)
    del qidx
    vmcfg = MapConfig(batch_size=B, **VERYFAST_MAP_OVERRIDES)
    vm = Mapper(vidx, vmcfg, device=dev)
    vc3 = []
    vresults, _vsam = map_fastq(vm, qdb, fq_q, B, None, vc3)
    vres = concat_results(vresults)
    vc3 = np.concatenate(vc3)
    vcorrect = correct_of(vres, qtpos, qtstrand)
    vhead = card_equals_cpu(vm, Mapper(vidx, vmcfg, device="cpu"), qdb,
                            fq_q_cpu, "veryfast")
    vhead.pop("sam")
    keep = np.nonzero(~vc3)[0]
    fq_vf = os.path.join(rdir, "quarter_vf.fq")
    write_fastq(fq_vf, qcodes[keep])
    _kres, vlib_sam = map_fastq(vm, qdb, fq_vf, B, None)
    vsam = os.path.join(rdir, "quarter_vf.sam")
    reset_counters()
    vrun = cli_map(dev, ["-map", fq_vf, "-ufi", vufi, "-samout", vsam,
                         "-batch", str(B), "-quiet"])
    paths["veryfast"] = vcounts = read_counters()
    vbody = b"".join(sam_records(vsam))
    nbv = -(-len(keep) // B)
    emit({"phase": "repeats_veryfast", "gpu": smi,
          "cut": f"the genome's first quarter ({int(qdb.total_len):,} "
                 f"bases; the segmental duplications' copies lie in the "
                 f"second half): slot_bits {vidx.config.slot_bits}, not "
                 f"the whole genome's "
                 f"{IndexConfig.auto_slot_bits(db.total_len) + 2}",
          "slot_bits": vidx.config.slot_bits, "slot_bits_default": auto,
          "positions": vidx.num_positions,
          "make_ufi_s": {"default": qbuild_s, "veryfast": vbuild_s},
          "layout": layout_of(vm), "c3_prone": int(vc3.sum()),
          "cli_reads": len(keep), **vrun,
          "sam_equals_library": vlib_sam == vbody,
          "correct_frac": float(vcorrect.mean()),
          "correct_frac_default": float(qcorrect.mean()),
          "roc": roc_of(vres.mapped, vres.mapq, vcorrect, N_REP),
          "roc_default": roc_of(qres.mapped, qres.mapq, qcorrect, N_REP),
          "suspect": int(vres.suspect.sum()),
          "suspect_default": int(qres.suspect.sum()),
          "clip_rescued": int((vres.clipped & vres.mapped).sum()),
          "cpu": vhead, "counters": vcounts})
    check_counters(vcounts, "16 veryfast")
    check(vlib_sam == vbody, "16: -veryfast -map's SAM differs from the "
          "Mapper's with VERYFAST_MAP_OVERRIDES")
    check(vcounts["vote"].get("widths") == {Q * VERYFAST_P: nbv},
          f"16: veryfast vote widths {vcounts['vote'].get('widths')}")
    check(set(vcounts["row128_fetch"].get("widths", {})) == {VERYFAST_P},
          f"16: veryfast row entry widths "
          f"{vcounts['row128_fetch'].get('widths')}")
    del vm, vidx
    torch.cuda.empty_cache()

    # 4. the wide second pass at 32 (-secondpass 32) over the same reads
    t0 = time.perf_counter()
    sp = Mapper(index, MapConfig(batch_size=B, second_pass_p=32),
                device=dev)
    sp_res = sp.map_codes(codes, np.full(N_REP, READ_LEN, np.int32))
    sp_ok = correct_of(sp_res)
    plain = res.mapped & ~res.suspect
    emit({"phase": "repeats_secondpass", "gpu": smi,
          "seconds": time.perf_counter() - t0,
          "suspects": int(res.suspect.sum()),
          "suspects_recovered": int((res.suspect & ~correct
                                     & sp_ok).sum()),
          "suspects_lost": int((res.suspect & correct & ~sp_ok).sum()),
          "unmapped_recovered": int((~res.mapped & sp_ok).sum()),
          "others_changed": int(differing_rows(res, sp_res)[plain].sum()),
          "correct_frac": float(sp_ok.mean()),
          "roc": roc_of(sp_res.mapped, sp_res.mapq, sp_ok, N_REP)})
    check(not differing_rows(res, sp_res)[plain].any(),
          "16: the second pass changed a row it does not re-map")
    emit({"phase": "repeats_done", "seconds": time.perf_counter() - t_phase})
    return paths


# ---- phase 17: the port's tools ------------------------------------------

N_SWEEP, SWEEP_BATCH = 65_536, 16_384    # 17a's reads and batch
A2A_SHARDS, A2A_BATCHES, A2A_BATCH = 8, 16, 8192      # 17b
A2A_CPU_BATCHES = 2                       # 17b's card = CPU comparison
N_G38 = 65_536                            # 17d's single-end reads
G38_MIN_CORRECT = 0.99                    # 17d, reads clear of genome N
G38_SPAN = READ_LEN + 8                   # a planted read's genome span


def tool_stdout(fn, *args) -> tuple:
    """fn(*args) with its stdout captured (the JSON lines here stay
    the smoke's): (its return value, the lines it printed)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        ret = fn(*args)
    return ret, out.getvalue().splitlines()


def sam_fields(path: str) -> list:
    """The record lines of a SAM file, as their first six fields."""
    with open(path) as f:
        return [ln.split("\t", 6)[:6] for ln in f if not ln.startswith("@")]


def score_verify_se(sam: str, truth_tsv: str, start_of: dict) -> dict:
    """The verify corpus' single-end reads by kind (read i is of kind
    i % 6, tools/make_verify_corpus.py): the planted reads (exact, 3
    SNPs, a 2-base insertion, a 2-base deletion, reverse strand with a
    SNP) at their global POS and strand, the indel reads with I or D in
    the CIGAR, the junk reads unmapped (flag 4)."""
    import re

    kinds = ("exact", "snp", "ins", "del", "revcomp", "junk")
    with open(truth_tsv) as f:
        truth = [ln.split("\t") for ln in f.read().splitlines()]
    out = {k: {"reads": 0, "ok": 0} for k in kinds}
    for qname, flag, rname, pos, _mapq, cigar in sam_fields(sam):
        i, flag = int(qname[1:]), int(flag)
        kind = kinds[i % 6]
        gpos, strand = int(truth[i][1]), int(truth[i][2])
        if kind == "junk":
            ok = bool(flag & 4)
        else:
            ok = (not flag & 4 and bool(flag & 16) == bool(strand)
                  and start_of[rname] + int(pos) - 1 == gpos)
            if kind in ("ins", "del"):
                ok = ok and re.search(r"\d[ID]", cigar) is not None
        out[kind]["reads"] += 1
        out[kind]["ok"] += int(ok)
    return out


def score_verify_pe(sam: str, truth_tsv: str, start_of: dict) -> dict:
    """The verify corpus' pairs: each mate at its global POS, proper
    pairs (flag 0x2), and the rescue pairs (R2 mutated every 15th base,
    placed only by the mate-rescue scan) with both mates placed."""
    with open(truth_tsv) as f:
        truth = [ln.split("\t") for ln in f.read().splitlines()]
    out = {"mates": 0, "mates_placed": 0, "proper_mates": 0,
           "rescue_mates": 0, "rescue_mates_placed": 0}
    for qname, flag, rname, pos, _mapq, _cigar in sam_fields(sam):
        i, flag = int(qname[1:]), int(flag)
        want = int(truth[i][2 if flag & 0x80 else 1])
        ok = not flag & 4 and start_of[rname] + int(pos) - 1 == want
        out["mates"] += 1
        out["mates_placed"] += int(ok)
        out["proper_mates"] += int(bool(flag & 2))
        if truth[i][3] == "1":
            out["rescue_mates"] += 1
            out["rescue_mates_placed"] += int(ok)
    return out


def score_g38(sam: str, truth_npy: str, genome, ref_start: int,
              pe: bool) -> dict:
    """tools/check_sam_truth.py's score of a corpus of
    tools/make_g38_corpus.py (run as a script: it imports numpy only),
    and by the same rule (mapped, POS - 1 + ref_start equal to the
    planted coordinate) the correct share of all reads, and of the
    reads whose planted genome span holds no N: synth_reads samples the
    whole chromosome, N runs included."""
    cmd = [sys.executable, os.path.join(ROOT, "tools", "check_sam_truth.py"),
           sam, truth_npy, "--ref-start", str(ref_start)]
    proc = subprocess.run(cmd + (["--pe"] if pe else []), cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"check_sam_truth: {proc.stderr[-400:]}")
    tool = json.loads(proc.stdout.strip().splitlines()[-1])
    truth = np.load(truth_npy).reshape(2 if pe else 1, -1)
    pos = np.full(truth.shape, -1, np.int64)
    for qname, flag, _rname, p, _mapq, _cigar in sam_fields(sam):
        flag = int(flag)
        if not flag & 4:
            pos[int(bool(pe and flag & 0x80)), int(qname[1:])] = \
                int(p) - 1 + ref_start
    ok = pos == truth
    span = truth[..., None] + np.arange(G38_SPAN)
    clear = ~(genome[np.minimum(span, len(genome) - 1)] == 4).any(-1)
    return {"check_sam_truth": tool, "reads": int(truth.size),
            "correct_frac": float(ok.mean()),
            "n_free_reads": int(clear.sum()),
            "correct_frac_n_free": float(ok[clear].mean())}


def phase_tools(dev, work: str, smi: str) -> dict:
    """Phase 17: the port's tools (urmap_tpu_torch/tools/), each as a
    user calls it, on the card. (a) suspect_sweep over phase 16's
    repeat index (--index-cache) with N_SWEEP reads, and its premise: a
    Mapper with the gate on (suspect_deficit None) gives the MAPQs of the
    host re-application at mismatch_equiv(6); (b) a2a_rounds over that
    index (B3's slots mode), and card = --cpu on A2A_CPU_BATCHES
    batches; (c) make_verify_corpus, then -map single-end and -reverse
    (cli.main in this process, counted, and python -m urmap_tpu_torch,
    the same bodies), scored against the truth TSVs, and the single-end
    body equal to cli.main(..., device="cpu")'s; (d) make_g38_corpus with
    N_G38 reads over phase 10's index of the setup genome, -map both,
    scored by tools/check_sam_truth.py; (e) bench_microvpu at the
    source's defaults (B8 against the torch ops it fuses), its sums equal
    to each other and to micro_numpy's. Returns the counts of the paths
    tools_sweep, tools_a2a, tools_verify_se, tools_verify_pe, tools_g38_se,
    tools_g38_pe and microvpu."""
    import torch

    from urmap_tpu_torch import cli
    from urmap_tpu_torch.config import resolve_suspect_deficits
    from urmap_tpu_torch.index import UfiIndex
    from urmap_tpu_torch.index.store import save_prepared
    from urmap_tpu_torch.map import Mapper
    from urmap_tpu_torch.tools import (a2a_rounds, bench_microvpu,
                                       make_g38_corpus, make_verify_corpus,
                                       suspect_sweep)

    t_phase = time.perf_counter()
    paths = {}
    rufi = os.path.join(work, "repeats", "g.ufi")

    # (a) the suspect sweep over phase 16's index; its --genome-mbp must
    # give back the genome's length through int(mbp * 1e6)
    mbp = repr((CHR21_LEN + 0.5) / 1e6)
    check(int(float(mbp) * 1e6) == CHR21_LEN, f"17a: --genome-mbp {mbp}")
    t0 = time.perf_counter()
    save_prepared(UfiIndex.load(rufi), rufi, VERYFAST_P)   # the sweep's p
    prep_s = time.perf_counter() - t0
    argv = ["--index-cache", rufi, "--genome-mbp", mbp, "--reads",
            str(N_SWEEP), "--batch", str(SWEEP_BATCH)]
    reset_counters()
    t0 = time.perf_counter()
    run, lines = tool_stdout(suspect_sweep.sweep, argv)
    torch.cuda.synchronize(dev)
    sweep_s = time.perf_counter() - t0
    paths["tools_sweep"] = counts = read_counters()
    check_counters(counts, "17a suspect_sweep")
    check(run["device"].type == "cuda", "17a: the sweep did not map on "
          "the card")
    res, mcfg, sc = run["res"], run["mcfg"], run["sc"]
    gated_cfg = dataclasses.replace(mcfg, suspect_deficit=None)
    T, _remap = resolve_suspect_deficits(gated_cfg, sc)
    gated = Mapper(run["index"], gated_cfg, device=dev).map_codes(
        run["codes"], run["lengths"])
    host = suspect_sweep.reapply_gate(res, run["lengths"], T, sc, mcfg)
    premise = {"T": T, "capped": int((host != res.mapq).sum()),
               "mapq_differing": int((gated.mapq != host).sum()),
               "other_fields_differing": [
                   f for f in FIELDS if f != "mapq"
                   and not np.array_equal(getattr(gated, f),
                                          getattr(res, f))]}
    emit({"phase": "tools_sweep", "gpu": smi, "argv": argv,
          "prepare_p8_s": prep_s, "seconds": sweep_s,
          "reads_per_s": N_SWEEP / sweep_s,
          "correct_frac": float(run["correct"].mean()),
          "table": [ln for ln in lines if not ln.startswith("# cached")],
          "premise": premise, "counters": counts})
    check(T == sc.mismatch_equiv(6), f"17a: derived T {T}")
    check(len(lines) == 3 + 1 + 5, f"17a: the sweep printed {lines}")
    check(premise["mapq_differing"] == 0
          and not premise["other_fields_differing"],
          f"17a: the host gate at T={T} is not the device gate: {premise}")
    check(counts["vote"].get("widths") == {Q * VERYFAST_P:
                                           N_SWEEP // SWEEP_BATCH},
          f"17a: vote widths {counts['vote'].get('widths')}")
    del run, res, gated
    torch.cuda.empty_cache()

    # (b) a2a_rounds: the seed front's slots mode, on the card and on the
    # CPU (--cpu) over the same first batches
    a2a = ["--index-cache", rufi, "--shards", str(A2A_SHARDS), "--batch",
           str(A2A_BATCH)]
    reset_counters()
    t0 = time.perf_counter()
    _, lines = tool_stdout(a2a_rounds.main,
                           a2a + ["--batches", str(A2A_BATCHES)])
    torch.cuda.synchronize(dev)
    a2a_s = time.perf_counter() - t0
    paths["tools_a2a"] = counts = read_counters()
    got = json.loads(lines[-1])
    slots_launches = counts["seed_front_slots"]["launches"]
    # card = --cpu on the first batches, at the adaptive slack and at
    # URMAP_A2A_SLACK=0.3 (its override), where batches take several
    # rounds, so the slot counts a shard are compared too
    short = a2a + ["--batches", str(A2A_CPU_BATCHES)]
    t0 = time.perf_counter()
    pairs = {}
    for slack in (None, "0.3"):
        if slack:
            os.environ["URMAP_A2A_SLACK"] = slack
        try:
            pairs[slack or "adaptive"] = [
                json.loads(tool_stdout(a2a_rounds.main, short + extra)[1][-1])
                for extra in ([], ["--cpu"])]
        finally:
            os.environ.pop("URMAP_A2A_SLACK", None)
    emit({"phase": "tools_a2a", "gpu": smi, "seconds": a2a_s,
          "result": got, "table": lines[:-1],
          "card_equals_cpu": {k: a == b for k, (a, b) in pairs.items()},
          "short": {k: a for k, (a, _b) in pairs.items()},
          "short_seconds": time.perf_counter() - t0, "counters": counts})
    check(slots_launches == 2 * A2A_BATCHES,
          f"17b: seed_front_slots launches {slots_launches}")
    check(all(c["plain_calls"] == 0 for c in counts.values()),
          "17b: a plain version ran on the card's run")
    check(got["metric"] == "a2a_rounds" and got["shards"] == A2A_SHARDS,
          f"17b: {got}")
    for k, (card, cpu) in pairs.items():
        check(card == cpu, f"17b {k}: card {card} != --cpu {cpu}")
    check(pairs["0.3"][0]["adaptive"]["rounds_max"] > 1,
          f"17b: slack 0.3 took one round: {pairs['0.3'][0]}")

    # (c) the verify corpus
    vdir = os.path.join(work, "verify")
    t0 = time.perf_counter()
    check(tool_stdout(make_verify_corpus.main, [vdir])[0] == 0,
          "17c: make_verify_corpus")
    corpus_s = time.perf_counter() - t0
    ufi = os.path.join(vdir, "g.ufi")
    vdb = UfiIndex.load(ufi).seqdb
    start_of = {lb: int(s) for lb, s in zip(vdb.labels, vdb.starts)}
    se_in = ["-map", os.path.join(vdir, "se.fq"), "-ufi", ufi]
    pe_in = ["-map", os.path.join(vdir, "r1.fq"), "-reverse",
             os.path.join(vdir, "r2.fq"), "-ufi", ufi]
    runs, bodies = {}, {}
    for name, args in (("se", se_in), ("pe", pe_in)):
        sam = os.path.join(vdir, f"{name}.sam")
        reset_counters()
        runs[name] = cli_map(dev, args + ["-samout", sam, "-quiet"])
        paths[f"tools_verify_{name}"] = read_counters()
        bodies[name] = b"".join(sam_records(sam))
        # the same command as its own process
        sub = os.path.join(vdir, f"{name}_sub.sam")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "urmap_tpu_torch", *args, "-samout", sub,
             "-quiet"], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, text=True, timeout=600)
        runs[name]["subprocess_s"] = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"17c: python -m urmap_tpu_torch {name}: {proc.stderr[-400:]}")
        runs[name]["subprocess_equal"] = proc.returncode == 0 and \
            b"".join(sam_records(sub)) == bodies[name]
    se = score_verify_se(os.path.join(vdir, "se.sam"),
                         os.path.join(vdir, "se_truth.tsv"), start_of)
    pe = score_verify_pe(os.path.join(vdir, "pe.sam"),
                         os.path.join(vdir, "pe_truth.tsv"), start_of)
    cpu_sam = os.path.join(vdir, "se_cpu.sam")
    t0 = time.perf_counter()
    check(tool_stdout(lambda: cli.main(
        se_in + ["-samout", cpu_sam, "-quiet", "-batch", "3000"],
        device="cpu"))[0] == 0, "17c: cli.main on the CPU")
    cpu_equal = b"".join(sam_records(cpu_sam)) == bodies["se"]
    emit({"phase": "tools_verify", "gpu": smi, "corpus_s": corpus_s,
          "runs": runs, "se": se, "pe": pe, "se_card_equals_cpu": cpu_equal,
          "cpu_s": time.perf_counter() - t0,
          "counters": {n: paths[f"tools_verify_{n}"] for n in ("se", "pe")}})
    for name in ("se", "pe"):
        c = paths[f"tools_verify_{name}"]
        check(all(v["plain_calls"] == 0 for v in c.values()),
              f"17c {name}: a plain version ran")
        for k in ("seed_front", "row128_fetch", "vote", "banded_dp",
                  "tb_dops"):
            check(c[k]["launches"] > 0, f"17c {name}: {k} not launched")
        check(runs[name]["subprocess_equal"], f"17c {name}: python -m "
              "urmap_tpu_torch's body differs from cli.main's")
    check(all(v["ok"] == v["reads"] > 0 for v in se.values()),
          f"17c: single-end reads off their plants: {se}")
    check(pe["mates"] == 3000 and pe["mates_placed"] == pe["mates"]
          and pe["proper_mates"] == pe["mates"]
          and pe["rescue_mates_placed"] == pe["rescue_mates"] > 0,
          f"17c: pairs off their plants: {pe}")
    check(cpu_equal, "17c: the card's single-end body differs from the "
          "CPU's")

    # (d) the GRCh38-scale corpus over the setup genome's index (phase 10)
    cufi = os.path.join(work, "cli.ufi")
    gdir = os.path.join(work, "g38")
    os.makedirs(gdir, exist_ok=True)
    t0 = time.perf_counter()
    check(tool_stdout(make_g38_corpus.main,
                      ["--index-cache", cufi, "--reads", str(N_G38),
                       "--out-dir", gdir])[0] == 0, "17d: make_g38_corpus")
    corpus_s = time.perf_counter() - t0
    gdb = UfiIndex.load(cufi).seqdb
    g38 = {}
    for name, args in (("se", ["-map", os.path.join(gdir, "g38_se.fq")]),
                       ("pe", ["-map", os.path.join(gdir, "g38_r1.fq"),
                               "-reverse", os.path.join(gdir, "g38_r2.fq")])):
        sam = os.path.join(gdir, f"{name}.sam")
        reset_counters()
        run = cli_map(dev, args + ["-ufi", cufi, "-samout", sam, "-quiet"])
        paths[f"tools_g38_{name}"] = c = read_counters()
        g38[name] = {**run, **score_g38(
            sam, os.path.join(gdir, f"g38_{name}_truth.npy"), gdb.codes,
            int(gdb.starts[0]), name == "pe")}
        check(all(v["plain_calls"] == 0 for v in c.values()),
              f"17d {name}: a plain version ran")
    emit({"phase": "tools_g38", "gpu": smi, "corpus_s": corpus_s,
          "min_correct_n_free": G38_MIN_CORRECT, **g38,
          "counters": {n: paths[f"tools_g38_{n}"] for n in ("se", "pe")}})
    for name in ("se", "pe"):
        check(g38[name]["correct_frac_n_free"] >= G38_MIN_CORRECT,
              f"17d {name}: correct over N-free reads "
              f"{g38[name]['correct_frac_n_free']}")

    # (e) the micro-benchmark at the source's defaults: B8 launched, the
    # torch row's and the kernel row's last sums equal to numpy's
    reset_counters()
    t0 = time.perf_counter()
    mv, lines = tool_stdout(bench_microvpu.run, [])
    torch.cuda.synchronize(dev)
    mv_s = time.perf_counter() - t0
    paths["microvpu"] = counts = read_counters()
    x = bench_microvpu.operands(mv["n"], mv["w"], "cpu")[mv["last_operand"]]
    want = int(micro_numpy(x.numpy().view(np.uint32), mv["passes"])
               .sum(dtype=np.uint64)) & 0xFFFF_FFFF
    emit({"phase": "tools_microvpu", "gpu": smi, "seconds": mv_s,
          "lines": lines, **mv, "numpy_sum": want,
          "counters": counts["micro_passes"]})
    check(len(lines) == 5 and lines[4].startswith("marginal: "),
          f"17e: the tool printed {lines}")
    check(mv["sums"]["torch"] == mv["sums"]["kernel"] == want,
          f"17e: sums {mv['sums']}, numpy {want}")
    check(counts["micro_passes"]["launches"] == 2 + mv["iters"],
          f"17e: micro_passes launches {counts['micro_passes']}")
    check(all(c["plain_calls"] == 0 for c in counts.values())
          and all(c["launches"] == 0 for k, c in counts.items()
                  if k != "micro_passes"),
          f"17e: another kernel or a plain version ran: {counts}")
    emit({"phase": "tools_done", "seconds": time.perf_counter() - t_phase})
    return paths


def micro_numpy(x: np.ndarray, passes: int) -> np.ndarray:
    """tools/bench_microvpu.py's ``body`` in numpy uint32 (every step
    wraps modulo 2^32): phase 17(e)'s reference for the tool's sums."""
    h = np.array(x, np.uint32)
    for i in range(passes):
        h *= np.uint32(0x9E3779B1 + 2 * i + 1)
        h ^= h >> np.uint32(15)
        h += np.uint32(0x85EBCA6B)
    return h


def differing_rows(a, b) -> np.ndarray:
    """bool per row: any of FIELDS differs between two MapResults."""
    out = np.zeros(len(a.mapped), bool)
    for f in FIELDS:
        out |= np.asarray(getattr(a, f)) != np.asarray(getattr(b, f))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=131_072)
    ap.add_argument("--pairs", type=int, default=65_536)
    # one rank of phase 14b, started by the smoke itself
    ap.add_argument("--mesh-rank", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh_rank:
        return mesh_rank_main(args.mesh_rank)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from urmap_tpu_torch import require_device
    from urmap_tpu_torch.config import MapConfig, ScoreConfig
    from urmap_tpu_torch.io import native
    from urmap_tpu_torch.kernels import _build
    from urmap_tpu_torch.map import Mapper

    # the host times below must be the C++ codecs', not the numpy twins'
    check(native.lib() is not None,
          "the port's native codecs did not build (g++)")
    dev = require_device("cuda")
    smi = smi_line()
    emit({"phase": "device", "gpu": smi, "host_cpu": cpu_model(),
          "cpu_count": os.cpu_count(),
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.load()
    ptxas = [ln for ln in _build.build_log["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "seconds_by_source": _build.build_log["by_source"],
          "library": os.path.relpath(_build.build_log["path"], ROOT),
          "ptxas": ptxas})

    rng = np.random.default_rng(args.seed)
    recs = phase_kernels(dev, rng, 2 * B, 2 * (B // 8) * V,
                         2 * (B // 32) * V)
    emit({"phase": "kernels", "gpu": smi, **recs})
    phase3 = read_counters()
    # phase 3's table past 2^31 words went with its cases: give it back
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated(dev) < (1 << 30),
          f"{torch.cuda.memory_allocated(dev)} bytes still held after "
          "phase 3")

    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    n_half = min(args.reads, max(args.reads // 2, N_CPU))
    # the genome, reads and pairs come from a stream of their own: a case
    # added to phase 3 must not change what the paths map
    w = make_world(np.random.default_rng([args.seed, 1]), work, args.reads,
                   n_half, args.pairs, CHR21_LEN)
    emit({"phase": "setup", "seconds": w["setup_s"],
          "layouts": [w["prepared"][1]["layout"],
                      w["prepared128"][1]["layout"]],
          "off_bits": w["prepared128"][1]["off_bits"]})
    mcfg = MapConfig(batch_size=B)           # the default: traceback on
    check(mcfg.tb_bits, "the default MapConfig has the traceback on")
    sc = ScoreConfig()
    mappers = {
        "on": Mapper(w["index"], mcfg, sc, device=dev,
                     prepared=w["prepared"]),
        "off": Mapper(w["index"], MapConfig(batch_size=B, tb_bits=False), sc,
                      device=dev, prepared=w["prepared"]),
        "row128": Mapper(w["index"], mcfg, sc, device=dev,
                         prepared=w["prepared128"]),
    }
    check(mappers["on"].tb and mappers["row128"].tb
          and not mappers["off"].tb, "the traceback switch of the Mappers")
    aligned = run_single_end(dev, w, mappers["on"], "slice", w["reads_half"],
                             n_half, B, smi, os.path.join(work, "out.sam"))
    phase_profile(mappers, w["db"], w["reads"], B, work)
    phase_cpu(w, mappers, aligned["sam"], B)
    r128 = phase_row128(dev, w, mappers["row128"], aligned, B, smi, work)
    pe_counts = phase_paired(dev, w, mappers["row128"], smi, work)
    sg_counts = phase_semiglobal(dev, w, r128, N_CPU)
    w["seed"] = args.seed
    sh_counts = phase_shapes(dev, w, smi, work, N_SHAPES)
    cli_counts = phase_cli(dev, w, aligned, smi, work)
    tier = phase_tier(dev, w, aligned, mappers["on"], smi, work)
    phase_spill(w, work)
    scale_counts = phase_scale(dev, mcfg, sc, smi, work, args.seed)
    mesh = phase_mesh(dev, w, aligned, smi, work)
    phase_device_build(dev, w, smi, work)
    repeats = phase_repeats(dev, smi, work, args.seed)
    tools = phase_tools(dev, work, smi)

    src = "urmap_tpu_torch/csrc/"
    tpu = "urmap_tpu/kernels/"
    w_dp = 2 * (-(-(L_MAX + 2 * HW) // 16) + 1)
    w_rescue = 2 * (-(-RESCUE_W // 16) + 1)
    # name → (source, TPU kernel: under urmap_tpu/kernels/ unless a path
    # is given)
    sources = {
        "seed_front": ("seed_slots.cu", "seed_slots.py:192"),
        "seed_front_slots": ("seed_slots.cu", "seed_slots.py:192"),
        "row128_fetch": ("lane_rotate.cu", "lane_rotate.py:120"),
        "vote": ("vote.cu", "vote.py:123"),
        "window_mismatches": ("lane_rotate.cu", "lane_rotate.py:120"),
        "window_codes": ("lane_rotate.cu", "lane_rotate.py:120"),
        f"window_codes_w{RESCUE_W}": ("lane_rotate.cu", "lane_rotate.py:120"),
        "banded_dp": ("banded_dp.cu", "banded_dp.py:172"),
        "banded_dp_clip": ("banded_dp.cu", "banded_dp.py:172"),
        "tb_dops": ("tb_dp.cu", "tb_dp.py:548"),
        "banded_semiglobal": ("banded_dp.cu", "banded_dp.py:199"),
        "row128_window_fetch": ("lane_rotate.cu", "lane_rotate.py:120"),
        f"row128_window_fetch_w{w_dp}": ("lane_rotate.cu",
                                         "lane_rotate.py:120"),
        f"row128_window_fetch_w{w_rescue}": ("lane_rotate.cu",
                                             "lane_rotate.py:120"),
        "banded_semiglobal_clip": ("banded_dp.cu", "banded_dp.py:199"),
        "rotate_narrow": ("lane_rotate.cu", "lane_rotate.py:120"),
        "tb_bits": ("tb_dp.cu", "tb_dp.py:227"),
        "micro_passes": ("micro_passes.cu", "tools/bench_microvpu.py:73"),
        # no TPU kernel: the reference runs this DP on the host
        "clip_tb": ("clip_tb.cu",
                    "urmap_tpu/io/native/codecs.cpp:298 (host, clip mode)"),
    }
    # entries that share a counter, told apart by the width it records
    by_width = {
        "window_codes": ("window_codes", L_MAX + 2 * HW),
        f"window_codes_w{RESCUE_W}": ("window_codes", RESCUE_W),
        "row128_window_fetch": ("row128_window_fetch",
                                2 * (-(-L_MAX // 16) + 1)),
        f"row128_window_fetch_w{w_dp}": ("row128_window_fetch", w_dp),
        f"row128_window_fetch_w{w_rescue}": ("row128_window_fetch",
                                             w_rescue)}
    # the same kernel held against its plain version on other inputs in
    # phase 3: the [R, 128] view of the table, other batch sizes
    variants = {
        "seed_front": ["seed_front_packed", "seed_front_obase_past_2^31"],
        "row128_fetch": ["row128_fetch_tier4", "row128_fetch_tier8",
                         "row128_fetch_past_2^31",
                         f"row128_fetch_p{VERYFAST_P}"],
        "vote": [f"vote_m{Q * VERYFAST_P}", "vote_m256", "vote_m2048"],
        "window_mismatches": ["window_mismatches_row128"],
        "window_codes": ["window_codes_row128"],
        "banded_dp": ["banded_dp_hw12", "banded_dp_hw24", "banded_dp_hw40",
                      "banded_dp_L700", "banded_dp_L2000"],
        "banded_dp_clip": ["banded_dp_clip_n32768", "banded_dp_hw12_clip",
                           "banded_dp_hw24_clip", "banded_dp_hw40_clip"],
        "banded_semiglobal": ["banded_semiglobal_hw12",
                              "banded_semiglobal_hw24",
                              "banded_semiglobal_hw40"],
        "tb_dops": ["tb_dops_n128", "tb_dops_n16384", "tb_dops_hw12",
                    "tb_dops_hw24", "tb_dops_hw31", "tb_dops_L700",
                    "tb_dops_L2000"],
        "tb_bits": ["tb_bits_hw12", "tb_bits_hw24", "tb_bits_hw31"],
        "micro_passes": ["micro_passes_1000x127", "micro_passes_3x1"]}

    def launches_in(counts: dict, name: str) -> int:
        """Launches of a kernels-line entry in one path's counters."""
        if name in by_width:
            counter, width = by_width[name]
            return counts[counter].get("widths", {}).get(width, 0)
        return counts[name]["launches"]

    # launches: the counts over the paths (aligned slice, row128 slice,
    # paired run, semiglobal, shapes, the cli phase's -map runs: cli,
    # endclip, endclip_paired, secondpass, the tiered slice, the scale
    # run and the sharded runs of phase 14, this process's and the four
    # ranks' summed, phase 16's repeats, repeats_paired and veryfast, and
    # phase 17's tools: the sweep, a2a_rounds (the slots mode), the
    # corpora's -map runs, bench_microvpu, the one path of B8), each read
    # just after its run
    # with the counters set to 0 just before it, summed; by path under
    # launches_by_path.
    # banded_semiglobal's path is phase 8 (the winners re-aligned over
    # the byte genome). The plain window entry serves the classic
    # layout's positions only, and the clip mode of B1', the literal
    # rotate and tb_bits have no caller on any path: 0; phase 3 launched
    # them phase3_launches times (one compared, eight timed).
    paths = {"slice": aligned["counts"], "row128": r128["counts"],
             "paired": pe_counts, "semiglobal": sg_counts,
             "shapes": sh_counts, **cli_counts, "tier": tier["counts"],
             "scale": scale_counts, "mesh": mesh["counts"], **repeats,
             **tools}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for name, (cu, py) in sources.items():
        by_path = {p: launches_in(c, name) for p, c in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src + cu,
            "replaces": py if "/" in py else tpu + py,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "phase3_launches": launches_in(phase3, name),
            **{k: recs[name][k] for k in keys},
            **({"variants": {v: {k: recs[v][k] for k in keys + ("n",)}
                             for v in variants[name]}}
               if name in variants else {})})
    off_path = ("row128_window_fetch", f"row128_window_fetch_w{w_dp}",
                f"row128_window_fetch_w{w_rescue}", "banded_semiglobal_clip",
                "rotate_narrow", "tb_bits")
    check(all(k["launches"] > 0 for k in kernels
              if k["name"] not in off_path),
          f"a kernel of the paths was never launched: {kernels}")
    check(all(k["launches"] == 0 for k in kernels if k["name"] in off_path),
          f"a kernel off the paths was launched there: {kernels}")
    b8 = next(k for k in kernels if k["name"] == "micro_passes")
    check(b8["launches_by_path"]["microvpu"] > 0
          and b8["launches"] == b8["launches_by_path"]["microvpu"],
          f"micro_passes launched outside its tool: {b8}")
    emit({"kernels": kernels,
          "mesh": {k: mesh[k] for k in ("a2a_loops", "a2a_rounds")},
          "tier_rounds": {
              **{k: tier[k] for k in ("batches", "calls", "rounds")},
              "host_syncs_one_batch": {
                  k: v for k, v in tier["host_syncs_one_batch"].items()
                  if not k.endswith("_sites")}},
          "note": "row128_window_fetch (the classic layout's fetch), "
                  "banded_semiglobal_clip, rotate_narrow and tb_bits have "
                  "no caller on these paths: their launches there are 0, "
                  "phase 3 held each against its plain version; "
                  "micro_passes (B8) runs on the microvpu path (phase "
                  "17e) alone"})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
