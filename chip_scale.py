"""GRCh38-scale run of urmap_tpu_torch on one CUDA card: a synthetic
genome of GRCh38's size through the command line, as a sequencing
pipeline runs it, and what each stage costs.

    python3 chip_scale.py --gbp 3.1 [--reads 1048576] [--pairs 262144]
                          [--spill-dir DIR] [--work DIR] [--seed 0]
                          [--device-build] [--repeat-frac F] [--veryfast]

1. the host: free -g, df -h of the work and spill directories, nproc,
   the card's name and power limit; the disk the run needs, estimated,
   against what is free (exit 2 before any work when it does not fit);
2. genome: 24 chromosomes with GRCh38's lengths (chr1-22, X, Y) scaled
   to --gbp, each from chip_smoke.make_genome (random bases, a leading N
   run and six interior ones), written as FASTA; with --repeat-frac F,
   tools/accuracy.py's plant_repeat_families (one SINE- and one LINE-like
   family, exact segmental duplications, tandem runs) overwrites a
   fraction F of the whole genome first, the chromosomes end to end;
   planted reads (phase 4's mix) and FR pairs (phase 7's mix), 80% of
   them in the chromosomes that lie past global position 2^31, written
   as FASTQ;
3. make_ufi: `python -m urmap_tpu_torch -make_ufi` in a process of its
   own, auto slot_bits (30 for a human genome), the disk radix spill
   under --spill-dir (its TMPDIR): seconds by stage (from the spill
   directory's life and the index files' times), the spill's peak bytes
   on disk, the process's peak RSS, the index directory's bytes, the
   SHA-256 of its offsets.npy and positions.npy; with --device-build
   first `-make_ufi -device_build` (k-mers extracted, hashed and sorted
   on the card in chunks of DEFAULT_CHUNK words, slot-sorted into the
   spill) with the same figures, its index removed before the host
   build, whose hashes must equal it; with --veryfast `-make_ufi
   -veryfast` (auto + 2 slot_bits, at most 30: at this size only the
   header flag, which makes -map apply VERYFAST_MAP_OVERRIDES, and the
   tables prepared at positions_per_seed 8 differ);
4. map: `python -m urmap_tpu_torch -map` single-end and with -reverse,
   each in a process of its own, so the process start, the index load
   and the table upload are in the wall time: reads/s of the map loop
   (the CLI's summary) and over the wall, peak RSS, the correct
   fraction from the SAM (POS and strand of the planted read), in all
   and past 2^31, and the ROC by MAPQ from the SAM's MAPQ column (a
   call at q: mapped with MAPQ >= q; precision: its correct share;
   recall: correct calls over the planted reads or mates). With
   --repeat-frac, -map may stop on a read the SAM writer refuses
   (ROADMAP C.3, urmap_tpu's fault, which the port copies): its exit
   and the error are recorded, and the run goes on;
5. profile: in this process a Mapper over the index's prepared tables
   (the card bytes they take, the upload's seconds) and one batch under
   torch.profiler: kernel B5's row entry (launches, device ms a launch)
   beside its bound from this batch's starts (the seed front's CSR
   runs), at a positions table past 2^31 words; with --repeat-frac it
   first maps every single-end read (batches of 65,536, as -map): the
   ROC by MAPQ from the results, the weak, suspect and clip-rescued
   counts and the reads the SAM writer refuses (chip_smoke.c3_prone);
   where -map stopped, -map runs again over the reads less those
   (map_se_kept).

Each stage prints one JSON line as it ends, so a run that a time limit
cuts shows how far it got.
At 3.1 Gbp it needs ~43 GB of disk (FASTA, then the spill or the
index) and ~78 GB of host RAM (-make_ufi's peak RSS on a machine of 8
CPUs and 101 GB, where the whole run took 461 s; PERF.md section 5).
Scratch goes to build/chip_scale/ in the checkout, or to --work: a
directory that is empty, missing, or an earlier run's (it holds the
marker file .chip_scale); any other is refused, since a run clears it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

# GRCh38 primary assembly, chromosome lengths (NCBI GCA_000001405.15)
GRCH38 = [("chr1", 248_956_422), ("chr2", 242_193_529),
          ("chr3", 198_295_559), ("chr4", 190_214_555),
          ("chr5", 181_538_259), ("chr6", 170_805_979),
          ("chr7", 159_345_973), ("chr8", 145_138_636),
          ("chr9", 138_394_717), ("chr10", 133_797_422),
          ("chr11", 135_086_622), ("chr12", 133_275_309),
          ("chr13", 114_364_328), ("chr14", 107_043_718),
          ("chr15", 101_991_189), ("chr16", 90_338_345),
          ("chr17", 83_257_441), ("chr18", 80_373_285),
          ("chr19", 58_617_616), ("chr20", 64_444_167),
          ("chr21", 46_709_983), ("chr22", 50_818_468),
          ("chrX", 156_040_895), ("chrY", 57_227_415)]
TWO31 = 1 << 31
PAST_SHARE = 0.8         # of the reads and pairs, in chromosomes past 2^31
MARKER = ".chip_scale"   # marks a --work directory as this script's to clear


def sh(cmd: list) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (out.stdout + out.stderr).strip()


def layout(gbp: float):
    """Scaled chromosome lengths and their global starts as SeqDB lays a
    FASTA out (a separator of N before each and after the last)."""
    from urmap_tpu_torch.io.fasta import SEPARATOR_LEN

    tot = sum(n for _, n in GRCH38)
    lens = [int(round(n * gbp * 1e9 / tot)) for _, n in GRCH38]
    starts, pos = [], SEPARATOR_LEN
    for n in lens:
        starts.append(pos)
        pos += n + SEPARATOR_LEN
    return [c for c, _ in GRCH38], np.asarray(lens), np.asarray(starts)


def need_disk_bytes(gbp: float) -> int:
    """FASTA + max(spill, index + prepared tables): the spill is 8 bytes
    a word and goes before the index is saved; the index holds 4-byte
    offsets at 2^30 slots, 4-byte positions and the codes; the prepared
    row128 tables the offsets twice (plain and packed: 6 bytes a slot),
    the padded positions and the 2-bit genome."""
    g = gbp * 1e9
    slots = 1 << 30
    index = 4 * slots + 4 * g + g
    prepared = 6 * slots + 4.1 * g + g / 4
    return int(g * 81 / 80 + max(8 * g, index + prepared))


class Sampler(threading.Thread):
    """Polls a directory's bytes every 0.25 s while a child runs: the
    peak, and when the spill directory first appeared, peaked and went."""

    def __init__(self, root: str):
        super().__init__(daemon=True)
        self.root, self.stop = root, threading.Event()
        self.peak, self.t_first, self.t_peak, self.t_gone = 0, None, None, None
        self.t0 = time.perf_counter()

    def run(self):
        while not self.stop.is_set():
            n, seen = 0, False
            for d, _dirs, names in os.walk(self.root):
                if d != self.root:
                    seen = True
                for x in names:
                    try:
                        n += os.path.getsize(os.path.join(d, x))
                    except OSError:
                        pass
            t = time.perf_counter() - self.t0
            if seen and self.t_first is None:
                self.t_first = t
            if n > self.peak:
                self.peak, self.t_peak = n, t
            if not seen and self.t_first is not None and self.t_gone is None:
                self.t_gone = t
            self.stop.wait(0.25)


def run_child(args: list, env: dict, log: str, sampler=None) -> dict:
    """Run ``python -m urmap_tpu_torch args`` → rc, wall seconds, the
    child's own peak RSS (wait4), its stderr's tail."""
    t0 = time.perf_counter()
    with open(log, "w") as err:
        p = subprocess.Popen([sys.executable, "-m", "urmap_tpu_torch", *args],
                             cwd=ROOT, env=env, stdout=err, stderr=err)
        if sampler:
            sampler.t0 = t0
            sampler.start()
        _pid, status, ru = os.wait4(p.pid, 0)
        p.returncode = os.waitstatus_to_exitcode(status)
    wall = time.perf_counter() - t0
    if sampler:
        sampler.stop.set()
        sampler.join()
    with open(log) as f:
        tail = f.read()[-2000:]
    return {"rc": p.returncode, "wall_s": wall,
            "peak_rss_bytes": ru.ru_maxrss * 1024, "stderr_tail": tail}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(path) for n in names)


def make_inputs(rng, work: str, gbp: float, n_reads: int, n_pairs: int,
                repeat_frac: float = 0.0):
    """FASTA, FASTQ and the truth (chromosome, 0-based local start,
    strand) of every read and mate; the reads' codes. With
    ``repeat_frac``, repeat families planted over the whole genome."""
    labels, lens, starts = layout(gbp)
    past = starts >= TWO31
    w = lens.astype(float)
    p_reads = np.where(past, PAST_SHARE * w / max(w[past].sum(), 1),
                       (1 - PAST_SHARE) * w / max(w[~past].sum(), 1))
    if not past.any():
        p_reads = w / w.sum()
    per_read = rng.multinomial(n_reads, p_reads / p_reads.sum())
    per_pair = rng.multinomial(n_pairs, p_reads / p_reads.sum())
    fa = os.path.join(work, "genome.fa")
    se, pe = [], []
    whole = None
    if repeat_frac > 0:
        from urmap_tpu_torch.tools.accuracy import plant_repeat_families

        whole = np.concatenate([smoke.make_genome(rng, int(n))
                                for n in lens])
        plant_repeat_families(rng, whole, repeat_frac)
        ends = np.cumsum(lens)
    with open(fa, "wb") as f:
        for c, (lab, n) in enumerate(zip(labels, lens)):
            g = (smoke.make_genome(rng, int(n)) if whole is None
                 else whole[ends[c] - n : ends[c]])
            chars = np.frombuffer(b"ACGTN", np.uint8)[g]
            f.write(f">{lab}\n".encode())
            for s in range(0, len(chars), 80 << 20):
                blk = chars[s : s + (80 << 20)]
                full = len(blk) // 80 * 80
                lines = blk[:full].reshape(-1, 80)
                nl = np.full((len(lines), 1), ord("\n"), np.uint8)
                f.write(np.hstack([lines, nl]).tobytes())
                if full < len(blk):
                    f.write(blk[full:].tobytes() + b"\n")
            one = types.SimpleNamespace(codes=g, starts=np.array([0]),
                                        lengths=np.array([n]))
            if per_read[c]:
                codes, truth, strand = smoke.plant_reads(rng, one,
                                                         int(per_read[c]))
                se.append((codes, np.full(len(truth), c), truth, strand))
            if per_pair[c]:
                c1, c2, t = smoke.plant_pairs(rng, one, int(per_pair[c]))
                pe.append((c1, c2, np.full(len(c1), c), t))
            del g, chars
    order = rng.permutation(n_reads)
    codes = np.concatenate([x[0] for x in se])[order]
    truth = {"chrom": np.concatenate([x[1] for x in se])[order],
             "pos": np.concatenate([x[2] for x in se])[order],
             "strand": np.concatenate([x[3] for x in se])[order]}
    smoke.write_fastq(os.path.join(work, "se.fq"), codes)
    order = rng.permutation(n_pairs)
    c1 = np.concatenate([x[0] for x in pe])[order]
    c2 = np.concatenate([x[1] for x in pe])[order]
    ptruth = {"chrom": np.concatenate([x[2] for x in pe])[order]}
    for k in ("pos1", "pos2", "strand1", "strand2"):
        ptruth[k] = np.concatenate([x[3][k] for x in pe])[order]
    smoke.write_fastq(os.path.join(work, "r1.fq"), c1)
    smoke.write_fastq(os.path.join(work, "r2.fq"), c2)
    return fa, (labels, lens, starts), truth, ptruth, codes


def sam_calls(path: str, labels: list) -> dict:
    """Per record: read index, first mate, mapped, chromosome, 0-based
    local start less the leading soft clip, strand, MAPQ."""
    lab = {x.encode(): i for i, x in enumerate(labels)}
    cols = {k: [] for k in ("i", "first", "mapped", "chrom", "pos",
                            "strand", "mapq")}
    with open(path, "rb") as f:
        for ln in f:
            if ln.startswith(b"@"):
                continue
            q = ln.split(b"\t", 6)
            flag = int(q[1])
            lead = re.match(rb"(\d+)S", q[5])
            cols["i"].append(int(q[0][1:]))
            cols["first"].append(not flag & 0x80)
            cols["mapped"].append(not flag & 4)
            cols["chrom"].append(lab.get(q[2], -1))
            cols["pos"].append(int(q[3]) - 1 - (int(lead.group(1))
                                                if lead else 0))
            cols["strand"].append(int(bool(flag & 16)))
            cols["mapq"].append(int(q[4]))
    return {k: np.asarray(v) for k, v in cols.items()}


def write_fastq_named(path: str, codes: np.ndarray, names) -> None:
    """FASTQ of ``codes`` with read i named r<names[i]> (the read's
    index in the whole set, which the truth arrays take)."""
    chars = np.frombuffer(b"ACGTNN", np.uint8)[codes]
    qual = b"I" * codes.shape[1]
    with open(path, "wb") as f:
        for s in range(0, len(codes), 65536):
            f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (int(k), row.tobytes(),
                                                        qual)
                             for k, row in zip(names[s : s + 65536],
                                               chars[s : s + 65536])))


# the error urmap_tpu's SAM writer, and the port's, stop -map with on a
# read whose banded DP score the host DP at its POS does not reproduce
# (ROADMAP C.3)
C3_ERROR = "native traceback score mismatch"


def correct_of(calls: dict, chrom, pos, strand, sel) -> np.ndarray:
    i = calls["i"][sel]
    return (calls["mapped"][sel].astype(bool) & (calls["chrom"][sel]
                                                 == chrom[i])
            & (calls["pos"][sel] == pos[i])
            & (calls["strand"][sel] == strand[i]))


def sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while blk := f.read(1 << 24):
            h.update(blk)
    return h.hexdigest()


def make_ufi(fa: str, ufi: str, env: dict, work: str, spill: str, starts,
             labels: list, device: bool = False,
             veryfast: bool = False) -> dict:
    """`-make_ufi` (with -device_build when ``device``, -veryfast when
    ``veryfast``) in a process of its own: its record, printed, with the
    stage seconds, the spill's peak bytes and the SHA-256 of the index's
    offsets and positions."""
    name = "make_ufi_device" if device else "make_ufi"
    smp = Sampler(spill)
    r = run_child(["-make_ufi", fa, "-output", ufi,
                   *(["-device_build"] if device else []),
                   *(["-veryfast"] if veryfast else [])], env,
                  os.path.join(work, f"{name}.log"), smp)
    prep = f"prepared_p{8 if veryfast else 16}"
    smoke.check(r["rc"] == 0, f"{name} exit {r['rc']}: {r['stderr_tail']}")

    def mtime(*p):
        return os.path.getmtime(os.path.join(ufi, *p)) - (
            time.time() - (time.perf_counter() - smp.t0))

    t_saved = mtime("seqdb.npz", "meta.json")
    t_prep = mtime(prep, "meta.json")
    with open(os.path.join(ufi, "seqdb.npz", "meta.json")) as f:
        sdb = json.load(f)
    with open(os.path.join(ufi, prep, "meta.json")) as f:
        pmeta = json.load(f)
    smoke.check(sdb["starts"] == [int(x) for x in starts]
                and sdb["labels"] == labels, "the genome's layout")
    t_hash = time.perf_counter()
    rec = {"phase": name, **r, "veryfast": veryfast,
           "stage_s": {"parse_fasta": smp.t_first,
                       "extract_and_spill": (smp.t_peak or 0)
                       - (smp.t_first or 0),
                       "finalize": (smp.t_gone or 0) - (smp.t_peak or 0),
                       "save_index": t_saved - (smp.t_gone or 0),
                       "prepare_and_save": t_prep - t_saved},
           "spill_peak_bytes": smp.peak, "index_bytes": dir_bytes(ufi),
           "spill_left": os.listdir(spill), "prepared": pmeta,
           "sha256": {a: sha256_of(os.path.join(ufi, f"{a}.npy"))
                      for a in ("offsets", "positions")}}
    rec["hash_s"] = time.perf_counter() - t_hash
    smoke.emit(rec)
    smoke.check(not os.listdir(spill), "the spill directory is not empty")
    return rec


def cli_summary(text: str) -> dict:
    m = re.search(r"([\d,]+) reads, [\d,]+ mapped \(([\d.]+)%\), "
                  r"([\d.]+)s \(([\d,]+) reads/s\)", text)
    smoke.check(m is not None, f"no -map summary in {text[-400:]!r}")
    return {"reads": int(m.group(1).replace(",", "")),
            "mapped_pct": float(m.group(2)), "cli_map_s": float(m.group(3)),
            "cli_reads_per_s": int(m.group(4).replace(",", ""))}


def phase_profile(dev, ufi: str, codes: np.ndarray, smi: str,
                  work: str, every=None) -> dict:
    """A Mapper over the saved prepared tables in this process and one
    batch under torch.profiler; B5's row entry beside its bound. With
    ``every`` (all the single-end reads' codes and their global truth
    positions and strands), map_every first."""
    import torch

    from urmap_tpu_torch.config import VERYFAST_MAP_OVERRIDES, MapConfig
    from urmap_tpu_torch.index import UfiIndex
    from urmap_tpu_torch.index.store import load_prepared, prepare_tables
    from urmap_tpu_torch.kernels import seed_slots
    from urmap_tpu_torch.map import Mapper

    t0 = time.perf_counter()
    index = UfiIndex.load(ufi)
    # the -map of a -veryfast index applies the overrides
    mcfg = MapConfig(batch_size=smoke.B,
                     **(VERYFAST_MAP_OVERRIDES if index.config.veryfast
                        else {}))
    # as the Mapper takes them: the saved tables, or prepared anew where
    # load_prepared finds them stale
    prepared = load_prepared(index, mcfg.positions_per_seed)
    saved = prepared is not None
    if not saved:
        prepared = prepare_tables(index, mcfg.positions_per_seed)
    t1 = time.perf_counter()
    mapper = Mapper(index, mcfg, device=dev, prepared=prepared)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    card_bytes = sum(v.numel() * v.element_size()
                     for v in mapper.tables.values()
                     if isinstance(v, torch.Tensor))
    every_out = (map_every(dev, mapper, index.seqdb, *every, smi)
                 if every is not None else None)
    lens = np.full(len(codes), smoke.READ_LEN, np.int32)
    mapper.map_codes(codes, lens)                         # warm
    pk, nm, ln, _ = mapper.prepack(codes, lens)
    prof = smoke.profile_call(lambda: mapper.finish_batch(
        mapper.start_batch(codes, lens, prepacked=(pk, nm, ln, len(codes))),
        lens), os.path.join(work, "profile_scale.txt"))
    fetch = {k: v for k, v in prof["port_kernels_device_ms"].items()
             if "row128_fetch" in k}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the batch's CSR runs (the seed front, outside the profile): the
    # row entry's bytes are the starts, the used words and the output
    t = mapper.tables
    ob = mapper.off_bits
    _a, _b, _o, _v, start, _c = seed_slots.seed_front(
        put(pk), put(nm), put(ln), mcfg.max_read_len, k=index.config.k,
        q=mcfg.seeds_per_read, slot_bits=index.config.slot_bits,
        offsets=t["offsets"], obase=t.get("obase"),
        cnt_bits=ob[0] if ob else 0, block_bits=ob[1] if ob else 0)
    p = mcfg.positions_per_seed
    s = start.reshape(-1) & 0xFFFF_FFFF
    n = s.shape[0]
    used = int((128 - s % 128).clamp(max=p).sum())
    bound_ms = (n * 8 + used * 4 + n * p * 4) / smoke.HBM_BYTES_PER_S * 1e3
    out = {"phase": "scale_profile", "gpu": smi,
           "veryfast": index.config.veryfast,
           "positions_per_seed": mcfg.positions_per_seed,
           "layout": prepared[1]["layout"], "off_bits": mapper.off_bits,
           "table_words": int(t["positions"].numel()),
           "prepared_from_index_dir": saved, "load_s": t1 - t0,
           "upload_s": t2 - t1, "card_bytes": card_bytes,
           "batch": len(codes), "row128_fetch_in_batch": fetch,
           "row128_fetch_starts": n,
           "row128_fetch_starts_past_2^31": int((s >= TWO31).sum()),
           "row128_fetch_bound_ms": bound_ms, "bound_by": "bytes",
           **{k: prof[k] for k in ("device_busy_ms", "device_launches",
                                   "device_idle_share", "profiled_wall_ms")}}
    smoke.emit(out)
    out["every"] = every_out
    return out


def map_every(dev, mapper, db, codes, tpos, tstrand, smi: str) -> dict:
    """Every single-end read through ``mapper`` in this process, in
    batches of 65,536 (-map's), no CIGAR and no SAM: the map loop's
    reads/s (the first batch, which faults the cold genome pages in,
    apart), the correct fraction (POS and strand as planted) and the ROC
    by MAPQ over the planted reads, the repeat gates' counts
    (chip_smoke.gate_counts) and the reads the SAM writer refuses
    (chip_smoke.c3_prone)."""
    import torch

    from urmap_tpu_torch.map.pipeline import MapResult

    bs = 65_536
    n = len(codes)
    lens = np.full(bs, smoke.READ_LEN, np.int32)
    results, secs, prone = [], [], np.zeros(n, bool)
    with smoke.GateSpy() as spy:
        for s in range(0, n, bs):
            c = codes[s : s + bs]
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            parts = [mapper.finish_batch(mapper.start_batch(
                c[k : k + mapper.mcfg.batch_size],
                lens[k : k + mapper.mcfg.batch_size]),
                lens[k : k + mapper.mcfg.batch_size])
                for k in range(0, len(c), mapper.mcfg.batch_size)]
            secs.append(time.perf_counter() - t)
            for k, r in zip(range(0, len(c), mapper.mcfg.batch_size), parts):
                rows = slice(s + k, s + k + len(r.mapped))
                prone[rows] = smoke.c3_prone(db.codes, codes[rows], r,
                                             mapper.sc)
            results += parts
    fields = ("mapped", "pos", "strand", "score", "second", "mapq",
              "gapped", "ungapped", "clipped", "suspect", "lengths")
    res = MapResult(**{f: np.concatenate([getattr(r, f) for r in results])
                       for f in fields})
    weak, nsat = spy.reads([len(r.mapped) for r in results])
    gates = smoke.gate_counts(res, weak, nsat, mapper.mcfg, mapper.sc)
    planted = tpos >= 0
    ok = res.mapped & (res.pos == tpos) & (res.strand == tstrand)
    out = {"phase": "map_se_library", "gpu": smi, "reads": n,
           "batch": mapper.mcfg.batch_size,
           "positions_per_seed": mapper.mcfg.positions_per_seed,
           "first_65536_s": secs[0],
           "reads_per_s_after_first": (n - bs) / max(sum(secs[1:]), 1e-9),
           "correct_frac": float(ok[planted].mean()),
           "roc": smoke.roc_of(res.mapped[planted], res.mapq[planted],
                               ok[planted], int(planted.sum())),
           "gates": gates, "c3_prone": int(prone.sum()),
           "peak_rss_bytes": smoke.peak_rss_bytes()}
    smoke.emit(out)
    out["prone"] = prone
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gbp", type=float, default=3.1)
    ap.add_argument("--reads", type=int, default=1 << 20)
    ap.add_argument("--pairs", type=int, default=1 << 18)
    ap.add_argument("--spill-dir", default=None)
    ap.add_argument("--work", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device-build", action="store_true",
                    help="build the index on the card first, then on the "
                    "host, and compare the two")
    ap.add_argument("--repeat-frac", type=float, default=0.0,
                    help="plant repeat families over this fraction of the "
                    "genome (tools/accuracy.py's plant_repeat_families)")
    ap.add_argument("--veryfast", action="store_true",
                    help="-make_ufi -veryfast, and -map with "
                    "VERYFAST_MAP_OVERRIDES")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_scale: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    work = args.work or os.path.join(ROOT, "build", "chip_scale")
    marker = os.path.join(work, MARKER)
    if os.path.isdir(work) and os.listdir(work) \
            and not os.path.exists(marker):
        print(f"chip_scale: --work {work} is not empty and not an earlier "
              f"run's (no {MARKER}); refusing to clear it", file=sys.stderr)
        return 2
    spill = args.spill_dir or os.path.join(work, "spill")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    open(marker, "w").close()
    os.makedirs(spill, exist_ok=True)
    smi = smoke.smi_line()
    need = need_disk_bytes(args.gbp)
    free = min(shutil.disk_usage(work).free, shutil.disk_usage(spill).free)
    smoke.emit({"phase": "host", "gpu": smi, "host_cpu": smoke.cpu_model(),
          "nproc": sh(["nproc"]), "free_g": sh(["free", "-g"]),
          "df_work": sh(["df", "-h", work]), "df_spill": sh(["df", "-h", spill]),
          "gbp": args.gbp, "reads": args.reads, "pairs": args.pairs,
          "repeat_frac": args.repeat_frac, "veryfast": args.veryfast,
          "need_disk_bytes": need, "free_disk_bytes": free,
          "torch": torch.__version__})
    if need > free:
        smoke.emit({"phase": "stopped", "reason": "disk", "need": need,
              "free": free})
        return 2

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    fa, (labels, lens, starts), truth, ptruth, codes = make_inputs(
        rng, work, args.gbp, args.reads, args.pairs, args.repeat_frac)
    past_r = starts[truth["chrom"]] + truth["pos"] >= TWO31
    smoke.emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
          "genome_bases": int(lens.sum()), "chromosomes": len(labels),
          "repeat_frac": args.repeat_frac,
          "fasta_bytes": os.path.getsize(fa),
          "chroms_past_2^31": [labels[i] for i in np.nonzero(
              starts >= TWO31)[0]],
          "reads_past_2^31": int(past_r.sum())})

    env = {**os.environ, "TMPDIR": spill,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    ufi = os.path.join(work, "genome.ufi")
    if args.device_build:
        dbuild = make_ufi(fa, ufi, env, work, spill, starts, labels,
                          device=True, veryfast=args.veryfast)
        shutil.rmtree(ufi)
    hbuild = make_ufi(fa, ufi, env, work, spill, starts, labels,
                      veryfast=args.veryfast)
    if args.device_build:
        same = dbuild["sha256"] == hbuild["sha256"]
        smoke.emit({"phase": "device_vs_host_build", "gpu": smi,
                    "equal": same, "wall_s": {"device": dbuild["wall_s"],
                                              "host": hbuild["wall_s"]}})
        smoke.check(same, "the device build's offsets or positions differ "
                    "from the host build's")

    def stopped_by_c3(r: dict, what: str) -> bool:
        """-map's exit: 0, or with --repeat-frac the SAM writer's C.3
        error (recorded; the run goes on); anything else fails."""
        if r["rc"] != 0 and args.repeat_frac > 0 \
                and C3_ERROR in r["stderr_tail"]:
            smoke.emit({"phase": what, "gpu": smi, "rc": r["rc"],
                        "wall_s": r["wall_s"], "stopped_by": "ROADMAP C.3",
                        "error": [ln for ln in r["stderr_tail"].splitlines()
                                  if C3_ERROR in ln][-1]})
            return True
        smoke.check(r["rc"] == 0, f"{what} exit {r['rc']}: "
                    f"{r['stderr_tail']}")
        return False

    def map_se(fq: str, what: str, planted_reads) -> bool:
        """-map of ``fq`` in a process of its own and its record; False
        where -map stopped on C.3."""
        sam = os.path.join(work, "se.sam")
        r = run_child(["-map", fq, "-ufi", ufi, "-samout", sam], env,
                      os.path.join(work, f"{what}.log"))
        if stopped_by_c3(r, what):
            return False
        s = cli_summary(r["stderr_tail"])
        calls = sam_calls(sam, labels)
        ok = correct_of(calls, truth["chrom"], truth["pos"], truth["strand"],
                        np.ones(len(calls["i"]), bool))
        planted = truth["pos"][calls["i"]] >= 0
        past = past_r[calls["i"]]
        smoke.emit({"phase": what, **{k: r[k] for k in (
                        "rc", "wall_s", "peak_rss_bytes")},
              **s, "reads_per_wall_s": s["reads"] / r["wall_s"],
              "correct_frac": float(ok[planted].mean()),
              "correct_frac_past_2^31": float(ok[planted & past].mean()),
              "reads_past_2^31": int((planted & past).sum()),
              "roc": smoke.roc_of(calls["mapped"][planted].astype(bool),
                                  calls["mapq"][planted], ok[planted],
                                  planted_reads)})
        return True

    se_done = map_se(os.path.join(work, "se.fq"), "map_se",
                     int((truth["pos"] >= 0).sum()))

    sam = os.path.join(work, "pe.sam")
    r = run_child(["-map", os.path.join(work, "r1.fq"), "-reverse",
                   os.path.join(work, "r2.fq"), "-ufi", ufi, "-samout", sam],
                  env, os.path.join(work, "map_pe.log"))
    if not stopped_by_c3(r, "map_pe"):
        s = cli_summary(r["stderr_tail"])
        calls = sam_calls(sam, labels)
        first = calls["first"].astype(bool)
        oks, pasts, plants, mapqs, mapped = [], [], [], [], []
        for m, sel in ((1, first), (2, ~first)):
            pos, st = ptruth[f"pos{m}"], ptruth[f"strand{m}"]
            oks.append(correct_of(calls, ptruth["chrom"], pos, st, sel))
            i = calls["i"][sel]
            plants.append(pos[i] >= 0)
            pasts.append(starts[ptruth["chrom"][i]] + pos[i] >= TWO31)
            mapqs.append(calls["mapq"][sel])
            mapped.append(calls["mapped"][sel].astype(bool))
        ok, pl, pa, mq, mp = (np.concatenate(x) for x in (
            oks, plants, pasts, mapqs, mapped))
        smoke.emit({"phase": "map_pe", **{k: r[k] for k in (
                        "rc", "wall_s", "peak_rss_bytes")},
              **s, "reads_per_wall_s": s["reads"] / r["wall_s"],
              "correct_mate_frac": float(ok[pl].mean()),
              "correct_mate_frac_past_2^31": float(ok[pl & pa].mean()),
              "mates_past_2^31": int((pl & pa).sum()),
              "roc_mates": smoke.roc_of(mp[pl], mq[pl], ok[pl],
                                        int(pl.sum()))})

    every = None
    if args.repeat_frac > 0:
        tpos = np.where(truth["pos"] >= 0,
                        starts[truth["chrom"]] + truth["pos"], -1)
        every = (codes, tpos, truth["strand"])
    prof = phase_profile(dev, ufi, codes[:smoke.B], smi, work, every)
    if not se_done:
        # -map again over the reads the SAM writer does not refuse, named
        # as in se.fq
        keep = np.nonzero(~prof["every"]["prone"])[0]
        fq = os.path.join(work, "se_kept.fq")
        write_fastq_named(fq, codes[keep], keep)
        smoke.check(map_se(fq, "map_se_kept",
                           int((truth["pos"][keep] >= 0).sum())),
                    "-map stopped on C.3 over the reads less c3_prone")
    smoke.emit({"phase": "scale_done", "gbp": args.gbp,
          "seconds": time.perf_counter() - t0,
          "table_words": prof["table_words"]})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except smoke.CheckFailed as e:
        print(f"chip_scale: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
