"""GRCh38-scale run of urmap_tpu_torch on one CUDA card: a synthetic
genome of GRCh38's size through the command line, as a sequencing
pipeline runs it, and what each stage costs.

    python3 chip_scale.py --gbp 3.1 [--reads 1048576] [--pairs 262144]
                          [--spill-dir DIR] [--work DIR] [--seed 0]
                          [--device-build]

1. the host: free -g, df -h of the work and spill directories, nproc,
   the card's name and power limit; the disk the run needs, estimated,
   against what is free (exit 2 before any work when it does not fit);
2. genome: 24 chromosomes with GRCh38's lengths (chr1-22, X, Y) scaled
   to --gbp, each from chip_smoke.make_genome (random bases, a leading N
   run and six interior ones), written as FASTA; planted reads (phase
   4's mix) and FR pairs (phase 7's mix), 80% of them in the chromosomes
   that lie past global position 2^31, written as FASTQ;
3. make_ufi: `python -m urmap_tpu_torch -make_ufi` in a process of its
   own, auto slot_bits (30 for a human genome), the disk radix spill
   under --spill-dir (its TMPDIR): seconds by stage (from the spill
   directory's life and the index files' times), the spill's peak bytes
   on disk, the process's peak RSS, the index directory's bytes, the
   SHA-256 of its offsets.npy and positions.npy; with --device-build
   first `-make_ufi -device_build` (k-mers extracted, hashed and sorted
   on the card in chunks of DEFAULT_CHUNK words, slot-sorted into the
   spill) with the same figures, its index removed before the host
   build, whose hashes must equal it;
4. map: `python -m urmap_tpu_torch -map` single-end and with -reverse,
   each in a process of its own, so the process start, the index load
   and the table upload are in the wall time: reads/s of the map loop
   (the CLI's summary) and over the wall, peak RSS, the correct
   fraction from the SAM (POS and strand of the planted read), in all
   and past 2^31;
5. profile: in this process a Mapper over the index's prepared tables
   (the card bytes they take, the upload's seconds) and one batch under
   torch.profiler: kernel B5's row entry (launches, device ms a launch)
   beside its bound from this batch's starts (the seed front's CSR
   runs), at a positions table past 2^31 words.

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


def make_inputs(rng, work: str, gbp: float, n_reads: int, n_pairs: int):
    """FASTA, FASTQ and the truth (chromosome, 0-based local start,
    strand) of every read and mate."""
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
    with open(fa, "wb") as f:
        for c, (lab, n) in enumerate(zip(labels, lens)):
            g = smoke.make_genome(rng, int(n))
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
    return fa, (labels, lens, starts), truth, ptruth, codes[:16384]


def sam_calls(path: str, labels: list) -> dict:
    """Per record: read index, first mate, mapped, chromosome, 0-based
    local start less the leading soft clip, strand."""
    lab = {x.encode(): i for i, x in enumerate(labels)}
    cols = {k: [] for k in ("i", "first", "mapped", "chrom", "pos",
                            "strand")}
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
    return {k: np.asarray(v) for k, v in cols.items()}


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
             labels: list, device: bool = False) -> dict:
    """`-make_ufi` (with -device_build when ``device``) in a process of
    its own: its record, printed, with the stage seconds, the spill's
    peak bytes and the SHA-256 of the index's offsets and positions."""
    name = "make_ufi_device" if device else "make_ufi"
    smp = Sampler(spill)
    r = run_child(["-make_ufi", fa, "-output", ufi,
                   *(["-device_build"] if device else [])], env,
                  os.path.join(work, f"{name}.log"), smp)
    smoke.check(r["rc"] == 0, f"{name} exit {r['rc']}: {r['stderr_tail']}")

    def mtime(*p):
        return os.path.getmtime(os.path.join(ufi, *p)) - (
            time.time() - (time.perf_counter() - smp.t0))

    t_saved = mtime("seqdb.npz", "meta.json")
    t_prep = mtime("prepared_p16", "meta.json")
    with open(os.path.join(ufi, "seqdb.npz", "meta.json")) as f:
        sdb = json.load(f)
    with open(os.path.join(ufi, "prepared_p16", "meta.json")) as f:
        pmeta = json.load(f)
    smoke.check(sdb["starts"] == [int(x) for x in starts]
                and sdb["labels"] == labels, "the genome's layout")
    t_hash = time.perf_counter()
    rec = {"phase": name, **r,
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
                  work: str) -> dict:
    """A Mapper over the saved prepared tables in this process and one
    batch under torch.profiler; B5's row entry beside its bound."""
    import torch

    from urmap_tpu_torch.index import UfiIndex
    from urmap_tpu_torch.index.store import load_prepared, prepare_tables
    from urmap_tpu_torch.kernels import seed_slots
    from urmap_tpu_torch.config import MapConfig
    from urmap_tpu_torch.map import Mapper

    t0 = time.perf_counter()
    index = UfiIndex.load(ufi)
    mcfg = MapConfig(batch_size=smoke.B)
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
          "need_disk_bytes": need, "free_disk_bytes": free,
          "torch": torch.__version__})
    if need > free:
        smoke.emit({"phase": "stopped", "reason": "disk", "need": need,
              "free": free})
        return 2

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    fa, (labels, lens, starts), truth, ptruth, head = make_inputs(
        rng, work, args.gbp, args.reads, args.pairs)
    past_r = starts[truth["chrom"]] + truth["pos"] >= TWO31
    smoke.emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
          "genome_bases": int(lens.sum()), "chromosomes": len(labels),
          "fasta_bytes": os.path.getsize(fa),
          "chroms_past_2^31": [labels[i] for i in np.nonzero(
              starts >= TWO31)[0]],
          "reads_past_2^31": int(past_r.sum())})

    env = {**os.environ, "TMPDIR": spill,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    ufi = os.path.join(work, "genome.ufi")
    if args.device_build:
        dbuild = make_ufi(fa, ufi, env, work, spill, starts, labels,
                          device=True)
        shutil.rmtree(ufi)
    hbuild = make_ufi(fa, ufi, env, work, spill, starts, labels)
    if args.device_build:
        same = dbuild["sha256"] == hbuild["sha256"]
        smoke.emit({"phase": "device_vs_host_build", "gpu": smi,
                    "equal": same, "wall_s": {"device": dbuild["wall_s"],
                                              "host": hbuild["wall_s"]}})
        smoke.check(same, "the device build's offsets or positions differ "
                    "from the host build's")

    sam = os.path.join(work, "se.sam")
    r = run_child(["-map", os.path.join(work, "se.fq"), "-ufi", ufi,
                   "-samout", sam], env, os.path.join(work, "map_se.log"))
    smoke.check(r["rc"] == 0, f"-map exit {r['rc']}: {r['stderr_tail']}")
    s = cli_summary(r["stderr_tail"])
    calls = sam_calls(sam, labels)
    ok = correct_of(calls, truth["chrom"], truth["pos"], truth["strand"],
                    np.ones(len(calls["i"]), bool))
    planted = truth["pos"][calls["i"]] >= 0
    past = past_r[calls["i"]]
    smoke.emit({"phase": "map_se", **{k: r[k] for k in ("rc", "wall_s",
                                                   "peak_rss_bytes")},
          **s, "reads_per_wall_s": s["reads"] / r["wall_s"],
          "correct_frac": float(ok[planted].mean()),
          "correct_frac_past_2^31": float(ok[planted & past].mean()),
          "reads_past_2^31": int((planted & past).sum())})

    sam = os.path.join(work, "pe.sam")
    r = run_child(["-map", os.path.join(work, "r1.fq"), "-reverse",
                   os.path.join(work, "r2.fq"), "-ufi", ufi, "-samout", sam],
                  env, os.path.join(work, "map_pe.log"))
    smoke.check(r["rc"] == 0, f"-map -reverse exit {r['rc']}: "
                f"{r['stderr_tail']}")
    s = cli_summary(r["stderr_tail"])
    calls = sam_calls(sam, labels)
    first = calls["first"].astype(bool)
    oks, pasts, plants = [], [], []
    for m, sel in ((1, first), (2, ~first)):
        pos, st = ptruth[f"pos{m}"], ptruth[f"strand{m}"]
        oks.append(correct_of(calls, ptruth["chrom"], pos, st, sel))
        i = calls["i"][sel]
        plants.append(pos[i] >= 0)
        pasts.append(starts[ptruth["chrom"][i]] + pos[i] >= TWO31)
    ok, pl, pa = (np.concatenate(x) for x in (oks, plants, pasts))
    smoke.emit({"phase": "map_pe", **{k: r[k] for k in ("rc", "wall_s",
                                                   "peak_rss_bytes")},
          **s, "reads_per_wall_s": s["reads"] / r["wall_s"],
          "correct_mate_frac": float(ok[pl].mean()),
          "correct_mate_frac_past_2^31": float(ok[pl & pa].mean()),
          "mates_past_2^31": int((pl & pa).sum())})

    prof = phase_profile(dev, ufi, head, smi, work)
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
