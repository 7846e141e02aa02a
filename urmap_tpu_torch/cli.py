"""Command-line interface of the port: urmap_tpu/cli.py's flags and
output, on CUDA cards.

    python -m urmap_tpu_torch -make_ufi genome.fa -output genome.ufi
    python -m urmap_tpu_torch -ufistats genome.ufi
    python -m urmap_tpu_torch -map R1.fq -ufi genome.ufi -samout out.sam
    torchrun --nproc-per-node N -m urmap_tpu_torch -map R1.fq \
        -ufi genome.ufi -samout out.sam [-mesh DxI -route a2a|psum]

``-make_ufi`` writes the index directory urmap_tpu writes, byte for
byte, and each package's ``-map`` reads the other's; it builds on the
host, or with ``-device_build`` extracts, hashes and sorts the k-mers on
the card. ``-map`` writes the SAM bytes urmap_tpu writes. ``-map`` and
``-make_ufi -device_build`` run on ``main``'s ``device``, "cuda" unless
a Python caller passes "cpu", and raise without a card.
Launched as N processes (one per card, dist/multihost.py), ``-map``
maps data-parallel: each rank its own byte range of the FASTQ, rank 0
merging the shards. ``-mesh DxI`` (or N, or auto) shards the index
tables over the ranks instead (dist/sharded.py, route ``-route``):
every rank is fed every batch and writes the rows it owns. The wide
second pass (``-secondpass P``) runs on the host CPU, as urmap_tpu runs
it on its host.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from urmap_tpu_torch import __version__
from urmap_tpu_torch.config import IndexConfig, MapConfig
from urmap_tpu_torch.utils import MetricsLogger, Progress, trace

USAGE = """urmap-tpu v{v} — short-read mapper (PyTorch + CUDA port)

Index build:
  python -m urmap_tpu_torch -make_ufi <genome.fa> -output <genome.ufi>
      [-wordlength K] [-slot_bits B] [-maxpos N] [-veryfast]
      [-device_build]  (k-mers sorted on the card instead of the C++
      host build; the same index bytes)

Mapping (on CUDA cards):
  python -m urmap_tpu_torch -map <reads.fq> -ufi <genome.ufi> -samout <out.sam>
  (or torchrun --nproc-per-node N -m urmap_tpu_torch -map ...)
      (.gz input and .sam.gz output supported)
      [-reverse <reads2.fq>] [-threads N] [-batch B] [-maxreadlen L]
      [-inflight D] [-endclip] [-selfcheck] [-log <file>]
      [-metrics <file.jsonl>] [-quiet] [-resume] [-profile <dir>]
      [-secondpass P] [-mesh DxI|N|auto] [-route a2a|psum]

-secondpass P re-maps the unmapped and suspect reads at a gather of P
positions a seed on the host CPU. -resume restarts a run from the last
durable batch watermark. N processes (one per card) map data-parallel
over byte ranges of the input; -mesh DxI shards the index tables over
the D x I ranks (which must be all of them) by slot range, -route picks
how the lookups combine (a2a, the default, or psum); "-mesh auto"
shards over all ranks when the tables pass 0.6 of one card's memory.

Index inspection:
  python -m urmap_tpu_torch -ufistats <genome.ufi>

Other: -version, -help
"""

# flag → has_value (urmap_tpu/cli.py's surface)
_FLAGS = {
    "make_ufi": True, "output": True, "wordlength": True, "slot_bits": True,
    "maxpos": True, "veryfast": False, "device_build": False,
    "ufistats": True,
    "map": True, "ufi": True, "samout": True, "reverse": True,
    "threads": True, "batch": True, "maxreadlen": True, "resume": False,
    "inflight": True, "endclip": False, "selfcheck": False,
    "mesh": True, "route": True, "secondpass": True,
    "log": True, "metrics": True, "quiet": False, "profile": True,
    "version": False, "help": False,
}


def parse_args(argv: list[str]) -> dict:
    opts: dict[str, object] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("-"):
            raise SystemExit(f"unexpected argument {tok!r} (see -help)")
        name = tok.lstrip("-")
        if name not in _FLAGS:
            raise SystemExit(f"unknown option {tok!r} (see -help)")
        if _FLAGS[name]:
            if i + 1 >= len(argv):
                raise SystemExit(f"option {tok} requires a value")
            opts[name] = argv[i + 1]
            i += 2
        else:
            opts[name] = True
            i += 1
    return opts


def cmd_make_ufi(opts: dict, device="cuda") -> int:
    from urmap_tpu_torch.device import require_device
    from urmap_tpu_torch.index import build_index
    from urmap_tpu_torch.io import SeqDB

    # host backend by default, as urmap_tpu's: -device_build sorts the
    # k-mers on ``device`` (the same bytes), checked before any work
    dev = require_device(device) if opts.get("device_build") else None
    fasta = str(opts["make_ufi"])
    out = opts.get("output")
    if not out:
        raise SystemExit("-make_ufi requires -output <index dir>")
    t0 = time.monotonic()
    print(f"urmap-tpu v{__version__}: building index for {fasta}", file=sys.stderr)
    db = SeqDB.from_fasta(fasta)
    kw = {}
    if "wordlength" in opts:
        kw["k"] = int(str(opts["wordlength"]))
    if "slot_bits" in opts:
        kw["slot_bits"] = int(str(opts["slot_bits"]))
    else:
        kw["slot_bits"] = IndexConfig.auto_slot_bits(db.total_len)
        if opts.get("veryfast"):
            # 4x the slot space and a header flag cmd_map reads to
            # narrow the gathers (config.VERYFAST_MAP_OVERRIDES)
            kw["slot_bits"] = min(kw["slot_bits"] + 2, 30)
            kw["veryfast"] = True
    if "maxpos" in opts:
        kw["max_positions_per_slot"] = int(str(opts["maxpos"]))
    cfg = IndexConfig(**kw)
    idx = build_index(db, cfg, backend="host" if dev is None else "device",
                      device=dev)
    idx.save(str(out))
    # map-ready tables beside the raw CSR, so -map loads and goes
    from urmap_tpu_torch.config import VERYFAST_MAP_OVERRIDES
    from urmap_tpu_torch.index.store import save_prepared

    p_map = (VERYFAST_MAP_OVERRIDES["positions_per_seed"]
             if cfg.veryfast else MapConfig.positions_per_seed)
    save_prepared(idx, str(out), p_map)
    el = time.monotonic() - t0
    print(f"indexed {db.total_len:,} bases ({db.num_seqs} seqs) → "
          f"{idx.num_positions:,} positions, 2^{cfg.slot_bits} slots, "
          f"k={cfg.k} in {el:.1f}s", file=sys.stderr)
    return 0


def cmd_ufistats(opts: dict) -> int:
    """Index statistics: size, slot occupancy histogram, repeat load."""
    from urmap_tpu_torch.index import UfiIndex

    index = UfiIndex.load(str(opts["ufistats"]))
    cfg = index.config
    counts = np.diff(index.offsets.astype(np.int64))
    occupied = int((counts > 0).sum())
    print(f"k={cfg.k} slots=2^{cfg.slot_bits} "
          f"cap={cfg.max_positions_per_slot}"
          + (" veryfast" if cfg.veryfast else ""))
    print(f"genome: {index.seqdb.total_len:,} bases, "
          f"{index.seqdb.num_seqs} sequences")
    print(f"positions: {index.num_positions:,} "
          f"({index.num_positions * 4 / 1e6:.1f} MB)")
    print(f"occupied slots: {occupied:,}/{cfg.num_slots:,} "
          f"({100.0 * occupied / cfg.num_slots:.1f}%)")
    print(f"mean load (occupied): {counts.sum() / max(occupied, 1):.2f}  "
          f"max load: {int(counts.max())}")
    print("load histogram:")
    for lo, hi in ((1, 1), (2, 3), (4, 7), (8, 15), (16, 63),
                   (64, 255), (256, 1 << 30)):
        n = int(((counts >= lo) & (counts <= hi)).sum())
        if n:
            label = f"{lo}" if lo == hi else f"{lo}-{hi if hi < 1 << 29 else 'inf'}"
            print(f"  {label:>9}: {n:,}")
    return 0


def _cig3(r):
    """cigars_nm_blob result → ((blob, offsets), nm, span) for the
    native formatter (available() guarantees r is not None)."""
    blob, off, nm, span = r
    return (blob, off), nm, span


def _table_bytes(index) -> int:
    """Approximate prepared-table footprint: positions (4 B) + offsets
    + the 2-bit packed genome planes; the row128 layout's offsets ride
    packed (2 B a slot), so the offsets term halves there."""
    import os

    budget = int(os.environ.get("URMAP_ROW128_BYTES", str(2 << 30)))
    row128 = (index.num_positions * 4 > budget
              and os.environ.get("URMAP_NO_PACKED_OFFSETS") != "1")
    return (index.num_positions * 4
            + index.config.num_slots * (2 if row128 else 4)
            + index.seqdb.total_len // 2)


# Card memory of the map step, measured by chip_smoke.py's cli phase on
# an NVIDIA H100 80GB HBM3 (power limit 700.00 W): the slope of
# torch.cuda.max_memory_allocated() above the tables between batches of
# 16,384 and 65,536 reads, at max_read_len 160 and 704: single-end 4,083
# and 7,359 bytes a read, paired (batch // 2 pairs of two mates) 18,277
# and 108,777, the mate-rescue scan's [lanes, L, window - L] compare
# growing with the block. CUDA_READ_BYTES holds, rounded up, the bytes a
# read at 160 bases and the bytes per base above 160 (below 160 the 160
# figure stands). The margin holds the CUDA context (0.62 GiB) and the
# caching allocator's reserve above its peak allocation (0.54 GiB at
# batch 131,072), rounded up.
CUDA_READ_BYTES = {False: (4_100, 6.1), True: (18_300, 167.0)}
CUDA_MARGIN_BYTES = 3 << 29


def cuda_read_bytes(max_read_len: int, paired: bool) -> int:
    """Card bytes a read of the map step takes (CUDA_READ_BYTES)."""
    a, b = CUDA_READ_BYTES[bool(paired)]
    return int(a + b * max(0, max_read_len - 160))


def _device_mem_bytes(device) -> int:
    """The card's memory: URMAP_DEVICE_MEM_GB (GiB) where set, else what
    the card reports."""
    import os

    if os.environ.get("URMAP_DEVICE_MEM_GB"):
        return int(float(os.environ["URMAP_DEVICE_MEM_GB"]) * 2**30)
    import torch

    return int(torch.cuda.get_device_properties(device).total_memory)


def _auto_batch(opts: dict, index, mcfg, quiet: bool, device=None,
                paired: bool = False):
    """The largest 8192-multiple batch, from mcfg.batch_size down, whose
    map step fits the device's memory next to the tables. On a CUDA
    card: the card's memory less CUDA_MARGIN_BYTES, at CUDA_READ_BYTES a
    read (measured on the H100). On the CPU: urmap_tpu's rule unchanged
    (a 16 GiB part, URMAP_DEVICE_MEM_GB, less 0.9 GiB, at 11,000 bytes a
    read), so a CPU run picks the batch urmap_tpu picks. An explicit
    -batch always wins; callers use the RETURNED config."""
    import os

    if "batch" in opts:
        return mcfg
    if device is not None and device.type == "cuda":
        budget = _device_mem_bytes(device) - CUDA_MARGIN_BYTES
        per_read = cuda_read_bytes(mcfg.max_read_len, paired)
    else:
        budget = ((float(os.environ.get("URMAP_DEVICE_MEM_GB", "16")) - 0.9)
                  * 2**30)
        per_read = 11_000
    tbytes = _table_bytes(index)
    bs = mcfg.batch_size
    while bs > 8192 and tbytes + bs * per_read > budget:
        bs -= 8192
    if bs != mcfg.batch_size:
        import dataclasses

        if not quiet:
            print(f"auto batch {mcfg.batch_size} → {bs}: largest "
                  f"8192-multiple fitting next to {tbytes / 2**30:.1f} "
                  f"GiB of tables (-batch overrides)", file=sys.stderr)
        mcfg = dataclasses.replace(mcfg, batch_size=bs)
    return mcfg


def _make_mapper(opts: dict, index, mcfg, quiet: bool, device,
                 paired: bool = False):
    """The single-device Mapper, or a ShardedMapper when -mesh asks for
    (or "auto" decides on) index sharding over the world's ranks (one
    rank per device: torchrun --nproc-per-node N). A mesh spans the
    world: a rank outside it would own no rows. cmd_map re-reads
    mapper.mcfg (the auto-batch shrink may have replaced it)."""
    import os

    from urmap_tpu_torch.dist import multihost as mh
    from urmap_tpu_torch.map import Mapper

    spec = opts.get("mesh")
    if not spec:
        return Mapper(index, _auto_batch(opts, index, mcfg, quiet, device,
                                         paired), device=device)
    from urmap_tpu_torch.dist.sharded import ShardedMapper, make_mesh

    spec = str(spec)
    world = mh.launch_env().world
    data = index_ax = None            # -mesh N and auto: the default split
    if spec == "auto":
        if device.type == "cuda":
            budget = _device_mem_bytes(device) * 0.6
        else:
            budget = (float(os.environ.get("URMAP_DEVICE_MEM_GB", "16"))
                      * 0.6 * 2**30)
        tbytes = _table_bytes(index)
        if world == 1 or tbytes <= budget:
            if not quiet:
                print(f"-mesh auto: single device "
                      f"({tbytes / 2**30:.1f} GiB tables, {world} ranks)",
                      file=sys.stderr)
            return Mapper(index, _auto_batch(opts, index, mcfg, quiet,
                                             device, paired), device=device)
    else:
        if "x" in spec:
            data, index_ax = (int(t) for t in spec.split("x", 1))
        n = data * index_ax if data else int(spec)
        if n != world:
            raise SystemExit(
                f"-mesh {spec}: a mesh takes one rank per device and spans "
                f"the world, which has {world} rank(s); launch {n} ranks: "
                f"torchrun --nproc-per-node {n} -m urmap_tpu_torch -map ...")
    route = str(opts.get("route", "a2a"))
    if route not in ("a2a", "psum"):
        raise SystemExit(f"-route {route}: a2a or psum")
    mh.init_distributed(device)
    mesh = make_mesh(data=data, index=index_ax)
    if not quiet:
        print(f"sharded mesh: data={mesh.data} x index={mesh.index} ranks, "
              f"route={route}", file=sys.stderr)
    return ShardedMapper(index, mesh, mcfg, route=route, device=device)


def _profile(opts: dict, device):
    """-profile DIR: torch.profiler over the map (CPU activity of every
    thread, with the program's spans, and the card's on CUDA), written
    as a Chrome trace into DIR."""
    import contextlib

    if "profile" not in opts:
        return contextlib.nullcontext()
    import os

    import torch

    out = str(opts["profile"])
    os.makedirs(out, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def save(prof):
        prof.export_chrome_trace(os.path.join(
            out, f"urmap_map_{os.getpid()}.trace.json"))

    return torch.profiler.profile(
        activities=acts, on_trace_ready=save,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))


def cmd_map(opts: dict, device="cuda") -> int:
    from urmap_tpu_torch.dist import multihost as mh

    # one rank per device; the launcher's environment (dist/multihost.py)
    device = mh.maybe_init_distributed(device)

    from urmap_tpu_torch.index import UfiIndex
    from urmap_tpu_torch.io import FastqReader
    from urmap_tpu_torch.io import sam as samio
    from urmap_tpu_torch.io import sam_native
    from urmap_tpu_torch.map.cigar import cigars_for_result, cigars_nm_blob
    from urmap_tpu_torch.map.pipeline import revcomp_strand_codes

    fq = str(opts["map"])
    ufi = opts.get("ufi")
    samout = opts.get("samout")
    if not ufi:
        raise SystemExit("-map requires -ufi <index dir>")
    if not samout:
        raise SystemExit("-map requires -samout <out.sam>")
    reverse = opts.get("reverse")
    quiet = bool(opts.get("quiet"))

    mkw = {}
    if "batch" in opts:
        mkw["batch_size"] = int(str(opts["batch"]))
    else:
        # urmap_tpu's production default; the auto-fit in _make_mapper
        # steps down in 8192-multiples where the card has no headroom
        mkw["batch_size"] = 65536
    if "maxreadlen" in opts:
        mkw["max_read_len"] = int(str(opts["maxreadlen"]))
    if opts.get("endclip"):
        mkw["end_clip"] = True
    if "secondpass" in opts:
        # host-CPU wide-gather recovery (MapConfig.second_pass_p)
        mkw["second_pass_p"] = int(str(opts["secondpass"]))

    t0 = time.monotonic()
    index = UfiIndex.load(str(ufi))
    if index.config.veryfast:
        # -veryfast index: narrower gathers reach the same loci
        # (config.VERYFAST_MAP_OVERRIDES); explicit flags still win
        from urmap_tpu_torch.config import VERYFAST_MAP_OVERRIDES

        for k_, v_ in VERYFAST_MAP_OVERRIDES.items():
            mkw.setdefault(k_, v_)
    mcfg = MapConfig(**mkw)
    if not quiet:
        print(f"urmap-tpu v{__version__}: loaded index "
              f"({index.num_positions:,} positions, k={index.config.k}) "
              f"in {time.monotonic() - t0:.1f}s", file=sys.stderr)

    mapper = _make_mapper(opts, index, mcfg, quiet, device,
                          paired=bool(reverse))
    mcfg = mapper.mcfg   # the auto-batch shrink may have replaced it
    from urmap_tpu_torch.dist.sharded import (ShardedMapper,
                                              ShardedPairedMapper)

    rank, nproc = mh.process_index(), mh.process_count()
    # a mesh over several ranks: replicated feeding, each rank writes the
    # rows it owns (ShardedMapper.finish_batch_local)
    mesh_local_rows = isinstance(mapper, ShardedMapper) and nproc > 1
    metrics = MetricsLogger(str(opts["metrics"]) if "metrics" in opts else None)
    # -profile and -metrics turn the program's spans and counters on: the
    # trace shows them, and each metrics line gets its batch's totals
    traced = "profile" in opts or "metrics" in opts
    batch_totals = trace.BatchTotals() if traced else None
    progress = Progress("reads") if not quiet else None
    cmdline = "urmap-tpu " + " ".join(sys.argv[1:])
    resume = bool(opts.get("resume"))

    genome = index.seqdb.codes
    selfcheck = bool(opts.get("selfcheck"))

    def _selfcheck_batch(codes, res):
        """Consistency audit: re-derive a sample of M-only calls on the
        host genome and compare with the device's ungapped scores.
        (Gapped calls are audited on every batch: the traceback asserts
        score equality.)"""
        from urmap_tpu_torch.map.cigar import strand_codes_subset

        rows = np.nonzero(res.mapped & ~res.gapped)[0][:8]
        if rows.size == 0:
            return
        sub = strand_codes_subset(codes[rows],
                                  np.asarray(res.strand)[rows],
                                  np.asarray(res.lengths)[rows])
        for k, i in enumerate(rows):
            li = int(res.lengths[i])
            seg = genome[int(res.pos[i]) : int(res.pos[i]) + li]
            mm = int(np.sum(seg != sub[k][:li]))
            want = ((li - mm) * mapper.sc.match
                    + mm * mapper.sc.mismatch)
            got = int(res.ungapped[i])
            if got != want:
                raise AssertionError(
                    f"selfcheck: device ungapped {got} != host {want} "
                    f"(read row {i}, pos {int(res.pos[i])})")
    t_map0 = time.monotonic()
    writer = mh.ShardWriter(str(samout), rank, resume=resume)
    if writer.skip_batches and not quiet:
        print(f"resuming: shard {rank} already has "
              f"{writer.skip_batches} batches ({writer.wm.reads:,} reads)",
              file=sys.stderr)
    from urmap_tpu_torch.io.fastq import PrefetchIterator

    # data-parallel ranks: uncompressed inputs split into record-aligned
    # byte ranges, so each rank parses only its own slice (paired files
    # cut at the same records); gzip, or a mate cut that cannot be
    # located, falls back to round-robin batches
    byte_range = rev_byte_range = None
    if nproc > 1 and not mesh_local_rows and not str(fq).endswith(".gz"):
        if reverse and not str(reverse).endswith(".gz"):
            pr = mh.paired_fastq_byte_ranges(fq, str(reverse), nproc)
            if pr is not None:
                byte_range, rev_byte_range = pr[0][rank], pr[1][rank]
        elif not reverse:
            byte_range = mh.fastq_byte_ranges(fq, nproc)[rank]
    # paired mode: half the pairs per batch (PairedMapper docstring)
    reader = FastqReader(fq, str(reverse) if reverse else None,
                         batch_size=(mcfg.batch_size // 2 if reverse
                                     else mcfg.batch_size),
                         max_read_len=mcfg.max_read_len,
                         byte_range=byte_range,
                         reverse_byte_range=rev_byte_range)
    native = reader.native and sam_native.available()
    # -threads N: host worker threads of the drain pool; 0 = synchronous
    # (no prefetch, no pool)
    n_threads = int(str(opts.get("threads", 2)))
    pmapper = None
    if reader.paired:
        from urmap_tpu_torch.map.pair import PairedMapper

        pmapper = (ShardedPairedMapper(mapper)
                   if isinstance(mapper, ShardedMapper)
                   else PairedMapper(mapper))

    # upload prep (pad + 2-bit pack) on the prefetch thread: the
    # dispatch thread is the critical path
    def _prepack(item):
        if pmapper is not None:
            fwd, rev = item
            return item, pmapper.prepack(fwd.codes, fwd.lengths,
                                         rev.codes, rev.lengths)
        return item, mapper.prepack(item.codes, item.lengths)

    batches = (PrefetchIterator(reader, transform=_prepack)
               if n_threads != 0 else ((it, None) for it in reader))

    def start_one(entry):
        """Queue one batch (or pair batch) on the device."""
        item, pk = entry
        if pmapper is not None:
            fwd, rev = item
            return pmapper.start_batch(fwd.codes, fwd.lengths,
                                       rev.codes, rev.lengths,
                                       prepacked=pk)
        return mapper.start_batch(item.codes, item.lengths, prepacked=pk)

    def sync_one(entry, handle):
        """Block until one batch's results are on the host; on a mesh
        of several ranks only this rank's rows, as (result, global row
        indices)."""
        item = entry[0]
        if pmapper is not None:
            fwd, rev = item
            if mesh_local_rows:
                return pmapper.finish_batch_local(handle, fwd.lengths,
                                                  rev.lengths)
            return pmapper.finish_batch(handle, fwd.lengths, rev.lengths)
        if mesh_local_rows:
            return mapper.finish_batch_local(handle, item.lengths)
        return mapper.finish_batch(handle, item.lengths)

    def format_one(entry, res):
        """Host formatting (CPU only) → (SAM bytes, stats), in the
        worker pool; the wide second pass rides here too, beside the
        next device batch."""
        item = entry[0]
        if mesh_local_rows:
            res, rows = res
            if pmapper is not None:
                fwd, rev = item
                item = (fwd.take(rows), rev.take(rows))
            else:
                item = item.take(rows)
        if pmapper is not None:
            fwd, rev = item
            res = pmapper.second_pass(fwd.codes, fwd.lengths, rev.codes,
                                      rev.lengths, res)
            if selfcheck:
                _selfcheck_batch(fwd.codes, res.m1)
                _selfcheck_batch(rev.codes, res.m2)
            stats = {"reads": 2 * len(fwd),
                     "mapped": int(res.m1.mapped.sum())
                     + int(res.m2.mapped.sum()),
                     "proper_pairs": int(res.proper.sum()),
                     "gapped": int(res.m1.gapped.sum())
                     + int(res.m2.gapped.sum()),
                     "batch": trace.batch_of(res)}
            if native:
                c1, e1, sp1 = _cig3(cigars_nm_blob(
                    genome, fwd.codes, res.m1, mapper.sc,
                    raw_lengths=fwd.seq_len, clip_rows=res.m1.clipped))
                c2, e2, sp2 = _cig3(cigars_nm_blob(
                    genome, rev.codes, res.m2, mapper.sc,
                    raw_lengths=rev.seq_len, clip_rows=res.m2.clipped))
                data = sam_native.format_paired(
                    fwd, rev, res, c1, e1, sp1, c2, e2, sp2, index.seqdb)
            else:
                recs = pmapper.format_py(fwd, rev, res)
                data = ("\n".join(recs) + "\n").encode("ascii")
            return data, stats
        batch = item
        res = mapper.second_pass(batch.codes, batch.lengths, res)
        if selfcheck:
            _selfcheck_batch(batch.codes, res)
        stats = {"reads": len(batch), "mapped": int(res.mapped.sum()),
                 "gapped": int(res.gapped.sum()),
                 "mapq_ge20": int((res.mapq >= 20).sum()),
                 "batch": trace.batch_of(res)}
        if native:
            cig, nm, _span = _cig3(cigars_nm_blob(
                genome, batch.codes, res, mapper.sc,
                raw_lengths=batch.seq_len, clip_rows=res.clipped))
            data = sam_native.format_single_end(batch, res, cig, nm,
                                                index.seqdb)
        else:
            strand_codes = revcomp_strand_codes(batch.codes, res)
            cigars, nms = cigars_for_result(
                genome, strand_codes, res, mapper.sc,
                raw_lengths=[len(sq) for sq in batch.seqs],
                clip_open=res.clip_open, clip_rows=res.clipped)
            recs = samio.records_single_end(batch, res, cigars, nms,
                                            index.seqdb)
            data = ("\n".join(recs) + "\n").encode("ascii")
        return data, stats

    state = {"reads": 0, "mapped": 0}

    def write_one(out):
        data, stats = out
        batch = stats.pop("batch")
        if batch_totals is not None:
            stats.update(batch_totals.take(batch))
        writer.append_batch(data, stats["reads"])
        state["reads"] += stats["reads"]
        state["mapped"] += stats["mapped"]
        if progress:
            progress.update(stats["reads"])
        metrics.log(**stats)

    def my_batches():
        my_no = 0
        for batch_no, item in enumerate(batches):
            if byte_range is None and nproc > 1 and not mesh_local_rows \
                    and batch_no % nproc != rank:
                continue   # round-robin fallback (gzip / paired input)
            my_no += 1
            if my_no <= writer.skip_batches:
                continue
            yield item

    # pipelined drain: the device maps batch i+1 while the workers
    # format batch i and the writer commits batch i-1 (utils/stream.py)
    from urmap_tpu_torch.utils.stream import run_stream

    inflight = int(str(opts.get("inflight", 2)))
    if traced:
        trace.enable()
    try:
        with _profile(opts, device):
            run_stream(my_batches(), start_one, sync_one, format_one,
                       write_one, inflight=inflight, workers=n_threads)
    finally:
        if traced:
            trace.disable()
            trace.drain()
    n_reads, n_mapped = state["reads"], state["mapped"]
    writer.close()

    mh.barrier("map-done")
    if rank == 0:
        mh.merge_shards(str(samout), nproc,
                        samio.sam_header(index.seqdb, cmdline).encode("ascii"))
    mh.barrier("merge-done")

    el = time.monotonic() - t_map0
    pct = 100.0 * n_mapped / max(n_reads, 1)
    if progress:
        progress.done()
    summary = (f"{n_reads:,} reads, {n_mapped:,} mapped ({pct:.2f}%), "
               f"{el:.1f}s ({n_reads / max(el, 1e-9):,.0f} reads/s)")
    print(summary, file=sys.stderr)
    if "log" in opts:
        with open(str(opts["log"]), "a") as lf:
            lf.write(f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] "
                     f"{cmdline}\n{summary}\n")
    metrics.close()
    return 0


def main(argv: list[str] | None = None, *, device="cuda") -> int:
    """Run one command. ``device`` is where -map maps and where
    -make_ufi -device_build sorts: the CUDA card unless the caller asks
    for "cpu" (the tests do); without a card they raise
    (device.require_device). -make_ufi without -device_build and
    -ufistats touch no device."""
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts.get("help") or not opts:
        print(USAGE.format(v=__version__))
        return 0
    if opts.get("version"):
        print(f"urmap-tpu v{__version__}")
        return 0
    if "make_ufi" in opts:
        return cmd_make_ufi(opts, device)
    if "ufistats" in opts:
        return cmd_ufistats(opts)
    if "map" in opts:
        return cmd_map(opts, device)
    raise SystemExit("nothing to do: need -make_ufi or -map (see -help)")
