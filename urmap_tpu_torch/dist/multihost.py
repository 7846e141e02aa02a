"""Single-process part of urmap_tpu/dist/multihost.py: per-host input
sharding, the watermarked SAM shard writer and the shard merge, which
the CLI's ``-map`` writes through (``-resume`` restarts from the last
durable batch), on one process.

The functions from ``_align_to_record`` to ``merge_shards`` are the
reference's, copied verbatim (tests/unit/test_torch_copies.py holds them
by text). Multi-process runs are not ported (ROADMAP.md A.10): this
process is rank 0 of 1, ``barrier`` does nothing, and
``maybe_init_distributed`` refuses an environment that launches more
than one process, so that no rank quietly writes the whole output as
rank 0 of 1.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

__all__ = [
    "maybe_init_distributed", "process_index", "process_count",
    "fastq_byte_ranges", "paired_fastq_byte_ranges", "ShardWriter",
    "merge_shards", "barrier",
]


def maybe_init_distributed() -> None:
    """SystemExit when the environment asks for a multi-process job: a
    coordinator address (JAX_COORDINATOR_ADDRESS or COORDINATOR_ADDRESS,
    as urmap_tpu reads them) or torch's WORLD_SIZE above 1. Otherwise a
    no-op: the run is one process."""
    addr = (os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("COORDINATOR_ADDRESS"))
    world = int(os.environ.get("WORLD_SIZE", "1") or "1")
    if addr or world > 1:
        why = (f"coordinator address {addr!r}" if addr
               else f"WORLD_SIZE={world}")
        raise SystemExit(
            f"multi-process mapping ({why}) is not ported (ROADMAP.md "
            "A.10): run one process per input, or urmap_tpu")


def process_index() -> int:
    return 0


def process_count() -> int:
    return 1


def _align_to_record(f, pos: int, limit: int) -> int:
    """Scan forward from byte ``pos`` to the start of a FASTQ record.

    A line starting with '@' is a header (not a quality line) iff the
    line after its next line starts with '+'. Quality lines can also
    start with '@', so the 4-line phase must be confirmed structurally.
    """
    if pos == 0:
        return 0
    f.seek(pos)
    f.readline()  # discard partial line
    while True:
        start = f.tell()
        if start >= limit:
            return limit
        l1 = f.readline()
        if not l1:
            return start
        if l1.startswith(b"@"):
            f.readline()
            l3 = f.readline()
            if l3.startswith(b"+"):
                return start
            f.seek(start)
            f.readline()


def fastq_byte_ranges(path: str, n: int) -> list[tuple[int, int]]:
    """Split a (plain, uncompressed) FASTQ into n record-aligned byte
    ranges. Gzip inputs can't be range-split — caller shards by file or
    round-robin batch instead."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        cuts = [0]
        for i in range(1, n):
            cuts.append(_align_to_record(f, i * size // n, size))
        cuts.append(size)
    # monotonicity (tiny files may collapse ranges to empty)
    for i in range(1, len(cuts)):
        cuts[i] = max(cuts[i], cuts[i - 1])
    return [(cuts[i], cuts[i + 1]) for i in range(n)]


def _norm_name(hdr_line: bytes) -> bytes:
    """QNAME from a '@...' header line, matching the readers' semantics:
    first whitespace token, '/1' '/2' pair suffix stripped."""
    name = hdr_line[1:].split()[0] if hdr_line.startswith(b"@") else b""
    if len(name) > 2 and name[-2:-1] == b"/" and name[-1:] in b"12":
        name = name[:-2]
    return name


def _find_record_by_name(f, name: bytes, approx: int, size: int) -> int | None:
    """Byte offset of the record whose (normalized) QNAME is ``name``,
    searched in expanding windows around ``approx``. Records are walked
    4-line from a structurally aligned boundary, so quality lines that
    start with '@' can't confuse the match."""
    for w in (1 << 22, 1 << 25, 1 << 28):
        lo = max(approx - w, 0)
        hi = min(approx + w, size)
        start = _align_to_record(f, lo, size)
        f.seek(start)
        while start < hi:
            hdr = f.readline()
            if not hdr:
                break
            if _norm_name(hdr) == name:
                return start
            f.readline(); f.readline(); f.readline()
            start = f.tell()
        if lo == 0 and hi == size:
            break
    return None


def paired_fastq_byte_ranges(path1: str, path2: str, n: int):
    """Split two synchronized paired FASTQ files into n byte-range pairs
    that cut BOTH files at the SAME records, so each host can parse only
    its own slice of each file (the reference parses everything on its
    one node; multi-host feeding is ours alone).

    File 1 is cut at record-aligned fractions; each cut's mate record in
    file 2 is located by QNAME near the proportional byte offset (mates
    carry equal names modulo a '/1' '/2' suffix — the same normalization
    the readers' desync guard uses, which also backstops any mismatch at
    map time). Returns (ranges1, ranges2) or None when a mate record
    cannot be located (caller falls back to round-robin batches).
    Uncompressed files only."""
    size1 = os.path.getsize(path1)
    size2 = os.path.getsize(path2)
    ranges1 = fastq_byte_ranges(path1, n)
    cuts2 = [0]
    with open(path1, "rb") as f1, open(path2, "rb") as f2:
        for i in range(1, n):
            c1 = ranges1[i][0]
            if c1 >= size1:          # collapsed (tiny-file) trailing range
                cuts2.append(size2)
                continue
            f1.seek(c1)
            name = _norm_name(f1.readline())
            if not name:
                return None
            c2 = _find_record_by_name(
                f2, name, c1 * size2 // max(size1, 1), size2)
            if c2 is None:
                return None
            cuts2.append(c2)
    cuts2.append(size2)
    for i in range(1, len(cuts2)):
        if cuts2[i] < cuts2[i - 1]:
            return None              # out-of-order names near a cut
    ranges2 = [(cuts2[i], cuts2[i + 1]) for i in range(n)]
    return ranges1, ranges2


@dataclass
class Watermark:
    batches: int = 0
    bytes_out: int = 0
    reads: int = 0

    def to_json(self) -> str:
        return json.dumps({"batches": self.batches,
                           "bytes_out": self.bytes_out,
                           "reads": self.reads})


class ShardWriter:
    """Append-only per-host SAM shard with a durable batch watermark.

    Layout: ``<out>.shard<rank>`` + ``<out>.shard<rank>.wm`` (one JSON
    line, rewritten after each batch). On resume, the shard is truncated
    to the last committed byte offset and ``batches`` tells the caller
    how many input batches to skip.
    """

    def __init__(self, out_path: str, rank: int, resume: bool = False):
        self.path = f"{out_path}.shard{rank}"
        self.wm_path = self.path + ".wm"
        self.wm = Watermark()
        mode = "r+b" if (resume and os.path.exists(self.path)) else "wb"
        if mode == "r+b" and os.path.exists(self.wm_path):
            with open(self.wm_path) as f:
                d = json.load(f)
            self.wm = Watermark(**d)
            self._f = open(self.path, "r+b")
            self._f.truncate(self.wm.bytes_out)
            self._f.seek(self.wm.bytes_out)
        else:
            self._f = open(self.path, "wb")
        self.skip_batches = self.wm.batches

    def append_batch(self, data: bytes, n_reads: int) -> None:
        self._f.write(data)
        self._f.flush()
        os.fsync(self._f.fileno())
        self.wm.batches += 1
        self.wm.bytes_out += len(data)
        self.wm.reads += n_reads
        tmp = self.wm_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.wm.to_json())
        os.replace(tmp, self.wm_path)

    def close(self) -> None:
        self._f.close()


def merge_shards(out_path: str, n_shards: int, header: bytes,
                 cleanup: bool = True) -> None:
    """Rank-ordered concatenation of shard files into the final SAM.

    A ``.gz`` suffix on out_path gzip-compresses the merged output
    (BGZF-free plain gzip — readable by samtools/zcat; shards stay raw
    so the resume watermark math is unchanged)."""
    if out_path.endswith(".gz"):
        import gzip

        out_ctx = gzip.open(out_path, "wb", compresslevel=4)
    else:
        out_ctx = open(out_path, "wb")
    with out_ctx as out:
        out.write(header)
        for r in range(n_shards):
            shard = f"{out_path}.shard{r}"
            with open(shard, "rb") as f:
                while True:
                    chunk = f.read(1 << 24)
                    if not chunk:
                        break
                    out.write(chunk)
            if cleanup:
                os.remove(shard)
                wm = shard + ".wm"
                if os.path.exists(wm):
                    os.remove(wm)


def barrier(name: str = "urmap") -> None:
    """Cross-process barrier: a no-op, the run is one process."""
