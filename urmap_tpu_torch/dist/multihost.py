"""Multi-process wiring over torch.distributed: process init, per-host
input sharding, the watermarked SAM shard writer and the shard merge,
which the CLI's ``-map`` writes through (``-resume`` restarts from the
last durable batch). A port of urmap_tpu/dist/multihost.py.

Process model: one process (rank) per device. A launcher starts the
ranks (``torchrun --nproc-per-node N python -m urmap_tpu_torch -map
...``) and this module reads its environment: RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT. Where
WORLD_SIZE is not set, the reference's names stand in for it:
JAX_COORDINATOR_ADDRESS (or COORDINATOR_ADDRESS) as host:port,
JAX_NUM_PROCESSES and JAX_PROCESS_ID (local rank = rank there). A
rank's device is ``cuda:{LOCAL_RANK % torch.cuda.device_count()}``
unless the caller asks for the CPU.

Backend, by rule: "nccl" when the ranks map on CUDA and every rank of
the node has a card of its own (device_count() >= LOCAL_WORLD_SIZE);
"gloo" on the CPU and when ranks share a card. Gloo takes CUDA tensors
for every collective the sharded routes run (all-reduce, all-gather,
all-to-all: dist/sharded.py); it copies them through host memory
itself, so nothing here stages a collective. Host barriers run on a
gloo group under either backend. A world of one rank (no launcher)
initialises on an in-process store, so that a one-card mesh runs its
collectives for real.

The functions from ``_align_to_record`` to ``merge_shards`` are the
reference's, copied verbatim (tests/unit/test_torch_copies.py holds them
by text).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass

__all__ = [
    "maybe_init_distributed", "init_distributed", "launch_env",
    "pick_backend", "rank_device", "process_index", "process_count",
    "fastq_byte_ranges", "paired_fastq_byte_ranges", "ShardWriter",
    "merge_shards", "barrier",
]

# the gloo group host barriers run on (the world's under gloo)
_host_group = None


@dataclass
class LaunchEnv:
    rank: int
    world: int
    local_rank: int
    local_world: int
    addr: str | None      # host:port of the rendezvous; None: world of 1


def launch_env() -> LaunchEnv:
    """The launcher's environment (module docstring), or a world of 1.
    SystemExit for a launch that names several processes but not where
    they meet: no rank could join the others."""
    env = os.environ
    if env.get("WORLD_SIZE"):
        world = int(env["WORLD_SIZE"])
        rank = int(env.get("RANK", "0"))
        addr = None
        if world > 1:
            if not env.get("MASTER_PORT"):
                raise SystemExit(
                    f"WORLD_SIZE={world} without MASTER_PORT (and "
                    "MASTER_ADDR, RANK): launch the ranks with torchrun "
                    "--nproc-per-node N, which sets them")
            addr = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                    f"{env['MASTER_PORT']}")
        return LaunchEnv(rank, world, int(env.get("LOCAL_RANK", rank)),
                         int(env.get("LOCAL_WORLD_SIZE", world)), addr)
    addr = env.get("JAX_COORDINATOR_ADDRESS") or env.get(
        "COORDINATOR_ADDRESS")
    if addr:
        if not env.get("JAX_NUM_PROCESSES"):
            raise SystemExit(
                f"coordinator address {addr!r} without JAX_NUM_PROCESSES "
                "(and JAX_PROCESS_ID): set them, or launch the ranks with "
                "torchrun --nproc-per-node N")
        world = int(env["JAX_NUM_PROCESSES"])
        rank = int(env.get("JAX_PROCESS_ID", "0"))
        return LaunchEnv(rank, world, rank, world, addr if world > 1 else None)
    return LaunchEnv(0, 1, 0, 1, None)


def pick_backend(device_type: str, local_world: int) -> str:
    """The backend rule of the module docstring."""
    import torch

    if device_type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def rank_device(device="cuda"):
    """This rank's device: ``cuda`` without an index becomes
    cuda:{LOCAL_RANK % device_count()}; anything else as given. Raises
    without a card (device.require_device)."""
    import torch

    from urmap_tpu_torch.device import require_device

    dev = require_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda",
                           launch_env().local_rank % torch.cuda.device_count())
    return dev


def init_distributed(device="cuda") -> str:
    """Initialise torch.distributed for this rank (idempotent) → the
    backend. A multi-process launch joins its rendezvous; a single
    process forms a world of 1 on an in-process store. Prints the
    backend; under NCCL also forms the gloo group of the host barriers.
    Where the ranks map on CUDA, local rank 0 builds the kernels while
    the others wait at a barrier (one nvcc per source, not one per
    rank)."""
    import torch
    import torch.distributed as dist

    global _host_group
    if dist.is_initialized():
        return dist.get_backend()
    dev = rank_device(device)
    env = launch_env()
    backend = pick_backend(dev.type, env.local_world)
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    if env.addr is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{env.addr}",
                                rank=env.rank, world_size=env.world, **kw)
    _host_group = (dist.new_group(backend="gloo") if backend == "nccl"
                   else dist.group.WORLD)
    print(f"urmap-tpu: rank {env.rank} of {env.world} on {dev}, "
          f"backend {backend}", file=sys.stderr)
    if dev.type == "cuda" and env.world > 1:
        from urmap_tpu_torch.kernels import _build

        if env.local_rank == 0:
            _build.build()
        barrier("kernels-built")
    return backend


def maybe_init_distributed(device="cuda"):
    """init_distributed when the environment launches more than one
    process, a no-op for a single process → this rank's device
    (rank_device)."""
    if launch_env().world > 1:
        init_distributed(device)
    return rank_device(device)


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


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
    """Cross-process barrier on the host group (a no-op for one
    process). ``name`` labels the call site, as in urmap_tpu."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(group=_host_group)
