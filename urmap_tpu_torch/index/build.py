"""UFI index build: k-mer extract → hash → sort → cap → CSR.

Both backends of urmap_tpu/index/build.py, with the same tables bit for
bit:

- ``backend="device"`` (the default, as the reference's): each chunk
  of word starts is extracted, hashed and sorted by (slot, position) on
  a torch device (``torch.sort``, as the reference sorts with
  ``jax.lax.sort`` outside any Pallas kernel), the card unless the
  caller asks for the CPU; the host merges the sorted runs, or streams
  them into the spill;
- ``backend="host"`` (what the command line takes unless
  ``-device_build``): the multithreaded C++ extract/partition and radix
  sort of the io.native codecs, with the bit-identical numpy twins when
  the native library is missing or URMAP_NO_NATIVE_BUILD=1.

Genomes above ``spill_threshold`` words (GRCh38 scale: ~3.1G words)
stream through the disk radix spill (``_RadixSpill``): chunks of
(slot << 32 | pos) keys partitioned by the slot's high bits into 256
bucket files, then each bucket sorted, capped and laid out in order, so
peak RAM is one bucket plus the final tables. The output is
bit-identical to the in-RAM build. ``_RadixSpill`` is copied verbatim
(tests/unit/test_torch_copies.py holds it by text); the device backend
feeds it slot-sorted chunks (``add(sorted_by_slot=True)``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from urmap_tpu_torch.config import IndexConfig
from urmap_tpu_torch.device import require_device
from urmap_tpu_torch.hashing import extract_words, words_to_slots
from urmap_tpu_torch.io.fasta import SeqDB
from urmap_tpu_torch.index.store import UfiIndex, evenly_cap_runs

# Max genome positions sorted in one device call (chunking unit). 64M
# (slot,pos) pairs = 512 MB of sort traffic — comfortable in 16 GB HBM.
DEFAULT_CHUNK = 64 * 1024 * 1024
# Words one chunk of the host spill build extracts: urmap_tpu's host
# backend takes max(DEFAULT_CHUNK, 2^27), which is 2^27.
HOST_CHUNK = 1 << 27
# Above this many words the build streams through the disk radix spill.
SPILL_THRESHOLD = 256 * 1024 * 1024

_P_U64 = ctypes.POINTER(ctypes.c_uint64)


# urmap_tpu/index/build.py:_native_lib
def _native_lib():
    """The C++ build kernels, or None → bit-identical numpy twins."""
    if os.environ.get("URMAP_NO_NATIVE_BUILD"):
        return None
    from urmap_tpu_torch.io import native

    return native.lib()


# urmap_tpu/index/build.py:_native_extract_partition
def _native_extract_partition(L, codes: np.ndarray, base_pos: int, k: int,
                              slot_bits: int, radix_bits: int):
    """C++ extract+hash+partition: codes → (keys uint64[(slot<<32)|pos]
    partitioned by slot high bits, per-bucket counts)."""
    from urmap_tpu_torch.io import native
    from urmap_tpu_torch.utils.bigmem import big_empty

    codes = np.ascontiguousarray(codes)
    n_words = codes.shape[0] - k + 1
    keys = big_empty(n_words, np.uint64)
    counts = np.zeros(1 << radix_bits, np.int64)
    tot = L.urmap_extract_partition(
        codes.ctypes.data_as(native.p_u8), codes.shape[0], base_pos, k,
        slot_bits, slot_bits - radix_bits, os.cpu_count() or 4,
        keys.ctypes.data_as(_P_U64), counts.ctypes.data_as(native.p_i64))
    if tot < 0:
        raise MemoryError("urmap_extract_partition failed")
    return keys[:tot], counts


# urmap_tpu/index/build.py:_sort_u64
def _sort_u64(L, keys: np.ndarray) -> None:
    """In-place sort of unique uint64 keys (native radix when present)."""
    if L is not None and keys.shape[0] > 1:
        if L.urmap_sort_u64(keys.ctypes.data_as(_P_U64),
                            keys.shape[0]) == 0:
            return
    keys.sort(kind="stable")


def _chunk_sorted_slots(codes: torch.Tensor, base_pos: int, k: int,
                        slot_bits: int):
    """One chunk on the codes' device: uint8 codes of word starts
    [base_pos, base_pos + n) and the k - 1 bases after them → (slots,
    positions), numpy uint32 sorted by (slot, position), the words that
    hold an N dropped (urmap_tpu/index/build.py:_chunk_sorted_slots with
    its callers' sentinel trim).

    Such words get the sentinel slot 2**slot_bits and sort to the tail.
    The positions of a chunk rise with the index, so a stable sort on
    the slot alone gives the (slot, position) order, and its permutation
    is the position less base_pos. Slots and positions stay int64 on the
    device (the sentinel is 2^31 at slot_bits 31, positions pass 2^31 at
    GRCh38 scale); they cross to the host as their low 32 bits."""
    lo, hi, valid = extract_words(codes, k)
    slots = words_to_slots(lo, hi, slot_bits).to(torch.int64) & 0xFFFF_FFFF
    slots = torch.where(valid, slots, 1 << slot_bits)
    slots, order = torch.sort(slots, stable=True)
    n = int(valid.sum())

    def low32(x: torch.Tensor) -> np.ndarray:
        x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
        return x.cpu().numpy().view(np.uint32)

    return low32(slots[:n]), low32(order[:n] + base_pos)


# urmap_tpu/index/build.py:_merge_sorted_runs
def _merge_sorted_runs(runs: list[tuple[np.ndarray, np.ndarray]]):
    """Merge per-chunk (slot, pos) runs, each sorted by (slot, pos).

    Chunks are produced in ascending-position order, so one STABLE sort
    on slots alone re-establishes (slot, pos) order — equal slots keep
    (chunk, within-chunk) order, which is ascending pos. Half the cost
    of a two-key lexsort on multi-G-position genomes."""
    if len(runs) == 1:
        return runs[0]
    slots = np.concatenate([r[0] for r in runs])
    pos = np.concatenate([r[1] for r in runs])
    order = np.argsort(slots, kind="stable")
    return slots[order], pos[order]


# urmap_tpu/index/build.py:_cap_slots
def _cap_slots(slots: np.ndarray, pos: np.ndarray, num_slots: int, cap: int):
    """Cap each slot to <= ``cap`` positions, subsampled evenly. Returns
    capped (slots, pos, offsets uint32[num_slots+1])."""
    counts = np.bincount(slots, minlength=num_slots).astype(np.int64)
    offsets64 = np.zeros(num_slots + 1, np.int64)
    np.cumsum(counts, out=offsets64[1:])
    if cap > 0 and int(counts.max(initial=0)) > cap:
        keep = evenly_cap_runs(counts, cap)
        slots, pos = slots[keep], pos[keep]
        offsets64 = np.zeros(num_slots + 1, np.int64)
        np.cumsum(np.minimum(counts, cap), out=offsets64[1:])
    if slots.shape[0] >= (1 << 32):
        raise ValueError(
            f"{slots.shape[0]} positions exceed uint32 CSR range; raise "
            "max_positions_per_slot capping")
    return slots, pos, offsets64.astype(np.uint32)


# urmap_tpu/index/build.py:_host_sorted_slots
def _host_sorted_slots(codes: np.ndarray, k: int, slot_bits: int):
    """(slot, pos) pairs of every N-free k-mer, sorted by (slot, pos):
    one sort of the combined (slot << 32 | pos) key."""
    L = _native_lib()
    if L is not None:
        radix_bits = min(8, slot_bits)
        keys, counts = _native_extract_partition(L, codes, 0, k,
                                                 slot_bits, radix_bits)
        off = np.zeros(counts.shape[0] + 1, np.int64)
        np.cumsum(counts, out=off[1:])
        segs = [keys[off[i] : off[i + 1]] for i in range(counts.shape[0])]
        with ThreadPoolExecutor(min(4, os.cpu_count() or 4)) as ex:
            list(ex.map(lambda s: _sort_u64(L, s), segs))
        return (keys >> np.uint64(32)).astype(np.uint32), \
            keys.astype(np.uint32)
    from urmap_tpu_torch.hashing import extract_words_np, words_to_slots_np

    lo, hi, valid = extract_words_np(codes, k)
    slots = words_to_slots_np(lo, hi, slot_bits)
    pos = np.nonzero(valid)[0].astype(np.uint32)
    key = (slots[valid].astype(np.uint64) << np.uint64(32)) | pos
    key.sort(kind="stable")
    return (key >> np.uint64(32)).astype(np.uint32), key.astype(np.uint32)


# urmap_tpu/index/build.py:_RadixSpill
class _RadixSpill:
    """Disk-backed (slot, pos) partition by slot high bits.

    Pairs ride as one uint64 key (slot << 32 | pos); positions are
    unique, so the per-bucket radix sort in finalize() directly yields
    (slot asc, pos asc) — identical to the in-RAM merge, with no stable-
    argsort or payload gathers and no ordering requirements on add()."""

    def __init__(self, slot_bits: int, spill_dir: str | None):
        self.radix_bits = min(8, slot_bits)
        self.shift = slot_bits - self.radix_bits
        self.nbuck = 1 << self.radix_bits
        self.dir = tempfile.mkdtemp(prefix="ufi_spill_", dir=spill_dir)
        self.paths = [os.path.join(self.dir, f"b{i:04d}.bin")
                      for i in range(self.nbuck)]
        self.files = [open(p, "wb", buffering=1 << 20) for p in self.paths]

    def add(self, slots: np.ndarray, pos: np.ndarray,
            sorted_by_slot: bool = False) -> None:
        key = (slots.astype(np.uint64) << np.uint64(32)) | pos
        if sorted_by_slot:
            # device-build chunks arrive slot-sorted: bucket boundaries
            # are nbuck binary searches, no argsort partition pass.
            # uint32 needles — uint64 ones would promote (copy) the
            # whole slots chunk
            cuts = np.searchsorted(
                slots, (np.arange(1, self.nbuck, dtype=np.uint32)
                        << np.uint32(self.shift)).astype(slots.dtype))
            counts = np.diff(np.concatenate(
                [[0], cuts, [slots.shape[0]]]))
        else:
            b = (slots >> np.uint32(self.shift)).astype(np.uint8)
            order = np.argsort(b, kind="stable")  # radix partition
            key = key[order]
            counts = np.bincount(b, minlength=self.nbuck)
        off = 0
        for i in range(self.nbuck):
            c = int(counts[i])
            if c:
                self.files[i].write(key[off : off + c].tobytes())
                off += c

    def add_partitioned(self, keys: np.ndarray,
                        counts: np.ndarray) -> None:
        """Append keys already partitioned by bucket (ascending, counts
        per bucket) — the native extract_partition output lands here
        with zero host post-processing."""
        off = 0
        for i in range(self.nbuck):
            c = int(counts[i])
            if c:
                self.files[i].write(keys[off : off + c].tobytes())
                off += c

    def finalize(self, num_slots: int, cap: int):
        """Per-bucket sort + cap → (offsets uint32[num_slots+1],
        positions uint32). Deletes the spill directory.

        Buckets are independent, so a small thread pool loads + sorts a
        few buckets ahead (the native kernels release the GIL); the
        consumer assembles offsets/positions in bucket order. Buffers
        come from a fixed free-list and the capped positions land
        directly in the final array (bigmem shared-hugepage storage) —
        fresh multi-GB allocations cost ~5-20 s/GB of page faults on
        this VM class, so the loop reuses every large buffer."""
        for f in self.files:
            f.close()
        L = _native_lib()
        running = 0
        sps = 1 << self.shift                     # slots per bucket
        sizes = [os.path.getsize(p) // 8 for p in self.paths]
        grand = sum(sizes)          # uncapped upper bound on positions;
        #                             the capped total is range-checked
        #                             per bucket below
        window = min(4, (os.cpu_count() or 4))

        if L is not None:
            import ctypes
            import queue

            from urmap_tpu_torch.utils.bigmem import big_empty

            # every entry is assigned below (each slot belongs to
            # exactly one bucket), so no zero-fill is needed — and a
            # zeroed anon array would fault ~10 s/GB on this VM class
            offsets = big_empty(num_slots + 1, np.uint32)
            final_pos = big_empty(max(grand, 1), np.uint32)
            maxb = max(sizes, default=1)
            free: queue.Queue = queue.Queue()
            for _ in range(window + 1):
                free.put((big_empty(maxb, np.uint64),
                          big_empty(maxb, np.uint32),
                          np.empty(sps, np.int64)))

            def load_sort(i: int):
                bufs = free.get()
                kbuf, pbuf, cbuf = bufs
                n = sizes[i]
                key = kbuf[:n]
                with open(self.paths[i], "rb") as f:
                    if f.readinto(key) != n * 8:
                        raise IOError(f"short read on {self.paths[i]}")
                _sort_u64(L, key)
                m = L.urmap_bucket_csr(
                    key.ctypes.data_as(_P_U64), n, i * sps, sps, cap,
                    pbuf.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint32)),
                    cbuf.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int64)))
                if m < 0:
                    raise RuntimeError("urmap_bucket_csr failed")
                return bufs, int(m)

            cum_buf = np.empty(sps + 1, np.int64)
            with ThreadPoolExecutor(window) as ex:
                pending = {i: ex.submit(load_sort, i)
                           for i in range(min(window, self.nbuck))}
                for i in range(self.nbuck):
                    bufs, m = pending.pop(i).result()
                    nxt = i + window
                    if nxt < self.nbuck:
                        pending[nxt] = ex.submit(load_sort, nxt)
                    _, pbuf, cbuf = bufs
                    lo = i * sps
                    cum_buf[0] = running
                    np.cumsum(cbuf, out=cum_buf[1:])
                    cum_buf[1:] += running
                    if cum_buf[-1] >= (1 << 32):
                        raise ValueError(
                            "positions exceed uint32 CSR range")
                    offsets[lo : lo + sps + 1] = cum_buf
                    final_pos[running : running + m] = pbuf[:m]
                    running = int(cum_buf[-1])
                    free.put(bufs)
            shutil.rmtree(self.dir, ignore_errors=True)
            return offsets, final_pos[:running]

        offsets = np.zeros(num_slots + 1, np.uint32)
        pos_parts = []

        def load_sort_np(i: int) -> np.ndarray:
            key = np.fromfile(self.paths[i], "<u8")
            _sort_u64(L, key)
            return key

        with ThreadPoolExecutor(window) as ex:
            pending = {i: ex.submit(load_sort_np, i)
                       for i in range(min(window, self.nbuck))}
            for i in range(self.nbuck):
                key = pending.pop(i).result()
                nxt = i + window
                if nxt < self.nbuck:
                    pending[nxt] = ex.submit(load_sort_np, nxt)
                sl_rel = (key >> np.uint64(32)).astype(np.int64) - i * sps
                po = key.astype(np.uint32)
                del key
                counts_b = np.bincount(sl_rel,
                                       minlength=sps).astype(np.int64)
                if cap > 0 and int(counts_b.max(initial=0)) > cap:
                    po = po[evenly_cap_runs(counts_b, cap)]
                    counts_b = np.minimum(counts_b, cap)
                pos_parts.append(po)
                lo = i * sps
                cum = running + np.concatenate([[0], np.cumsum(counts_b)])
                if cum[-1] >= (1 << 32):
                    raise ValueError("positions exceed uint32 CSR range")
                offsets[lo : lo + sps + 1] = cum
                running = int(cum[-1])
        shutil.rmtree(self.dir, ignore_errors=True)
        return offsets, np.concatenate(pos_parts) if pos_parts \
            else np.zeros(0, np.uint32)


# urmap_tpu/index/build.py:_host_chunk_slots
def _host_chunk_slots(codes: np.ndarray, start: int, stop: int, k: int,
                      slot_bits: int):
    """Host word extraction for word starts [start, stop): returns
    (slots, pos) in ascending-position order (invalid words dropped)."""
    from urmap_tpu_torch.hashing import extract_words_np, words_to_slots_np

    sub = codes[start : stop + k - 1]
    lo, hi, valid = extract_words_np(sub, k)
    slots = words_to_slots_np(lo, hi, slot_bits)
    pos = (np.nonzero(valid)[0] + start).astype(np.uint32)
    return slots[valid], pos


# urmap_tpu/index/build.py:build_index
def build_index(seqdb: SeqDB, cfg: IndexConfig | None = None, *,
                backend: str = "device", device=None,
                chunk: int | None = None,
                spill_threshold: int = SPILL_THRESHOLD,
                spill_dir: str | None = None) -> UfiIndex:
    """Build the UFI index for a SeqDB. ``cfg=None`` auto-sizes
    slot_bits from the genome length. ``backend``: "device" (the
    default, as the reference's: extract, hash and sort on ``device``,
    "cuda" when None, which raises without a card) or "host" (C++ or
    numpy; the command line's default). Each processes ``chunk`` words
    at a time (``DEFAULT_CHUNK`` on the device, ``HOST_CHUNK`` on the host;
    the host's in-RAM build takes the genome whole). Genomes with more
    than ``spill_threshold`` words stream through a disk radix spill
    under ``spill_dir`` (tempfile's default when None). The output is
    the same bit for bit whatever the backend, the chunk or the spill;
    the spill directory is removed on success and on any exception."""
    if backend not in ("host", "device"):
        raise ValueError(f"backend must be 'host' or 'device', not "
                         f"{backend!r}")
    dev = (require_device("cuda" if device is None else device)
           if backend == "device" else None)
    if chunk is None:
        chunk = HOST_CHUNK if dev is None else DEFAULT_CHUNK
    if cfg is None:
        cfg = IndexConfig(
            slot_bits=IndexConfig.auto_slot_bits(seqdb.total_len))
    codes = seqdb.codes
    n_words = codes.shape[0] - cfg.k + 1
    if n_words <= 0:
        raise ValueError("genome shorter than k")

    def device_run(start: int):
        # word starts [start, stop) read codes[start : stop + k - 1]
        stop = min(start + chunk, n_words)
        sub = np.ascontiguousarray(codes[start : stop + cfg.k - 1])
        return _chunk_sorted_slots(torch.from_numpy(sub).to(dev), start,
                                   cfg.k, cfg.slot_bits)

    if n_words > spill_threshold:
        spill = _RadixSpill(cfg.slot_bits, spill_dir)
        L = _native_lib() if dev is None else None
        try:
            start = 0
            while start < n_words:
                stop = min(start + chunk, n_words)
                if dev is not None:
                    sl, po = device_run(start)
                    spill.add(sl, po, sorted_by_slot=True)
                elif L is not None:
                    keys, counts = _native_extract_partition(
                        L, codes[start : stop + cfg.k - 1], start,
                        cfg.k, cfg.slot_bits, spill.radix_bits)
                    spill.add_partitioned(keys, counts)
                    # free this chunk's keys before the next allocates
                    del keys
                else:
                    sl, po = _host_chunk_slots(codes, start, stop, cfg.k,
                                               cfg.slot_bits)
                    spill.add(sl, po)
                start = stop
            offsets, positions = spill.finalize(cfg.num_slots,
                                                cfg.max_positions_per_slot)
        except BaseException:
            # a multi-Gbp spill is ~25 GB of TMPDIR: never leave it
            # behind (finalize removes it on success)
            shutil.rmtree(spill.dir, ignore_errors=True)
            raise
        return UfiIndex(config=cfg, offsets=offsets, positions=positions,
                        seqdb=seqdb)
    if dev is None:
        slots, pos = _host_sorted_slots(codes, cfg.k, cfg.slot_bits)
    else:
        slots, pos = _merge_sorted_runs(
            [device_run(start) for start in range(0, n_words, chunk)])
    slots, pos, offsets = _cap_slots(slots, pos, cfg.num_slots,
                                     cfg.max_positions_per_slot)
    return UfiIndex(config=cfg, offsets=offsets,
                    positions=pos.astype(np.uint32), seqdb=seqdb)
