"""UFI index container, on-disk format and map-ready tables.

JAX-free copies of urmap_tpu/index/store.py (that module's package
imports JAX through index/build.py), reading and writing the same
on-disk format: an index or a prepared_p<p>/ cache that urmap_tpu saved
loads here and the other way round. New here: ``tables_to_device`` and
``tables_from_numpy`` put the host tables on a torch device.

CSR semantics: positions[offsets[s] : offsets[s+1]] are the global
genome start positions (ascending) of every indexed k-mer whose hash
slot is s.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from urmap_tpu_torch.config import IndexConfig
from urmap_tpu_torch.io.fasta import SeqDB
from urmap_tpu_torch._bits import as_i32

FORMAT_VERSION = 1
ROW128 = 128  # dense-row layout width


# urmap_tpu/index/store.py:evenly_cap_runs
def evenly_cap_runs(counts: np.ndarray, cap: int,
                    chunk_entries: int = 1 << 26) -> np.ndarray:
    """Per-entry keep-mask capping each CSR run to <= ``cap`` entries,
    sampled evenly across the run (kept ranks ceil(m*c/cap))."""
    counts = counts.astype(np.int64)
    ends = np.cumsum(counts)
    n = int(ends[-1]) if counts.size else 0
    keep = np.empty(n, bool)
    S = counts.shape[0]
    s = 0
    pos = 0
    while s < S:
        e = int(np.searchsorted(ends, pos + chunk_entries, side="left"))
        e = max(e, s)
        sub = counts[s : e + 1]
        m = int(sub.sum())
        if m:
            cnt_e = np.repeat(sub, sub)
            starts = np.cumsum(sub) - sub
            rank = np.arange(m, dtype=np.int64) - np.repeat(starts, sub)
            mark = (rank * cap) // cnt_e
            keep[pos : pos + m] = mark != ((rank - 1) * cap) // cnt_e
        pos += m
        s = e + 1
    return keep


# urmap_tpu/index/store.py:counts_i64
def counts_i64(offsets: np.ndarray) -> np.ndarray:
    """CSR run lengths (diff of offsets) as int64."""
    from urmap_tpu_torch.utils.bigmem import big_empty

    n = offsets.shape[0] - 1
    if offsets.dtype != np.uint32:
        return np.diff(offsets.astype(np.int64))
    c32 = big_empty(n, np.uint32)
    np.subtract(offsets[1:], offsets[:-1], out=c32)
    counts = big_empty(n, np.int64)
    counts[...] = c32
    return counts


def _native_starts(fn_name: str, counts: np.ndarray, g: int):
    from urmap_tpu_torch.io import native as _native

    nlib = _native.lib()
    if nlib is None:
        return None
    import ctypes

    from urmap_tpu_torch.utils.bigmem import big_empty

    starts = big_empty(counts.shape[0], np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    total = getattr(nlib, fn_name)(
        counts.ctypes.data_as(p64), counts.shape[0], g,
        starts.ctypes.data_as(p64))
    return starts, int(total)


# urmap_tpu/index/store.py:align_runs_fixed
def align_runs_fixed(counts: np.ndarray, g: int) -> tuple[np.ndarray, int]:
    """Greedy placement with a fixed no-crossing granularity g (the
    row128 layout): each run (<= g entries) never crosses a g-word
    boundary. Returns (starts int64[S], padded_total)."""
    counts = np.ascontiguousarray(counts, np.int64)
    n = counts.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), 0
    assert g & (g - 1) == 0, "g must be a power of two"
    assert int(counts.max()) <= g, "runs must be capped to <= g"
    nat = _native_starts("urmap_align_runs_fixed", counts, g)
    if nat is not None:
        return nat
    starts = np.empty(n, np.int64)
    cur = 0
    for i, c in enumerate(counts.tolist()):
        rem = g - (cur & (g - 1))
        if c > rem:
            cur += rem
        starts[i] = cur
        cur += c
    return starts, cur


# urmap_tpu/index/store.py:align_runs
def align_runs(counts: np.ndarray, rw: int) -> tuple[np.ndarray, int]:
    """Greedy no-straddle placement of CSR runs: a run of c entries
    (<= rw) never crosses a next_pow2(c)-word boundary. Returns
    (starts int64[S], padded_total)."""
    counts = np.ascontiguousarray(counts, np.int64)
    n = counts.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), 0
    assert rw & (rw - 1) == 0, "rw must be a power of two"
    assert int(counts.max()) <= rw, "runs must be capped to <= rw"
    nat = _native_starts("urmap_align_runs", counts, rw)
    if nat is not None:
        return nat
    starts = np.empty(n, np.int64)
    cur = 0
    for i, c in enumerate(counts.tolist()):
        g = 1
        while g < c:
            g <<= 1
        rem = g - (cur & (g - 1))
        if c > rem:
            cur += rem
        starts[i] = cur
        cur += c
    return starts, cur


@dataclass
class UfiIndex:
    """urmap_tpu/index/store.py:UfiIndex, JAX-free (same fields, same
    on-disk format)."""

    config: IndexConfig
    offsets: np.ndarray    # uint32[num_slots + 1] (CSR; >2^31 legal)
    positions: np.ndarray  # uint32[total_positions] global coordinates
    seqdb: SeqDB
    path: str | None = None

    @property
    def num_positions(self) -> int:
        return int(self.positions.shape[0])

    # urmap_tpu/index/store.py:UfiIndex.recapped
    def recapped(self, cap: int) -> "UfiIndex":
        """This index with every slot capped to <= ``cap`` positions,
        subsampled evenly across the run."""
        if cap <= 0:
            return self
        from urmap_tpu_torch.io import native as _native

        nlib = None if os.environ.get("URMAP_NO_NATIVE_BUILD") \
            else _native.lib()
        n_slots = self.offsets.shape[0] - 1
        if nlib is not None:
            import ctypes

            from urmap_tpu_torch.utils.bigmem import big_empty

            p_u32 = ctypes.POINTER(ctypes.c_uint32)
            offsets = np.ascontiguousarray(self.offsets, np.uint32)
            off32 = big_empty(n_slots + 1, np.uint32)
            mx = nlib.urmap_cap_offsets(
                offsets.ctypes.data_as(p_u32), n_slots, cap,
                os.cpu_count() or 4, off32.ctypes.data_as(p_u32))
            if mx <= cap:
                return self
            positions = np.ascontiguousarray(self.positions, np.uint32)
            new_pos = big_empty(int(off32[-1]), np.uint32)
            nlib.urmap_recap(
                offsets.ctypes.data_as(p_u32), n_slots,
                positions.ctypes.data_as(p_u32), cap,
                os.cpu_count() or 4, off32.ctypes.data_as(p_u32),
                new_pos.ctypes.data_as(p_u32))
            return UfiIndex(config=self.config, offsets=off32,
                            positions=new_pos, seqdb=self.seqdb)
        counts = np.diff(self.offsets.astype(np.int64))
        if int(counts.max(initial=0)) <= cap:
            return self
        off = np.zeros(n_slots + 1, np.int64)
        np.cumsum(np.minimum(counts, cap), out=off[1:])
        keep = evenly_cap_runs(counts, cap)
        return UfiIndex(config=self.config, offsets=off.astype(np.uint32),
                        positions=self.positions[keep], seqdb=self.seqdb)

    def host_tables(self, cap: int | None = None,
                    row_align: int | None = None,
                    row_fixed: int | None = None) -> dict:
        """Map-ready numpy tables (same keys as urmap_tpu's)."""
        return self._tables_np(cap=cap, row_align=row_align,
                               row_fixed=row_fixed)

    # urmap_tpu/index/store.py:UfiIndex._tables_np
    def _tables_np(self, cap: int | None = None,
                   row_align: int | None = None,
                   row_fixed: int | None = None) -> dict:
        from urmap_tpu_torch import genome_pack as gpk
        from urmap_tpu_torch.map.seed import POS_BIAS, SENTINEL

        if cap is not None:
            return self.recapped(cap)._tables_np(row_align=row_align,
                                                 row_fixed=row_fixed)
        glen = self.seqdb.total_len
        if glen >= SENTINEL + POS_BIAS - (1 << 16):
            raise ValueError(
                f"genome of {glen:,} bases exceeds the biased-int32 "
                "device coordinate range (~4.29 Gbp); shard the genome")
        from urmap_tpu_torch.utils.bigmem import big_empty

        ginter, base_off = gpk.pack_genome(self.seqdb.codes)
        offsets = self.offsets
        npos = self.positions.shape[0]
        layout = "classic"
        if row_fixed is not None:
            layout = "row128"
        elif row_align is not None:
            layout = "aligned"
        if row_align is None and row_fixed is None:
            pad = 2 * gpk.ROW_WORDS + ((-npos) % gpk.ROW_WORDS)
            positions = big_empty(npos + pad, np.int32)
            np.subtract(np.asarray(self.positions, np.uint32),
                        np.uint32(POS_BIAS),
                        out=positions[:npos].view(np.uint32))
            positions[npos:] = 0
        else:
            counts = counts_i64(offsets)
            if row_fixed is not None:
                rw = int(row_fixed)
                starts, total = align_runs_fixed(counts, rw)
                pad = rw + ((-total) % rw)
            else:
                rw = int(row_align)
                starts, total = align_runs(counts, rw)
                pad = (2 * gpk.ROW_WORDS
                       + ((-(total + 2 * gpk.ROW_WORDS)) % 128))
            if total + pad >= 1 << 32:
                raise ValueError("row-aligned positions table exceeds "
                                 "uint32 offsets; raise the cap filter")
            positions = big_empty(total + pad, np.int32)
            positions[...] = SENTINEL
            pos_b = positions[:total]
            from urmap_tpu_torch.io import native as _native

            nlib = None if os.environ.get("URMAP_NO_NATIVE_BUILD") \
                else _native.lib()
            if nlib is not None:
                import ctypes

                p_u32 = ctypes.POINTER(ctypes.c_uint32)
                off_c = np.ascontiguousarray(offsets, np.uint32)
                pos_c = np.ascontiguousarray(self.positions, np.uint32)
                starts_c = np.ascontiguousarray(starts, np.int64)
                nlib.urmap_place_runs(
                    off_c.ctypes.data_as(p_u32), counts.shape[0],
                    pos_c.ctypes.data_as(p_u32),
                    starts_c.ctypes.data_as(_native.p_i64), POS_BIAS,
                    os.cpu_count() or 4,
                    pos_b.ctypes.data_as(_native.p_i32))
            else:
                CH = 1 << 26
                ends = np.cumsum(counts)
                old_starts = ends - counts
                s = 0
                S = counts.shape[0]
                while s < S:
                    e = int(np.searchsorted(ends,
                                            int(old_starts[s]) + CH,
                                            side="left"))
                    e = max(e, s + 1)
                    cs = counts[s:e]
                    m = int(cs.sum())
                    if m:
                        rank = (np.arange(m, dtype=np.int64)
                                - np.repeat(
                                    old_starts[s:e] - old_starts[s], cs))
                        idx = np.repeat(starts[s:e], cs) + rank
                        src = self.positions[
                            old_starts[s] : old_starts[s] + m]
                        pos_b[idx] = ((src.astype(np.int64) - POS_BIAS)
                                      .astype(np.int32))
                    s = e
            off_al = big_empty(counts.shape[0] + 1, np.uint32)
            off_al[:-1] = starts
            off_al[-1] = total
            offsets = off_al
        return {
            "offsets": np.asarray(offsets, np.uint32),
            "positions": positions,
            "ginter": ginter,
            "layout": layout,
            "base_off": base_off + POS_BIAS // gpk.BASES_PER_WORD,
            "genome_max_biased": np.int32(glen - 1 - POS_BIAS),
        }

    # urmap_tpu/index/store.py:UfiIndex.save
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        header = {
            "format_version": FORMAT_VERSION,
            "k": self.config.k,
            "slot_bits": self.config.slot_bits,
            "max_positions_per_slot": self.config.max_positions_per_slot,
            "veryfast": self.config.veryfast,
            "num_positions": self.num_positions,
            "genome_total_len": self.seqdb.total_len,
            "num_seqs": self.seqdb.num_seqs,
        }
        with open(os.path.join(path, "header.json"), "w") as f:
            json.dump(header, f, indent=2)
        # temp name + os.replace: the arrays may be mmaps of these files
        for name, arr in (("offsets", self.offsets),
                          ("positions", self.positions)):
            tmp = os.path.join(path, f".{name}.{os.getpid()}.tmp.npy")
            np.save(tmp, arr)
            os.replace(tmp, os.path.join(path, f"{name}.npy"))
        stale = os.path.join(path, "tables.npz")
        if os.path.exists(stale):
            os.remove(stale)
        self.seqdb.save(os.path.join(path, "seqdb.npz"))
        self.path = path

    # urmap_tpu/index/store.py:UfiIndex.load
    @classmethod
    def load(cls, path: str) -> "UfiIndex":
        with open(os.path.join(path, "header.json")) as f:
            header = json.load(f)
        if header["format_version"] != FORMAT_VERSION:
            raise ValueError(
                f"unsupported index format {header['format_version']}")
        npz = os.path.join(path, "tables.npz")
        if os.path.exists(npz):                   # pre-round-3 layout
            with np.load(npz) as z:
                offsets = z["offsets"].astype(np.uint32)
                positions = z["positions"]
        else:
            offsets = np.load(os.path.join(path, "offsets.npy"),
                              mmap_mode="r")
            positions = np.load(os.path.join(path, "positions.npy"),
                                mmap_mode="r")
        seqdb = SeqDB.load(os.path.join(path, "seqdb.npz"))
        cfg = IndexConfig(
            k=header["k"],
            slot_bits=header["slot_bits"],
            max_positions_per_slot=header["max_positions_per_slot"],
            veryfast=header.get("veryfast", False),
        )
        return cls(config=cfg, offsets=offsets, positions=positions,
                   seqdb=seqdb, path=path)


# urmap_tpu/index/store.py:packed_offsets_bits
def packed_offsets_bits(p: int) -> tuple[int, int]:
    """(cnt_bits, block_bits) of the packed row128 offsets encoding."""
    cnt_bits = int(2 * p - 1).bit_length()
    delta_bits = 16 - cnt_bits
    span = 2 * p - 1
    block_bits = 0
    while (1 << (block_bits + 1)) * span <= (1 << delta_bits):
        block_bits += 1
    return cnt_bits, block_bits


# urmap_tpu/index/store.py:pack_offsets_row128
def pack_offsets_row128(offsets: np.ndarray, p: int):
    """row128 CSR offsets → dict(opacked, obase, cnt_bits, block_bits),
    or None when the encoding's invariants don't hold."""
    from urmap_tpu_torch.utils.bigmem import big_empty

    cnt_bits, block_bits = packed_offsets_bits(p)
    S = offsets.shape[0] - 1
    if S <= 0:
        return None
    off = np.asarray(offsets[:-1], np.uint32)
    diff = np.asarray(offsets[1:], np.uint32) - off
    if int(diff.max(initial=0)) >= (1 << cnt_bits):
        return None
    nb = -(-S // (1 << block_bits))
    base = np.ascontiguousarray(off[:: 1 << block_bits], np.uint32)
    assert base.shape[0] == nb
    delta = off - np.repeat(base, 1 << block_bits)[:S]
    if int(delta.max(initial=0)) >= (1 << (16 - cnt_bits)):
        return None
    u16 = big_empty(S + (S & 1), np.uint16)
    u16[:S] = (delta.astype(np.uint16) << np.uint16(cnt_bits)) \
        | diff.astype(np.uint16)
    if S & 1:
        u16[S] = 0
    return {"opacked": u16.view(np.uint32), "obase": base,
            "cnt_bits": cnt_bits, "block_bits": block_bits}


# urmap_tpu/index/store.py:effective_gather_tier
def effective_gather_tier(meta: dict):
    """The gather tier the map step uses: none unless
    URMAP_TIER_GATHER=1 (the reference's default)."""
    if os.environ.get("URMAP_TIER_GATHER") == "1":
        return meta.get("gather_tier")
    return None


def _row128_budget() -> int:
    return int(os.environ.get("URMAP_ROW128_BYTES", str(2 << 30)))


# urmap_tpu/index/store.py:prepare_tables
def prepare_tables(index: UfiIndex, p: int) -> tuple[dict, dict]:
    """Map-time prep (recap → layout decision → gather tier → packed
    genome) as numpy + metadata, with the reference's decision rule:
    aligned when the no-straddle pad costs <= 15%, row128 when the
    padded table view exceeds URMAP_ROW128_BYTES (default 2 GiB)."""
    from urmap_tpu_torch.map.pipeline import pick_gather_tier
    from urmap_tpu_torch.map.seed import align_row_words

    capped = index.recapped(p)
    rw = align_row_words(p)
    starts, total = align_runs(counts_i64(capped.offsets), rw)
    csr_aligned = bool(total <= 1.15 * max(capped.num_positions, 1))
    view_bytes = (total if csr_aligned
                  else capped.num_positions) * 4 * (128 // min(rw, 128))
    row128 = p <= ROW128 and view_bytes > _row128_budget()
    tier = None
    if row128:
        # 8 bytes a slot (8.6 GB at 2^30 slots) that the row128 layout,
        # which places its runs anew, does not read
        del starts
        csr_aligned = False
        ht = capped.host_tables(row_fixed=ROW128)
        pk = pack_offsets_row128(ht["offsets"], p)
        if pk is not None:
            ht["opacked"], ht["obase"] = pk["opacked"], pk["obase"]
    else:
        if csr_aligned:
            tier = pick_gather_tier(
                np.diff(np.concatenate([starts, [total]])))
        ht = capped.host_tables(row_align=rw if csr_aligned else None)
    meta = {
        "p": p,
        "layout": ht["layout"],
        "csr_aligned": csr_aligned,
        "gather_tier": tier,
        "off_bits": (list(packed_offsets_bits(p))
                     if ht.get("opacked") is not None else None),
        "k": index.config.k,
        "slot_bits": index.config.slot_bits,
        "veryfast": index.config.veryfast,
        "genome_total_len": index.seqdb.total_len,
        "base_off": int(ht["base_off"]),
        "genome_max_biased": int(ht["genome_max_biased"]),
    }
    return ht, meta


def _prepared_dir(path: str, p: int) -> str:
    return os.path.join(path, f"prepared_p{p}")


# urmap_tpu/index/store.py:save_prepared
def save_prepared(index: UfiIndex, path: str, p: int) -> str:
    """Persist map-ready tables under <index dir>/prepared_p<p>/."""
    ht, meta = prepare_tables(index, p)
    d = _prepared_dir(path, p)
    os.makedirs(d, exist_ok=True)
    keys = ["offsets", "positions", "ginter"]
    if ht.get("opacked") is not None:
        keys += ["opacked", "obase"]
    for key in keys:
        np.save(os.path.join(d, f"{key}.npy"), ht[key])
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return d


# urmap_tpu/index/store.py:load_prepared
def load_prepared(index: UfiIndex, p: int) -> tuple[dict, dict] | None:
    """The prepared tables matching this index and gather width, or
    None (missing or stale). Arrays are memory-mapped. A row128 cache
    written before the packed offsets existed is returned without them
    (the Mapper then gathers from the plain offsets table)."""
    if index.path is None:
        return None
    d = _prepared_dir(index.path, p)
    mf = os.path.join(d, "meta.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        meta = json.load(f)
    cfg = index.config
    if (meta.get("p") != p or meta.get("k") != cfg.k
            or meta.get("slot_bits") != cfg.slot_bits
            or meta.get("veryfast") != cfg.veryfast
            or meta.get("genome_total_len") != index.seqdb.total_len):
        return None
    ht = {key: np.load(os.path.join(d, f"{key}.npy"), mmap_mode="r")
          for key in ("offsets", "positions", "ginter")}
    ht["base_off"] = meta["base_off"]
    ht["genome_max_biased"] = meta["genome_max_biased"]
    ht["layout"] = meta.get(
        "layout", "aligned" if meta.get("csr_aligned") else "classic")
    meta.setdefault("layout", ht["layout"])
    if ht["layout"] != "row128":
        from urmap_tpu_torch.map.seed import align_row_words

        rw_ = align_row_words(p)
        if (p <= ROW128 and ht["positions"].shape[0] * 4
                * (128 // min(rw_, 128)) > _row128_budget()):
            return None
    else:
        opf = os.path.join(d, "opacked.npy")
        if os.path.exists(opf):
            ht["opacked"] = np.load(opf, mmap_mode="r")
            ht["obase"] = np.load(os.path.join(d, "obase.npy"),
                                  mmap_mode="r")
            meta.setdefault("off_bits", list(packed_offsets_bits(p)))
    return ht, meta


# urmap_tpu/index/store.py:ginter_rows
def ginter_rows(ginter) -> np.ndarray:
    """Interleaved genome planes → dense [R, 128] rows for the row128
    layout (genome_pack.row128_window_fetch). Pads stale caches whose
    length predates the %128 pack_genome guarantee with all-N guard
    pairs (code 0, nplane 0x5555_5555)."""
    g = np.asarray(ginter)
    rem = int((-g.shape[0]) % 128)
    if rem:
        pad = np.empty(rem, np.uint32)
        pad[0::2] = 0
        pad[1::2] = 0x5555_5555
        g = np.concatenate([g, pad])
    return g.reshape(-1, 128)


def tables_to_device(ht: dict, device: torch.device, *,
                     use_packed_offsets: bool = False) -> dict:
    """Host tables → device tables. uint32 arrays travel as int32 bit
    patterns (``_bits``); gathered CSR offsets are widened back to
    uint32 values in int64 (seed.gather_candidates).

    row128 layout: positions and the interleaved genome go up shaped
    [R, 128], the view kernel B5 (kernels/lane_rotate.py) fetches from.
    ``use_packed_offsets``: ht["opacked"] rides as ``offsets`` with
    ht["obase"] beside it (pack_offsets_row128: half the offsets' bytes);
    the caller then threads the matching meta["off_bits"]."""
    def put(a):
        return torch.from_numpy(as_i32(np.asarray(a))).to(device)

    pos, gin = ht["positions"], ht["ginter"]
    if ht.get("layout") == "row128":
        pos = np.asarray(pos).reshape(-1, ROW128)
        gin = ginter_rows(gin)
    out = {
        "positions": torch.from_numpy(
            np.ascontiguousarray(pos, np.int32)).to(device),
        "ginter": put(gin),
        "base_off": int(ht["base_off"]),
        "genome_max_biased": int(ht["genome_max_biased"]),
    }
    if use_packed_offsets:
        if ht.get("opacked") is None:
            raise ValueError("use_packed_offsets without ht['opacked']")
        out["offsets"] = put(ht["opacked"])
        out["obase"] = put(ht["obase"])
    else:
        out["offsets"] = put(ht["offsets"])
    return out


def tables_from_numpy(ht: dict, meta: dict, device: torch.device) -> dict:
    """Prepared host tables from either package (urmap_tpu's
    index.store.prepare_tables / load_prepared, or this module's) →
    this package's device tables, plus the layout flags the Mapper
    needs: ``csr_aligned``, ``gather_tier``, ``row128`` and ``off_bits``
    ((cnt_bits, block_bits) when the packed offsets are in use: the
    table has them and URMAP_NO_PACKED_OFFSETS is not 1). This is the
    state carried across from the reference: both packages then map
    against the same tables."""
    row128 = meta.get("layout") == "row128"
    off_bits = None
    if (row128 and ht.get("opacked") is not None
            and os.environ.get("URMAP_NO_PACKED_OFFSETS") != "1"):
        off_bits = tuple(meta["off_bits"])
    tables = tables_to_device(ht, device,
                              use_packed_offsets=off_bits is not None)
    tables["csr_aligned"] = bool(meta["csr_aligned"])
    tables["gather_tier"] = effective_gather_tier(meta)
    tables["row128"] = row128
    tables["off_bits"] = off_bits
    return tables
