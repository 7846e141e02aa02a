# Copy of urmap_tpu/io/sam_native.py with the package name replaced.
"""Native SAM record formatting: vectorized field prep + C++ byte codec.

Pairs with io/native/codecs.cpp (SURVEY.md §2.12: the reference's SAM
writer is C++; so is ours). All per-read decisions (flags, coordinates,
TLEN, tag presence) are computed as numpy arrays; the C++ formatter then
emits the record bytes straight from the FASTQ chunk buffer (names, seq,
qual via offsets — no per-read Python objects).

Paired batches are emitted as the R1 block then the R2 block (record
order within a SAM file is unconstrained under @HD SO:unknown; pairs are
matched by QNAME, not adjacency).
"""

from __future__ import annotations

import ctypes

import numpy as np

from urmap_tpu_torch.io import native
from urmap_tpu_torch.io.sam import (FLAG_FIRST, FLAG_MATE_REVERSE,
                              FLAG_MATE_UNMAPPED, FLAG_PAIRED, FLAG_PROPER,
                              FLAG_REVERSE, FLAG_SECOND, FLAG_UNMAPPED)

INT32_MIN = -(1 << 31)


def available() -> bool:
    return native.lib() is not None


def _label_cache(seqdb):
    cache = getattr(seqdb, "_sam_label_cache", None)
    if cache is None:
        blob = "".join(seqdb.labels).encode("ascii")
        off = np.zeros(len(seqdb.labels) + 1, np.int64)
        np.cumsum([len(l) for l in seqdb.labels], out=off[1:])
        cache = (blob, off)
        seqdb._sam_label_cache = cache
    return cache


def _concat_cigars(cig):
    """object-array of str → (bytes blob, int64 offsets[n+1]); an
    already-composed (blob, offsets) tuple (map.cigar.cigars_nm_blob)
    passes through untouched."""
    if isinstance(cig, tuple):
        return cig
    lens = np.fromiter((len(c) for c in cig), np.int64, count=len(cig))
    off = np.zeros(len(cig) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    blob = "".join(cig.tolist()).encode("ascii")
    return blob, off


def _run_formatter(batch, fields, cig_blob, cig_off, seqdb) -> bytes:
    lib = native.lib()
    labels, label_off = _label_cache(seqdb)
    n = len(batch)
    max_label = int(np.diff(label_off).max(initial=0))
    cap = (96 * n + int(batch.name_len.sum()) + len(cig_blob)
           + 2 * int(batch.seq_len.sum()) + 2 * max_label * n
           + 64 * n + 1024)
    while True:
        out = np.empty(cap, np.uint8)
        wrote = lib.urmap_format_sam(
            n, batch.buf,
            batch.name_off.ctypes.data_as(native.p_i64),
            batch.name_len.ctypes.data_as(native.p_i32),
            batch.seq_off.ctypes.data_as(native.p_i64),
            batch.seq_len.ctypes.data_as(native.p_i32),
            batch.qual_off.ctypes.data_as(native.p_i64),
            cig_blob, cig_off.ctypes.data_as(native.p_i64),
            labels, label_off.ctypes.data_as(native.p_i64),
            fields["flag"].ctypes.data_as(native.p_i32),
            fields["ref_id"].ctypes.data_as(native.p_i32),
            fields["pos1"].ctypes.data_as(native.p_i64),
            fields["mapq"].ctypes.data_as(native.p_i32),
            fields["mate_ref"].ctypes.data_as(native.p_i32),
            fields["mate_pos1"].ctypes.data_as(native.p_i64),
            fields["tlen"].ctypes.data_as(native.p_i64),
            fields["score"].ctypes.data_as(native.p_i32),
            fields["nm"].ctypes.data_as(native.p_i32),
            fields["rev"].ctypes.data_as(native.p_i32),
            out.ctypes.data_as(ctypes.c_void_p), cap)
        if wrote >= 0:
            return out[:wrote].tobytes()
        cap *= 2


def _locate(result, seqdb):
    ref, loc = seqdb.global_to_local(result.pos)
    mapped = result.mapped.astype(bool)
    ref_id = np.where(mapped, ref, -1).astype(np.int32)
    pos1 = np.where(mapped, loc + 1, 0).astype(np.int64)
    return mapped, ref_id, pos1


def format_single_end(batch, result, cig, nm, seqdb) -> bytes:
    """NativeReadBatch + MapResult (+ cigars_nm_fast output) → SAM bytes."""
    n = len(batch)
    mapped, ref_id, pos1 = _locate(result, seqdb)
    strand = result.strand.astype(np.int32)
    fields = {
        "flag": np.where(mapped, np.where(strand == 1, FLAG_REVERSE, 0),
                         FLAG_UNMAPPED).astype(np.int32),
        "ref_id": ref_id,
        "pos1": pos1,
        "mapq": np.where(mapped, result.mapq, 0).astype(np.int32),
        "mate_ref": np.full(n, -1, np.int32),
        "mate_pos1": np.zeros(n, np.int64),
        "tlen": np.zeros(n, np.int64),
        "score": np.where(mapped, result.score, INT32_MIN).astype(np.int32),
        "nm": nm.astype(np.int32),
        "rev": (mapped & (strand == 1)).astype(np.int32),
    }
    blob, off = _concat_cigars(cig)
    return _run_formatter(batch, fields, blob, off, seqdb)


def _mate_fields(res_self, res_mate, self_loc, mate_loc, proper, tlen_self,
                 first: bool, n: int):
    m_self = res_self.mapped.astype(bool)
    m_mate = res_mate.mapped.astype(bool)
    self_ref, self_pos1 = self_loc
    mate_ref_id, mate_pos1 = mate_loc

    flag = np.full(n, FLAG_PAIRED | (FLAG_FIRST if first else FLAG_SECOND),
                   np.int32)
    flag |= np.where(proper, FLAG_PROPER, 0)
    flag |= np.where(~m_self, FLAG_UNMAPPED, 0)
    flag |= np.where(~m_mate, FLAG_MATE_UNMAPPED, 0)
    flag |= np.where(m_self & (res_self.strand == 1), FLAG_REVERSE, 0)
    flag |= np.where(m_mate & (res_mate.strand == 1), FLAG_MATE_REVERSE, 0)

    # self unmapped + mate mapped: placed at mate's coordinates
    placed = ~m_self & m_mate
    ref_id = np.where(m_self, self_ref,
                      np.where(placed, mate_ref_id, -1)).astype(np.int32)
    pos1 = np.where(m_self, self_pos1,
                    np.where(placed, mate_pos1, 0)).astype(np.int64)

    same = m_self & m_mate & (self_ref == mate_ref_id)
    # mate_ref: -2 => '='  | >=0 label | -1 => '*'
    mate_ref = np.where(
        m_self & ~m_mate, -2,                      # '=' at own coords
        np.where(placed, -2,
                 np.where(same, -2,
                          np.where(m_self & m_mate, mate_ref_id, -1)))
    ).astype(np.int32)
    pnext = np.where(m_self & ~m_mate, self_pos1,
                     np.where(m_mate, mate_pos1, 0)).astype(np.int64)
    tlen = np.where(same, tlen_self, 0).astype(np.int64)
    return {
        "flag": flag,
        "ref_id": ref_id,
        "pos1": pos1,
        "mapq": np.where(m_self, res_self.mapq, 0).astype(np.int32),
        "mate_ref": mate_ref,
        "mate_pos1": pnext,
        "tlen": tlen,
        "score": np.where(m_self, res_self.score,
                          INT32_MIN).astype(np.int32),
        "nm": None,  # filled by caller
        "rev": (m_self & (res_self.strand == 1)).astype(np.int32),
    }


def format_paired(b1, b2, pres, cig1, nm1, span1, cig2, nm2, span2,
                  seqdb) -> bytes:
    """Two NativeReadBatches + PairResult → SAM bytes (R1 block, R2 block)."""
    n = len(b1)
    m1, ref1, pos1_1 = _locate(pres.m1, seqdb)
    m2, ref2, pos1_2 = _locate(pres.m2, seqdb)
    proper = pres.proper.astype(bool) & m1 & m2

    both_same = m1 & m2 & (ref1 == ref2)
    s1 = pos1_1 - 1
    s2 = pos1_2 - 1
    e1 = s1 + span1
    e2 = s2 + span2
    span = np.maximum(e1, e2) - np.minimum(s1, s2)
    r1_left = (s1 < s2) | ((s1 == s2) & (e1 <= e2))
    tlen1 = np.where(both_same, np.where(r1_left, span, -span), 0)

    f1 = _mate_fields(pres.m1, pres.m2, (ref1, pos1_1), (ref2, pos1_2),
                      proper, tlen1, True, n)
    f1["nm"] = nm1.astype(np.int32)
    f2 = _mate_fields(pres.m2, pres.m1, (ref2, pos1_2), (ref1, pos1_1),
                      proper, -tlen1, False, n)
    f2["nm"] = nm2.astype(np.int32)

    blob1, off1 = _concat_cigars(cig1)
    blob2, off2 = _concat_cigars(cig2)
    return (_run_formatter(b1, f1, blob1, off1, seqdb)
            + _run_formatter(b2, f2, blob2, off2, seqdb))


# the port's spans (urmap_tpu_torch/utils/trace.py): each formatter call
# is the span urmap.sam of its result's batch
from urmap_tpu_torch.utils import trace as _trace  # noqa: E402

format_single_end = _trace.spanned("urmap.sam", 1)(format_single_end)
format_paired = _trace.spanned("urmap.sam", 2)(format_paired)
