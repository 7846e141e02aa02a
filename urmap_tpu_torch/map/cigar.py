"""Host CIGAR/NM for mapping results (numpy + the C++ codecs).

Copies of what urmap_tpu/map/cigar.py's SAM paths run:
M-only winners get "{len}M" and an NM from the ungapped score; gapped
winners replay the device traceback records (MapResult.tb, kernel B6)
in O(L), clip-rescued ones (under end_clip every gapped one) the clip
traceback's (MapResult.clip_tb, kernels/clip_tb.py;
io/native/replay.cpp); rows without valid records (lane overflow, a
walk that left the band or a record, stale score/pos/strand, or the
traceback off) re-run the DP with traceback in C++ (io.native),
clip-rescued rows (every row under end_clip) in clip mode. Each result
is formatted in the clip mode it was mapped in (MapResult.clip_open).
SAM records then come from
io.sam_native.format_single_end / format_paired. The pure-Python path
(``traceback``, ``cigars_nm_fast``, ``cigars_for_result``) serves
PairedMapper.format_py and pair._ref_spans.
"""

from __future__ import annotations

import numpy as np

from urmap_tpu_torch.config import ScoreConfig
from urmap_tpu_torch.utils import trace


# urmap_tpu/map/cigar.py:_finish_ops, decode_tb_row (the host decoder
# of the raw bits of kernel B7; the tests hold the dops replay to it)
def _finish_ops(ops: list[str]) -> tuple[str, int, int]:
    """Shared tail of every traceback: leading/trailing I → S, X → M
    merge, run-length encode. Returns (cigar, nm, ref_span). ``ops`` is
    the forward-ordered op chars (M/X/I/D, optionally S)."""
    s, e = 0, len(ops)
    while s < e and ops[s] == "I":
        ops[s] = "S"; s += 1
    while e > s and ops[e - 1] == "I":
        ops[e - 1] = "S"; e -= 1
    nm = sum(1 for op in ops if op in "XID")
    span = sum(1 for op in ops if op in "MXD")
    if not ops:
        return "", 0, 0
    out: list[str] = []
    prev, run = None, 0
    for op in ops:
        op = "M" if op == "X" else op
        if op == prev:
            run += 1
        else:
            if prev is not None:
                out.append(f"{run}{prev}")
            prev, run = op, 1
    out.append(f"{run}{prev}")
    return "".join(out), nm, span


def decode_tb_row(bits: np.ndarray, col: int, bend: int, length: int,
                  genome: np.ndarray, pos: int, read: np.ndarray,
                  hw: int, L: int) -> tuple[str, int, int] | None:
    """Walk one read's traceback bits (kernels/tb_dp.py layout) →
    (cigar, nm, ref_span), or None when the walk is inconsistent (the
    winner's path left the re-anchored band — caller falls back to the
    host DP). ``bits`` is the [NWORDS, n] device matrix, ``col`` the
    read's column, ``L`` the static padded read length the bits were
    packed at (nibble positions depend on it), ``pos`` the UNBIASED
    genome start. Byte-identical to traceback() for in-band paths: the
    4-bit codes record the same value-equality tie-breaks the host walk
    applies (diag > E > F; gap-open preferred over extend on ties)."""
    W = 2 * hw + 1
    Wp = -(-W // 8) * 8
    ops: list[str] = []
    i, b = length - 1, int(bend)
    if not (0 <= b < W):
        return None
    state = "H"
    guard = 3 * length + 2 * W + 4
    while i >= 0:
        guard -= 1
        if guard < 0:
            return None
        g = i >> 3
        hi = min(g * 8 + 8, L)
        code = (int(bits[g * Wp + b, col]) >> (4 * (hi - 1 - i))) & 0xF
        if state == "H":
            hc = code & 3
            if hc == 0:
                gi = pos + i + b - hw
                if gi < 0 or gi >= len(genome):
                    return None
                ops.append("M" if genome[gi] == read[i] else "X")
                i -= 1
            elif hc == 1:
                state = "E"
            elif hc == 2:
                state = "F"
            else:
                return None
        elif state == "E":
            ops.append("I")
            state = "E" if (code >> 2) & 1 else "H"
            i -= 1
            b += 1
            if b >= W:
                return None
        else:
            ops.append("D")
            state = "F" if (code >> 3) & 1 else "H"
            b -= 1
            if b < 0:
                return None
    if state != "H" or b != hw:
        return None
    ops.reverse()
    return _finish_ops(ops)


# urmap_tpu/map/cigar.py:_tb_select, _tb_decode_rows
def _tb_select(result, rows: np.ndarray, clip_rows):
    """Gapped-winner rows whose CIGAR can decode from the device
    traceback bits (MapResult.tb): present in the tb matrix with the
    SAME score and pos as the final result (a second-pass patch or a
    band-escaping path invalidates the entry) and not clip-rescued.
    Returns (sub_rows, tb_entry_indices)."""
    tb = getattr(result, "tb", None)
    if tb is None or rows.size == 0 or tb["rows"].size == 0:
        return rows[:0], np.zeros(0, np.int64)
    tbr = tb["rows"]
    pi = np.minimum(np.searchsorted(tbr, rows), tbr.size - 1)
    ok = tbr[pi] == rows
    ok &= tb["score"][pi] == np.asarray(result.score)[rows]
    ok &= tb["pos"][pi] == np.asarray(result.pos)[rows]
    # strand too: a second-pass patch can flip orientation at an EQUAL
    # pos/score on an inverted repeat — stale records would replay the
    # wrong orientation's ops with no structural violation
    ok &= tb["strand"][pi] == np.asarray(result.strand)[rows]
    if clip_rows is not None:
        ok &= ~np.asarray(clip_rows, bool)[rows]
    return rows[ok], pi[ok]


def _tb_decode_rows(genome, raw_codes, result, use: np.ndarray,
                    ti: np.ndarray):
    """Replay device dops records for rows ``use`` → (blob, offsets,
    nm, span, ok bool[n]) — strand applied here; ok=False rows fall
    back."""
    tb = result.tb
    lens_u = np.asarray(result.lengths)[use]
    sub = strand_codes_subset(raw_codes[use],
                              np.asarray(result.strand)[use], lens_u)
    (blob, off), nm_u, span_u, okd = dops_decode_batch(
        tb["dops"], tb["cols"][ti], lens_u, genome,
        np.asarray(result.pos)[use], sub, raw=True)
    return blob, off, nm_u, span_u, okd


def _clip_select(result, rows: np.ndarray):
    """Clip-mode rows among ``rows`` whose CIGAR can replay from the
    clip traceback's records (MapResult.clip_tb): present there with the
    SAME score, pos and strand as the final result, as _tb_select holds
    B6's. Returns (sub_rows, clip_tb entry indices)."""
    ctb = getattr(result, "clip_tb", None)
    if ctb is None or rows.size == 0 or ctb["rows"].size == 0:
        return rows[:0], np.zeros(0, np.int64)
    cr = ctb["rows"]
    pi = np.minimum(np.searchsorted(cr, rows), cr.size - 1)
    ok = cr[pi] == rows
    ok &= ctb["score"][pi] == np.asarray(result.score)[rows]
    ok &= ctb["pos"][pi] == np.asarray(result.pos)[rows]
    ok &= ctb["strand"][pi] == np.asarray(result.strand)[rows]
    return rows[ok], pi[ok]


def _clip_decode_rows(genome, raw_codes, result, use: np.ndarray,
                      ci: np.ndarray):
    """Replay the clip traceback's records for rows ``use`` → (blob,
    offsets, nm, span, good bool[n]), or None without the replay
    library. A row is good where its records decode and the clip
    traceback's score is at least the device's (as the host DP's check
    in clip mode); the others go to the host DP."""
    from urmap_tpu_torch.io.native import replay

    ctb = result.clip_tb
    lens_u = np.asarray(result.lengths)[use]
    sub = strand_codes_subset(raw_codes[use],
                              np.asarray(result.strand)[use], lens_u)
    dec = replay.clip_replay_batch(ctb["recs"], ctb["cols"][ci], lens_u,
                                   genome, np.asarray(result.pos)[use], sub)
    if dec is None:
        return None
    (blob, off), nm_u, span_u, okd = dec
    okd &= ctb["dp_score"][ci] >= np.asarray(result.score)[use]
    return blob, off, nm_u, span_u, okd


def _keep_replayed(rows, use, blob, off, nm_u, span_u, okd, nm, span,
                   parts, handled, name) -> None:
    """The rows of a replay whose records served them: their NM and
    span, their CIGARs as one part, marked handled; counted as
    ``rows.<name>`` and ``rows.<name>_failed`` (decoded, then sent to
    the host DP)."""
    good = np.nonzero(okd)[0]
    trace.count(f"rows.{name}", int(good.size))
    trace.count(f"rows.{name}_failed", int(use.size - good.size))
    if good.size == 0:
        return
    guse = use[good]
    nm[guse] = nm_u[good]
    span[guse] = span_u[good]
    if good.size == use.size:
        gblob, goff = blob, off
    else:
        lnb = np.diff(off)
        goff = np.zeros(good.size + 1, np.int64)
        np.cumsum(lnb[good], out=goff[1:])
        gblob = b"".join(blob[off[g] : off[g + 1]] for g in good)
    sel = np.searchsorted(rows, guse)
    parts.append((sel, gblob, goff))
    handled[sel] = True


# urmap_tpu/map/cigar.py:_clip_groups
def _clip_groups(result, sc: ScoreConfig, clip_open: int | None,
                 clip_rows, rows: np.ndarray | None = None,
                 ) -> list[tuple[np.ndarray, int | None]]:
    """Gapped rows split into (rows, per-group clip_open) traceback
    groups: clip-rescued rows (``clip_rows``) trace back in clip mode."""
    if rows is None:
        rows = np.nonzero(result.mapped.astype(bool)
                          & result.gapped.astype(bool))[0]
    if clip_open is not None:
        return [(rows, clip_open)]
    if clip_rows is None:
        return [(rows, None)]
    cm = np.asarray(clip_rows, bool)[rows]
    out = []
    if (~cm).any():
        out.append((rows[~cm], None))
    if cm.any():
        out.append((rows[cm], sc.clip_open))
    return out


# urmap_tpu/map/cigar.py:traceback_batch_native
def traceback_batch_native(genome: np.ndarray, starts: np.ndarray,
                           reads: np.ndarray, lengths: np.ndarray,
                           sc: ScoreConfig, pad: int = 48, raw: bool = False,
                           clip_open: int | None = None):
    """C++ batch traceback → (cigars list[str], nm, score, span), or
    with ``raw`` (blob bytes, offsets int64[n+1], nm, score, span);
    None if the native library is unavailable."""
    from urmap_tpu_torch.io import native

    lib = native.lib()
    if lib is None:
        return None
    import ctypes

    n = starts.shape[0]
    genome = np.ascontiguousarray(genome, np.uint8)
    reads = np.ascontiguousarray(reads, np.uint8)
    starts64 = np.ascontiguousarray(starts, np.int64)
    lens32 = np.ascontiguousarray(lengths, np.int32)
    maxL = int(lens32.max()) if n else 0
    cap = n * (2 * (3 * maxL + pad) + 16) + 64
    cig = np.empty(cap, np.uint8)
    cig_off = np.empty(n + 1, np.int64)
    nm = np.empty(n, np.int32)
    score = np.empty(n, np.int32)
    span = np.empty(n, np.int32)
    rcode = lib.urmap_traceback_batch(
        genome.ctypes.data_as(native.p_u8), genome.shape[0],
        starts64.ctypes.data_as(native.p_i64),
        reads.ctypes.data_as(native.p_u8), reads.shape[1] if n else 0,
        lens32.ctypes.data_as(native.p_i32), n, pad,
        sc.match, sc.mismatch, sc.gap_open, sc.gap_extend,
        int(clip_open is not None), int(clip_open or 0),
        cig.ctypes.data_as(ctypes.c_void_p), cap,
        cig_off.ctypes.data_as(native.p_i64),
        nm.ctypes.data_as(native.p_i32),
        score.ctypes.data_as(native.p_i32),
        span.ctypes.data_as(native.p_i32))
    if rcode != 0:
        return None
    if raw:
        return cig[:cig_off[n]].tobytes(), cig_off, nm, score, span
    blob = cig.tobytes()
    cigars = [blob[cig_off[i]:cig_off[i + 1]].decode("ascii")
              for i in range(n)]
    return cigars, nm, score, span


# urmap_tpu/map/cigar.py:decode_dops_row, dops_decode_batch
def decode_dops_row(dops: np.ndarray, col: int, length: int,
                    genome: np.ndarray, pos: int, read: np.ndarray,
                    ) -> tuple[str, int, int] | None:
    """Replay one read's device (d, op) records (kernels/tb_dp.py dops
    layout: rec_i = byte i%4 of word i//4; op bit 6, deletion-run in
    bits 0-5) → (cigar, nm, ref_span). Forward order: op_i, then d_i
    deletions. Returns None on a structural violation (caller falls
    back to the host DP)."""
    ops: list[str] = []
    gi = int(pos)
    G = len(genome)
    for i in range(length):
        w = i >> 2
        if w >= dops.shape[0]:
            return None
        rec = (int(dops[w, col]) >> (8 * (i & 3))) & 0xFF
        d = rec & 63
        if (rec >> 6) & 1:
            ops.append("I")
        else:
            if gi < 0 or gi >= G:
                return None
            ops.append("M" if genome[gi] == read[i] else "X")
            gi += 1
        if d:
            ops.extend("D" * d)
            gi += d
            if gi > G:
                return None
    return _finish_ops(ops)


def dops_decode_batch(dops: np.ndarray, cols: np.ndarray,
                      lengths: np.ndarray, genome: np.ndarray,
                      starts: np.ndarray, reads: np.ndarray,
                      raw: bool = False):
    """Batch replay of device dops records for ``len(cols)`` reads.
    C++ when available, decode_dops_row twin otherwise — byte-identical
    outputs.

    reads must be STRAND-APPLIED codes [n, >=L]. Returns
    (cigars list[str] | (blob, offsets) with raw=True, nm int32[n],
    span int32[n], ok bool[n]); rows with ok=False have empty cigar
    entries and must fall back to the host DP traceback."""
    from urmap_tpu_torch.io import native

    n = cols.shape[0]
    L = reads.shape[1] if n else 0
    lib = native.lib()
    if lib is not None:
        import ctypes

        dops = np.ascontiguousarray(dops, np.int32)
        cols32 = np.ascontiguousarray(cols, np.int32)
        lens32 = np.ascontiguousarray(lengths, np.int32)
        genome = np.ascontiguousarray(genome, np.uint8)
        starts64 = np.ascontiguousarray(starts, np.int64)
        reads = np.ascontiguousarray(reads, np.uint8)
        cap = n * (6 * L + 32) + 64
        while True:
            cig = np.empty(cap, np.uint8)
            cig_off = np.empty(n + 1, np.int64)
            nm = np.empty(n, np.int32)
            span = np.empty(n, np.int32)
            ok = np.empty(n, np.uint8)
            rc = lib.urmap_dops_decode_batch(
                dops.ctypes.data_as(native.p_i32),
                dops.shape[0], dops.shape[1],
                cols32.ctypes.data_as(native.p_i32),
                lens32.ctypes.data_as(native.p_i32),
                genome.ctypes.data_as(native.p_u8), genome.shape[0],
                starts64.ctypes.data_as(native.p_i64),
                reads.ctypes.data_as(native.p_u8), L, n,
                cig.ctypes.data_as(ctypes.c_void_p), cap,
                cig_off.ctypes.data_as(native.p_i64),
                nm.ctypes.data_as(native.p_i32),
                span.ctypes.data_as(native.p_i32),
                ok.ctypes.data_as(native.p_u8))
            if rc == 0:
                break
            cap *= 2
        okb = ok.astype(bool)
        if raw:
            return (cig[: cig_off[n]].tobytes(), cig_off), nm, span, okb
        blob = cig.tobytes()
        return ([blob[cig_off[i] : cig_off[i + 1]].decode("ascii")
                 for i in range(n)], nm, span, okb)
    # Python twin (no native lib: tests / fallback platforms)
    cigars: list[str] = []
    nm = np.full(n, -1, np.int32)
    span = np.zeros(n, np.int32)
    ok = np.zeros(n, bool)
    for i in range(n):
        dec = decode_dops_row(dops, int(cols[i]), int(lengths[i]),
                              genome, int(starts[i]), reads[i])
        if dec is None:
            cigars.append("")
            continue
        cigars.append(dec[0])
        nm[i], span[i], ok[i] = dec[1], dec[2], True
    if raw:
        blob = "".join(cigars).encode("ascii")
        off = np.zeros(n + 1, np.int64)
        np.cumsum([len(c) for c in cigars], out=off[1:])
        return (blob, off), nm, span, ok
    return cigars, nm, span, ok


# urmap_tpu/map/cigar.py:strand_codes_subset
def strand_codes_subset(raw_codes: np.ndarray, strand, lengths) -> np.ndarray:
    """Strand-applied codes for a row subset (reverse-complement the
    strand==1 rows in place of the originals)."""
    import types

    from urmap_tpu_torch.map.pipeline import revcomp_strand_codes

    shim = types.SimpleNamespace(
        mapped=np.ones(raw_codes.shape[0], bool),
        strand=np.asarray(strand), lengths=np.asarray(lengths))
    return revcomp_strand_codes(raw_codes, shim)


def _clip_mode(result, clip_open: int | None) -> int | None:
    """The clip mode to format ``result`` in: the one it was mapped in
    (MapResult.clip_open), which a caller's ``clip_open`` must name, if
    it names one; for a result that records none, the caller's."""
    if not hasattr(result, "clip_open"):
        return clip_open
    if clip_open is not None and clip_open != result.clip_open:
        raise ValueError(f"clip_open {clip_open}: the result was mapped "
                         f"with clip_open {result.clip_open}")
    return result.clip_open


# urmap_tpu/map/cigar.py:cigars_nm_blob
def cigars_nm_blob(genome: np.ndarray, raw_codes: np.ndarray, result,
                   sc: ScoreConfig, raw_lengths=None,
                   clip_open: int | None = None, clip_rows=None):
    """Native CIGAR/NM for a MapResult → (cig_blob bytes, cig_off
    int64[n+1], nm int32[n], span int32[n]) for the native SAM
    formatter, or None when the native library is unavailable. Takes
    the as-sequenced codes and reverse-complements only the gapped rows.

    The result is formatted in the clip mode it was mapped in
    (MapResult.clip_open; ValueError where ``clip_open`` names another):
    end to end, B6's records serve the gapped rows and the clip
    traceback's the clip-rescued ones (``clip_rows``); in clip mode
    (end_clip) the clip traceback's records serve every gapped row.
    Rows no record serves take the host DP in their mode.

    Traced (utils/trace.py) as ``urmap.cigars`` of the result's batch,
    with the children ``.replay`` (B6's records decoded),
    ``.clip_replay`` (the clip traceback's records decoded),
    ``.host_dp`` and ``.clip_dp`` (the host DP of the rows left, plain
    and clip mode), ``.interleave`` and ``.compose``; the counters
    ``rows.replay``, ``rows.clip_replay``, ``rows.replay_failed`` and
    ``rows.clip_replay_failed`` (decoded, then sent to the host DP),
    ``rows.host_dp`` and ``rows.clip_dp`` (each gapped row is in one of
    replay, clip_replay, host_dp, clip_dp).
    """
    from urmap_tpu_torch.io import native

    clip_open = _clip_mode(result, clip_open)
    lib = native.lib()
    if lib is None:
        return None
    with trace.span("urmap.cigars", trace.batch_of(result)):
        return _cigars_nm_blob(lib, genome, raw_codes, result, sc,
                               raw_lengths, clip_open, clip_rows)


def _cigars_nm_blob(lib, genome, raw_codes, result, sc, raw_lengths,
                    clip_open, clip_rows):
    import ctypes

    from urmap_tpu_torch.io import native

    n = len(result.mapped)
    L = result.lengths.astype(np.int64)
    mapped = result.mapped.astype(bool)
    gapped = mapped & result.gapped.astype(bool)
    denom = sc.match - sc.mismatch
    assert result.ungapped is not None, "device output lacks 'ungapped'"
    ung = result.ungapped.astype(np.int64)
    m_only = mapped & ~gapped
    nm = np.where(m_only, (L * sc.match - ung) // denom, -1).astype(np.int32)
    span = np.where(m_only, L, 0).astype(np.int32)

    tcig_blob = b""
    tcig_off = np.zeros(1, np.int64)
    rows = np.nonzero(gapped)[0]
    if rows.size:
        parts = []           # (sel-within-rows, blob, offs) per group
        handled = np.zeros(rows.size, bool)
        # device traceback records: O(L) replay for the rows the tb
        # pass (pipeline.tb_pass_device) and, for the clip-mode rows, the
        # clip traceback pass covered; stale/band-escaped/overflow rows
        # fall through to the DP below
        if clip_open is None:
            use, ti = _tb_select(result, rows, clip_rows)
            if use.size:
                with trace.span("urmap.cigars.replay"):
                    _keep_replayed(rows, use, *_tb_decode_rows(
                        genome, raw_codes, result, use, ti), nm, span,
                        parts, handled, "replay")
            crows = (rows[:0] if clip_rows is None
                     else rows[np.asarray(clip_rows, bool)[rows]])
        else:
            crows = rows            # end-clip: every gapped row
        use, ci = _clip_select(result, crows)
        if use.size:
            with trace.span("urmap.cigars.clip_replay"):
                dec = _clip_decode_rows(genome, raw_codes, result, use, ci)
                if dec is not None:
                    _keep_replayed(rows, use, *dec, nm, span, parts,
                                   handled, "clip_replay")
        groups = _clip_groups(result, sc, clip_open, clip_rows,
                              rows=rows[~handled])
        for grows, co in groups:
            if grows.size == 0:
                continue
            path = "host_dp" if co is None else "clip_dp"
            with trace.span(f"urmap.cigars.{path}"):
                trace.count(f"rows.{path}", int(grows.size))
                lens = np.asarray(result.lengths)[grows]
                sub = strand_codes_subset(raw_codes[grows],
                                          np.asarray(result.strand)[grows],
                                          lens)
                nat = traceback_batch_native(
                    genome, np.asarray(result.pos)[grows], sub, lens, sc,
                    raw=True, clip_open=co)
                if nat is None:
                    return None
                gblob, goff, nms_, scores_, spans_ = nat
                dev = np.asarray(result.score)[grows]
                # clip mode: the host DP at POS is a superset of the
                # banded device paths, so >=
                bad = np.nonzero((scores_ < dev) if co is not None
                                 else (scores_ != dev))[0]
                if bad.size:  # pragma: no cover - consistency
                    raise AssertionError(
                        f"native traceback score mismatch at rows "
                        f"{grows[bad[:5]]}")
                nm[grows] = nms_
                span[grows] = spans_
                sel = np.searchsorted(rows, grows)
                parts.append((sel, gblob, goff))
        if len(parts) == 1 and parts[0][0].size == rows.size:
            _, tcig_blob, tcig_off = parts[0]
        else:
            with trace.span("urmap.cigars.interleave"):
                # interleave the groups' blobs back into gapped-row order
                rowlen = np.zeros(rows.size, np.int64)
                for sel, gblob, goff in parts:
                    rowlen[sel] = np.diff(goff)
                tcig_off = np.zeros(rows.size + 1, np.int64)
                np.cumsum(rowlen, out=tcig_off[1:])
                buf = bytearray(int(tcig_off[-1]))
                for sel, gblob, goff in parts:
                    for j, r_ in enumerate(sel):
                        buf[tcig_off[r_] : tcig_off[r_ + 1]] = \
                            gblob[goff[j] : goff[j + 1]]
                tcig_blob = bytes(buf)

    with trace.span("urmap.cigars.compose"):
        mg = np.zeros(n, np.uint8)
        mg[m_only] = 1
        mg[gapped] = 2
        lens32 = np.ascontiguousarray(result.lengths, dtype=np.int32)
        strand32 = np.ascontiguousarray(result.strand, dtype=np.int32)
        raw32 = (None if raw_lengths is None
                 else np.ascontiguousarray(raw_lengths, dtype=np.int32))
        cap = 48 * n + len(tcig_blob) + 64
        while True:
            out = np.empty(cap, np.uint8)
            off = np.empty(n + 1, np.int64)
            wrote = lib.urmap_compose_cigars(
                n, lens32.ctypes.data_as(native.p_i32),
                raw32.ctypes.data_as(native.p_i32) if raw32 is not None
                else None,
                mg.ctypes.data_as(native.p_u8),
                strand32.ctypes.data_as(native.p_i32),
                tcig_blob, tcig_off.ctypes.data_as(native.p_i64),
                out.ctypes.data_as(ctypes.c_void_p), cap,
                off.ctypes.data_as(native.p_i64))
            if wrote >= 0:
                return out[:wrote].tobytes(), off, nm, span
            cap *= 2


# urmap_tpu/map/cigar.py:traceback, cigars_nm_fast, add_truncation_clips,
# cigars_for_result — the pure-Python CIGAR path of the paired SAM
# records (PairedMapper.format_py) and of pair._ref_spans
NEG = -(1 << 28)


def traceback(genome: np.ndarray, read: np.ndarray, start: int,
              sc: ScoreConfig, pad: int = 48,
              clip_open: int | None = None) -> tuple[str, int, int]:
    """Returns (cigar, score, nm) for the alignment of the read starting
    at genome position ``start``. nm = edit distance (SAM NM).

    ``clip_open``: end-clipped mode (map/dp.py banded_from_windows) —
    the alignment may begin at any read row (prefix soft-clipped, one
    clip_open charge, genome start stays exactly ``start``) and end at
    any read row (suffix clipped, one charge)."""
    g = genome[start : start + len(read) + pad].astype(np.int16)
    r = read.astype(np.int16)
    G, L = len(g), len(r)
    H = np.full((L + 1, G + 1), NEG, np.int32)
    E = np.full((L + 1, G + 1), NEG, np.int32)
    F = np.full((L + 1, G + 1), NEG, np.int32)
    open_, ext = sc.gap_open, sc.gap_extend
    H[0, 0] = 0
    j1 = np.arange(1, G + 1)
    for i in range(1, L + 1):
        if clip_open is not None and i >= 2:
            # start-clip state: read bases [0, i-1) clipped, genome at POS
            H[i - 1, 0] = max(int(H[i - 1, 0]), clip_open)
        E[i] = np.maximum(H[i - 1] + open_, E[i - 1] + ext)
        sub = np.where(g == r[i - 1], sc.match, sc.mismatch).astype(np.int32)
        diag = np.full(G + 1, NEG, np.int32)
        diag[1:] = H[i - 1, :-1] + sub
        T = np.maximum(diag, E[i])
        # F[i, j] = max_{k<j}(T[k] - (k+1)*ext) + open + j*ext
        runmax = np.maximum.accumulate(T - np.arange(1, G + 2) * ext)
        F[i, 1:] = runmax[:-1] + open_ + j1 * ext
        H[i] = np.maximum(T, F[i])
    iend, jend = L, int(np.argmax(H[L]))
    score = int(H[L, jend])
    if clip_open is not None:
        for i in range(1, L):
            # j ≥ 1: an end-clip must leave a non-empty aligned segment
            # (H[i, 0] holds the injected bare start-clip state)
            j = int(np.argmax(H[i, 1:])) + 1
            s = int(H[i, j]) + clip_open
            if s > score:
                score, iend, jend = s, i, j

    ops: list[str] = []
    i, j = iend, jend
    state = "H"
    while i > 0 or j > 0:
        if (clip_open is not None and state == "H" and j == 0
                and 0 < i < L and H[i, 0] == clip_open):
            # start-clip entry: bases [0, i) are soft-clipped
            ops.extend("S" * i)
            i = 0
            break
        if state == "H":
            if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + (
                sc.match if g[j - 1] == r[i - 1] else sc.mismatch
            ):
                ops.append("M" if g[j - 1] == r[i - 1] else "X")
                i -= 1; j -= 1
            elif i > 0 and H[i, j] == E[i, j]:
                state = "E"
            elif j > 0 and H[i, j] == F[i, j]:
                state = "F"
            else:  # pragma: no cover
                raise AssertionError(f"traceback failed at ({i},{j})")
        elif state == "E":
            ops.append("I")
            if H[i - 1, j] + open_ == E[i, j]:
                state = "H"
            i -= 1
        else:  # F
            ops.append("D")
            if H[i, j - 1] + open_ == F[i, j]:
                state = "H"
            j -= 1
    ops.reverse()
    if clip_open is not None and iend < L:
        ops.extend("S" * (L - iend))       # end-clip: bases [iend, L)
    s, e = 0, len(ops)
    while s < e and ops[s] == "I":
        ops[s] = "S"; s += 1
    while e > s and ops[e - 1] == "I":
        ops[e - 1] = "S"; e -= 1
    nm = sum(1 for op in ops if op in "XID")
    cigar_ops = ["M" if op == "X" else op for op in ops]
    out: list[str] = []
    prev, run = None, 0
    for op in cigar_ops:
        if op == prev:
            run += 1
        else:
            if prev is not None:
                out.append(f"{run}{prev}")
            prev, run = op, 1
    out.append(f"{run}{prev}")
    return "".join(out), score, nm


def cigars_nm_fast(genome: np.ndarray, strand_codes: np.ndarray, result,
                   sc: ScoreConfig, raw_lengths=None,
                   clip_open: int | None = None, clip_rows=None):
    """Vectorized CIGAR/NM for a MapResult (native-writer fast path).

    M-only winners (the vast majority) get "{L}M" and an NM derived from
    the device ungapped score — mm = (L·match − ung)/(match − mismatch) —
    with no genome gather; only gapped winners run the Python traceback.
    ``clip_rows``: per-row clip-rescue flags (those rows traceback in
    end-clip mode; see _clip_groups).

    Returns (cigars object-array[n], nm int32[n], ref_span int32[n]);
    unmapped entries hold ("", -1, 0).
    """
    n = len(result.mapped)
    L = result.lengths.astype(np.int64)
    mapped = result.mapped.astype(bool)
    gapped = result.gapped.astype(bool)
    denom = sc.match - sc.mismatch
    assert result.ungapped is not None, "device output lacks 'ungapped'"
    ung = result.ungapped.astype(np.int64)
    m_only = mapped & ~gapped
    nm = np.where(m_only, (L * sc.match - ung) // denom, -1).astype(np.int32)
    span = np.where(m_only, L, 0).astype(np.int32)
    cig = np.where(m_only, np.char.add(L.astype("U6"), "M"), "").astype(object)
    grows_all = np.nonzero(mapped & gapped)[0]
    handled = np.zeros(grows_all.size, bool)
    if clip_open is None and grows_all.size:
        use, ti = _tb_select(result, grows_all, clip_rows)
        if use.size:
            # ``strand_codes`` is already strand-applied here (this
            # entry point's contract) — replay directly
            tb = result.tb
            lens_u = np.asarray(result.lengths)[use]
            (cigs_u, nm_u, span_u, okd) = dops_decode_batch(
                tb["dops"], tb["cols"][ti], lens_u,
                genome, np.asarray(result.pos)[use], strand_codes[use])
            good = np.nonzero(okd)[0]
            for g in good:
                cig[use[g]] = cigs_u[g]
            nm[use[good]] = nm_u[good]
            span[use[good]] = span_u[good]
            handled[np.searchsorted(grows_all, use[good])] = True
    for rows, co in _clip_groups(result, sc, clip_open, clip_rows,
                                 rows=grows_all[~handled]):
        if rows.size == 0:
            continue
        nat = traceback_batch_native(
            genome, result.pos[rows], strand_codes[rows],
            result.lengths[rows], sc, clip_open=co)
        if nat is not None:
            cigs, nms_, scores_, spans_ = nat
            dev_s = np.asarray(result.score)[rows]
            bad = np.nonzero((scores_ < dev_s) if co is not None
                             else (scores_ != dev_s))[0]
            if bad.size:  # pragma: no cover - consistency
                raise AssertionError(
                    f"native traceback score mismatch at rows {rows[bad[:5]]}")
            for idx, i in enumerate(rows):
                cig[i] = cigs[idx]
            nm[rows] = nms_
            span[rows] = spans_
        else:
            from urmap_tpu_torch.io.sam import ref_consumed
            for i in rows:
                li = int(L[i])
                c, score, e = traceback(genome, strand_codes[i][:li],
                                        int(result.pos[i]), sc,
                                        clip_open=co)
                dev_i = int(result.score[i])
                if (score < dev_i if co is not None
                        else score != dev_i):  # pragma: no cover
                    raise AssertionError(
                        f"traceback score {score} != device "
                        f"{result.score[i]}")
                cig[i] = c
                nm[i] = e
                span[i] = ref_consumed(c)
    if raw_lengths is not None:
        add_truncation_clips(cig, result, raw_lengths)
    return cig, nm, span


def add_truncation_clips(cig, result, raw_lengths) -> None:
    """Reads longer than max_read_len were truncated for mapping; the
    unmapped tail must appear as a soft clip so CIGAR length == SEQ
    length (SAM v1.6 §1.4.6). Trailing S for forward alignments; the
    truncated tail of a reverse-complemented record is emitted FIRST,
    so leading S. Mutates ``cig`` in place."""
    raw = np.asarray(raw_lengths)
    extra = raw - np.asarray(result.lengths)
    for i in np.nonzero(result.mapped & (extra > 0))[0]:
        if result.strand[i]:
            cig[i] = f"{extra[i]}S" + cig[i]
        else:
            cig[i] = cig[i] + f"{extra[i]}S"


def cigars_for_result(genome: np.ndarray, reads_codes: np.ndarray,
                      result, sc: ScoreConfig, raw_lengths=None,
                      clip_open: int | None = None,
                      clip_rows=None) -> tuple[list[str], list[int]]:
    """CIGAR + NM per read for a MapResult. ``reads_codes`` must be
    strand-applied (rc already taken for strand==1 reads)."""
    cigars: list[str] = []
    nms: list[int] = []
    match, mis = sc.match, sc.mismatch
    for i in range(len(result.mapped)):
        L = int(result.lengths[i])
        if not result.mapped[i]:
            cigars.append("*"); nms.append(0)
            continue
        if not result.gapped[i]:
            cigars.append(f"{L}M")
            seg = genome[int(result.pos[i]) : int(result.pos[i]) + L]
            nms.append(int(np.sum(seg != reads_codes[i][:L])))
            continue
        co = clip_open
        if co is None and clip_rows is not None and clip_rows[i]:
            co = sc.clip_open   # clip-rescued row (MapResult.clipped)
        cigar, score, nm = traceback(
            genome, reads_codes[i][:L], int(result.pos[i]), sc,
            clip_open=co)
        dev_i = int(result.score[i])
        if (score < dev_i if co is not None
                else score != dev_i):  # pragma: no cover - consistency
            raise AssertionError(
                f"traceback score {score} != device score {result.score[i]}")
        cigars.append(cigar); nms.append(nm)
    if raw_lengths is not None:
        add_truncation_clips(cigars, result, raw_lengths)
    return cigars, nms
