"""Clip-mode traceback of the clip-rescued gapped winners: the plain
PyTorch version.

The CUDA kernel (csrc/clip_tb.cu, wrapper kernels/clip_tb.py) computes
the same outputs bit for bit. Both run the host's clip-mode traceback,
``urmap_traceback_batch(use_clip=1)`` in io/native/codecs.cpp, over its
whole window: no band. Per winner, the read (strand applied, L_i
bases) against the genome from POS, ``width`` bases (``L_i + 48``,
clamped at the genome's end, as the host clamps it), in a matrix of
``L_i + 1`` rows by ``width + 1`` columns:

  - H[0, 0] = 0, the rest of row 0 NEG; E from the row above, F along
    the row as ``max_{k<j}(T[k] - (k+1)*ext) + open + j*ext`` (T the
    diagonal and E maximum; the host's sequential F gives the same
    values while gap_open <= gap_extend);
  - after each row ii in 1..L_i-1, column 0 is raised to ``clip_open``
    (the start-clip state: read bases [0, ii) soft-clipped);
  - the free end is the first maximum of row L_i (column 0 included);
    an end clip after row ii in 1..L_i-1 (columns >= 1) wins only with
    a score plus ``clip_open`` strictly above it, the earliest row and
    column on ties.

Every cell of rows 1..L_i keeps a 4-bit code of how the host's walk
leaves it, in its tie order:

  bits 0-1  hc: column >= 1: 0 diagonal, 1 E, 2 F (diag > E > F);
            column 0: 0 the start-clip entry, 1 E, 3 none
  bit  2    ee: E stays in the gap (H above + open != E)
  bit  3    fe: F stays in the gap (H left + open != F, H left after
            the column-0 injection, as the host reads it)

The walk from the end emits one record byte per read row, ``d | I << 6
| S << 7`` (d the deletions after the row's op, I an insertion, S a
soft-clipped row, neither a diagonal step), four per int32 word, row i
at byte i % 4 of word i // 4 (map.tb.dops_words rows). A path the
records cannot hold (a deletion run past 63, a walk that leaves the
matrix) has ``ok`` 0 and all-zero records; so have a length outside
1..L and a width below 1.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.config import ScoreConfig
from urmap_tpu_torch.map.tb import dops_words

NEGV = -(1 << 28)        # the host DP's fill (codecs.cpp NEGV)
LOW = -(1 << 30)         # below every score: the scans' identity
PAD = 48                 # window bases past the read (cigar.py's pad)
REC_I, REC_S = 0x40, 0x80
MAX_DEL = 63


def clip_tb_from_windows(windows: torch.Tensor, reads: torch.Tensor,
                         lengths: torch.Tensor, widths: torch.Tensor, *,
                         sc: ScoreConfig, clip_open: int):
    """windows uint8[N, L + 48] (genome from POS), reads uint8[N, L]
    (strand applied), lengths int32[N], widths int32[N] (the window's
    real width) → (score int32[N], recs int32[DWp, N], ok bool[N])."""
    N, L = reads.shape
    dev = reads.device
    W1 = L + PAD + 1
    i32 = torch.int32
    open_, ext = sc.gap_open, sc.gap_extend
    lens = lengths.to(i32)
    wid = widths.to(i32).clamp(max=L + PAD)
    live = (lens >= 1) & (lens <= L) & (wid >= 1)
    col = torch.arange(W1, dtype=i32, device=dev)[None, :]
    cext = (col + 1) * ext
    fpost = open_ + col[:, 1:] * ext
    in_win = col <= wid[:, None]
    win = windows.to(i32)
    rd = reads.to(i32)

    H = torch.where(col == 0, 0, NEGV).to(i32).expand(N, W1).contiguous()
    E = torch.full((N, W1), NEGV, dtype=i32, device=dev)
    codes = torch.zeros((N, L + 1, W1), dtype=torch.uint8, device=dev)
    last_v = torch.full((N,), LOW, dtype=i32, device=dev)
    last_j = torch.zeros(N, dtype=i32, device=dev)
    clip_v = torch.full((N,), LOW, dtype=i32, device=dev)
    clip_i = torch.zeros(N, dtype=i32, device=dev)
    clip_j = torch.zeros(N, dtype=i32, device=dev)
    for ii in range(1, L + 1):
        sub = torch.where(win == rd[:, ii - 1 : ii], sc.match,
                          sc.mismatch).to(i32)
        eo = H + open_
        En = torch.maximum(eo, E + ext)
        ee = (eo != En).to(i32)
        D = H[:, :-1] + sub
        T = torch.cat([En[:, :1], torch.maximum(D, En[:, 1:])], dim=1)
        run = torch.cummax(T - cext, dim=1).values
        F = run[:, :-1] + fpost
        Hn = torch.cat([En[:, :1], torch.maximum(T[:, 1:], F)], dim=1)
        hc = torch.where(Hn[:, 1:] == D, 0,
                         torch.where(Hn[:, 1:] == En[:, 1:], 1, 2))
        # column 0: the start-clip state after rows 1..L_i-1
        inject = ii <= lens - 1
        h0 = torch.where(inject & (Hn[:, 0] < clip_open), clip_open,
                         Hn[:, 0])
        Hn = torch.cat([h0[:, None], Hn[:, 1:]], dim=1)
        hc0 = torch.where(inject & (h0 == clip_open), 0,
                          torch.where(h0 == En[:, 0], 1, 3))
        fe = (F != Hn[:, :-1] + open_).to(i32)
        code = torch.cat([hc0[:, None], hc | (fe << 3)], dim=1) | (ee << 2)
        codes[:, ii] = code.to(torch.uint8)
        # the end-clip scan: rows 1..L_i-1, columns 1..width
        v = torch.where(in_win[:, 1:], Hn[:, 1:], LOW)
        rv, rj = v.max(dim=1)              # first maximum
        upd = inject & (rv > clip_v)
        clip_v = torch.where(upd, rv, clip_v)
        clip_i = torch.where(upd, ii, clip_i)
        clip_j = torch.where(upd, rj.to(i32) + 1, clip_j)
        # the free end: row L_i, columns 0..width
        at_end = ii == lens
        v = torch.where(in_win, Hn, LOW)
        rv, rj = v.max(dim=1)
        last_v = torch.where(at_end, rv, last_v)
        last_j = torch.where(at_end, rj.to(i32), last_j)
        H, E = Hn, En

    use_clip = (clip_v > LOW) & (clip_v + clip_open > last_v)
    score = torch.where(use_clip, clip_v + clip_open, last_v)
    iend = torch.where(use_clip, clip_i, lens)
    jend = torch.where(use_clip, clip_j, last_j)
    recs, ok = _walk(codes, lens, iend, jend, live, L)
    score = torch.where(live, score, 0)
    return score, recs, ok


def _walk(codes, lens, iend, jend, live, L):
    """The host walk over the codes, all winners in step → (recs
    int32[DWp, N], ok bool[N])."""
    N = codes.shape[0]
    dev = codes.device
    i32 = torch.int32
    rows = torch.arange(L, dtype=i32, device=dev)[None, :]
    rec = torch.where((rows >= iend[:, None]) & (rows < lens[:, None]),
                      REC_S, 0).to(i32)
    lane = torch.arange(N, device=dev)
    ii = torch.where(live, iend, 0).clone()
    j = torch.where(live, jend, 0).clone()
    st = torch.zeros(N, dtype=i32, device=dev)     # 0 H, 1 E, 2 F
    dcnt = torch.zeros(N, dtype=i32, device=dev)
    fail = ~live
    act = live & ((ii > 0) | (j > 0))
    while bool(act.any()):
        fail = fail | (act & (ii == 0))            # row 0 beyond (0, 0)
        act = act & ~fail
        c = codes[lane, ii.clamp(min=0).long(), j.clamp(min=0).long()] \
            .to(i32)
        hc = c & 3
        inH, inE, inF = act & (st == 0), act & (st == 1), act & (st == 2)
        entry = inH & (j == 0) & (hc == 0)
        diag = inH & (j > 0) & (hc == 0)
        toE = inH & (hc == 1)
        toF = inH & (j > 0) & (hc == 2)
        bad = inH & ~(entry | diag | toE | toF)
        emit = diag | inE | entry
        bad = bad | (emit & (dcnt > MAX_DEL)) | (inF & (j == 0))
        op = torch.where(inE, REC_I, torch.where(entry, REC_S, 0)).to(i32)
        r = (ii - 1).clamp(min=0).long()
        old = rec[lane, r]
        rec[lane, r] = torch.where(emit & ~bad, op | dcnt, old)
        # start-clip entry: rows [0, ii) are S (the last one set above)
        rec = torch.where(entry[:, None] & (rows < ii[:, None] - 1), REC_S,
                          rec)
        dcnt = torch.where(emit, 0, torch.where(inF, dcnt + 1, dcnt))
        st = torch.where(toE, 1, torch.where(toF, 2, st))
        st = torch.where(inE & (((c >> 2) & 1) == 0), 0, st)
        st = torch.where(inF & (((c >> 3) & 1) == 0), 0, st)
        ii = torch.where(diag | inE, ii - 1, ii)
        ii = torch.where(entry, 0, ii)
        j = torch.where(diag | inF, j - 1, j)
        j = torch.where(entry, 0, j)
        fail = fail | bad
        act = act & ~bad & ((ii > 0) | (j > 0))
    ok = ~fail
    rec = torch.where(ok[:, None], rec, 0)
    DW = -(-L // 4)
    pad = torch.zeros((N, DW * 4 - L), dtype=i32, device=dev)
    rec4 = torch.cat([rec, pad], dim=1).reshape(N, DW, 4)
    sh = (torch.arange(4, dtype=torch.int64, device=dev) * 8)[None, None, :]
    w64 = (rec4.to(torch.int64) << sh).sum(dim=2)
    # bit 31 set (an S record at byte 3): the int32 with the same bits
    words = torch.where(w64 >= 1 << 31, w64 - (1 << 32), w64).to(i32)
    out = torch.zeros((dops_words(L), N), dtype=i32, device=dev)
    out[:DW] = words.T
    return out, ok
