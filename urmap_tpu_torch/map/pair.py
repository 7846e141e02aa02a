"""Paired-end pairing and mate rescue on top of the shared candidate
pipeline. A port of urmap_tpu/map/pair.py: the same stages, constants
and tie orders, so the output is bit-equal.

  1. Both mates of the pair batch ride one candidates_batch_device call
     (reads concatenated: rows [0, Bp) are mate 1, [Bp, 2Bp) mate 2).
  2. Concordance over the candidate cross-product: FR orientation,
     fragment length inside the configured window, pair score s1 + s2;
     best pair and the best pair at a distinct locus.
  3. Mate rescue for pairs with exactly one mapped mate and no
     concordant pair: the window where the mate is expected
     (``rescue_window`` bases, from the anchor's strand and the fragment
     window) is scanned for the best ungapped offset, which the banded
     DP (kernel B1) then verifies. Pairs in need are compacted into
     Dr = Bp // rescue_capacity_frac lanes per round; the reference's
     ``lax.while_loop`` is a host loop that reads its condition back.
  4. The traceback pass (kernel B6) runs once over both mates' winners.

MAPQ of proper pairs comes from the pair-score gap; discordant and
single mates keep the single-end formula; a rescued mate inherits the
anchor's, capped at RESCUE_MAPQ_CAP.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from urmap_tpu_torch import alphabet
from urmap_tpu_torch.config import (IndexConfig, MapConfig, ScoreConfig,
                                    resolve_suspect_deficits)
from urmap_tpu_torch.map.dp import NEG, banded_packed
from urmap_tpu_torch.kernels import rescue_rounds
from urmap_tpu_torch.map.pipeline import (PACKED_COLS, MapResult, _any,
                                          _nonzero_padded,
                                          candidates_batch_device, clip_mode,
                                          download,
                                          merge_tb_batches, pack_out,
                                          revcomp_batch,
                                          revcomp_strand_codes, tb_cols,
                                          tb_pass_device, tb_rows,
                                          unpack_out, unpack_tb, upload)
from urmap_tpu_torch.map.seed import POS_BIAS
from urmap_tpu_torch.map.select import host_scalar, select_hits
from urmap_tpu_torch.utils import trace

# A rescued mate's placement is inferred from the anchor, not seeded on
# its own: its MAPQ is capped here.
RESCUE_MAPQ_CAP = 30


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum of each row (jnp.argmax's tie order;
    torch.argmax promises none on a CUDA tensor)."""
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    return torch.where(x == x.amax(dim=-1, keepdim=True), idx, n) \
        .amin(dim=-1)


def _pair_cross(c1: dict, c2: dict, l1: torch.Tensor, l2: torch.Tensor,
                mc: MapConfig) -> dict:
    """Concordant-pair scoring over the candidate cross-product.

    c1/c2: candidate dicts (pos/score/strand/valid [B, C], span).
    Returns the best pair's candidate indexes i1/i2, its score, the
    best score at a distinct locus, and ``has``."""
    B, C = c1["pos"].shape
    s1 = torch.where(c1["valid"], c1["score"], NEG)[:, :, None]  # [B, C, 1]
    s2 = torch.where(c2["valid"], c2["score"], NEG)[:, None, :]  # [B, 1, C]
    p1 = c1["pos"][:, :, None]
    p2 = c2["pos"][:, None, :]
    st1 = c1["strand"][:, :, None]
    st2 = c2["strand"][:, None, :]

    fwd1 = st1 == 0
    pf = torch.where(fwd1, p1, p2)
    pr = torch.where(fwd1, p2, p1)
    if mc.end_clip or "span" not in c1:
        # clip-mode spans are meaningless: the read length stands in
        Lr = torch.where(fwd1, l2[:, None, None], l1[:, None, None])
    else:
        # aligned reference span of the rightmost mate (DP candidates:
        # lengths + d1 - d0; M-only candidates: the read length)
        Lr = torch.where(fwd1, c2["span"][:, None, :], c1["span"][:, :, None])
    # (pr - pf) first: positions are biased int32 and may sit near
    # INT32_MAX on a large genome; the difference is always small
    tlen = (pr - pf) + Lr
    ok = ((st1 != st2) & c1["valid"][:, :, None] & c2["valid"][:, None, :]
          & (pf <= pr) & (tlen >= mc.min_fragment_len)
          & (tlen <= mc.max_fragment_len))
    pscore = torch.where(ok, s1 + s2, NEG)

    flat = pscore.reshape(B, C * C)
    flat_pf = pf.reshape(B, C * C)
    best_idx = _first_argmax(flat)
    best = _take(flat, best_idx)
    best_pf = _take(flat_pf, best_idx)

    distinct = ((flat_pf - best_pf[:, None]).abs() > mc.max_read_len) \
        & (flat > NEG)
    second = torch.where(distinct, flat, NEG).amax(dim=-1)
    return {"i1": best_idx // C, "i2": best_idx % C, "score": best,
            "second": second, "has": best > NEG // 2}


def _rescue_scan(tables: dict, anchor_pos: torch.Tensor,
                 anchor_strand: torch.Tensor, anchor_len: torch.Tensor,
                 other_codes: torch.Tensor, other_len: torch.Tensor, *,
                 mc: MapConfig, sc: ScoreConfig) -> dict:
    """Windowed rescue: the offset with the most matching bases in the
    expected mate window, verified by the banded DP. ``other_codes``
    must already be strand-applied to the expected mate orientation
    (the reverse complement of the read as sequenced when the anchor is
    forward)."""
    from urmap_tpu_torch import genome_pack as gpk

    B, L = other_codes.shape
    W = mc.rescue_window
    O = W - L + 1

    slack = mc.band_halfwidth + 8
    # anchor fwd → mate (rc) right of it; anchor rc → mate (fwd) left
    win_start = torch.where(
        anchor_strand == 0,
        anchor_pos + mc.min_fragment_len - other_len - slack,
        anchor_pos + anchor_len - mc.max_fragment_len - slack,
    ).to(torch.int32)
    win = gpk.gather_codes(tables["ginter"], tables["base_off"],
                           win_start, W)                         # [B, W]

    # counts[b, o] = #{l : win[b, o+l] == read[b, l]}. Read pads are
    # READ_N (5) and genome N is 4, so pads and Ns never match.
    # win.unfold: [B, L, O] with [b, l, o] = win[b, l + o]
    counts = (win.unfold(1, O, 1) == other_codes[:, :, None]) \
        .sum(dim=1, dtype=torch.int32)                           # [B, O]
    best_off = _first_argmax(counts).to(torch.int32)
    # genome range in biased device coordinates (seed.POS_BIAS)
    cand = (win_start + best_off).clamp(-POS_BIAS,
                                        tables["genome_max_biased"])

    rp, rn = gpk.pack_reads(other_codes, other_len,
                            -(-L // gpk.BASES_PER_WORD))
    score, d0, ungapped, _span = banded_packed(
        tables["ginter"], tables["base_off"], cand, other_codes, other_len,
        rp, rn, hw=mc.band_halfwidth, sc=sc,
        clip_open=clip_mode(mc, sc))
    return {"pos": cand + d0, "score": score, "ungapped": ungapped}


def map_pairs_device(tables: dict, r1: torch.Tensor, l1: torch.Tensor,
                     r2: torch.Tensor, l2: torch.Tensor, *,
                     icfg: IndexConfig, mcfg: MapConfig, sc: ScoreConfig,
                     tb: bool = False, stats: dict | None = None,
                     gather_runner=None, dp_runner=None) -> dict:
    """One pair batch → {"m1", "m2": per-mate call dicts, "proper"} and,
    with ``tb``, ``_tb`` (tb_pass_device over both mates' winners, rows
    [0, B) mate 1 and [B, 2B) mate 2). r1/r2 uint8[B, L] read codes as
    sequenced (pad READ_N), l1/l2 int32[B]. ``stats``, when given, gets
    ``rescue_rounds`` added. ``gather_runner``, ``dp_runner``: the
    sharded routes' candidate stages (pipeline.candidates_batch_device);
    pairing, concordance and the rescue scan read the replicated genome
    and stay local."""
    B, L = r1.shape
    dev = r1.device
    reads = torch.cat([r1, r2], dim=0)
    lens = torch.cat([l1, l2], dim=0)
    c = candidates_batch_device(tables, reads, lens, icfg=icfg, mcfg=mcfg,
                                sc=sc, gather_runner=gather_runner,
                                dp_runner=dp_runner)
    words = c.pop("_words")
    # the pair path keeps the host clip-mode traceback for clip rows
    c.pop("_clip_rounds")
    c1 = {k: v[:B] for k, v in c.items()}
    c2 = {k: v[B:] for k, v in c.items()}

    # single-end selection per mate (fallback and anchors)
    se1 = select_hits(c1["pos"], c1["score"], c1["strand"], c1["valid"],
                      l1, c1["ungapped"], mc=mcfg, k=icfg.k)
    se2 = select_hits(c2["pos"], c2["score"], c2["strand"], c2["valid"],
                      l2, c2["ungapped"], mc=mcfg, k=icfg.k)

    pair = _pair_cross(c1, c2, l1, l2, mcfg)
    f32 = torch.float32
    frac = host_scalar(mcfg.min_score_frac, dev)

    def min_score(lengths):
        return torch.ceil(frac * lengths.to(f32)).to(torch.int32)

    p_s1 = _take(c1["score"], pair["i1"])
    p_s2 = _take(c2["score"], pair["i2"])
    proper = (pair["has"] & (p_s1 >= min_score(l1)) & (p_s2 >= min_score(l2))
              & (l1 >= icfg.k) & (l2 >= icfg.k))

    # float32 and round-half-to-even, as select_hits
    scale = host_scalar(mcfg.mapq_scale, dev)
    pair_gap = (pair["score"] - pair["second"]).to(f32)
    pair_mapq = torch.round(scale * pair_gap).clamp(0, mcfg.max_mapq) \
        .to(torch.int32)
    pair_mapq = torch.where(pair["second"] <= NEG // 2, mcfg.max_mapq,
                            pair_mapq)

    # ---- mate rescue (anchored on the mate that mapped alone) ----
    a1 = se1["mapped"] & ~se2["mapped"] & ~proper      # mate1 anchors mate2
    a2 = se2["mapped"] & ~se1["mapped"] & ~proper      # mate2 anchors mate1
    any_anchor = a1 | a2
    anchor_pos = torch.where(a1, se1["pos"], se2["pos"])
    anchor_strand = torch.where(a1, se1["strand"], se2["strand"])
    anchor_len = torch.where(a1, l1, l2)
    other_len = torch.where(a1, l2, l1)
    # the rescued mate is expected on the strand opposite to the
    # anchor's: strand-applied (genome-forward) codes for the scan
    other_as_seq = torch.where(a1[:, None], r2, r1)
    other_rc = torch.where(a1[:, None], revcomp_batch(r2, l2),
                           revcomp_batch(r1, l1))
    exp_strand = 1 - anchor_strand
    other_codes = torch.where((exp_strand == 1)[:, None], other_rc,
                              other_as_seq)
    # bucketed rescue rounds: each serves the first Dr unserved pairs
    # until none remain (zero rounds when nothing needs a rescue). Fill
    # lanes alias row 0 with the anchor position forced to 0; ``do``
    # keeps them from writing.
    Dr = max(B // mcfg.rescue_capacity_frac, 1)
    r_pos = torch.zeros(B, dtype=torch.int32, device=dev)
    r_score = torch.full((B,), NEG, dtype=torch.int32, device=dev)
    r_ung = r_score.clone()
    served = torch.zeros(B, dtype=torch.bool, device=dev)
    rounds = 0
    while _any(any_anchor & ~served, "rescue"):
        rem = any_anchor & ~served
        idx = _nonzero_padded(rem, Dr)
        do = rem[idx]
        sub = _rescue_scan(tables, torch.where(do, anchor_pos[idx], 0),
                           anchor_strand[idx], anchor_len[idx],
                           other_codes[idx], other_len[idx], mc=mcfg, sc=sc)
        r_pos[idx] = torch.where(do, sub["pos"], r_pos[idx])
        r_score[idx] = torch.where(do, sub["score"], r_score[idx])
        r_ung[idx] = torch.where(do, sub["ungapped"], r_ung[idx])
        served[idx] = served[idx] | do
        rounds += 1
    rescue_rounds.add(rounds)
    if stats is not None:
        stats["rescue_rounds"] = stats.get("rescue_rounds", 0) + rounds
    resc = {"pos": r_pos, "score": r_score, "ungapped": r_ung}
    resc_ok = any_anchor & (resc["score"] >= min_score(other_len)) \
        & (other_len >= icfg.k)
    anchor_mapq = torch.where(a1, se1["mapq"], se2["mapq"])
    resc_mapq = anchor_mapq.clamp(max=RESCUE_MAPQ_CAP)

    # ---- final per-mate fields ----
    def mate_out(se, cm, idx, is_first):
        """The paired candidate when proper, else the rescue, else the
        single-end call."""
        p_pos = _take(cm["pos"], idx)
        p_strand = _take(cm["strand"], idx)
        p_score = _take(cm["score"], idx)
        p_ung = _take(cm["ungapped"], idx)
        my_weak = c1["weak"] if is_first else c2["weak"]
        other_weak = c2["weak"] if is_first else c1["weak"]
        rescued = resc_ok & (a1 if not is_first else a2)
        mapped = proper | se["mapped"] | rescued
        pos = torch.where(proper, p_pos,
                          torch.where(rescued, resc["pos"], se["pos"]))
        strand = torch.where(proper, p_strand,
                             torch.where(rescued, exp_strand, se["strand"]))
        score = torch.where(proper, p_score,
                            torch.where(rescued, resc["score"], se["score"]))
        gapped = torch.where(proper, p_ung < p_score,
                             torch.where(rescued,
                                         resc["ungapped"] < resc["score"],
                                         se["gapped"]))
        ung = torch.where(proper, p_ung,
                          torch.where(rescued, resc["ungapped"],
                                      se["ungapped"]))
        mapq = torch.where(proper, torch.maximum(se["mapq"], pair_mapq),
                           torch.where(rescued, resc_mapq, se["mapq"]))
        # weak-fallback mate (no candidate reached the vote floor): in
        # a proper pair whose other mate is not weak the fragment
        # constraint restores rescue-grade confidence; otherwise the
        # hard cap
        wcap = torch.where(proper & ~other_weak, RESCUE_MAPQ_CAP,
                           mcfg.weak_mapq_cap).to(torch.int32)
        mapq = torch.where(my_weak, torch.minimum(mapq, wcap), mapq)
        mapq = torch.where(mapped, mapq, 0)
        # proper and single winners of a clip-rescued read carry
        # clip-mode scores; window-rescued mates use the plain DP
        return {
            "mapped": mapped,
            "pos": pos,
            "strand": strand,
            "score": score,
            "second": se["second"],
            "mapq": mapq,
            "gapped": mapped & gapped,
            "ungapped": ung,
            "clipped": mapped & cm["clipped"] & ~rescued,
        }

    out1 = mate_out(se1, c1, pair["i1"], is_first=True)
    out2 = mate_out(se2, c2, pair["i2"], is_first=False)

    # ---- suspect gate, per mate (pipeline.map_batch_device) ----
    # raw suspicion = saturated evidence and a final score trailing
    # perfect by more than the gate. A window-rescued mate has no seed
    # evidence of its own and inherits the anchor's suspicion. A suspect
    # mate in a proper pair with a clean other mate keeps rescue-grade
    # confidence and is not flagged for a re-map.
    def1 = l1 * sc.match - out1["score"]
    def2 = l2 * sc.match - out2["score"]
    sat1 = c1["nsat"] > 0
    sat2 = c2["nsat"] > 0
    sus_d, remap_d = resolve_suspect_deficits(mcfg, sc)
    raw1, rm1 = sat1 & (def1 > sus_d), sat1 & (def1 > remap_d)
    raw2, rm2 = sat2 & (def2 > sus_d), sat2 & (def2 > remap_d)
    resc1 = resc_ok & a2          # mate1 was rescued off mate2's anchor
    resc2 = resc_ok & a1
    eff1 = torch.where(resc1, raw2, raw1)
    eff2 = torch.where(resc2, raw1, raw2)
    effr1 = torch.where(resc1, rm2, rm1)
    effr2 = torch.where(resc2, rm1, rm2)
    for out, eff, other_eff, effr, other_effr in (
            (out1, eff1, eff2, effr1, effr2),
            (out2, eff2, eff1, effr2, effr1)):
        # clip-rescued mates are left out, as in the single-end gate
        sus = out["mapped"] & eff & ~out["clipped"]
        cap = torch.where(proper & ~other_eff, RESCUE_MAPQ_CAP,
                          mcfg.suspect_mapq_cap).to(torch.int32)
        out["mapq"] = torch.where(sus, torch.minimum(out["mapq"], cap),
                                  out["mapq"])
        out["suspect"] = (out["mapped"] & effr & ~out["clipped"]
                          & ~(proper & ~other_effr))

    res = {"m1": out1, "m2": out2, "proper": proper | resc_ok}
    if tb:
        # one traceback pass over both mates' final winners: proper,
        # rescued and single alike, since the pass re-anchors at
        # whatever POS won
        pos2 = torch.cat([out1["pos"], out2["pos"]])
        strand2 = torch.cat([out1["strand"], out2["strand"]])
        gsel = torch.cat([o["mapped"] & o["gapped"] & ~o["clipped"]
                          for o in (out1, out2)])
        res["_tb"] = tb_pass_device(tables, pos2, strand2, lens, gsel,
                                    *words, L=L, mcfg=mcfg, sc=sc)
    return res


def map_pairs_packed(tables: dict, pk1, nm1, l1, pk2, nm2, l2, *,
                     icfg: IndexConfig, mcfg: MapConfig, sc: ScoreConfig,
                     tb: bool = False, stats: dict | None = None,
                     gather_runner=None, dp_runner=None) -> torch.Tensor:
    """The paired step from the packed upload blocks
    (genome_pack.pack_read_codes_host) to ONE int32 array, as the
    reference's make_map_pairs_fn builds it: [Bp, 2*PACKED_COLS + 1]
    (mate 1's pack_out columns, mate 2's, then proper); with ``tb``
    flattened and followed by the flattened traceback matrix, so a
    batch costs one device-to-host copy. ``gather_runner``,
    ``dp_runner``: see map_pairs_device."""
    from urmap_tpu_torch import genome_pack as gpk

    L = mcfg.max_read_len
    nw = -(-L // gpk.BASES_PER_WORD)
    r1 = gpk.unpack_words_to_codes(
        *gpk.read_words_from_upload(pk1, nm1, l1, nw), L)
    r2 = gpk.unpack_words_to_codes(
        *gpk.read_words_from_upload(pk2, nm2, l2, nw), L)
    out = map_pairs_device(tables, r1, l1, r2, l2, icfg=icfg, mcfg=mcfg,
                           sc=sc, tb=tb, stats=stats,
                           gather_runner=gather_runner, dp_runner=dp_runner)
    packed = torch.cat([pack_out(out["m1"]), pack_out(out["m2"]),
                        out["proper"].to(torch.int32)[:, None]], dim=1)
    if tb:
        return torch.cat([packed.reshape(-1), out["_tb"].reshape(-1)])
    return packed


# urmap_tpu/map/pair.py:PairResult
@dataclass
class PairResult:
    m1: MapResult
    m2: MapResult
    proper: np.ndarray  # bool[B]


class PairedMapper:
    """Host wrapper over the single-end Mapper for paired batches, with
    the surface of urmap_tpu.map.pair.PairedMapper.

    Device pair batches are half the configured read batch: the paired
    step stacks both mates and both strands ([4*Bp] rows against the
    single-end step's [2*B]), so equal rows per call keep the per-read
    cost alike. The device, tables, configs and the traceback switch are
    the wrapped mapper's."""

    def __init__(self, mapper):
        self.mapper = mapper
        self.index = mapper.index
        self.mcfg = mapper.mcfg
        self.sc = mapper.sc
        self.device = mapper.device
        self.pair_batch = max(1, self.mcfg.batch_size // 2)
        # one source of truth (pipeline.tb_enabled through the mapper):
        # finish_batch splits the flattened output by it
        self.tb = mapper.tb
        # both mates' results record the mapper's clip mode; under
        # end_clip their clip rows keep the host clip DP (the pair path
        # runs no clip traceback)
        self.clip_open = mapper.clip_open
        self.stats = {"rescue_rounds": 0, "batches": 0}

    def prepack(self, codes1, lengths1, codes2, lengths2):
        """Host upload prep (pad + 2-bit pack) for start_batch's
        ``prepacked``; safe to run off the dispatch thread."""
        from urmap_tpu_torch.genome_pack import pack_read_codes_host

        B = codes1.shape[0]
        bs = self.pair_batch
        if B > bs:
            raise ValueError(f"pair batch {B} > {bs} (= batch_size // 2)")
        c1, l1 = _pad_block(codes1, lengths1, bs, self.mcfg.max_read_len)
        c2, l2 = _pad_block(codes2, lengths2, bs, self.mcfg.max_read_len)
        pk1, nm1 = pack_read_codes_host(c1)
        pk2, nm2 = pack_read_codes_host(c2)
        return (pk1, nm1, l1, pk2, nm2, l2, B)

    def start_batch(self, codes1, lengths1, codes2, lengths2, *,
                    prepacked=None):
        """Map one (<= pair_batch) pair batch; returns a handle for
        finish_batch. Device work is queued on the current stream. The
        batch's id (tracing on, utils/trace.py) rides the handle."""
        batch = trace.new_batch()
        with trace.span("urmap.start_batch", batch):
            *blocks, B = (prepacked if prepacked is not None
                          else self.prepack(codes1, lengths1, codes2,
                                            lengths2))
            out = map_pairs_packed(self.mapper.tables,
                                   *(upload(a, self.device) for a in blocks),
                                   icfg=self.mapper.icfg, mcfg=self.mcfg,
                                   sc=self.sc, tb=self.tb, stats=self.stats)
            self.stats["batches"] += 1
        return out, B, batch

    def finish_batch(self, handle, lengths1, lengths2) -> PairResult:
        out, B, batch = handle
        with trace.span("urmap.finish_batch", batch):
            arr = download(out)
            with trace.span("urmap.unpack"):
                res = self._unpack(arr, B, lengths1, lengths2)
        res.m1.batch = res.m2.batch = batch
        return res

    def _unpack(self, arr, B, lengths1, lengths2) -> PairResult:
        tbmat = None
        Bp = self.pair_batch
        C = PACKED_COLS
        if self.tb:
            split = Bp * (2 * C + 1)
            tbmat = arr[split:].reshape(tb_rows(self.mcfg),
                                        tb_cols(2 * Bp, self.mcfg))
            arr = arr[:split].reshape(Bp, 2 * C + 1)
        arr = arr[:B]
        res = PairResult(
            m1=MapResult.from_device(unpack_out(arr[:, 0:C]),
                                     np.asarray(lengths1)[:B],
                                     self.clip_open),
            m2=MapResult.from_device(unpack_out(arr[:, C : 2 * C]),
                                     np.asarray(lengths2)[:B],
                                     self.clip_open),
            proper=arr[:, 2 * C].astype(bool),
        )
        if tbmat is not None:
            # rows [0, Bp) = mate 1, [Bp, 2Bp) = mate 2 (Bp = the PADDED
            # pair batch the device step ran at); both mates' dicts
            # share one dops matrix, filtered by their own rows/cols
            tb = unpack_tb(tbmat, self.mcfg.band_halfwidth,
                           self.mcfg.max_read_len)
            s1 = tb["rows"] < Bp

            def side(sel, base):
                return {"rows": tb["rows"][sel] - base,
                        "score": tb["score"][sel],
                        "pos": tb["pos"][sel],
                        "strand": tb["strand"][sel],
                        "cols": tb["cols"][sel],
                        "dops": tb["dops"], "hw": tb["hw"],
                        "L": tb["L"]}

            res.m1.tb = side(s1, 0)
            res.m2.tb = side(~s1, Bp)
        return res

    def second_pass(self, codes1, lengths1, codes2, lengths2,
                    res: PairResult) -> PairResult:
        """Per-mate wide-gather recovery (pipeline.Mapper.second_pass,
        on the host CPU): mates still unmapped or suspect after pairing
        and rescue are re-mapped, then every pair a re-map moved has its
        concordance re-derived (_recheck_pairs): a recovered mate in FR
        orientation inside the fragment window makes its pair proper,
        a moved mate that breaks a proper pair demotes it. ``res``
        unchanged when the wrapped mapper has no second pass."""
        with trace.span("urmap.second_pass", trace.batch_of(res)):
            if getattr(self.mapper, "second", None) is None:
                return res
            sp = self.mapper.second_pass

            def snap(m):
                return (m.mapped.copy(), m.pos.copy(), m.strand.copy())

            s1, s2 = snap(res.m1), snap(res.m2)
            res = PairResult(m1=sp(codes1, lengths1, res.m1),
                             m2=sp(codes2, lengths2, res.m2),
                             proper=res.proper)

            def moved(m, s):
                return ((m.mapped != s[0]) | (m.pos != s[1])
                        | (m.strand != s[2]))

            touched = moved(res.m1, s1) | moved(res.m2, s2)
            if touched.any():
                self._recheck_pairs(codes1, codes2, res, touched)
            return res

    def _recheck_pairs(self, codes1, codes2, res: PairResult,
                       touched: np.ndarray) -> None:
        """Host-side concordance re-derivation for the ``touched`` pairs
        of a result whose mates were patched after the device step: the
        device rule (_pair_cross) — opposite strands, forward mate
        leftmost, TLEN = (pr - pf) + reference span of the rightmost
        mate inside [min_fragment_len, max_fragment_len], spans as in
        the emitted SAM. Sets ``proper`` for every touched pair."""
        res.proper[touched & ~(res.m1.mapped & res.m2.mapped
                               & (res.m1.strand != res.m2.strand))] = False
        rows = np.nonzero(touched
                          & res.m1.mapped & res.m2.mapped
                          & (res.m1.strand != res.m2.strand))[0]
        if rows.size == 0:
            return
        mc = self.mcfg
        p1 = res.m1.pos[rows].astype(np.int64)
        p2 = res.m2.pos[rows].astype(np.int64)
        fwd1 = res.m1.strand[rows] == 0
        pf = np.where(fwd1, p1, p2)
        pr = np.where(fwd1, p2, p1)
        if mc.end_clip:
            lr = np.where(fwd1, res.m2.lengths[rows],
                          res.m1.lengths[rows]).astype(np.int64)
        else:
            s1 = _ref_spans(self.index.seqdb.codes, codes1, res.m1,
                            rows, self.sc)
            s2 = _ref_spans(self.index.seqdb.codes, codes2, res.m2,
                            rows, self.sc)
            lr = np.where(fwd1, s2, s1).astype(np.int64)
        tlen = (pr - pf) + lr
        ok = ((pf <= pr) & (tlen >= mc.min_fragment_len)
              & (tlen <= mc.max_fragment_len))
        res.proper[rows] = ok

    def map_pair_codes(self, codes1, lengths1, codes2,
                       lengths2) -> PairResult:
        B = codes1.shape[0]
        bs = self.pair_batch
        outs = []
        for s in range(0, B, bs):
            h = self.start_batch(codes1[s:s + bs], lengths1[s:s + bs],
                                 codes2[s:s + bs], lengths2[s:s + bs])
            outs.append(self.second_pass(
                codes1[s:s + bs], lengths1[s:s + bs],
                codes2[s:s + bs], lengths2[s:s + bs],
                self.finish_batch(h, lengths1[s:s + bs],
                                  lengths2[s:s + bs])))
        if len(outs) == 1:
            return outs[0]

        def cat_result(results, lengths):
            fields = {f: np.concatenate([getattr(r, f) for r in results])
                      for f in ("mapped", "pos", "strand", "score", "second",
                                "mapq", "gapped", "ungapped", "clipped",
                                "suspect")}
            res = MapResult(lengths=np.asarray(lengths)[:B],
                            clip_open=self.clip_open, **fields)
            res.tb = merge_tb_batches([r.tb for r in results],
                                      range(0, B, bs))
            return res

        return PairResult(
            m1=cat_result([o.m1 for o in outs], lengths1),
            m2=cat_result([o.m2 for o in outs], lengths2),
            proper=np.concatenate([o.proper for o in outs])[:B],
        )

    def format_py(self, fwd_batch, rev_batch, res: PairResult) -> list[str]:
        """Pure-Python SAM records for an already-mapped pair batch."""
        from urmap_tpu_torch.io import sam as samio
        from urmap_tpu_torch.map.cigar import cigars_for_result

        genome = self.index.seqdb.codes
        sc1 = revcomp_strand_codes(fwd_batch.codes, res.m1)
        sc2 = revcomp_strand_codes(rev_batch.codes, res.m2)
        cig1, nm1 = cigars_for_result(
            genome, sc1, res.m1, self.sc,
            raw_lengths=[len(sq) for sq in fwd_batch.seqs],
            clip_open=res.m1.clip_open, clip_rows=res.m1.clipped)
        cig2, nm2 = cigars_for_result(
            genome, sc2, res.m2, self.sc,
            raw_lengths=[len(sq) for sq in rev_batch.seqs],
            clip_open=res.m2.clip_open, clip_rows=res.m2.clipped)
        return samio.records_paired(fwd_batch, rev_batch, res,
                                    cig1, nm1, cig2, nm2, self.index.seqdb)

    def map_pairs_to_sam(self, fwd_batch, rev_batch):
        """ReadBatch pair → (SAM record lines, stats dict)."""
        res = self.map_pair_codes(fwd_batch.codes, fwd_batch.lengths,
                                  rev_batch.codes, rev_batch.lengths)
        recs = self.format_py(fwd_batch, rev_batch, res)
        stats = {
            "reads": 2 * len(fwd_batch),
            "mapped": int(res.m1.mapped.sum()) + int(res.m2.mapped.sum()),
            "proper_pairs": int(res.proper.sum()),
        }
        return recs, stats


# urmap_tpu/map/pair.py:_ref_spans
def _ref_spans(genome, codes, res: MapResult, rows: np.ndarray,
               sc: ScoreConfig) -> np.ndarray:
    """Reference spans of ``rows`` of a MapResult, matching the emitted
    SAM: read length for M-only winners, CIGAR ref span (traceback) for
    gapped/clip-rescued ones. Used by the post-second-pass proper-pair
    promotion; volumes are tiny (a few % of pairs), so the per-row
    traceback cost is negligible."""
    from urmap_tpu_torch.map.cigar import cigars_nm_fast, strand_codes_subset

    lengths = np.asarray(res.lengths)[rows].astype(np.int32)
    span = lengths.copy()
    need = np.asarray(res.gapped)[rows].astype(bool)
    if res.clipped is not None:
        need |= np.asarray(res.clipped)[rows].astype(bool)
    g = rows[need]
    if g.size == 0:
        return span
    sub = MapResult(
        lengths=np.asarray(res.lengths)[g],
        mapped=np.asarray(res.mapped)[g], pos=np.asarray(res.pos)[g],
        strand=np.asarray(res.strand)[g], score=np.asarray(res.score)[g],
        second=np.asarray(res.second)[g], mapq=np.asarray(res.mapq)[g],
        gapped=np.asarray(res.gapped)[g],
        ungapped=np.asarray(res.ungapped)[g],
        clipped=(np.asarray(res.clipped)[g]
                 if res.clipped is not None else None))
    sc_codes = strand_codes_subset(codes[g], sub.strand, sub.lengths)
    _, _, sp = cigars_nm_fast(genome, sc_codes, sub, sc,
                              clip_rows=sub.clipped)
    span[need] = sp
    return span


def _pad_block(codes, lengths, bs, max_len=None):
    """Pad rows to ``bs`` and (when max_len is given) columns to
    ``max_len`` with READ_N; the lengths mask everything."""
    Lm = codes.shape[1] if max_len is None else max_len
    if codes.shape[1] > Lm:
        raise ValueError(f"read block width {codes.shape[1]} > "
                         f"max_read_len {Lm}")
    if codes.shape[0] == bs and codes.shape[1] == Lm:
        return codes, lengths.astype(np.int32)
    pad = bs - codes.shape[0]
    block = np.full((bs, Lm), alphabet.READ_N, np.uint8)
    block[: codes.shape[0], : codes.shape[1]] = codes
    lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
    return block, lengths.astype(np.int32)
