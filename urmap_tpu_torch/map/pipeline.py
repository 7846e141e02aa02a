"""The per-batch single-end mapping pipeline and the ``Mapper``.

One batch, both strands in one [2B] block:

    upload words ──┬─ fwd ─┐
                   └─ rc ──┴→ seed slots (B3) → CSR gather → vote (B4)
                             → ungapped verify, capacity-compacted rounds
                             → banded DP bucket rounds (B1)
                             → clip-rescue DP lane (B1, clip mode)
                             → select + weak/suspect MAPQ gates
                             → traceback of the gapped winners (B6)
                             → one flat int32 output (map/output.py):
                               packed [B, 3] calls, then the traceback
                               matrices

A port of urmap_tpu/map/pipeline.py (candidates_batch_device,
map_batch_device, tb_pass_device, pack_out, Mapper): the same stages,
constants and
tie orders, so the output is bit-equal. The reference's
``jax.lax.while_loop`` rounds become Python loops on ``.any()``, and
``jnp.nonzero(size=cap, fill_value=0)`` is padded by hand
(``_nonzero_padded``). Index tables stay on the device across batches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from urmap_tpu_torch import alphabet
from urmap_tpu_torch.config import (IndexConfig, MapConfig, ScoreConfig,
                              resolve_suspect_deficits)
from urmap_tpu_torch.device import require_device
from urmap_tpu_torch.map.dp import NEG, banded_packed
from urmap_tpu_torch.map.seed import POS_BIAS, SENTINEL, gather_runs
from urmap_tpu_torch.map.select import host_scalar, select_hits
from urmap_tpu_torch.utils import trace

_COMP = np.asarray(alphabet.COMP_CODE)


def revcomp_batch(reads: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-row reverse complement of the first ``lengths`` codes of
    uint8[B, L] reads. The reference complements, reverses the whole
    row and rotates it left by L - len, which also reverses the pad
    lanes among themselves; callers keep the pad uniform READ_N, and
    this index form gives the same lanes either way."""
    B, L = reads.shape
    with trace.sync("const"):
        comp_table = torch.from_numpy(_COMP).to(reads.device)
    comp = comp_table[reads.long()]
    col = torch.arange(L, dtype=torch.int64, device=reads.device)[None, :]
    ln = lengths.long()[:, None]
    src = torch.where(col < ln, ln - 1 - col, L - 1 - col + ln)
    return torch.gather(comp, 1, src)


# urmap_tpu/map/pipeline.py:MapResult
@dataclass
class MapResult:
    """Host-side mapping results for one batch (numpy arrays, length B)."""

    mapped: np.ndarray   # bool
    pos: np.ndarray      # int64 global alignment start
    strand: np.ndarray   # int32, 0 fwd / 1 rc
    score: np.ndarray    # int32
    second: np.ndarray   # int32 (NEG-ish if none)
    mapq: np.ndarray     # int32
    gapped: np.ndarray   # bool: CIGAR needs traceback (else all-M)
    lengths: np.ndarray  # int32
    ungapped: np.ndarray | None = None  # int32 M-only rescore at pos
    clipped: np.ndarray | None = None   # bool: clip-rescued row
    suspect: np.ndarray | None = None   # bool: saturated-evidence winner
    tb: dict | None = None              # device traceback (unpack_tb)
    clip_tb: dict | None = None         # clip traceback (unpack_clip_tb)
    batch: int | None = None            # the batch id (utils/trace.py)
    # the clip mode the batch was mapped in (clip_mode): ScoreConfig.
    # clip_open under end_clip, else None; cigar.cigars_nm_blob formats
    # in it
    clip_open: int | None = None

    @classmethod
    def from_device(cls, out: dict, lengths,
                    clip_open: int | None = None) -> "MapResult":
        return cls(
            mapped=np.asarray(out["mapped"]),
            pos=np.asarray(out["pos"], dtype=np.int64),
            strand=np.asarray(out["strand"]),
            score=np.asarray(out["score"]),
            second=np.asarray(out["second"]),
            mapq=np.asarray(out["mapq"]),
            gapped=np.asarray(out["gapped"]),
            lengths=np.asarray(lengths),
            ungapped=(np.asarray(out["ungapped"])
                      if "ungapped" in out else None),
            clipped=(np.asarray(out["clipped"])
                     if "clipped" in out else None),
            suspect=(np.asarray(out["suspect"])
                     if "suspect" in out else None),
            clip_open=clip_open,
        )


# urmap_tpu/map/pipeline.py:pick_gather_tier
def pick_gather_tier(aligned_counts: np.ndarray,
                     max_overflow: float = 0.04) -> int | None:
    """Tiered-gather width from the aligned layout's padded counts: the
    smallest power of two whose overflow fraction stays under
    ``max_overflow``, or None."""
    if aligned_counts.size == 0:
        return None
    for t in (4, 8):
        if float((aligned_counts > t).mean()) <= max_overflow:
            return t
    return None


# urmap_tpu/map/pipeline.py:tb_enabled
def tb_enabled(mcfg: MapConfig) -> bool:
    """The one predicate that turns the device traceback pass on: off
    under end_clip (every gapped winner needs the clip-mode host
    traceback), under URMAP_NO_TB_BITS=1, and for band_halfwidth > 31
    (a dops record holds the deletion run in 6 bits, d <= 2*hw)."""
    return bool(mcfg.tb_bits and not mcfg.end_clip
                and mcfg.band_halfwidth <= 31
                and os.environ.get("URMAP_NO_TB_BITS") != "1")


def clip_mode(mcfg: MapConfig, sc: ScoreConfig) -> int | None:
    """The clip mode of a Mapper's results (MapResult.clip_open): every
    DP of the path soft-clips for ``sc.clip_open`` under end_clip; None
    (end to end) otherwise."""
    return sc.clip_open if mcfg.end_clip else None


def clip_tb_enabled(mcfg: MapConfig, sc: ScoreConfig) -> bool:
    """The one predicate that turns the clip traceback pass
    (clip_tb_pass_device) on, apart from tb_enabled: under end_clip over
    every mapped gapped winner of every batch (B6 has no clip mode and
    stays off); otherwise the rescue rule, over the clip-rescued gapped
    winners of the batches whose clip-rescue lane ran, beside B6. Both
    only where the kernel takes the read block (kernels.clip_tb.enabled)
    and the device traceback records are on (``tb_bits``, not
    URMAP_NO_TB_BITS=1): without them every clip row takes the host clip
    DP, with the same SAM bytes."""
    from urmap_tpu_torch.kernels import clip_tb

    if not clip_tb.enabled(mcfg.max_read_len, sc):
        return False
    if mcfg.end_clip:
        return bool(mcfg.tb_bits
                    and os.environ.get("URMAP_NO_TB_BITS") != "1")
    return tb_enabled(mcfg)


def card_limits(mcfg: MapConfig) -> list[str]:
    """What of ``mcfg`` the card's kernels do not take, one line each
    naming the kernel and its limit; empty when every kernel of the path
    takes it. The Mapper refuses such a config on a CUDA device before
    the tables load; on the CPU every shape runs (the plain versions).

    The limits: B1 (the banded DP, every mode) band half-widths 1-271
    and the read block that one candidate's shared memory holds; B6 (the
    device traceback, when tb_enabled) the read block that one winner's
    holds; B4 (the vote) Q x P candidates a read; the seed front the
    read block its four reads a block hold.

    Not a kernel's limit, so not listed: clip mode's packed scores
    overflow int32 once L + 2 * hw + 1 > 2,048 (``NEG * S``), in the
    plain versions and in urmap_tpu alike. Under ``end_clip`` every DP
    of the path runs in clip mode, so such a read block maps wrongly
    there on every device, as in the reference (ROADMAP.md C)."""
    from urmap_tpu_torch.kernels import banded_dp, seed_slots, tb_dp, vote

    hw, L = mcfg.band_halfwidth, mcfg.max_read_len
    out = []
    if not 1 <= hw <= banded_dp.MAX_HALF_WIDTH:
        out.append(f"band_halfwidth {hw}: kernel B1 (banded_dp) takes 1 to "
                   f"{banded_dp.MAX_HALF_WIDTH}")
    else:
        lim = banded_dp.max_read_len(hw)
        if L > lim:
            out.append(f"max_read_len {L}: kernel B1 (banded_dp) holds at "
                       f"most {lim} bases at band_halfwidth {hw} (one "
                       "candidate in a block's 227 KB of shared memory)")
    if tb_enabled(mcfg):
        lim = tb_dp.max_read_len(hw)
        if L > lim:
            out.append(f"max_read_len {L}: kernel B6 (tb_dops) holds at "
                       f"most {lim} bases at band_halfwidth {hw} (one "
                       "winner in a block's 227 KB of shared memory); "
                       "tb_bits=False maps it on the host traceback")
    m = mcfg.seeds_per_read * mcfg.positions_per_seed
    if m > vote.MAX_M:
        out.append(f"seeds_per_read x positions_per_seed = {m}: kernel B4 "
                   f"(vote) takes at most {vote.MAX_M} candidates a read")
    lim = seed_slots.front_max_read_len()
    if L > lim:
        out.append(f"max_read_len {L}: the seed front (seed_front) holds at "
                   f"most {lim} bases")
    return out


def refuse_beyond_card(mcfg: MapConfig, device: torch.device) -> None:
    """ValueError on a CUDA device for a config beyond a kernel's limit
    (card_limits): raised before any table loads."""
    if device.type == "cuda":
        lines = card_limits(mcfg)
        if lines:
            raise ValueError("this MapConfig is beyond the card's kernels: "
                             + "; ".join(lines))


def _nonzero_padded(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The first ``size`` True indices of ``mask``, padded with 0 — the
    reference's jnp.nonzero(mask, size=size, fill_value=0). Fill lanes
    alias row 0; callers take ``do = mask[idx]``, so a fill lane
    computes and writes exactly what lane row 0 does (or leaves row 0
    as it was), and duplicate-index writes agree."""
    with trace.sync("nonzero"):
        idx = mask.nonzero().flatten()[:size]
    if idx.shape[0] < size:
        idx = torch.cat([idx, idx.new_zeros(size - idx.shape[0])])
    return idx


def _any(mask: torch.Tensor, site: str) -> bool:
    """A round loop's condition, read back by the host (a sync)."""
    with trace.sync(site):
        return bool(mask.any())


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on the device (from pageable memory: the host waits
    for the copy, a sync)."""
    with trace.sync("upload"):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def download(out: torch.Tensor) -> np.ndarray:
    """A batch's flat output on the host (the host waits for the card to
    finish the batch, a sync)."""
    with trace.sync("download"):
        return out.cpu().numpy()


def _fold(x: torch.Tensor, rows: int, v: int) -> torch.Tensor:
    """[2*rows*v] or [2*rows, v] (fwd block, rc block) → [rows, 2V]."""
    x = x.reshape(2, rows, v)
    return torch.cat([x[0], x[1]], dim=1)


def candidates_batch_device(tables: dict, reads, lengths: torch.Tensor, *,
                            icfg: IndexConfig, mcfg: MapConfig,
                            sc: ScoreConfig, packed_reads=None,
                            gather_runner=None, dp_runner=None) -> dict:
    """Seed → vote → ungapped verify → bucketed banded DP → clip lane,
    both strands. ``packed_reads``: the (packed, nmask) upload blocks of
    genome_pack.pack_read_codes_host, in place of ``reads`` (uint8
    codes [B, L]). ``gather_runner(slots, offs, valid) → cand int32[2B,
    Q*P]`` and ``dp_runner(cand, reads, lens, rpacked, rnplane) →
    (scores, d0, ungapped, span)``: the sharded routes' stages
    (dist/sharded.py). With a gather runner the seed front runs in its
    slots mode and the runner fetches the candidates (a rank holds one
    slot range of the tables); a DP runner takes the main DP bucket in
    place of banded_packed (the clip-rescue lane stays local, as in the
    reference). Returns per-read candidate arrays [B, 2V] (forward
    candidates in columns [:V], reverse-complement in [V:]): pos, score,
    strand, valid, ungapped, span; and per read dp_ran, clipped, weak,
    nsat; ``_words``, the word planes of both strands (rpacked2,
    rnplane2 int32[2B, nw]: rows [0, B) forward, [B, 2B) reverse
    complement), which the traceback passes read again; and
    ``_clip_rounds``, the rounds the clip-rescue lane ran (a host int,
    known from its loop's syncs)."""
    from urmap_tpu_torch import genome_pack as gpk
    from urmap_tpu_torch.kernels import (clip_rounds, dp_rounds, seed_slots,
                                         verify_rounds, vote)

    B = lengths.shape[0]
    dev = lengths.device
    L = mcfg.max_read_len if reads is None else reads.shape[1]
    nw = -(-L // gpk.BASES_PER_WORD)
    q, p, v = mcfg.seeds_per_read, mcfg.positions_per_seed, mcfg.top_candidates
    ginter, base_off = tables["ginter"], tables["base_off"]

    # packed-offsets coherence: the tables and the decode must agree, or
    # every candidate is garbage and every read comes back unmapped
    off_bits = tables["off_bits"]
    if ("obase" in tables) != (off_bits is not None):
        raise ValueError("tables carry packed offsets without off_bits "
                         "(or off_bits without the packed offsets)")
    # the seed front: both strands' words, the seeds and their CSR runs
    # in one launch on the card (kernels/seed_slots.py)
    fwd = packed_reads if packed_reads is not None \
        else gpk.pack_reads(reads, lengths, nw)
    if gather_runner is None:
        rpacked2, rnplane2, offs, valid, start, cnt = seed_slots.seed_front(
            *fwd, lengths, L, k=icfg.k, q=q, slot_bits=icfg.slot_bits,
            offsets=tables["offsets"], obase=tables.get("obase"),
            cnt_bits=off_bits[0] if off_bits else 0,
            block_bits=off_bits[1] if off_bits else 0)
        cand = gather_runs(tables["positions"], start, cnt, offs, valid,
                           p=p, csr_aligned=tables["csr_aligned"],
                           tier=tables["gather_tier"],
                           row128=tables["row128"])
    else:
        # ``valid`` stays every seed's global validity: the vote floor's
        # nval below reads it; the runner masks what its shard owns
        rpacked2, rnplane2, offs, valid, slots = seed_slots.seed_front(
            *fwd, lengths, L, k=icfg.k, q=q, slot_bits=icfg.slot_bits,
            offsets=None)
        cand = gather_runner(slots, offs, valid)
    lengths2 = torch.cat([lengths, lengths], dim=0)         # [2B]
    top_cand, votes = vote.vote(cand, v=v)                  # [2B, V]
    if mcfg.min_votes > 1:
        # vote floor with per-read fallback (config.MapConfig.min_votes)
        mv = mcfg.min_votes
        pair_max = votes.reshape(2, B, v).amax(dim=(0, 2))
        no_floor = pair_max < mv
        top_cand = torch.where((votes >= mv) | no_floor.repeat(2)[:, None],
                               top_cand, SENTINEL)
        # saturated seeds (slot load >= min(p, suspect_slot_load)) mark
        # subsampled repeat evidence: weak reads get their MAPQ capped
        load = (cand.reshape(2 * B, q, p) != SENTINEL).sum(dim=2)
        sat = load >= min(p, mcfg.suspect_slot_load)
        nsat = sat.sum(dim=1).reshape(2, B).sum(dim=0)
        nval = valid.sum(dim=1).reshape(2, B).sum(dim=0)
        weak = (no_floor & (nsat > 0)) | ((2 * nsat >= nval) & (nval > 0))
    else:
        weak = torch.zeros(B, dtype=torch.bool, device=dev)
        nsat = torch.zeros(B, dtype=torch.int64, device=dev)
    # genome range in biased device coordinates
    top_cand = torch.where(
        top_cand == SENTINEL, SENTINEL,
        top_cand.clamp(-POS_BIAS, tables["genome_max_biased"]))

    # ---- ungapped verification of every candidate (bit-parallel) ----
    flat_cand = top_cand.reshape(-1)                        # [2B*V]
    flat_lens = lengths2.repeat_interleave(v)
    valid_flat = flat_cand != SENTINEL
    nv = 2 * B * v
    cap = min(max(nv // mcfg.verify_capacity_frac, 128), nv)
    if cap < nv:
        # capacity-compacted rounds: each serves the first ``cap``
        # unserved valid lanes until none remain
        starts_all = torch.where(valid_flat, flat_cand, 0)
        mm = flat_lens.clone()      # all-mismatch; SENTINEL lanes masked
        done = torch.zeros(nv, dtype=torch.bool, device=dev)
        rounds = 0
        while _any(valid_flat & ~done, "verify"):
            rem = valid_flat & ~done
            idx = _nonzero_padded(rem, cap)
            do = rem[idx]
            rrow = idx // v
            mm_sub = gpk.mismatch_counts(ginter, base_off, starts_all[idx],
                                         rpacked2[rrow], rnplane2[rrow],
                                         lengths2[rrow])
            mm[idx] = torch.where(do, mm_sub, mm[idx])
            done[idx] = done[idx] | do
            rounds += 1
        verify_rounds.add(rounds)
    else:
        mm = gpk.mismatch_counts(
            ginter, base_off, torch.where(valid_flat, flat_cand, 0),
            rpacked2.repeat_interleave(v, dim=0),
            rnplane2.repeat_interleave(v, dim=0), flat_lens)
    ung = ((flat_lens - mm) * sc.match + mm * sc.mismatch) \
        .to(torch.int32).reshape(2 * B, v)

    cand_f = _fold(top_cand, B, v)
    valid_c = cand_f != SENTINEL
    strands = torch.cat([torch.zeros((B, v), dtype=torch.int32, device=dev),
                         torch.ones((B, v), dtype=torch.int32, device=dev)],
                        dim=1)
    ung_masked = torch.where(valid_c, _fold(ung, B, v), NEG)
    best_ung = ung_masked.amax(dim=-1)

    def dp_round(idx, clip_open, runner=None):
        """Banded DP on every candidate of reads ``idx`` (both strands)
        → (sub_cand [D, 2V], (scores, d0, ungapped, span) [D, 2V]);
        ``runner``: a DP runner in place of banded_packed."""
        d = idx.shape[0]
        sub_cand = cand_f[idx]
        sub_rp = torch.cat([rpacked2[idx], rpacked2[B + idx]], dim=0)
        sub_rn = torch.cat([rnplane2[idx], rnplane2[B + idx]], dim=0)
        # byte codes only for the DP rows (the window compare)
        sub_reads2 = gpk.unpack_words_to_codes(sub_rp, sub_rn, L)
        sub_lens2 = torch.cat([lengths[idx], lengths[idx]], dim=0)
        dflat = torch.cat([sub_cand[:, :v], sub_cand[:, v:]], dim=0) \
            .reshape(-1)                                    # [2D*V]
        args = (torch.where(dflat == SENTINEL, 0, dflat),
                sub_reads2.repeat_interleave(v, dim=0),
                sub_lens2.repeat_interleave(v),
                sub_rp.repeat_interleave(v, dim=0),
                sub_rn.repeat_interleave(v, dim=0))
        if runner is not None:
            outs = runner(*args)
        else:
            outs = banded_packed(ginter, base_off, *args,
                                 hw=mcfg.band_halfwidth, sc=sc,
                                 clip_open=clip_open)
        return sub_cand, [_fold(x, d, v) for x in outs]

    # ---- gapped-DP bucket rounds ----
    # reads whose best ungapped candidate has more than
    # dp_trigger_mismatches mismatches, D = B / dp_capacity_frac per round
    trigger = (lengths * sc.match
               - mcfg.dp_trigger_mismatches * (sc.match - sc.mismatch))
    need_dp = (best_ung > NEG) & (best_ung < trigger) & (lengths >= icfg.k)
    D = max(B // mcfg.dp_capacity_frac, 1)
    clip = clip_mode(mcfg, sc)
    scores_f = ung_masked.clone()
    pos_f = cand_f.clone()
    ungapped_f = ung_masked.clone()
    # span = read length for M-only placements; DP rounds overwrite
    spans0 = lengths[:, None].expand(B, 2 * v)
    spans_f = spans0.clone()
    served = torch.zeros(B, dtype=torch.bool, device=dev)
    rounds = 0
    while _any(need_dp & ~served, "dp"):
        rem = need_dp & ~served
        idx = _nonzero_padded(rem, D)
        do = rem[idx]
        sub_cand, (dp_s, dp_d0, dp_ung, dp_sp) = dp_round(idx, clip,
                                                          dp_runner)
        upd = do[:, None] & (sub_cand != SENTINEL)
        scores_f[idx] = torch.where(upd, dp_s, scores_f[idx])
        pos_f[idx] = torch.where(upd, sub_cand + dp_d0, pos_f[idx])
        ungapped_f[idx] = torch.where(upd, dp_ung, ungapped_f[idx])
        spans_f[idx] = torch.where(upd, dp_sp, spans_f[idx])
        served[idx] = served[idx] | do
        rounds += 1
    dp_rounds.add(rounds)

    # ---- clip-rescue lane (config.MapConfig.clip_rescue) ----
    # reads still below the mapping threshold get one more bucketed DP
    # in end-clip mode; it touches only would-be-unmapped reads
    clipped_read = torch.zeros(B, dtype=torch.bool, device=dev)
    rounds = 0
    if mcfg.clip_rescue and not mcfg.end_clip:
        frac = host_scalar(mcfg.min_score_frac, dev)
        min_sc = torch.ceil(frac * lengths.to(torch.float32)) \
            .to(torch.int32)
        best_now = torch.where(valid_c, scores_f, NEG).amax(dim=-1)
        need_clip = (valid_c.any(dim=-1) & (best_now < min_sc)
                     & (lengths >= icfg.k))
        Dc = max(B // mcfg.clip_rescue_capacity_frac, 1)
        cserved = torch.zeros(B, dtype=torch.bool, device=dev)
        rounds = 0
        while _any(need_clip & ~cserved, "clip"):
            rem = need_clip & ~cserved
            idx = _nonzero_padded(rem, Dc)
            do = rem[idx]
            sub_cand, (dp_s, dp_d0, dp_ung, _sp) = dp_round(idx,
                                                             sc.clip_open)
            upd = do[:, None] & (sub_cand != SENTINEL)
            scores_f[idx] = torch.where(upd, dp_s, scores_f[idx])
            pos_f[idx] = torch.where(upd, sub_cand + dp_d0, pos_f[idx])
            ungapped_f[idx] = torch.where(upd, dp_ung, ungapped_f[idx])
            clipped_read[idx] = clipped_read[idx] | do
            cserved[idx] = cserved[idx] | do
            rounds += 1
        clip_rounds.add(rounds)
        # rescued candidates: spans fall back to the length proxy
        spans_f = torch.where(clipped_read[:, None], spans0, spans_f)

    return {"pos": pos_f, "score": scores_f, "strand": strands,
            "valid": valid_c, "ungapped": ungapped_f, "span": spans_f,
            "dp_ran": served, "clipped": clipped_read, "weak": weak,
            "nsat": nsat, "_words": (rpacked2, rnplane2),
            "_clip_rounds": rounds}


def map_batch_device(tables: dict, reads, lengths: torch.Tensor, *,
                     icfg: IndexConfig, mcfg: MapConfig, sc: ScoreConfig,
                     packed_reads=None, tb: bool = False,
                     clip_tb: bool = False,
                     gather_runner=None, dp_runner=None) -> dict:
    """One batch → per-read calls with the weak and suspect MAPQ gates;
    with ``tb`` also ``_tb``, the traceback matrix of tb_pass_device;
    with ``clip_tb`` (clip_tb_enabled) also ``_clip_tb``, the matrix of
    clip_tb_pass_device: under end_clip in every batch, over every
    mapped gapped winner; otherwise where the clip-rescue lane ran a
    round, over the clip-rescued gapped winners. ``gather_runner``,
    ``dp_runner``: see candidates_batch_device."""
    c = candidates_batch_device(tables, reads, lengths, icfg=icfg,
                                mcfg=mcfg, sc=sc, packed_reads=packed_reads,
                                gather_runner=gather_runner,
                                dp_runner=dp_runner)
    words = c.pop("_words")
    clip_ran = c.pop("_clip_rounds") > 0
    out = select_hits(c["pos"], c["score"], c["strand"], c["valid"],
                      lengths, c["ungapped"], mc=mcfg, k=icfg.k)
    out["dp_ran"] = c["dp_ran"]
    out["clipped"] = c["clipped"] & out["mapped"]
    # weak-fallback winners: placement rests on one seed from a
    # saturated slot — MAPQ capped
    out["mapq"] = torch.where(c["weak"] & out["mapped"],
                              out["mapq"].clamp(max=mcfg.weak_mapq_cap),
                              out["mapq"])
    # suspect winners (config.MapConfig.suspect_deficit): saturated
    # evidence and a score trailing perfect by more than the gate; clip-
    # rescued winners are excluded
    sus_d, remap_d = resolve_suspect_deficits(mcfg, sc)
    deficit = lengths * sc.match - out["score"]
    sat = out["mapped"] & (c["nsat"] > 0) & ~out["clipped"]
    out["mapq"] = torch.where(
        sat & (deficit > sus_d),
        out["mapq"].clamp(max=mcfg.suspect_mapq_cap), out["mapq"])
    out["suspect"] = sat & (deficit > remap_d)
    L = mcfg.max_read_len if reads is None else reads.shape[1]
    if tb:
        # clip-rescued rows take the clip traceback below (B6's band
        # cannot hold the host's clip-mode paths)
        gsel = out["mapped"] & out["gapped"] & ~out["clipped"]
        out["_tb"] = tb_pass_device(tables, out["pos"], out["strand"],
                                    lengths, gsel, *words, L=L, mcfg=mcfg,
                                    sc=sc)
    if clip_tb and (mcfg.end_clip or clip_ran):
        csel = out["gapped"] & (out["mapped"] if mcfg.end_clip
                                else out["clipped"])
        out["_clip_tb"] = clip_tb_pass_device(
            tables, out["pos"], out["strand"], out["score"], lengths,
            csel, *words, L=L, mcfg=mcfg, sc=sc)
    return out


# ---- device traceback pass (config.MapConfig.tb_bits) ----
# Gapped winners are re-aligned at their selected POS by kernel B6, which
# walks its own per-cell codes and emits one (deletion-run, op) byte per
# read row; the host replays the records in O(L) (map/cigar.py). One
# matrix rides the batch's device-to-host copy, flattened into the same
# array as the packed output: rows 0-3 = meta (winner row index;
# strand<<18 | walk_ok<<17 | do<<16; tb score; tb anchor pos, biased),
# rows 4.. = packed dops words, columns = the C compacted winner lanes.
TB_META_ROWS = 4


# urmap_tpu/map/pipeline.py:tb_cols
def tb_cols(nrows: int, mcfg: MapConfig) -> int:
    return min(max(nrows // mcfg.tb_capacity_frac, 128), nrows)


# urmap_tpu/map/pipeline.py:tb_rows
def tb_rows(mcfg: MapConfig) -> int:
    from urmap_tpu_torch.map.tb import dops_words

    return TB_META_ROWS + dops_words(mcfg.max_read_len)


def tb_pass_device(tables: dict, pos: torch.Tensor, strand: torch.Tensor,
                   lengths_rows: torch.Tensor, gsel: torch.Tensor,
                   rp2: torch.Tensor, rn2: torch.Tensor, *, L: int,
                   mcfg: MapConfig, sc: ScoreConfig) -> torch.Tensor:
    """Compact gapped winners → windows at POS-hw → kernel B6 → one
    int32 matrix [TB_META_ROWS + DWp, C].

    pos: biased int32 winner positions (row-aligned with gsel);
    rp2/rn2: the word planes of both strands as the seed front gives
    them, int32[2N, nw]: row r forward, row N + r its reverse
    complement (genome_pack.revcomp_words of row r).
    Winners beyond the C lanes get no records and fall back to the host
    DP."""
    from urmap_tpu_torch import genome_pack as gpk
    from urmap_tpu_torch.kernels import tb_dp

    hw = mcfg.band_halfwidth
    if hw > 31:
        raise ValueError("a dops record holds d in 6 bits: band_halfwidth "
                         "must be <= 31 (tb_enabled gates it)")
    nrows = gsel.shape[0]
    C = tb_cols(nrows, mcfg)
    idx = _nonzero_padded(gsel, C)
    # live lanes by COUNT, not gsel[idx]: fill lanes alias row 0, whose
    # gsel bit may really be set
    do = torch.arange(C, device=gsel.device) < gsel.sum()
    lens = lengths_rows[idx]
    st = strand[idx].to(torch.int32)
    # the winner's strand picks its row: forward, or N + row
    row = idx + nrows * st
    codes = gpk.unpack_words_to_codes(rp2[row], rn2[row], L)
    # fill lanes take p = 0 (biased), a position far past the genome's
    # end: their window is whatever the gather's clamp gives, and their
    # records are never read (do is 0)
    p = torch.where(do, pos[idx].to(torch.int32), 0)
    windows = gpk.gather_codes(tables["ginter"], tables["base_off"], p - hw,
                               L + 2 * hw)
    score, dops, walk_ok = tb_dp.tb_dops_from_windows(windows, codes, lens,
                                                      hw=hw, sc=sc)
    # the strand rides the meta so a result whose orientation was flipped
    # at an equal pos and score cannot replay stale records
    # (cigar._tb_select compares it)
    meta = torch.stack([idx.to(torch.int32),
                        (do.to(torch.int32) << 16)
                        | (walk_ok.to(torch.int32) << 17) | (st << 18),
                        score, p], dim=0)
    return torch.cat([meta, dops], dim=0)


# ---- the clip traceback pass (kernels/clip_tb.py) ----
# The clip-mode gapped winners (under end_clip every mapped gapped
# winner, else the clip-rescued ones) are re-aligned by the clip
# traceback over the host's clip-mode window (POS, read length + 48
# bases, clamped at the genome's end), and cigar.cigars_nm_blob replays
# its records in O(L). Its matrix rides the same device-to-host copy,
# after the tb matrix where B6 ran (clip_tb_enabled says in which
# batches): rows 0-4 = meta (winner row index; strand<<18 | ok<<17 |
# do<<16; the winner's score; its POS, biased; the clip traceback's
# score), rows 5.. = the records, columns = the C compacted winner lanes
# (clip_tb_cols).
CLIP_META_ROWS = 5


def clip_tb_rows(mcfg: MapConfig) -> int:
    from urmap_tpu_torch.map.tb import dops_words

    return CLIP_META_ROWS + dops_words(mcfg.max_read_len)


def clip_tb_cols(nrows: int, mcfg: MapConfig) -> int:
    """The clip traceback's lanes over ``nrows`` rows: B6's (tb_cols)
    for the clip-rescued winners; under end_clip, where every gapped
    winner takes a lane (indels and adapter tails alike: ~17% of a
    short-insert library's reads), twice that."""
    C = tb_cols(nrows, mcfg)
    return min(2 * C, nrows) if mcfg.end_clip else C


def clip_tb_past(res: "MapResult", mcfg: MapConfig, C: int,
                 rows: int) -> None:
    """Count ``rows.clip_tb_past``: the clip pass's winners of ``res``
    (under end_clip the mapped gapped rows, else the clip-rescued gapped
    rows) past the C lanes of each block of ``rows`` rows the pass
    compacted; the host clip DP serves them."""
    sel = res.gapped & (res.mapped if mcfg.end_clip else res.clipped)
    trace.count("rows.clip_tb_past",
                sum(max(int(sel[s : s + rows].sum()) - C, 0)
                    for s in range(0, sel.size, rows)))


def _compact(sel: torch.Tensor, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(_nonzero_padded(sel, C), lanes live by count) without a host
    sync: the first C True indices of ``sel`` in order, padded with 0."""
    n = sel.shape[0]
    rank = torch.cumsum(sel.to(torch.int32), 0)
    slot = torch.where(sel & (rank <= C), rank - 1, C)
    idx = torch.zeros(C + 1, dtype=torch.int64, device=sel.device)
    idx.scatter_(0, slot, torch.arange(n, device=sel.device))
    do = torch.arange(C, device=sel.device) < rank[-1]
    return idx[:C], do


def clip_tb_pass_device(tables: dict, pos: torch.Tensor,
                        strand: torch.Tensor, score: torch.Tensor,
                        lengths_rows: torch.Tensor, gsel: torch.Tensor,
                        rp2: torch.Tensor, rn2: torch.Tensor, *, L: int,
                        mcfg: MapConfig, sc: ScoreConfig) -> torch.Tensor:
    """Compact the winners ``gsel`` → windows at POS → the clip
    traceback → one int32 matrix [CLIP_META_ROWS + DWp, C]
    (C = clip_tb_cols); no host sync. Arguments as tb_pass_device's,
    with ``score`` the winners'. Winners beyond the C lanes get no
    record; those at a POS below 0, or whose path the records cannot
    hold, get ok 0; both go to the host DP."""
    from urmap_tpu_torch import genome_pack as gpk
    from urmap_tpu_torch.kernels import clip_tb
    from urmap_tpu_torch.map.clip_tb import PAD

    nrows = gsel.shape[0]
    C = clip_tb_cols(nrows, mcfg)
    idx, do = _compact(gsel, C)
    # fill lanes (do 0) take length 0: the kernel skips them
    lens = torch.where(do, lengths_rows[idx], 0)
    st = strand[idx].to(torch.int32)
    row = idx + nrows * st
    codes = gpk.unpack_words_to_codes(rp2[row], rn2[row], L)
    p = torch.where(do, pos[idx].to(torch.int32), 0)
    windows = gpk.gather_codes(tables["ginter"], tables["base_off"], p,
                               L + PAD)
    # the host's window: read length + 48 bases, cut at the genome's end
    pl = p.to(torch.int64)
    gend = tables["genome_max_biased"] + 1
    widths = torch.minimum(lens.to(torch.int64) + PAD, gend - pl) \
        .clamp(min=0).to(torch.int32)
    dp_score, recs, ok = clip_tb.clip_tb(windows, codes, lens, widths,
                                         sc=sc, clip_open=sc.clip_open)
    ok = ok & (pl >= -POS_BIAS)
    meta = torch.stack([idx.to(torch.int32),
                        (do.to(torch.int32) << 16)
                        | (ok.to(torch.int32) << 17) | (st << 18),
                        score[idx].to(torch.int32), p, dp_score], dim=0)
    return torch.cat([meta, recs], dim=0)


def unpack_clip_tb(arr: np.ndarray) -> dict:
    """Host reader of clip_tb_pass_device's matrix → the dict
    cigar.cigars_nm_blob reads: the live lanes whose path the records
    hold (rows, score, pos, strand as the winner had them, dp_score, and
    their columns of ``recs``). Counts ``rows.clip_tb``, the lanes that
    held a winner (``do``)."""
    meta = arr[:CLIP_META_ROWS]
    do = ((meta[1] >> 16) & 1).astype(bool)
    trace.count("rows.clip_tb", int(do.sum()))
    live = do & ((meta[1] >> 17) & 1).astype(bool)
    return {
        "rows": meta[0][live].astype(np.int64),
        "score": meta[2][live].astype(np.int32),
        "pos": meta[3][live].astype(np.int64) + POS_BIAS,
        "strand": ((meta[1] >> 18) & 1)[live].astype(np.int32),
        "dp_score": meta[4][live].astype(np.int32),
        "cols": np.nonzero(live)[0].astype(np.int32),
        "recs": arr[CLIP_META_ROWS:],
    }


def merge_clip_tb(parts: list, row_offsets) -> dict | None:
    """Per-batch clip dicts (None: a batch the pass did not run in) →
    one dict over the concatenated result, rows re-based by each batch's
    first row and columns by the matrices before it; None if no batch
    had one."""
    kept = [(p, o) for p, o in zip(parts, row_offsets) if p is not None]
    if not kept:
        return None
    col_off = np.cumsum([0] + [p["recs"].shape[1] for p, _ in kept])
    out = {k: np.concatenate([p[k] for p, _ in kept])
           for k in ("score", "pos", "strand", "dp_score")}
    out["rows"] = np.concatenate([p["rows"] + o for p, o in kept])
    out["cols"] = np.concatenate([p["cols"] + c for (p, _), c
                                  in zip(kept, col_off)]).astype(np.int32)
    out["recs"] = np.concatenate([p["recs"] for p, _ in kept], axis=1)
    return out


# urmap_tpu/map/pipeline.py:merge_tb_batches
def merge_tb_batches(tbs: list, row_offsets) -> dict | None:
    """Per-batch tb dicts → one dict over the concatenated result:
    rows re-based by each batch's starting row, dops matrices
    concatenated along columns (None if any batch lacks tb — the whole
    merge then falls back to the host DP rather than mixing)."""
    if not tbs or any(t is None for t in tbs):
        return None
    if len(tbs) == 1:
        return tbs[0]
    col_off = np.cumsum([0] + [t["dops"].shape[1] for t in tbs])

    def cat(key, offs):
        return np.concatenate([t[key] + o for t, o in zip(tbs, offs)])

    zero = [0] * len(tbs)
    return {
        "rows": cat("rows", list(row_offsets)),
        "score": cat("score", zero),
        "pos": cat("pos", zero),
        "strand": cat("strand", zero),
        "cols": cat("cols", col_off),
        "dops": np.concatenate([t["dops"] for t in tbs], axis=1),
        "hw": tbs[0]["hw"], "L": tbs[0]["L"],
    }


# urmap_tpu/map/pipeline.py:unpack_tb
def unpack_tb(arr: np.ndarray, hw: int, L: int) -> dict:
    """Host twin of tb_pass_device's packing → dict consumed by
    map/cigar.py (rows/score/pos are filtered to the live lanes whose
    device walk was structurally valid)."""
    meta = arr[:TB_META_ROWS]
    do = ((meta[1] >> 16) & 1).astype(bool) \
        & ((meta[1] >> 17) & 1).astype(bool)
    return {
        "rows": meta[0][do].astype(np.int64),
        "score": meta[2][do].astype(np.int32),
        "pos": meta[3][do].astype(np.int64) + POS_BIAS,
        "strand": ((meta[1] >> 18) & 1)[do].astype(np.int32),
        "cols": np.nonzero(do)[0].astype(np.int32),
        "dops": arr[TB_META_ROWS:],
        "hw": hw,
        "L": L,
    }


# ---- single-array output packing (urmap_tpu/map/pipeline.py) ----
# columns: 0 = pos (biased int32); 1 = (score i16 << 16) | (second i16);
# 2 = (ungapped i16 << 16) | (mapq u8 << 8) | flags (1 mapped, 2 gapped,
# 4 dp_ran, 8 strand, 16 clipped, 32 suspect). Scores saturate at
# I16_FLOOR, which unpacks back to NEG.
PACKED_COLS = 3
I16_FLOOR = -(1 << 15)


def pack_out(out: dict) -> torch.Tensor:
    """Per-read calls → one int32 [B, 3] array. The per-mate dicts of
    the paired step carry no ``dp_ran``: the bit is then 0."""
    def sat16(x):
        return x.clamp(min=I16_FLOOR)

    def bit(name, shift):
        if name not in out:
            return 0
        return out[name].to(torch.int32) << shift

    flags = (bit("mapped", 0) | bit("gapped", 1) | bit("dp_ran", 2)
             | bit("strand", 3) | bit("clipped", 4) | bit("suspect", 5))
    col1 = (sat16(out["score"]) << 16) | (sat16(out["second"]) & 0xFFFF)
    col2 = ((sat16(out["ungapped"]) << 16)
            | (out["mapq"].to(torch.int32) << 8) | flags)
    return torch.stack([out["pos"].to(torch.int32), col1, col2], dim=1)


def _unsat16(x: np.ndarray) -> np.ndarray:
    return np.where(x == I16_FLOOR, np.int32(NEG), x.astype(np.int32))


# urmap_tpu/map/pipeline.py:unpack_out
def unpack_out(arr: np.ndarray) -> dict:
    col1 = arr[:, 1]
    col2 = arr[:, 2]
    flags = col2 & 0xFF
    second = ((col1 & 0xFFFF) ^ 0x8000) - 0x8000      # sign-extend i16
    return {
        "mapped": (flags & 1).astype(bool),
        "gapped": ((flags >> 1) & 1).astype(bool),
        "dp_ran": ((flags >> 2) & 1).astype(bool),
        "strand": ((flags >> 3) & 1).astype(np.int32),
        "clipped": ((flags >> 4) & 1).astype(bool),
        "suspect": ((flags >> 5) & 1).astype(bool),
        "pos": arr[:, 0].astype(np.int64) + POS_BIAS,
        "score": _unsat16(col1 >> 16),
        "second": _unsat16(second),
        "mapq": (col2 >> 8) & 0xFF,
        "ungapped": _unsat16(col2 >> 16),
    }


# urmap_tpu/map/pipeline.py:revcomp_strand_codes
def revcomp_strand_codes(codes: np.ndarray, result) -> np.ndarray:
    """Host helper: strand-applied read codes (rc rows reverse-
    complemented in place of the original)."""
    sel = np.asarray(result.mapped & (result.strand == 1))
    if not sel.any():
        return codes
    out = codes.copy()
    sub = codes[sel]
    lens = np.asarray(result.lengths)[sel]
    L = codes.shape[1]
    if (lens == L).all():
        out[sel] = _COMP[sub[:, ::-1]]
        return out
    idx = np.where(np.arange(L)[None, :] < lens[:, None],
                   lens[:, None] - 1 - np.arange(L)[None, :],
                   np.arange(L)[None, :])
    out[sel] = _COMP[np.take_along_axis(sub, idx, axis=1)]
    return out


class WideSecondPass:
    """The wide-gather recovery pass (MapConfig.second_pass_p), a port
    of urmap_tpu/map/pipeline.py:WideSecondPass: a second map program
    over tables recapped at the wider cap ``second_pass_p``, in batches
    of 512 unpacked reads, without the device traceback. It re-maps the
    rows the first pass left unmapped or flagged suspect; everything
    else keeps the first pass's call.

    It runs on the host CPU by design, as the reference's does (there
    the program is jitted for jax.devices("cpu") with use_pallas=False):
    the wide tables live in host RAM, not on the card, and the pass
    overlaps the card's next batch in the CLI's worker threads. So its
    tensors are CPU tensors and every stage runs its plain version,
    counted apart from a card path's (kernels.host_pass). This is the
    reference's semantics, not a fallback: a Mapper on a CUDA device
    still launches every kernel of its own path or raises."""

    _BATCH = 512

    def __init__(self, index, mcfg: MapConfig, sc: ScoreConfig):
        import dataclasses

        from urmap_tpu_torch.index.store import (load_prepared,
                                                 prepare_tables,
                                                 tables_from_numpy)

        sp = mcfg.second_pass_p
        if sp < mcfg.positions_per_seed:
            raise ValueError(f"second_pass_p {sp} narrower than the first "
                             f"pass ({mcfg.positions_per_seed})")
        self.icfg = index.config
        self.mcfg = mcfg
        self.sc = sc
        self.device = torch.device("cpu")
        prep = load_prepared(index, sp) or prepare_tables(index, sp)
        self._tables = tables_from_numpy(*prep, self.device)
        self._cfg = dataclasses.replace(mcfg, positions_per_seed=sp,
                                        batch_size=self._BATCH,
                                        second_pass_p=0)

    def _map(self, codes: np.ndarray, lengths: np.ndarray) -> dict:
        from urmap_tpu_torch.kernels import host_pass

        with host_pass():
            out = map_batch_device(self._tables, torch.from_numpy(codes),
                                   torch.from_numpy(lengths),
                                   icfg=self.icfg, mcfg=self._cfg,
                                   sc=self.sc)
            return unpack_out(pack_out(out).numpy())

    def __call__(self, codes: np.ndarray, lengths,
                 result: MapResult) -> MapResult:
        lengths = np.asarray(lengths)
        sel = ~result.mapped
        if result.suspect is not None:
            # suspect rows: a poor-scoring winner on subsampled evidence;
            # the wide gather usually surfaces the true copy
            sel = sel | result.suspect
        rows = np.nonzero(sel & (lengths[: len(result.mapped)]
                                 >= self.icfg.k))[0]
        if rows.size == 0:
            return result
        L, SPB = self.mcfg.max_read_len, self._BATCH
        for s in range(0, rows.size, SPB):
            r = rows[s : s + SPB]
            c = np.full((SPB, L), alphabet.READ_N, np.uint8)
            c[: r.size, : codes.shape[1]] = codes[r]
            ln = np.zeros(SPB, np.int32)
            ln[: r.size] = lengths[r]
            out = self._map(c, ln)
            got = out["mapped"][: r.size]
            pr = r[got]
            if pr.size == 0:
                continue
            src = np.nonzero(got)[0]
            result.mapped[pr] = True
            result.pos[pr] = out["pos"][src]
            result.strand[pr] = out["strand"][src]
            result.score[pr] = out["score"][src]
            result.second[pr] = out["second"][src]
            result.mapq[pr] = out["mapq"][src]
            result.gapped[pr] = out["gapped"][src]
            if result.ungapped is not None:
                result.ungapped[pr] = out["ungapped"][src]
            # clip-rescued recoveries need the clip-mode host traceback
            if result.clipped is not None:
                result.clipped[pr] = out["clipped"][src]
            if result.suspect is not None:
                # still suspect at the wide gather: the flag stays
                result.suspect[pr] = out["suspect"][src]
        return result


class Mapper:
    """Holds the device tables and maps host batches on one device.

    The surface of urmap_tpu.map.Mapper — prepack / start_batch /
    finish_batch / map_codes — so utils.stream.run_stream drives it
    unchanged. ``device`` ("cuda" by default, "cuda:1", "cpu"): the
    Mapper runs on the card unless the caller asks for the CPU, and
    raises without a card (``require_device`` never falls back). On
    CUDA the seed, table-fetch, vote, DP and traceback stages launch
    their kernels, on the CPU they run the plain versions. The table
    layout (classic, aligned or row128, with or without packed
    offsets) comes with the prepared tables, and with them the tiered
    gather's width where URMAP_TIER_GATHER=1 (``gather_tier``). ``prepared``: (host
    tables, meta) from either package's prepare_tables /
    load_prepared, in place of preparing them from ``index`` here.
    ``mcfg.end_clip`` runs every DP in clip mode and traces every gapped
    winner back with the clip traceback in place of B6 (results record
    the mode, MapResult.clip_open); ``mcfg.second_pass_p`` adds the
    WideSecondPass,
    which ``second_pass`` (and ``map_codes``) apply on the host CPU."""

    def __init__(self, index, mcfg: MapConfig | None = None,
                 sc: ScoreConfig | None = None, *, device="cuda",
                 prepared: tuple[dict, dict] | None = None):
        from urmap_tpu_torch.index.store import (load_prepared,
                                                 prepare_tables,
                                                 tables_from_numpy)

        self.device = require_device(device)
        self.mcfg = mcfg or MapConfig()
        refuse_beyond_card(self.mcfg, self.device)
        self.index = index
        self.icfg = index.config
        self.sc = sc or ScoreConfig()
        # device traceback records: B6's and the clip traceback's, each
        # by its one predicate
        self.tb = tb_enabled(self.mcfg)
        self.clip_tb = clip_tb_enabled(self.mcfg, self.sc)
        # the clip mode its results record (MapResult.clip_open)
        self.clip_open = clip_mode(self.mcfg, self.sc)
        p = self.mcfg.positions_per_seed
        if prepared is None:
            prepared = load_prepared(index, p) or prepare_tables(index, p)
        ht, meta = prepared
        self.tables = tables_from_numpy(ht, meta, self.device)
        self.csr_aligned = self.tables["csr_aligned"]
        self.row128 = self.tables["row128"]
        self.off_bits = self.tables["off_bits"]
        # the tiered gather's width (aligned layout, URMAP_TIER_GATHER=1)
        self.gather_tier = self.tables["gather_tier"]
        self.second = (WideSecondPass(index, self.mcfg, self.sc)
                       if self.mcfg.second_pass_p else None)

    @property
    def layout(self):
        """A batch's flat output (map/output.py) at the current mcfg."""
        from urmap_tpu_torch.map.output import Layout

        return Layout(self.mcfg, self.mcfg.batch_size, tb=self.tb)

    def second_pass(self, codes: np.ndarray, lengths,
                    result: MapResult) -> MapResult:
        """Re-map ``result``'s unmapped and suspect rows through the
        wide second pass on the host CPU and patch the recovered calls
        in place (no-op when second_pass_p is 0). Thread-safe: the CLI
        calls it from its formatting workers, beside the next batch's
        dispatch to the card."""
        with trace.span("urmap.second_pass", result.batch):
            if self.second is None:
                return result
            return self.second(codes, lengths, result)

    def _pad_full(self, codes: np.ndarray, lengths: np.ndarray):
        """Pad to the full [batch_size, max_read_len] block (rows of
        zero-length READ_N reads, columns of READ_N)."""
        B = codes.shape[0]
        bs, Lm = self.mcfg.batch_size, self.mcfg.max_read_len
        if B > bs or codes.shape[1] > Lm:
            raise ValueError(f"batch {codes.shape} exceeds the configured "
                             f"[{bs}, {Lm}]")
        if B < bs or codes.shape[1] < Lm:
            block = np.full((bs, Lm), alphabet.READ_N, np.uint8)
            block[:B, : codes.shape[1]] = codes
            codes = block
            lengths = np.concatenate([lengths, np.zeros(bs - B, np.int32)])
        return codes, lengths.astype(np.int32)

    def prepack(self, codes: np.ndarray, lengths: np.ndarray):
        """Host upload prep (pad + 2-bit pack) for start_batch's
        ``prepacked``; safe to run off the dispatch thread."""
        from urmap_tpu_torch.genome_pack import pack_read_codes_host

        B = codes.shape[0]
        codes, lengths = self._pad_full(codes, lengths)
        pk, nm = pack_read_codes_host(codes)
        return pk, nm, lengths, B

    def start_batch(self, codes: np.ndarray, lengths: np.ndarray, *,
                    prepacked=None):
        """Map one (<= batch_size) batch; returns a handle for
        finish_batch. Device work is queued on the current stream; the
        verify and DP rounds read their loop conditions back, so this
        returns once the last round is queued. The batch's id (tracing
        on, utils/trace.py) rides the handle to finish_batch."""
        batch = trace.new_batch()
        with trace.span("urmap.start_batch", batch):
            pk, nm, lens, B = (prepacked if prepacked is not None
                               else self.prepack(codes, lengths))
            out = map_batch_device(self.tables, None, upload(lens,
                                                             self.device),
                                   icfg=self.icfg, mcfg=self.mcfg,
                                   sc=self.sc,
                                   packed_reads=(upload(pk, self.device),
                                                 upload(nm, self.device)),
                                   tb=self.tb, clip_tb=self.clip_tb)
            packed = self.layout.pack(out)
        return packed, B, batch

    def finish_batch(self, handle, lengths) -> MapResult:
        out, B, batch = handle
        with trace.span("urmap.finish_batch", batch):
            arr = download(out)
            with trace.span("urmap.unpack"):
                res = self.layout.result(arr[None], np.asarray(lengths)[:B],
                                         self.clip_open)
        res.batch = batch
        return res

    def map_codes(self, codes: np.ndarray, lengths: np.ndarray) -> MapResult:
        from urmap_tpu_torch.map.output import join

        B = codes.shape[0]
        bs = self.mcfg.batch_size
        outs = [self.second_pass(
                    codes[s : s + bs], lengths[s : s + bs],
                    self.finish_batch(self.start_batch(codes[s : s + bs],
                                                       lengths[s : s + bs]),
                                      lengths[s : s + bs]))
                for s in range(0, B, bs)]
        return join(outs, lengths)
