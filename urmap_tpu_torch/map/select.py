"""Hit selection: best/second-best alignment, MAPQ, mapped flag.

Canonical order (urmap_tpu/map/select.py): score desc, then POS asc,
then forward strand first. Second-best is the best score at a distinct
locus, |POS − best_POS| > max_read_len.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.config import MapConfig
from urmap_tpu_torch.map.dp import NEG
from urmap_tpu_torch.map.seed import SENTINEL
from urmap_tpu_torch.utils import trace


def host_scalar(value: float, device: torch.device) -> torch.Tensor:
    """A float32 scalar sent from the host to ``device`` (from pageable
    memory: the host waits for the stream, a sync)."""
    with trace.sync("const"):
        return torch.tensor(value, dtype=torch.float32, device=device)


def select_hits(pos, scores, strands, valid, lengths, ungapped, *,
                mc: MapConfig, k: int) -> dict:
    """Per-read candidates [B, C] → dict of per-read calls: mapped, pos,
    strand, score, second, mapq, gapped, ungapped."""
    scores = torch.where(valid, scores, NEG)
    pos = torch.where(valid, pos, SENTINEL)

    # cascaded reductions in the tie order score desc, pos asc, strand asc
    best_score = scores.amax(dim=-1)
    at_best = scores == best_score[:, None]
    best_pos = torch.where(at_best, pos, SENTINEL).amin(dim=-1)
    at_best &= pos == best_pos[:, None]
    best_strand = torch.where(at_best, strands, 2).amin(dim=-1)
    at_best &= strands == best_strand[:, None]
    # residual tie (same score/pos/strand): the first such candidate
    first = at_best.to(torch.int8).argmax(dim=-1)
    best_ung = torch.gather(ungapped, 1, first[:, None])[:, 0]

    distinct = ((pos - best_pos[:, None]).abs() > mc.max_read_len) \
        & (scores > NEG)
    second = torch.where(distinct, scores, NEG).amax(dim=-1)

    f32 = torch.float32
    frac = host_scalar(mc.min_score_frac, lengths.device)
    min_score = torch.ceil(frac * lengths.to(f32)).to(torch.int32)
    mapped = (best_score > NEG) & (best_score >= min_score) & (lengths >= k)

    # MAPQ = clip(round(scale * (best - second)), 0, max) in float32;
    # torch.round rounds half to even, as jnp.round does in the
    # reference. No competing locus → max.
    scale = host_scalar(mc.mapq_scale, lengths.device)
    gap = (best_score - second).to(f32)
    mapq = torch.round(scale * gap).clamp(0, mc.max_mapq).to(torch.int32)
    mapq = torch.where(second <= NEG // 2, mc.max_mapq, mapq)
    mapq = torch.where(mapped, mapq, 0)

    return {
        "mapped": mapped,
        "pos": best_pos,
        "strand": best_strand.to(torch.int32),
        "score": best_score,
        "second": second,
        "mapq": mapq,
        "gapped": mapped & (best_ung < best_score),
        "ungapped": best_ung,
    }
