"""Kernel B4 wrapper: candidate diagonal vote.

CUDA tensors launch ``csrc/vote.cu`` (replaces
urmap_tpu/kernels/vote.py:vote_pallas); CPU tensors run the plain
version, map.seed.vote_top_candidates. The two are bit-equal.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build
from urmap_tpu_torch.map.seed import vote_top_candidates

counter = Counter("vote")
MAX_M = 128


def vote(cand: torch.Tensor, *, v: int):
    """cand int32[N, M] → (top_cand int32[N, V], votes int32[N, V])."""
    if not cand.is_cuda:
        counter.plain_calls += 1
        return vote_top_candidates(cand, v=v)
    _build.require_cuda(cand, "cand", torch.int32, 2)
    n, m = cand.shape
    if not (1 <= m <= MAX_M and 1 <= v <= m):
        raise ValueError(f"vote: unsupported M={m}, V={v} (M <= {MAX_M})")
    top = torch.empty((n, v), dtype=torch.int32, device=cand.device)
    votes = torch.empty((n, v), dtype=torch.int32, device=cand.device)
    err = _build.lib().urmap_vote(cand.data_ptr(), top.data_ptr(),
                                  votes.data_ptr(), n, m, v,
                                  _build.stream_ptr(cand.device))
    _build.check(err, "urmap_vote")
    counter.launched()
    return top, votes
