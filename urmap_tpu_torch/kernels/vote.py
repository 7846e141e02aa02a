"""Kernel B4 wrapper: candidate diagonal vote.

CUDA tensors launch ``csrc/vote.cu`` (replaces
urmap_tpu/kernels/vote.py:vote_pallas); CPU tensors run the plain
version, map.seed.vote_top_candidates. The two are bit-equal. Up to 128
candidates a read take the register body, up to ``MAX_M`` the
shared-memory body (csrc/vote.cu); the operator refuses more.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build
from urmap_tpu_torch.map.seed import vote_top_candidates

counter = Counter("vote")
MAX_M = 4096  # candidates a read (Q x P) the kernel takes


def vote(cand: torch.Tensor, *, v: int):
    """cand int32[N, M] → (top_cand int32[N, V], votes int32[N, V])."""
    if not cand.is_cuda:
        counter.plain()
        return vote_top_candidates(cand, v=v)
    _build.load()
    top, votes = torch.ops.urmap.vote(cand, v)
    counter.launched(cand.shape[1])
    return top, votes
