"""urmap_tpu_torch banded DP against urmap_tpu (exact).

banded_from_windows (kernel B1's plain version) against the jnp
function and the Pallas kernel in interpret mode, and banded_packed
against urmap_tpu.map.dp.banded_packed(use_pallas=False), in plain and
clip_open mode, at band half-widths 16 and 8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401  (one torch thread)
from urmap_tpu import genome_pack as jgpk
from urmap_tpu.config import ScoreConfig
from urmap_tpu.kernels.banded_dp import pallas_from_windows
from urmap_tpu.map import dp as jdp
from urmap_tpu_torch import _bits
from urmap_tpu_torch import genome_pack as tgpk
from urmap_tpu_torch.kernels import banded_dp as kdp
from urmap_tpu_torch.map import dp as tdp

SC = ScoreConfig()
L = 100


def _cases(rng, n, hw, genome):
    """Candidates around planted reads: exact, SNPs, indels, adapter
    tails, unrelated reads (negative packed scores), short and empty."""
    G = genome.shape[0]
    starts = rng.integers(100, G - L - 100, n).astype(np.int64)
    reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    for i in range(n):
        kind = i % 6
        if kind == 1:
            reads[i, rng.integers(0, L, 4)] = rng.integers(0, 4, 4)
        elif kind == 2:
            o, d = rng.integers(8, L - 8), rng.integers(1, 6)
            seg = genome[starts[i] : starts[i] + L + d]
            reads[i] = np.concatenate([seg[:o], seg[o + d :]])[:L]
        elif kind == 3:
            o, d = rng.integers(8, L - 8), rng.integers(1, 6)
            reads[i] = np.concatenate(
                [reads[i, :o], rng.integers(0, 4, d), reads[i, o:]])[:L]
        elif kind == 4:
            reads[i, L - 40 :] = rng.integers(0, 4, 40)
        elif kind == 5:
            reads[i] = rng.integers(0, 4, L)
    reads[rng.random(reads.shape) < 0.01] = 5
    reads[reads == 4] = 5
    lengths = np.full(n, L, np.int32)
    lengths[::7] = rng.integers(0, L, len(lengths[::7]))
    reads[np.arange(L)[None, :] >= lengths[:, None]] = 5
    cand = (starts + rng.integers(-hw + 1, hw, n)).astype(np.int32)
    return cand, reads.astype(np.uint8), lengths


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 30_000).astype(np.uint8)
    g[5000:5050] = 4
    return g


@pytest.mark.parametrize("hw", [16, 8])
@pytest.mark.parametrize("clip", [None, SC.clip_open])
def test_banded_from_windows_matches(rng, genome, hw, clip):
    n = 72
    cand, reads, lengths = _cases(rng, n, hw, genome)
    widx = cand[:, None] - hw + np.arange(L + 2 * hw)[None, :]
    windows = genome[np.clip(widx, 0, genome.shape[0] - 1)]
    kdp.counter.reset()
    kdp.clip_counter.reset()
    got = kdp.banded_from_windows(torch.from_numpy(windows),
                                  torch.from_numpy(reads),
                                  torch.from_numpy(lengths), hw=hw, sc=SC,
                                  clip_open=clip)
    cnt = kdp.counter if clip is None else kdp.clip_counter
    assert (cnt.plain_calls, cnt.launches) == (1, 0)
    wj, rj, lj = (jnp.asarray(a) for a in (windows, reads, lengths))
    want = jdp.banded_from_windows(wj, rj, lj, hw=hw, sc=SC, clip_open=clip)
    for a, b in zip(want, got[:3]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want_k = pallas_from_windows(wj, rj, lj, hw=hw, sc=SC, block_r=128,
                                 interpret=True, clip_open=clip)
    for a, b in zip(want_k, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (got[0].numpy() < 0).any()       # negative packed scores


@pytest.mark.parametrize("hw", [16, 8])
@pytest.mark.parametrize("clip", [None, SC.clip_open])
def test_banded_packed_matches(rng, genome, hw, clip):
    n = 64
    cand, reads, lengths = _cases(rng, n, hw, genome)
    inter, off = jgpk.pack_genome(genome)
    nw = -(-L // 16)
    jw = jgpk.pack_reads(jnp.asarray(reads), jnp.asarray(lengths), nw)
    want = jdp.banded_packed(jnp.asarray(inter), off, jnp.asarray(cand),
                             jnp.asarray(reads), jnp.asarray(lengths), *jw,
                             hw=hw, sc=SC, use_pallas=False, clip_open=clip)
    tw = tgpk.pack_reads(torch.from_numpy(reads), torch.from_numpy(lengths),
                         nw)
    got = tdp.banded_packed(torch.from_numpy(_bits.as_i32(inter)), off,
                            torch.from_numpy(cand), torch.from_numpy(reads),
                            torch.from_numpy(lengths), *tw, hw=hw, sc=SC,
                            clip_open=clip)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
