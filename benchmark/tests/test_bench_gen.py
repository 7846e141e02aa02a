"""The traffic generators: deterministic by seed, exact counts of each
kind, reads where the truth says, FASTQ records that parse back."""

import numpy as np

from benchmark.gen import pairs, reads
from benchmark.gen.fastq import read_index, write_fastq
from benchmark.gen.genome import (COMP, draw_starts, free_runs,
                                  genome_from_config)
from benchmark.tests.conftest import TINY

SE = {"reads": 4000, "read_len": 150, "snp_rate": 0.01, "indel_share": 0.08,
      "indel_len": [1, 8], "adapter_share": 0.05, "adapter_len": [65, 75],
      "junk_share": 0.01}
PE = {"pairs": 2000, "read_len": 150, "fragment": [200, 600],
      "snp_rate": 0.01, "indel_share": 0.05, "rescue_share": 0.05,
      "junk_share": 0.01}


def genome(seed=5):
    return genome_from_config(seed, TINY)


def test_genome_is_the_seeds():
    a, b, c = genome(5), genome(5), genome(6)
    assert a.size == TINY["genome_length"]
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert (a[: TINY["leading_n"]] == 4).all()


def test_reads_are_the_seeds_with_exact_kinds():
    g = genome()
    a, b = reads.generate(9, g, SE), reads.generate(9, g, SE)
    c = reads.generate(10, g, SE)
    assert np.array_equal(a["codes"], b["codes"])
    assert not np.array_equal(a["codes"], c["codes"])
    for d in (a, c):
        kind = d["truth"]["kind"]
        assert [(kind == k).sum() for k in (1, 2, 3)] == [320, 200, 40]
        assert d["codes"].shape == (4000, 150) and d["codes"].max() <= 3


def test_clean_reads_sit_at_their_truth():
    g = genome()
    d = reads.generate(3, g, dict(SE, snp_rate=0.0, indel_share=0.0,
                                  adapter_share=0.0, junk_share=0.0))
    t = d["truth"]
    for i in range(0, 4000, 97):
        fwd = g[t["pos"][i] : t["pos"][i] + 150]
        want = COMP[fwd[::-1]] if t["strand"][i] else fwd
        assert np.array_equal(d["codes"][i], want)


def test_pairs_geometry_and_rescue_mates():
    g = genome()
    d = pairs.generate(4, g, PE)
    t = d["truth"]
    assert np.array_equal(d["codes"], pairs.generate(4, g, PE)["codes"])
    ok = t["pos"] >= 0
    left = np.minimum(t["pos"], t["pos2"])[ok]
    right = np.maximum(t["pos"], t["pos2"])[ok]
    frag = right + 150 - left
    assert frag.min() >= 200 and frag.max() <= 600
    assert (t["strand"] != t["strand2"]).all()
    # a rescue mate keeps no 24-mer of its genome stretch
    for i in np.flatnonzero(t["kind"] == pairs.RESCUE)[:20]:
        m = t["mutated"][i]
        code = d["codes"][i] if m == 1 else d["codes2"][i]
        pos = t["pos"][i] if m == 1 else t["pos2"][i]
        strand = t["strand"][i] if m == 1 else t["strand2"][i]
        seq = COMP[code[::-1]] if strand else code
        ref = g[pos : pos + 150]
        same = seq == ref
        run = max(len(s) for s in "".join("1" if x else "0"
                                          for x in same).split("0"))
        assert run < 24


def test_valid_starts_avoid_n():
    g = np.array([0, 1, 4, 2, 3, 0, 1], np.uint8)
    assert [r.tolist() for r in free_runs(g)] == [[0, 3], [2, 7]]
    got = draw_starts(np.random.default_rng(1), g, 3, 200)
    assert set(got.tolist()) == {3, 4}


def test_fastq_records_round_trip(tmp_path):
    codes = np.random.default_rng(1).integers(0, 4, (5, 12), dtype=np.uint8)
    p = str(tmp_path / "r.fq")
    n = write_fastq(p, codes, b"r")
    data = open(p, "rb").read()
    assert n == len(data)
    lines = data.split(b"\n")
    assert lines[0] == b"@r000000000" and lines[4] == b"@r000000001"
    assert lines[1] == np.frombuffer(b"ACGT", np.uint8)[codes[0]].tobytes()
    assert lines[3] == b"I" * 12
    assert read_index(b"r000000004", b"r") == 4
