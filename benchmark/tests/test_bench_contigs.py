"""A genome of several contigs (a human layout): the streamed read draws,
the chunked FASTA and k-mer index against the whole-genome versions
they replace (kept here as the oracles), the judge over contigs, and
tiny multi-contig cells rehearsed through ``cell_run.run`` on the CPU."""

import hashlib
import json
import os
import shutil
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from benchmark.gen import pairs, reads
from benchmark.gen.genome import (CHARS, COMP, GENOME_N, SEPARATOR, Layout,
                                  draw_starts, genome_from_config,
                                  write_fasta)
from benchmark.harness import cell_run
from benchmark.reference.align import cigar_score, parse_cigar
from benchmark.reference.judge import judge
from benchmark.reference.kmers import KmerIndex, kmer_codes
from benchmark.tests.conftest import TINY

# four GRCh38 chromosomes (GCA_000001405.15), their relative lengths
# kept, ~400 kbp in all
GRCH38 = [("chr1", 248_956_422), ("chr13", 114_364_328),
          ("chr21", 46_709_983), ("chrY", 57_227_415)]
CONTIGS = [[name, round(n * 400_000 / sum(m for _, m in GRCH38))]
           for name, n in GRCH38]
TINY_CONTIGS = {**TINY, "contigs": CONTIGS}


# the draws as they were: a whole-genome cumulative sum and flatnonzero
def old_valid_starts(g, span):
    isn = np.concatenate([[0], np.cumsum(g >= GENOME_N)])
    ok = np.zeros(len(g), bool)
    m = len(g) - span + 1
    if m > 0:
        ok[:m] = isn[span : span + m] - isn[:m] == 0
    return ok


def old_draw_starts(rng, ok, n):
    where = np.flatnonzero(ok)
    if where.size == 0:
        raise ValueError("no N-free window of the asked span in the genome")
    return where[rng.integers(0, where.size, size=n)].astype(np.int64)


# the FASTA as it was: one record, the whole genome copied three times
def old_write_fasta(path, codes, label):
    chars = CHARS[codes]
    width = 80
    full = len(chars) // width * width
    lines = chars[:full].reshape(-1, width)
    nl = np.full((len(lines), 1), ord("\n"), np.uint8)
    with open(path, "wb") as f:
        f.write(f">{label}\n".encode())
        f.write(np.hstack([lines, nl]).tobytes())
        f.write(chars[full:].tobytes() + b"\n")


# the index as it was: every k-mer of the whole genome, sorted by code
class OldKmerIndex(KmerIndex):
    def __init__(self, genome, k, device):
        g = torch.from_numpy(np.ascontiguousarray(genome)).to(device)
        code, ok = kmer_codes(g, k)
        pos = torch.nonzero(ok)[:, 0]
        self.codes, order = torch.sort(code[pos])
        self.pos = pos[order]
        self.k = k
        self.device = device


def n_runs_genome(seed):
    """5,000 bases with N runs across the 64-base chunks' boundaries, at
    both ends and a lone N on a boundary."""
    g = np.random.default_rng(seed).integers(0, 4, 5000).astype(np.uint8)
    for a, b in ((0, 3), (60, 70), (127, 129), (191, 192), (500, 700),
                 (1023, 1100), (4990, 5000)):
        g[a:b] = GENOME_N
    return g


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
def test_streamed_draw_equals_the_whole_genome_draw(seed):
    cases = [(n_runs_genome(seed), span, 64) for span in (1, 24, 150, 700)]
    cases.append((genome_from_config(seed, TINY_CONTIGS), 158, 4096))
    cases.append((genome_from_config(seed, TINY), 632, 1 << 26))
    for g, span, chunk in cases:
        want = old_draw_starts(np.random.default_rng(seed),
                               old_valid_starts(g, span), 3000)
        got = draw_starts(np.random.default_rng(seed), g, span, 3000, chunk)
        assert got.dtype == np.int64 and np.array_equal(got, want)
    with pytest.raises(ValueError):
        draw_starts(np.random.default_rng(seed), n_runs_genome(seed), 4000,
                    10)


def test_contigs_lay_out_and_draws_stay_inside_one():
    lay = Layout.from_config(TINY_CONTIGS)
    g = genome_from_config(3, TINY_CONTIGS)
    assert g.size == lay.size == sum(n for _, n in CONTIGS) + 3 * SEPARATOR
    for i, (s, n) in enumerate(zip(lay.starts, lay.lengths)):
        assert (g[s : s + TINY["leading_n"]] == GENOME_N).all()
        assert (g[s + n : s + n + SEPARATOR] == GENOME_N).all()
        name = CONTIGS[i][0]
        assert lay.offset(name.encode(), 1) == s
        assert lay.locate(int(s + n - 1)) == (name, int(n))
    assert lay.index(b"chr13") == 1 and lay.index(b"chr2") is None
    # each contig from a stream of its own: a longer first contig shifts
    # the others, and changes none of their bases
    longer = [["chr1", CONTIGS[0][1] + 1000]] + CONTIGS[1:]
    g2 = genome_from_config(3, {**TINY, "contigs": longer})
    assert np.array_equal(g2[lay.starts[1] + 1000 :], g[lay.starts[1] :])
    d = reads.generate(4, g, {"reads": 4000, "read_len": 150,
                              "indel_share": 0.1})
    where = [lay.locate(int(p)) for p in d["truth"]["pos"]]
    assert {c for c, _ in where} == {c for c, _ in CONTIGS}
    length = dict(CONTIGS)
    assert all(p + 150 + 16 - 1 <= length[c] for c, p in where)
    pp = pairs.generate(4, g, {"pairs": 2000, "read_len": 150,
                               "fragment": [200, 600]})["truth"]
    for a, b in zip(pp["pos"], pp["pos2"]):
        assert lay.locate(int(a))[0] == lay.locate(int(b))[0]


@pytest.mark.parametrize("length,chunk", [(TINY["genome_length"], 80 * 7),
                                          (TINY["genome_length"] + 37,
                                           80 << 20)])
def test_fasta_bytes_are_the_whole_genome_writers(tmp_path, length, chunk):
    cfg = {**TINY, "genome_label": "chr21", "genome_length": length}
    g = genome_from_config(8, cfg)
    old, new = str(tmp_path / "old.fa"), str(tmp_path / "new.fa")
    old_write_fasta(old, g, "chr21")
    write_fasta(new, g, Layout.from_config(cfg), chunk=chunk)
    digest = [hashlib.sha256(open(p, "rb").read()).hexdigest()
              for p in (old, new)]
    assert digest[0] == digest[1]


def test_fasta_has_a_record_a_contig(tmp_path):
    lay = Layout.from_config(TINY_CONTIGS)
    g = genome_from_config(8, TINY_CONTIGS)
    p = str(tmp_path / "g.fa")
    write_fasta(p, g, lay, chunk=80 * 3)
    recs = open(p, "rb").read().split(b">")[1:]
    assert [r.split(b"\n", 1)[0].decode() for r in recs] == list(lay.names)
    for r, s, n in zip(recs, lay.starts, lay.lengths):
        body = r.split(b"\n", 1)[1]
        assert max(len(x) for x in body.split(b"\n")) == 80
        assert body.replace(b"\n", b"") == CHARS[g[s : s + n]].tobytes()


def hit_set(index, oriented):
    out = set()
    for strand in (0, 1):
        rows, diags = index.diagonals(torch.from_numpy(oriented[:, strand]))
        out |= {(strand, int(r), int(d)) for r, d in zip(rows, diags)}
    return out


def test_chunked_index_gives_the_whole_genome_hits():
    rng = np.random.default_rng(12)
    g = rng.integers(0, 4, 8000).astype(np.uint8)
    g[3000 : 3000 + 1000] = GENOME_N             # a separator
    g[6500:6510] = GENOME_N
    rep = g[100:140].copy()
    at = np.sort(rng.choice(np.arange(4200, 6400, 60), 12, replace=False))
    for p in at:                                 # a 12-copy repeat
        g[p : p + 40] = rep
    g[100:140] = (rep + 1) % 4
    # windows across the 1,000-base chunks' boundaries, into the
    # separator and the short N run, and away from the repeat
    starts = [930, 985, 1990, 2860, 2900, 3950, 3990, 6420, 6480, 7700,
              7850]
    rd = np.stack([g[s : s + 150] for s in starts])
    oriented = np.stack([rd, COMP[rd[:, ::-1]]], axis=1)
    cpu = torch.device("cpu")
    new = KmerIndex(g, 24, cpu, torch.from_numpy(oriented), chunk=1000)
    got = hit_set(new, oriented)
    assert got == hit_set(OldKmerIndex(g, 24, cpu), oriented)
    assert {(s, r) for s, r, _ in got} >= {(0, r) for r in range(len(starts))}
    # the repeat: the 8 lowest of its 12 places
    one = np.stack([rep, COMP[rep[::-1]]])[None]
    idx = KmerIndex(g, 24, cpu, torch.from_numpy(one), chunk=1000)
    rows, diags = idx.diagonals(torch.from_numpy(one[:, 0]))
    assert sorted(set(diags.tolist())) == at[:8].tolist()
    assert rows.size == 8 * (40 - 24 + 1)


def se_line(name, read, contig, pos1, lay, g):
    """A forward record of ``read`` at (contig, POS), its AS and NM
    counted over the array from the contig's start on."""
    s = lay.starts[lay.index(contig)]
    cig = b"%dM" % read.size
    got = cigar_score(parse_cigar(cig), read, g[s:], pos1 - 1, SC)
    return b"\t".join([name, b"0", contig, b"%d" % pos1, b"42", cig, b"*",
                       b"0", b"0", CHARS[read].tobytes(), b"I" * read.size,
                       b"AS:i:%d" % got[0], b"NM:i:%d" % got[1]]) + b"\n"


SC = {"match": 1, "mismatch": -2, "gap_open": -4, "gap_extend": -1,
      "clip_open": -5}
CFG = {"scores": SC, "check": {"k": 24},
       "calls": {"min_score_frac": 0.4, "max_mapq": 42, "mapq_scale": 6.0,
                 "distinct": 160, "rescue_mapq_cap": 30,
                 "fragment": [50, 1000]}}


def test_judge_holds_records_to_their_contig():
    lay = Layout.of([("chrA", 3000), ("chrB", 4000)])
    g = np.full(lay.size, GENOME_N, np.uint8)
    g[: 3000] = np.random.default_rng(2).integers(0, 4, 3000)
    sB = lay.starts[1]
    g[sB : sB + 4000] = np.random.default_rng(3).integers(0, 4, 4000)
    # on chrB at POS 501, and on chrA up to 4 bases from its end
    rd = np.stack([g[sB + 500 : sB + 650], g[2846:2996]])
    lines = [se_line(b"r0", rd[0], b"chrB", 501, lay, g),
             se_line(b"r1", rd[1], b"chrA", 2847, lay, g)]
    ok = judge(g, lay, rd, lines, CFG, paired=False,
               truth_pos=np.array([sB + 500, 2846]))
    assert (ok["bad_records"], ok["score_gap"], ok["truth_share"]) == (0, 0,
                                                                      1.0)
    # RNAME changed to the other contig at the same POS
    moved = [lines[0].replace(b"\tchrB\t", b"\tchrA\t"), lines[1]]
    assert judge(g, lay, rd, moved, CFG, paired=False)["bad_records"] == 1
    # a CIGAR running 4 bases past chrA's end, its NM and AS counted
    # over the N beyond it (the array, not the contig, would take it)
    tail = np.concatenate([g[2854:3000], np.zeros(4, np.uint8)])
    past = se_line(b"r1", tail, b"chrA", 2855, lay, g)
    assert cigar_score(parse_cigar(b"150M"), tail, g, 2854, SC)[1] == 4
    out = judge(g, lay, np.stack([rd[0], tail]), [lines[0], past], CFG,
                paired=False)
    assert out["bad_records"] == 1 and "does not fit" in out["why"][0]
    # an unknown RNAME
    bad = [lines[0].replace(b"\tchrB\t", b"\tchrC\t"), lines[1]]
    assert judge(g, lay, rd, bad, CFG, paired=False)["bad_records"] == 1


def pair_lines(lay, g, where1, where2, rnext1, rnext2, tlen, proper=0):
    """Mate 1 forward at ``where1``, mate 2 reverse at ``where2``
    ((contig, 0-based start)), exact, with the given RNEXT and TLEN →
    (reads as sequenced, records)."""
    rows, out = [], []
    for (c, p), (_, mp), rn, flag, t in (
            (where1, where2, rnext1, 0x61 | proper, tlen),
            (where2, where1, rnext2, 0x91 | proper, -tlen)):
        s = lay.starts[lay.index(c)]
        fwd = g[s + p : s + p + 150]
        rows.append(COMP[fwd[::-1]] if flag & 0x10 else fwd)
        out.append(b"\t".join([b"p0", b"%d" % flag, c, b"%d" % (p + 1),
                               b"42", b"150M", rn, b"%d" % (mp + 1),
                               b"%d" % t, CHARS[fwd].tobytes(), b"I" * 150,
                               b"AS:i:150", b"NM:i:0"]) + b"\n")
    return np.stack(rows), out


def test_mates_on_two_contigs_name_each_other():
    lay = Layout.of([("chrA", 3000), ("chrB", 4000)])
    g = np.full(lay.size, GENOME_N, np.uint8)
    g[: 3000] = np.random.default_rng(4).integers(0, 4, 3000)
    sB = lay.starts[1]
    g[sB : sB + 4000] = np.random.default_rng(5).integers(0, 4, 4000)
    rd, ln = pair_lines(lay, g, (b"chrA", 1000), (b"chrB", 1200), b"chrB",
                        b"chrA", 0)
    out = judge(g, lay, rd, ln, CFG, paired=True)
    assert out["bad_records"] == 0, out["why"]
    # "=" across two contigs, a TLEN across them, or 0x2: wrong
    for r1, r2, t, proper in ((b"=", b"=", 0, 0), (b"chrB", b"chrA", 350, 0),
                              (b"chrB", b"chrA", 0, 2)):
        rd, ln = pair_lines(lay, g, (b"chrA", 1000), (b"chrB", 1200), r1,
                            r2, t, proper)
        assert judge(g, lay, rd, ln, CFG, paired=True)["bad_records"] == 2
    # on one contig: "=", the span and 0x2 (FR, 350 bases)
    rd, ln = pair_lines(lay, g, (b"chrB", 1000), (b"chrB", 1200), b"=",
                        b"=", 350, 2)
    out = judge(g, lay, rd, ln, CFG, paired=True)
    assert out["bad_records"] == 0, out["why"]


@pytest.fixture(scope="module")
def contig_root(tiny_root, tmp_path_factory):
    """The tiny root with a four-contig configuration of each kind and
    its cells (new files and entries only)."""
    root = str(tmp_path_factory.mktemp("contigs") / "root")
    shutil.copytree(tiny_root, root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, src, mix in (("tiny_ctg_se", "tiny_se", "tiny_wgs"),
                           ("tiny_ctg_pe", "tiny_pe", "tiny_pairs")):
        conf = os.path.join(root, "benchmark", "configs", src + ".json")
        with open(conf) as f:
            cfg = json.load(f)
        del cfg["genome_label"], cfg["genome_length"]
        cfg["contigs"] = CONTIGS
        with open(os.path.join(root, "benchmark", "configs",
                               name + ".json"), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": "tiny",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "tiny"})
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": mix, "chips": 1,
                                   "why": "tiny"})
        for m in bench["per_layer"]:
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run(root, cell, seed):
    return cell_run.run(root, cell, seed, 4.0, False, torch.device("cpu"),
                        time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny_ctg_se", "tiny_ctg_pe"])
def test_contig_cells_rehearse_correct(contig_root, cell):
    res, checks = run(contig_root, cell, 2**31 + 23)
    assert res["correct"], checks
    assert res["attempted"] > 0


@contextmanager
def altered_records(change):
    """Every 8th mapped single-end record of each batch changed by
    ``change(fields)`` as the program's SAM formatter writes it."""
    from urmap_tpu_torch.io import sam_native

    fmt = sam_native.format_single_end

    def altered(*args, **kwargs):
        lines = fmt(*args, **kwargs).split(b"\n")
        mapped = [i for i, ln in enumerate(lines)
                  if ln and not int(ln.split(b"\t")[1]) & 4]
        for i in mapped[::8]:
            f = lines[i].split(b"\t")
            change(f)
            lines[i] = b"\t".join(f)
        return b"\n".join(lines)

    sam_native.format_single_end = altered
    try:
        yield
    finally:
        sam_native.format_single_end = fmt


def next_contig(f):
    names = [c for c, _ in CONTIGS]
    f[2] = names[(names.index(f[2].decode()) + 1) % len(names)].encode()


def past_the_end(f):
    f[3] = b"%d" % (dict(CONTIGS)[f[2].decode()] - 99)


@pytest.mark.parametrize("change", [next_contig, past_the_end])
def test_records_off_their_contig_are_not_correct(contig_root, change):
    with altered_records(change):
        res, checks = run(contig_root, "tiny_ctg_se", 31)
    assert not res["correct"]
    assert dict((n, v) for n, v, _ in checks)["bad_records"] > 0
