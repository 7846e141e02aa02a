"""The port's command line against urmap_tpu's, on the same inputs.

``urmap_tpu_torch.cli.main(argv, device="cpu")`` and
``urmap_tpu.cli.main(argv)`` over one planted corpus: -make_ufi writes
byte-equal index directories, -ufistats prints the same, each package's
-map reads the other's index and writes the same SAM bytes (single-end,
paired, -endclip both ways, -secondpass, -resume after a cut shard,
.sam.gz, reads past -maxreadlen), -make_ufi -veryfast (auto slot_bits
+ 2) writes the same directory and -map on it the same SAM bytes,
single-end and paired, -make_ufi -device_build on the CPU
writes the same directory, and what is not ported or not launchable
refuses. The @PG line carries sys.argv, so both packages run
under the same sys.argv.
"""

import filecmp
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests.utils import make_seqdb, plant_pair, plant_read, write_fastq
from urmap_tpu import alphabet
from urmap_tpu import cli as jcli
from urmap_tpu_torch import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BATCH = ["-batch", "64"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A two-chromosome genome, 200 single-end reads (SNPs, indels,
    60-base adapter tails, junk) and 80 FR pairs (some with a mate that
    only the rescue scan places, some with an adapter tail on mate 1),
    and the index built by both CLIs."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(41)
    db = make_seqdb(rng, [150_000, 60_000])
    fa = str(d / "g.fa")
    with open(fa, "w") as f:
        for lab, s, n in zip(db.labels, db.starts, db.lengths):
            f.write(f">{lab}\n{alphabet.decode(db.codes[s : s + n])}\n")
    reads = []
    for i in range(200):
        kind = i % 6
        if kind == 0:
            r = plant_read(rng, db, n_snps=2)
        elif kind == 1:
            r = plant_read(rng, db, dels=3)
        elif kind == 2:
            r = plant_read(rng, db, ins=2, n_snps=1)
        elif kind == 3:
            r = plant_read(rng, db, length=90, strand=0)
            r.codes = np.concatenate(
                [r.codes, rng.integers(0, 4, 60).astype(np.uint8)])
        elif kind == 4:
            r = plant_read(rng, db)
            r.codes = rng.integers(0, 4, 150).astype(np.uint8)
        else:
            r = plant_read(rng, db)
        reads.append(r)
    write_fastq(str(d / "se.fq"), reads)
    pairs = [plant_pair(rng, db, length=120, frag=int(rng.integers(250, 500)),
                        snp_every=15 if i % 8 == 0 else None)
             for i in range(80)]
    for p in pairs[3::8]:          # a 45-base adapter tail on mate 1
        p[0].codes[-45:] = rng.integers(0, 4, 45)
    write_fastq(str(d / "r1.fq"), [p[0] for p in pairs])
    write_fastq(str(d / "r2.fq"), [p[1] for p in pairs])
    sys_argv = sys.argv
    try:
        for name, mod, kw in (("j", jcli, {}), ("t", tcli, {})):
            sys.argv = ["urmap"]
            assert mod.main(["-make_ufi", fa, "-output", str(d / f"{name}.ufi"),
                             "-slot_bits", "16"], **kw) == 0
    finally:
        sys.argv = sys_argv
    return d


def _both(d, monkeypatch, args, name, *, cross=True, index=""):
    """Run -map ``args`` through both packages (each on the other's
    index when ``cross``; ``index`` names the pair of index directories
    after the package letter) → (urmap_tpu's SAM bytes, the port's)."""
    out = []
    for pkg, mod, kw in (("j", jcli, {}), ("t", tcli, {"device": "cpu"})):
        ufi = {"j": "t", "t": "j"}[pkg] if cross else pkg
        sam = str(d / f"{name}_{pkg}.sam")
        full = ["-map", *args, "-ufi", str(d / f"{ufi}{index}.ufi"),
                "-samout", sam, "-quiet"]
        # the @PG line: the same command line for both
        monkeypatch.setattr(sys, "argv", ["urmap", *args])
        assert mod.main(full, **kw) == 0
        with open(sam, "rb") as f:
            out.append(f.read())
    return out


def test_make_ufi_writes_equal_index_directories(corpus):
    j, t = str(corpus / "j.ufi"), str(corpus / "t.ufi")
    files = []
    for base, _dirs, names in os.walk(j):
        files += [os.path.relpath(os.path.join(base, n), j) for n in names]
    theirs = []
    for base, _dirs, names in os.walk(t):
        theirs += [os.path.relpath(os.path.join(base, n), t) for n in names]
    assert sorted(files) == sorted(theirs) and len(files) > 3
    match, mismatch, errors = filecmp.cmpfiles(j, t, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.fixture(scope="module")
def veryfast(corpus):
    """-make_ufi -veryfast over the corpus's genome by both CLIs, with no
    -slot_bits, so that the auto slot_bits + 2 and the header flag
    apply: the directories jvf.ufi and tvf.ufi."""
    fa = str(corpus / "g.fa")
    sys_argv = sys.argv
    try:
        for name, mod in (("jvf", jcli), ("tvf", tcli)):
            sys.argv = ["urmap"]
            assert mod.main(["-make_ufi", fa, "-output",
                             str(corpus / f"{name}.ufi"), "-veryfast"]) == 0
    finally:
        sys.argv = sys_argv
    return corpus


def _files(d):
    return sorted(os.path.relpath(os.path.join(base, n), d)
                  for base, _dirs, names in os.walk(d) for n in names)


def test_make_ufi_veryfast_writes_equal_index_directories(veryfast):
    """C.2: -make_ufi -veryfast writes urmap_tpu's directory byte for
    byte: slot_bits auto + 2, the veryfast flag, and the tables prepared
    at VERYFAST_MAP_OVERRIDES' positions_per_seed."""
    from urmap_tpu_torch.config import VERYFAST_MAP_OVERRIDES, IndexConfig
    from urmap_tpu_torch.index import UfiIndex

    j, t = str(veryfast / "jvf.ufi"), str(veryfast / "tvf.ufi")
    files = _files(t)
    assert files == _files(j)
    p = VERYFAST_MAP_OVERRIDES["positions_per_seed"]
    assert any(f.startswith(f"prepared_p{p}") for f in files), files
    match, mismatch, errors = filecmp.cmpfiles(j, t, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    idx = UfiIndex.load(t)
    assert idx.config.veryfast
    assert idx.config.slot_bits == IndexConfig.auto_slot_bits(
        idx.seqdb.total_len) + 2
    assert not UfiIndex.load(str(veryfast / "t.ufi")).config.veryfast


@pytest.mark.parametrize("case", ["se", "pe"])
def test_map_veryfast_writes_urmap_tpus_sam(veryfast, monkeypatch, case):
    """C.2: -map on a -veryfast index (VERYFAST_MAP_OVERRIDES narrow the
    gathers) writes urmap_tpu's SAM bytes, single-end and with
    -reverse, each package on the other's index."""
    if case == "pe":
        args = [str(veryfast / "r1.fq"), "-reverse", str(veryfast / "r2.fq")]
    else:
        args = [str(veryfast / "se.fq")]
    want, got = _both(veryfast, monkeypatch, [*args, *BATCH], f"vf_{case}",
                      index="vf")
    n = 160 if case == "pe" else 200
    assert got.count(b"\n") - got.count(b"\n@") - 1 == n
    assert got == want
    body = [ln.split(b"\t") for ln in got.split(b"\n")
            if ln and not ln.startswith(b"@")]
    assert sum(not int(f[1]) & 4 for f in body) > 0.8 * n


def test_ufistats_prints_the_same(corpus, capsys):
    for mod in (jcli, tcli):
        assert mod.main(["-ufistats", str(corpus / "t.ufi")]) == 0
    out = capsys.readouterr().out.split("\n")
    half = len(out) // 2
    assert out[:half] == out[half : 2 * half] and "k=" in out[0]


CASES = {
    "se": [],
    "se_endclip": ["-endclip"],
    "se_secondpass": ["-secondpass", "32"],
    "pe": ["-reverse", "{r2}"],
    "pe_endclip": ["-reverse", "{r2}", "-endclip"],
    "pe_secondpass": ["-reverse", "{r2}", "-secondpass", "32"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_map_writes_urmap_tpus_sam(corpus, monkeypatch, case):
    fq = str(corpus / ("r1.fq" if case.startswith("pe") else "se.fq"))
    extra = [a.format(r2=str(corpus / "r2.fq")) for a in CASES[case]]
    want, got = _both(corpus, monkeypatch, [fq, *BATCH, *extra], case)
    n = 160 if case.startswith("pe") else 200
    assert got.count(b"\n") - got.count(b"\n@") - 1 == n
    assert got == want
    body = [ln.split(b"\t") for ln in got.split(b"\n")
            if ln and not ln.startswith(b"@")]
    clipped = sum(f[5].endswith(b"S") for f in body)
    if "endclip" in case:
        assert clipped > 0


def test_secondpass_equals_the_plain_run_here(corpus, monkeypatch):
    """On this corpus the first pass already maps every mappable read at
    the default cap: -secondpass 32 changes no record (the check urmap_tpu
    keeps for its own corpus), single-end and paired."""
    monkeypatch.setattr(sys, "argv", ["urmap"])
    for src in (["se.fq"], ["r1.fq", "-reverse", "r2.fq"]):
        args = [str(corpus / a) if a.endswith(".fq") else a for a in src]
        bodies = []
        for extra in ([], ["-secondpass", "32"]):
            out = str(corpus / "sp_t.sam")
            assert tcli.main(["-map", *args, "-ufi", str(corpus / "t.ufi"),
                              "-samout", out, *BATCH, "-quiet", *extra],
                             device="cpu") == 0
            with open(out, "rb") as f:
                bodies.append(f.read())
        assert bodies[1] == bodies[0]


def test_resume_after_a_cut_shard(corpus, monkeypatch):
    """A shard with one committed batch and a torn tail: -resume keeps
    the batch, drops the tail and maps the rest, as urmap_tpu does."""
    fq = str(corpus / "se.fq")
    outs = []
    for pkg, mod, mh, kw in (
            ("j", jcli, "urmap_tpu.dist.multihost", {}),
            ("t", tcli, "urmap_tpu_torch.dist.multihost", {"device": "cpu"})):
        import importlib

        mhm = importlib.import_module(mh)
        sam = str(corpus / f"resume_{pkg}.sam")
        w = mhm.ShardWriter(sam, 0)
        w.append_batch(b"FAKE\n", 64)
        w.close()
        with open(w.path, "ab") as f:
            f.write(b"torn tail")
        monkeypatch.setattr(sys, "argv", ["urmap", "-resume"])
        assert mod.main(["-map", fq, "-ufi", str(corpus / "t.ufi"),
                         "-samout", sam, *BATCH, "-quiet", "-resume"],
                        **kw) == 0
        with open(sam, "rb") as f:
            outs.append(f.read())
        assert not os.path.exists(sam + ".shard0")
    assert outs[1] == outs[0]
    body = [ln for ln in outs[1].split(b"\n") if ln and ln[:1] != b"@"]
    assert body[0] == b"FAKE" and len(body) == 1 + 200 - 64


def test_gzip_samout_equals_plain(corpus, monkeypatch):
    fq = str(corpus / "se.fq")
    monkeypatch.setattr(sys, "argv", ["urmap"])
    got = {}
    for ext in ("sam", "sam.gz"):
        out = str(corpus / f"gz_t.{ext}")
        assert tcli.main(["-map", fq, "-ufi", str(corpus / "t.ufi"),
                          "-samout", out, *BATCH, "-quiet"],
                         device="cpu") == 0
        opener = gzip.open if ext.endswith("gz") else open
        with opener(out, "rb") as f:
            got[ext] = f.read()
    assert got["sam.gz"] == got["sam"] and got["sam"].count(b"\n") > 200


def test_reads_past_maxreadlen_are_soft_clipped(corpus, monkeypatch):
    """130-base reads under -maxreadlen 100 map on their first 100
    bases; the tail is soft-clipped (forward: trailing S; reverse:
    leading S), and the SAM equals urmap_tpu's."""
    import re

    rng = np.random.default_rng(3)
    from urmap_tpu.io.fasta import SeqDB

    db = SeqDB.from_fasta(str(corpus / "g.fa"))
    reads = [plant_read(rng, db, length=130, strand=s % 2) for s in range(16)]
    fq = str(corpus / "long.fq")
    write_fastq(fq, reads)
    want, got = _both(corpus, monkeypatch,
                      [fq, "-batch", "16", "-maxreadlen", "100"], "long")
    assert got == want
    n = 0
    for line in got.decode().split("\n"):
        if not line or line.startswith("@"):
            continue
        f = line.split("\t")
        flag, cigar = int(f[1]), f[5]
        if flag & 4:
            continue
        ops = re.findall(r"(\d+)([MIDS])", cigar)
        assert sum(int(k) for k, op in ops if op in "MIS") == 130, cigar
        assert (ops[0] if flag & 16 else ops[-1]) == ("30", "S"), cigar
        n += 1
    assert n >= 15


def test_selfcheck_threads_0_and_mesh_auto_change_nothing(corpus,
                                                          monkeypatch):
    """-selfcheck audits and stays silent, -threads 0 maps synchronously
    and -mesh auto keeps to one device here: the SAM body is the plain
    run's."""
    fq = str(corpus / "se.fq")
    monkeypatch.setattr(sys, "argv", ["urmap"])
    bodies = []
    for extra in ([], ["-selfcheck"], ["-threads", "0"], ["-mesh", "auto"],
                  ["-reverse", str(corpus / "r2.fq"), "-selfcheck"]):
        src = str(corpus / "r1.fq") if "-reverse" in extra else fq
        out = str(corpus / "sc_t.sam")
        assert tcli.main(["-map", src, "-ufi", str(corpus / "t.ufi"),
                          "-samout", out, *BATCH, "-quiet", *extra],
                         device="cpu") == 0
        with open(out, "rb") as f:
            bodies.append(f.read())
    assert bodies[1] == bodies[0] == bodies[2] == bodies[3]
    assert bodies[4].count(b"\n") - bodies[4].count(b"\n@") - 1 == 160


def test_profile_writes_a_trace_and_logs(corpus, monkeypatch):
    prof = corpus / "prof"
    log, met = str(corpus / "run.log"), str(corpus / "m.jsonl")
    monkeypatch.setattr(sys, "argv", ["urmap"])
    assert tcli.main(["-map", str(corpus / "se.fq"), "-ufi",
                      str(corpus / "t.ufi"), "-samout",
                      str(corpus / "prof.sam"), *BATCH, "-quiet", "-profile",
                      str(prof), "-log", log, "-metrics", met],
                     device="cpu") == 0
    traces = [n for n in os.listdir(prof) if n.endswith(".json")]
    assert traces and os.path.getsize(prof / traces[0]) > 0
    assert "200 reads" in open(log).read()
    lines = [json.loads(ln) for ln in open(met).read().splitlines()]
    assert len(lines) == 4                               # one a batch
    # both turn the program's spans on: the trace holds them beside
    # torch's operators, on the dispatch thread and the workers
    with open(prof / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"urmap.start_batch", "urmap.sync[upload]", "urmap.sync[download]",
            "urmap.finish_batch", "urmap.unpack", "urmap.second_pass",
            "urmap.cigars", "urmap.cigars.compose", "urmap.sam"} <= names
    span_tids = {e["tid"] for e in events
                 if e.get("name") in ("urmap.start_batch", "urmap.sam")}
    assert len(span_tids) >= 2
    # each metrics line: its batch's span totals (ms) and counters
    for ln in lines:
        assert ln["span_ms"]["urmap.start_batch"] > 0
        assert ln["span_ms"]["urmap.cigars"] > 0
        assert ln["span_ms"]["urmap.sam"] > 0
        assert ln["counts"]["host_syncs"] >= 4
        assert ln["counts"]["rows.replay"] + sum(
            ln["counts"].get(k, 0) for k in ("rows.clip_replay",
                                             "rows.host_dp", "rows.clip_dp")) \
            == ln["gapped"]


def test_version_of_python_m_matches_urmap_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [subprocess.run([sys.executable, "-m", pkg, "-version"], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=120)
            for pkg in ("urmap_tpu", "urmap_tpu_torch")]
    assert outs[0].returncode == outs[1].returncode == 0, outs[1].stderr
    assert outs[1].stdout == outs[0].stdout and "urmap-tpu v" in outs[1].stdout


@pytest.mark.parametrize("extra,env,item", [
    (["-mesh", "2x1"], {}, "torchrun --nproc-per-node 2"),
    (["-mesh", "4"], {}, "torchrun --nproc-per-node 4"),
    (["-mesh", "1", "-route", "ring"], {}, "a2a or psum"),
    ([], {"JAX_COORDINATOR_ADDRESS": "localhost:1234"}, "JAX_NUM_PROCESSES"),
    ([], {"WORLD_SIZE": "2"}, "MASTER_PORT"),
])
def test_map_refuses_what_is_not_ported(corpus, monkeypatch, extra, env,
                                        item):
    """Multi-device mapping is ported: what -map still refuses is a mesh
    that does not span the world (here one process: a mesh of 2 or 4
    needs that many ranks), an unknown route and a multi-process
    environment without its rendezvous."""
    monkeypatch.delenv("MASTER_PORT", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=item):
        tcli.main(["-map", str(corpus / "se.fq"), "-ufi",
                   str(corpus / "t.ufi"), "-samout",
                   str(corpus / "no.sam"), "-quiet", *extra], device="cpu")


def test_device_build_and_cardless_map_refuse(corpus, monkeypatch):
    """-make_ufi -device_build on the CPU writes urmap_tpu's -device_build
    directory byte for byte, prepared tables included; without a card it
    and -map raise naming cuda, and -make_ufi writes nothing."""
    fa = str(corpus / "g.fa")
    monkeypatch.setattr(sys, "argv", ["urmap"])
    for name, mod, kw in (("jd", jcli, {}), ("td", tcli, {"device": "cpu"})):
        assert mod.main(["-make_ufi", fa, "-output", str(corpus / name),
                         "-slot_bits", "16", "-device_build"], **kw) == 0
    j, t = str(corpus / "jd"), str(corpus / "td")
    files = sorted(os.path.relpath(os.path.join(base, n), t)
                   for base, _dirs, names in os.walk(t) for n in names)
    assert files == sorted(
        os.path.relpath(os.path.join(base, n), j)
        for base, _dirs, names in os.walk(j) for n in names)
    assert any(f.startswith("prepared_") for f in files)
    match, mismatch, errors = filecmp.cmpfiles(j, t, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    # the same bytes as the host build's directory
    match, mismatch, errors = filecmp.cmpfiles(str(corpus / "t.ufi"), t,
                                               files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: -device_build and -map run "
                    "on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["-make_ufi", fa, "-output", str(corpus / "no.ufi"),
                   "-device_build"])
    assert not os.path.exists(corpus / "no.ufi")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["-map", str(corpus / "se.fq"), "-ufi",
                   str(corpus / "t.ufi"), "-samout",
                   str(corpus / "no.sam"), "-quiet"])


def test_auto_batch(corpus, monkeypatch):
    """On the CPU the port picks urmap_tpu's batch; against a card's
    budget it steps down in 8,192-multiples; -batch always wins."""
    from urmap_tpu.config import MapConfig as JCfg
    from urmap_tpu.index import UfiIndex as JIndex
    from urmap_tpu_torch.config import MapConfig
    from urmap_tpu_torch.index import UfiIndex

    tidx = UfiIndex.load(str(corpus / "t.ufi"))
    jidx = JIndex.load(str(corpus / "t.ufi"))
    cpu = torch.device("cpu")
    for gb in ("16", "1.6", "0.95"):
        monkeypatch.setenv("URMAP_DEVICE_MEM_GB", gb)
        want = jcli._auto_batch({}, jidx, JCfg(batch_size=65536), True)
        got = tcli._auto_batch({}, tidx, MapConfig(batch_size=65536), True,
                               cpu)
        assert got.batch_size == want.batch_size
    assert want.batch_size == 8192
    card = torch.device("cuda")
    per_read = tcli.cuda_read_bytes(160, False)
    assert tcli.cuda_read_bytes(704, True) > tcli.cuda_read_bytes(160, True) \
        > per_read
    room = tcli.CUDA_MARGIN_BYTES + tcli._table_bytes(tidx)
    for fit in (65536, 40960, 8192):
        gib = (room + fit * per_read + 1000) / 2**30
        monkeypatch.setenv("URMAP_DEVICE_MEM_GB", repr(gib))
        got = tcli._auto_batch({}, tidx, MapConfig(batch_size=65536), True,
                               card)
        assert got.batch_size == fit
        assert tcli._auto_batch({}, tidx, MapConfig(batch_size=65536), True,
                                card, paired=True).batch_size <= fit
    assert tcli._auto_batch({"batch": "300"}, tidx,
                            MapConfig(batch_size=300), True,
                            card).batch_size == 300
