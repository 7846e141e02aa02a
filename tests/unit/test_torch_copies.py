"""The port's host-layer copies are held to their sources by text.

urmap_tpu_torch imports nothing of urmap_tpu and keeps its own copy of
every host module it needs. Each copy is its source with one leading
comment line naming the source and the package name replaced;
codecs.cpp is byte-equal. A copy that must differ names the lines that
may (``ALLOWED``); everything else is compared, so drift shows here.
"""

import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

COPIES = ["config.py", "alphabet.py", "io/__init__.py", "io/fasta.py",
          "io/fastq.py", "io/sam.py", "io/sam_native.py",
          "io/native/__init__.py", "io/native/codecs.cpp",
          "utils/__init__.py", "utils/bigmem.py", "utils/progress.py",
          "utils/stream.py"]

# copy text → source text, for the lines that may differ: the port
# builds codecs.cpp into build/urmap_tpu_torch/ at the repository root,
# the reference beside its source; the port's SAM formatters are spans
# of their batch (a block appended to the copy, the bodies untouched)
ALLOWED = {
    "io/sam_native.py": [
        ("\n\n# the port's spans (urmap_tpu/utils/trace.py): each formatter"
         " call\n# is the span urmap.sam of its result's batch\n"
         "from urmap_tpu.utils import trace as _trace  # noqa: E402\n\n"
         'format_single_end = _trace.spanned("urmap.sam", 1)'
         "(format_single_end)\n"
         'format_paired = _trace.spanned("urmap.sam", 2)(format_paired)\n',
         ""),
    ],
    "io/native/__init__.py": [
        ("and cached in\nbuild/urmap_tpu/ at the repository root,\n",
         "and cached next to the source,\n"),
        ('_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname('
         'os.path.dirname(\n    _DIR))), "build", "urmap_tpu")\n', ""),
        ("    os.makedirs(_BUILD_DIR, exist_ok=True)\n", ""),
        ('os.path.join(_BUILD_DIR, f"_codecs_{h}.so")',
         'os.path.join(_DIR, f"_codecs_{h}.so")'),
    ],
}


def _read(*parts):
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_source(rel):
    src = _read("urmap_tpu", rel)
    copy = _read("urmap_tpu_torch", rel)
    if rel.endswith(".cpp"):
        assert copy == src
        return
    head, _, body = copy.decode().partition("\n")
    assert head == f"# Copy of urmap_tpu/{rel} with the package name replaced."
    body = body.replace("urmap_tpu_torch", "urmap_tpu")
    for theirs, ours in ALLOWED.get(rel, []):
        assert body.count(theirs) == 1, theirs
        body = body.replace(theirs, ours)
    assert body == src.decode()


# functions the port's modules copy verbatim from the module of the same
# name in urmap_tpu (modules that also hold ported torch code)
FUNCTION_COPIES = [
    ("map.cigar", "_finish_ops"), ("map.cigar", "decode_tb_row"),
    ("map.cigar", "_tb_select"), ("map.cigar", "_tb_decode_rows"),
    ("map.cigar", "decode_dops_row"), ("map.cigar", "dops_decode_batch"),
    ("map.cigar", "strand_codes_subset"), ("map.pipeline", "tb_cols"),
    ("map.pipeline", "merge_tb_batches"), ("map.pipeline", "unpack_tb"),
    ("map.pipeline", "_unsat16"), ("hashing", "words_to_slots_np"),
    ("map.cigar", "traceback"), ("map.cigar", "cigars_nm_fast"),
    ("map.cigar", "add_truncation_clips"), ("map.cigar", "cigars_for_result"),
    ("map.pair", "PairResult"), ("map.pair", "_ref_spans"),
    ("index.store", "ginter_rows"),
    ("dist.multihost", "_align_to_record"),
    ("dist.multihost", "fastq_byte_ranges"),
    ("dist.multihost", "_norm_name"),
    ("dist.multihost", "_find_record_by_name"),
    ("dist.multihost", "paired_fastq_byte_ranges"),
    ("dist.multihost", "Watermark"), ("dist.multihost", "ShardWriter"),
    ("dist.multihost", "merge_shards"),
    ("index.build", "_RadixSpill"), ("index.build", "_host_chunk_slots"),
    ("index.build", "_merge_sorted_runs"),
    ("dist.sharded", "_largest_pow2_divisor"),
    ("dist.sharded", "ShardedTables"),
    ("dist.sharded", "shard_index_tables"),
    ("dist.sharded", "shard_prepared_tables"),
    ("dist.sharded", "save_sharded_tables"),
    ("dist.sharded", "load_sharded_tables"),
    ("dist.sharded", "a2a_slack_from_index"),
]


@pytest.mark.parametrize("module,name", FUNCTION_COPIES)
def test_function_copy_equals_source(module, name):
    """Each copy equals its source and (for dist.sharded, a module of
    ported code beside the copies) stands under a comment line naming
    it."""
    import importlib
    import inspect

    ours = getattr(importlib.import_module(f"urmap_tpu_torch.{module}"), name)
    theirs = getattr(importlib.import_module(f"urmap_tpu.{module}"), name)
    assert inspect.getsource(ours).replace("urmap_tpu_torch", "urmap_tpu") \
        == inspect.getsource(theirs)
    if module == "dist.sharded":
        lines, first = inspect.getsourcelines(ours)
        text = _read("urmap_tpu_torch", "dist", "sharded.py").decode()
        assert text.splitlines()[first - 2] == \
            f"# urmap_tpu/dist/sharded.py:{name}"


# module constants copied with the comment lines above them
CONSTANT_COPIES = [("index/build.py", "SPILL_THRESHOLD"),
                   ("index/build.py", "DEFAULT_CHUNK")]


@pytest.mark.parametrize("rel,name", CONSTANT_COPIES)
def test_constant_copy_equals_source(rel, name):
    def block(pkg):
        lines = _read(pkg, rel).decode().splitlines()
        i = next(i for i, ln in enumerate(lines)
                 if ln.startswith(f"{name} = "))
        j = i
        while j > 0 and lines[j - 1].startswith("# ") \
                and not lines[j - 1].startswith("# urmap_tpu/"):
            j -= 1
        return lines[j : i + 1]

    theirs = block("urmap_tpu")
    assert len(theirs) >= 2
    assert block("urmap_tpu_torch") == theirs


# functions and classes the port's tools (urmap_tpu_torch/tools/) copy,
# each under a comment line naming its source: name → (source file,
# the port's file); each copy is its source with the package name
# replaced (simulate's and synth_reads' and synth_pairs' alphabet
# imports)
TOOL_COPIES = {
    "simulate": ("tools/accuracy.py", "accuracy.py"),
    "plant_repeat_families": ("tools/accuracy.py", "accuracy.py"),
    "rounds_for_batch": ("tools/a2a_rounds.py", "a2a_rounds.py"),
    "plant_indels": ("bench.py", "synth.py"),
    "synth_reads": ("bench.py", "synth.py"),
    "synth_pairs": ("bench.py", "synth.py"),
    "write_fastq": ("bench.py", "synth.py"),
    "random_seq": ("tests/utils.py", "synth.py"),
    "make_seqdb": ("tests/utils.py", "synth.py"),
    "PlantedRead": ("tests/utils.py", "synth.py"),
    "plant_read": ("tests/utils.py", "synth.py"),
    "plant_pair": ("tests/utils.py", "synth.py"),
}


@pytest.mark.parametrize("name", list(TOOL_COPIES))
def test_tool_copy_equals_source(name):
    import ast

    def definition(*parts):
        text = _read(*parts).decode()
        node = next(n for n in ast.parse(text).body
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                    and n.name == name)
        first = min([node.lineno] + [d.lineno for d in node.decorator_list])
        lines = text.splitlines(keepends=True)
        return "".join(lines[first - 1 : node.end_lineno]), lines[first - 2]

    source, ported = TOOL_COPIES[name]
    theirs, _ = definition(*source.split("/"))
    ours, above = definition("urmap_tpu_torch", "tools", ported)
    assert above.startswith(f"# {source}:{name}")
    assert ours.replace("urmap_tpu_torch", "urmap_tpu") == theirs
    if "import alphabet" in theirs:
        assert "from urmap_tpu_torch import alphabet" in ours


def test_microvpu_passes_equals_source():
    """B8's round count is tools/bench_microvpu.py's ``PASSES`` (line
    31), copied under a comment line naming it."""
    src = _read("tools", "bench_microvpu.py").decode().splitlines()
    assert src[30] == "PASSES = 24"
    ours = _read("urmap_tpu_torch", "kernels", "micro.py").decode() \
        .splitlines()
    i = ours.index(src[30])
    assert ours[i - 1] == "# tools/bench_microvpu.py:PASSES"
    assert sum(ln.startswith("PASSES = ") for ln in ours) == 1


def test_port_source_never_imports_the_reference_or_jax():
    """No ``import``/``from`` of urmap_tpu or jax in the port's Python
    sources or in chip_smoke.py (docstrings and comments included: a
    plain text search, as a reader would run it)."""
    import re

    pat = re.compile(r"(from|import) (urmap_tpu(\.| |$)|jax)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(os.path.join(ROOT, "urmap_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 25
    hits = [(os.path.relpath(f, ROOT), m.group(0)) for f in files
            for m in pat.finditer(open(f).read())]
    assert not hits, hits
