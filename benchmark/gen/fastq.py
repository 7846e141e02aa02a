"""FASTQ files of a read pool, written in bulk.

Each record is ``@<prefix><index, 9 digits>``, the bases, ``+`` and a
quality string of ``I``; mate files of a pair carry the same names.
The fixed-width names make every record the same length, so a chunk of
records is one NumPy array.
"""

from __future__ import annotations

import numpy as np

from benchmark.gen.genome import CHARS

NAME_DIGITS = 9


def write_fastq(path: str, codes: np.ndarray, prefix: bytes) -> int:
    """Write ``codes`` (uint8[n, L], codes 0-3) → bytes written."""
    n, L = codes.shape
    head = 1 + len(prefix) + NAME_DIGITS + 1
    rec = head + L + 3 + L + 1
    digits = 10 ** np.arange(NAME_DIGITS - 1, -1, -1, dtype=np.int64)
    wrote = 0
    with open(path, "wb") as f:
        for s in range(0, n, 1 << 16):
            idx = np.arange(s, min(s + (1 << 16), n), dtype=np.int64)
            out = np.empty((idx.size, rec), np.uint8)
            out[:, 0] = ord("@")
            out[:, 1 : 1 + len(prefix)] = np.frombuffer(prefix, np.uint8)
            out[:, 1 + len(prefix) : head - 1] = \
                ord("0") + (idx[:, None] // digits) % 10
            out[:, head - 1] = ord("\n")
            out[:, head : head + L] = CHARS[codes[s : s + idx.size]]
            out[:, head + L : head + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
            out[:, head + L + 3 : rec - 1] = ord("I")
            out[:, rec - 1] = ord("\n")
            f.write(out.tobytes())
            wrote += out.size
    return wrote


def read_index(qname: bytes, prefix: bytes) -> int:
    """The pool index a record name carries."""
    if not qname.startswith(prefix):
        raise ValueError(f"record name {qname!r} lacks prefix {prefix!r}")
    return int(qname[len(prefix):])
