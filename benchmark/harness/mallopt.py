"""glibc's malloc settings that a configuration states (``mallopt``),
applied at the start of the process, before the program allocates. With
glibc's defaults every large block the host stages free goes back to the
kernel and comes back as fresh pages on the next batch; in a sandboxed
host that system time is dear and varies from run to run. The values
are those an operator sets with GLIBC_TUNABLES (glibc.malloc.*)."""

from __future__ import annotations

import ctypes

PARAMS = {"M_TRIM_THRESHOLD": -1, "M_TOP_PAD": -2, "M_MMAP_THRESHOLD": -3}


def apply(settings: dict) -> None:
    """mallopt(name, value) for each entry; raises where glibc refuses."""
    if not settings:
        return
    libc = ctypes.CDLL(None)
    for name, value in settings.items():
        if not 0 <= value < 2**31:
            raise ValueError(f"mallopt {name}: {value} does not fit an int")
        if libc.mallopt(PARAMS[name], ctypes.c_int(value)) != 1:
            raise RuntimeError(f"mallopt {name} {value} refused")
