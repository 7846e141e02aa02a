"""What a run may not load: JAX and the JAX package the port came from.

Module names are compared by their top-level part (before the first
dot) whole, since the port's own name, ``urmap_tpu_torch``, begins with
the JAX package's.
"""

from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "urmap_tpu")


def forbidden_loaded(modules) -> list[str]:
    """The top-level names among ``modules`` (names of sys.modules) that
    are forbidden, sorted."""
    return sorted({m.split(".", 1)[0] for m in modules}
                  & set(FORBIDDEN))
