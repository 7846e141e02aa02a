"""urmap_tpu_torch — the PyTorch + CUDA port of urmap_tpu.

Single-end and paired-end mapping on one device: the packed read
upload, seed slots, CSR gather (classic, aligned and dense-row row128
tables, the last with packed offsets), diagonal vote, ungapped verify,
bucketed banded DP with the clip-rescue lane, hit selection, pairing and
mate rescue, the MAPQ gates and the device traceback of the gapped
winners, driven by a ``Mapper`` and a ``PairedMapper`` with urmap_tpu's
``start_batch`` / ``finish_batch`` surface. The seed, table-fetch, vote,
banded-DP and traceback stages run hand-written CUDA kernels (``csrc/``)
on a CUDA device and their plain PyTorch versions on the CPU. The JAX package
``urmap_tpu`` is the reference every function here is held against; this
package imports nothing of it and keeps its own copies of the host layer
(config, alphabet, io, utils), held to the originals by text
(tests/unit/test_torch_copies.py).
"""

__version__ = "0.1.0"

from urmap_tpu_torch.config import IndexConfig, MapConfig, ScoreConfig  # noqa: F401
from urmap_tpu_torch.device import require_device  # noqa: F401
