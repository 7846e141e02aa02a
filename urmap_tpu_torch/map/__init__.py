"""The mapping pipeline: seed → vote → align → select → MAPQ, single-end
(``Mapper``) and paired-end (``PairedMapper``)."""

from urmap_tpu_torch.map.pipeline import Mapper, MapResult  # noqa: F401
from urmap_tpu_torch.map.pair import PairedMapper, PairResult  # noqa: F401
