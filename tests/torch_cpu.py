"""One intra-op thread for torch in every process that runs a port test.

Every ``test_torch_*.py`` module imports this, so a test worker is
pinned once it has collected one of them, before its first test. The
port's CPU path is many small ops; when parallel test workers run them
with torch's default threads, the workers' threads outnumber the cores
and each op waits at OpenMP barriers, so a test can take tens of times
as long as alone. With one thread it maps as fast as alone. A process a
test starts is not reached by this pin: give it ``OMP_NUM_THREADS=1``.
"""

import torch

torch.set_num_threads(1)
