"""Put the repository's root on the path, so that `benchmark` and the
program import as they do under `python3 -m benchmark.run`; and keep each
test process to two threads, so that parallel workers do not contend."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(2)
