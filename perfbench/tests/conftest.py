"""The benchmark's tests put its own directory and the program's
``src/`` on the path, as ``run.py`` does.  Under pytest-xdist each
worker takes its share of the cores: PyTorch's CPU threads slow down by
orders of magnitude when the workers together run more threads than
there are cores, and the serving tests' windows are measured on the
clock."""
import os
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
