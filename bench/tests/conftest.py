"""The benchmark's CPU tests: its harness and reference at tiny sizes.

    PYTHONPATH=src python -m pytest bench/tests

Tests marked ``cuda`` run a cell on the card and skip without one.
"""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(ROOT, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# one thread a test process: the tiny models gain nothing from more, and
# several test processes share the machine's cores
torch.set_num_threads(1)
