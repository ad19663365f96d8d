"""Caps torch's intra-op threads in the port's test processes.

Every ``tests/test_torch_*.py`` file imports this module first.  Under
pytest-xdist every worker collects every file, so every worker imports
it: each then computes on ``THREADS`` threads instead of one a core, so
six workers no longer oversubscribe the cores (torch's pools and JAX's
in every worker did, and a test that runs in tens of seconds alone took
many times that).  Spawned ranks set their own count (1).
"""

import torch

#: intra-op threads a test process computes on
THREADS = 1

torch.set_num_threads(THREADS)
