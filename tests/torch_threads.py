"""torch's intra-op threads for the port's tests, from what the process can
see: the cores it may run on, shared among pytest-xdist's workers.

Every ``tests/test_torch_*.py`` imports this module, so the rule holds in
every worker (each collects the modules it runs, or all of them) and in a
file run alone. Under ``-n 6`` on 8 cores each worker takes one thread;
without xdist the process keeps every core. ``OMP_NUM_THREADS`` carries the
same number to the subprocesses and spawned ranks that tests start.
"""

import os

import torch

THREADS = max(1, len(os.sched_getaffinity(0))
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1)))
torch.set_num_threads(THREADS)
os.environ["OMP_NUM_THREADS"] = str(THREADS)
