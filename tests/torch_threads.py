"""Share the CPU's cores among pytest-xdist's workers in the port's
tests. torch's intra-op threads (one a core by default) spin while they
wait, so six workers of eight threads each on an eight-core machine run
a test many times slower than it runs alone (a phase-2 rehearsal of
chip_smoke.py: 35 s alone, 552 s so); one thread a worker there costs it
79 s. Under xdist (PYTEST_XDIST_WORKER_COUNT) each worker takes its share
of the cores, and so do the processes it starts (OMP_NUM_THREADS, which
they inherit); a run without xdist keeps torch's default. Every
tests/test_torch_*.py imports this module for that effect."""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    SHARE = max(1, len(os.sched_getaffinity(0)) // WORKERS)
    torch.set_num_threads(SHARE)
    os.environ["OMP_NUM_THREADS"] = str(SHARE)
