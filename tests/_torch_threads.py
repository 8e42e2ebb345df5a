"""Caps torch's intra-op threads in a test process at its share of the
machine's cores: the cores over the number of pytest-xdist workers
(PYTEST_XDIST_WORKER_COUNT; 1 without xdist). Each worker otherwise starts
as many threads as there are cores, and six workers on eight cores then
make a 0.07 s CPU training step take 20 s. Every tests/test_torch_*.py
imports this module before its first torch computation.

It then makes the first call of torch's vectorised float functions on one
element, which runs on this thread alone. On a CPU build of torch with
MKL, the first torch.exp of a process made by two threads at once can
leave one thread's half of the output up to 1e-4 off (seen under four
xdist workers of two threads each, one run in three): the kernel's first
call sets itself up, and two threads doing that at once race."""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))

_one = torch.full((1,), 0.5)
for _fn in (torch.exp, torch.expm1, torch.log, torch.log1p, torch.tanh,
            torch.erf, torch.erfinv, torch.sqrt, torch.rsqrt, torch.sin,
            torch.cos):
    _fn(_one)
del _one, _fn
