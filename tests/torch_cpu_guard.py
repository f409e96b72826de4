"""A guard for the port's CPU tests against a fault of some CPU builds of
torch: the first large parallel ``torch.sqrt`` of a process now and then
returns ~12-bit results on one thread's share of the elements, which moves
the plain sweep's winding number by up to ~1e-3 (reproduced by
``scripts/cpu_sqrt_first_call_torch.py``).  Later calls are exact.

Each test module of the port that runs the plain sweep on the CPU calls
:func:`warm_sqrt` at import, so the guard holds whether the module runs
alone or with others."""

import torch


def warm_sqrt() -> None:
    """Take the process's first large parallel square roots here, where
    their results are thrown away."""
    for _ in range(2):
        torch.sqrt(torch.rand(1 << 20))
