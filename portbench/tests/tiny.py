"""A copy of the benchmark's data files, shrunk so that a run takes seconds on
the CPU: coarser link caches, fewer configurations and points, short traced
windows.  Every key keeps its meaning; only sizes change."""

from __future__ import annotations

import json
import os
import shutil

from portbench import harness

SEED = 2 ** 31 + 12345  # a seed above 32 signed bits, as the driver's are


def _edit(path, fn):
    with open(path) as f:
        obj = json.load(f)
    fn(obj)
    with open(path, "w") as f:
        json.dump(obj, f)


def _config(c):
    c["links"]["resolution"] = 0.1 if c["name"] == "arm7" else 0.02
    c["links"]["padding"] = 0.2 if c["name"] == "arm7" else 0.05


def _mix(m):
    m["configs"], m["pool"] = 8, 2
    m["chunk"] = 8 if m["chunk"] == 200 else 4
    m["sample"]["per_chunk"] = 64
    m["trace_steps"] = 2
    if "grid" in m:
        if m["grid"]["range"][1][0] == m["grid"]["range"][1][1]:
            m["grid"]["resolution"] = 0.04
        elif m["grid"]["range"] == [[-0.5, 0.49]] * 3:
            m["grid"].update(resolution=0.05, range=[[-0.5, 0.45]] * 3)
        else:
            m["grid"]["resolution"] = 0.02
    else:
        m["points"]["count"] = 300


def tiny_base(directory: str) -> str:
    """The benchmark's files under ``directory/portbench``, shrunk."""
    base = os.path.join(directory, "portbench")
    shutil.copytree(harness.BENCH_DIR, base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name in os.listdir(os.path.join(base, "configs")):
        _edit(os.path.join(base, "configs", name), _config)
    for name in os.listdir(os.path.join(base, "mixes")):
        _edit(os.path.join(base, "mixes", name), _mix)
    return base
