"""The lookup layer's least time, counted from the workload.

What a cached-link robot query must at least move and compute, whatever
implements it: the world points once (12 B each), every link's pose for
every configuration (48 B: a 3x4 float32 transform), each distinct (link,
cache cell) that an in-bounds nearest lookup reads (a 4 B value, and a
12 B gradient where gradients are returned), and the outputs (4 B a value,
12 B a gradient).  Operations: a rigid transform (9 multiplies, 9 adds) and
the nearest key (3 subtractions, 3 multiplies) for every (configuration,
link, point), one comparison of the min-union, and the winner's gradient
rotated back (9 multiplies, 6 adds).  The cells are counted with the
reference's own FK and the cache grids' geometry (the link kind's
``Table.cells_read``), never from the program's tables.

The least time is the larger of bytes over the peak bandwidth and
operations over the peak float32 rate (NVIDIA's data sheet, H100 SXM).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# the published peaks of each card the benchmark knows: HBM bytes/s, float32 (no tensor core) FLOP/s
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12}}

TRANSFORM_FLOPS, KEY_FLOPS, UNION_FLOPS, ROTATE_FLOPS = 18, 6, 1, 15


def lookup_work(ref, q: torch.Tensor, world: torch.Tensor, gradients: bool,
                block: int = 1 << 20) -> Dict[str, float]:
    """Bytes, operations and distinct cells of one call: configurations
    ``q [C, dof]`` over the real world points ``world [M, 3]``."""
    C, M, L = q.shape[0], world.shape[0], len(ref.tables)
    o2l, _ = ref.link_poses(q)
    cells = 0
    for l, t in enumerate(ref.tables):
        seen = torch.zeros(t.size, dtype=torch.bool, device=world.device)
        for c in range(C):
            for s in range(0, M, block):
                seen[t.cells_read(ref.apply(o2l[l, c], world[s:s + block]))] = True
        cells += int(seen.sum())
    g = 1 if gradients else 0
    nbytes = 12 * M + 48 * L * C + cells * (4 + 12 * g) + C * M * (4 + 12 * g)
    flops = (C * M * L * (TRANSFORM_FLOPS + KEY_FLOPS + UNION_FLOPS)
             + C * M * ROTATE_FLOPS * g)
    return {"bytes": float(nbytes), "flops": float(flops), "cells": float(cells)}


def least_seconds(work: Dict[str, float], kind: str) -> Optional[Dict[str, float]]:
    """``{"seconds", "bytes_s", "flops_s", "bound"}`` on card ``kind``, or
    None for a card whose peaks the table does not hold."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    b = work["bytes"] / peak["bytes_per_s"]
    f = work["flops"] / peak["flops_per_s"]
    return {"seconds": max(b, f), "bytes_s": b, "flops_s": f,
            "bound": "bytes" if b >= f else "operations"}
