"""The exact links' least work a call, and K1's device time a call: what the
metrics ``exact_roofline`` and ``exact.device_ms_per_call`` read.

What a robot query over exact mesh links must at least move and compute,
whatever implements it, for ``C`` configurations × ``M`` points over ``L``
links (the count of ``exact_roofline``):

- bytes: the points once (12 B each), every answer out (16 B: the value and
  the gradient), each triangle of every distinct link mesh (36 B: three
  float32 corners), and every link's pose for every configuration (48 B: a
  3x4 float32 transform);
- operations: for every (configuration, link, point) the rigid transform
  (18), one point-triangle closest-point evaluation (:data:`CLOSEST_FLOPS`)
  and one comparison of the min-union; for every (configuration, point) the
  winner's gradient rotated back (15).

A sweep that culls pairs evaluates more than one triangle a (configuration,
link, point) but fewer than all, so the brute-force count of pairs (every
triangle) would put the floor above a culling kernel's own work; it is only
logged, for information.

The geometry is the reference's (``links/mesh.exact.py``), never the
program's.  While ``harness.traced_roofline`` counts the lookup layer's
least time, ``roofline.lookup_work`` asks every link's ``Table``, in link
order, for the cells that each configuration's link-frame points read; an
exact link reads none and notes here its mesh, its triangles and the points
it was asked about (:data:`ASKS`).  Over the ``n`` calls counted, a mesh that
serves ``u`` links is asked about ``n * u * C * M`` points, and the run gives
``C * M`` (its queries over its calls).  So each mesh's (counted call, link)
pairs are ``n * u``; their greatest common divisor is ``n`` wherever the
counts of links per mesh share no factor (as where one mesh serves one link,
the arm's base), and the links a call are the sum of the ``u``.  Where they
share one, the count of links comes out short and the floor low, never high.
"""

from __future__ import annotations

import math
import sys
from collections import Counter
from typing import Dict, List, Optional, Tuple

from portbench import roofline

# the sweep kernels of ``csrc/closest_point.cu`` (both instantiations of the
# template), by the name the device trace gives them
K1_KERNEL = "closest_point_sweep_kernel"

POINT_BYTES, ANSWER_BYTES, TRIANGLE_BYTES, POSE_BYTES = 12, 16, 36, 48
# Ericson's face-region path, the longest exit of the closest-point cascade:
# three point-to-corner differences (9), six dot products (30), the three
# barycentric determinants (9), their sum and two divisions (4), the
# closest point (12), its squared distance (8) and the square root (1)
CLOSEST_FLOPS = 73

# (mesh, its triangles, link-frame points) of every ``Table.cells_read`` call
# since the last exact ``Table`` was built
ASKS: List[Tuple[int, int, int]] = []


def k1_seconds_per_call(run: dict) -> Optional[float]:
    """Device seconds a call of K1's sweep kernels in the plain traced
    window (None where the window ran none)."""
    t = run["plain"]
    if not t or not t["calls"]:
        return None
    s = sum(sec for name, sec in t["device_ops"] if K1_KERNEL in name)
    return s / t["calls"] if s else None


def call_work(asks: List[Tuple[int, int, int]], answers: int) -> Optional[Dict[str, float]]:
    """The least bytes and operations of one call of ``answers`` (``C * M``)
    configuration-point queries, from the reference's ``asks`` (see the
    module's docstring); None where they do not hold whole calls of one
    block of points a configuration."""
    points, triangles = Counter(), {}
    sizes = set()
    for mesh, f, n in asks:
        points[mesh] += n
        triangles[mesh] = f
        sizes.add(n)
    if not points or len(sizes) != 1 or answers % next(iter(sizes)):
        return None
    M = sizes.pop()
    C = answers // M
    if any(p % answers for p in points.values()):
        return None
    pairs = {mesh: p // answers for mesh, p in points.items()}
    n = math.gcd(*pairs.values())
    links = {mesh: k // n for mesh, k in pairs.items()}
    L = sum(links.values())
    nbytes = (POINT_BYTES * M + ANSWER_BYTES * answers + TRIANGLE_BYTES * sum(triangles.values())
              + POSE_BYTES * L * C)
    flops = (answers * L * (roofline.TRANSFORM_FLOPS + CLOSEST_FLOPS + roofline.UNION_FLOPS)
             + answers * roofline.ROTATE_FLOPS)
    return {"bytes": float(nbytes), "flops": float(flops), "configurations": C, "points": M,
            "links": L, "brute_force_pairs": answers * sum(links[m] * triangles[m] for m in links)}


def roofline_share(run: dict) -> Optional[float]:
    """The least time a call (:func:`call_work`) over K1's device time a
    call, in %; None where the run traced no K1 or counted no roofline."""
    k1 = k1_seconds_per_call(run)
    if k1 is None or run["roofline"] is None:
        return None
    work = call_work(ASKS, round(run["queries"] / run["calls"]))
    if work is None:
        return None
    import torch
    least = roofline.least_seconds(work, torch.cuda.get_device_name())
    if least is None:
        return None
    print(f"[portbench] exact floor a call: {work['configurations']} configurations x "
          f"{work['points']} points x {work['links']} links, {work['bytes']:.0f} B, "
          f"{work['flops']:.0f} operations, {least['seconds'] * 1e3:.4f} ms ({least['bound']}); "
          f"brute-force pairs {work['brute_force_pairs']}, for information",
          file=sys.stderr, flush=True)
    return 100.0 * least["seconds"] / k1
