#!/usr/bin/env python3
"""CPU emulation of the tensor-core sweep's arithmetic: how far its
split-TF32 products move the distances and the winding number, and how near
a group's box the direct solid angle must take over.

    python3 scripts/tf32_split_emulation_torch.py [--points 2048] [--near 0 0.5 1 2]

The expanded sweep (``ops.point_triangle._pairs_expanded``, the plain
version of ``csrc/closest_point_mma.cu``) runs with its products taken two
ways: plain float32, and 3xTF32 as the kernel packs them into K = 16
(``hi.hi`` for x, y, z, the constant and ``|q|^2``, then ``lo.hi`` for x,
y, z, then ``hi.lo`` for x, y, z, the constant and ``|q|^2``; the ``lo.lo``
term is dropped), each with the direct solid angle within ``near`` group-box
diagonals (0: never).  TF32 rounding is emulated bit for bit (round to
nearest, ties away, 10 mantissa bits); the products are summed in float32
in that order, which the tensor cores need not follow.

Three inputs: the roofline probe's torus (16,384 faces; an evenly strided
subset of its 2^17 points), the arm's capsule with points in a band of 1 cm
around its box (``chip_smoke.py``'s straddling case), and the capsule with
points 0.8-1.2 m away.  Prints one JSON line: for each input and variant,
the max |winding| difference from the direct sweep (``mesh_closest_query``)
at points farther than ``sweep_roofline.WIND_MIN_DIST`` from the surface,
the max distance difference, the max difference from the float32 variant
with the same ``near``, and the share of pairs whose solid angle is taken
directly.  About a minute on the CPU.
"""

import argparse
import json
import os
import sys
from functools import partial

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytorch_volumetric_tpu_torch import mesh as tm  # noqa: E402
from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr  # noqa: E402
from pytorch_volumetric_tpu_torch.ops import point_triangle as tpt  # noqa: E402


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round the magnitude to 10 mantissa bits, ties
    away from zero."""
    b = x.view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return ((b & -2 ** 31) | mag).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def tf32x3_products(q: torch.Tensor, pp: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """:func:`point_triangle._products` as the kernel issues them: 3xTF32,
    summed in the kernel's K order."""
    qh, ql = split(q)
    ph, pl = split(pp)
    vh, vl = split(cols[..., :3])
    ch, cl = split(cols[..., 3])
    e = cols[..., 4]  # 0 or 1: exact in TF32
    terms = [qh[..., k, None] * vh[..., k] for k in range(3)] + [ch, ph[..., None] * e]
    terms += [ql[..., k, None] * vh[..., k] for k in range(3)]
    terms += [qh[..., k, None] * vl[..., k] for k in range(3)] + [cl, pl[..., None] * e]
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def inputs(points: int):
    """name -> (points, triangles) of the three inputs (seed 0)."""
    cpu = torch.device("cpu")
    pts, scene = sr.torus_inputs(cpu, 1 << 17)
    torus = (pts[::max(1, pts.shape[0] // points)].contiguous(), scene.tri)
    cap_mesh = tm.capsule_mesh(radius=0.045, height=0.18, segments=14, rings=5)
    cap = tm.MeshScene.from_mesh(cap_mesh, device=cpu).tri
    bb = cap_mesh.aabb()
    rng = np.random.default_rng(0)
    band = torch.as_tensor(rng.uniform(bb[:, 0] - 0.01, bb[:, 1] + 0.01, (points, 3))
                           .astype(np.float32))
    far = rng.normal(size=(points, 3))
    far *= rng.uniform(0.8, 1.2, (points, 1)) / np.linalg.norm(far, axis=1, keepdims=True)
    return {"torus": torus, "capsule, 1 cm band around its box": (band, cap),
            "capsule, points 0.8-1.2 m away": (torch.as_tensor(far.astype(np.float32)), cap)}


def near_share(pts: torch.Tensor, tri: torch.Tensor, near: float) -> float:
    """The share of (point, real face) pairs within ``near`` diagonals of
    their group's box."""
    fr = tpt.expanded_frames(tri)
    real = ~(tri == tm.PAD_COORD).flatten(1).all(dim=1)
    lo, hi = fr[real, 1][None], fr[real, 2][None]
    gap = torch.clamp(torch.maximum(lo - pts[:, None], pts[:, None] - hi), min=0.0)
    span = hi - lo
    return (tpt._dot(gap, gap) <= near * near * tpt._dot(span, span)).float().mean().item()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--near", type=float, nargs="*", default=[0.0, 0.5, 1.0, 2.0])
    args = ap.parse_args()
    out = {}
    for name, (pts, tri) in inputs(args.points).items():
        direct = tpt.mesh_closest_query(pts, tri, tri_chunk=128)
        off = direct[0] > sr.WIND_MIN_DIST
        rows = torch.cat([tri, tpt.expanded_frames(tri)], dim=1)
        res = {}
        for near in args.near:
            f32 = None
            for label, products in (("f32", tpt._products), ("3xTF32", tf32x3_products)):
                pairs = partial(tpt._pairs_expanded, products=products, near=near)
                r = tpt._sweep(pts, rows, 2048, 128, pairs)
                row = {"wind_vs_direct": (r[3] - direct[3])[off].abs().max().item(),
                       "dist_vs_direct": (r[0] - direct[0]).abs().max().item()}
                if f32 is None:
                    f32 = r
                else:
                    row["wind_vs_f32"] = (r[3] - f32[3])[off].abs().max().item()
                    row["dist_vs_f32"] = (r[0] - f32[0]).abs().max().item()
                res[f"near{near:g}_{label}"] = row
            res[f"near{near:g}_direct_share"] = near_share(pts, tri, near)
        out[name] = res
    print(json.dumps({"metric": "tf32_split_emulation", "points": args.points,
                      "variants": out}))


if __name__ == "__main__":
    main()
