#!/usr/bin/env python3
"""CPU emulation of the tensor-core sweep's arithmetic: how far split-TF32
dot products move the expanded winding number, with and without a frame
per triangle group.

    python3 scripts/tf32_split_emulation_torch.py [--points 4096] [--groups 0 8 32 128]

On the roofline probe's torus (16,384 faces) and an evenly strided subset of
its 2^17 points, the expanded sweep (``ops.point_triangle._pairs_expanded``,
the plain version of ``csrc/closest_point_mma.cu``) runs with its six dot products taken three
ways: plain float32, 3xTF32 (hi/lo split, three products, as the kernel
issues them) and 6xTF32 (hi/mid/lo, six products), each in the mesh's own
frame or in one frame per group of G triangles (the first corner of the
group's first triangle).  TF32 rounding is emulated bit for bit
(round to nearest, ties away, 10 mantissa bits); the products are summed in
float32 in a fixed order, which the tensor cores need not follow.  Prints
one JSON line: each variant's max |winding| difference from the float32
expanded sweep in the same frame and from the direct sweep, and its max
distance difference.  Runs on the CPU in about a minute per 4096 points.
"""

import argparse
import json
import os
import sys
from functools import partial

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr  # noqa: E402
from pytorch_volumetric_tpu_torch.ops import point_triangle as tpt  # noqa: E402


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round the magnitude to 10 mantissa bits, ties
    away from zero."""
    b = x.view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return ((b & -2 ** 31) | mag).view(torch.float32)


def split_dot(p: torch.Tensor, v: torch.Tensor, parts: int) -> torch.Tensor:
    """``p . v`` from TF32 pieces: 2 pieces and 3 products, or 3 pieces and
    6 products; each product exact in float32, summed in float32."""
    def pieces(x):
        hi = tf32(x)
        mid = tf32(x - hi)
        return [hi, mid] if parts == 2 else [hi, mid, tf32(x - hi - mid)]

    P, V = pieces(p), pieces(v)
    terms = ([(1, 0), (0, 1), (0, 0)] if parts == 2
             else [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)])
    acc = torch.zeros(torch.broadcast_shapes(p.shape, v.shape)[:-1])
    for i, j in terms:
        prod = P[i] * V[j]
        acc = acc + prod[..., 0] + prod[..., 1] + prod[..., 2]
    return acc


def expanded_pairs(parts: int, group: int):
    """The plain version's expanded per-pair arithmetic with split dot
    products (``parts`` 0 = plain float32) in frames of ``group`` triangles
    (0 = none)."""
    dot = tpt._dot if parts == 0 else partial(split_dot, parts=parts)
    return partial(tpt._pairs_expanded, dot=dot, group=group)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--groups", type=int, nargs="*", default=[0, 8, 32, 128])
    args = ap.parse_args()
    cpu = torch.device("cpu")
    pts, scene = sr.torus_inputs(cpu, 1 << 17)
    sub = pts[::max(1, pts.shape[0] // args.points)].contiguous()
    tri = scene.tri
    direct = tpt.mesh_closest_query(sub, tri, tri_chunk=128)
    out = {}
    for group in args.groups:
        f32 = tpt._sweep(sub, tri, 2048, 128, expanded_pairs(0, group))
        for parts in (0, 2, 3):
            res = f32 if parts == 0 else tpt._sweep(sub, tri, 2048, 128,
                                                    expanded_pairs(parts, group))
            out[f"group{group}_{['f32', '', '3xTF32', '6xTF32'][parts]}"] = {
                "wind_vs_f32_same_frame": (res[3] - f32[3]).abs().max().item(),
                "wind_vs_direct": (res[3] - direct[3]).abs().max().item(),
                "dist_vs_direct": (res[0] - direct[0]).abs().max().item()}
    print(json.dumps({"metric": "tf32_split_emulation", "points": sub.shape[0],
                      "faces": scene.num_faces, "variants": out}))


if __name__ == "__main__":
    main()
