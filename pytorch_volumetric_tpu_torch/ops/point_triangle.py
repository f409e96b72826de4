"""Batched point -> triangle-mesh closest-point and winding-number queries.

This module holds the plain PyTorch version of the sweep: a chunked
brute-force pass over triangle tiles that carries a running (min squared
distance, closest point, face id) and a running winding-number sum.  On a
CUDA tensor :func:`signed_closest_query` runs the hand-written kernel
(``ops.closest_point``); on a CPU tensor it runs the plain version below.

Every dot product and sum is written out component by component in a fixed
order, the same order the CUDA kernel uses, so the kernel (built without
FMA contraction) and this version give the same distances and face ids on
the card.

Triangle arrays are padded with degenerate far-away triangles
(``mesh.PAD_COORD``) that never win the min and contribute exactly zero
solid angle.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pytorch_volumetric_tpu_torch.mesh import PAD_COORD
from pytorch_volumetric_tpu_torch.utils.batching import cdiv, pad_to

DEFAULT_POINT_CHUNK = 2048
DEFAULT_TRI_CHUNK = 512

_FOUR_PI = 12.566370614359172


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.where(den.abs() < 1e-30, 1e-30, den)


def _closest_point_bary(p: torch.Tensor, a: torch.Tensor, ab: torch.Tensor,
                        ac: torch.Tensor, with_features: bool = False):
    """Closest point on each triangle for each point (Ericson RTCD 5.1.5,
    branch-free).  ``p``: [P, 1, 3]; ``a, ab, ac``: [1-or-P, T, 3].
    Returns (dist2 [P, T], closest [P, T, 3]); with ``with_features`` also
    the closest-feature code [P, T] int32 (0 face, 1..3 vertex A/B/C, 4..6
    edge AB/BC/CA)."""
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = ap - ab
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = ap - ac
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    # interior barycentric
    denom = va + vb + vc
    v_in = _safe_div(vb, denom)
    w_in = _safe_div(vc, denom)

    # edge candidates
    v_ab = _safe_div(d1, d1 - d3)                       # on AB
    w_ac = _safe_div(d2, d2 - d6)                       # on AC
    w_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))    # on BC

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    # priority cascade (vertices, then edges, then interior)
    v = torch.where(on_bc, 1.0 - w_bc, v_in)
    w = torch.where(on_bc, w_bc, w_in)
    v, w = torch.where(on_ac, 0.0, v), torch.where(on_ac, w_ac, w)
    v, w = torch.where(on_ab, v_ab, v), torch.where(on_ab, 0.0, w)
    v, w = torch.where(in_c, 0.0, v), torch.where(in_c, 1.0, w)
    v, w = torch.where(in_b, 1.0, v), torch.where(in_b, 0.0, w)
    v, w = torch.where(in_a, 0.0, v), torch.where(in_a, 0.0, w)

    closest = a + v[..., None] * ab + w[..., None] * ac
    diff = closest - p
    dist2 = _dot(diff, diff)
    if not with_features:
        return dist2, closest
    feat = torch.zeros(dist2.shape, dtype=torch.int32, device=dist2.device)
    feat = torch.where(on_bc, 5, feat)
    feat = torch.where(on_ac, 6, feat)
    feat = torch.where(on_ab, 4, feat)
    feat = torch.where(in_c, 3, feat)
    feat = torch.where(in_b, 2, feat)
    feat = torch.where(in_a, 1, feat)
    return dist2, closest, feat


def _winding_contrib(p: torch.Tensor, va: torch.Tensor, vb: torch.Tensor,
                     vc: torch.Tensor) -> torch.Tensor:
    """Solid angle of each triangle seen from each point (van Oosterom &
    Strackee).  ``p``: [P, 1, 3]; ``va, vb, vc``: [1, T, 3].  Returns
    [P, T].  Degenerate (padding) triangles contribute exactly 0."""
    a = va - p
    b = vb - p
    c = vc - p
    la = torch.sqrt(_dot(a, a))
    lb = torch.sqrt(_dot(b, b))
    lc = torch.sqrt(_dot(c, c))
    bxc = torch.stack([b[..., 1] * c[..., 2] - b[..., 2] * c[..., 1],
                       b[..., 2] * c[..., 0] - b[..., 0] * c[..., 2],
                       b[..., 0] * c[..., 1] - b[..., 1] * c[..., 0]], dim=-1)
    num = _dot(a, bxc)
    den = la * lb * lc + _dot(a, b) * lc + _dot(b, c) * la + _dot(c, a) * lb
    return 2.0 * torch.atan2(num, den)


def _sweep_chunk(points: torch.Tensor, tri: torch.Tensor, tri_chunk: int):
    """One point chunk against all triangles: loop over triangle tiles with
    a running (min d2, closest, face id, winding sum).  Ties go to the lowest
    face id: first index within a tile, strict ``<`` across tiles."""
    P = points.shape[0]
    p = points[:, None, :]
    best_d2 = torch.full((P,), float("inf"), dtype=points.dtype, device=points.device)
    best_pt = torch.zeros((P, 3), dtype=points.dtype, device=points.device)
    best_fid = torch.zeros((P,), dtype=torch.int32, device=points.device)
    wind = torch.zeros((P,), dtype=points.dtype, device=points.device)
    for t0 in range(0, tri.shape[0], tri_chunk):
        tile = tri[t0:t0 + tri_chunk]
        a = tile[None, :, 0, :]
        b = tile[None, :, 1, :]
        c = tile[None, :, 2, :]
        d2, cp = _closest_point_bary(p, a, b - a, c - a)
        wind = wind + _winding_contrib(p, a, b, c).sum(dim=-1)
        arg = torch.argmin(d2, dim=-1)
        tile_d2 = d2.gather(1, arg[:, None])[:, 0]
        tile_pt = cp.gather(1, arg[:, None, None].expand(P, 1, 3))[:, 0, :]
        better = tile_d2 < best_d2
        best_pt = torch.where(better[:, None], tile_pt, best_pt)
        best_fid = torch.where(better, (arg + t0).to(torch.int32), best_fid)
        best_d2 = torch.where(better, tile_d2, best_d2)
    return best_d2, best_pt, best_fid, wind


def mesh_closest_query(points: torch.Tensor, tri: torch.Tensor,
                       point_chunk: int = DEFAULT_POINT_CHUNK,
                       tri_chunk: int = DEFAULT_TRI_CHUNK):
    """Closest point + winding number for ``points [P, 3]`` against padded
    triangles ``tri [Fp, 3, 3]`` (plain PyTorch).

    Returns ``(dist [P] unsigned, closest [P, 3], face_id [P] int32,
    winding [P])``.  Memory is bounded by chunking points and triangles.
    """
    Fp = tri.shape[0]
    tri_chunk = min(tri_chunk, Fp)
    tri = pad_to(tri, cdiv(Fp, tri_chunk) * tri_chunk, value=PAD_COORD)
    parts = [_sweep_chunk(points[s:s + point_chunk], tri, tri_chunk)
             for s in range(0, points.shape[0], point_chunk)]
    if not parts:
        parts = [_sweep_chunk(points, tri, tri_chunk)]
    d2, cp, fid, wind = (torch.cat(x) for x in zip(*parts))
    return torch.sqrt(d2), cp, fid, wind / _FOUR_PI


def signed_closest_query(points: torch.Tensor, tri: torch.Tensor,
                         normals: torch.Tensor,
                         surface_normal_eps: float = 1e-3,
                         winding_threshold: float = 0.5,
                         point_chunk: int = DEFAULT_POINT_CHUNK,
                         tri_chunk: int = DEFAULT_TRI_CHUNK,
                         backend: str = "auto"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Signed query: signed distance, SDF gradient (the face normal within
    ``surface_normal_eps`` of the surface), closest surface point and the
    face normal at the closest point.

    ``backend``: "auto" runs the CUDA kernel for a CUDA tensor and the plain
    sweep for a CPU tensor; "torch" forces the plain sweep (the kernel's
    reference on the card).

    Returns ``(closest [P,3], sdf [P], gradient [P,3], normal [P,3])``.
    """
    if backend == "auto":
        from pytorch_volumetric_tpu_torch.ops.closest_point import (
            mesh_closest_query_cuda)
        dist, closest, fid, wind = mesh_closest_query_cuda(
            points, tri, point_chunk=point_chunk, tri_chunk=tri_chunk)
    elif backend == "torch":
        dist, closest, fid, wind = mesh_closest_query(
            points, tri, point_chunk=point_chunk, tri_chunk=tri_chunk)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    # |winding|: orientation-independent, like ray parity
    inside = wind.abs() > winding_threshold
    sign = torch.where(inside, -1.0, 1.0).to(points.dtype)
    sdf = sign * dist
    away = points - closest
    grad = sign[..., None] * away / torch.clamp(dist, min=1e-12)[..., None]
    face_n = normals.index_select(0, fid)
    on_surface = dist < surface_normal_eps
    grad = torch.where(on_surface[..., None], face_n, grad)
    return closest, sdf, grad, face_n
