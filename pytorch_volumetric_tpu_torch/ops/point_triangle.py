"""Batched point -> triangle-mesh closest-point and winding-number queries.

This module holds the plain PyTorch versions of the sweep: a chunked
brute-force pass over triangle tiles that carries a running (min squared
distance, closest point, face id) and a running winding-number sum.  On a
CUDA tensor :func:`signed_closest_query` runs the hand-written kernel
(``ops.closest_point``); on a CPU tensor it runs the plain version below.

Every dot product and sum is written out component by component in a fixed
order, the same order the CUDA kernels use, so a kernel built without FMA
contraction and its plain version give the same distances and face ids on
the card.  Three variants share the sweep:

- :func:`mesh_closest_query`: the direct forms (``(p - a) . ab``, ...), the
  plain version of ``csrc/closest_point.cu``;
- ``mesh_closest_query(..., winding=False)``: the same without the winding
  sum, the plain version of the kernel's no-winding instantiation;
- :func:`mesh_closest_query_expanded`: each pair's d1, d2, solid-angle
  numerator and squared corner distances as products of the point's row
  ``(q, 1, |q|^2)`` with per-triangle columns, in a frame per group of
  faces, the plain version of the tensor-core kernel
  (``csrc/closest_point_mma.cu``).

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
    return _region_cascade(p, a, ab, ac, d1, d2, d3, d4, d5, d6, with_features)


def _region_cascade(p, a, ab, ac, d1, d2, d3, d4, d5, d6, with_features=False):
    """The Voronoi-region cascade of :func:`_closest_point_bary` on given
    ``d1 = ab . (p - a)``, ``d2 = ac . (p - a)``, ``d3, d4`` (from b) and
    ``d5, d6`` (from c), each [P, T]."""
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


def _corners(t: torch.Tensor):
    """The corners a, b, c of triangle rows ``t [..., R >= 3, 3]``."""
    return t[..., 0, :], t[..., 1, :], t[..., 2, :]


def _pairs_direct(p, t):
    """Per-pair (dist2, closest, solid angle) from the direct forms."""
    a, b, c = _corners(t)
    d2, cp = _closest_point_bary(p, a, b - a, c - a)
    return d2, cp, _winding_contrib(p, a, b, c)


def _pairs_direct_nowind(p, t):
    """:func:`_pairs_direct` without the solid angle (None)."""
    a, b, c = _corners(t)
    d2, cp = _closest_point_bary(p, a, b - a, c - a)
    return d2, cp, None


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], dim=-1)


# The tensor-core kernel's grouping (csrc/closest_point_mma.cu, kTriTile and
# kCluster): every tile of EXPANDED_TILE input rows is compacted to its real
# faces and cut into groups of EXPANDED_GROUP; a group shares one frame and
# one box.  The box is the kernel's cluster box, grown by CULL_ABS of its
# largest coordinate and infinite when a face is thin (squared area below
# THIN of its longest edge's fourth power), as in csrc/closest_point.cu.
EXPANDED_TILE = 64
EXPANDED_GROUP = 8
CULL_ABS = 1e-5
THIN = 1e-3
# a pair's solid angle comes from the direct forms where the point lies
# within EXPANDED_NEAR diagonals of its group's box, where the expanded
# forms cancel
EXPANDED_NEAR = 1.0


def _is_thin(ab: torch.Tensor, ac: torch.Tensor) -> torch.Tensor:
    """Whether each triangle with edges ``ab, ac`` is thin (NaN is thin)."""
    x = _cross(ab, ac)
    l2 = torch.maximum(_dot(ab, ab), _dot(ac, ac))
    return ~(_dot(x, x) >= THIN * (l2 * l2))


def expanded_frames(tri: torch.Tensor) -> torch.Tensor:
    """Each face's frame origin and group box as the tensor-core kernel
    forms them: ``[F, 3, 3]`` rows (origin, box lo, box hi) for ``tri
    [F, 3, 3]``.

    The frame of a group is centred on the first corner of its first face,
    so ``PAD_COORD`` padding anywhere moves no frame.  A padding face keeps
    its own first corner as its origin and as a box of no extent."""
    F = tri.shape[0]
    pad = (tri == PAD_COORD).flatten(1).all(dim=1)
    a = tri[:, 0]
    thin = _is_thin(tri[:, 1] - a, tri[:, 2] - a)
    out = a[:, None, :].repeat(1, 3, 1)
    inf = torch.full((3,), float("inf"), dtype=tri.dtype, device=tri.device)
    for f0 in range(0, F, EXPANDED_TILE):
        ids = torch.arange(f0, min(f0 + EXPANDED_TILE, F), device=tri.device)
        ids = ids[~pad[ids]]
        for k in range(0, ids.shape[0], EXPANDED_GROUP):
            g = ids[k:k + EXPANDED_GROUP]
            corners = tri[g].reshape(-1, 3)
            lo, hi = corners.min(dim=0).values, corners.max(dim=0).values
            eta = CULL_ABS * torch.maximum(-lo, hi).max()
            if bool(thin[g].any()):
                lo, hi = -inf, inf
            else:
                lo, hi = lo - eta, hi + eta
            out[g, 0] = tri[g[0], 0]
            out[g, 1] = lo
            out[g, 2] = hi
    return out


def expanded_columns(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The tensor-core product's triangle columns, ``[..., 6, 5]`` for
    corners ``[..., 3]`` in a group's frame.  Against a point's row
    ``(qx, qy, qz, 1, |q|^2)`` the six columns give ``d1 = ab.(q - a)``,
    ``d2 = ac.(q - a)``, the solid angle's numerator ``(a-q).((b-q) x
    (c-q)) = a.(b x c) - q.n`` with ``n = ab x ac``, and the squared
    corner distances ``|a - q|^2, |b - q|^2, |c - q|^2``."""
    ab, ac = b - a, c - a
    zero, one = torch.zeros_like(a[..., 0]), torch.ones_like(a[..., 0])

    def col(v, const, e):
        return torch.stack([v[..., 0], v[..., 1], v[..., 2], const, e], dim=-1)

    return torch.stack([col(ab, -_dot(ab, a), zero), col(ac, -_dot(ac, a), zero),
                        col(-_cross(ab, ac), _dot(a, _cross(b, c)), zero),
                        col(-2.0 * a, _dot(a, a), one), col(-2.0 * b, _dot(b, b), one),
                        col(-2.0 * c, _dot(c, c), one)], dim=-2)


def _products(q: torch.Tensor, pp: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Each pair's six products in float32: the point row ``(qx, qy, qz, 1,
    pp)`` (``q [P, T, 3]``, ``pp [P, T]``) against the columns ``cols
    [1, T, 6, 5]``, summed in that order; ``[P, T, 6]``."""
    return (q[..., 0, None] * cols[..., 0] + q[..., 1, None] * cols[..., 1]
            + q[..., 2, None] * cols[..., 2] + cols[..., 3] + pp[..., None] * cols[..., 4])


def _pairs_expanded(p, t, products=_products, near: float = EXPANDED_NEAR):
    """Per-pair (dist2, closest, solid angle) from the tensor-core kernel's
    products (:func:`expanded_columns`) in each group's frame; ``t [1, T,
    6, 3]`` holds each face's corners and its :func:`expanded_frames` rows.

    - ``d3 = d1 - |ab|^2``, ``d4 = d2 - ab.ac``, ``d5 = d1 - ab.ac``,
      ``d6 = d2 - |ac|^2``; the closest point from the region cascade, the
      squared distance directly as ``|q' - q|^2``.
    - The solid angle's cross terms ``(a-q).(b-q) = (|a-q|^2 + |b-q|^2 -
      |ab|^2) / 2``.  Within ``near`` diagonals of the group's box the
      solid angle comes from the direct forms in the frame instead.

    ``products`` takes the pairs' products
    (``scripts/tf32_split_emulation_torch.py`` passes emulated split-TF32
    ones)."""
    a, b, c = _corners(t)
    o, lo, hi = t[..., 3, :], t[..., 4, :], t[..., 5, :]
    gap = torch.clamp(torch.maximum(lo - p, p - hi), min=0.0)
    span = hi - lo
    is_near = _dot(gap, gap) <= (near * near) * _dot(span, span)
    q, a, b, c = p - o, a - o, b - o, c - o
    ab, ac = b - a, c - a
    pp = _dot(q, q)
    m = products(q, pp, expanded_columns(a, b, c))
    d1, d2 = m[..., 0], m[..., 1]
    ab2, ac2, abac = _dot(ab, ab), _dot(ac, ac), _dot(ab, ac)
    dist2, cp = _region_cascade(q, a, ab, ac, d1, d2, d1 - ab2, d2 - abac, d1 - abac,
                                d2 - ac2)
    la2, lb2, lc2 = (torch.clamp(m[..., k], min=0.0) for k in (3, 4, 5))
    la, lb, lc = torch.sqrt(la2), torch.sqrt(lb2), torch.sqrt(lc2)
    bc = c - b
    den = (la * lb * lc + (la2 + lb2 - ab2) * 0.5 * lc
           + (lb2 + lc2 - _dot(bc, bc)) * 0.5 * la + (lc2 + la2 - ac2) * 0.5 * lb)
    solid = torch.where(is_near, _winding_contrib(q, a, b, c),
                        2.0 * torch.atan2(m[..., 2], den))
    return dist2, cp + o, solid


def _sweep_chunk(points: torch.Tensor, tri: torch.Tensor, tri_chunk: int, pairs):
    """One point chunk against all triangles: loop over triangle tiles with
    a running (min d2, closest, face id, winding sum).  Ties go to the lowest
    face id: first index within a tile, strict ``<`` across tiles.  A
    ``pairs`` function that returns no solid angle leaves the sum at 0."""
    P = points.shape[0]
    p = points[:, None, :]
    best_d2 = torch.full((P,), float("inf"), dtype=points.dtype, device=points.device)
    best_pt = torch.zeros((P, 3), dtype=points.dtype, device=points.device)
    best_fid = torch.zeros((P,), dtype=torch.int32, device=points.device)
    wind = torch.zeros((P,), dtype=points.dtype, device=points.device)
    for t0 in range(0, tri.shape[0], tri_chunk):
        d2, cp, solid = pairs(p, tri[None, t0:t0 + tri_chunk])
        if solid is not None:
            wind = wind + solid.sum(dim=-1)
        arg = torch.argmin(d2, dim=-1)
        tile_d2 = d2.gather(1, arg[:, None])[:, 0]
        tile_pt = cp.gather(1, arg[:, None, None].expand(P, 1, 3))[:, 0, :]
        better = tile_d2 < best_d2
        best_pt = torch.where(better[:, None], tile_pt, best_pt)
        best_fid = torch.where(better, (arg + t0).to(torch.int32), best_fid)
        best_d2 = torch.where(better, tile_d2, best_d2)
    return best_d2, best_pt, best_fid, wind


def _sweep(points, tri, point_chunk, tri_chunk, pairs):
    """The chunked sweep over triangle rows ``tri [Fp, R, 3]`` (corners
    first; padded here with ``PAD_COORD`` rows to whole tiles)."""
    Fp = tri.shape[0]
    tri_chunk = min(tri_chunk, Fp)
    tri = pad_to(tri, cdiv(Fp, tri_chunk) * tri_chunk, value=PAD_COORD)
    parts = [_sweep_chunk(points[s:s + point_chunk], tri, tri_chunk, pairs)
             for s in range(0, points.shape[0], point_chunk)]
    if not parts:
        parts = [_sweep_chunk(points, tri, tri_chunk, pairs)]
    d2, cp, fid, wind = (torch.cat(x) for x in zip(*parts))
    return torch.sqrt(d2), cp, fid, wind / _FOUR_PI


def mesh_closest_query(points: torch.Tensor, tri: torch.Tensor,
                       point_chunk: int = DEFAULT_POINT_CHUNK,
                       tri_chunk: int = DEFAULT_TRI_CHUNK,
                       winding: bool = True):
    """Closest point + winding number for ``points [P, 3]`` against padded
    triangles ``tri [Fp, 3, 3]`` (plain PyTorch).

    Returns ``(dist [P] unsigned, closest [P, 3], face_id [P] int32,
    winding [P])``.  With ``winding=False`` the winding sum is skipped and
    returned as zeros.  Memory is bounded by chunking points and triangles.
    """
    return _sweep(points, tri, point_chunk, tri_chunk,
                  _pairs_direct if winding else _pairs_direct_nowind)


def mesh_closest_query_expanded(points: torch.Tensor, tri: torch.Tensor,
                                point_chunk: int = DEFAULT_POINT_CHUNK,
                                tri_chunk: int = DEFAULT_TRI_CHUNK):
    """:func:`mesh_closest_query` computed from the tensor-core kernel's
    products (:func:`_pairs_expanded`), its plain version.  Same outputs
    (``PAD_COORD`` padding allowed anywhere); agrees with the direct forms
    to float32 rounding, which the products amplify in proportion to a
    point's distance from its group's frame (about 1e-7 of it in
    distance)."""
    rows = torch.cat([tri, expanded_frames(tri)], dim=1)
    return _sweep(points, rows, point_chunk, tri_chunk, _pairs_expanded)


def signed_closest_query(points: torch.Tensor, tri: torch.Tensor,
                         normals: torch.Tensor,
                         surface_normal_eps: float = 1e-3,
                         winding_threshold: float = 0.5,
                         point_chunk: int = DEFAULT_POINT_CHUNK,
                         tri_chunk: int = DEFAULT_TRI_CHUNK,
                         backend: str = "auto",
                         exterior_box=None,
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Signed query: signed distance, SDF gradient (the face normal within
    ``surface_normal_eps`` of the surface), closest surface point and the
    face normal at the closest point.

    ``backend``: "auto" runs the CUDA kernel for a CUDA tensor and the plain
    sweep for a CPU tensor; "torch" forces the plain sweep (the kernel's
    reference on the card).  ``exterior_box`` (``mesh.exterior_box``, only
    for a surface with no boundary) lets the kernel skip the winding sum
    outside it; the plain sweep ignores it.

    Returns ``(closest [P,3], sdf [P], gradient [P,3], normal [P,3])``.
    """
    if backend == "auto":
        from pytorch_volumetric_tpu_torch.ops.closest_point import (
            mesh_closest_query_cuda)
        dist, closest, fid, wind = mesh_closest_query_cuda(
            points, tri, exterior_box=exterior_box, point_chunk=point_chunk,
            tri_chunk=tri_chunk)
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
