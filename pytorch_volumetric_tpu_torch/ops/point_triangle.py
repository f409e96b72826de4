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
- :func:`mesh_closest_query_expanded`: the pairwise dot products
  ``p . ab, p . ac, p . n, p . a, p . b, p . c`` with per-triangle
  constants, the plain version of the tensor-core kernel
  (``csrc/closest_point_mma.cu``).

Triangle arrays are padded with degenerate far-away triangles
(``mesh.PAD_COORD``) that never win the min and contribute exactly zero
solid angle.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pytorch_volumetric_tpu_torch.mesh import PAD_COORD
from pytorch_volumetric_tpu_torch.utils.batching import cdiv, pad_to, round_up

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


def _pairs_direct(p, a, b, c):
    """Per-pair (dist2, closest, solid angle) from the direct forms."""
    d2, cp = _closest_point_bary(p, a, b - a, c - a)
    return d2, cp, _winding_contrib(p, a, b, c)


def _pairs_direct_nowind(p, a, b, c):
    """:func:`_pairs_direct` without the solid angle (None)."""
    d2, cp = _closest_point_bary(p, a, b - a, c - a)
    return d2, cp, None


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], dim=-1)


EXPANDED_GROUP = 8  # triangles sharing one frame in the expanded sweep


def _pairs_expanded(p, a, b, c, dot=_dot, group: int = EXPANDED_GROUP):
    """Per-pair (dist2, closest, solid angle) from the six pairwise dot
    products ``p . {ab, ac, n, a, b, c}`` and per-triangle constants (the
    arithmetic of ``benchmarks/pallas_mxu_ab.py`` mode ``mxu``):
    ``d1 = p.ab - ab.a``, ``|a - p|^2 = |a|^2 - 2 p.a + |p|^2``,
    ``(a-p).(b-p) = a.b - p.a - p.b + |p|^2`` and ``num = a.(b x c) - p.n``
    with ``n = b x c + c x a + a x b``.  The distance is still taken
    directly as ``|q - p|^2``.

    The expanded forms cancel in proportion to the magnitudes of ``p`` and
    the corners, so each group of ``EXPANDED_GROUP`` triangles (counted from
    the first of the tile, which starts at a multiple of the group) works in
    a frame centred on its first triangle's first corner, as the kernel
    does (``group`` 0: the mesh's own frame).  ``dot`` takes the six
    products (``scripts/tf32_split_emulation_torch.py`` passes emulated
    split-TF32 products)."""
    o = 0.0
    if group:
        T = a.shape[1]
        o = a[:, ::group].repeat_interleave(group, dim=1)[:, :T]
        p, a, b, c = p - o, a - o, b - o, c - o
    ab, ac = b - a, c - a
    # n summed as b x c + c x a + a x b, each cross in the kernel's order
    n = _cross(b, c) + _cross(c, a) + _cross(a, b)
    pab, pac, pn = dot(p, ab), dot(p, ac), dot(p, n)
    pa, pb, pc = dot(p, a), dot(p, b), dot(p, c)
    d2, cp = _region_cascade(p, a, ab, ac, pab - _dot(ab, a), pac - _dot(ac, a),
                             pab - _dot(ab, b), pac - _dot(ac, b),
                             pab - _dot(ab, c), pac - _dot(ac, c))
    pp = _dot(p, p)
    la = torch.sqrt(torch.clamp(_dot(a, a) - 2.0 * pa + pp, min=0.0))
    lb = torch.sqrt(torch.clamp(_dot(b, b) - 2.0 * pb + pp, min=0.0))
    lc = torch.sqrt(torch.clamp(_dot(c, c) - 2.0 * pc + pp, min=0.0))
    num = _dot(a, _cross(b, c)) - pn
    den = (la * lb * lc + (_dot(a, b) - pa - pb + pp) * lc
           + (_dot(b, c) - pb - pc + pp) * la + (_dot(c, a) - pc - pa + pp) * lb)
    return d2, cp + o, 2.0 * torch.atan2(num, den)


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
        tile = tri[t0:t0 + tri_chunk]
        a = tile[None, :, 0, :]
        b = tile[None, :, 1, :]
        c = tile[None, :, 2, :]
        d2, cp, solid = pairs(p, a, b, c)
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
    """:func:`mesh_closest_query` computed from the pairwise dot products
    (:func:`_pairs_expanded`), the arithmetic of the tensor-core kernel.
    Same outputs; agrees with the direct forms to float32 rounding, which
    the expanded forms amplify (about 1e-7 of ``|p|`` in distance)."""
    tri_chunk = round_up(tri_chunk, EXPANDED_GROUP)  # tiles start at a group
    return _sweep(points, tri, point_chunk, tri_chunk, _pairs_expanded)


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
