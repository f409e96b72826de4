"""Narrow-band mesh SDF: exact near the surface, voxel-accurate far field.

The brute-force sweep (``ops.point_triangle``) costs ``points x faces``
pairs; on meshes of hundreds of thousands of faces that is the wrong shape
of work.  This module trades it for a host-built cell grid:

- **Build (host, native C++, ``native/``):** a regular grid over the padded
  mesh box.  Each cell whose center lies within ``band`` of the surface
  gets a packed candidate list: every triangle within ``d(center) +
  half_diag`` of the cell's box, which holds the closest triangle of every
  point in the cell (the distance is 1-Lipschitz).  Each cell's signed
  value and gradient at its center come from the native BVH.  Cells with
  ``max_k`` candidates or more are demoted to the far field (with a
  warning) rather than truncated.
- **Query (device):** the cell's meta row; in the band, the closest-point
  cascade over the cell's ``K`` candidate rows and the winner's
  angle-weighted pseudonormal (Baerentzen & Aanaes) at its closest feature
  for the sign; in the far field, the center's value with a first-order
  step; outside the grid, the distance to the surface's box.

Tables are the JAX package's (``pytorch_volumetric_tpu/ops/narrow_band.py``)
field for field, in the same ``.npz`` store and key, so each package loads
the other's cache.  The small grid fields (``NarrowBandSmalls``) are CPU
tensors, the counterpart of the JAX package's trace-time constants: the
kernel takes them as launch arguments.  The large tables
(``NarrowBandBig``) live on the query's device.

:func:`narrow_band_query` runs the hand-written kernel
(``csrc/narrow_band.cu``, ``ops.narrow_band_cuda``) on a CUDA tensor and
the plain version :func:`_query_impl` on a CPU tensor.  The plain version
computes cell keys as ``(p - lo) * f32(1 / res)``, the arithmetic of the
JAX package's jitted query (XLA folds the division by a constant into this
multiply), and writes every sum in the kernel's order.
"""

from __future__ import annotations

import hashlib
import logging
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_volumetric_tpu_torch.mesh import PAD_COORD, TriangleMesh
from pytorch_volumetric_tpu_torch.ops.point_triangle import _closest_point_bary, _dot
from pytorch_volumetric_tpu_torch.utils.batching import float_keys, resolve_device
from pytorch_volumetric_tpu_torch.utils.cache import get_store

logger = logging.getLogger(__name__)

# (point, candidate) pairs per chunk of the plain version: its [n, K]
# intermediates and [n, K, 10] rows stay under ~1 GB
PAIRS_PER_CHUNK = 1 << 22

# slot codes of a query's classification (``with_slots``)
FAR, OUT_OF_GRID = -1, -2


class NarrowBandSmalls(NamedTuple):
    """The small grid fields, CPU tensors."""
    lo: torch.Tensor       # [3] float32 grid origin
    res: torch.Tensor      # [3] float32 cell size
    dims: torch.Tensor     # [3] int32 cell counts
    strides: torch.Tensor  # [3] int32 ravel strides
    bb: torch.Tensor       # [3, 2] float32 surface box (out-of-grid fallback)


class NarrowBandBig(NamedTuple):
    """The large tables, on the query's device."""
    meta: torch.Tensor    # [C, 5]: signed value, gradient xyz, slot (-1 far) at each center
    cand: torch.Tensor    # [S, K, 10]: corners 9 | face id (int32 bit pattern)
    pseudo: torch.Tensor  # [F, 21]: n_face 3 | n_vert 9 | n_edge 9


class NarrowBandTables(NamedTuple):
    """The JAX package's eight tables, in its order."""
    lo: torch.Tensor
    res: torch.Tensor
    dims: torch.Tensor
    strides: torch.Tensor
    meta: torch.Tensor
    cand: torch.Tensor
    pseudo: torch.Tensor
    bb: torch.Tensor

    @property
    def smalls(self) -> NarrowBandSmalls:
        return NarrowBandSmalls(self.lo, self.res, self.dims, self.strides, self.bb)

    @property
    def big(self) -> NarrowBandBig:
        return NarrowBandBig(self.meta, self.cand, self.pseudo)


def tables_from_numpy(arrays: Sequence[np.ndarray], device=None) -> NarrowBandTables:
    """:class:`NarrowBandTables` from the eight host arrays (for example the
    JAX package's ``NarrowBandTables``, or a cache entry): the grid fields
    on the CPU, the large tables on ``device`` (CUDA unless named)."""
    if len(arrays) != 8:
        raise ValueError(f"narrow-band tables are 8 arrays, got {len(arrays)}")
    dev = resolve_device(device)
    lo, res, dims, strides, meta, cand, pseudo, bb = (np.asarray(a) for a in arrays)
    # copies: the arrays may be read-only views of another package's buffers
    small = [torch.tensor(np.asarray(a, dtype=t)) for a, t in
             ((lo, np.float32), (res, np.float32), (dims, np.int32), (strides, np.int32),
              (bb, np.float32))]
    big = [torch.tensor(np.ascontiguousarray(a, dtype=np.float32), device=dev)
           for a in (meta, cand, pseudo)]
    return NarrowBandTables(small[0], small[1], small[2], small[3], *big, small[4])


def _mesh_fingerprint(m: TriangleMesh) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(m.vertices).tobytes())
    h.update(np.ascontiguousarray(m.faces).tobytes())
    return h.hexdigest()[:16]


def build_narrow_band_host(m: TriangleMesh, cell_res: float, band: float,
                           padding: float = 0.1, max_k: int = 256) -> Tuple[np.ndarray, ...]:
    """The eight tables as host numpy arrays, built with the native runtime.
    Each cell's candidates are in ascending face order (see
    ``native/pvt_native.cpp``)."""
    from pytorch_volumetric_tpu_torch import native

    if len(m.faces) == 0:
        raise ValueError("cannot build a narrow band for an empty mesh (no faces)")
    tris = m.triangles().astype(np.float32)
    aabb = m.aabb()
    lo = aabb[:, 0] - padding
    hi = aabb[:, 1] + padding
    dims = np.maximum(np.ceil((hi - lo) / cell_res).astype(np.int64), 1)
    res = (hi - lo) / dims
    C = int(np.prod(dims))
    if C >= 2 ** 31:
        raise ValueError(f"narrow-band grid of {C} cells: cell indices are int32 "
                         "(at most 2^31 - 1 cells); use a larger cell_res")
    half_diag = 0.5 * float(np.linalg.norm(res))

    # signed value + gradient at every cell center (native BVH)
    ii = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij"),
                  axis=-1).reshape(-1, 3)
    centers = (lo + (ii + 0.5) * res).astype(np.float32)
    scene = native.NativeScene(tris)
    dist, closest, _, wind = scene.closest_query(centers)
    # |winding|: orientation-independent inside test
    inside = np.abs(wind) > 0.5
    sign = np.where(inside, -1.0, 1.0).astype(np.float32)
    val = sign * dist
    direction = centers - closest
    direction /= np.maximum(np.linalg.norm(direction, axis=-1, keepdims=True), 1e-12)
    grad = sign[:, None] * direction

    band_mask = dist <= band
    radius = np.where(band_mask, dist + half_diag + 1e-5, -1.0).astype(np.float32)
    ids, counts = native.build_cell_table(tris, lo, res, dims, radius, max_k=max_k)
    K = ids.shape[1]
    overflow = counts >= max_k
    if overflow.any():
        # a truncated candidate list could miss the closest triangle: those
        # cells take the (bounded-error) far field instead
        logger.warning(
            "narrow-band: %d cells exceed max_k=%d candidates and fall back "
            "to the far-field approximation; increase max_k or shrink the "
            "band/cell size for full exactness", int(overflow.sum()), max_k)
        band_mask = band_mask & ~overflow

    slots = np.full(C, -1, dtype=np.int32)
    band_cells = np.nonzero(band_mask)[0]
    if len(band_cells) > 2 ** 24:
        raise ValueError(f"{len(band_cells)} band cells: slots ride in float32 meta "
                         "rows (exact up to 2^24); use a larger cell_res or band")
    slots[band_cells] = np.arange(len(band_cells), dtype=np.int32)
    S = max(len(band_cells), 1)

    ids_b = ids[band_cells] if len(band_cells) else np.full((1, K), -1, dtype=np.int32)
    flat = ids_b.reshape(-1)
    safe = np.maximum(flat, 0)
    packed = np.empty((len(flat), 10), dtype=np.float32)
    packed[:, :9] = tris.reshape(-1, 9)[safe]
    # the face id rides in the float row as an int32 bit pattern (exact for
    # every id; a float32 value would round ids above 2^24)
    packed[:, 9] = safe.astype(np.int32).view(np.float32)
    invalid = flat < 0
    packed[invalid, :9] = PAD_COORD
    packed[invalid, 9] = np.int32(0).view(np.float32)
    cand = packed.reshape(S, K, 10)

    n_vert, n_edge, n_face = m.pseudonormals()
    if m.signed_volume() < 0.0:
        # inverted orientation: pseudonormals point inward; flip them so the
        # sign test agrees with the winding-number sign of the meta rows
        logger.warning("mesh winds inward (signed volume < 0); flipping "
                       "pseudonormals for the sign test")
        n_vert, n_edge, n_face = -n_vert, -n_edge, -n_face
    pseudo = np.concatenate([n_face.astype(np.float32),
                             n_vert.reshape(-1, 9).astype(np.float32),
                             n_edge.reshape(-1, 9).astype(np.float32)], axis=1)

    meta = np.concatenate([val[:, None], grad, slots[:, None].astype(np.float32)], axis=1)
    strides = np.array([dims[1] * dims[2], dims[2], 1], dtype=np.int64)
    logger.info("narrow-band tables: %d cells (%d band, K=%d, %.1f MB)",
                C, len(band_cells), K, cand.nbytes / 1e6)
    return (lo.astype(np.float32), res.astype(np.float32), dims.astype(np.int32),
            strides.astype(np.int32), meta.astype(np.float32), cand, pseudo,
            aabb.astype(np.float32))


def build_narrow_band_tables(m: TriangleMesh, cell_res: float, band: float,
                             padding: float = 0.1, max_k: int = 256,
                             cache_path: Optional[str] = None,
                             device=None) -> NarrowBandTables:
    """Build (or load) the tables of ``m`` with the large ones on ``device``
    (CUDA unless named).

    ``cache_path``: an optional ``.npz`` store, keyed by the mesh's content
    hash and the build parameters under the JAX package's key ("nb2": face
    ids packed as int32 bit patterns), so restarts skip the BVH sweep and
    the candidate tables.
    """
    dev = resolve_device(device)
    key = None
    if cache_path is not None:
        key = f"nb2 {_mesh_fingerprint(m)} {cell_res} {band} {padding} {max_k}"
        hit = get_store(cache_path).get(key)
        if hit is not None and len(hit) == 8:
            logger.info("narrow-band tables for %s loaded from %s", key, cache_path)
            return tables_from_numpy(hit, dev)
    host = build_narrow_band_host(m, cell_res, band, padding, max_k)
    if key is not None:
        get_store(cache_path).put(key, list(host))
        logger.info("narrow-band tables cached to %s", cache_path)
    return tables_from_numpy(host, dev)


# ---------------------------------------------------------------------------
# The plain version of the query
# ---------------------------------------------------------------------------

def inverse_res(smalls: NarrowBandSmalls) -> torch.Tensor:
    """``f32(1 / res)``, the reciprocal of the cell keys' multiply."""
    return torch.as_tensor(np.float32(1.0) / smalls.res.numpy().astype(np.float32))


def cell_index(smalls: NarrowBandSmalls, points: torch.Tensor):
    """Each point's cell: ``(in_grid [P] bool, kc [P, 3] int64 clamped into
    the grid, cidx [P] int64 flat index)``.  Keys are ``floor((p - lo) *
    f32(1 / res))`` converted by :func:`float_keys` (NaN to 0, clamped to
    ``[-1, dims]``), as the JAX package's keys and the kernel's are."""
    dev = points.device
    lo = smalls.lo.to(dev)
    inv_res = inverse_res(smalls).to(dev)
    dims = smalls.dims.to(device=dev, dtype=torch.int64)
    k = float_keys(torch.floor((points - lo) * inv_res), dims)
    in_grid = ((k >= 0) & (k < dims)).all(dim=-1)
    kc = torch.minimum(k.clamp(min=0), dims - 1)
    cidx = (kc * smalls.strides.to(device=dev, dtype=torch.int64)).sum(dim=-1)
    return in_grid, kc, cidx


def _candidate_pairs(p: torch.Tensor, rows: torch.Tensor):
    """The cascade of each point against each of its candidate rows: ``p
    [n, 3]``, ``rows [n, K, 10]`` -> ``(dist2 [n, K], q [n, K, 3], feat [n,
    K])``."""
    a = rows[..., 0:3]
    return _closest_point_bary(p[:, None, :], a, rows[..., 3:6] - a, rows[..., 6:9] - a,
                               with_features=True)


def _candidate_query(p: torch.Tensor, rows: torch.Tensor, fid_bits: torch.Tensor,
                     pseudo: torch.Tensor, surface_normal_eps: float):
    """Signed distance and gradient of each point against its candidate
    rows: ``p [n, 3]``, ``rows [n, K, 10]``, ``fid_bits [n, K]`` (column 9
    read as int32), ``pseudo [F, 21]`` -> ``(val [n], grad [n, 3])``."""
    dist2, q, feat = _candidate_pairs(p, rows)
    # the first least value, or the first NaN
    kbest = torch.argmin(dist2, dim=1, keepdim=True)
    return _winner_query(p, dist2, q, feat, fid_bits, kbest, pseudo, surface_normal_eps)


def _winner_query(p, dist2, q, feat, fid_bits, kbest, pseudo, surface_normal_eps: float):
    """Signed distance and gradient from the winning row ``kbest [n, 1]``
    of each point's pairs (:func:`_candidate_pairs`)."""
    d = torch.sqrt(dist2.gather(1, kbest)[:, 0])
    qw = q.gather(1, kbest[..., None].expand(-1, 1, 3))[:, 0]
    fid = fid_bits.gather(1, kbest)[:, 0].to(torch.int64)
    featw = feat.gather(1, kbest)[:, 0].to(torch.int64)

    # the winner's pseudonormal at its closest feature: one 21-float row,
    # face | vertices A, B, C | edges AB, BC, CA
    rows_n = pseudo.index_select(0, fid).reshape(-1, 7, 3)
    nw = rows_n.gather(1, featw[:, None, None].expand(-1, 1, 3))[:, 0]

    to_p = p - qw
    sgn = torch.where(_dot(to_p, nw) < 0.0, -1.0, 1.0).to(p.dtype)
    val = sgn * d
    grad = (sgn[:, None] * to_p) / torch.clamp(d, min=1e-12)[:, None]
    # at the surface the direction is degenerate: the pseudonormal
    nw_unit = nw / torch.clamp(torch.sqrt(_dot(nw, nw)), min=1e-12)[:, None]
    grad = torch.where((d < surface_normal_eps)[:, None], nw_unit, grad)
    return val, grad


def _query_impl(smalls: NarrowBandSmalls, big: NarrowBandBig, points: torch.Tensor,
                surface_normal_eps: float):
    """The plain query: ``points [P, 3] -> (val [P], grad [P, 3], slot [P]
    int32)``, ``slot`` the candidate slot, :data:`FAR` or
    :data:`OUT_OF_GRID`.  Only in-band points run the candidate cascade, in
    chunks of :data:`PAIRS_PER_CHUNK` (point, candidate) pairs."""
    p = points
    dev = p.device
    in_grid, kc, cidx = cell_index(smalls, p)
    meta = big.meta.index_select(0, cidx)
    lo, res = smalls.lo.to(dev), smalls.res.to(dev)
    center = lo + (kc.to(p.dtype) + 0.5) * res
    far_grad = meta[:, 1:4]
    val = meta[:, 0] + _dot(far_grad, p - center)
    grad = far_grad
    slot = torch.where(in_grid, meta[:, 4].to(torch.int32), OUT_OF_GRID)

    band = torch.nonzero(slot >= 0)[:, 0]
    if band.numel():
        K = big.cand.shape[1]
        fid_bits = big.cand.view(torch.int32)[..., 9]
        chunk = max(1, PAIRS_PER_CHUNK // K)
        vals, grads = [], []
        for s in range(0, band.numel(), chunk):
            idx = band[s:s + chunk]
            sl = slot.index_select(0, idx).to(torch.int64)
            v, g = _candidate_query(p.index_select(0, idx), big.cand.index_select(0, sl),
                                    fid_bits.index_select(0, sl), big.pseudo,
                                    surface_normal_eps)
            vals.append(v)
            grads.append(g)
        val = val.index_copy(0, band, torch.cat(vals))
        grad = grad.index_copy(0, band, torch.cat(grads))

    # outside the grid: the distance to the surface's box (an under-
    # approximation, CachedSDF's BOUNDING_BOX semantics)
    bb = smalls.bb.to(dev)
    dtotal = torch.clamp(p - bb[:, 1], min=0.0) - torch.clamp(bb[:, 0] - p, min=0.0)
    oob_val = torch.sqrt(_dot(dtotal, dtotal))
    oob_grad = dtotal / torch.clamp(oob_val, min=1e-12)[:, None]
    val = torch.where(in_grid, val, oob_val)
    grad = torch.where(in_grid[:, None], grad, oob_grad)
    return val, grad, slot


def narrow_band_query(tables: NarrowBandTables, points: torch.Tensor,
                      surface_normal_eps: float = 1e-3, backend: str = "auto",
                      with_slots: bool = False, grid=None):
    """``points [P, 3] -> (val [P], grad [P, 3])`` (and ``slot [P]`` int32
    with ``with_slots``: the candidate slot, -1 far field, -2 outside the
    grid).

    ``backend``: "auto" calls the kernel's wrapper (the kernel for a CUDA
    tensor, the plain version for a CPU tensor); "torch" forces the plain
    version (the kernel's reference on the card).  ``grid``: the grid
    fields as lists (``narrow_band_cuda.grid_lists``), when the caller
    holds them."""
    if backend == "auto":
        from pytorch_volumetric_tpu_torch.ops.narrow_band_cuda import narrow_band_query_cuda
        out = narrow_band_query_cuda(tables.smalls, tables.big, points, surface_normal_eps,
                                     with_slots=with_slots, grid=grid)
    elif backend == "torch":
        out = _query_impl(tables.smalls, tables.big, points, surface_normal_eps)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return out if with_slots else out[:2]
