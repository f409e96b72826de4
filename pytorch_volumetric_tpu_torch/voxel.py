"""Voxel grids with value-space indexing.

A :class:`GridView` maps points to nearest-voxel indices by the affine
``idx = round((x - lo) / res)`` per dimension, with a raveled gather and an
out-of-range fallback (a scalar, or a callable evaluated on the points).
:class:`VoxelGrid` is a dense grid with an ``invalid_val = 0`` sentinel,
:class:`ExpandingVoxelGrid` one that grows to cover its writes and
:class:`VoxelSet` a sparse list of (position, value) pairs.
"""

from __future__ import annotations

import abc
from typing import Callable, Union

import numpy as np
import torch

from pytorch_volumetric_tpu_torch.utils.batching import (
    as_float_tensor, float_keys, resolve_device)


def get_divisible_range_by_resolution(resolution: float, range_per_dim):
    """Snap each (lo, hi) so the span is an integer multiple of resolution."""
    out = []
    for low, high in np.asarray(range_per_dim):
        span = round(float(high - low) / resolution)
        out.append((float(low), float(low) + span * resolution))
    return out


def get_coordinates_and_points_in_grid(resolution: float, range_per_dim,
                                       dtype=torch.float32, device=None,
                                       get_points: bool = True):
    """Per-dim coordinates (inclusive upper bound) and the cartesian-product
    point list ``[N, d]``.  Coordinates come from ``np.arange`` in float32,
    the same values the JAX package builds."""
    dev = resolve_device(device)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    coords = [torch.as_tensor(np.arange(low, high + 0.9 * resolution, resolution,
                                        dtype=np_dtype), device=dev)
              for low, high in np.asarray(range_per_dim)]
    pts = None
    if get_points:
        grid = torch.meshgrid(*coords, indexing="ij")
        pts = torch.stack(grid, dim=-1).reshape(-1, len(coords))
    return coords, pts


def get_coherent_grid_points(resolution: float, range_per_dim,
                             dtype=torch.float32, device=None):
    """Grid point list arranged for the brick-gather path
    (``ComposedSDF.query_coherent``): the last dimension is padded to a
    multiple of 4 by repeating its final coordinate, so every consecutive
    quadruple of points is collinear with span ``3 * resolution``, which
    satisfies the coherence contract of ``sdf.compose_query_coherent``
    whenever the cached voxel resolution is at least ``2 * resolution``.

    Returns ``(pts [F, d] on device, take_idx [N] numpy)``; ``pts[take_idx]``
    is :func:`get_coordinates_and_points_in_grid`'s point order."""
    coords, _ = get_coordinates_and_points_in_grid(resolution, range_per_dim, dtype=dtype,
                                                   device=device, get_points=False)
    sizes = [len(c) for c in coords]
    nz = sizes[-1]
    nzp = -(-nz // 4) * 4
    coords[-1] = torch.cat([coords[-1], coords[-1][-1:].expand(nzp - nz)])
    pts = torch.stack(torch.meshgrid(*coords, indexing="ij"), dim=-1).reshape(-1, len(coords))
    lead = int(np.prod(sizes[:-1], dtype=np.int64))
    take_idx = (np.arange(lead, dtype=np.int64)[:, None] * nzp
                + np.arange(nz, dtype=np.int64)[None, :]).reshape(-1)
    return pts, take_idx


def get_coherent_tile_points(resolution: float, range_per_dim,
                             cache_resolution: float = None,
                             dtype=torch.float32, device=None):
    """Grid point list arranged in box TILES for the brick-gather path:
    every consecutive group of ``seg`` points is a tile of grid points that
    lands inside one stride-2-anchored 4x4x4 voxel brick under any rigid
    transform, so one brick row serves ``seg`` points.

    A tile with ``t_d - 1`` steps of ``resolution`` per dimension spans at
    most ``resolution * ||t - 1||_2`` along any rotated axis, and integer
    voxel keys spanning ``sigma`` fit the brick iff ``sigma < 2 *
    cache_resolution``.  The largest-volume tile with ``||t - 1||_2 < 2 *
    rho`` (``rho = cache_resolution / resolution``, default 2) is chosen:
    4-point lines in 1D, (4, 3) tiles for 2D slices and (3, 3, 3) for 3D
    sweeps at ``rho = 2``.  ``cache_resolution`` is the smallest voxel
    resolution among the cached children to be queried
    (``sdf.coherent_min_cache_resolution``).

    Returns ``(pts [F, d] on device, take_idx [N] numpy, seg)``;
    ``pts[take_idx]`` is :func:`get_coordinates_and_points_in_grid`'s point
    order (padded duplicates discarded)."""
    coords, _ = get_coordinates_and_points_in_grid(resolution, range_per_dim, dtype=dtype,
                                                   device=device, get_points=False)
    sizes = [len(c) for c in coords]
    rho = 2.0 if cache_resolution is None else float(cache_resolution) / float(resolution)
    tile = _tile_shape(sizes, rho)
    seg = int(np.prod(tile))
    padded = []
    for c, t in zip(coords, tile):
        n_pad = -(-len(c) // t) * t
        padded.append(torch.cat([c, c[-1:].expand(n_pad - len(c))]))
    P = [len(c) for c in padded]
    d = len(P)
    pts = torch.stack(torch.meshgrid(*padded, indexing="ij"), dim=-1)
    # [P1..Pd, d] -> [T1, t1, .., Td, td, d] -> tiles-major, within-tile-minor
    shape = []
    for Pd, td in zip(P, tile):
        shape += [Pd // td, td]
    perm = [2 * i for i in range(d)] + [2 * i + 1 for i in range(d)] + [2 * d]
    pts = pts.reshape(*shape, d).permute(*perm).reshape(-1, d)
    # original raster index -> position in the tiled order
    idxs = np.meshgrid(*[np.arange(s, dtype=np.int64) for s in sizes], indexing="ij")
    pos_tile = np.zeros((), dtype=np.int64)
    pos_within = np.zeros((), dtype=np.int64)
    for i_d, td, Pd in zip(idxs, tile, P):
        pos_tile = pos_tile * (Pd // td) + i_d // td
        pos_within = pos_within * td + i_d % td
    take_idx = (pos_tile * seg + pos_within).reshape(-1)
    return pts, take_idx, seg


def _tile_shape(sizes, rho):
    """Largest-volume integer tile with ``||t - 1||_2 < 2 * rho`` over the
    non-degenerate dims (ties broken toward less padding waste)."""
    from itertools import product
    active = [i for i, s in enumerate(sizes) if s > 1]
    limit = (2.0 * rho) ** 2 - 1e-9
    # the all-ones tile is always admissible (a single point spans nothing),
    # so degenerate ratios (rho ~ 0) give seg = 1
    best = ((1, 0.0), (1,) * len(active))
    for combo in product(range(1, 9), repeat=len(active)):
        if sum((t - 1) ** 2 for t in combo) >= limit:
            continue
        waste = 1.0
        for a, t in zip(active, combo):
            waste *= -(-sizes[a] // t) * t / sizes[a]
        key = (int(np.prod(combo)), -waste)
        if key > best[0]:
            best = (key, combo)
    tile = [1] * len(sizes)
    for a, t in zip(active, best[1]):
        tile[a] = t
    return tile


class GridView:
    """A dense tensor viewed through value-space coordinates."""

    def __init__(self, data: torch.Tensor, range_per_dim,
                 invalid_value: Union[float, Callable] = 0.0):
        self.raw_data = data
        rng = np.asarray(range_per_dim, dtype=np.float64)
        self.range_per_dim = rng
        self.shape = tuple(data.shape)
        d = len(self.shape)
        self.lo = rng[:, 0]
        # a degenerate dimension (single coordinate) gets res 1.0 instead of 0
        self.res = np.array([
            ((rng[i, 1] - rng[i, 0]) / max(self.shape[i] - 1, 1))
            or 1.0 for i in range(d)])
        self.invalid_value = invalid_value
        self._strides = np.array(
            [int(np.prod(self.shape[i + 1:], dtype=np.int64)) for i in range(d)])

    @property
    def device(self) -> torch.device:
        return self.raw_data.device

    def _n(self) -> torch.Tensor:
        return torch.tensor(self.shape, dtype=torch.int64, device=self.device)

    # -- key conversions ------------------------------------------------------
    def ensure_index_key(self, pts) -> torch.Tensor:
        pts = as_float_tensor(pts, self.device)
        lo = torch.as_tensor(self.lo, dtype=pts.dtype, device=pts.device)
        res = torch.as_tensor(self.res, dtype=pts.dtype, device=pts.device)
        # NaN -> 0, saturating at int32's range: the JAX package's keys
        return float_keys(torch.round((pts - lo) / res))

    def ensure_value_key(self, indices) -> torch.Tensor:
        idx = torch.as_tensor(indices, device=self.device)
        lo = torch.as_tensor(self.lo, dtype=torch.float32, device=self.device)
        res = torch.as_tensor(self.res, dtype=torch.float32, device=self.device)
        return lo + idx.to(torch.float32) * res

    def ravel_multi_index(self, keys: torch.Tensor, shape=None) -> torch.Tensor:
        """Flat indices of integer keys ``[..., 3]`` over this grid's
        strides (``shape`` is accepted for the reference's signature and
        unused: the grid's own shape sets the strides)."""
        strides = torch.as_tensor(self._strides, dtype=torch.int64, device=keys.device)
        return (keys * strides).sum(dim=-1)

    def get_valid_values(self, pts) -> torch.Tensor:
        """In-range mask by nearest-index membership."""
        keys = self.ensure_index_key(pts)
        return ((keys >= 0) & (keys < self._n())).all(dim=-1)

    # -- access ---------------------------------------------------------------
    def __getitem__(self, pts) -> torch.Tensor:
        pts = as_float_tensor(pts, self.device)
        keys = self.ensure_index_key(pts)
        n = self._n()
        valid = ((keys >= 0) & (keys < n)).all(dim=-1)
        flat = self.ravel_multi_index(torch.minimum(keys.clamp(min=0), n - 1))
        vals = self.raw_data.reshape(-1)[flat]
        if callable(self.invalid_value):
            fallback = torch.as_tensor(self.invalid_value(pts)).reshape(
                vals.shape).to(vals.dtype)
        else:
            fallback = torch.full_like(vals, self.invalid_value)
        return torch.where(valid, vals, fallback)

    def __setitem__(self, pts, value) -> None:
        pts = as_float_tensor(pts, self.device)
        keys = self.ensure_index_key(pts)
        valid = ((keys >= 0) & (keys < self._n())).all(dim=-1)
        value = torch.as_tensor(value, dtype=self.raw_data.dtype,
                                device=self.device).expand(keys.shape[:-1])
        flat = self.ravel_multi_index(keys[valid])
        data = self.raw_data.reshape(-1).clone()
        data[flat] = value[valid]
        self.raw_data = data.reshape(self.shape)


class Voxels(abc.ABC):
    @abc.abstractmethod
    def get_known_pos_and_values(self):
        """Return the position (N x d) and values (N) of known voxels."""

    @abc.abstractmethod
    def __getitem__(self, pts):
        """Return the values (N) at the positions (N x d)."""

    @abc.abstractmethod
    def __setitem__(self, pts, value):
        """Set the values (N) at the positions (N x d)."""


class VoxelGrid(Voxels):
    """Dense grid with an ``invalid_val = 0`` "unknown" sentinel."""

    def __init__(self, resolution: float, range_per_dim, dtype=torch.float32,
                 device=None):
        self.resolution = float(resolution)
        self.invalid_val = 0
        self.dtype = dtype
        self.device = resolve_device(device)
        self._create_voxels(self.resolution, range_per_dim)

    def _create_voxels(self, resolution, range_per_dim):
        self.range_per_dim = get_divisible_range_by_resolution(resolution, range_per_dim)
        self.coords, self.pts = get_coordinates_and_points_in_grid(
            resolution, self.range_per_dim, device=self.device)
        shape = [len(c) for c in self.coords]
        self.voxels = GridView(torch.zeros(shape, dtype=self.dtype, device=self.device),
                               self.range_per_dim, invalid_value=self.invalid_val)
        self.range_per_dim = np.array(self.range_per_dim)

    def get_known_pos_and_values(self):
        data = self.voxels.raw_data
        known = data != self.invalid_val
        indices = torch.nonzero(known)
        return self.voxels.ensure_value_key(indices), data[known]

    def resize_to_fit(self):
        """Shrink the range to the known voxels plus one voxel of margin,
        keeping their values."""
        known_pos, known_val = self.get_known_pos_and_values()
        if known_pos.numel() == 0:
            return
        mins = known_pos.amin(dim=0).cpu().numpy()
        maxs = known_pos.amax(dim=0).cpu().numpy()
        rng = [(mins[i] - self.resolution, maxs[i] + self.resolution)
               for i in range(len(mins))]
        self._create_voxels(self.resolution, rng)
        self[known_pos] = known_val

    def get_voxel_values(self) -> torch.Tensor:
        return self.voxels.raw_data

    def get_voxel_center_points(self) -> torch.Tensor:
        return self.pts

    def __getitem__(self, pts):
        return self.voxels[pts]

    def __setitem__(self, pts, value):
        self.voxels[pts] = value


class ExpandingVoxelGrid(VoxelGrid):
    """Grows its range in whole-resolution steps to cover writes, keeping
    the known values (the regrow runs on the host)."""

    def __setitem__(self, pts, value):
        pts = as_float_tensor(pts, self.device)
        if pts.numel() > 0:
            flat = pts.reshape(-1, pts.shape[-1]).cpu().numpy()
            cur = np.asarray(self.range_per_dim, dtype=np.float64)
            # grow each bound outward in whole-resolution steps until every
            # written point fits (no overshoot keeps the bound in place)
            overshoot = np.maximum(
                np.stack([cur[:, 0] - flat.min(axis=0),
                          flat.max(axis=0) - cur[:, 1]], axis=1), 0.0)
            steps = np.ceil(overshoot / self.resolution)
            grown = cur + steps * self.resolution * np.array([-1.0, 1.0])
            if not np.allclose(grown, cur):
                keep_pos, keep_vals = self.get_known_pos_and_values()
                self._create_voxels(self.resolution, grown)
                super().__setitem__(keep_pos, keep_vals)
        return super().__setitem__(pts, value)


class VoxelSet(Voxels):
    """Sparse append-only (positions, values) store.  A tensor stays on its
    device; anything else goes to ``device`` (CUDA unless given)."""

    def __init__(self, positions, values, device=None):
        self.positions = as_float_tensor(positions, device)
        self.values = torch.as_tensor(values, device=self.positions.device)

    def __getitem__(self, pts):
        raise RuntimeError("Cannot get arbitrary points on a voxel set")

    def __setitem__(self, pts, value):
        pts = as_float_tensor(pts, self.positions.device).reshape(-1, self.positions.shape[-1])
        self.positions = torch.cat((self.positions, pts), dim=0)
        value = torch.as_tensor(value, dtype=self.values.dtype, device=self.positions.device)
        self.values = torch.cat((self.values, torch.atleast_1d(value)))

    def get_known_pos_and_values(self):
        return self.positions, self.values


def bounds_contain_another_bounds(outer_bounds, inner_bounds) -> bool:
    outer_bounds = np.asarray(outer_bounds)
    inner_bounds = np.asarray(inner_bounds)
    return bool(np.all(outer_bounds[:, 0] <= inner_bounds[:, 0])
                and np.all(outer_bounds[:, 1] >= inner_bounds[:, 1]))


def voxel_down_sample(points, resolution: float, range_per_dim=None,
                      ignore_flat_dim: bool = False, device=None) -> torch.Tensor:
    """Down-sample a point cloud ``[N, d]`` to the centers of its occupied
    voxels by one scatter into an occupancy grid.  The output's size
    depends on the data, so the grid's range is settled on the host.
    ``ignore_flat_dim``: a flat last dimension (min == max) is dropped for
    the scatter and its constant coordinate put back afterwards."""
    points = as_float_tensor(points, device)
    if points.shape[0] == 0:
        return points
    pts_np = points.cpu().numpy()
    padded = np.stack((pts_np.min(axis=0) - 2 * resolution,
                       pts_np.max(axis=0) + 2 * resolution)).T
    if range_per_dim is None or bounds_contain_another_bounds(range_per_dim, padded):
        range_per_dim = padded
    bounds = np.asarray(range_per_dim, dtype=np.float64)

    squeeze_last = ignore_flat_dim and bounds[-1, 0] == bounds[-1, 1]
    if squeeze_last:
        const_last = bounds[-1, 0]
        bounds, points = bounds[:-1], points[..., :-1]

    occupancy = VoxelGrid(resolution, bounds, dtype=torch.bool, device=points.device)
    occupancy[points] = True
    centers, _ = occupancy.get_known_pos_and_values()

    if squeeze_last:
        tail = torch.full((centers.shape[0], 1), const_last, dtype=centers.dtype,
                          device=centers.device)
        centers = torch.cat((centers, tail), dim=-1)
    return centers
