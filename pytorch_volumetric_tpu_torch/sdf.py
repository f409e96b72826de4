"""Object-frame signed distance fields (the central abstraction).

The ``ObjectFrameSDF`` protocol maps ``pts [.., N, 3]`` to ``(val [.., N],
grad [.., N, 3])``, with concrete primitive, ``MeshSDF``,
``NarrowBandMeshSDF``, ``ComposedSDF`` and ``CachedSDF`` implementations.

- Mesh queries run the brute-force closest-point + winding sweep
  (``ops.point_triangle``; the CUDA kernel on the card); the inside/outside
  sign comes from the generalized winding number.
- Every SDF exposes ``raw_query(pts [P, 3])``; ``__call__`` adds input
  coercion and batch flattening.
- Mesh and cached values are differentiable w.r.t. the query points (and
  so w.r.t. poses and joint angles by the chain rule) through registered
  straight-through ops (``ops.straight_through``) whose derivative is the
  analytic SDF gradient; they keep it through ``torch.export``.
- Disk caches are ``.npz`` files in the JAX package's format.
"""

from __future__ import annotations

import abc
import enum
import logging
import math
import os
from functools import partial
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pytorch_volumetric_tpu_torch import mesh as mesh_mod
from pytorch_volumetric_tpu_torch import transforms as tfm
from pytorch_volumetric_tpu_torch.ops.point_triangle import signed_closest_query
from pytorch_volumetric_tpu_torch.ops.straight_through import (
    straight_through, tile_winner_straight_through, winner_straight_through)
from pytorch_volumetric_tpu_torch.utils.batching import (
    as_float_tensor, float_keys, resolve_device)
from pytorch_volumetric_tpu_torch.utils.cache import get_store
from pytorch_volumetric_tpu_torch.voxel import (
    GridView, VoxelGrid, get_coherent_tile_points, get_coordinates_and_points_in_grid,
    get_divisible_range_by_resolution,
)

logger = logging.getLogger(__name__)


class SDFQuery(NamedTuple):
    closest: torch.Tensor
    distance: torch.Tensor
    gradient: torch.Tensor
    normal: Union[torch.Tensor, None]


# ---------------------------------------------------------------------------
# Object factories (mesh loading and framing)
# ---------------------------------------------------------------------------

class ObjectFactory(abc.ABC):
    """Loads and frames a triangle mesh and answers closest-point queries
    through a :class:`mesh.MeshScene` of padded triangle tensors."""

    def __init__(self, name="", scale=1.0, vis_frame_pos=(0, 0, 0),
                 vis_frame_rot=(0, 0, 0, 1), plausible_suboptimality=0.001,
                 mesh: Optional[mesh_mod.TriangleMesh] = None,
                 surface_normal_eps: float = 1e-3,
                 winding_threshold: float = 0.5,
                 weld_tolerance: Optional[float] = None, device=None, **kwargs):
        self.name = name
        self.scale = scale if scale is not None else 1.0
        # frame from the mesh's own frame to the object frame
        self.vis_frame_pos = vis_frame_pos
        self.vis_frame_rot = vis_frame_rot
        self.other_load_kwargs = kwargs
        self.plausible_suboptimality = plausible_suboptimality
        self.surface_normal_eps = surface_normal_eps
        # inside <=> |generalized winding number| > winding_threshold; robust
        # at 0.5 for watertight meshes
        self.winding_threshold = winding_threshold
        # merge vertices within this distance at load (file units)
        self.weld_tolerance = weld_tolerance
        self.device = resolve_device(device)

        if mesh is not None and weld_tolerance is not None:
            mesh = mesh_mod.weld_vertices(mesh, weld_tolerance)
        self._mesh = mesh
        self._mesh_was_given = mesh is not None
        self._scene: Optional[mesh_mod.MeshScene] = None
        self.precompute_sdf()

    def _reduce_kwargs(self):
        kw = dict(scale=self.scale, vis_frame_pos=self.vis_frame_pos,
                  vis_frame_rot=self.vis_frame_rot,
                  plausible_suboptimality=self.plausible_suboptimality,
                  surface_normal_eps=self.surface_normal_eps,
                  winding_threshold=self.winding_threshold,
                  weld_tolerance=self.weld_tolerance, device=self.device,
                  **self.other_load_kwargs)
        if self._mesh_was_given:
            # an in-memory mesh has no file to reload from: it travels along
            # (host numpy)
            kw["mesh"] = self._mesh
        return kw

    def __reduce__(self):
        """Pickled as its constructor call (file or in-memory mesh, and
        keyword arguments, ``device`` included), never with its device
        tensors, so that a spawned process can rebuild it."""
        return partial(self.__class__, **self._reduce_kwargs()), (self.name,)

    def make_collision_obj(self, z, rgba=None):
        return None, None

    @abc.abstractmethod
    def get_mesh_resource_filename(self) -> str:
        """Path to the mesh resource file (.obj, .stl, ...)."""

    def get_mesh_high_poly_resource_filename(self) -> str:
        return self.get_mesh_resource_filename()

    def draw_mesh(self, dd, name, pose, rgba, object_id=None):
        """Draw the mesh through a drawer ``dd`` with the reference's
        ``draw_mesh(name, path, pose, scale=, rgba=, object_id=,
        vis_frame_pos=, vis_frame_rot=)`` interface."""
        frame_pos = np.array(self.vis_frame_pos) * self.scale
        return dd.draw_mesh(name, self.get_mesh_resource_filename(), pose,
                            scale=self.scale, rgba=rgba, object_id=object_id,
                            vis_frame_pos=frame_pos, vis_frame_rot=self.vis_frame_rot)

    def precompute_sdf(self):
        """Load and frame the mesh (scale, vis-frame rotation about the
        origin, translation by the scaled vis-frame position) and pack the
        triangle tensors."""
        if self._mesh is None:
            full_path = os.path.expanduser(self.get_mesh_high_poly_resource_filename())
            if not os.path.exists(full_path):
                raise RuntimeError(f"Expected mesh file does not exist: {full_path}")
            m = mesh_mod.read_triangle_mesh(full_path,
                                            weld_tolerance=self.weld_tolerance)
            m = m.scale(self.scale)
            R = tfm.quaternion_xyzw_to_matrix(torch.as_tensor(
                np.asarray(self.vis_frame_rot, dtype=np.float32))).numpy()
            m = m.rotate(R, center=[0, 0, 0])
            m = m.translate(np.asarray(self.vis_frame_pos) * self.scale)
            self._mesh = m
        if self._scene is None:
            self._scene = mesh_mod.MeshScene.from_mesh(self._mesh, device=self.device)

    def bounding_box(self, padding=0.0, padding_ratio=0.0) -> np.ndarray:
        """[3, 2] AABB of the framed mesh with padding."""
        return pad_aabb(self._mesh.aabb(), padding, padding_ratio)

    def center(self) -> np.ndarray:
        return self._mesh.center()

    @property
    def scene(self) -> mesh_mod.MeshScene:
        return self._scene

    def object_frame_closest_point(self, points_in_object_frame,
                                   compute_normal=False) -> SDFQuery:
        """Batched closest point / signed distance / SDF gradient / normal.
        Input ``[.., N, 3]``; leading dims are preserved on all outputs."""
        pts = as_float_tensor(points_in_object_frame, self.device)
        flat = pts.reshape(-1, pts.shape[-1]).contiguous()
        closest, dist, grad, normal = signed_closest_query(
            flat, self._scene.tri, self._scene.normals,
            surface_normal_eps=self.surface_normal_eps,
            winding_threshold=self.winding_threshold,
            exterior_box=self._scene.exterior_box)
        batch = pts.shape[:-1]
        return SDFQuery(closest.reshape(batch + (3,)), dist.reshape(batch),
                        grad.reshape(batch + (3,)),
                        normal.reshape(batch + (3,)) if compute_normal else None)


class MeshObjectFactory(ObjectFactory):
    """Mesh from a file path with optional prefix joining and ``package://``
    stripping."""

    def __init__(self, mesh_name="", path_prefix="", **kwargs):
        self.path_prefix = path_prefix
        self.strip_package_prefix = path_prefix != ""
        super().__init__(mesh_name, **kwargs)

    def __reduce__(self):
        return partial(self.__class__, path_prefix=self.path_prefix,
                       **self._reduce_kwargs()), (self.name,)

    def get_mesh_resource_filename(self) -> str:
        mesh_path = self.name
        if self.strip_package_prefix:
            mesh_path = mesh_path.replace("package://", "")
        return os.path.join(self.path_prefix, mesh_path)


def pad_aabb(aabb, padding=0.0, padding_ratio=0.0) -> np.ndarray:
    """[3, 2] AABB expanded by ``padding`` (absolute) plus ``padding_ratio``
    of each extent."""
    bb = np.array(aabb, dtype=np.float64, copy=True)
    extents = bb[:, 1] - bb[:, 0]
    bb[:, 0] -= padding + padding_ratio * extents
    bb[:, 1] += padding + padding_ratio * extents
    return bb


def aabb_corners(aabb: torch.Tensor) -> torch.Tensor:
    """[3, 2] AABB -> its 8 corner points [8, 3]."""
    lo, hi = aabb[:, 0], aabb[:, 1]
    sel = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)],
                       dtype=aabb.dtype, device=aabb.device)
    return lo + sel * (hi - lo)


# ---------------------------------------------------------------------------
# SDF protocol
# ---------------------------------------------------------------------------

class ObjectFrameSDF(abc.ABC):
    """SDF protocol: ``pts [.., N, d] -> (val [.., N], grad [.., N, d])``.
    Subclasses implement :meth:`raw_query` on flat points and set
    ``self.device``."""

    device: torch.device

    @abc.abstractmethod
    def raw_query(self, points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat points ``[P, d]`` -> ``(val [P], grad [P, d])``."""

    @abc.abstractmethod
    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0) -> torch.Tensor:
        """(min, max) per dimension of the 0-level set, ``[3, 2]``."""

    def raw_query_aux(self):
        """Big per-instance tables that callers pass back explicitly through
        :meth:`raw_query_with` (``None``: nothing to pass)."""
        return None

    def raw_query_with(self, aux, points):
        """``raw_query`` with :meth:`raw_query_aux`'s tables passed back in."""
        return self.raw_query(points)

    def __call__(self, points_in_object_frame):
        pts = as_float_tensor(points_in_object_frame, self.device)
        batch = pts.shape[:-1]
        flat = pts.reshape(-1, pts.shape[-1])
        val, grad = self.raw_query(flat)
        return val.reshape(batch), grad.reshape(batch + pts.shape[-1:])

    def outside_surface(self, points_in_object_frame, surface_level=0):
        sdf_values, _ = self(points_in_object_frame)
        return sdf_values > surface_level

    def get_voxel_view(self, voxels: Optional[VoxelGrid] = None, dtype=torch.float32,
                       device=None) -> GridView:
        """This SDF rasterized onto ``voxels`` (by default a 0.01 grid over
        the surface box padded by 0.1); points outside the grid evaluate the
        SDF itself."""
        if voxels is None:
            bb = self.surface_bounding_box(padding=0.1).cpu().numpy()
            voxels = VoxelGrid(0.01, bb, dtype=dtype, device=self.device)
        sdf_val, _ = self(voxels.get_voxel_center_points())
        shape = [len(c) for c in voxels.coords]
        return GridView(sdf_val.reshape(shape), voxels.range_per_dim,
                        invalid_value=lambda p: self(p)[0])

    def get_filtered_points(self, unary_filter, voxels: Optional[VoxelGrid] = None,
                            dtype=torch.float32, device=None) -> torch.Tensor:
        """Voxel-center points whose SDF value passes ``unary_filter``."""
        view = self.get_voxel_view(voxels, dtype=dtype)
        return view.ensure_value_key(torch.nonzero(unary_filter(view.raw_data)))


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


class SphereSDF(ObjectFrameSDF):
    """Analytic sphere at the origin."""

    def __init__(self, radius: float, device=None):
        self.radius = radius
        self.device = resolve_device(device)

    def raw_query(self, points):
        dist_to_origin = _norm(points)
        dist = dist_to_origin - self.radius
        grad = points / (dist_to_origin[..., None] + 1e-12)
        return dist, grad

    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0):
        length = self.radius + padding + padding_ratio * self.radius
        return torch.tensor([[-length, length]] * 3, device=self.device)


class BoxSDF(ObjectFrameSDF):
    """Analytic axis-aligned box centered at the origin (``size`` = full
    extents)."""

    def __init__(self, size, device=None):
        self.device = resolve_device(device)
        self.size = as_float_tensor(size, self.device)

    def raw_query(self, points):
        half = self.size / 2.0
        q = points.abs() - half
        q_out = q.clamp(min=0.0)
        d_out = _norm(q_out)
        q_in = q.max(dim=-1).values
        d_in = q_in.clamp(max=0.0)
        dist = d_out + d_in
        # outside: normalized residual; inside: axis of the closest face
        sign = torch.sign(points)
        sign = torch.where(sign == 0, 1.0, sign)
        grad_out = sign * q_out / d_out.clamp(min=1e-12)[..., None]
        inside_axis = q.argmax(dim=-1)
        grad_in = sign * torch.nn.functional.one_hot(inside_axis, 3).to(points.dtype)
        grad = torch.where((d_out > 0)[..., None], grad_out, grad_in)
        return dist, grad

    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0):
        half = self.size.cpu().numpy().astype(np.float64) / 2.0
        pad = padding + padding_ratio * 2 * half
        return torch.tensor(np.stack([-half - pad, half + pad], axis=1),
                            dtype=torch.float32, device=self.device)


class CylinderSDF(ObjectFrameSDF):
    """Analytic capped cylinder along z, centered at the origin."""

    def __init__(self, radius: float, height: float, device=None):
        self.radius = radius
        self.height = height
        self.device = resolve_device(device)

    def raw_query(self, points):
        r = _norm(points[..., :2])
        dr = r - self.radius
        dz = points[..., 2].abs() - self.height / 2.0
        out_r = dr.clamp(min=0.0)
        out_z = dz.clamp(min=0.0)
        d_out = torch.sqrt(out_r ** 2 + out_z ** 2)
        d_in = torch.maximum(dr, dz).clamp(max=0.0)
        dist = d_out + d_in
        radial = points[..., :2] / r.clamp(min=1e-12)[..., None]
        zsign = torch.sign(points[..., 2])
        zsign = torch.where(zsign == 0, 1.0, zsign)
        gr = out_r / d_out.clamp(min=1e-12)
        gz = out_z / d_out.clamp(min=1e-12) * zsign
        grad_out = torch.cat([radial * gr[..., None], gz[..., None]], dim=-1)
        grad_in_radial = torch.cat([radial, torch.zeros_like(points[..., :1])], dim=-1)
        grad_in_axial = torch.cat([torch.zeros_like(points[..., :2]), zsign[..., None]],
                                  dim=-1)
        grad_in = torch.where((dr > dz)[..., None], grad_in_radial, grad_in_axial)
        grad = torch.where((d_out > 0)[..., None], grad_out, grad_in)
        return dist, grad

    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0):
        r = self.radius + padding + padding_ratio * 2 * self.radius
        h = self.height / 2.0 + padding + padding_ratio * self.height
        return torch.tensor([[-r, r], [-r, r], [-h, h]], device=self.device)


class CapsuleSDF(ObjectFrameSDF):
    """Analytic capsule along z (cylinder of ``height`` with hemispherical
    caps), centered at the origin."""

    def __init__(self, radius: float, height: float, device=None):
        self.radius = radius
        self.height = height
        self.device = resolve_device(device)

    def raw_query(self, points):
        half = self.height / 2.0
        z = points[..., 2].clamp(-half, half)
        axis_pt = torch.cat([torch.zeros_like(points[..., :2]), z[..., None]], dim=-1)
        diff = points - axis_pt
        d_axis = _norm(diff)
        dist = d_axis - self.radius
        grad = diff / d_axis.clamp(min=1e-12)[..., None]
        # on-axis points: the gradient defaults to +x
        x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=points.dtype, device=points.device)
        grad = torch.where((d_axis < 1e-12)[..., None], x_axis, grad)
        return dist, grad

    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0):
        r = self.radius + padding + padding_ratio * 2 * self.radius
        h = (self.height / 2.0 + self.radius + padding
             + padding_ratio * (self.height + 2 * self.radius))
        return torch.tensor([[-r, r], [-r, r], [-h, h]], device=self.device)


def _no_derivative(t):
    """A table detached where a derivative could reach it (the tables get
    none); otherwise the caller's own tensor object."""
    return t.detach() if isinstance(t, torch.Tensor) and t.requires_grad else t


def _straight_through(raw_fn: Callable, pts: torch.Tensor, *tables):
    """``raw_fn(*tables, pts) -> (val, grad)`` on the detached points, then
    the value's derivative w.r.t. ``pts`` attached as the analytic gradient
    itself (:func:`ops.straight_through.straight_through`).  The gradient
    output carries no derivative of its own, and the tables get none."""
    val, grad = raw_fn(*map(_no_derivative, tables), pts.detach())
    if torch.is_grad_enabled():
        val = straight_through(val, grad, pts)
    return val, grad


def _straight_through_sdf(raw_fn: Callable) -> Callable:
    """Wrap ``raw_fn(*tables, pts) -> (val, grad)`` so that pose and joint
    gradients flow through transforms and FK by the chain rule (second
    derivatives of the gradient output are treated as zero)."""

    def query(*args):
        *tables, pts = args
        return _straight_through(raw_fn, pts, *tables)

    return query


class MeshSDF(ObjectFrameSDF):
    """Exact SDF from the triangle sweep.  ``backend="torch"`` forces the
    plain sweep on the card too (the kernel's reference)."""

    def __init__(self, obj_factory: ObjectFactory, vis=None, backend: str = "auto"):
        self.obj_factory = obj_factory
        self.vis = vis
        self.device = obj_factory.device
        scene = obj_factory.scene
        eps = obj_factory.surface_normal_eps
        thr = obj_factory.winding_threshold
        box = scene.exterior_box  # None for an open mesh: the winding is summed in full

        def raw(tri, normals, pts):
            _, val, grad, _ = signed_closest_query(pts.contiguous(), tri, normals,
                                                   surface_normal_eps=eps,
                                                   winding_threshold=thr,
                                                   backend=backend, exterior_box=box)
            return val, grad

        self._tables = (scene.tri, scene.normals)
        self._raw = _straight_through_sdf(raw)

    def raw_query(self, points):
        return self._raw(*self._tables, points)

    def raw_query_aux(self):
        return self._tables

    def raw_query_with(self, aux, points):
        return self._raw(*aux, points)

    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0):
        return torch.as_tensor(self.obj_factory.bounding_box(padding, padding_ratio),
                               dtype=torch.float32, device=self.device)


class NarrowBandMeshSDF(ObjectFrameSDF):
    """Large-mesh SDF: exact within ``band`` of the surface through per-cell
    candidate lists, a first-order-corrected voxel far field beyond it
    (``ops.narrow_band``; the kernel ``csrc/narrow_band.cu`` on the card).

    A query costs one cell lookup and ``K`` candidate evaluations instead of
    the sweep's ``F``.  Signs come from angle-weighted pseudonormals, exact
    for watertight manifold meshes (use :class:`MeshSDF`'s winding numbers
    for triangle soups).  The build runs the native host runtime.

    :param cell_res: cell size; defaults to the mesh box's diagonal / 96.
    :param band: half-width of the exact shell; defaults to ``4 * cell_res``.
    :param padding: grid margin beyond the mesh box; queries outside the
        grid take the distance to the surface's box (an under-approximation).
    :param max_k: cells with this many candidates or more take the far field.
    :param tables: given :class:`ops.narrow_band.NarrowBandTables` instead of
        a build (``state.narrow_band_sdf_from_numpy``).
    :param backend: "torch" forces the plain query on the card too (the
        kernel's reference).
    """

    def __init__(self, obj_factory: ObjectFactory, cell_res: Optional[float] = None,
                 band: Optional[float] = None, padding: float = 0.1, max_k: int = 256,
                 cache_path: Optional[str] = None, tables=None, backend: str = "auto"):
        from pytorch_volumetric_tpu_torch.ops import narrow_band as nb

        self.obj_factory = obj_factory
        self.device = obj_factory.device
        m = obj_factory._mesh
        if cell_res is None:
            aabb = m.aabb()
            cell_res = float(np.linalg.norm(aabb[:, 1] - aabb[:, 0])) / 96.0
        if band is None:
            band = 4.0 * cell_res
        self.cell_res = cell_res
        self.band = band
        self.backend = backend
        if tables is None:
            tables = nb.build_narrow_band_tables(m, cell_res, band, padding=padding,
                                                 max_k=max_k, cache_path=cache_path,
                                                 device=self.device)
        self.tables = tables
        eps = obj_factory.surface_normal_eps
        # the small grid fields are fixed here, as numbers (the JAX package's
        # trace-time constants); the big tables are passed on every call, so
        # a union can thread them (raw_query_aux / raw_query_with)
        from pytorch_volumetric_tpu_torch.ops.narrow_band_cuda import grid_lists
        grid = grid_lists(tables.smalls)

        def raw(meta, cand, pseudo, pts):
            return nb.narrow_band_query(tables._replace(meta=meta, cand=cand, pseudo=pseudo),
                                        pts.contiguous(), eps, backend, grid=grid)

        self._raw = _straight_through_sdf(raw)

    def raw_query(self, points):
        return self._raw(*self.tables.big, points)

    def raw_query_aux(self):
        return self.tables.big

    def raw_query_with(self, aux, points):
        return self._raw(*aux, points)

    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0):
        return torch.as_tensor(self.obj_factory.bounding_box(padding, padding_ratio),
                               dtype=torch.float32, device=self.device)


# ---------------------------------------------------------------------------
# Composition (min-union over posed children)
# ---------------------------------------------------------------------------

def compose_query(child_raw_queries: Tuple[Callable, ...],
                  obj_to_link: torch.Tensor, link_to_obj: torch.Tensor,
                  batch: int, points: torch.Tensor):
    """Min-union query over ``S`` posed child SDFs.

    ``obj_to_link``/``link_to_obj``: ``[S*B, 4, 4]`` link-major flattened
    transforms (child ``i`` owns rows ``[i*B, (i+1)*B)``).  ``points``:
    ``[F, d]`` in the shared object frame, every point taken under every
    configuration, or ``[B, F, d]``, row ``b`` taken under configuration
    ``b`` alone.  Returns ``(val [B, F], grad [B, F, d])``; ties keep the
    earlier child (strict ``<``).
    """
    S = len(child_raw_queries)
    F = points.shape[-2]
    pts_all = tfm.transform_points(obj_to_link.reshape(S, batch, 4, 4), points)
    R_back = link_to_obj.reshape(S, batch, 4, 4)[..., :3, :3]

    best_v = None
    best_g = None
    for i, raw in enumerate(child_raw_queries):
        v, g = raw(pts_all[i].reshape(batch * F, 3))
        v = v.reshape(batch, F)
        g = g.reshape(batch, F, 3)
        # rotate gradients back into the object frame (rigid: R == inv-transpose)
        g = tfm.rotate_vectors(R_back[i], g)
        if best_v is None:
            best_v, best_g = v, g
        else:
            better = v < best_v
            best_v = torch.where(better, v, best_v)
            best_g = torch.where(better[..., None], g, best_g)
    return best_v, best_g


# ---------------------------------------------------------------------------
# Coherent (brick-gather) union query
# ---------------------------------------------------------------------------
#
# When consecutive groups of ``seg`` query points are spatially coherent (a
# tile of a regular grid sweep, see voxel.get_coherent_tile_points), each
# group's integer voxel keys land inside one 4x4x4 voxel BRICK anchored at
# an even key, ``2 * floor(min_key / 2)``, for every cached child under any
# rigid transform.  The lookup then reads one brick row per (child, tile)
# and takes each point's cell from it.  Bricks overlap at stride 2 per
# dimension (8x the value grid in memory), so that any tile whose keys span
# at most 2 voxels per dimension fits the brick at its anchor.  Results are
# bit-identical to compose_query's: every point computes the same keys
# (_voxel_keys), reads the same cell value and goes through the same
# arithmetic.  Tensors keep the tile layout ``[B, FS, seg]``: ``FS`` tiles of
# ``seg`` consecutive points, a view of the flat ``[B, F]``.

COHERENT_SEG = 4
# the per-tile union's residual lane: its capacity as a fraction of all
# (configuration, tile) pairs (compose_query_coherent's default)
RESIDUAL_FRAC = 0.04


class _CoherentTables(NamedTuple):
    lo: torch.Tensor        # [3] grid origin
    inv_res: torch.Tensor   # [3] float32 reciprocal of the voxel size (_voxel_keys)
    n: torch.Tensor         # [3] int64 grid dims
    strides: torch.Tensor   # [3] int64 ravel strides of the value grid
    vg: torch.Tensor        # [G, 4] packed (value, grad) rows
    bstrides: torch.Tensor  # [3] int64 ravel strides of the brick-anchor grid
    bb: torch.Tensor        # [3, 2] surface AABB of the out-of-bounds fallback
    # [NB, 64] overlapping 4x4x4 VALUE bricks
    bricks: Optional[torch.Tensor] = None
    # [NB, 4, 64] (value, gx, gy, gz) 4x4x4 bricks, channel-major: built only
    # for a union with one cached child (no winner to find)
    bricks4: Optional[torch.Tensor] = None
    # [NB, 4, 125] (value, gx, gy, gz) 5x5x5 bricks of the single trilinear child
    bricks5: Optional[torch.Tensor] = None
    # [NB, 3, 64] gradient-only 4x4x4 bricks of the multi-child union's winners
    gbricks: Optional[torch.Tensor] = None
    # [NB, 125] value and [NB, 3, 125] gradient 5x5x5 bricks of the
    # multi-child trilinear union
    tbricks: Optional[torch.Tensor] = None
    tgbricks: Optional[torch.Tensor] = None


def _is_coherent_fast_child(s) -> bool:
    """True iff the nearest brick path serves this union child."""
    return (isinstance(s, CachedSDF)
            and s.out_of_bounds_strategy == OutOfBoundsStrategy.BOUNDING_BOX
            and s.interpolation == "nearest")


def _is_coherent_trilinear_child(s) -> bool:
    """True iff ``s`` is a trilinear BOUNDING_BOX ``CachedSDF``."""
    return (isinstance(s, CachedSDF)
            and s.out_of_bounds_strategy == OutOfBoundsStrategy.BOUNDING_BOX
            and s.interpolation == "trilinear")


def _coherent_single_trilinear_child(children):
    """The lone child iff the composition is one trilinear BOUNDING_BOX
    ``CachedSDF`` (the 5x5x5 single-child path), else ``None``."""
    if len(children) == 1 and _is_coherent_trilinear_child(children[0]):
        return children[0]
    return None


def _coherent_classify(children) -> tuple:
    """``(fast_idx, tri_idx, generic_idx)``: which children take which path
    in :func:`compose_query_coherent`.

    - ``fast_idx``: nearest BOUNDING_BOX caches (the 4x4x4 brick union);
    - ``tri_idx``: trilinear BOUNDING_BOX caches, when there are at least
      two of them and no nearest fast child (the trilinear union);
    - ``generic_idx``: everything else (per-point ``raw_query``).

    A composition whose only child is a trilinear cache is routed before
    this classification (:func:`_coherent_single_trilinear_child`)."""
    fast = [i for i, s in enumerate(children) if _is_coherent_fast_child(s)]
    tri = [i for i, s in enumerate(children) if _is_coherent_trilinear_child(s)]
    if fast or len(tri) < 2:
        tri = []
    generic = [i for i in range(len(children)) if i not in fast and i not in tri]
    return fast, tri, generic


def coherent_fast_tables(children: Sequence[ObjectFrameSDF]):
    """The ``_CoherentTables`` of the children that take a brick path, in
    child order, for :func:`compose_query_coherent`'s ``fast_tables``.
    One nearest fast child carries ``bricks4``; a multi-child union carries
    ``gbricks`` and never ``bricks4`` (stripped if an earlier single-child
    composition built it); the single trilinear child carries ``bricks5``;
    the trilinear union ``tbricks`` and ``tgbricks``."""
    tri = _coherent_single_trilinear_child(children)
    if tri is not None:
        return (tri._coherent_tables(with_tri_bricks=True, with_value_bricks=False),)
    fast_idx, tri_idx, _ = _coherent_classify(children)
    if tri_idx:
        return tuple(children[i]._coherent_tables(
            with_value_bricks=False, with_tri_value_bricks=True,
            with_tri_gradonly_bricks=True) for i in tri_idx)
    single = len(fast_idx) == 1
    tables = tuple(children[i]._coherent_tables(with_grad_bricks=single,
                                                with_gradonly_bricks=not single)
                   for i in fast_idx)
    if single:
        return tuple(t._replace(gbricks=None) for t in tables)
    return tuple(t._replace(bricks4=None) for t in tables)


def coherent_min_cache_resolution(children) -> Optional[float]:
    """Smallest voxel resolution among the children that take a brick path
    (``None`` when none does): the ``cache_resolution`` that decides a safe
    tile in :func:`voxel.get_coherent_tile_points`."""
    tri = _coherent_single_trilinear_child(children)
    if tri is not None:
        return float(tri.resolution)
    fast_idx, tri_idx, _ = _coherent_classify(children)
    vals = [float(children[i].resolution) for i in fast_idx + tri_idx]
    return min(vals) if vals else None


def coherent_generic_aux(children: Sequence[ObjectFrameSDF]):
    """``raw_query_aux`` of the children that take the generic per-point
    sub-path of :func:`compose_query_coherent`, in that order."""
    if _coherent_single_trilinear_child(children) is not None:
        return ()
    _, _, generic = _coherent_classify(children)
    return tuple(children[i].raw_query_aux() for i in generic)


def _coherent_row_bases(tables: Sequence[torch.Tensor]) -> np.ndarray:
    """Row offset of each child's table in the children's concatenation
    (child order, trailing total)."""
    return np.cumsum([0] + [int(t.shape[0]) for t in tables])


def _cells(table: torch.Tensor, row: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Each point's cell of its tile's brick row, read straight from the
    table (no one-hot, no row copy).  ``table [NR, W]`` or channel-major
    ``[NR, CH, W]``; ``row [B, FS]`` the brick row of each tile; ``cell [B,
    FS, seg]`` each point's cell in ``[0, W)``.  Returns ``[B, FS, seg]``,
    or ``[CH, B, FS, seg]`` for a channel-major table."""
    base = row[..., None] * table[0].numel() + cell
    if table.dim() == 2:
        return torch.take(table, base)
    W = table.shape[-1]
    ch = torch.arange(table.shape[1], device=base.device) * W
    return torch.take(table, base + ch.view(-1, 1, 1, 1))


def _brick_anchor(keys: torch.Tensor, bstrides: torch.Tensor):
    """``(row [.., FS], off [.., FS, seg, 3])``: the brick row of each tile,
    anchored at ``2 * floor(min_key / 2)`` per dimension over the tile's
    keys ``[.., FS, seg, 3]``, and each key's offset from the anchor,
    clamped to 3: in range under the coherence contract, and inside the
    brick row for a tile that breaks it."""
    corner2 = keys.amin(dim=-2) // 2
    off = (keys - 2 * corner2[..., None, :]).clamp(max=3)
    return (corner2 * bstrides).sum(dim=-1), off


def _stacked(tables: Sequence[_CoherentTables], name: str, lead: int) -> torch.Tensor:
    """Field ``name`` of every child stacked, shaped ``[C, 1 x lead, ..]``
    to broadcast over the children's tile layout."""
    x = torch.stack([getattr(t, name) for t in tables])
    return x.view((len(tables),) + (1,) * lead + x.shape[1:])


def _vg_offsets(tables: Sequence[_CoherentTables]) -> torch.Tensor:
    """``[C, 1, 1, 1]`` row offset of each child's packed (value, grad)
    rows in their concatenation, computed on the device."""
    n = _stacked(tables, "n", 0).prod(dim=-1)
    return (n.cumsum(0) - n).view(-1, 1, 1, 1)


def _first_min(v: torch.Tensor):
    """Each point's winner over the children's values ``v [C, B, FS,
    seg]``: the first child of least value, as ``compose_query``'s strict
    ``<`` in child order.  Returns ``(win, pick)``, with ``pick(x)`` each
    point's winner entry of a per-child ``[C, B, FS, seg(, k)]`` tensor."""
    win = torch.argmin(v, dim=0)

    def pick(x):
        idx = win.view((1,) + win.shape + (1,) * (x.dim() - 4))
        return x.gather(0, idx.expand((1,) + x.shape[1:]))[0]

    return win, pick


def _nearest_keys(tables: Sequence[_CoherentTables], pts_c: torch.Tensor):
    """:func:`_nearest_union`'s first step: ``(valid, kc)``, every child's
    in-grid mask and clamped voxel keys on the tile layout."""
    return _voxel_keys(pts_c, _stacked(tables, "lo", 3), _stacked(tables, "inv_res", 3),
                       _stacked(tables, "n", 3))


def _nearest_anchor(tables: Sequence[_CoherentTables], kc: torch.Tensor):
    """:func:`_nearest_union`'s second step: ``(row, cell, flat)`` of the
    keys ``kc``: each tile's brick row, each point's cell in it and its
    row of the children's concatenated (value, grad) rows."""
    row, off = _brick_anchor(kc, _stacked(tables, "bstrides", 2))
    cell = off[..., 0] * 16 + off[..., 1] * 4 + off[..., 2]
    flat = (kc * _stacked(tables, "strides", 3)).sum(dim=-1) + _vg_offsets(tables)
    return row, cell, flat


def _nearest_cells(tables: Sequence[_CoherentTables], row, cell) -> torch.Tensor:
    """:func:`_nearest_union`'s third step: every child's value-brick cell
    ``[C, B, FS, seg]``."""
    return torch.stack([_cells(t.bricks, r, c) for t, r, c in zip(tables, row, cell)])


def _nearest_select(tables: Sequence[_CoherentTables], pts_c, valid, v_in):
    """:func:`_nearest_union`'s last step: ``(v, g_oob)``, the cell value
    ``v_in`` in the grid, the AABB distance outside, and the AABB
    fallback's gradient."""
    v_oob, g_oob = _aabb_distance_grad(_stacked(tables, "bb", 3), pts_c)
    return torch.where(valid, v_in, v_oob), g_oob


def _nearest_union(tables: Sequence[_CoherentTables], pts_c: torch.Tensor):
    """Every nearest child at once on the tile layout ``pts_c [C, B, FS,
    seg, 3]``: ``(v, valid, flat, row, cell, g_oob)``, each with the
    children leading: the value (the brick cell in the grid, the AABB
    distance outside), the in-grid mask, the row of the children's
    concatenated (value, grad) rows, each tile's brick row, each point's
    cell in it, and the AABB fallback's gradient.  Its four steps are
    separate functions, so that ``bench/roofline_arm.py`` times them one
    by one."""
    valid, kc = _nearest_keys(tables, pts_c)
    row, cell, flat = _nearest_anchor(tables, kc)
    del kc
    v, g_oob = _nearest_select(tables, pts_c, valid, _nearest_cells(tables, row, cell))
    return v, valid, flat, row, cell, g_oob


def _trilinear_anchor(tables: Sequence[_CoherentTables], pts_c: torch.Tensor):
    """Every trilinear child at once on the tile layout ``pts_c [C, B, FS,
    seg, 3]``: ``(valid, flat0, w, row, base5, v_oob, g_oob)`` with the
    children leading: the in-grid mask, the lower corner's row of the
    children's concatenated (value, grad) rows, the weights, each tile's
    5x5x5 brick row, each point's lower-corner cell in it (its 8 corners
    are ``base5 + delta``, ``delta`` in :data:`_DELTA5`) and the AABB
    fallback."""
    valid, i0, w = _trilinear_cell(pts_c, _stacked(tables, "lo", 3),
                                   _stacked(tables, "inv_res", 3), _stacked(tables, "n", 3))
    # the tile contract bounds the clipped lower corners' span by 2, so
    # every corner stays inside the 5-window at the anchor
    row, off = _brick_anchor(i0, _stacked(tables, "bstrides", 2))
    base5 = off[..., 0] * 25 + off[..., 1] * 5 + off[..., 2]
    flat0 = (i0 * _stacked(tables, "strides", 3)).sum(dim=-1) + _vg_offsets(tables)
    v_oob, g_oob = _aabb_distance_grad(_stacked(tables, "bb", 3), pts_c)
    return valid, flat0, w, row, base5, v_oob, g_oob


def _lerp5(table: torch.Tensor, row, base5, w) -> torch.Tensor:
    """Trilinear interpolation from 5x5x5 brick rows, in ``gather_trilinear``'s
    corner and weight order: ``[B, FS, seg]`` or ``[CH, B, FS, seg]``."""
    acc = None
    for offs, delta in zip(_CORNERS, _DELTA5):
        term = _corner_weight(w, offs) * _cells(table, row, base5 + delta)
        acc = torch.zeros_like(term) + term if acc is None else acc + term
    return acc


def _coherent_union_values(tables: Sequence[_CoherentTables], pts_c: torch.Tensor):
    """Values only of the nearest brick union: ``pts_c [C, B, FS, seg, 3]
    -> val [B, FS, seg]`` (no winner, no gradient; callers detach)."""
    return _nearest_union(tables, pts_c)[0].amin(dim=0)


def _winner_rows_eval(tables, pts_c):
    v, valid, flat, _, _, g_oob = _nearest_union(tables, pts_c)
    win, pick = _first_min(v)
    g = torch.cat([t.vg for t in tables])[pick(flat)][..., 1:4]
    return pick(v), torch.where(pick(valid)[..., None], g, pick(g_oob)), win


def _coherent_union_lookup(tables: Sequence[_CoherentTables], pts_c: torch.Tensor):
    """Nearest brick union with per-point winner rows: ``pts_c [C, B, FS,
    seg, 3] -> (val [B, FS, seg], g_link [B, FS, seg, 3], win [B, FS,
    seg])``.  Values come from the value bricks; the winner's gradient, in
    its own link frame, from its packed (value, grad) row; ``win`` indexes
    ``tables``.  Used when the tables carry no gradient bricks.  The
    straight-through derivative: d val / d pts_c[ci] = (win == ci) * the
    winner's link-frame gradient."""
    val, g_link, win = _winner_rows_eval(tuple(tables), pts_c.detach())
    if torch.is_grad_enabled():
        val = winner_straight_through(val, g_link, win, pts_c)
    return val, g_link, win


def _tile_candidate_ids(best_i, best_valid, C: int):
    """The per-tile winner candidates: the first and the last distinct
    in-bounds winner of each tile, then the smallest one not yet covered.
    Returns ``(candidates, middle)``: ``(ceff [B, FS], mask [B, FS, seg])``
    per candidate (``ceff`` is ``-1`` or ``C`` where a tile has no such
    candidate, and ``mask`` marks the points it wins), and the residual
    lane's middle tiles ``[B, FS]``: those where an in-bounds point's winner
    is none of the three (4 or more distinct winners; None for ``C <= 3``,
    where three candidates cover every winner)."""
    eff_min = torch.where(best_valid, best_i, C).amin(dim=2)
    ids = [eff_min]
    if C >= 2:
        eff_max = torch.where(best_valid, best_i, -1).amax(dim=2)
        ids.append(torch.where(eff_max > eff_min, eff_max, -1))
    candidates, covered = [], torch.zeros_like(best_valid)
    for ceff in ids + [None] * (C >= 3):
        if ceff is None:
            eff_mid = torch.where(best_valid & ~covered, best_i, C).amin(dim=2)
            ceff = torch.where(eff_mid < C, eff_mid, -1)
        mask = best_i == ceff[:, :, None]
        candidates.append((ceff, mask))
        covered = covered | mask
    return candidates, ((best_valid & ~covered).any(dim=2) if C > 3 else None)


def _tile_candidates(candidates, evaluate):
    """Each point's result from the candidate of :func:`_tile_candidate_ids`
    that is its winner: ``evaluate(ceff [B, FS]) -> [B, FS, seg, 3]`` is
    candidate ``ceff``'s result at every point."""
    selected = None
    for ceff, mask in candidates:
        g_k = evaluate(ceff)
        selected = g_k if selected is None else torch.where(mask[..., None], g_k, selected)
    return selected


def residual_capacity(n_tiles: int, residual_frac: float = RESIDUAL_FRAC) -> int:
    """The residual lane's capacity over ``n_tiles`` (configuration, tile)
    pairs: ``residual_frac`` of them, at least 32 (for ``residual_frac >=
    1e-6``) and at most all."""
    return min(n_tiles, max(int(math.ceil(n_tiles * residual_frac)),
                            min(32, n_tiles) if residual_frac >= 1e-6 else 1))


def _residual_tiles(middle: torch.Tensor, residual_frac: float):
    """The residual lane's tiles, without a host sync: ``(idx [cap],
    overflow [B, FS])``.  ``idx`` holds the flat indices ``b * FS + f`` of
    the first ``cap`` middle tiles in order, then ``B * FS`` for unused
    slots; ``overflow`` marks the middle tiles beyond ``cap``
    (:func:`residual_capacity`)."""
    B, FS = middle.shape
    T = B * FS
    cap = residual_capacity(T, residual_frac)
    mflat = middle.reshape(-1)
    mint = mflat.to(torch.int64)
    rank = torch.cumsum(mint, 0) - mint
    slot = torch.where(mflat & (rank < cap), rank, cap)  # slot cap: dropped
    idx = torch.full((cap + 1,), T, dtype=torch.int64, device=middle.device).scatter_(
        0, slot, torch.arange(T, device=middle.device))[:cap]
    return idx, middle & (rank.reshape(B, FS) >= cap)


def coherent_middle_tiles(children: Sequence[ObjectFrameSDF], obj_to_link: torch.Tensor,
                          batch: int, points: torch.Tensor, fast_tables=None,
                          seg: int = COHERENT_SEG) -> Optional[torch.Tensor]:
    """``[B, FS]`` bool: the residual lane's middle tiles of
    :func:`compose_query_coherent`'s per-tile union (:func:`_tile_candidate_ids`),
    or ``None`` when no per-tile union with more than 3 children runs.
    Arguments as :func:`compose_query_coherent`'s; computed without
    gradients."""
    if _coherent_single_trilinear_child(children) is not None:
        return None
    fast, tri_u, _ = _coherent_classify(children)
    idx = tri_u or fast
    if len(idx) <= 3:
        return None
    tables = fast_tables if fast_tables is not None else coherent_fast_tables(children)
    if not tri_u and any(t.gbricks is None for t in tables):
        return None  # the per-point winner rows: no tile candidates
    S, F = len(children), points.shape[0]
    with torch.no_grad():
        pts_all = tfm.transform_points(obj_to_link, points).reshape(S, batch, F // seg, seg, 3)
        pts_c = torch.stack([pts_all[i] for i in idx])
        if tri_u:
            v, (valid, *_) = _trilinear_union_values(tables, pts_c)
        else:
            v, valid = _nearest_union(tables, pts_c)[:2]
        win, pick = _first_min(v)
        return _tile_candidate_ids(win, pick(valid), len(idx))[1]


def _scatter_residual(res: torch.Tensor, idx: torch.Tensor, B: int, FS: int):
    """``res [cap, seg, 3]`` of the residual tiles ``idx`` back onto ``[B,
    FS, seg, 3]`` (zeros elsewhere; unused slots land on a dropped row)."""
    T = B * FS
    out = res.new_zeros((T + 1,) + res.shape[1:]).index_copy_(0, idx, res)
    return out[:T].reshape((B, FS) + res.shape[1:])


def _finish_tile_union(best_v, best_i, best_valid, g_cand, g_oob, middle, residual,
                       residual_frac, Rb):
    """The per-tile unions' last step, on link-frame gradients: the
    candidates' ``g_cand`` where a candidate is the point's winner, the
    residual lane's winner rows (``residual(tb, tf) -> [cap, seg, 3]`` for
    residual tiles ``(tb, tf)``) in the ``middle`` tiles of
    :func:`_tile_candidate_ids` (None when three candidates cover every
    winner), NaN in middle tiles beyond the lane's capacity, the AABB
    fallback ``g_oob`` out of bounds, then rotated with each point's
    winner's rotation.  Returns ``(val, g_obj, win, g_link)``."""
    B, FS = best_v.shape[:2]
    if middle is not None:
        idx, overflow = _residual_tiles(middle, residual_frac)
        tile = idx.clamp(max=B * FS - 1)
        res = _scatter_residual(residual(tile // FS, tile % FS), idx, B, FS)
        g_cand = torch.where(middle[:, :, None, None], res, g_cand)
        # beyond the lane's capacity: NaN, never a wrong gradient
        g_cand = torch.where(overflow[:, :, None, None], float("nan"), g_cand)
    g_link = torch.where(best_valid[..., None], g_cand, g_oob)
    return best_v, _rotate_winners(Rb, best_i, g_link), best_i, g_link


def _rotate_winners(Rb: torch.Tensor, win: torch.Tensor, g_link: torch.Tensor):
    """``g_link [B, FS, seg, 3]`` rotated into the object frame, each point
    with its winner's rotation ``Rb[win]`` (``Rb [C, B, 3, 3]``), in
    ``rotate_vectors``' term order: the arithmetic of the generic path."""
    R = Rb[win, torch.arange(win.shape[0], device=Rb.device).view(-1, 1, 1)]
    return tfm.rotate_vectors(R, g_link[..., None, :])[..., 0, :]


def _union_tile_eval(tables, residual_frac, pts_c, Rb):
    """Forward of :func:`_coherent_union_lookup_tile`, plus the winner's
    link-frame gradient for the backward."""
    C = len(tables)
    v, valid, flat, row, cell, g_oob = _nearest_union(tables, pts_c)
    win, pick = _first_min(v)
    best_valid, best_cell = pick(valid), pick(cell)
    bases = _coherent_row_bases([t.gbricks for t in tables])
    rows = torch.stack([r + int(base) for r, base in zip(row, bases)])  # [C, B, FS]
    g_cat = torch.cat([t.gbricks for t in tables])

    def candidate(ceff):
        # each point's cell of candidate ceff's gradient brick at its tile
        row = rows.gather(0, ceff.clamp(0, C - 1)[None])[0]
        return _cells(g_cat, row, best_cell).permute(1, 2, 3, 0)

    def residual(tb, tf):
        # each point's winner row of the packed (value, grad) tables
        return torch.cat([t.vg for t in tables])[pick(flat)[tb, tf]][..., 1:4]

    candidates, middle = _tile_candidate_ids(win, best_valid, C)
    return _finish_tile_union(pick(v), win, best_valid, _tile_candidates(candidates, candidate),
                              pick(g_oob), middle, residual, residual_frac, Rb)


def _tile_winner_lookup(pts_c: torch.Tensor, Rb: torch.Tensor, evaluate):
    """``evaluate(pts_c, Rb) -> (val, g_obj, win, g_link)`` of a per-tile
    winner union on the detached inputs, then its straight-through
    derivatives attached (:func:`ops.straight_through.tile_winner_straight_through`):
    d val / d pts_c[ci] = (win == ci) * the winner's link-frame gradient,
    and the gradient output's w.r.t. ``Rb``.  Returns ``(val, g_obj,
    win)``."""
    val, g_obj, win, g_link = evaluate(pts_c.detach(), Rb.detach())
    if torch.is_grad_enabled():
        val, g_obj = tile_winner_straight_through(val, g_obj, win, g_link, pts_c, Rb)
    return val, g_obj, win


def _coherent_union_lookup_tile(tables: Sequence[_CoherentTables], pts_c: torch.Tensor,
                                Rb: torch.Tensor, residual_frac: float = RESIDUAL_FRAC):
    """Nearest brick union with per-TILE winner gradients: ``pts_c [C, B,
    FS, seg, 3]``, ``Rb [C, B, 3, 3]`` (link -> object rotations) -> ``(val
    [B, FS, seg], g_obj [B, FS, seg, 3], win [B, FS, seg])`` with ``g_obj``
    in the OBJECT frame.

    Values come from the value bricks.  Gradients: three candidate children
    per tile (its first and last distinct in-bounds winners, then the
    smallest remaining one) give each point covered by one its cell of that
    child's gradient brick.  Tiles with >= 4 distinct winners ("middle"
    tiles) take a residual lane of per-point winner rows; its capacity is
    ``residual_frac`` of all tiles, and middle tiles beyond it get NaN
    gradients (values unaffected).  Each point's gradient is then rotated
    with its winner's rotation (:func:`_finish_tile_union`)."""
    return _tile_winner_lookup(pts_c, Rb, partial(_union_tile_eval, tuple(tables),
                                                  residual_frac))


def _trilinear_union_values(tables: Sequence[_CoherentTables], pts_c: torch.Tensor):
    """Every trilinear union child's value ``[C, B, FS, seg]`` (the lerp of
    its 5x5x5 value brick in the grid, the AABB distance outside) and
    :func:`_trilinear_anchor`'s tuple."""
    anchor = _trilinear_anchor(tables, pts_c)
    valid, _, w, row, base5, v_oob, _ = anchor
    return torch.where(valid, torch.stack([_lerp5(t.tbricks, r, b, ww) for t, r, b, ww in
                                           zip(tables, row, base5, w)]), v_oob), anchor


def _union_tile_tri_eval(tables, residual_frac, pts_c, Rb=None):
    """Forward of :func:`_coherent_union_lookup_tile_tri` (values only
    without ``Rb``)."""
    C = len(tables)
    v, (valid, flat0, w, row, base5, _, g_oob) = _trilinear_union_values(tables, pts_c)
    if Rb is None:
        return v.amin(dim=0)
    win, pick = _first_min(v)
    best_valid, best_base5, best_w = pick(valid), pick(base5), pick(w)
    bases = _coherent_row_bases([t.tgbricks for t in tables])
    rows = torch.stack([r + int(base) for r, base in zip(row, bases)])  # [C, B, FS]
    tg_cat = torch.cat([t.tgbricks for t in tables])

    def candidate(ceff):
        # the point's lerp of candidate ceff's gradient brick at its tile;
        # the rotation comes after the lerp, as in the generic path (it does
        # not distribute over the lerp's sum bit for bit)
        row = rows.gather(0, ceff.clamp(0, C - 1)[None])[0]
        return _lerp5(tg_cat, row, best_base5, best_w).permute(1, 2, 3, 0)

    def residual(tb, tf):
        # the exact 8-corner lerp of each point's winner rows
        res_flat0, res_w = pick(flat0)[tb, tf], best_w[tb, tf]   # [cap, seg(, 3)]
        strides = _stacked(tables, "strides", 0)[win[tb, tf]]
        vg_cat = torch.cat([t.vg for t in tables])
        acc = torch.zeros(res_w.shape, dtype=res_w.dtype, device=res_w.device)
        for offs in _CORNERS:
            doff = offs[0] * strides[..., 0] + offs[1] * strides[..., 1] + offs[2] * strides[..., 2]
            acc = acc + _corner_weight(res_w, offs)[..., None] * vg_cat[res_flat0 + doff][..., 1:4]
        return acc

    candidates, middle = _tile_candidate_ids(win, best_valid, C)
    return _finish_tile_union(pick(v), win, best_valid, _tile_candidates(candidates, candidate),
                              pick(g_oob), middle, residual, residual_frac, Rb)


def _coherent_union_lookup_tile_tri(tables: Sequence[_CoherentTables], pts_c: torch.Tensor,
                                    Rb: Optional[torch.Tensor] = None,
                                    residual_frac: float = RESIDUAL_FRAC):
    """Multi-child TRILINEAR union on the per-tile winner design of
    :func:`_coherent_union_lookup_tile`: values lerp the 8 corners of each
    point's cell from one 5x5x5 value brick per (child, tile), in
    ``gather_trilinear``'s corner order; each point covered by a tile
    candidate lerps its winner's gradient brick in the link frame, then
    rotates it with the winner's rotation; middle tiles take a
    residual lane of exact 8-corner winner rows, NaN beyond its capacity.
    Without ``Rb``: just ``val [B, FS, seg]`` (no gradient; callers
    detach)."""
    evaluate = partial(_union_tile_tri_eval, tuple(tables), residual_frac)
    if Rb is None:
        return evaluate(pts_c)
    return _tile_winner_lookup(pts_c, Rb, evaluate)


def _single_brick_lookup(bricks4, p, t):
    valid, kc = _voxel_keys(p, t.lo, t.inv_res, t.n)
    row, off = _brick_anchor(kc, t.bstrides)
    ch = _cells(bricks4, row, off[..., 0] * 16 + off[..., 1] * 4 + off[..., 2])
    v_oob, g_oob = _aabb_distance_grad(t.bb, p)
    return (torch.where(valid, ch[0], v_oob),
            torch.where(valid[..., None], ch[1:4].permute(1, 2, 3, 0), g_oob))


def _coherent_single_lookup(t: _CoherentTables, p: torch.Tensor):
    """One nearest cached child: ``(val [B, FS, seg], g_link [B, FS, seg,
    3])`` in its link frame, both from one (value, gradient) brick row
    ``bricks4`` per tile, with the straight-through derivative w.r.t. the
    points ``p [B, FS, seg, 3]``."""
    return _straight_through(partial(_single_brick_lookup, t=t), p, t.bricks4)


def _single_trilinear_lookup(bricks5, p, t, values_only=False):
    valid, _, w, row, base5, v_oob, g_oob = (x[0] for x in _trilinear_anchor([t], p[None]))
    if values_only:  # the value channel only
        return torch.where(valid, _lerp5(bricks5[:, :1], row, base5, w)[0], v_oob)
    acc = _lerp5(bricks5, row, base5, w)
    return (torch.where(valid, acc[0], v_oob),
            torch.where(valid[..., None], acc[1:4].permute(1, 2, 3, 0), g_oob))


def _coherent_single_trilinear_lookup(t: _CoherentTables, p: torch.Tensor,
                                      values_only: bool = False):
    """One trilinear cached child: one 5x5x5 (value, gradient) brick row
    ``bricks5`` per tile replaces the 8 corner rows per point.  The tile
    contract bounds each tile's clipped lower-corner keys to a span of 2,
    so the 8 corners of every point fit the 5-window at the anchor.  The
    lerp follows ``gather_trilinear``'s corner and weight order (bit for
    bit).  Returns ``(val, g_link)`` with the straight-through derivative,
    or ``val`` alone with ``values_only`` (callers detach)."""
    if values_only:
        return _single_trilinear_lookup(t.bricks5, p, t, values_only=True)
    return _straight_through(partial(_single_trilinear_lookup, t=t), p, t.bricks5)


def compose_query_coherent(children: Sequence[ObjectFrameSDF],
                           obj_to_link: torch.Tensor, link_to_obj: torch.Tensor,
                           batch: int, points: torch.Tensor,
                           fast_tables=None, values_only: bool = False,
                           generic_aux=None, seg: int = COHERENT_SEG,
                           residual_frac: float = RESIDUAL_FRAC):
    """Min-union query like :func:`compose_query`, with the brick-gather
    path for ``CachedSDF`` children; results are bit-identical to it.

    Contract: ``points [F, 3]`` with ``F % seg == 0``, and every group of
    ``seg`` consecutive points has its integer voxel keys inside one
    stride-2-anchored 4x4x4 brick of every cached child (rigid transforms
    keep this for the layouts of :func:`voxel.get_coherent_grid_points`
    and :func:`voxel.get_coherent_tile_points`).

    Nearest BOUNDING_BOX caches take the brick union: one child reads
    (value, gradient) bricks (:func:`_coherent_single_lookup`), several take
    the per-tile winner union (:func:`_coherent_union_lookup_tile`), or per-
    point winner rows when ``fast_tables`` carry no gradient bricks
    (:func:`_coherent_union_lookup`).  A lone trilinear BOUNDING_BOX cache
    takes the 5x5x5 path, two or more with no nearest one the trilinear
    union.  Other children (primitives, meshes, other caches) take the
    generic per-point sub-path, merged last with ties broken on the
    original child index, as in ``compose_query``.

    ``fast_tables``: :func:`coherent_fast_tables` of the children (built
    when omitted); ``generic_aux``: :func:`coherent_generic_aux`.
    ``residual_frac``: capacity of the per-tile union's residual lane as a
    fraction of all (configuration, tile) pairs; middle tiles beyond it get
    NaN gradients.  ``values_only=True`` returns just ``val [B, F]``,
    detached.  Otherwise returns ``(val [B, F], grad [B, F, 3])``."""
    if values_only:
        with torch.no_grad():
            return _compose_coherent(children, obj_to_link, link_to_obj, batch, points,
                                     fast_tables, True, generic_aux, seg, residual_frac)
    return _compose_coherent(children, obj_to_link, link_to_obj, batch, points,
                             fast_tables, False, generic_aux, seg, residual_frac)


def _compose_coherent(children, obj_to_link, link_to_obj, batch, points, fast_tables,
                      values_only, generic_aux, seg, residual_frac):
    S = len(children)
    F = points.shape[0]
    if F % seg:
        raise ValueError(f"points count {F} must be a multiple of seg={seg}")
    FS = F // seg
    # tile layout [S, B, FS, seg, 3]: a view of compose_query's [S*B, F, 3]
    pts_all = tfm.transform_points(obj_to_link, points).reshape(S, batch, FS, seg, 3)
    R_back = link_to_obj.reshape(S, batch, 4, 4)[..., :3, :3]

    def out(v, g=None):
        v = v.reshape(batch, F)
        return v if values_only else (v, g.reshape(batch, F, 3))

    tri_child = _coherent_single_trilinear_child(children)
    if tri_child is not None:
        t = (fast_tables[0] if fast_tables is not None and len(fast_tables) == 1
             and fast_tables[0].bricks5 is not None
             else tri_child._coherent_tables(with_tri_bricks=True, with_value_bricks=False))
        if values_only:
            return out(_coherent_single_trilinear_lookup(t, pts_all[0], values_only=True))
        val, g_link = _coherent_single_trilinear_lookup(t, pts_all[0])
        return out(val, tfm.rotate_vectors(R_back[0][:, None], g_link))

    fast, tri_u, generic = _coherent_classify(children)
    if generic_aux is None:
        generic_aux = tuple(children[i].raw_query_aux() for i in generic)

    def generic_query(k, i):
        pts_flat = pts_all[i].reshape(batch * F, 3)
        if generic_aux[k] is None:
            return children[i].raw_query(pts_flat)
        return children[i].raw_query_with(generic_aux[k], pts_flat)

    def of(x, idx):
        # the children idx of a per-child tensor (every child: x itself)
        return x if len(idx) == S else torch.stack([x[i] for i in idx])

    def child_index(win, idx):
        # the winners' original child indices (no host-to-device copy)
        out = torch.zeros_like(win)
        for ci, i in enumerate(idx):
            out = torch.where(win == ci, i, out)
        return out

    def tables_for(idx, build):
        if fast_tables is None:
            return [build(children[i]) for i in idx]
        if len(fast_tables) != len(idx):
            raise ValueError(f"fast_tables holds {len(fast_tables)} table sets but "
                             f"{len(idx)} children take a brick path")
        return list(fast_tables)

    best_v = best_g = best_i = None
    if tri_u:
        tables = tables_for(tri_u, lambda s: s._coherent_tables(
            with_value_bricks=False, with_tri_value_bricks=True,
            with_tri_gradonly_bricks=True))
        if values_only:
            best_v = _coherent_union_lookup_tile_tri(tables, of(pts_all, tri_u))
        else:
            best_v, best_g, win = _coherent_union_lookup_tile_tri(
                tables, of(pts_all, tri_u), of(R_back, tri_u), residual_frac=residual_frac)
            best_i = child_index(win, tri_u)
    if fast:
        tables = tables_for(fast, lambda s: s._coherent_tables(
            with_grad_bricks=len(fast) == 1, with_gradonly_bricks=len(fast) > 1))
        pts_fast = of(pts_all, fast)
        if values_only:
            best_v = _coherent_union_values(tables, pts_fast)
        elif len(fast) == 1 and tables[0].bricks4 is not None:
            # one cached child: no union to win, value and gradient from one
            # brick row per tile
            best_v, g_link = _coherent_single_lookup(tables[0], pts_fast[0])
            best_g = tfm.rotate_vectors(R_back[fast[0]][:, None], g_link)
            best_i = torch.full(best_v.shape, fast[0], dtype=torch.int64,
                                device=best_v.device)
        elif all(t.gbricks is not None for t in tables):
            best_v, best_g, win = _coherent_union_lookup_tile(
                tables, pts_fast, of(R_back, fast), residual_frac=residual_frac)
            best_i = child_index(win, fast)
        else:
            best_v, g_link, win = _coherent_union_lookup(tables, pts_fast)
            best_g = _rotate_winners(of(R_back, fast), win, g_link)
            best_i = child_index(win, fast)
    for k, i in enumerate(generic):
        v, g = generic_query(k, i)
        v = v.reshape(batch, FS, seg)
        if values_only:
            best_v = v if best_v is None else torch.minimum(best_v, v)
            continue
        g = tfm.rotate_vectors(R_back[i][:, None], g.reshape(batch, FS, seg, 3))
        if best_v is None:
            best_v, best_g = v, g
            best_i = torch.full(v.shape, i, dtype=torch.int64, device=v.device)
        else:
            # ties go to the lower ORIGINAL child index, as in compose_query,
            # though the brick children were evaluated first
            better = (v < best_v) | ((v == best_v) & (i < best_i))
            best_v = torch.where(better, v, best_v)
            best_g = torch.where(better[..., None], g, best_g)
            best_i = torch.where(better, i, best_i)
    return out(best_v, best_g)


class ComposedSDF(ObjectFrameSDF):
    def __init__(self, sdfs: Sequence[ObjectFrameSDF],
                 obj_frame_to_each_frame: Optional[tfm.Transform3d] = None):
        """
        :param sdfs: S object-frame SDFs (on one device)
        :param obj_frame_to_each_frame: ``[B*]S x 4 x 4`` transforms from the
            shared object frame to each SDF's frame, flattened link-major.
        """
        self.sdfs = list(sdfs)
        self.device = self.sdfs[0].device
        self.obj_frame_to_link_frame: Optional[tfm.Transform3d] = None
        self.link_frame_to_obj_frame: Optional[torch.Tensor] = None
        self.tsf_batch = None
        self.set_transforms(obj_frame_to_each_frame)

    def set_transforms(self, tsf: Optional[tfm.Transform3d], batch_dim=None):
        self.obj_frame_to_link_frame = tsf
        self.tsf_batch = tuple(batch_dim) if batch_dim is not None else None
        if tsf is not None:
            S = len(self.sdfs)
            S_tsf = len(tsf)
            if self.tsf_batch is None and S_tsf != S:
                if S_tsf % S:
                    raise ValueError(f"{S_tsf} transforms for {S} SDFs")
                self.tsf_batch = (S_tsf // S,)
            self.link_frame_to_obj_frame = tfm.invert_tf(tsf.get_matrix())

    def ith_transform_slice(self, i):
        if self.tsf_batch is None:
            return slice(i, i + 1)
        total = math.prod(self.tsf_batch)
        return slice(i * total, (i + 1) * total)

    @property
    def _batch(self) -> int:
        return math.prod(self.tsf_batch) if self.tsf_batch is not None else 1

    def raw_query(self, points):
        return compose_query(tuple(s.raw_query for s in self.sdfs),
                             self.obj_frame_to_link_frame.get_matrix(),
                             self.link_frame_to_obj_frame, self._batch, points)

    def __call__(self, points_in_object_frame):
        pts = as_float_tensor(points_in_object_frame, self.device)
        pts_batch = pts.shape[:-1]
        flat = pts.reshape(-1, pts.shape[-1])
        queries = tuple(partial(s.raw_query_with, s.raw_query_aux()) for s in self.sdfs)
        vv, gg = compose_query(queries, self.obj_frame_to_link_frame.get_matrix(),
                               self.link_frame_to_obj_frame, self._batch, flat)
        if self.tsf_batch is not None:
            out_batch = self.tsf_batch + pts_batch
        else:
            out_batch = pts_batch
            vv, gg = vv[0], gg[0]
        return vv.reshape(out_batch), gg.reshape(out_batch + (pts.shape[-1],))

    def check_coherent_contract(self, points_in_object_frame,
                                seg: int = COHERENT_SEG) -> bool:
        """True iff every group of ``seg`` consecutive points lands inside
        its brick for every child that takes a brick path, under the current
        transforms: the precondition of :meth:`query_coherent`.  Computed
        on the host from the transformed points, without building bricks."""
        pts = as_float_tensor(points_in_object_frame, self.device)
        S, B, F = len(self.sdfs), self._batch, pts.shape[0]
        if F % seg:
            return False
        with torch.no_grad():
            pts_all = tfm.transform_points(self.obj_frame_to_link_frame.get_matrix(), pts)
        pts_all = pts_all.cpu().numpy().reshape(S, B, F, 3)
        tri = _coherent_single_trilinear_child(self.sdfs)
        fast_idx, tri_idx, _ = _coherent_classify(self.sdfs)
        for i, s in enumerate(self.sdfs):
            is_tri = s is tri or i in tri_idx
            if not (i in fast_idx or is_tri):
                continue
            lo = np.asarray(s.voxels.lo, dtype=np.float32)
            res = np.asarray(s.voxels.res, dtype=np.float32)
            n = np.asarray(s.voxels.shape)
            f = (pts_all[i] - lo) / res
            if is_tri:
                # the 8 corners of the clipped lower-corner cell must fit
                # the 5-window at the stride-2 anchor
                fc = np.clip(f, 0.0, (n - 1).astype(np.float32))
                ks = np.clip(np.floor(fc), 0, n - 2).astype(np.int64).reshape(
                    B, F // seg, seg, 3)
                if (ks.max(axis=2) + 1 - 2 * (ks.min(axis=2) // 2)).max() > 4:
                    return False
                continue
            ks = np.clip(np.round(f), 0, n - 1).astype(np.int64).reshape(B, F // seg, seg, 3)
            if (ks.max(axis=2) - 2 * (ks.min(axis=2) // 2)).max() > 3:
                return False
        return True

    def query_coherent(self, points_in_object_frame, debug_check=False,
                       values_only: bool = False, seg: int = COHERENT_SEG):
        """``__call__`` on coherent points ``[F, 3]`` (groups of ``seg``
        consecutive points inside one brick; see
        :func:`compose_query_coherent`), bit-identical to it.
        ``debug_check=True`` checks the contract on the host first and
        raises ``ValueError`` if it fails.  ``values_only=True`` returns the
        values alone, detached.  ``seg``: 4 for
        :func:`voxel.get_coherent_grid_points`, or the tile size that
        :func:`voxel.get_coherent_tile_points` returns."""
        pts = as_float_tensor(points_in_object_frame, self.device)
        if debug_check and not self.check_coherent_contract(pts, seg=seg):
            raise ValueError(
                f"points violate the coherence contract (a {seg}-point group "
                "spans more than its 4x4x4 voxel brick for some cached child); "
                "use get_coherent_grid_points / get_coherent_tile_points or "
                "the generic __call__ path")
        out = compose_query_coherent(
            tuple(self.sdfs), self.obj_frame_to_link_frame.get_matrix(),
            self.link_frame_to_obj_frame, self._batch, pts,
            fast_tables=coherent_fast_tables(self.sdfs), values_only=values_only,
            generic_aux=coherent_generic_aux(self.sdfs), seg=seg)
        F = pts.shape[0]
        lead = self.tsf_batch + (F,) if self.tsf_batch is not None else None
        if values_only:
            return out[0] if lead is None else out.reshape(lead)
        vv, gg = out
        if lead is None:
            return vv[0], gg[0]
        return vv.reshape(lead), gg.reshape(lead + (pts.shape[-1],))

    def get_voxel_view(self, voxels: Optional[VoxelGrid] = None, dtype=torch.float32,
                       device=None) -> GridView:
        """The union rasterized onto ``voxels``.  A voxel raster is the
        tile layout's shape, so with unbatched transforms and the contract
        holding it runs the brick path (values only)."""
        if voxels is None:
            bb = self.surface_bounding_box(padding=0.1).cpu().numpy()
            voxels = VoxelGrid(0.01, bb, dtype=dtype, device=self.device)
        if self.tsf_batch is not None:
            return super().get_voxel_view(voxels, dtype=dtype, device=device)
        shape = [len(c) for c in voxels.coords]
        min_res = coherent_min_cache_resolution(self.sdfs)
        vals = None
        if min_res is not None:
            pts_t, take, seg = get_coherent_tile_points(
                voxels.resolution, voxels.range_per_dim, cache_resolution=min_res,
                device=self.device)
            if self.check_coherent_contract(pts_t, seg=seg):
                vals = self.query_coherent(pts_t, seg=seg, values_only=True)[
                    torch.as_tensor(take, device=self.device)]
        if vals is None:
            vals, _ = self(voxels.get_voxel_center_points())
        return GridView(vals.reshape(shape), voxels.range_per_dim,
                        invalid_value=lambda p: self(p)[0])

    def surface_bounding_box(self, **kwargs):
        """Batched AABB of the union: every child's AABB corners moved into
        the object frame, then min/max over children and corners."""
        m_inv = self.link_frame_to_obj_frame  # [S*B, 4, 4]
        bounds = []
        for i, sdf in enumerate(self.sdfs):
            corners = aabb_corners(sdf.surface_bounding_box(**kwargs))
            bounds.append(tfm.transform_points(m_inv[self.ith_transform_slice(i)],
                                               corners))  # [B, 8, 3]
        bounds = torch.stack(bounds)  # [S, B, 8, 3]
        if self.tsf_batch is not None:
            mins = bounds.amin(dim=(0, 2))
            maxs = bounds.amax(dim=(0, 2))
            out = torch.stack((mins, maxs), dim=-1)  # [B, 3, 2]
            return out.reshape(self.tsf_batch + (3, 2))
        mins = bounds.amin(dim=(0, 1, 2))
        maxs = bounds.amax(dim=(0, 1, 2))
        return torch.stack((mins, maxs), dim=-1)


# ---------------------------------------------------------------------------
# Cached (voxelized) SDF
# ---------------------------------------------------------------------------

class OutOfBoundsStrategy(enum.Enum):
    LOOKUP_GT_SDF = 0
    BOUNDING_BOX = 1  # under-approximates the SDF value


DEFAULT_CACHE_PATH = "sdf_cache.npz"

GRID_SWEEP_CHUNK = 131072


def _aabb_distance_grad(bb: torch.Tensor, pts: torch.Tensor):
    """Distance-to-AABB under-approximation and its gradient, in the
    one-clamp form ``p - clip(p, lo, hi)``."""
    dtotal = pts - torch.clamp(pts, min=bb[..., 0], max=bb[..., 1])
    dist = _norm(dtotal)
    grad = dtotal / dist.clamp(min=1e-12)[..., None]
    return dist, grad


def _voxel_keys(pts: torch.Tensor, lo, inv_res, n):
    """Nearest voxel keys ``round((p - lo) * (1 / res))``, with the
    reciprocal rounded to float32: the arithmetic of the JAX package's
    compiled lookup, where XLA folds the division by a constant into this
    multiply.  Every nearest lookup (generic and brick path) computes its
    keys here, so borderline ``round``\\ s agree.  Returns the in-grid mask
    and the keys clamped into the grid.  NaN keys are 0 (:func:`float_keys`),
    as in the JAX package."""
    keys = float_keys(torch.round((pts - lo) * inv_res), n)
    valid = ((keys >= 0) & (keys < n)).all(dim=-1)
    return valid, torch.minimum(keys.clamp(min=0), n - 1)


def _trilinear_cell(pts: torch.Tensor, lo, inv_res, n):
    """Trilinear cell of every point: the in-grid mask of its nearest key
    (the nearest contract), the cell's lower corner ``i0`` clamped into the
    grid and the interpolation weights ``w`` in it."""
    f = (pts - lo) * inv_res
    keys = float_keys(torch.round(f), n)
    valid = ((keys >= 0) & (keys < n)).all(dim=-1)
    f = torch.minimum(f.clamp(min=0.0), (n - 1).to(pts.dtype))
    i0 = torch.minimum(float_keys(torch.floor(f), n).clamp(min=0), n - 2)
    return valid, i0, f - i0.to(pts.dtype)


# the 8 corners of a trilinear cell, bit d of the corner number = offset in dim d
_CORNERS = tuple(tuple((corner >> d) & 1 for d in range(3)) for corner in range(8))
# their offsets from the lower corner in a 5x5x5 brick row
_DELTA5 = tuple(o[0] * 25 + o[1] * 5 + o[2] for o in _CORNERS)


def _corner_weight(w: torch.Tensor, offs) -> torch.Tensor:
    """Trilinear weight of corner ``offs``: the product in order x, y, z."""
    wd = [w[..., d] if offs[d] else 1.0 - w[..., d] for d in range(3)]
    return wd[0] * wd[1] * wd[2]


def _grid_sweep(gt_sdf: ObjectFrameSDF, pts: torch.Tensor,
                chunk: int = GRID_SWEEP_CHUNK):
    """Evaluate ``gt_sdf`` over a large grid in chunks of ``chunk`` points
    (bounded device memory); returns host numpy ``(val [P], grad [P, d])``."""
    vals, grads = [], []
    with torch.no_grad():
        for s in range(0, pts.shape[0], chunk):
            v, g = gt_sdf.raw_query(pts[s:s + chunk])
            vals.append(v)
            grads.append(g)
    return (torch.cat(vals).cpu().numpy(),
            torch.cat(grads).reshape(-1, pts.shape[1]).cpu().numpy())


class CachedSDF(ObjectFrameSDF):
    """SDF by nearest-voxel (or trilinear) lookup of precomputed value and
    gradient grids.

    The grid build sweeps the ground-truth SDF over the snapped range and
    persists to an ``.npz`` store keyed ``"{name} {resolution} {range}"``.
    Out-of-bounds queries either recurse into the ground truth or use the
    distance-to-AABB under-approximation.  ``tables=(val, grad, surface_bb)``
    installs given grids instead of reading the store or building.
    """

    def __init__(self, object_name, resolution, range_per_dim,
                 gt_sdf: Optional[ObjectFrameSDF],
                 out_of_bounds_strategy=OutOfBoundsStrategy.BOUNDING_BOX,
                 device=None, clean_cache=False, debug_check_sdf=False,
                 cache_path: str = DEFAULT_CACHE_PATH,
                 interpolation: str = "nearest",
                 tables: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None):
        if device is None and gt_sdf is not None:
            device = gt_sdf.device
        self.device = resolve_device(device)
        self.gt_sdf = gt_sdf
        self.resolution = float(resolution)
        self.out_of_bounds_strategy = out_of_bounds_strategy
        self.debug_check_sdf = debug_check_sdf
        if interpolation not in ("nearest", "trilinear"):
            raise ValueError(f"unknown interpolation {interpolation!r}")
        self.interpolation = interpolation

        bb = np.asarray(range_per_dim, dtype=np.float64)
        num_voxel = (bb[:, 1] - bb[:, 0]) // resolution
        if num_voxel.min() < 10:
            logger.warning("Resolution %s is too high for %s, only getting %s voxels",
                           resolution, object_name, num_voxel)

        range_per_dim = get_divisible_range_by_resolution(resolution, range_per_dim)
        self.ranges = np.array(range_per_dim)
        self.object_name = object_name
        self.name = f"{object_name} {resolution} {tuple(range_per_dim)}"

        self._stored_bb = None
        if tables is not None:
            val_np, grad_np, self._stored_bb = tables
        else:
            store = get_store(cache_path)
            cached = None if clean_cache else store.get(self.name)
            if cached is not None:
                val_np, grad_np = cached[0], cached[1]
                if len(cached) > 2:  # tight surface bb persisted with the grids
                    self._stored_bb = np.asarray(cached[2])
                logger.info("cached sdf for %s loaded from %s", self.name, cache_path)
            else:
                if gt_sdf is None:
                    raise RuntimeError(
                        "Cached SDF did not find the cache and requires an initial "
                        "queryable SDF")
                coords, pts = get_coordinates_and_points_in_grid(
                    self.resolution, self.ranges, device=self.device)
                val_np, grad_np = _grid_sweep(gt_sdf, pts)
                val_np = val_np.reshape([len(c) for c in coords])
                self._stored_bb = gt_sdf.surface_bounding_box().cpu().numpy()
                store.put(self.name, [val_np, grad_np, self._stored_bb])
                logger.info("caching sdf for %s to %s", self.name, cache_path)

        self.voxels = GridView(
            torch.tensor(np.asarray(val_np, dtype=np.float32), device=self.device),
            range_per_dim, invalid_value=self._fallback_sdf_value_func)
        self.voxels_grad = torch.tensor(np.asarray(grad_np, dtype=np.float32),
                                        device=self.device).reshape(-1, 3)
        self.bb = self.surface_bounding_box().to(torch.float32)
        self._coherent_cache: Optional[_CoherentTables] = None
        self._build_raw()

    def _build_raw(self):
        dev = self.device
        lo = torch.as_tensor(self.voxels.lo.astype(np.float32), device=dev)
        # keys are (p - lo) * (1 / res) with the reciprocal rounded to float32,
        # the arithmetic of the JAX package's compiled lookup (XLA folds the
        # division by a constant into this multiply)
        inv_res = torch.as_tensor(
            np.float32(1.0) / self.voxels.res.astype(np.float32), device=dev)
        n = torch.as_tensor(self.voxels.shape, dtype=torch.int64, device=dev)
        strides = torch.as_tensor(self.voxels._strides, dtype=torch.int64, device=dev)
        self._grid = (lo, inv_res, n, strides)
        # one packed [G, 4] (value, grad) row per voxel: one gather per point
        self._vg = torch.cat([self.voxels.raw_data.reshape(-1, 1), self.voxels_grad],
                             dim=1).contiguous()
        bb = self.bb
        strategy = self.out_of_bounds_strategy
        gt_raw = self.gt_sdf.raw_query if self.gt_sdf is not None else None
        if strategy == OutOfBoundsStrategy.LOOKUP_GT_SDF and gt_raw is None:
            raise RuntimeError("LOOKUP_GT_SDF requires a ground-truth SDF")

        def rows(vg, flat_idx):
            return vg.index_select(0, flat_idx.reshape(-1)).reshape(
                flat_idx.shape + (4,))

        def gather_nearest(vg, pts):
            # out-of-range lanes read a clamped in-range row; the caller's
            # select discards them
            valid, kc = _voxel_keys(pts, lo, inv_res, n)
            r = rows(vg, (kc * strides).sum(dim=-1))
            return r[..., 0], r[..., 1:4], valid

        def gather_trilinear(vg, pts):
            valid, i0, w = _trilinear_cell(pts, lo, inv_res, n)
            acc = torch.zeros(pts.shape[:-1] + (4,), dtype=pts.dtype, device=pts.device)
            for offs in _CORNERS:
                idx = i0 + torch.tensor(offs, dtype=torch.int64, device=pts.device)
                acc = acc + (_corner_weight(w, offs)[..., None]
                             * rows(vg, (idx * strides).sum(dim=-1)))
            return acc[..., 0], acc[..., 1:4], valid

        gather = gather_trilinear if self.interpolation == "trilinear" else gather_nearest

        def raw_with(vg, pts):
            val_in, grad_in, valid = gather(vg, pts)
            if strategy == OutOfBoundsStrategy.BOUNDING_BOX:
                val_oob, g_oob = _aabb_distance_grad(bb, pts)
            else:
                val_oob, g_oob = gt_raw(pts)
            val = torch.where(valid, val_in, val_oob)
            grad = torch.where(valid[..., None], grad_in, g_oob)
            return val, grad

        self._raw = _straight_through_sdf(raw_with)

    def raw_query(self, points):
        return self._raw(self._vg, points)

    def raw_query_aux(self):
        return self._vg

    def raw_query_with(self, aux, points):
        return self._raw(aux, points)

    def _coherent_tables(self, with_grad_bricks: bool = False,
                         with_tri_bricks: bool = False,
                         with_value_bricks: bool = True,
                         with_gradonly_bricks: bool = False,
                         with_tri_value_bricks: bool = False,
                         with_tri_gradonly_bricks: bool = False) -> "_CoherentTables":
        """Tables of the brick-gather path, built lazily on the cache's
        device from the packed (value, grad) rows; a later call asking for
        more brick kinds upgrades the cache in place.  Flags: ``bricks``
        (4x4x4 values, on by default), ``bricks4`` (4x4x4 value + gradient,
        single-child unions), ``gbricks`` (4x4x4 gradient, multi-child
        unions), ``bricks5`` (5x5x5 value + gradient, the single trilinear
        child), ``tbricks`` / ``tgbricks`` (5x5x5 value / gradient, the
        trilinear union)."""
        c = self._coherent_cache
        if (c is not None and (not with_grad_bricks or c.bricks4 is not None)
                and (not with_tri_bricks or c.bricks5 is not None)
                and (not with_value_bricks or c.bricks is not None)
                and (not with_gradonly_bricks or c.gbricks is not None)
                and (not with_tri_value_bricks or c.tbricks is not None)
                and (not with_tri_gradonly_bricks or c.tgbricks is not None)):
            return c
        return self._build_coherent_tables(
            with_grad_bricks=with_grad_bricks, with_tri_bricks=with_tri_bricks,
            with_value_bricks=with_value_bricks,
            with_gradonly_bricks=with_gradonly_bricks,
            with_tri_value_bricks=with_tri_value_bricks,
            with_tri_gradonly_bricks=with_tri_gradonly_bricks)

    @staticmethod
    def _brick_expand(vol: torch.Tensor, nb: np.ndarray, width: int = 4) -> torch.Tensor:
        """Overlapping stride-2 ``width^3`` bricks of a zero-padded volume
        ``[npad_x, npad_y, npad_z, CH]`` -> ``[NB, CH, width^3]`` rows,
        channel-major, cells raveled x-major (``ux * width^2 + uy * width +
        uz``) and bricks raveled like the value grid."""
        w = vol
        for d in range(3):
            w = w.unfold(d, width, 2)  # [nbx, nby, nbz, CH, wx, wy, wz] after all three
        return w.reshape(int(np.prod(nb)), vol.shape[3], width ** 3)

    def _build_coherent_tables(self, with_grad_bricks: bool = False,
                               with_tri_bricks: bool = False,
                               with_value_bricks: bool = True,
                               with_gradonly_bricks: bool = False,
                               with_tri_value_bricks: bool = False,
                               with_tri_gradonly_bricks: bool = False) -> "_CoherentTables":
        n = np.asarray(self.voxels.shape, dtype=np.int64)
        nb = (n - 1) // 2 + 1          # brick-anchor grid dims (anchors at even keys)
        shape = tuple(int(d) for d in n)

        def expand(cols, width):
            # anchor 2 * (nb - 1) plus the brick's extent, zero-padded
            pad = 2 * nb + width - 2 - n
            vol = self._vg[:, cols].reshape(shape + (len(cols),))
            vol = torch.nn.functional.pad(
                vol, (0, 0, 0, int(pad[2]), 0, int(pad[1]), 0, int(pad[0])))
            return self._brick_expand(vol, nb, width)

        prev = self._coherent_cache
        old = prev._asdict() if prev is not None else {}
        wanted = {"bricks": (with_value_bricks, [0], 4),
                  "bricks4": (with_grad_bricks, [0, 1, 2, 3], 4),
                  "gbricks": (with_gradonly_bricks, [1, 2, 3], 4),
                  "bricks5": (with_tri_bricks, [0, 1, 2, 3], 5),
                  "tbricks": (with_tri_value_bricks, [0], 5),
                  "tgbricks": (with_tri_gradonly_bricks, [1, 2, 3], 5)}
        built = {}
        for name, (want, cols, width) in wanted.items():
            built[name] = old.get(name)
            if want and built[name] is None:
                b = expand(cols, width)
                # value-only kinds are plain [NB, width^3] rows
                built[name] = b[:, 0] if len(cols) == 1 else b
        lo, inv_res, n_t, strides = self._grid
        self._coherent_cache = _CoherentTables(
            lo=lo, inv_res=inv_res, n=n_t, strides=strides, vg=self._vg,
            bstrides=torch.as_tensor([nb[1] * nb[2], nb[2], 1], dtype=torch.int64,
                                     device=self.device),
            bb=self.bb, **built)
        return self._coherent_cache

    def get_voxel_view(self, voxels=None, dtype=torch.float32, device=None) -> GridView:
        """The cached grid itself, or the ground truth evaluated on another
        grid ``voxels``."""
        if voxels is None:
            return self.voxels
        if self.gt_sdf is None:
            raise RuntimeError(
                "get_voxel_view with a custom grid re-evaluates the ground "
                "truth; this CachedSDF was restored from cache without one")
        sdf_val, _ = self.gt_sdf(voxels.get_voxel_center_points())
        shape = [len(c) for c in voxels.coords]
        return GridView(sdf_val.reshape(shape), voxels.range_per_dim,
                        invalid_value=self._fallback_sdf_value_func)

    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0):
        if self.gt_sdf is not None:
            return self.gt_sdf.surface_bounding_box(padding=padding,
                                                    padding_ratio=padding_ratio)
        # warm-cache restart without a ground truth: the persisted tight bb
        if self._stored_bb is None:
            raise RuntimeError(
                "CachedSDF has neither a ground-truth SDF nor a persisted "
                "bounding box")
        return torch.as_tensor(pad_aabb(self._stored_bb, padding, padding_ratio),
                               dtype=torch.float32, device=self.device)

    def _fallback_sdf_value_func(self, *args, **kwargs):
        if self.gt_sdf is None:
            # no ground truth: the AABB under-approximation
            pts = as_float_tensor(args[0], self.device)
            dist, _ = _aabb_distance_grad(self.surface_bounding_box(), pts)
            return dist
        sdf_val, _ = self.gt_sdf(*args, **kwargs)
        return sdf_val

    def __call__(self, points_in_object_frame):
        val, grad = super().__call__(points_in_object_frame)
        if self.debug_check_sdf:
            self._debug_check(points_in_object_frame, val, grad)
        return val, grad

    def _debug_check(self, pts, val, grad):
        """Online self-check against the ground truth: in-bounds error <
        resolution; out-of-bounds bounding-box values under-approximate with
        gradient cosine similarity > 0.7."""
        pts = as_float_tensor(pts, self.device)
        with torch.no_grad():
            val_gt, grad_gt = self.gt_sdf(pts)
        val = val.detach().cpu().numpy()
        grad = grad.detach().cpu().numpy()
        val_gt = val_gt.cpu().numpy()
        grad_gt = grad_gt.cpu().numpy()
        within = self.voxels.get_valid_values(pts.reshape(-1, 3)).cpu().numpy().reshape(
            val.shape)
        diff = np.abs(val - val_gt)
        if not np.all(diff[within] < self.resolution):
            raise AssertionError(f"cached SDF error {diff[within].max()} "
                                 f">= resolution {self.resolution}")
        if self.out_of_bounds_strategy == OutOfBoundsStrategy.BOUNDING_BOX:
            oob = ~within
            if oob.any():
                under = val_gt[oob] - val[oob]
                if not np.all(under > -1e-5):
                    raise AssertionError(f"AABB value over-approximates by {-under.min()}")
                g1, g2 = grad[oob], grad_gt[oob]
                cos = np.sum(g1 * g2, axis=-1) / np.maximum(
                    np.linalg.norm(g1, axis=-1) * np.linalg.norm(g2, axis=-1), 1e-12)
                if not (np.all(cos > 0.7) and cos.mean() > 0.95):
                    raise AssertionError(f"AABB gradient cosine min {cos.min()}, "
                                         f"mean {cos.mean()}")

    def outside_surface(self, points_in_object_frame, surface_level=0):
        """Fast check assuming out-of-bounds points are outside."""
        pts = as_float_tensor(points_in_object_frame, self.device)
        flat = pts.reshape(-1, pts.shape[-1])
        keys = self.voxels.ensure_index_key(flat)
        n = torch.as_tensor(self.voxels.shape, dtype=torch.int64, device=self.device)
        valid = ((keys >= 0) & (keys < n)).all(dim=-1)
        flat_idx = self.voxels.ravel_multi_index(torch.minimum(keys.clamp(min=0), n - 1))
        inside_grid = self.voxels.raw_data.reshape(-1)[flat_idx] > surface_level
        return torch.where(valid, inside_grid, True).reshape(pts.shape[:-1])


def sample_mesh_points(obj_factory: Optional[ObjectFactory] = None, num_points=100,
                       seed=0, name="", clean_cache=False, dtype=torch.float32,
                       min_init_sample_points=200,
                       dbpath="model_points_cache.npz", device=None, cache=None):
    """Uniform surface samples and their face normals, cached on disk under
    the key ``name/seed/num_points`` (the JAX package's store format, so
    either package reads the other's cache).  Deterministic from ``seed``.
    ``cache`` is accepted for the reference's signature and unused: the
    store at ``dbpath`` is the cache.

    Returns ``(points [N, 3], normals [N, 3], store)`` on ``device`` (the
    factory's device by default)."""
    if device is None and obj_factory is not None:
        device = obj_factory.device
    device = resolve_device(device)
    store = get_store(dbpath)
    key = f"{name}/{seed}/{num_points}"
    if not clean_cache:
        hit = store.get(key)
        if hit is not None:
            points, normals = hit
            return (torch.as_tensor(points, dtype=dtype, device=device),
                    torch.as_tensor(normals, dtype=dtype, device=device), store)

    if obj_factory is None:
        raise RuntimeError(
            f"Expect model points to be cached for {name} {seed} {num_points} in {dbpath}")

    rng = np.random.default_rng(seed)
    # surface sampling is not dispersed: oversample, then subselect at random
    sample_num_points = max(min_init_sample_points, 2 * num_points)
    pts = obj_factory._mesh.sample_points_uniformly(sample_num_points, rng=rng)
    pts = rng.permutation(pts)[:num_points]

    res = obj_factory.object_frame_closest_point(pts, compute_normal=True)
    normals = res.normal.cpu().numpy()

    points = np.asarray(pts, dtype=np.float32)
    normals = normals.astype(np.float32)
    store.put(key, [points, normals])
    return (torch.as_tensor(points, dtype=dtype, device=device),
            torch.as_tensor(normals, dtype=dtype, device=device), store)
