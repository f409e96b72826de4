"""Object-frame signed distance fields (the central abstraction).

The ``ObjectFrameSDF`` protocol maps ``pts [.., N, 3]`` to ``(val [.., N],
grad [.., N, 3])``, with concrete primitive, ``MeshSDF``, ``ComposedSDF``
and ``CachedSDF`` implementations.

- Mesh queries run the brute-force closest-point + winding sweep
  (``ops.point_triangle``; the CUDA kernel on the card); the inside/outside
  sign comes from the generalized winding number.
- Every SDF exposes ``raw_query(pts [P, 3])``; ``__call__`` adds input
  coercion and batch flattening.
- Mesh and cached values are differentiable w.r.t. the query points (and
  so w.r.t. poses and joint angles by the chain rule) through a
  straight-through ``torch.autograd.Function`` whose derivative is the
  analytic SDF gradient.
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
from pytorch_volumetric_tpu_torch.utils.batching import (
    as_float_tensor, resolve_device)
from pytorch_volumetric_tpu_torch.utils.cache import get_store
from pytorch_volumetric_tpu_torch.voxel import (
    GridView, get_coordinates_and_points_in_grid,
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
        self._scene: Optional[mesh_mod.MeshScene] = None
        self.precompute_sdf()

    @abc.abstractmethod
    def get_mesh_resource_filename(self) -> str:
        """Path to the mesh resource file (.obj, .stl, ...)."""

    def get_mesh_high_poly_resource_filename(self) -> str:
        return self.get_mesh_resource_filename()

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


class _StraightThrough(torch.autograd.Function):
    """``raw_fn(*tables, pts) -> (val, grad)`` whose derivative of the value
    w.r.t. the points is the analytic gradient itself.  The gradient output
    carries no derivative of its own, and the tables get none."""

    @staticmethod
    def forward(ctx, raw_fn, pts, *tables):
        val, grad = raw_fn(*tables, pts)
        ctx.n_tables = len(tables)
        ctx.save_for_backward(grad)
        ctx.mark_non_differentiable(grad)
        return val, grad

    @staticmethod
    def backward(ctx, ct_val, _ct_grad):
        (grad,) = ctx.saved_tensors
        return (None, ct_val[..., None] * grad) + (None,) * ctx.n_tables


def _straight_through_sdf(raw_fn: Callable) -> Callable:
    """Wrap ``raw_fn(*tables, pts) -> (val, grad)`` so that pose and joint
    gradients flow through transforms and FK by the chain rule (second
    derivatives of the gradient output are treated as zero)."""

    def query(*args):
        *tables, pts = args
        return _StraightThrough.apply(raw_fn, pts, *tables)

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
    ``[F, d]`` in the shared object frame.  Returns ``(val [B, F],
    grad [B, F, d])``; ties keep the earlier child (strict ``<``).
    """
    S = len(child_raw_queries)
    F = points.shape[0]
    pts_all = tfm.transform_points(obj_to_link, points).reshape(S, batch, F, 3)
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
    dtotal = pts - torch.clamp(pts, min=bb[:, 0], max=bb[:, 1])
    dist = _norm(dtotal)
    grad = dtotal / dist.clamp(min=1e-12)[..., None]
    return dist, grad


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
            keys = torch.round((pts - lo) * inv_res).to(torch.int64)
            valid = ((keys >= 0) & (keys < n)).all(dim=-1)
            # out-of-range lanes read a clamped in-range row; the caller's
            # select discards them
            flat_idx = (torch.minimum(keys.clamp(min=0), n - 1) * strides).sum(dim=-1)
            r = rows(vg, flat_idx)
            return r[..., 0], r[..., 1:4], valid

        def gather_trilinear(vg, pts):
            f = (pts - lo) * inv_res
            # valid if the nearest-voxel key is in range (the nearest
            # contract); the interpolation cell is clamped to the grid
            keys = torch.round(f).to(torch.int64)
            valid = ((keys >= 0) & (keys < n)).all(dim=-1)
            f = torch.minimum(f.clamp(min=0.0), (n - 1).to(pts.dtype))
            i0 = torch.minimum(torch.floor(f).to(torch.int64).clamp(min=0), n - 2)
            w = f - i0.to(pts.dtype)
            acc = torch.zeros(pts.shape[:-1] + (4,), dtype=pts.dtype, device=pts.device)
            for corner in range(8):
                offs = [(corner >> d) & 1 for d in range(3)]
                wd = [w[..., d] if offs[d] else 1.0 - w[..., d] for d in range(3)]
                wt = wd[0] * wd[1] * wd[2]
                idx = i0 + torch.tensor(offs, dtype=torch.int64, device=pts.device)
                acc = acc + wt[..., None] * rows(vg, (idx * strides).sum(dim=-1))
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
                       dbpath="model_points_cache.npz", device=None):
    """Uniform surface samples and their face normals, cached on disk under
    the key ``name/seed/num_points`` (the JAX package's store format, so
    either package reads the other's cache).  Deterministic from ``seed``.

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
