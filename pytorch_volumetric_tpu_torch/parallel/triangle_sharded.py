"""Triangle-sharded mesh SDF: the triangle array split over ranks.

For meshes too large to replicate (or to split one heavy query), the sweep
is data-parallel over triangles: each rank sweeps its triangle shard (the
closest-point + winding kernel on the card, ``ops.closest_point``),
keeping a local (distance, closest point, face id) and a partial winding
sum; the union is an epilogue of all-reduces over the ranks of the
triangle dimension.  The result is the single-rank sweep's, up to the
winding sum's order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard

from pytorch_volumetric_tpu_torch import mesh as mesh_mod
from pytorch_volumetric_tpu_torch import sdf as sdf_mod
from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda
from pytorch_volumetric_tpu_torch.parallel.sharding import (
    _axis_size, _local_block, _placements, _sharded)
from pytorch_volumetric_tpu_torch.utils.batching import cdiv, pad_to


class TriangleShardedMeshSDF(sdf_mod.ObjectFrameSDF):
    """Exact mesh SDF with its triangles sharded over one dimension of a
    device mesh: the contract of :class:`sdf.MeshSDF`, over ranks."""

    def __init__(self, obj_factory: sdf_mod.ObjectFactory, device_mesh: DeviceMesh,
                 axis: str = None, point_axis: str = None):
        """``axis``: the mesh dimension the triangles shard over (default:
        the first).  ``point_axis``: the other dimension of a 2D mesh, over
        which the query points are sharded too (the point count must divide
        evenly); the outputs are then ``DTensor``s sharded over it.  With a
        1D mesh the points are replicated and so are the outputs."""
        self.obj_factory = obj_factory
        self.device_mesh = device_mesh
        self.device = obj_factory.device
        names = device_mesh.mesh_dim_names
        self.axis = axis if axis is not None else names[0]
        self.point_axis = point_axis
        extra = [a for a in names if a != self.axis]
        if extra != ([] if point_axis is None else [point_axis]):
            raise ValueError(
                f"mesh axes {names} with triangle axis {self.axis!r}: point_axis must name "
                f"exactly the remaining axis (got point_axis={point_axis!r})")

        scene = obj_factory.scene
        n_shards = _axis_size(device_mesh, self.axis)
        # every shard a multiple of 128 faces, padded as the scene is
        shard = cdiv(scene.padded_faces, n_shards * 128) * 128
        me = device_mesh.get_local_rank(self.axis)
        rows = slice(me * shard, (me + 1) * shard)
        tri = pad_to(scene.tri, shard * n_shards, value=mesh_mod.PAD_COORD)[rows].contiguous()
        normals = pad_to(scene.normals, shard * n_shards)[rows].contiguous()
        tri_placements = _placements(device_mesh, **{self.axis: Shard(0)})
        self.tri = _sharded(tri, device_mesh, tri_placements)
        self.normals = _sharded(normals, device_mesh, tri_placements)
        self.shard_size = shard
        self.surface_normal_eps = obj_factory.surface_normal_eps
        self.winding_threshold = obj_factory.winding_threshold
        # the WHOLE mesh's box on every shard (None for an open mesh): with
        # the same box and points every shard skips the winding of the same
        # point warps, whose whole-mesh winding is 0
        self._exterior_box = scene.exterior_box
        self._group = device_mesh.get_group(self.axis)
        self._rank, self._n_shards = me, n_shards
        eps, thr = self.surface_normal_eps, self.winding_threshold

        def raw(tri_local, normals_local, pts):
            dist_, closest, face_n, wind = self._union(pts, tri_local, normals_local)
            # |winding|, as MeshSDF: an inward-wound mesh is inside too
            inside = wind.abs() > thr
            sign = torch.where(inside, -1.0, 1.0).to(pts.dtype)
            away = pts - closest
            grad = sign[..., None] * away / torch.clamp(dist_, min=1e-12)[..., None]
            grad = torch.where((dist_ < eps)[..., None], face_n, grad)
            return sign * dist_, grad

        self._raw = sdf_mod._straight_through_sdf(raw)

    def _union(self, pts, tri_local, normals_local):
        """The sweep of this rank's shard, then the union over the triangle
        dimension: ``(dist, closest, normal at closest, winding)``."""
        d, closest, fid, wind = mesh_closest_query_cuda(
            pts.contiguous(), tri_local, exterior_box=self._exterior_box)
        d_min = d.clone()
        dist.all_reduce(d_min, op=dist.ReduceOp.MIN, group=self._group)
        # distance ties go to the lowest rank, whose faces come first (the
        # single sweep ranks squared distances: where two of them round to
        # one distance, the closest point may differ by rounding)
        best = torch.where(d <= d_min, self._rank, self._n_shards).to(torch.int32)
        dist.all_reduce(best, op=dist.ReduceOp.MIN, group=self._group)
        win = (best == self._rank)[:, None]
        packed = torch.cat([torch.where(win, closest, 0.0),
                            torch.where(win, normals_local.index_select(0, fid), 0.0),
                            wind[:, None]], dim=1)
        dist.all_reduce(packed, group=self._group)
        return d_min, packed[:, :3], packed[:, 3:6], packed[:, 6]

    def _points(self, points):
        if self.point_axis is None:
            return points
        return _local_block(points, self.device_mesh, (self.point_axis,), self.device)

    def _out(self, *ts):
        if self.point_axis is None:
            return ts
        placements = _placements(self.device_mesh, **{self.point_axis: Shard(0)})
        return tuple(_sharded(t, self.device_mesh, placements) for t in ts)

    def raw_query(self, points):
        return self._out(*self._raw(self.tri.to_local(), self.normals.to_local(),
                                    self._points(points)))

    def full_query(self, points):
        """``(dist, closest, normal at closest, winding)``: the pieces of
        an ``SDFQuery``."""
        with torch.no_grad():
            return self._out(*self._union(self._points(points), self.tri.to_local(),
                                          self.normals.to_local()))

    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0):
        return torch.as_tensor(self.obj_factory.bounding_box(padding, padding_ratio),
                               dtype=torch.float32, device=self.device)
