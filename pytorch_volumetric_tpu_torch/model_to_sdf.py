"""Robot model -> SDF conditioned on joint configurations.

Walk the kinematic chain's visuals into per-link SDFs, run batched FK and
compose a min-union SDF over links with the link-major transform layout.
:meth:`RobotSDF.query` runs FK inside the query, so its result is
differentiable w.r.t. joint angles as well as query points.
"""

from __future__ import annotations

import logging
import typing
from functools import partial

import numpy as np
import torch

from pytorch_volumetric_tpu_torch import sdf
from pytorch_volumetric_tpu_torch import transforms as tfm
from pytorch_volumetric_tpu_torch.kinematics import Chain
from pytorch_volumetric_tpu_torch.ops import fk as fk_ops
from pytorch_volumetric_tpu_torch.sdf import compose_query
from pytorch_volumetric_tpu_torch.utils import profiling
from pytorch_volumetric_tpu_torch.utils.batching import (
    as_float_tensor, flatten_tensors, unflatten_tensors)
from pytorch_volumetric_tpu_torch.voxel import (
    get_coherent_tile_points, get_coordinates_and_points_in_grid)

logger = logging.getLogger(__name__)


class _GridLayout(typing.NamedTuple):
    """A grid of :meth:`RobotSDF.query_grid` as it is queried."""
    pts: torch.Tensor                   # [P, 3] the points queried
    take: typing.Optional[torch.Tensor]  # [n1 * n2 * n3] un-tiling index; None: raster
    seg: typing.Optional[int]           # points a tile
    shape: typing.Tuple[int, ...]       # (n1, n2, n3)


class RobotSDF(sdf.ObjectFrameSDF):
    """SDF of an articulated robot conditioned on a joint configuration."""

    def __init__(self, chain: Chain, default_joint_config=None, path_prefix="",
                 link_sdf_cls: typing.Callable[[sdf.ObjectFactory],
                                               sdf.ObjectFrameSDF] = sdf.MeshSDF,
                 primitive_geometry: bool = True, device=None):
        """``primitive_geometry``: build analytic SDFs for box / sphere /
        cylinder / capsule visuals.  The chain is moved to ``device``."""
        self.chain = chain.to(device=device) if device is not None else chain
        self.device = self.chain.device
        self.q = None
        self.joint_names = self.chain.get_joint_parameter_names()
        self.frame_names = self.chain.get_frame_names(exclude_fixed=False)
        self.sdf: typing.Optional[sdf.ComposedSDF] = None
        self.sdf_to_link_name = []
        self.configuration_batch = None
        # query_grid's points per grid, see _grid_layout
        self._grid_layouts = {}

        sdfs = []
        offsets = []
        primitives = {"box": sdf.BoxSDF, "sphere": sdf.SphereSDF,
                      "cylinder": sdf.CylinderSDF, "capsule": sdf.CapsuleSDF}
        for frame_name in self.frame_names:
            frame = self.chain.find_frame(frame_name)
            for link_vis in frame.link.visuals:
                if link_vis.geom_type == "mesh":
                    logger.info("%s offset %s", frame.link.name, link_vis.offset)
                    link_obj = sdf.MeshObjectFactory(
                        link_vis.geom_param[0], scale=link_vis.geom_param[1],
                        path_prefix=path_prefix, device=self.device)
                    link_sdf = link_sdf_cls(link_obj)
                elif link_vis.geom_type in primitives and primitive_geometry:
                    link_sdf = primitives[link_vis.geom_type](
                        *link_vis.geom_param, device=self.device)
                else:
                    if link_vis.geom_type is not None:
                        logger.warning("Cannot handle non-mesh link visual type %s "
                                       "for %s", link_vis.geom_type, frame.link.name)
                    continue
                sdfs.append(link_sdf)
                self.sdf_to_link_name.append(frame.link.name)
                offsets.append(np.asarray(link_vis.offset, dtype=np.float32))
        if not sdfs:
            raise ValueError("Chain has no mesh visuals to build SDFs from")

        # [L, 4, 4] visual offsets (mesh frame -> link frame) and inverses
        self.offset_transforms = torch.as_tensor(np.stack(offsets), device=self.device)
        self._offset_inv = tfm.invert_tf(self.offset_transforms)
        # the chain and the links as device tensors for the FK kernels, built
        # once here (never inside a call, where it would copy from the host)
        self._fk_desc = fk_ops.fk_descriptor(self.chain, self.sdf_to_link_name,
                                             self._offset_inv)
        self.sdf = sdf.ComposedSDF(sdfs, None)
        self.set_joint_configuration(default_joint_config)

    # -- transforms from configurations --------------------------------------
    def _link_transforms(self, q_flat: torch.Tensor):
        """``q [A, M]`` -> link-major ``(obj->link [L*A,4,4],
        link->obj [L*A,4,4])`` with object->link = offset^-1 o FK(link)^-1.
        A float32 CUDA ``q`` takes the FK kernels (``ops.fk``: one launch
        forward, one for d/dq), any other the plain chain walk over the same
        descriptor, called directly so that autograd keeps its second
        derivatives."""
        if q_flat.shape[-1] != len(self.joint_names):
            raise ValueError(f"expected {len(self.joint_names)} joint values "
                             f"({self.joint_names}), got shape {tuple(q_flat.shape)}")
        with profiling.span("pvt.fk"):
            if q_flat.is_cuda and q_flat.dtype == torch.float32:
                profiling.count("path.fk_fused")
                return fk_ops.fk_link_transforms(q_flat, self._fk_desc)
            profiling.count("path.fk_plain")
            return fk_ops.link_transforms_plain(q_flat, *self._fk_desc)

    def _flat_configs(self, joint_config):
        q = as_float_tensor(joint_config, self.device)
        # explicit leading size: -1 inference fails for 0-DOF robots
        q_flat = q.reshape(int(np.prod(q.shape[:-1], dtype=np.int64)), q.shape[-1])
        return q, q_flat

    def set_joint_configuration(self, joint_config=None):
        """``[A x] M`` arbitrarily batched joint configurations."""
        if joint_config is None:
            joint_config = torch.zeros(len(self.joint_names), device=self.device)
        q, q_flat = self._flat_configs(joint_config)
        self.configuration_batch = tuple(q.shape[:-1]) if q.ndim > 1 else None
        self.q = q
        m, _ = self._link_transforms(q_flat)
        self.sdf.set_transforms(tfm.Transform3d(matrix=m),
                                batch_dim=self.configuration_batch)
        return self

    # -- queries ---------------------------------------------------------------
    def raw_query(self, points):
        return self.sdf.raw_query(points)

    def __call__(self, points_in_object_frame):
        """``[B x] N x 3`` points -> ``[A x] [B x] N`` values and
        ``... x 3`` gradients under the configuration set last."""
        return self.sdf(points_in_object_frame)

    def query(self, joint_config, points_in_object_frame):
        """FK -> per-link SDF -> min-union in one call, differentiable
        w.r.t. ``joint_config`` and the points.

        :param joint_config: ``[A x] M``
        :param points_in_object_frame: ``[B x] N x 3``
        :return: ``([A x] [B x] N, [A x] [B x] N x 3)``
        """
        with profiling.span("pvt.query"):
            q, q_flat = self._flat_configs(joint_config)
            pts = as_float_tensor(points_in_object_frame, self.device)
            pts_flat = pts.reshape(-1, pts.shape[-1])
            # the tables are fetched on every call, so a table swap takes effect
            fn, leaves = self.fused_query_fn()
            vv, gg = fn(q_flat, pts_flat, *leaves)
            out_batch = q.shape[:-1] + pts.shape[:-1]
            return vv.reshape(out_batch), gg.reshape(out_batch + (3,))

    def fused_query_fn(self):
        """``(fn, leaves)``: ``fn(q_flat [A, M], pts_flat [P, 3], *leaves)
        -> (val [A, P], grad [A, P, 3])`` is the FK -> per-link SDF ->
        min-union query with every link's big tables (``raw_query_aux``,
        flattened in link order) as trailing arguments, and ``leaves`` are
        their current values.  :meth:`query` calls it; ``utils.serving``
        exports it with the tables as the program's inputs."""
        children = tuple(self.sdf.sdfs)
        leaves, spec = flatten_tensors(tuple(s.raw_query_aux() for s in children))

        def fn(q_flat, pts_flat, *table_leaves):
            aux = unflatten_tensors(spec, table_leaves)
            queries = tuple(partial(s.raw_query_with, a) for s, a in zip(children, aux))
            m, m_inv = self._link_transforms(q_flat)
            return compose_query(queries, m, m_inv, q_flat.shape[0], pts_flat)

        return fn, leaves

    def distill(self, key=0, **fit_kwargs):
        """Distill this robot SDF into a learned configuration-space field
        (:class:`models.ConfigSpaceNeuralSDF`); see
        :func:`models.fit_config_space_sdf` for the options.  Runs on this
        robot's device unless ``device`` is given.  Returns ``(model,
        losses)``; this robot stays the oracle."""
        from pytorch_volumetric_tpu_torch.models import fit_config_space_sdf
        fit_kwargs.setdefault("device", self.device)
        return fit_config_space_sdf(self, key, **fit_kwargs)

    def query_grid(self, joint_config, query_range, resolution, values_only: bool = False):
        """:meth:`query` over a regular world-frame grid through the brick
        path (:func:`sdf.compose_query_coherent`), with identical results.
        The grid is laid out in the largest tiles that fit a brick of every
        cached link (``voxel.get_coherent_tile_points``); when a cached link
        is finer than twice the grid's resolution, no tile fits and the
        generic :meth:`query` runs instead.

        :param joint_config: ``[A x] M``
        :param query_range: ``(min, max)`` per dimension
        :param resolution: grid step
        :param values_only: return the values alone, detached
        :return: ``(val [A x] n1 x n2 x n3, grad ... x 3)`` over the grid,
            or ``val`` alone with ``values_only``
        """
        with profiling.span("pvt.query_grid"):
            layout = self._grid_layout(query_range, resolution)
            q, q_flat = self._flat_configs(joint_config)
            out_shape = q.shape[:-1] + layout.shape
            if layout.take is None:
                profiling.count("path.grid_fallback")
                out = self.query(joint_config, layout.pts)
                if values_only:
                    out = out[0].detach()
            else:
                profiling.count("path.grid_coherent")
                children = tuple(self.sdf.sdfs)
                # the tables are fetched on every call, so a table swap takes effect
                out = self._grid_query_with(q_flat, layout, sdf.coherent_fast_tables(children),
                                            sdf.coherent_generic_aux(children), values_only)
            if values_only:
                return out.reshape(out_shape)
            vv, gg = out
            return vv.reshape(out_shape), gg.reshape(out_shape + (3,))

    def _grid_layout(self, query_range, resolution) -> _GridLayout:
        """The points :meth:`query_grid` runs over ``query_range`` at
        ``resolution``, built once per grid and kept on the device (a
        host-to-device copy on every call would wait for the card): the
        tiles of the brick path with their un-tiling index, or, when a
        cached link is finer than twice the grid's resolution (no tile fits
        its bricks), the grid's own points with ``take`` None."""
        min_res = sdf.coherent_min_cache_resolution(tuple(self.sdf.sdfs))
        key = (float(resolution), np.asarray(query_range, dtype=np.float64).tobytes(), min_res)
        if key not in self._grid_layouts:
            coords, _ = get_coordinates_and_points_in_grid(resolution, query_range,
                                                           device="cpu", get_points=False)
            shape = tuple(len(c) for c in coords)
            if min_res is not None and 2.0 * resolution > min_res:
                logger.info(
                    "query_grid: sweep resolution %.4g too coarse for cached link "
                    "resolution %.4g (needs <= half); the grid takes the generic "
                    "query path", resolution, min_res)
                _, pts = get_coordinates_and_points_in_grid(resolution, query_range,
                                                            device=self.device)
                layout = _GridLayout(pts, None, None, shape)
            else:
                pts, take_idx, seg = get_coherent_tile_points(
                    resolution, query_range, cache_resolution=min_res, device=self.device)
                layout = _GridLayout(pts, torch.as_tensor(take_idx, device=self.device),
                                     seg, shape)
            self._grid_layouts[key] = layout
        return self._grid_layouts[key]

    def _grid_query_with(self, q_flat, layout: _GridLayout, fast_tables, generic_aux,
                         values_only: bool):
        """The brick path of :meth:`query_grid` on a tiled ``layout`` with
        the given tables: ``q_flat [A, M]`` -> ``(val [A, n1, n2, n3], grad
        [..., 3])``, or ``val`` alone with ``values_only``.
        ``utils.serving`` exports it with the layout and tables as inputs."""
        m, m_inv = self._link_transforms(q_flat)
        out = sdf.compose_query_coherent(
            tuple(self.sdf.sdfs), m, m_inv, q_flat.shape[0], layout.pts,
            fast_tables=fast_tables, values_only=values_only, generic_aux=generic_aux,
            seg=layout.seg)
        shape = (q_flat.shape[0],) + layout.shape
        if values_only:
            return out[:, layout.take].reshape(shape)
        vv, gg = out
        return vv[:, layout.take].reshape(shape), gg[:, layout.take].reshape(shape + (3,))

    # -- geometry ----------------------------------------------------------------
    def surface_bounding_box(self, **kwargs):
        return self.sdf.surface_bounding_box(**kwargs)

    def link_bounding_boxes(self):
        """Per-link oriented bounding boxes under the current configuration:
        ``[A x] L x 8 x 3`` corner points in the robot frame (squeezed)."""
        tfs = self.sdf.link_frame_to_obj_frame  # [L*A, 4, 4]
        bbs = []
        for i, s in enumerate(self.sdf.sdfs):
            bb = aabb_to_ordered_end_points(
                s.surface_bounding_box(padding=0).cpu().numpy())
            corners = torch.as_tensor(bb, dtype=torch.float32, device=self.device)
            bbs.append(tfm.transform_points(tfs[self.sdf.ith_transform_slice(i)],
                                            corners))
        out = torch.stack(bbs)  # [L, A, 8, 3]
        return torch.squeeze(out.transpose(0, 1) if self.configuration_batch else out)


def cache_link_sdf_factory(resolution=0.01, padding=0.1, **kwargs):
    """Closure producing a ``CachedSDF(MeshSDF(obj))`` per link."""

    def create_sdf(obj_factory: sdf.ObjectFactory):
        gt_sdf = sdf.MeshSDF(obj_factory)
        return sdf.CachedSDF(obj_factory.name, resolution,
                             obj_factory.bounding_box(padding=padding), gt_sdf,
                             **kwargs)

    return create_sdf


def narrow_band_link_sdf_factory(cell_res=None, band=None, padding=0.1, max_k=256,
                                 **kwargs):
    """Closure producing a :class:`sdf.NarrowBandMeshSDF` per link, the
    large-mesh counterpart of :func:`cache_link_sdf_factory` (exact near the
    surface, ``K`` candidates per query instead of every face)."""

    def create_sdf(obj_factory: sdf.ObjectFactory):
        return sdf.NarrowBandMeshSDF(obj_factory, cell_res=cell_res, band=band,
                                     padding=padding, max_k=max_k, **kwargs)

    return create_sdf


# Corner codes: bit d set <=> take the max bound along dimension d: a plain
# 8-corner enumeration, and a 16-step wireframe walk in which consecutive
# points share an edge.
_CORNER_ORDER = (0b000, 0b001, 0b010, 0b100, 0b110, 0b101, 0b011, 0b111)
_CORNER_DRAW_WALK = (0b000, 0b001, 0b011, 0b010, 0b000, 0b100, 0b101, 0b001,
                     0b101, 0b111, 0b011, 0b111, 0b110, 0b010, 0b110, 0b100)


def aabb_to_ordered_end_points(aabb, arrange_in_sequential_order=False):
    """AABB [3, 2] -> 8 corners (or a 16-point sequential drawing order)."""
    aabb = np.asarray(aabb)
    codes = np.asarray(_CORNER_DRAW_WALK if arrange_in_sequential_order
                       else _CORNER_ORDER)
    take_max = (codes[:, None] >> np.arange(3)) & 1  # [K, 3] in {0, 1}
    return np.where(take_max, aabb[:, 1], aabb[:, 0])
