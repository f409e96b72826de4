"""Build the port's objects from arrays taken as numpy.

The system's state is the packed triangle arrays of each mesh, the
value/gradient grids of each cached SDF, the eight tables of each
narrow-band SDF and, for the neural models, the MLP's learned weights.
These functions install such arrays (for example ones the JAX package
built or trained), so lookups, unions and networks can be compared on
identical tables and weights.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from pytorch_volumetric_tpu_torch import sdf
from pytorch_volumetric_tpu_torch.mesh import MeshScene
from pytorch_volumetric_tpu_torch.models.neural_sdf import MLP
from pytorch_volumetric_tpu_torch.ops.narrow_band import NarrowBandTables, tables_from_numpy
from pytorch_volumetric_tpu_torch.utils.batching import resolve_device


def scene_from_numpy(tri, normals, num_faces: int, device=None) -> MeshScene:
    """A :class:`MeshScene` from padded ``tri [Fp, 3, 3]`` and
    ``normals [Fp, 3]``."""
    dev = resolve_device(device)
    return MeshScene(torch.as_tensor(np.asarray(tri, dtype=np.float32), device=dev),
                     torch.as_tensor(np.asarray(normals, dtype=np.float32), device=dev),
                     int(num_faces))


def cached_sdf_from_numpy(name: str, resolution: float, range_per_dim, val, grad,
                          surface_bb, device=None, interpolation: str = "nearest",
                          out_of_bounds_strategy=sdf.OutOfBoundsStrategy.BOUNDING_BOX,
                          gt_sdf=None) -> sdf.CachedSDF:
    """A :class:`sdf.CachedSDF` over the given grids: ``val [nx, ny, nz]``,
    ``grad [nx*ny*nz, 3]`` and the tight surface box ``surface_bb [3, 2]``
    (``LOOKUP_GT_SDF`` also needs ``gt_sdf``)."""
    return sdf.CachedSDF(name, resolution, range_per_dim, gt_sdf,
                         out_of_bounds_strategy=out_of_bounds_strategy,
                         device=device, interpolation=interpolation,
                         tables=(np.asarray(val), np.asarray(grad),
                                 np.asarray(surface_bb)))


def narrow_band_sdf_from_numpy(obj_factory: sdf.ObjectFactory, tables: Sequence[np.ndarray],
                               cell_res=None, band=None) -> sdf.NarrowBandMeshSDF:
    """A :class:`sdf.NarrowBandMeshSDF` of ``obj_factory``'s mesh over the
    given eight tables, in ``NarrowBandTables`` order (lo, res, dims,
    strides, meta, cand, pseudo, bb), on the factory's device.  The tables
    fix the grid; ``cell_res`` and ``band`` are only recorded on the SDF
    (defaulting as in its constructor)."""
    return sdf.NarrowBandMeshSDF(obj_factory, cell_res=cell_res, band=band,
                                 tables=tables_from_numpy(tables, obj_factory.device))


def load_robot_tables(robot, arrays: Sequence[Mapping[str, np.ndarray]]) -> None:
    """Install per-link tables on ``robot`` in link order
    (``robot.sdf.sdfs``).  A cached link takes ``{"val", "grad"}`` (and
    optionally ``"surface_bb"``); an exact mesh link takes ``{"tri",
    "normals"}``; a narrow-band link takes the eight tables by their
    ``NarrowBandTables`` names (``"lo"``, ..., ``"bb"``)."""
    children = robot.sdf.sdfs
    if len(arrays) != len(children):
        raise ValueError(f"{len(arrays)} table sets for {len(children)} links")
    for i, (child, a) in enumerate(zip(children, arrays)):
        if isinstance(child, sdf.CachedSDF):
            bb = a.get("surface_bb")
            if bb is None:
                bb = child.surface_bounding_box().cpu().numpy()
            children[i] = cached_sdf_from_numpy(
                child.object_name, child.resolution, child.ranges,
                a["val"], a["grad"], bb, device=child.device,
                interpolation=child.interpolation,
                out_of_bounds_strategy=child.out_of_bounds_strategy,
                gt_sdf=child.gt_sdf)
        elif isinstance(child, sdf.MeshSDF):
            fac = child.obj_factory
            fac._scene = scene_from_numpy(a["tri"], a["normals"], fac.scene.num_faces,
                                          device=child.device)
            children[i] = sdf.MeshSDF(fac)
        elif isinstance(child, sdf.NarrowBandMeshSDF):
            children[i] = narrow_band_sdf_from_numpy(
                child.obj_factory, [a[f] for f in NarrowBandTables._fields],
                cell_res=child.cell_res, band=child.band)
        else:
            raise TypeError(f"link {i} ({type(child).__name__}) holds no tables")


def mlp_params_from_numpy(params: Sequence[Tuple[np.ndarray, np.ndarray]], device=None) -> MLP:
    """The port's MLP weights from ``(W [din, dout], b [dout])`` pairs, the
    JAX package's ``mlp_init`` layout, as float32 on ``device``."""
    dev = resolve_device(device)
    return MLP([(torch.tensor(np.asarray(W, dtype=np.float32), device=dev),
                 torch.tensor(np.asarray(b, dtype=np.float32), device=dev))
                for W, b in params])
