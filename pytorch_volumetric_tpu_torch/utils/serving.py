"""Export robot-SDF queries for serving, on ``torch.export``.

:func:`export_robot_query` exports the fused FK -> per-link SDF ->
min-union query (``RobotSDF.fused_query_fn``) as a ``torch.export``
program that a serving process loads and runs without the robot: no URDF,
no mesh, no cache build.  The kernels stay in the program as registered
custom ops (``pvt::closest_point_sweep``, ``pvt::narrow_band_query``,
``pvt::fk_link_transforms`` in an export made on the card, and
``pvt::coherent_union_tile`` or, on trilinear links,
``pvt::coherent_union_tile_tri`` in a grid export), so a
program loaded on the card runs the hand-written kernels, and the
straight-through lookups keep their analytic backward
(``ops.straight_through``), so the loaded query is differentiable w.r.t.
joint angles and points.  The big per-link tables ride OUTSIDE the program,
in an ``.npz`` sidecar (``leaf{i}``, ``n_leaves``), and are passed as its
inputs: the artifact's size does not grow with them.

>>> export_robot_query(robot, n_configs=32, n_points=4096, path="arm.pt2")
>>> query = load_robot_query("arm.pt2")     # no RobotSDF, meshes or cache
>>> val, grad = query(q, pts)               # [32, 4096], [32, 4096, 3]

A program is exported on the robot's device and moved to the device the
loader names with ``torch.export.passes.move_to_device_pass``: that plays
the part of the JAX package's ``platforms=`` argument.  Shapes are static:
export one program per serving shape, or pad at the call site.  The
sidecar is an uncompressed npz (a grid export's brick tables are over a
gigabyte).
"""

from __future__ import annotations

import importlib
import os
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from pytorch_volumetric_tpu_torch.utils.batching import (
    DeviceLike, as_float_tensor, flatten_tensors, resolve_device, unflatten_tensors)

TABLES_SUFFIX = ".tables.npz"

# the modules whose custom ops an exported query calls: importing them
# registers the ops a loaded program dispatches to (``sdf`` registers the
# CPU kernels of ``pvt::coherent_union_tile`` and ``pvt::coherent_union_tile_tri``
# beside the op modules' CUDA ones)
_OP_MODULES = ("pytorch_volumetric_tpu_torch.ops.closest_point",
               "pytorch_volumetric_tpu_torch.ops.fk",
               "pytorch_volumetric_tpu_torch.sdf",
               "pytorch_volumetric_tpu_torch.ops.narrow_band_cuda",
               "pytorch_volumetric_tpu_torch.ops.straight_through")


class _Program(torch.nn.Module):
    """A function as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn: Callable, inputs: Sequence[torch.Tensor], leaves: Sequence[torch.Tensor],
            path: str) -> Dict[str, float]:
    """Export ``fn(*inputs, *leaves)`` to ``path`` and the leaves to the
    sidecar.  Traced with gradients on, so the straight-through ops (and
    with them the backward) are part of the program.  Returns the seconds
    of the export (trace and save) and of the sidecar's write, and both
    files' bytes."""
    t0 = time.perf_counter()
    with torch.enable_grad():
        program = torch.export.export(_Program(fn), tuple(inputs) + tuple(leaves))
    # the export keeps its example inputs, the tables among them: not saved
    program.example_inputs = None
    torch.export.save(program, path)
    t1 = time.perf_counter()
    np.savez(path + TABLES_SUFFIX,
             **{f"leaf{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(leaves)},
             n_leaves=np.asarray(len(leaves)))
    return {"export_s": t1 - t0, "sidecar_s": time.perf_counter() - t1,
            "artifact_bytes": os.path.getsize(path),
            "sidecar_bytes": os.path.getsize(path + TABLES_SUFFIX)}


def export_robot_query(robot_sdf, n_configs: int, n_points: int,
                       path: str) -> Dict[str, float]:
    """Export the fused robot query for ``[n_configs, M]`` configurations x
    ``[n_points, 3]`` points to ``path``, with the per-link tables in
    ``path + '.tables.npz'``.  Returns the seconds each file took and its
    bytes."""
    fn, leaves = robot_sdf.fused_query_fn()
    dev = robot_sdf.device
    M = len(robot_sdf.joint_names)
    inputs = (torch.zeros((n_configs, M), device=dev), torch.zeros((n_points, 3), device=dev))
    return _export(fn, inputs, leaves, path)


def export_robot_grid_query(robot_sdf, n_configs: int, query_range, resolution: float,
                            path: str, values_only: bool = False) -> Dict[str, float]:
    """Export a fixed-grid collision-field server: ``query(q [A, M]) ->
    (val [A, n1, n2, n3], grad [..., 3])`` (``val`` alone with
    ``values_only``) over ``query_range`` at ``resolution``, on
    ``RobotSDF.query_grid``'s brick path with identical results.  The
    grid's tiled points, its un-tiling index and the links' tables ride in
    the sidecar; the consumer passes only ``q``.  Raises ``ValueError``
    when a cached link is finer than twice the grid's resolution (no tile
    fits its bricks).  Returns the seconds each file took and its bytes."""
    from pytorch_volumetric_tpu_torch import sdf as sdf_mod

    children = tuple(robot_sdf.sdf.sdfs)
    layout = robot_sdf._grid_layout(query_range, resolution)
    if layout.take is None:
        raise ValueError(
            f"sweep resolution {resolution:g} too coarse for cached link resolution "
            f"{sdf_mod.coherent_min_cache_resolution(children):g} (needs <= half); "
            "export_robot_query with explicit points instead")
    leaves, spec = flatten_tensors((layout, sdf_mod.coherent_fast_tables(children),
                                    sdf_mod.coherent_generic_aux(children)))

    def fn(q, *leaf_args):
        return robot_sdf._grid_query_with(q, *unflatten_tensors(spec, leaf_args), values_only)

    dev = robot_sdf.device
    M = len(robot_sdf.joint_names)
    return _export(fn, (torch.zeros((n_configs, M), device=dev),), leaves, path)


def _load(path: str, device: DeviceLike) -> Tuple[torch.nn.Module, Tuple[torch.Tensor, ...],
                                                   torch.device]:
    """The program at ``path`` on ``device`` (CUDA unless named) and its
    sidecar's tables there."""
    for name in _OP_MODULES:
        importlib.import_module(name)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    program = move_to_device_pass(torch.export.load(path), dev)
    with np.load(path + TABLES_SUFFIX, allow_pickle=False) as d:
        leaves = tuple(torch.as_tensor(d[f"leaf{i}"], device=dev)
                       for i in range(int(d["n_leaves"])))
    return program.module(), leaves, dev


def load_robot_query(path: str, device: DeviceLike = None) -> Callable:
    """Load an :func:`export_robot_query` program; returns ``query(q,
    pts) -> (val, grad)``, differentiable w.r.t. ``q`` and ``pts``.  Needs
    only the two files the export wrote."""
    program, leaves, dev = _load(path, device)

    def query(q, pts):
        return program(as_float_tensor(q, dev), as_float_tensor(pts, dev), *leaves)

    return query


def load_robot_grid_query(path: str, device: DeviceLike = None) -> Callable:
    """Load an :func:`export_robot_grid_query` program; returns
    ``query(q [A, M]) -> (val grid, grad grid)`` (or the values alone for
    a values-only export)."""
    program, leaves, dev = _load(path, device)

    def query(q):
        return program(as_float_tensor(q, dev), *leaves)

    return query
