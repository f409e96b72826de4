"""SDF visualization helpers (headless matplotlib).

2D SDF slices with the 0-level contour and an optional gradient quiver,
and per-link meshes posed in the world frame (as :class:`mesh.TriangleMesh`).
Matplotlib is imported only when a plot is drawn, and works under Agg.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pytorch_volumetric_tpu_torch import sdf as sdf_mod
from pytorch_volumetric_tpu_torch import transforms as tfm
from pytorch_volumetric_tpu_torch import voxel


def fmt(x):
    """Contour-label formatter: the zero level reads "surface", other
    levels print with one decimal unless that decimal is zero."""
    if x == 0:
        return "surface"
    return f"{x:.0f}" if float(f"{x:.1f}").is_integer() else f"{x:.1f}"


def _jitter(pts: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    noise = torch.randn(pts.shape, generator=generator, dtype=pts.dtype,
                        device=generator.device)
    return pts + noise.to(pts.device) * 1e-6


def draw_sdf_slice(s: sdf_mod.ObjectFrameSDF, query_range, resolution=0.01,
                   interior_padding=0.2, cmap="Greys_r", plot_grad=False, do_plot=True,
                   generator: Optional[torch.Generator] = None):
    """Evaluate (and optionally plot) an axis-aligned SDF slice.

    ``query_range``: (min, max) per dimension with exactly one dimension
    having min == max (the sliced dimension).  Query points get 1e-6 jitter
    against grid-aligned artifacts, drawn from ``generator`` (a CPU
    generator seeded 0 without one).  A composition whose cached children
    admit the brick path (:meth:`sdf.ComposedSDF.check_coherent_contract`)
    is evaluated through :meth:`sdf.ComposedSDF.query_coherent` on a tiled
    layout of the same grid, with its own jitter; the returned points are
    the ones each value was evaluated at.

    :return: (sdf_val, sdf_grad, pts, ax, cset1, cset2, v)
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    coords, pts = voxel.get_coordinates_and_points_in_grid(resolution, query_range,
                                                           device=s.device)
    pts = _jitter(pts, generator)
    take_idx = None
    if hasattr(s, "query_coherent"):
        min_res = sdf_mod.coherent_min_cache_resolution(getattr(s, "sdfs", ()))
        pts_c, take_idx, seg = voxel.get_coherent_tile_points(
            resolution, query_range, cache_resolution=min_res, device=s.device)
        pts_c = _jitter(pts_c, generator)
        if not s.check_coherent_contract(pts_c, seg=seg):
            take_idx = None
    slice_dim = next((i for i in range(len(coords)) if len(coords[i]) == 1), None)
    if slice_dim is None:
        raise RuntimeError(
            "Sliced SDF requires a single query value for the sliced dimension, "
            "but all query dimensions have > 1 values")
    shown_dims = [i for i in range(3) if i != slice_dim]

    if take_idx is not None:
        v_c, g_c = s.query_coherent(pts_c, seg=seg)
        take = torch.as_tensor(take_idx, device=pts_c.device)
        sdf_val, sdf_grad = v_c[..., take], g_c[..., take, :]
        pts = pts_c[take]
    else:
        sdf_val, sdf_grad = s(pts)
    x = coords[shown_dims[0]].cpu().numpy()
    z = coords[shown_dims[1]].cpu().numpy()
    v = sdf_val.detach().cpu().numpy().reshape(len(x), len(z)).T

    ax = cset1 = cset2 = None
    if do_plot:
        from matplotlib import pyplot as plt
        import matplotlib.colors
        dim_labels = ["x", "y", "z"]
        norm = matplotlib.colors.Normalize(
            vmin=float(np.min(v)) - interior_padding, vmax=float(np.max(v)))
        ax = plt.gca()
        ax.set_xlabel(dim_labels[shown_dims[0]])
        ax.set_ylabel(dim_labels[shown_dims[1]])
        cset1 = ax.contourf(x, z, v, norm=norm, cmap=cmap)
        cset2 = ax.contour(x, z, v, colors="k", levels=[0], linestyles="dashed")
        if plot_grad:
            g = sdf_grad.detach().cpu().numpy().reshape(len(x), len(z), 3).transpose(1, 0, 2)
            n = 5
            ax.quiver(x[::n], z[::n],
                      g[::n, ::n, shown_dims[0]], g[::n, ::n, shown_dims[1]], color="g")
        ax.clabel(cset2, cset2.levels, inline=True, fontsize=13, fmt=fmt)
        plt.colorbar(cset1)
        plt.draw()
    return sdf_val, sdf_grad, pts, ax, cset1, cset2, v


def get_transformed_meshes(robot_sdf, obj_to_world_tsf: Optional[tfm.Transform3d] = None):
    """Per-link meshes of a :class:`model_to_sdf.RobotSDF` moved to the
    world frame under its first configuration, as :class:`mesh.TriangleMesh`."""
    tsfs = robot_sdf.sdf.link_frame_to_obj_frame  # [L*A, 4, 4] link -> object
    if obj_to_world_tsf is not None:
        tsfs = tfm.mm(obj_to_world_tsf.get_matrix().to(tsfs.device), tsfs)
    tsfs = tsfs.detach().cpu().numpy()
    meshes = []
    for i in range(len(robot_sdf.sdf_to_link_name)):
        sl = robot_sdf.sdf.ith_transform_slice(i)
        mesh = robot_sdf.sdf.sdfs[i].obj_factory._mesh
        meshes.append(mesh.transform(tsfs[sl][0]))
    return meshes
