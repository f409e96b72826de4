"""The closest-point + winding sweep as hand-written CUDA kernels.

Each wrapper is a drop-in equivalent of a plain version in
``ops.point_triangle``.  For a CUDA tensor it launches its kernel on
PyTorch's current stream (the library is built from ``csrc/`` at first use),
or raises; for a CPU tensor it runs the plain version.  Each wrapper counts
its kernel launches in its own ``.launches``.

- :func:`mesh_closest_query_cuda` (``csrc/closest_point.cu``): the sweep of
  the main path, plain version ``mesh_closest_query``.
- :func:`mesh_closest_query_nowind_cuda` (same source, no winding sum):
  plain version ``mesh_closest_query(..., winding=False)``.
- :func:`mesh_closest_query_mma_cuda` (``csrc/closest_point_mma.cu``): the
  pairwise dot products on the tensor cores, plain version
  ``mesh_closest_query_expanded``.
- :func:`mesh_closest_query_contracted_cuda`: ``csrc/closest_point.cu``
  built with multiply-add contraction on, for the roofline probe only; it
  differs from its plain version by rounding.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_volumetric_tpu_torch.ops import cuda_build
from pytorch_volumetric_tpu_torch.ops.point_triangle import (
    _FOUR_PI, mesh_closest_query, mesh_closest_query_expanded)

KERNEL = "closest_point"


def _entry(library: str, symbol: str, winding: bool):
    lib = cuda_build.load(library)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([p, ctypes.c_int, p, ctypes.c_int, p, p, p]
                       + ([p] if winding else []) + [p])
        fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(points: torch.Tensor, tri: torch.Tensor) -> None:
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [P, 3], got {tuple(points.shape)}")
    if tri.ndim != 3 or tri.shape[1:] != (3, 3) or tri.shape[0] < 1:
        raise ValueError(f"tri must be [F>=1, 3, 3], got {tuple(tri.shape)}")
    for name, t in (("points", points), ("tri", tri)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != points.device:
            raise ValueError("points and tri must be on the same device")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name} is too large for 32-bit indexing")


def _launch(wrapper, library: str, symbol: str, points: torch.Tensor,
            tri: torch.Tensor, winding: bool = True):
    """Run one sweep kernel on CUDA tensors; returns the wrapper's outputs
    (winding zeros when the kernel computes none)."""
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    _check_inputs(points, tri)
    lib, fn = _entry(library, symbol, winding)
    P, F = points.shape[0], tri.shape[0]
    dev = points.device
    d2 = torch.empty(P, dtype=torch.float32, device=dev)
    closest = torch.empty((P, 3), dtype=torch.float32, device=dev)
    fid = torch.empty(P, dtype=torch.int32, device=dev)
    wind = (torch.empty if winding else torch.zeros)(P, dtype=torch.float32, device=dev)
    if P:
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = [d2.data_ptr(), closest.data_ptr(), fid.data_ptr()]
        if winding:
            outs.append(wind.data_ptr())
        with torch.cuda.device(dev):
            code = fn(points.data_ptr(), P, tri.data_ptr(), F, *outs, stream)
        cuda_build.check_launch(lib, code, symbol)
        wrapper.launches += 1
    return torch.sqrt(d2), closest, fid, wind / _FOUR_PI


def mesh_closest_query_cuda(points: torch.Tensor, tri: torch.Tensor,
                            **plain_kwargs):
    """Closest point + winding number for ``points [P, 3]`` against
    triangles ``tri [Fp, 3, 3]`` (padding with ``mesh.PAD_COORD`` allowed).

    Returns ``(dist [P], closest [P, 3], face_id [P] int32, winding [P])``.
    ``plain_kwargs`` (chunk sizes) apply to the plain version only.
    """
    if points.device.type == "cpu":
        return mesh_closest_query(points, tri, **plain_kwargs)
    return _launch(mesh_closest_query_cuda, KERNEL, "pvt_closest_point_sweep",
                   points, tri)


def mesh_closest_query_nowind_cuda(points: torch.Tensor, tri: torch.Tensor,
                                   **plain_kwargs):
    """:func:`mesh_closest_query_cuda` without the winding sum: the same
    distances, closest points and face ids; the returned winding is all
    zeros (the kernel computes none)."""
    if points.device.type == "cpu":
        return mesh_closest_query(points, tri, winding=False, **plain_kwargs)
    return _launch(mesh_closest_query_nowind_cuda, KERNEL,
                   "pvt_closest_point_sweep_nowind", points, tri, winding=False)


def mesh_closest_query_mma_cuda(points: torch.Tensor, tri: torch.Tensor,
                                **plain_kwargs):
    """:func:`mesh_closest_query_cuda` with the pairwise dot products on
    the tensor cores (3xTF32, float32 accuracy); same inputs and outputs."""
    if points.device.type == "cpu":
        return mesh_closest_query_expanded(points, tri, **plain_kwargs)
    return _launch(mesh_closest_query_mma_cuda, "closest_point_mma",
                   "pvt_closest_point_sweep_mma", points, tri)


def mesh_closest_query_contracted_cuda(points: torch.Tensor, tri: torch.Tensor,
                                       **plain_kwargs):
    """:func:`mesh_closest_query_cuda` from the same source built with
    multiply-add contraction (``-fmad=true``), for the roofline probe: it
    measures what the main path's ``-fmad=false`` costs.  Not bit-identical
    to the plain version."""
    if points.device.type == "cpu":
        return mesh_closest_query(points, tri, **plain_kwargs)
    return _launch(mesh_closest_query_contracted_cuda, "closest_point_fmad",
                   "pvt_closest_point_sweep", points, tri)


for _wrapper in (mesh_closest_query_cuda, mesh_closest_query_nowind_cuda,
                 mesh_closest_query_mma_cuda, mesh_closest_query_contracted_cuda):
    _wrapper.launches = 0
