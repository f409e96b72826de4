"""The closest-point + winding sweep as hand-written CUDA kernels.

Each wrapper is a drop-in equivalent of a plain version in
``ops.point_triangle``.  For a CUDA tensor it launches its kernel on
PyTorch's current stream (the library is built from ``csrc/`` at first use),
or raises; for a CPU tensor it runs the plain version.  Each wrapper counts
its kernel launches in ``utils.profiling.COUNTERS`` under its key in
:data:`LAUNCHES`.

- :func:`mesh_closest_query_cuda` (``csrc/closest_point.cu``): the sweep of
  the main path, plain version ``mesh_closest_query``.  It reaches the
  kernel through the registered custom op ``pvt::closest_point_sweep``
  (CPU: the plain version; CUDA: the kernel; a fake implementation gives
  the outputs' shapes), so ``torch.export`` keeps the sweep as one opaque
  node that a loaded program dispatches to the kernel on the card.
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
from typing import List, Optional, Tuple

import numpy as np
import torch

from pytorch_volumetric_tpu_torch.ops import cuda_build
from pytorch_volumetric_tpu_torch.utils import profiling
from pytorch_volumetric_tpu_torch.ops.point_triangle import (
    _FOUR_PI, DEFAULT_POINT_CHUNK, DEFAULT_TRI_CHUNK, mesh_closest_query,
    mesh_closest_query_expanded)

# the libraries the sweep wrappers launch (scripts/sweep_variants_torch.py
# points them at its variants)
KERNEL = "closest_point"
MMA_KERNEL = "closest_point_mma"
# each wrapper's count of its launches in ``utils.profiling.COUNTERS``
SWEEP = "kernel.closest_point_sweep"
SWEEP_NOWIND = "kernel.closest_point_sweep_nowind"
SWEEP_MMA = "kernel.closest_point_sweep_mma"
SWEEP_CONTRACTED = "kernel.closest_point_sweep_contracted"

_p, _i = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types (pointers, counts, options, the stream)
_ARGTYPES = {
    "pvt_closest_point_sweep": [_p, _i, _p, _i, _p, _p, _p, _p, _p, _p, _p],
    "pvt_closest_point_sweep_nowind": [_p, _i, _p, _i, _p, _p, _p, _p, _p],
    "pvt_closest_point_sweep_mma": [_p, _i, _p, _i, _p, _p, _p, _p, _p, _p, _p],
}


def _entry(library: str, symbol: str):
    lib = cuda_build.load(library)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
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


def _sweep_options(points: torch.Tensor, exterior_box, counters, winding: bool):
    """The sweep kernel's trailing arguments (before the stream); the ctypes
    box array is returned too, to live through the call."""
    box = None
    if exterior_box is not None and winding:
        vals = [float(x) for x in np.asarray(exterior_box, dtype=np.float32).reshape(-1)]
        if len(vals) != 6:
            raise ValueError("exterior_box must be [2, 3] (lo, hi)")
        box = (ctypes.c_float * 6)(*vals)
    if counters is not None and (counters.dtype != torch.int64 or counters.shape != (2,)
                                 or counters.device != points.device):
        raise ValueError("counters must be an int64 tensor [2] on the points' device")
    args = [None if counters is None else counters.data_ptr()]
    if winding:
        args.insert(0, None if box is None else ctypes.addressof(box))
    return args, box


def _launch(counter: str, library: str, symbol: str, points: torch.Tensor,
            tri: torch.Tensor, winding: bool = True, options=None):
    """Run one sweep kernel on CUDA tensors and count it under ``counter``
    (the wrapper's key in :data:`LAUNCHES`: a key, not the function, so a
    wrapper that a profiler's labels replace still counts); returns the
    wrapper's outputs (winding zeros when the kernel computes none).
    ``options``: the sweep kernel's trailing arguments (:func:`_sweep_options`)."""
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    _check_inputs(points, tri)
    lib, fn = _entry(library, symbol)
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
            code = fn(points.data_ptr(), P, tri.data_ptr(), F, *outs, *(options or ()),
                      stream)
        cuda_build.check_launch(lib, code, symbol)
        profiling.count(counter)
    return torch.sqrt(d2), closest, fid, wind / _FOUR_PI


@torch.library.custom_op("pvt::closest_point_sweep", mutates_args=(), device_types="cpu")
def closest_point_sweep(points: torch.Tensor, tri: torch.Tensor,
                        exterior_box: Optional[List[float]], point_chunk: int,
                        tri_chunk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """``(dist [P], closest [P, 3], face_id [P] int32, winding [P])``: on
    the CPU the plain version (which ignores ``exterior_box``; the chunks
    apply to it only), on the card the kernel."""
    return mesh_closest_query(points, tri, point_chunk=point_chunk, tri_chunk=tri_chunk)


@closest_point_sweep.register_kernel("cuda")
def _closest_point_sweep_cuda(points, tri, exterior_box, point_chunk, tri_chunk):
    options, _box = _sweep_options(points, exterior_box, None, winding=True)
    return _launch(SWEEP, KERNEL, "pvt_closest_point_sweep", points, tri, options=options)


@closest_point_sweep.register_fake
def _closest_point_sweep_fake(points, tri, exterior_box, point_chunk, tri_chunk):
    _check_inputs(points, tri)
    P = points.shape[0]
    return (points.new_empty(P), points.new_empty((P, 3)),
            points.new_empty(P, dtype=torch.int32), points.new_empty(P))


def mesh_closest_query_cuda(points: torch.Tensor, tri: torch.Tensor,
                            exterior_box=None, counters: torch.Tensor = None,
                            point_chunk: int = DEFAULT_POINT_CHUNK,
                            tri_chunk: int = DEFAULT_TRI_CHUNK):
    """Closest point + winding number for ``points [P, 3]`` against
    triangles ``tri [Fp, 3, 3]`` (padding with ``mesh.PAD_COORD`` allowed).

    Returns ``(dist [P], closest [P, 3], face_id [P] int32, winding [P])``.

    - ``exterior_box`` ``[2, 3]``: give it only for a mesh with no boundary
      (``mesh.exterior_box``); warps of points all strictly outside it
      return winding 0 without summing.
    - ``counters``: an int64 tensor ``[2]`` on the device to which the
      launch adds the (point, real triangle) pairs whose closest point, and
      whose solid angle, it evaluated (a direct launch, for the probes; not
      through the custom op).

    The plain version (a CPU tensor) ignores these; the chunk sizes apply
    to it only.
    """
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {points.device}")
    if counters is not None and points.device.type == "cuda":
        options, _box = _sweep_options(points, exterior_box, counters, winding=True)
        return _launch(SWEEP, KERNEL, "pvt_closest_point_sweep", points, tri,
                       options=options)
    box = (None if exterior_box is None
           else np.asarray(exterior_box, dtype=np.float32).reshape(-1).tolist())
    return closest_point_sweep(points, tri, box, point_chunk, tri_chunk)


def mesh_closest_query_nowind_cuda(points: torch.Tensor, tri: torch.Tensor,
                                   counters: torch.Tensor = None, **plain_kwargs):
    """:func:`mesh_closest_query_cuda` without the winding sum: the same
    distances, closest points and face ids; the returned winding is all
    zeros (the kernel computes none)."""
    if points.device.type == "cpu":
        return mesh_closest_query(points, tri, winding=False, **plain_kwargs)
    options, _ = _sweep_options(points, None, counters, winding=False)
    return _launch(SWEEP_NOWIND, KERNEL,
                   "pvt_closest_point_sweep_nowind", points, tri, winding=False,
                   options=options)


def mesh_closest_query_mma_cuda(points: torch.Tensor, tri: torch.Tensor,
                                exterior_box=None, counters: torch.Tensor = None,
                                **plain_kwargs):
    """:func:`mesh_closest_query_cuda` with the pairwise products on the
    tensor cores (3xTF32, float32 accuracy): the same inputs, options and
    outputs (``mesh.PAD_COORD`` padding allowed anywhere), agreeing with
    its plain version ``mesh_closest_query_expanded`` to the products'
    rounding."""
    if points.device.type == "cpu":
        return mesh_closest_query_expanded(points, tri, **plain_kwargs)
    options, _box = _sweep_options(points, exterior_box, counters, winding=True)
    return _launch(SWEEP_MMA, MMA_KERNEL, "pvt_closest_point_sweep_mma",
                   points, tri, options=options)


def mesh_closest_query_contracted_cuda(points: torch.Tensor, tri: torch.Tensor,
                                       exterior_box=None, **plain_kwargs):
    """:func:`mesh_closest_query_cuda` from the same source built with
    multiply-add contraction (``-fmad=true``), for the roofline probe: it
    measures what the main path's ``-fmad=false`` costs.  Not bit-identical
    to the plain version."""
    if points.device.type == "cpu":
        return mesh_closest_query(points, tri, **plain_kwargs)
    options, _box = _sweep_options(points, exterior_box, None, winding=True)
    return _launch(SWEEP_CONTRACTED, "closest_point_fmad",
                   "pvt_closest_point_sweep", points, tri, options=options)


# each wrapper's key in ``utils.profiling.COUNTERS``
LAUNCHES = {mesh_closest_query_cuda: SWEEP, mesh_closest_query_nowind_cuda: SWEEP_NOWIND,
            mesh_closest_query_mma_cuda: SWEEP_MMA,
            mesh_closest_query_contracted_cuda: SWEEP_CONTRACTED}
