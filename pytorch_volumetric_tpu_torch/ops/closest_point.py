"""The closest-point + winding sweep as a hand-written CUDA kernel.

:func:`mesh_closest_query_cuda` is a drop-in equivalent of
``ops.point_triangle.mesh_closest_query``.  For a CUDA tensor it launches
the kernel in ``csrc/closest_point.cu`` (built at first use) on PyTorch's
current stream, or raises; for a CPU tensor it runs the plain version.
``mesh_closest_query_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_volumetric_tpu_torch.ops import cuda_build
from pytorch_volumetric_tpu_torch.ops.point_triangle import (
    _FOUR_PI, mesh_closest_query)

KERNEL = "closest_point"


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    fn = lib.pvt_closest_point_sweep
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, ctypes.c_int, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


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


def mesh_closest_query_cuda(points: torch.Tensor, tri: torch.Tensor,
                            **plain_kwargs):
    """Closest point + winding number for ``points [P, 3]`` against
    triangles ``tri [Fp, 3, 3]`` (padding with ``mesh.PAD_COORD`` allowed).

    Returns ``(dist [P], closest [P, 3], face_id [P] int32, winding [P])``.
    ``plain_kwargs`` (chunk sizes) apply to the plain version only.
    """
    if points.device.type == "cpu":
        return mesh_closest_query(points, tri, **plain_kwargs)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    _check_inputs(points, tri)
    lib = _lib()
    P, F = points.shape[0], tri.shape[0]
    dev = points.device
    d2 = torch.empty(P, dtype=torch.float32, device=dev)
    closest = torch.empty((P, 3), dtype=torch.float32, device=dev)
    fid = torch.empty(P, dtype=torch.int32, device=dev)
    wind = torch.empty(P, dtype=torch.float32, device=dev)
    if P:
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            code = lib.pvt_closest_point_sweep(
                points.data_ptr(), P, tri.data_ptr(), F, d2.data_ptr(),
                closest.data_ptr(), fid.data_ptr(), wind.data_ptr(), stream)
        cuda_build.check_launch(lib, code, "closest_point_sweep")
        mesh_closest_query_cuda.launches += 1
    return torch.sqrt(d2), closest, fid, wind / _FOUR_PI


mesh_closest_query_cuda.launches = 0
