"""The narrow-band query as a hand-written CUDA kernel.

:func:`narrow_band_query_cuda` (``csrc/narrow_band.cu``) is the drop-in
equivalent of the plain version ``ops.narrow_band._query_impl``.  For a
CUDA tensor it launches the kernel on PyTorch's current stream (the library
is built from ``csrc/`` at first use), or raises; for a CPU tensor it runs
the plain version.  One call launches one device kernel on the current
stream, without a host sync, and counts one in ``.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pytorch_volumetric_tpu_torch.ops import cuda_build
from pytorch_volumetric_tpu_torch.ops.narrow_band import (
    NarrowBandBig, NarrowBandSmalls, _query_impl, inverse_res)

KERNEL = "narrow_band"
_SYMBOL = "pvt_narrow_band_query"
_p, _i = ctypes.c_void_p, ctypes.c_int


def _entry():
    lib = cuda_build.load(KERNEL)
    fn = getattr(lib, _SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = [_p, _i, _p, _p, _p, _p, _i, _p, _p, _p, _p, _p]
        fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(big: NarrowBandBig, points: torch.Tensor) -> None:
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [P, 3], got {tuple(points.shape)}")
    meta, cand, pseudo = big
    shapes = ((meta.ndim == 2 and meta.shape[1] == 5), (cand.ndim == 3 and cand.shape[2] == 10),
              (pseudo.ndim == 2 and pseudo.shape[1] == 21))
    if not all(shapes):
        raise ValueError("tables must be meta [C, 5], cand [S, K, 10] and pseudo [F, 21]")
    for name, t in (("points", points), ("meta", meta), ("cand", cand), ("pseudo", pseudo)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != points.device:
            raise ValueError("points and the tables must be on the same device")
    if cand.data_ptr() % 8:
        raise ValueError("cand must be 8-byte aligned (the kernel reads rows in 8-byte words)")
    if points.shape[0] >= 2 ** 31:
        raise ValueError("too many points for 32-bit indexing")


def _grid_args(smalls: NarrowBandSmalls, surface_normal_eps: float):
    """The kernel's grid arguments as ctypes arrays (16 floats, 6 ints)."""
    bb = smalls.bb.numpy().astype(np.float32)
    floats = np.concatenate([smalls.lo.numpy(), inverse_res(smalls).numpy(),
                             smalls.res.numpy(), bb[:, 0], bb[:, 1],
                             [surface_normal_eps]]).astype(np.float32)
    ints = np.concatenate([smalls.dims.numpy(), smalls.strides.numpy()]).astype(np.int32)
    return (ctypes.c_float * 16)(*floats.tolist()), (ctypes.c_int * 6)(*ints.tolist())


def narrow_band_query_cuda(smalls: NarrowBandSmalls, big: NarrowBandBig,
                           points: torch.Tensor, surface_normal_eps: float = 1e-3,
                           with_slots: bool = False):
    """``points [P, 3] -> (val [P], grad [P, 3], slot [P] int32 or
    None)``: the signed distance, its gradient and, with ``with_slots``,
    each point's candidate slot (-1 far field, -2 outside the grid).
    ``smalls`` are CPU tensors; ``big`` lies on the points' device."""
    if points.device.type == "cpu":
        val, grad, slot = _query_impl(smalls, big, points, surface_normal_eps)
        return val, grad, slot if with_slots else None
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    _check_inputs(big, points)
    lib, fn = _entry()
    P, K = points.shape[0], big.cand.shape[1]
    dev = points.device
    val = torch.empty(P, dtype=torch.float32, device=dev)
    grad = torch.empty((P, 3), dtype=torch.float32, device=dev)
    slot = torch.empty(P, dtype=torch.int32, device=dev) if with_slots else None
    if P:
        grid_f, grid_i = _grid_args(smalls, surface_normal_eps)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            code = fn(points.data_ptr(), P, ctypes.addressof(grid_f), ctypes.addressof(grid_i),
                      big.meta.data_ptr(), big.cand.data_ptr(), K, big.pseudo.data_ptr(),
                      val.data_ptr(), grad.data_ptr(),
                      None if slot is None else slot.data_ptr(), stream)
        cuda_build.check_launch(lib, code, _SYMBOL)
        narrow_band_query_cuda.launches += 1
    return val, grad, slot


narrow_band_query_cuda.launches = 0
