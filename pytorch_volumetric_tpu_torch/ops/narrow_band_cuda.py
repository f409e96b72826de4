"""The narrow-band query as a hand-written CUDA kernel.

:func:`narrow_band_query_cuda` (``csrc/narrow_band.cu``) is the drop-in
equivalent of the plain version ``ops.narrow_band._query_impl``.  For a
CUDA tensor it launches the kernel on PyTorch's current stream (the library
is built from ``csrc/`` at first use), or raises; for a CPU tensor it runs
the plain version.  One call launches one device kernel on the current
stream, without a host sync, and counts one in
``utils.profiling.COUNTERS["kernel.narrow_band_query"]``.

The wrapper reaches the kernel through the registered custom op
``pvt::narrow_band_query`` (CPU: the plain version; CUDA: the kernel; a
fake implementation gives the outputs' shapes), with the small grid fields
as lists of numbers, so ``torch.export`` keeps the query as one opaque node
that a loaded program dispatches to the kernel on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from pytorch_volumetric_tpu_torch.ops import cuda_build
from pytorch_volumetric_tpu_torch.utils import profiling
from pytorch_volumetric_tpu_torch.ops.narrow_band import (
    NarrowBandBig, NarrowBandSmalls, _query_impl)

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


def grid_lists(smalls: NarrowBandSmalls) -> Tuple[List[float], List[int]]:
    """The grid fields as the op's arguments: ``lo, res, bb`` (12 floats,
    ``bb`` row-major) and ``dims, strides`` (6 ints).  Each float32 value
    goes through a Python float unchanged."""
    floats = (smalls.lo.tolist() + smalls.res.tolist()
              + smalls.bb.to(torch.float32).reshape(-1).tolist())
    return floats, smalls.dims.tolist() + smalls.strides.tolist()


def _smalls(grid_f: List[float], grid_i: List[int]) -> NarrowBandSmalls:
    """:func:`grid_lists`' inverse: the grid fields as CPU tensors."""
    f = torch.tensor(grid_f, dtype=torch.float32)
    i = torch.tensor(grid_i, dtype=torch.int32)
    return NarrowBandSmalls(f[0:3], f[3:6], i[0:3], i[3:6], f[6:12].reshape(3, 2))


def _grid_args(grid_f: List[float], grid_i: List[int], surface_normal_eps: float):
    """The kernel's grid arguments as ctypes arrays: lo, ``inverse_res``'s
    f32(1 / res), res, the box's low and high corners and the epsilon (16
    floats); dims and strides (6 ints)."""
    bb = np.asarray(grid_f[6:12], dtype=np.float32).reshape(3, 2)
    inv_res = np.float32(1.0) / np.asarray(grid_f[3:6], dtype=np.float32)
    floats = np.concatenate([grid_f[0:3], inv_res, grid_f[3:6], bb[:, 0], bb[:, 1],
                             [surface_normal_eps]]).astype(np.float32)
    return (ctypes.c_float * 16)(*floats.tolist()), (ctypes.c_int * 6)(*grid_i)


@torch.library.custom_op("pvt::narrow_band_query", mutates_args=(), device_types="cpu")
def narrow_band_query_op(points: torch.Tensor, meta: torch.Tensor, cand: torch.Tensor,
                         pseudo: torch.Tensor, grid_f: List[float], grid_i: List[int],
                         surface_normal_eps: float, with_slots: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(val [P], grad [P, 3], slot)``, ``slot [P]`` int32 with
    ``with_slots``, else empty: on the CPU the plain version, on the card
    the kernel.  ``grid_f`` / ``grid_i``: :func:`grid_lists`."""
    val, grad, slot = _query_impl(_smalls(grid_f, grid_i), NarrowBandBig(meta, cand, pseudo),
                                  points, surface_normal_eps)
    return val, grad, slot if with_slots else slot.new_empty(0)


@narrow_band_query_op.register_kernel("cuda")
def _narrow_band_query_op_cuda(points, meta, cand, pseudo, grid_f, grid_i,
                               surface_normal_eps, with_slots):
    big = NarrowBandBig(meta, cand, pseudo)
    _check_inputs(big, points)
    lib, fn = _entry()
    P, K = points.shape[0], cand.shape[1]
    dev = points.device
    val = torch.empty(P, dtype=torch.float32, device=dev)
    grad = torch.empty((P, 3), dtype=torch.float32, device=dev)
    slot = torch.empty(P if with_slots else 0, dtype=torch.int32, device=dev)
    if P:
        grid_fa, grid_ia = _grid_args(grid_f, grid_i, surface_normal_eps)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            code = fn(points.data_ptr(), P, ctypes.addressof(grid_fa), ctypes.addressof(grid_ia),
                      meta.data_ptr(), cand.data_ptr(), K, pseudo.data_ptr(),
                      val.data_ptr(), grad.data_ptr(),
                      slot.data_ptr() if with_slots else None, stream)
        cuda_build.check_launch(lib, code, _SYMBOL)
        profiling.count("kernel.narrow_band_query")
    return val, grad, slot


@narrow_band_query_op.register_fake
def _narrow_band_query_op_fake(points, meta, cand, pseudo, grid_f, grid_i,
                               surface_normal_eps, with_slots):
    P = points.shape[0]
    return (points.new_empty(P), points.new_empty((P, 3)),
            points.new_empty(P if with_slots else 0, dtype=torch.int32))


def narrow_band_query_cuda(smalls: NarrowBandSmalls, big: NarrowBandBig,
                           points: torch.Tensor, surface_normal_eps: float = 1e-3,
                           with_slots: bool = False, grid=None):
    """``points [P, 3] -> (val [P], grad [P, 3], slot [P] int32 or
    None)``: the signed distance, its gradient and, with ``with_slots``,
    each point's candidate slot (-1 far field, -2 outside the grid).
    ``smalls`` are CPU tensors; ``big`` lies on the points' device.
    ``grid``: ``grid_lists(smalls)`` when the caller holds it (an SDF
    computes it once, so that an exported query reads no tensor on the
    host)."""
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {points.device}")
    grid_f, grid_i = grid_lists(smalls) if grid is None else grid
    val, grad, slot = narrow_band_query_op(points, big.meta, big.cand, big.pseudo, grid_f,
                                           grid_i, float(surface_normal_eps), bool(with_slots))
    return val, grad, slot if with_slots else None

