"""The coherent per-tile trilinear union as a hand-written CUDA kernel.

:func:`coherent_union_tile_tri` (``csrc/coherent_union_tri.cu``, CU-T) is
the drop-in equivalent of the plain versions ``sdf._union_tile_tri_eval``
(value, object- and link-frame gradients and winner of every point of the
multi-child trilinear union) and ``sdf._union_values_tri_eval`` (values
only), each after ``transforms.transform_points`` of the world points by
the children's ``obj_to_link`` rows.  The kernel forms each link-frame
point in registers and stores none, and keeps the 8-corner lerps out of
device memory.  For CUDA tensors it launches the kernel on PyTorch's
current stream (the library is built from ``csrc/`` at first use, beside
the nearest union's, whose poison pass it calls), or raises; for CPU
tensors it runs the plain version.  One call launches the kernel once,
counted in ``utils.profiling.COUNTERS["kernel.coherent_union_tile_tri"]``;
with more than three children it also runs a ``cumsum`` of the per-tile
middle flags and the nearest union's poison pass, which put NaN in the
middle tiles beyond the residual lane's capacity.  Neither waits for the
device.

The wrapper reaches the kernel through the registered custom op
``pvt::coherent_union_tile_tri`` (CUDA: the kernel; CPU: the plain
version, which ``sdf`` registers; a fake implementation gives the outputs'
shapes), with each child's tables as lists of tensors, so ``torch.export``
keeps the union as one opaque node.  Its checks, its launch and the device
array of table pointers through which the kernel reads the tables in place
are the nearest union's (:mod:`ops.coherent_union`).
The union's backward is the nearest union's
(``ops.straight_through.tile_winner_straight_through``), which takes the
winners and their link-frame gradients that this op returns.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from pytorch_volumetric_tpu_torch.ops import coherent_union as cu
from pytorch_volumetric_tpu_torch.ops import cuda_build

KERNEL = "coherent_union_tri"
_TILE = "pvt_coherent_union_tile_tri"
# the per-child fields the kernel reads, in the order of its pointer array
FIELDS = ("lo", "inv_res", "n", "strides", "bstrides", "bb", "tbricks", "tgbricks", "vg")
# the row shapes of the 5x5x5 value and gradient bricks and the packed rows
_ROWS = {"tbricks": (125,), "tgbricks": (3, 125), "vg": (4,)}
_p, _i = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _entry():
    """``(lib, tile)``, loaded once a process."""
    # both libraries in one parallel build: the poison pass is the nearest
    # union's, and so are the backward's kernels
    cuda_build.build([KERNEL, cu.KERNEL])
    lib = cuda_build.load(KERNEL)
    tile = getattr(lib, _TILE)
    tile.argtypes = [_p, _p, _p, _p, _i, _i, _i, _i, _i, _p, _p, _p, _p, _p, _p, _p]
    tile.restype = ctypes.c_int
    return lib, tile


def _coherent_union_tile_tri_op_cuda(
        points: torch.Tensor, T: torch.Tensor, Rb: torch.Tensor, lo: List[torch.Tensor],
        inv_res: List[torch.Tensor], n: List[torch.Tensor], strides: List[torch.Tensor],
        bstrides: List[torch.Tensor], bb: List[torch.Tensor], tbricks: List[torch.Tensor],
        tgbricks: List[torch.Tensor], vg: List[torch.Tensor], seg: int, capacity: int,
        values_only: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(val [B, FS, seg], g_obj [B, FS, seg, 3], win [B, FS, seg] int64,
    g_link [B, FS, seg, 3])`` of the per-tile trilinear union of the world
    ``points [FS * seg, 3]`` in the children's frames ``T[c, b] @ points``
    (``T [C, B, 4, 4]``), with rotations ``Rb [C, B, 3, 3]``; with
    ``values_only`` just ``val`` and three empty tensors (``Rb`` and
    ``tgbricks`` unread).  ``capacity``: the residual lane's capacity in
    tiles; the middle tiles beyond it get NaN gradients.  The kernel."""
    fields = dict(zip(FIELDS, (lo, inv_res, n, strides, bstrides, bb, tbricks, tgbricks, vg)))
    return cu._launch_union(lambda: _entry() + (_TILE,), FIELDS, _ROWS,
                            "kernel.coherent_union_tile_tri", points, T, Rb, fields, seg,
                            capacity, values_only)


# the op's CUDA kernel; ``sdf`` registers its CPU kernel, the plain version
coherent_union_tile_tri_op = torch.library.custom_op(
    "pvt::coherent_union_tile_tri", _coherent_union_tile_tri_op_cuda, mutates_args=(),
    device_types="cuda")


@coherent_union_tile_tri_op.register_fake
def _coherent_union_tile_tri_op_fake(points, T, Rb, lo, inv_res, n, strides, bstrides, bb,
                                     tbricks, tgbricks, vg, seg, capacity, values_only):
    B, FS = T.shape[1], points.shape[0] // seg
    if values_only:
        e = points.new_empty(0)
        return points.new_empty((B, FS, seg)), e, e.to(torch.int64), e.clone()
    return (points.new_empty((B, FS, seg)), points.new_empty((B, FS, seg, 3)),
            points.new_empty((B, FS, seg), dtype=torch.int64),
            points.new_empty((B, FS, seg, 3)))


def op_args(tables: Sequence, values_only: bool = False) -> List[List[torch.Tensor]]:
    """The op's per-child table lists, in :data:`FIELDS` order (no gradient
    bricks with ``values_only``).  Raises ``ValueError`` for tables without
    the trilinear union's bricks."""
    need = ("tbricks",) if values_only else ("tbricks", "tgbricks")
    for name in need:
        if any(getattr(t, name) is None for t in tables):
            raise ValueError(f"the trilinear union's tables lack {name}; pass "
                             "sdf.coherent_fast_tables(children)")
    return [[] if name == "tgbricks" and values_only
            else [getattr(t, name).contiguous() for t in tables] for name in FIELDS]


def coherent_union_tile_tri(tables: Sequence, points: torch.Tensor, T: torch.Tensor, seg: int,
                            Rb: torch.Tensor = None, capacity: int = None,
                            values_only: bool = False):
    """The per-tile trilinear union of the children's ``sdf._CoherentTables``
    (with ``tbricks`` and ``tgbricks``) over the world ``points [FS * seg,
    3]`` in ``seg``-point tiles, each child's points ``T[c] @ points`` (``T
    [C, B, 4, 4]``, its obj_to_link rows; all detached): ``(val, g_obj, win,
    g_link)`` with the rotations ``Rb [C, B, 3, 3]`` and the residual
    lane's ``capacity`` in tiles (``sdf.residual_capacity`` of ``B * FS``),
    or ``val [B, FS, seg]`` alone with ``values_only``."""
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {points.device}")
    if values_only:
        Rb, capacity = points.new_empty(0), 0
    elif Rb is None or capacity is None:
        raise ValueError("the forward takes the rotations Rb and the residual lane's capacity")
    p = points.to(T.dtype)  # as transforms.transform_points takes them
    out = coherent_union_tile_tri_op(p.contiguous(), T.contiguous(), Rb.contiguous(),
                                     *op_args(tables, values_only), int(seg), int(capacity),
                                     bool(values_only))
    return out[0] if values_only else out
