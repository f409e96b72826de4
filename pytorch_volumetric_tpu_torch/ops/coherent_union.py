"""The coherent per-tile nearest union as a hand-written CUDA kernel.

:func:`coherent_union_tile` (``csrc/coherent_union.cu``) is the drop-in
equivalent of the plain versions ``sdf._union_tile_eval`` (value, object-
and link-frame gradients and winner of every point of a per-tile winner
union) and ``sdf._union_values_eval`` (values only), each after
``transforms.transform_points`` of the world points by the children's
``obj_to_link`` rows.  The kernel forms each link-frame point in registers
and stores none.  For CUDA tensors it
launches the kernel on PyTorch's current stream (the library is built from
``csrc/`` at first use), or raises; for CPU tensors it runs the plain
version.  One call launches the union kernel once, counted in
``utils.profiling.COUNTERS["kernel.coherent_union_tile"]``; with more than
three children it also runs a ``cumsum`` of the per-tile middle flags and
the kernel's poison pass, which put NaN in the middle tiles beyond the
residual lane's capacity.  Neither waits for the device.

The wrapper reaches the kernel through the registered custom op
``pvt::coherent_union_tile`` (CUDA: the kernel; CPU: the plain version,
which ``sdf`` registers, so that this module knows nothing of ``sdf``; a
fake implementation gives the outputs' shapes), with each child's tables
as lists of tensors, so ``torch.export`` keeps the union as one opaque node
that a loaded program dispatches to the kernel on the card.  The kernel
reads the tables in place through a device array of their pointers, built
once for each set of tables (cached by the pointers themselves, so an
entry never holds other content than its key says).

:func:`tile_union_cotangents` is the union's backward: from the winners,
the winners' link-frame gradients and the outputs' cotangents straight to
the cotangents of the children's ``obj_to_link`` rows and rotations.  On
float32 CUDA tensors it launches the backward kernels of the same library
(counted in ``COUNTERS["kernel.tile_union_backward"]``, one a call), else
it runs the plain version :func:`tile_union_cotangents_plain`.
"""

from __future__ import annotations

import ctypes
import math
from collections import OrderedDict
from typing import List, Sequence, Tuple

import torch

from pytorch_volumetric_tpu_torch.ops import cuda_build
from pytorch_volumetric_tpu_torch.utils import profiling

KERNEL = "coherent_union"
_TILE, _POISON = "pvt_coherent_union_tile", "pvt_coherent_union_poison"
_BACKWARD = "pvt_tile_union_backward"
_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the per-child fields the kernel reads, in the order of its pointer array
FIELDS = ("lo", "inv_res", "n", "strides", "bstrides", "bb", "bricks", "gbricks", "vg")
_SHAPES = {"lo": ((3,), torch.float32), "inv_res": ((3,), torch.float32),
           "n": ((3,), torch.int64), "strides": ((3,), torch.int64),
           "bstrides": ((3,), torch.int64), "bb": ((3, 2), torch.float32)}
# the row shapes of the per-child tables
_ROWS = {"bricks": (64,), "gbricks": (3, 64), "vg": (4,)}
_DESC_CACHE: "OrderedDict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = OrderedDict()
_DESC_CACHE_SIZE = 64


def _entry():
    lib = cuda_build.load(KERNEL)
    tile, poison = getattr(lib, _TILE), getattr(lib, _POISON)
    if tile.argtypes is None:
        tile.argtypes = [_p, _p, _p, _p, _i, _i, _i, _i, _i, _p, _p, _p, _p, _p, _p, _p]
        tile.restype = ctypes.c_int
        poison.argtypes = [_p, _p, _i, _ll, _i, _p, _p, _p, _p]
        poison.restype = ctypes.c_int
        backward, scratch = getattr(lib, _BACKWARD), lib.pvt_tile_union_backward_scratch
        backward.argtypes = [_p, _p, _p, _p, _p, _i, _i, _ll, _p, _p, _p, _p]
        backward.restype = ctypes.c_int
        scratch.argtypes = [_i, _i, _ll]
        scratch.restype = ctypes.c_longlong
    return lib, tile, poison


def _check_inputs(points: torch.Tensor, T: torch.Tensor, seg: int, Rb: torch.Tensor,
                  fields: dict, values_only: bool, names: Sequence[str], rows: dict) -> None:
    """Raise unless the inputs are what a union kernel takes: ``fields``
    holds each child's tables under ``names`` (the kernel's pointer order,
    the gradient bricks second to last), the row shapes of its tables in
    ``rows``."""
    if points.dim() != 2 or points.shape[-1] != 3:
        raise ValueError(f"points must be [F, 3], got {tuple(points.shape)}")
    if seg < 1 or points.shape[0] % seg:
        raise ValueError(f"points count {points.shape[0]} must be a multiple of seg={seg}")
    if T.dim() != 4 or tuple(T.shape[2:]) != (4, 4):
        raise ValueError(f"T must be [C, B, 4, 4], got {tuple(T.shape)}")
    C, B = T.shape[:2]
    named = [("points", points), ("T", T)]
    if not values_only:
        if tuple(Rb.shape) != (C, B, 3, 3):
            raise ValueError(f"Rb must be [C, B, 3, 3] = {(C, B, 3, 3)}, got {tuple(Rb.shape)}")
        named.append(("Rb", Rb))
    for name in names:
        ts = fields[name]
        if name == names[-2] and values_only:
            continue
        if len(ts) != C:
            raise ValueError(f"{name}: {len(ts)} tensors for {C} children")
        for c, t in enumerate(ts):
            shape, dtype = _SHAPES.get(name, (None, torch.float32))
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"{name}[{c}] must be {shape}, got {tuple(t.shape)}")
            if shape is None:
                want = rows[name]
                if t.dim() != len(want) + 1 or tuple(t.shape[1:]) != want:
                    raise ValueError(f"{name}[{c}] must be [rows, {', '.join(map(str, want))}]"
                                     f", got {tuple(t.shape)}")
            if t.dtype != dtype:
                raise TypeError(f"{name}[{c}] must be {dtype}, got {t.dtype}")
            named.append((f"{name}[{c}]", t))
    for name, t in named:
        if name in ("points", "T", "Rb") and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != points.device:
            raise ValueError(f"{name} lies on {t.device}, points on {points.device}")
    if max(B, points.shape[0] // seg, seg) >= 2 ** 31:
        raise ValueError("B, FS and seg must each fit 32 bits")
    if points.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {points.device}")


def _descriptor(fields: dict, device: torch.device, names: Sequence[str]) -> torch.Tensor:
    """The device array ``[C, 9]`` int64 of each child's table pointers (in
    the order of ``names``; 0 for a missing gradient brick table), copied
    once for each set of pointers."""
    C = len(fields["vg"])
    ptrs = tuple(fields[name][c].data_ptr() if fields[name] else 0
                 for c in range(C) for name in names)
    key = (device.index, ptrs)
    hit = _DESC_CACHE.get(key)
    if hit is not None:
        _DESC_CACHE.move_to_end(key)
        return hit[1]
    host = torch.tensor(ptrs, dtype=torch.int64).pin_memory()
    desc = host.to(device, non_blocking=True)
    _DESC_CACHE[key] = (host, desc)  # the pinned source lives until the copy has run
    if len(_DESC_CACHE) > _DESC_CACHE_SIZE:
        _DESC_CACHE.popitem(last=False)
    return desc


def _launch_union(entry, names: Sequence[str], rows: dict, counter: str, points: torch.Tensor,
                  T: torch.Tensor, Rb: torch.Tensor, fields: dict, seg: int, capacity: int,
                  values_only: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """One call of a per-tile union kernel, CU's or CU-T's
    (``ops.coherent_union_tri``): checks the inputs (``names`` and ``rows``
    describe the kernel's per-child ``fields``, :func:`_check_inputs`), then
    ``entry()`` gives the kernel's library, C entry and name.  Allocates the
    outputs, launches the kernel once (counted under ``counter``) and, with
    more than three children, the cumsum of the middle flags and this
    library's poison pass."""
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    _check_inputs(points, T, seg, Rb, fields, values_only, names, rows)
    lib, tile, name = entry()
    cu_lib, _, poison = _entry()
    C, B = T.shape[:2]
    FS = points.shape[0] // seg
    dev = points.device
    N = B * FS * seg
    val = torch.empty((B, FS, seg), dtype=torch.float32, device=dev)
    if values_only:
        e = val.new_empty(0)
        g_obj, win, g_link = e, e.to(torch.int64), e.clone()
    else:
        g_obj = torch.empty((B, FS, seg, 3), dtype=torch.float32, device=dev)
        win = torch.empty((B, FS, seg), dtype=torch.int64, device=dev)
        g_link = torch.empty_like(g_obj)
    lane = not values_only and C > 3  # the residual lane's middle tiles
    middle = torch.empty(B * FS if lane else 0, dtype=torch.int32, device=dev)
    mask = torch.empty(N if lane else 0, dtype=torch.uint8, device=dev)
    if N:
        if values_only:
            fields[names[-2]] = []
        desc = _descriptor(fields, dev, names)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            code = tile(points.data_ptr(), T.data_ptr(), None if values_only else Rb.data_ptr(),
                        desc.data_ptr(), C, B, FS, seg, int(values_only), val.data_ptr(),
                        g_obj.data_ptr(), win.data_ptr(), g_link.data_ptr(),
                        middle.data_ptr(), mask.data_ptr(), stream)
            cuda_build.check_launch(lib, code, name)
            profiling.count(counter)
            if lane:
                rank = torch.cumsum(middle, 0, dtype=torch.int32)
                code = poison(middle.data_ptr(), rank.data_ptr(), seg, N, capacity,
                              mask.data_ptr(), g_obj.data_ptr(), g_link.data_ptr(), stream)
                cuda_build.check_launch(cu_lib, code, _POISON)
    return val, g_obj, win, g_link


def _coherent_union_tile_op_cuda(
        points: torch.Tensor, T: torch.Tensor, Rb: torch.Tensor, lo: List[torch.Tensor],
        inv_res: List[torch.Tensor], n: List[torch.Tensor], strides: List[torch.Tensor],
        bstrides: List[torch.Tensor], bb: List[torch.Tensor], bricks: List[torch.Tensor],
        gbricks: List[torch.Tensor], vg: List[torch.Tensor], seg: int, capacity: int,
        values_only: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(val [B, FS, seg], g_obj [B, FS, seg, 3], win [B, FS, seg] int64,
    g_link [B, FS, seg, 3])`` of the per-tile nearest union of the world
    ``points [FS * seg, 3]`` in the children's frames, ``T[c, b] @ points``
    (``T [C, B, 4, 4]``, the children's obj_to_link rows), with rotations
    ``Rb [C, B, 3, 3]``; with ``values_only`` just ``val`` and three empty
    tensors (``Rb`` and ``gbricks`` unread).  ``capacity``: the residual
    lane's capacity in tiles; the middle tiles beyond it get NaN gradients.
    The kernel."""
    fields = dict(zip(FIELDS, (lo, inv_res, n, strides, bstrides, bb, bricks, gbricks, vg)))
    return _launch_union(lambda: _entry()[:2] + (_TILE,), FIELDS, _ROWS,
                         "kernel.coherent_union_tile", points, T, Rb, fields, seg, capacity,
                         values_only)


# the op's CUDA kernel; ``sdf`` registers its CPU kernel, the plain version
coherent_union_tile_op = torch.library.custom_op(
    "pvt::coherent_union_tile", _coherent_union_tile_op_cuda, mutates_args=(),
    device_types="cuda")


@coherent_union_tile_op.register_fake
def _coherent_union_tile_op_fake(points, T, Rb, lo, inv_res, n, strides, bstrides, bb, bricks,
                                 gbricks, vg, seg, capacity, values_only):
    B, FS = T.shape[1], points.shape[0] // seg
    if values_only:
        e = points.new_empty(0)
        return points.new_empty((B, FS, seg)), e, e.to(torch.int64), e.clone()
    return (points.new_empty((B, FS, seg)), points.new_empty((B, FS, seg, 3)),
            points.new_empty((B, FS, seg), dtype=torch.int64),
            points.new_empty((B, FS, seg, 3)))


def op_args(tables: Sequence, values_only: bool = False) -> List[List[torch.Tensor]]:
    """The op's per-child table lists, in :data:`FIELDS` order (no gradient
    bricks with ``values_only``)."""
    return [[] if name == "gbricks" and values_only
            else [getattr(t, name).contiguous() for t in tables] for name in FIELDS]


def coherent_union_tile(tables: Sequence, points: torch.Tensor, T: torch.Tensor, seg: int,
                        Rb: torch.Tensor = None, capacity: int = None,
                        values_only: bool = False):
    """The per-tile nearest union of the children's ``sdf._CoherentTables``
    over the world ``points [FS * seg, 3]`` in ``seg``-point tiles, each
    child's points ``T[c] @ points`` (``T [C, B, 4, 4]``, its obj_to_link
    rows; all detached): ``(val, g_obj, win, g_link)`` with the rotations
    ``Rb [C, B, 3, 3]`` and the residual lane's ``capacity`` in tiles
    (``sdf.residual_capacity`` of ``B * FS``), or ``val [B, FS, seg]``
    alone with ``values_only``."""
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {points.device}")
    if values_only:
        Rb, capacity = points.new_empty(0), 0
    elif Rb is None or capacity is None:
        raise ValueError("the forward takes the rotations Rb and the residual lane's capacity")
    p = points.to(T.dtype)  # as transforms.transform_points takes them
    out = coherent_union_tile_op(p.contiguous(), T.contiguous(), Rb.contiguous(),
                                 *op_args(tables, values_only), int(seg), int(capacity),
                                 bool(values_only))
    return out[0] if values_only else out


def tile_union_cotangents_plain(win: torch.Tensor, g_link: torch.Tensor, ct_val: torch.Tensor,
                                ct_g: torch.Tensor, points: torch.Tensor, n_children: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`tile_union_cotangents`: each point's 21
    terms summed into its winner's ``(b, c)`` with ``index_add_``; a term
    that the dense formula's 0/1 mask made NaN for the other children (a
    non-finite ``ct_val * g_link[o]``, ``ct_g[o]``, ``g_link[i]`` or
    ``points[p, j]``) makes their sum NaN."""
    C, B = n_children, win.shape[0]
    w = win.reshape(B, -1)
    N = w.shape[1]
    g, cg = g_link.reshape(B, N, 3), ct_g.reshape(B, N, 3)
    q = ct_val.reshape(B, N, 1) * g
    p = points.reshape(1, N, 3).expand(B, N, 3)
    terms = torch.cat([torch.cat([q[..., :, None] * p[..., None, :], q[..., :, None]], -1)
                       .reshape(B, N, 12), (cg[..., :, None] * g[..., None, :]).reshape(B, N, 9)],
                      -1)
    bad_q, bad_p = ~torch.isfinite(q), ~torch.isfinite(p)
    bad_g, bad_cg = ~torch.isfinite(g), ~torch.isfinite(cg)
    bad_T = bad_q[..., :, None] | torch.cat([bad_p, torch.zeros_like(bad_p[..., :1])],
                                            -1)[..., None, :]
    bad = torch.cat([bad_T.reshape(B, N, 12),
                     (bad_cg[..., :, None] | bad_g[..., None, :]).reshape(B, N, 9)], -1)
    # each point's (b, winner) row; a winner outside [0, C) is no child's
    valid = (w >= 0) & (w < C)
    slot = torch.where(valid, torch.arange(B, device=w.device)[:, None] * C + w, B * C).reshape(-1)
    sums = terms.new_zeros((B * C + 1, 21)).index_add_(0, slot, terms.reshape(-1, 21))
    own_bad = torch.zeros((B * C + 1, 21), dtype=torch.int64, device=w.device).index_add_(
        0, slot, bad.reshape(-1, 21).to(torch.int64))
    others_bad = bad.sum(1, dtype=torch.int64)[:, None, :] - own_bad[:-1].view(B, C, 21)
    sums = torch.where(others_bad > 0, float("nan"), sums[:-1].view(B, C, 21))
    d_T = torch.cat([sums[..., :12].reshape(B, C, 3, 4), sums.new_zeros((B, C, 1, 4))], -2)
    return (d_T.transpose(0, 1).contiguous(),
            sums[..., 12:].reshape(B, C, 3, 3).transpose(0, 1).contiguous())


def tile_union_point_cotangents(win: torch.Tensor, g_link: torch.Tensor, ct_val: torch.Tensor,
                                R: torch.Tensor) -> torch.Tensor:
    """The world points' cotangent ``[FS * seg, 3]`` of the per-tile union
    whose children's link-frame points are ``R[c, b] @ points + t[c, b]``
    (``R [C, B, 3, 3]``): the sum over configurations of ``R[win]^T
    (ct_val * g_link)``, each point's winner's rotation gathered.  The
    other children's terms are 0, or NaN where the dense formula's 0/1 mask
    met a non-finite factor: a non-finite ``ct_val * g_link[o]`` makes all
    three entries NaN, a non-finite ``R[c, b][o, j]`` of another child
    entry ``j``."""
    C, B = R.shape[:2]
    w = win.reshape(B, -1)
    q = ct_val.reshape(w.shape + (1,)) * g_link.reshape(w.shape + (3,))
    valid = (w >= 0) & (w < C)
    rows = torch.arange(B, device=w.device)[:, None]
    Rw = R.transpose(0, 1)[rows, w.clamp(0, C - 1)]                   # [B, N, 3, 3]
    d = torch.where(valid[..., None], (q[..., :, None] * Rw).sum(-2), 0)
    bad_R = (~torch.isfinite(R)).any(-2).transpose(0, 1).to(torch.int64)  # [B, C, 3]
    others_R = bad_R.sum(1)[:, None, :] - torch.where(valid[..., None], bad_R[rows, w.clamp(
        0, C - 1)], 0)
    others = C - valid.to(torch.int64)
    bad = ((others > 0) & (~torch.isfinite(q)).any(-1))[..., None] | (others_R > 0)
    return torch.where(bad, float("nan"), d).sum(0)


def _tile_union_cotangents_cuda(win, g_link, ct_val, ct_g, points, n_children):
    """:func:`tile_union_cotangents` by the backward kernels."""
    B = win.shape[0]
    N = win.numel() // B if B else 0
    named = {"g_link": (g_link, (B, N, 3)), "ct_val": (ct_val, (B, N)),
             "ct_g": (ct_g, (B, N, 3)), "points": (points, (N, 3))}
    if win.dtype != torch.int64:
        raise TypeError(f"win must be int64, got {win.dtype}")
    for name, (t, shape) in named.items():
        if t.numel() != math.prod(shape):
            raise ValueError(f"{name} must hold {shape} elements, got {tuple(t.shape)}")
        if t.device != win.device:
            raise ValueError(f"{name} lies on {t.device}, win on {win.device}")
    if max(B, n_children) >= 2 ** 31:
        raise ValueError("B and the number of children must each fit 32 bits")
    lib, _, _ = _entry()
    dev = win.device
    d_T = torch.empty((n_children, B, 4, 4), dtype=torch.float32, device=dev)
    d_Rb = torch.empty((n_children, B, 3, 3), dtype=torch.float32, device=dev)
    if n_children and B:
        scratch = torch.empty(lib.pvt_tile_union_backward_scratch(n_children, B, N),
                              dtype=torch.float32, device=dev)
        args = [t.contiguous() for t in (win, g_link, ct_val, ct_g, points)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            code = getattr(lib, _BACKWARD)(*(t.data_ptr() for t in args), n_children, B, N,
                                           scratch.data_ptr(), d_T.data_ptr(),
                                           d_Rb.data_ptr(), stream)
            cuda_build.check_launch(lib, code, _BACKWARD)
        profiling.count("kernel.tile_union_backward")
    return d_T, d_Rb


def tile_union_cotangents(win: torch.Tensor, g_link: torch.Tensor, ct_val: torch.Tensor,
                          ct_g: torch.Tensor, points: torch.Tensor, n_children: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-tile union's backward: ``(d_T [C, B, 4, 4], d_Rb [C, B, 3,
    3])``, the cotangents of the children's ``obj_to_link`` rows ``T`` and
    link -> object rotations ``Rb``, from the winners ``win [B, FS, seg]``
    (in ``[0, C)``), their link-frame gradients ``g_link [B, FS, seg, 3]``,
    the cotangents ``ct_val [B, FS, seg]`` of the values and ``ct_g [B, FS,
    seg, 3]`` of the object-frame gradients, and the world points ``points
    [FS * seg, 3]``.  Each point adds into its winner's ``(b, c)``: ``d_T[o,
    j] += ct_val * g_link[o] * points[j]`` (j < 3), ``d_T[o, 3] += ct_val *
    g_link[o]``, ``d_Rb[o, i] += ct_g[o] * g_link[i]``; the other children's
    terms are 0, or NaN where a factor is not finite (the dense formula's
    0/1 mask times inf).  The kernels for float32 CUDA tensors, else the
    plain version; the two sum in different orders."""
    if win.device.type == "cuda" and all(t.dtype == torch.float32
                                         for t in (g_link, ct_val, ct_g, points)):
        return _tile_union_cotangents_cuda(win, g_link, ct_val, ct_g, points, n_children)
    return tile_union_cotangents_plain(win, g_link, ct_val, ct_g, points, n_children)
