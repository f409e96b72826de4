"""Straight-through derivatives of SDF lookups as registered custom ops.

An SDF lookup returns a value and its analytic gradient; the value's
derivative w.r.t. the query points is that gradient, not the derivative of
the arithmetic that found it (a nearest-voxel lookup is piecewise constant).
Each op here takes a value computed from DETACHED points and returns a copy
of it whose registered backward is the analytic derivative.  As registered
ops (``torch.library.custom_op``) they survive ``torch.export`` with their
backward, so a loaded program stays differentiable w.r.t. joint angles and
points; a ``torch.autograd.Function`` would be inlined and lose it.  The
copy keeps every bit of the value (``inf``, ``-0.0``), which an identity
such as ``val + ((pts - pts.detach()) * grad).sum(-1)`` would not.

- :func:`straight_through`: d val / d pts = grad (every child lookup);
- :func:`tile_winner_straight_through`: the per-tile winner unions of the
  coherent path, d val / d (the point in child ci's frame) = (win == ci) *
  the winner's gradient; they also carry the object-frame gradient's
  derivative w.r.t. the rotations, and take the link-frame points'
  derivative straight back to the world points and the transforms that
  made them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pytorch_volumetric_tpu_torch.ops.coherent_union import (tile_union_cotangents,
                                                             tile_union_point_cotangents)


@torch.library.custom_op("pvt::straight_through", mutates_args=())
def straight_through(val: torch.Tensor, grad: torch.Tensor,
                     pts: torch.Tensor) -> torch.Tensor:
    """A copy of ``val [...]`` with d val / d pts ``[..., 3]`` = ``grad``
    (no derivative w.r.t. ``val`` or ``grad``)."""
    return val.clone()


@straight_through.register_fake
def _straight_through_fake(val, grad, pts):
    return torch.empty_like(val)


def _straight_through_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[1])


def _straight_through_backward(ctx, ct_val):
    (grad,) = ctx.saved_tensors
    return None, None, ct_val[..., None] * grad


straight_through.register_autograd(_straight_through_backward,
                                   setup_context=_straight_through_setup)


@torch.library.custom_op("pvt::tile_winner_straight_through", mutates_args=())
def tile_winner_straight_through(val: torch.Tensor, g_obj: torch.Tensor, win: torch.Tensor,
                                 g_link: torch.Tensor, points: torch.Tensor, T: torch.Tensor,
                                 Rb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copies of ``val [B, FS, seg]`` and ``g_obj [B, FS, seg, 3]``, the
    union of children whose link-frame points are ``T[ci] @ points`` (``T
    [C, B, 4, 4]``, the children's obj_to_link rows; ``points [FS * seg,
    3]``), with d val / d (that point of child ci) = (win == ci) *
    ``g_link`` (the winner's link-frame gradient), taken back through the
    transform to ``T`` and ``points``, and d g_obj / d Rb[ci] (``Rb [C, B,
    3, 3]``): d R[o, i] = the sum over the child's winners of ``ct_g[o] *
    g_link[i]``, as for ``transforms.rotate_vectors`` in the generic path.
    The backward of ``T`` and ``Rb`` is
    :func:`ops.coherent_union.tile_union_cotangents` (a kernel on the
    card), that of ``points`` (computed only when they require grad)
    :func:`ops.coherent_union.tile_union_point_cotangents`."""
    return val.clone(), g_obj.clone()


@tile_winner_straight_through.register_fake
def _tile_winner_fake(val, g_obj, win, g_link, points, T, Rb):
    return torch.empty_like(val), torch.empty_like(g_obj)


def _tile_winner_setup(ctx, inputs, output):
    _, _, win, g_link, points, T, _ = inputs
    ctx.save_for_backward(g_link, win, points, T)


def _tile_winner_backward(ctx, ct_val, ct_g):
    g_link, win, points, T = ctx.saved_tensors
    C = T.shape[0]
    p = points.to(T.dtype)
    d_T, d_Rb = tile_union_cotangents(win, g_link, ct_val, ct_g, p, C)
    d_points = None
    if ctx.needs_input_grad[4]:
        d_points = tile_union_point_cotangents(win, g_link, ct_val,
                                               T[..., :3, :3]).reshape(points.shape)
    return None, None, None, None, d_points, d_T, d_Rb


tile_winner_straight_through.register_autograd(_tile_winner_backward,
                                               setup_context=_tile_winner_setup)
