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
- :func:`winner_straight_through`: the per-point winner union of the
  coherent path, d val / d pts_c[ci] = (win == ci) * the winner's gradient;
- :func:`tile_winner_straight_through`: the per-tile winner unions, which
  also carry the object-frame gradient's derivative w.r.t. the rotations.
"""

from __future__ import annotations

from typing import Tuple

import torch


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


@torch.library.custom_op("pvt::winner_straight_through", mutates_args=())
def winner_straight_through(val: torch.Tensor, g_link: torch.Tensor, win: torch.Tensor,
                            pts_c: torch.Tensor) -> torch.Tensor:
    """A copy of ``val [B, FS, seg]`` with d val / d pts_c[ci] = (win ==
    ci) * ``g_link``, for ``pts_c [C, B, FS, seg, 3]``."""
    return val.clone()


@winner_straight_through.register_fake
def _winner_straight_through_fake(val, g_link, win, pts_c):
    return torch.empty_like(val)


def _winner_mask(win: torch.Tensor, n_children: int, dtype) -> torch.Tensor:
    """``[C, B, FS, seg, 1]``: 1 where child ``ci`` is the point's winner."""
    ci = torch.arange(n_children, device=win.device).view(-1, 1, 1, 1)
    return (win[None] == ci).to(dtype)[..., None]


def _winner_setup(ctx, inputs, output):
    _, g_link, win, pts_c = inputs
    ctx.n_children = pts_c.shape[0]
    ctx.save_for_backward(g_link, win)


def _winner_backward(ctx, ct_val):
    g_link, win = ctx.saved_tensors
    oh = _winner_mask(win, ctx.n_children, g_link.dtype)[..., 0]
    return None, None, None, oh[..., None] * (ct_val[..., None] * g_link)[None]


winner_straight_through.register_autograd(_winner_backward, setup_context=_winner_setup)


@torch.library.custom_op("pvt::tile_winner_straight_through", mutates_args=())
def tile_winner_straight_through(val: torch.Tensor, g_obj: torch.Tensor, win: torch.Tensor,
                                 g_link: torch.Tensor, pts_c: torch.Tensor,
                                 Rb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copies of ``val [B, FS, seg]`` and ``g_obj [B, FS, seg, 3]`` with
    d val / d pts_c[ci] = (win == ci) * ``g_link`` (the winner's link-frame
    gradient), and d g_obj / d Rb[ci] (``Rb [C, B, 3, 3]``): d R[o, i] =
    the sum over the child's winners of ``ct_g[o] * g_link[i]``, as for
    ``transforms.rotate_vectors`` in the generic path."""
    return val.clone(), g_obj.clone()


@tile_winner_straight_through.register_fake
def _tile_winner_fake(val, g_obj, win, g_link, pts_c, Rb):
    return torch.empty_like(val), torch.empty_like(g_obj)


def _tile_winner_setup(ctx, inputs, output):
    _, _, win, g_link, _, Rb = inputs
    ctx.n_children = Rb.shape[0]
    ctx.save_for_backward(g_link, win)


def _tile_winner_backward(ctx, ct_val, ct_g):
    g_link, win = ctx.saved_tensors
    mask = _winner_mask(win, ctx.n_children, g_link.dtype)    # [C, B, FS, seg, 1]
    d_pts = mask * (ct_val[..., None] * g_link)[None]
    d_Rb = ((ct_g[None] * mask)[..., :, None] * g_link[None, ..., None, :]).sum(dim=(2, 3))
    return None, None, None, None, d_pts, d_Rb


tile_winner_straight_through.register_autograd(_tile_winner_backward,
                                               setup_context=_tile_winner_setup)
