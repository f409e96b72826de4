"""The backward of the port's per-tile union op
``pvt::tile_winner_straight_through`` (``ops/straight_through.py``) on the
CPU, where it is the plain version (``ops.coherent_union.
tile_union_cotangents_plain`` and ``tile_union_point_cotangents``):
against the dense formula it replaced, kept here as the oracle, on random
winners, all children and a subset, one and three configurations, with NaN
and +-inf planted in each input; the kernels' card twins are in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch


def _tile_op_case(B, children, plant, points_grad, dtype, seed=0):
    """The port's ``pvt::tile_winner_straight_through`` as
    ``_compose_coherent`` calls it: ``S = 5`` children, ``obj_to_link [S *
    B, 4, 4]`` rigid, the union's children ``idx`` (all, or a subset whose
    rows are stacked), random winners, link-frame gradients and
    cotangents, 6 tiles of 4 points; ``plant`` puts NaN and +-inf into one
    input.  Returns ``(op_inputs, leaves, cotangents, (S, idx))``."""
    rng = np.random.default_rng(seed)
    S, FS, seg = 5, 6, 4
    idx = list(range(S)) if children == "all" else [0, 2, 3]
    C = len(idx)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype)

    Q, r = np.linalg.qr(rng.normal(size=(S * B, 3, 3)))
    m = np.zeros((S * B, 4, 4))
    m[:, :3, :3] = Q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    m[:, :3, 3] = rng.normal(size=(S * B, 3))
    m[:, 3, 3] = 1
    obj_to_link = torch.tensor(m, dtype=dtype, requires_grad=True)
    Rb_all = t(S, B, 3, 3).requires_grad_()
    points = t(FS * seg, 3)
    win = torch.as_tensor(rng.integers(0, C, (B, FS, seg)))
    val, g_obj, g_link = t(B, FS, seg), t(B, FS, seg, 3), t(B, FS, seg, 3)
    ct_val, ct_g = t(B, FS, seg), t(B, FS, seg, 3)
    planted = {"g_link": g_link, "ct_val": ct_val, "ct_g": ct_g, "points": points}.get(plant)
    if planted is not None:
        flat = planted.view(-1)
        for k, x in zip(rng.choice(flat.numel(), 3, replace=False),
                        (np.nan, np.inf, -np.inf)):
            flat[k] = x
    points.requires_grad_(points_grad)

    def of(x):
        return x if C == S else torch.stack([x[i] for i in idx])

    T = of(obj_to_link.reshape(S, B, 4, 4))
    leaves = [obj_to_link, Rb_all] + ([points] if points_grad else [])
    return ((val, g_obj, win, g_link, points, T, of(Rb_all)), leaves, (ct_val, ct_g),
            (S, idx))


def _dense_tile_op_grads(inputs, leaves, cts, layout):
    """The dense formula the port's tile-union backward had, kept as the
    oracle: the point cotangent ``mask * (ct_val * g_link)`` on the union
    children's link-frame points, taken back through ``transform_points``
    of their rows ``T``, and the rotations' ``sum((ct_g * mask) outer
    g_link)``.  (``obj_to_link``'s other rows take their derivative from
    the branch that queries them.)"""
    from pytorch_volumetric_tpu_torch import transforms as ttfm
    _, _, win, g_link, points, T, Rb = inputs
    ct_val, ct_g = cts
    C = len(layout[1])
    B, FS, seg = win.shape
    pts_c = ttfm.transform_points(T.reshape(C * B, 4, 4), points).reshape(C, B, FS, seg, 3)
    ci = torch.arange(C).view(-1, 1, 1, 1)
    mask = (win[None] == ci).to(g_link.dtype)[..., None]
    d_pts = mask * (ct_val[..., None] * g_link)[None]
    d_Rb = ((ct_g[None] * mask)[..., :, None] * g_link[None, ..., None, :]).sum(dim=(2, 3))
    return torch.autograd.grad((pts_c, Rb), leaves, (d_pts, d_Rb))


@pytest.mark.parametrize("points_grad", [False, True])
@pytest.mark.parametrize("plant", ["none", "g_link", "ct_val", "ct_g", "points"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("children", ["all", "subset"])
def test_tile_winner_op_backward_matches_dense(children, B, plant, points_grad):
    """The port's tile-union backward (``ops.coherent_union.
    tile_union_cotangents``, the plain version on the CPU; d points by its
    own plain expression) against the dense formula it replaced: the
    cotangents of ``obj_to_link``, of the rotations and, when they require
    grad, of the points.  A non-finite ``ct_val * g_link``, ``ct_g``,
    ``g_link`` or point makes every other child's sum NaN, as the dense
    0/1 mask did: NaN and +-inf must sit where the oracle has them.
    Float64, so the tolerance only covers the two sum orders: at most 24
    terms an entry, each of magnitude < 100, differ by < 24 * 2^-53 * 2400
    ~ 1e-11 (atol 1e-10)."""
    from pytorch_volumetric_tpu_torch.ops.straight_through import (
        tile_winner_straight_through)
    inputs, leaves, cts, layout = _tile_op_case(B, children, plant, points_grad,
                                                torch.float64)
    val, g_obj = tile_winner_straight_through(*inputs)
    got = torch.autograd.grad((val, g_obj), leaves, cts)
    want = _dense_tile_op_grads(inputs, leaves, cts, layout)
    for name, a, b in zip(("obj_to_link", "Rb", "points"), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10, equal_nan=True, msg=name)
    if plant != "none":
        assert torch.isnan(got[0]).any() or torch.isnan(got[1]).any()


def test_tile_winner_op_backward_float32():
    """The same op in float32 (the dtype the port runs) against the dense
    formula in float32: the two sum orders over at most 24 terms of
    magnitude < 100 differ by < 24 * 2^-24 * 2400 ~ 3.4e-3 at worst; the
    entries are O(1-10), so rtol 1e-5 with atol 1e-4 (both well above the
    few-ulp differences seen) still fails on any misplaced term."""
    from pytorch_volumetric_tpu_torch.ops.straight_through import (
        tile_winner_straight_through)
    inputs, leaves, cts, layout = _tile_op_case(3, "subset", "none", True, torch.float32)
    val, g_obj = tile_winner_straight_through(*inputs)
    got = torch.autograd.grad((val, g_obj), leaves, cts)
    want = _dense_tile_op_grads(inputs, leaves, cts, layout)
    for name, a, b in zip(("obj_to_link", "Rb", "points"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4, msg=name)


@pytest.mark.parametrize("children", ["all", "subset"])
def test_tile_winner_op_point_cotangent_nonfinite_rotation(children):
    """A non-finite rotation entry ``R[c, b][o, j]`` of a union child makes
    entry ``j`` of the points' cotangent NaN wherever ``c`` is not the
    winner (the dense mask's 0 times inf), and +-inf where ``c`` wins:
    the same places and values as the dense oracle (float64,
    atol 1e-10 as in ``test_tile_winner_op_backward_matches_dense``)."""
    from pytorch_volumetric_tpu_torch.ops.straight_through import (
        tile_winner_straight_through)
    inputs, leaves, cts, layout = _tile_op_case(3, children, "none", True, torch.float64)
    val, g_obj, win, g_link, points, T, Rb = inputs
    T = T.detach().clone()
    T[1, 2, 0, 1], T[0, 1, 2, 2] = float("inf"), float("nan")
    T.requires_grad_()
    inputs = (val, g_obj, win, g_link, points, T, Rb)
    got = torch.autograd.grad(tile_winner_straight_through(*inputs), [T, points], cts)
    want = _dense_tile_op_grads(inputs, [T, points], cts, layout)
    for name, a, b in zip(("T", "points"), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10, equal_nan=True, msg=name)
    assert not torch.isfinite(got[1][:, 1:]).any() and torch.isfinite(got[1][:, 0]).all()
