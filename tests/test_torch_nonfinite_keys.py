"""NaN and +-inf query points: the port against the JAX package (CPU).

The JAX package converts float keys with XLA's ``convert``, which maps NaN
to 0 and saturates at int32's range: a NaN coordinate reads the grid's
first layer, an infinite one is out of the grid.  The port converts every
key with ``utils.batching.float_keys`` to the same effect.  Inputs are
seeded numpy points with NaN, +inf and -inf in each coordinate, mixed with
finite ones; values, gradients and validity must agree, NaN at the same
places."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu import mesh as jmesh
from pytorch_volumetric_tpu.utils.robots import make_serial_arm
from pytorch_volumetric_tpu_torch import native as tnative
from pytorch_volumetric_tpu_torch import state
from pytorch_volumetric_tpu_torch.utils.batching import float_keys
from torch_cpu_guard import warm_sqrt

warm_sqrt()

BOX = np.array([[-0.2, 0.2]] * 3)


def nonfinite_points(seed, n, lo, hi):
    """``n`` finite points uniform in ``[lo, hi]``, then for each coordinate
    the same points with NaN, +inf and -inf there, and points with two or
    three non-finite coordinates."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    out = [base]
    for d in range(3):
        for bad in (np.nan, np.inf, -np.inf):
            p = base.copy()
            p[:, d] = bad
            out.append(p)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    out.append(np.array([[nan, nan, nan], [nan, inf, 0.0], [-inf, nan, 0.05],
                         [inf, inf, -inf], [0.0, nan, nan]], np.float32))
    return np.concatenate(out)


def assert_same(a, b, atol=0.0):
    """NaN and infinities at the same places, finite values within
    ``atol``."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b))
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(a)
    assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= atol


def test_float_keys_is_xla_convert():
    """Without a grid extent: XLA's float -> int32 conversion, value for
    value; with one: clamped to [-1, n], NaN to 0."""
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.0 ** 31, -2.0 ** 31, 5.0, -1.0, 0.0,
                  2147483520.0], np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.int32)).astype(np.int64)
    np.testing.assert_array_equal(float_keys(torch.as_tensor(x)).numpy(), ref)
    n = torch.tensor(4)
    np.testing.assert_array_equal(float_keys(torch.as_tensor(x), n).numpy(),
                                  [0, 4, -1, 4, -1, 4, -1, 4, -1, 0, 4])


def test_grid_view_keys_and_validity():
    """``GridView`` keys, ``get_valid_values`` and ``__getitem__``: a NaN
    coordinate is key 0 and valid, an infinite one invalid."""
    data = np.random.default_rng(0).normal(size=(5, 6, 7)).astype(np.float32)
    rng_pd = np.array([[-0.2, 0.2], [-0.3, 0.2], [0.0, 0.6]])
    gj = pv.voxel.GridView(jnp.asarray(data), rng_pd, invalid_value=-7.0)
    gt = pt.voxel.GridView(torch.as_tensor(data), rng_pd, invalid_value=-7.0)
    pts = nonfinite_points(1, 50, -0.3, 0.6)
    kj = np.asarray(gj.ensure_index_key(jnp.asarray(pts)))
    np.testing.assert_array_equal(gt.ensure_index_key(torch.as_tensor(pts)).numpy(), kj)
    vj = np.asarray(gj.get_valid_values(jnp.asarray(pts)))
    np.testing.assert_array_equal(gt.get_valid_values(torch.as_tensor(pts)).numpy(), vj)
    nan_only = np.isnan(pts).any(-1) & ~np.isinf(pts).any(-1)
    assert vj[nan_only].any() and not vj[np.isinf(pts).any(-1)].any()
    np.testing.assert_array_equal(gt[torch.as_tensor(pts)].numpy(), np.asarray(gj[jnp.asarray(pts)]))


@pytest.mark.parametrize("interpolation", ["nearest", "trilinear"])
def test_cached_lookup(tmp_path, interpolation):
    """Nearest and trilinear ``CachedSDF`` on the JAX package's tables:
    values, gradients and the straight-through d/dpoints."""
    cj = pv.CachedSDF("ball", 0.04, BOX, pv.SphereSDF(0.12), interpolation=interpolation,
                      cache_path=str(tmp_path / "c.npz"))
    ct = state.cached_sdf_from_numpy(
        "ball", 0.04, BOX, np.asarray(cj.voxels.raw_data), np.asarray(cj.voxels_grad),
        np.asarray(cj.surface_bounding_box()), device="cpu", interpolation=interpolation)
    pts = nonfinite_points(2, 200, -0.18, 0.18)
    vj, gj = (np.asarray(x) for x in cj(jnp.asarray(pts)))
    dj = np.asarray(jax.jit(jax.grad(lambda p: cj.raw_query(p)[0].sum()))(jnp.asarray(pts)))
    p = torch.as_tensor(pts).requires_grad_(True)
    vt, gt = ct(p)
    (dt,) = torch.autograd.grad(vt.sum(), p)
    tol = 0.0 if interpolation == "nearest" else 1e-6
    assert_same(vt.detach().numpy(), vj, tol)
    assert_same(gt.numpy(), gj, tol)
    assert_same(dt.numpy(), dj, tol)
    if interpolation == "nearest":
        # a NaN coordinate reads the grid's first layer: finite results
        assert np.isfinite(vj[np.isnan(pts).all(-1)]).all()


@pytest.mark.skipif(not tnative.available(), reason="g++ unavailable: no native runtime to build")
def test_narrow_band(tmp_path):
    """``NarrowBandMeshSDF`` on the JAX package's tables of a torus built
    with no margin (its first cell layer holds band cells): a NaN
    coordinate reads cell 0 on its axis, so far-field points keep the
    cell's finite gradient and in-band points run the cascade on NaN
    distances (NaN); infinite coordinates take the box fallback."""
    path = os.path.join(str(tmp_path), "torus.obj")
    jmesh.save_obj(jmesh.torus_mesh(0.3, 0.12, 24, 12), path)
    build = dict(cell_res=0.04, band=0.1, padding=0.0)
    nj = pv.NarrowBandMeshSDF(pv.MeshObjectFactory(path), **build)
    nt = state.narrow_band_sdf_from_numpy(pt.MeshObjectFactory(path, device="cpu"),
                                          [np.asarray(a) for a in nj.tables])
    pts = nonfinite_points(3, 300, -0.42, 0.42)
    vj, gj = (np.asarray(x) for x in nj(jnp.asarray(pts)))
    vt, gt, slot = pt.ops.narrow_band.narrow_band_query(nt.tables, torch.as_tensor(pts),
                                                        with_slots=True)
    bad = ~np.isfinite(pts).all(-1)
    nan_only = np.isnan(pts).any(-1) & ~np.isinf(pts).any(-1)
    slot = slot.numpy()
    assert (slot[nan_only] >= 0).any() and (slot[nan_only] == -1).any()
    assert np.isfinite(gj[nan_only & (slot == -1)]).all()
    # the jitted JAX query contracts multiply-adds: finite values within
    # 2e-6 (test_torch_narrow_band.py); gradients compared where a point
    # has a non-finite coordinate (the far field, the box fallback or NaN)
    assert_same(vt.numpy(), vj, 2e-6)
    assert_same(gt.numpy()[bad], gj[bad], 1e-6)


def test_cached_robot_query(tmp_path):
    """``RobotSDF.query`` over cached links holding the JAX package's
    tables: a NaN world point is NaN in every link frame and reads each
    link's cell 0."""
    d = str(tmp_path / "arm")
    urdf, end = make_serial_arm(d, num_joints=3, segments=6, rings=2)
    text = open(urdf).read()
    rj = pv.RobotSDF(pv.build_serial_chain_from_urdf(text, end), path_prefix=d,
                     link_sdf_cls=pv.cache_link_sdf_factory(
                         resolution=0.05, padding=0.1, cache_path=str(tmp_path / "jax.npz")))
    rt = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device="cpu"), path_prefix=d,
                     link_sdf_cls=pt.cache_link_sdf_factory(
                         resolution=0.05, padding=0.1, cache_path=str(tmp_path / "jax.npz")))
    state.load_robot_tables(rt, [
        {"val": np.asarray(s.voxels.raw_data), "grad": np.asarray(s.voxels_grad),
         "surface_bb": np.asarray(s.surface_bounding_box())} for s in rj.sdf.sdfs])
    q = np.random.default_rng(4).uniform(-1.5, 1.5, (3, 3)).astype(np.float32)
    pts = nonfinite_points(5, 60, -0.2, 0.5)
    vj, gj = (np.asarray(x) for x in rj.query(jnp.asarray(q), jnp.asarray(pts)))
    vt, gt = rt.query(torch.as_tensor(q), torch.as_tensor(pts))
    assert np.isfinite(vj[:, np.isnan(pts).all(-1)]).all()
    assert_same(vt.numpy(), vj, 1e-5)
    assert_same(gt.numpy(), gj, 1e-4)
