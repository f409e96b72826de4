"""The port's SDF layer against the JAX package on the same inputs (CPU):
exact mesh SDFs, cached lookups on identical tables, composition, the
straight-through gradient and the shared ``.npz`` cache format."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch import state
from torch_cpu_guard import warm_sqrt

warm_sqrt()

RES = 0.04


@pytest.fixture(scope="module")
def obj(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("obj"))
    pv.mesh.save_obj(pv.mesh.icosphere_mesh(0.15, 1), os.path.join(d, "ball.obj"))
    fj = pv.MeshObjectFactory("ball.obj", path_prefix=d)
    ft = pt.MeshObjectFactory("ball.obj", path_prefix=d, device="cpu")
    return d, fj, ft


def _points(seed, n, lo=-0.4, hi=0.4):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def _jax_value_and_point_grad(sdf, pts):
    v, g = sdf(jnp.asarray(pts))
    # compiled like the package's own queries: eagerly, XLA would divide by
    # the resolution instead of multiplying by its folded reciprocal
    dp = jax.jit(jax.grad(lambda p: sdf.raw_query(p)[0].sum()))(jnp.asarray(pts))
    return np.asarray(v), np.asarray(g), np.asarray(dp)


def _torch_value_and_point_grad(sdf, pts):
    p = torch.as_tensor(pts).requires_grad_(True)
    v, g = sdf(p)
    (dp,) = torch.autograd.grad(v.sum(), p)
    return v.detach().numpy(), g.numpy(), dp.numpy()


def _key_discrepant_points(cached, n_max=64):
    """Points whose nearest key differs between true division and the
    reciprocal multiply (both in float32): they tell the two arithmetics
    apart."""
    lo = cached.voxels.lo.astype(np.float32)
    res = cached.voxels.res.astype(np.float32)
    q = np.random.default_rng(9).uniform(cached.ranges[:, 0], cached.ranges[:, 1],
                                         (2_000_000, 3)).astype(np.float32)
    kd = np.round((q - lo) / res)
    km = np.round((q - lo) * (np.float32(1) / res))
    return q[(kd != km).any(-1)][:n_max]


def test_grid_points_match(obj):
    _, fj, _ = obj
    rng = pv.get_divisible_range_by_resolution(RES, fj.bounding_box(padding=0.1))
    assert pt.get_divisible_range_by_resolution(RES, fj.bounding_box(padding=0.1)) == rng
    _, pj = pv.get_coordinates_and_points_in_grid(RES, rng)
    _, pp = pt.get_coordinates_and_points_in_grid(RES, rng, device="cpu")
    np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))


def test_voxel_grid_matches_jax():
    rng = [(-0.2, 0.3), (0.0, 0.1), (-0.1, 0.2)]
    gj = pv.VoxelGrid(0.05, rng)
    gt = pt.VoxelGrid(0.05, rng, device="cpu")
    np.testing.assert_array_equal(gt.get_voxel_center_points().numpy(),
                                  np.asarray(gj.get_voxel_center_points()))
    pts = _points(11, 40, -0.3, 0.4)
    vals = np.arange(40, dtype=np.float32) + 1.0
    gj[jnp.asarray(pts)] = jnp.asarray(vals)
    gt[pts] = torch.as_tensor(vals)
    np.testing.assert_array_equal(gt.get_voxel_values().numpy(),
                                  np.asarray(gj.get_voxel_values()))
    np.testing.assert_array_equal(gt[pts].numpy(), np.asarray(gj[jnp.asarray(pts)]))
    pj, vj = gj.get_known_pos_and_values()
    pt_, vt = gt.get_known_pos_and_values()
    np.testing.assert_allclose(pt_.numpy(), np.asarray(pj), atol=1e-7)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_transforms_match_jax():
    tj, tt = pv.transforms, pt.transforms
    rng = np.random.default_rng(12)
    rpy = rng.uniform(-3, 3, (5, 3)).astype(np.float32)
    axis = rng.normal(size=(5, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, 5).astype(np.float32)
    quat = rng.normal(size=(5, 4)).astype(np.float32)
    pos = rng.normal(size=(5, 3)).astype(np.float32)
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
    T = torch.as_tensor
    pairs = [
        (tj.rpy_to_matrix(rpy), tt.rpy_to_matrix(T(rpy))),
        (tj.axis_angle_to_matrix(axis, ang), tt.axis_angle_to_matrix(T(axis), T(ang))),
        (tj.quaternion_xyzw_to_matrix(quat), tt.quaternion_xyzw_to_matrix(T(quat))),
    ]
    mj = tj.make_tf(pos=pos, rot=tj.rpy_to_matrix(rpy))
    mt = tt.make_tf(pos=T(pos), rot=tt.rpy_to_matrix(T(rpy)))
    pairs += [
        (mj, mt), (tj.invert_tf(mj), tt.invert_tf(mt)),
        (tj.compose_tf(mj, tj.invert_tf(mj[::-1])), tt.compose_tf(mt, tt.invert_tf(mt.flip(0)))),
        (tj.transform_points(mj, pts), tt.transform_points(mt, T(pts))),
        (tj.rotate_vectors(mj[:, :3, :3], pts), tt.rotate_vectors(mt[:, :3, :3], T(pts))),
        (tj.Translate(0.1, -0.2, 0.3).stack(tj.Transform3d(matrix=mj)).inverse().get_matrix(),
         tt.Translate(0.1, -0.2, 0.3, device="cpu").stack(tt.Transform3d(matrix=mt))
         .inverse().get_matrix()),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-6)
    assert len(tt.Transform3d(matrix=mt)) == 5


def test_mesh_sdf_matches_jax(obj):
    _, fj, ft = obj
    pts = _points(0, 300)
    vj, gj, dj = _jax_value_and_point_grad(pv.MeshSDF(fj), pts)
    vt, gt, dt = _torch_value_and_point_grad(pt.MeshSDF(ft), pts)
    assert np.abs(vj - vt).max() < 1e-6
    assert np.abs(gj - gt).max() < 1e-5
    # straight-through: d(sum val)/d pts is the analytic gradient, as in JAX
    assert np.abs(dj - dt).max() < 1e-5
    np.testing.assert_array_equal(dt, gt)


def test_object_frame_closest_point(obj):
    _, fj, ft = obj
    pts = _points(1, 64).reshape(4, 16, 3)
    rj = fj.object_frame_closest_point(jnp.asarray(pts), compute_normal=True)
    rt = ft.object_frame_closest_point(pts, compute_normal=True)
    assert rt.distance.shape == (4, 16) and rt.normal.shape == (4, 16, 3)
    for a, b in zip(rj[:3], rt[:3]):
        assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-5
    # the normal is that of a face reaching the closest point; at edge and
    # vertex ties either package may pick another of the tied faces
    np.testing.assert_allclose(np.linalg.norm(rt.normal.numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("interpolation", ["nearest", "trilinear"])
@pytest.mark.parametrize("oob", ["BOUNDING_BOX", "LOOKUP_GT_SDF"])
def test_cached_lookup_on_shared_tables(obj, tmp_path, interpolation, oob):
    """Lookups on identical tables: nearest keys are bit-identical to JAX's
    compiled lookup (which multiplies by the float32 reciprocal of the
    resolution), including on points where true division would round to
    another voxel."""
    _, fj, ft = obj
    bb = fj.bounding_box(padding=0.1)
    cj = pv.CachedSDF("ball.obj", RES, bb, pv.MeshSDF(fj),
                      out_of_bounds_strategy=pv.OutOfBoundsStrategy[oob],
                      interpolation=interpolation, cache_path=str(tmp_path / "c.npz"))
    ct = state.cached_sdf_from_numpy(
        "ball.obj", RES, bb, np.asarray(cj.voxels.raw_data), np.asarray(cj.voxels_grad),
        np.asarray(cj.surface_bounding_box()), device="cpu", interpolation=interpolation,
        out_of_bounds_strategy=pt.OutOfBoundsStrategy[oob], gt_sdf=pt.MeshSDF(ft))
    assert ct.name == cj.name
    border = _key_discrepant_points(cj)
    pts = np.concatenate([_points(2, 400, -0.35, 0.35), border])
    vj, gj, dj = _jax_value_and_point_grad(cj, pts)
    vt, gt, dt = _torch_value_and_point_grad(ct, pts)
    within = np.asarray(cj.voxels.get_valid_values(jnp.asarray(pts)))
    assert within.sum() > 100 and (~within).sum() > 50
    if interpolation == "nearest":
        np.testing.assert_array_equal(vt[within], vj[within])
        np.testing.assert_array_equal(gt[within], gj[within])
        assert len(border) > 0
    else:
        assert np.abs(vt[within] - vj[within]).max() < 1e-6
        assert np.abs(gt[within] - gj[within]).max() < 1e-6
    assert np.abs(vt - vj).max() < 1e-6
    assert np.abs(gt - gj).max() < 1e-5
    assert np.abs(dt - dj).max() < 1e-5


def test_port_build_matches_jax_build(obj, tmp_path):
    """The port's own cache build (its sweep over the grid) against JAX's."""
    _, fj, ft = obj
    bb = fj.bounding_box(padding=0.1)
    cj = pv.CachedSDF("ball.obj", RES, bb, pv.MeshSDF(fj), cache_path=str(tmp_path / "j.npz"))
    ct = pt.CachedSDF("ball.obj", RES, bb, pt.MeshSDF(ft), cache_path=str(tmp_path / "t.npz"))
    vj = np.asarray(cj.voxels.raw_data)
    vt = ct.voxels.raw_data.numpy()
    assert vt.shape == vj.shape
    assert np.abs(vt - vj).max() < 1e-6
    # the gradient is (p - closest) / dist: away from the surface a 1e-7
    # difference in the closest point stays below 1e-5 of gradient, except
    # on the medial axis, where two surface points tie and each package may
    # take the other (3 symmetric grid points of this ball, 1.4e-4 apart)
    off = np.abs(vj.reshape(-1)) > 1e-2
    err = np.abs(ct.voxels_grad.numpy()[off] - np.asarray(cj.voxels_grad)[off]).max(-1)
    assert (err < 1e-5).mean() > 0.99 and err.max() < 1e-3


def test_npz_cache_loads_across_packages(obj, tmp_path):
    _, fj, ft = obj
    bb = fj.bounding_box(padding=0.1)
    # written by JAX, read by the port (no ground truth needed)
    path_j = str(tmp_path / "from_jax.npz")
    cj = pv.CachedSDF("ball.obj", RES, bb, pv.MeshSDF(fj), cache_path=path_j)
    ct = pt.CachedSDF("ball.obj", RES, bb, None, cache_path=path_j, device="cpu")
    np.testing.assert_array_equal(ct.voxels.raw_data.numpy(), np.asarray(cj.voxels.raw_data))
    np.testing.assert_array_equal(ct.voxels_grad.numpy(), np.asarray(cj.voxels_grad))
    np.testing.assert_array_equal(ct.bb.numpy(), np.asarray(cj.bb))
    # written by the port, read by JAX
    path_t = str(tmp_path / "from_port.npz")
    ct2 = pt.CachedSDF("ball.obj", RES, bb, pt.MeshSDF(ft), cache_path=path_t)
    cj2 = pv.CachedSDF("ball.obj", RES, bb, None, cache_path=path_t)
    np.testing.assert_array_equal(np.asarray(cj2.voxels.raw_data), ct2.voxels.raw_data.numpy())
    np.testing.assert_array_equal(np.asarray(cj2.voxels_grad), ct2.voxels_grad.numpy())
    np.testing.assert_array_equal(np.asarray(cj2.bb), ct2.bb.numpy())


def test_outside_surface_and_debug_check(obj, tmp_path):
    _, fj, ft = obj
    bb = fj.bounding_box(padding=0.1)
    cj = pv.CachedSDF("ball.obj", RES, bb, pv.MeshSDF(fj), cache_path=str(tmp_path / "c.npz"))
    ct = state.cached_sdf_from_numpy(
        "ball.obj", RES, bb, np.asarray(cj.voxels.raw_data), np.asarray(cj.voxels_grad),
        np.asarray(cj.surface_bounding_box()), device="cpu", gt_sdf=pt.MeshSDF(ft))
    pts = _points(3, 500, -0.5, 0.5)
    np.testing.assert_array_equal(ct.outside_surface(pts).numpy(),
                                  np.asarray(cj.outside_surface(jnp.asarray(pts))))
    ct.debug_check_sdf = True
    v, _ = ct(pts)  # raises if the self-check fails
    assert v.shape == (500,)


def test_composed_sdf_matches_jax(obj, tmp_path):
    """Min-union over posed children, link-major [S*B, 4, 4] layout."""
    _, fj, ft = obj
    bb = fj.bounding_box(padding=0.1)
    cj = pv.CachedSDF("ball.obj", RES, bb, pv.MeshSDF(fj), cache_path=str(tmp_path / "c.npz"))
    tables = (np.asarray(cj.voxels.raw_data), np.asarray(cj.voxels_grad),
              np.asarray(cj.surface_bounding_box()))
    ct = state.cached_sdf_from_numpy("ball.obj", RES, bb, *tables, device="cpu")
    rng = np.random.default_rng(4)
    S, B = 3, 2
    ang = rng.uniform(-1, 1, (S * B, 3)).astype(np.float32)
    pos = rng.uniform(-0.2, 0.2, (S * B, 3)).astype(np.float32)
    R = np.asarray(pv.transforms.euler_angles_to_matrix(jnp.asarray(ang)))
    mats = np.asarray(pv.transforms.make_tf(pos=pos, rot=R))
    sj = pv.ComposedSDF([cj, cj, pv.MeshSDF(fj)], pv.transforms.Transform3d(matrix=mats))
    st = pt.ComposedSDF([ct, ct, pt.MeshSDF(ft)], pt.Transform3d(matrix=mats, device="cpu"))
    pts = _points(5, 200)
    vj, gj = (np.asarray(x) for x in sj(jnp.asarray(pts)))
    vt, gt = (x.numpy() for x in st(pts))
    assert vt.shape == (B, 200) and gt.shape == (B, 200, 3)
    assert np.abs(vt - vj).max() < 1e-5
    assert np.abs(gt - gj).max() < 1e-4
    bj = np.asarray(sj.surface_bounding_box(padding=0.05))
    bt = st.surface_bounding_box(padding=0.05).numpy()
    assert bt.shape == (B, 3, 2) and np.abs(bt - bj).max() < 1e-6


def test_straight_through_backward_ignores_gradient_output(obj):
    """Only the value's cotangent reaches the points (as the JAX custom VJP:
    the gradient output is treated as a constant)."""
    _, _, ft = obj
    sdf = pt.MeshSDF(ft)
    p = torch.as_tensor(_points(6, 32)).requires_grad_(True)
    v, g = sdf(p)
    assert not g.requires_grad
    (dp,) = torch.autograd.grad((3.0 * v).sum() + 0.0 * p.sum(), p)
    np.testing.assert_allclose(dp.numpy(), 3.0 * g.numpy(), rtol=1e-6)


@pytest.mark.parametrize("kind", ["sphere", "box", "cylinder", "capsule"])
def test_primitives_match_jax(kind):
    args = {"sphere": (0.2,), "box": (np.array([0.2, 0.3, 0.1]),),
            "cylinder": (0.1, 0.3), "capsule": (0.08, 0.2)}[kind]
    cls = {"sphere": "SphereSDF", "box": "BoxSDF", "cylinder": "CylinderSDF",
           "capsule": "CapsuleSDF"}[kind]
    sj = getattr(pv, cls)(*args)
    st = getattr(pt, cls)(*args, device="cpu")
    pts = _points(7, 300)
    vj, gj = (np.asarray(x) for x in sj(jnp.asarray(pts)))
    vt, gt = (x.numpy() for x in st(pts))
    assert np.abs(vt - vj).max() < 1e-6
    assert np.abs(gt - gj).max() < 1e-5
    np.testing.assert_allclose(st.surface_bounding_box(padding=0.1).numpy(),
                               np.asarray(sj.surface_bounding_box(padding=0.1)), atol=1e-7)
