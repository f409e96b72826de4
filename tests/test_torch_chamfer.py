"""The port's chamfer metrics against the JAX package on the same inputs
(CPU), on the fixtures of ``test_chamfer.py`` (the wrench and an
icosphere): surface sampling, batched chamfer through the exact closest
point and through an SDF, pose-space pairwise distances, the pairwise
chamfer matrix and ``PlausibleDiversity``.

Tolerances: both packages sweep the same float32 triangles, but the 4x4
compositions and point transforms round in different orders, so the
object-frame points differ by ~1e-7 and the squared millimetre distances
by ~1e-7 relative plus ~1e-9 mm^2 for points on the surface; ``rtol``
1e-4 and ``atol`` 1e-6 mm^2 leave room for that and nothing more."""

import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu import chamfer as jch
from pytorch_volumetric_tpu import mesh as jm
from pytorch_volumetric_tpu import transforms as jtf
from pytorch_volumetric_tpu_torch import chamfer as tch
from pytorch_volumetric_tpu_torch import transforms as ttf

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", params=["wrench", "sphere"])
def obj(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("assets")
    mesh = jm.wrench_mesh() if request.param == "wrench" else jm.icosphere_mesh(0.12, 2)
    path = str(d / f"{request.param}.obj")
    jm.save_obj(mesh, path)
    jf = pv.MeshObjectFactory(path)
    tf = pt.MeshObjectFactory(path, device="cpu")
    pts, _, _ = pv.sample_mesh_points(jf, name=jf.name, num_points=60,
                                      dbpath=str(d / "jax_points.npz"))
    return jf, tf, np.array(pts), d


def _poses(seed, n, rot_sigma=0.1, trans_sigma=0.02):
    """``n`` float32 rigid transforms near a random base pose (numpy)."""
    rng = np.random.default_rng(seed)

    def rot(v):
        ang = np.linalg.norm(v)
        k = v / max(ang, 1e-12)
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K

    base = np.eye(4)
    base[:3, :3] = rot(rng.normal(0, 1.0, 3))
    base[:3, 3] = rng.normal(0, 0.1, 3)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        out[i, :3, :3] = rot(rng.normal(0, rot_sigma, 3))
        out[i, :3, 3] = rng.normal(0, trans_sigma, 3)
    return (base @ out).astype(np.float32)


def test_sample_mesh_points_match_jax(obj, tmp_path):
    """Same seed, same points and normals; the port reads the JAX
    package's cache entries."""
    jf, tf, _, d = obj
    jax_out = {}
    for seed in (0, 3):
        jp, jn, _ = pv.sample_mesh_points(jf, num_points=50, seed=seed, name="m",
                                          dbpath=str(tmp_path / "jax.npz"))
        tp, tn, _ = pt.sample_mesh_points(tf, num_points=50, seed=seed, name="m",
                                          dbpath=str(tmp_path / "port.npz"))
        assert np.array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
        jax_out[seed] = (np.asarray(jp), np.asarray(jn))
    for seed, (jp, jn) in jax_out.items():
        cp, cn, _ = pt.sample_mesh_points(None, num_points=50, seed=seed, name="m",
                                          dbpath=str(tmp_path / "jax.npz"), device="cpu")
        assert np.array_equal(cp.numpy(), jp) and np.array_equal(cn.numpy(), jn)
    with pytest.raises(RuntimeError, match="Expect model points"):
        pt.sample_mesh_points(None, num_points=7, name="m",
                              dbpath=str(tmp_path / "port.npz"), device="cpu")


@pytest.mark.parametrize("through", ["factory", "sdf"])
def test_batch_chamfer_dist_matches_jax(obj, through):
    jf, tf, pts, _ = obj
    gt = _poses(1, 1)[0]
    pts_world = pts @ gt[:3, :3].T + gt[:3, 3]
    w2o = np.linalg.inv(_poses(2, 6, 0.05, 0.01)).astype(np.float32)
    if through == "factory":
        j = jch.batch_chamfer_dist(w2o, pts_world, obj_factory=jf)
        t = tch.batch_chamfer_dist(w2o, pts_world, obj_factory=tf)
    else:
        j = jch.batch_chamfer_dist(w2o, pts_world, obj_sdf=pv.MeshSDF(jf))
        t = tch.batch_chamfer_dist(w2o, pts_world, obj_sdf=pt.MeshSDF(tf))
    assert t.shape == (6,)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_batch_chamfer_dist_needs_a_model(obj):
    with pytest.raises(ValueError, match="obj_sdf or obj_factory"):
        tch.batch_chamfer_dist(np.eye(4)[None], obj[2])


def test_pairwise_distance_matches_jax():
    m = _poses(3, 5, 1.0, 0.3)
    j = jch.pairwise_distance(jtf.Transform3d(matrix=m))
    t = tch.pairwise_distance(ttf.Transform3d(matrix=m, device="cpu"))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    assert np.allclose(np.diag(t.numpy()), 0) and np.allclose(t.numpy(), t.numpy().T)
    np.testing.assert_array_equal(
        ttf.matrix_to_rotation_6d(torch.as_tensor(m[:, :3, :3])).numpy(),
        np.asarray(jtf.matrix_to_rotation_6d(m[:, :3, :3])))


def test_pairwise_distance_chamfer_matches_jax(obj):
    jf, tf, pts, _ = obj
    m = _poses(4, 4, 0.05, 0.02)
    j = jch.pairwise_distance_chamfer(jtf.Transform3d(matrix=m), obj_factory=jf,
                                      model_points_eval=pts)
    t = tch.pairwise_distance_chamfer(ttf.Transform3d(matrix=m, device="cpu"),
                                      obj_factory=tf, model_points_eval=pts)
    assert t.shape == (4, 4)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=1e-3)
    # the diagonal composes each pose with its inverse: ~0
    assert np.allclose(np.diag(t.numpy()), 0, atol=1e-3)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_plausible_diversity_matches_jax(obj, bidirectional):
    jf, tf, pts, _ = obj
    T_p = _poses(5, 6, 0.05, 0.01)
    T_est_inv = np.linalg.inv(_poses(5, 6, 0.05, 0.01)[:4]).astype(np.float32)
    j = jch.PlausibleDiversity(jf, model_points_eval=pts)(
        T_est_inv, T_p, bidirectional=bidirectional)
    t = tch.PlausibleDiversity(tf, model_points_eval=pts)(
        T_est_inv, T_p, bidirectional=bidirectional)
    np.testing.assert_allclose(t.plausibility.item(), float(j.plausibility), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t.coverage.item(), float(j.coverage), rtol=RTOL, atol=ATOL)
    for (tv, ti), (jv, ji) in zip((t.most_plausible_per_estimated,
                                   t.most_covered_per_plausible),
                                  (j.most_plausible_per_estimated,
                                   j.most_covered_per_plausible)):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
    # the first four plausible poses are the estimated ones: plausibility ~ 0
    assert t.plausibility.item() < 1e-3


def test_plausible_diversity_samples_its_own_points(obj, monkeypatch):
    """Without model points it samples 500 from the mesh (cache file in the
    working directory, as in the JAX package)."""
    _, tf, _, d = obj
    monkeypatch.chdir(d)
    pd = tch.PlausibleDiversity(tf, num_model_points_eval=40)
    assert pd.model_points_eval.shape == (40, 3)
    ret = pd(np.eye(4, dtype=np.float32)[None], np.eye(4, dtype=np.float32)[None])
    assert ret.plausibility.item() < 1e-6 and ret.coverage.item() < 1e-6
