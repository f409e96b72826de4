"""The port's closest-point + winding sweep against the JAX package on the
same inputs (CPU).  The CUDA kernel itself runs only on the card; its tests
are in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_volumetric_tpu import mesh as jm
from pytorch_volumetric_tpu.ops import point_triangle as jpt
from pytorch_volumetric_tpu.ops.pallas.closest_point import mesh_closest_query_pallas
from pytorch_volumetric_tpu_torch import mesh as tm
from pytorch_volumetric_tpu_torch.ops import point_triangle as tpt
from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda
from pytorch_volumetric_tpu_torch.state import scene_from_numpy
from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
from torch_cpu_guard import warm_sqrt

warm_sqrt()

INTERPRET = jax.default_backend() != "tpu"


def _mesh(pkg):
    return pkg.icosphere_mesh(0.3, 2).concatenate(
        pkg.box_mesh((0.2, 0.3, 0.1), center=(0.4, 0.0, 0.0)))


@pytest.fixture(scope="module")
def scenes():
    js = jm.MeshScene.from_mesh(_mesh(jm))
    ts = tm.MeshScene.from_mesh(_mesh(tm), device="cpu")
    return js, ts


def _points(seed, n, lo=-0.6, hi=0.8):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def _face_contract(tri, pts, fid, dist_ref, tol=1e-5):
    """The chosen face must reach the minimal distance (ties on shared
    edges, vertices and coplanar faces may pick any of the tied faces)."""
    chosen = tri[fid]
    d2, _ = jpt._closest_point_bary(
        jnp.asarray(pts)[:, None, :], jnp.asarray(chosen[:, None, 0]),
        jnp.asarray(chosen[:, 1] - chosen[:, 0])[:, None],
        jnp.asarray(chosen[:, 2] - chosen[:, 0])[:, None])
    assert np.abs(np.sqrt(np.asarray(d2)[:, 0]) - dist_ref).max() < tol


def test_scene_packing_matches(scenes):
    js, ts = scenes
    assert ts.num_faces == js.num_faces
    np.testing.assert_array_equal(ts.tri.numpy(), np.asarray(js.tri))
    np.testing.assert_array_equal(ts.normals.numpy(), np.asarray(js.normals))


def test_plain_sweep_matches_jax(scenes):
    js, ts = scenes
    pts = _points(0, 300)
    d0, c0, f0, w0 = (np.asarray(x) for x in jpt.mesh_closest_query(jnp.asarray(pts), js.tri))
    d1, c1, f1, w1 = (x.numpy() for x in tpt.mesh_closest_query(torch.as_tensor(pts), ts.tri))
    assert f1.dtype == np.int32
    assert np.abs(d0 - d1).max() < 1e-6
    assert np.abs(c0 - c1).max() < 1e-6
    assert np.abs(w0 - w1).max() < 1e-5
    _face_contract(np.asarray(js.tri), pts, f1, d0)


def test_plain_sweep_matches_pallas_interpret(scenes):
    js, ts = scenes
    pts = _points(1, 200)
    d0, c0, f0, w0 = (np.asarray(x) for x in mesh_closest_query_pallas(
        jnp.asarray(pts), js.tri, interpret=INTERPRET))
    d1, c1, f1, w1 = (x.numpy() for x in tpt.mesh_closest_query(torch.as_tensor(pts), ts.tri))
    assert np.abs(d0 - d1).max() < 1e-6
    assert np.abs(c0 - c1).max() < 1e-6
    assert np.abs(w0 - w1).max() < 5e-4  # the Pallas kernel's polynomial atan2
    _face_contract(np.asarray(js.tri), pts, f1, d0)


@pytest.mark.parametrize("P", [1, 7, 129, 257, 2049])
def test_ragged_point_counts(scenes, P):
    js, ts = scenes
    pts = _points(P, P, -0.5, 0.5)
    d0, _, _, w0 = (np.asarray(x) for x in jpt.mesh_closest_query(jnp.asarray(pts), js.tri))
    d1, _, _, w1 = (x.numpy() for x in tpt.mesh_closest_query(torch.as_tensor(pts), ts.tri))
    assert d1.shape == (P,)
    assert np.abs(d0 - d1).max() < 1e-6
    assert np.abs(w0 - w1).max() < 1e-5


@pytest.mark.parametrize("which", ["box_under_one_tile", "single_triangle", "unpadded_320"])
def test_small_and_unpadded_meshes(which):
    if which == "box_under_one_tile":
        tri = np.asarray(jm.MeshScene.from_mesh(jm.box_mesh((0.4, 0.6, 0.8))).tri)
    elif which == "single_triangle":
        tri = np.array([[[0.0, 0, 0], [0.3, 0, 0], [0, 0.2, 0.1]]], dtype=np.float32)
    else:
        tri = jm.icosphere_mesh(0.25, 2).triangles().astype(np.float32)
    pts = _points(2, 64, -0.8, 0.8)
    d0, c0, f0, w0 = (np.asarray(x) for x in jpt.mesh_closest_query(jnp.asarray(pts),
                                                                   jnp.asarray(tri)))
    d1, c1, f1, w1 = (x.numpy() for x in tpt.mesh_closest_query(torch.as_tensor(pts),
                                                               torch.as_tensor(tri)))
    assert np.abs(d0 - d1).max() < 1e-6
    assert np.abs(c0 - c1).max() < 1e-6
    assert np.abs(w0 - w1).max() < 1e-5
    _face_contract(tri, pts, f1, d0)


def test_closest_features_match_jax(scenes):
    js, _ = scenes
    tri = np.asarray(js.tri)[:50]
    pts = _points(3, 40)
    a, ab, ac = tri[None, :, 0], (tri[:, 1] - tri[:, 0])[None], (tri[:, 2] - tri[:, 0])[None]
    d0, c0, k0 = jpt._closest_point_bary(jnp.asarray(pts)[:, None], jnp.asarray(a),
                                         jnp.asarray(ab), jnp.asarray(ac), with_features=True)
    d1, c1, k1 = tpt._closest_point_bary(torch.as_tensor(pts)[:, None], torch.as_tensor(a),
                                         torch.as_tensor(ab), torch.as_tensor(ac),
                                         with_features=True)
    np.testing.assert_array_equal(k1.numpy(), np.asarray(k0))
    assert np.abs(d1.numpy() - np.asarray(d0)).max() < 1e-6


def test_signed_query_surface_normal_override(scenes):
    """Points on the surface take the normal of a face reaching them."""
    js, ts = scenes
    mesh = _mesh(jm)
    pts, _, fid = mesh.sample_points_uniformly(128, seed=4, return_normals=True)
    pts = np.concatenate([pts.astype(np.float32), _points(5, 64)])
    cj, sj, gj, nj = (np.asarray(x) for x in jpt.signed_closest_query(
        jnp.asarray(pts), js.tri, js.normals))
    ct, st, gt, nt = (x.numpy() for x in tpt.signed_closest_query(
        torch.as_tensor(pts), ts.tri, ts.normals))
    assert np.abs(sj - st).max() < 1e-6
    assert np.abs(cj - ct).max() < 1e-6
    on = np.abs(st) < 1e-3
    assert on[:128].all()
    # on the surface the gradient is a face normal: unit length, and the face
    # it belongs to passes within the override distance of the point
    np.testing.assert_allclose(np.linalg.norm(gt[on], axis=-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(gt[on], nt[on])
    # off the surface the gradients agree with JAX
    assert np.abs(gj[~on] - gt[~on]).max() < 1e-5


def test_wrapper_runs_plain_version_on_cpu(scenes):
    """On a CPU tensor the kernel wrapper runs the plain version and counts
    no launch."""
    _, ts = scenes
    pts = torch.as_tensor(_points(6, 50))
    before = COUNTERS["kernel.closest_point_sweep"]
    out = mesh_closest_query_cuda(pts, ts.tri)
    ref = tpt.mesh_closest_query(pts, ts.tri)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert COUNTERS["kernel.closest_point_sweep"] == before


def test_state_scene_roundtrip(scenes):
    js, ts = scenes
    s = scene_from_numpy(np.asarray(js.tri), np.asarray(js.normals), js.num_faces,
                         device="cpu")
    assert torch.equal(s.tri, ts.tri) and s.num_faces == ts.num_faces
