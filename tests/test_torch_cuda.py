"""The port's CUDA kernels on the card: against their plain versions, their
launch counts and their input checks.  Imports neither JAX nor the JAX
package, so it runs on a GPU machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tests marked ``cuda`` skip without a CUDA device."""

import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch.ops import point_triangle as tpt
from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr
from pytorch_volumetric_tpu_torch.ops.closest_point import (
    mesh_closest_query_contracted_cuda, mesh_closest_query_cuda,
    mesh_closest_query_mma_cuda, mesh_closest_query_nowind_cuda)
from pytorch_volumetric_tpu_torch.ops.fma_probe import fma_probe, fma_probe_cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the closest-point kernel has no CPU mode")
    return torch.device("cuda")


def _scene(device):
    mesh = pt.mesh.icosphere_mesh(0.3, 2).concatenate(
        pt.mesh.box_mesh((0.2, 0.3, 0.1), center=(0.4, 0.0, 0.0)))
    return pt.mesh.MeshScene.from_mesh(mesh, device=device)


def _points(seed, n, device, lo=-0.6, hi=0.8):
    pts = np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)
    return torch.as_tensor(pts, device=device)


@pytest.mark.parametrize("wrapper", [
    mesh_closest_query_cuda, mesh_closest_query_nowind_cuda,
    mesh_closest_query_mma_cuda, mesh_closest_query_contracted_cuda])
def test_wrapper_rejects_other_devices(wrapper):
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(meta, torch.empty((2, 3, 3), device="meta"))


def test_fma_probe_rejects_other_devices():
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fma_probe_cuda(meta, meta, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 129, 5000])
def test_kernel_matches_plain_on_card(card, P):
    """Distances, closest points and face ids match the plain version bit
    for bit (both round every operation the same way); the winding sums
    differ only by summation order."""
    tri = _scene(card).tri
    pts = _points(P, P, card)
    before = mesh_closest_query_cuda.launches
    d1, c1, f1, w1 = mesh_closest_query_cuda(pts, tri)
    torch.cuda.synchronize()
    assert mesh_closest_query_cuda.launches == before + 1
    d0, c0, f0, w0 = tpt.mesh_closest_query(pts, tri)
    assert (d0 - d1).abs().max().item() <= 1e-5
    assert (c0 - c1).abs().max().item() <= 1e-5
    assert (w0 - w1).abs().max().item() <= 1e-4
    # face-id contract: the chosen face reaches the minimal distance
    chosen = tri.index_select(0, f1)
    d2, _ = tpt._closest_point_bary(pts[:, None], chosen[:, None, 0],
                                    (chosen[:, 1] - chosen[:, 0])[:, None],
                                    (chosen[:, 2] - chosen[:, 0])[:, None])
    assert (torch.sqrt(d2[:, 0]) - d0).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_kernel_checks_inputs(card):
    tri = _scene(card).tri
    pts = _points(0, 10, card)
    with pytest.raises(TypeError, match="float32"):
        mesh_closest_query_cuda(pts.double(), tri)
    with pytest.raises(ValueError, match="contiguous"):
        mesh_closest_query_cuda(pts.t().contiguous().t(), tri)
    with pytest.raises(ValueError, match=r"\[P, 3\]"):
        mesh_closest_query_cuda(pts[:, :2].contiguous(), tri)
    with pytest.raises(ValueError, match="same device"):
        mesh_closest_query_cuda(pts, tri.cpu())


@pytest.mark.cuda
def test_mesh_sdf_on_card_matches_cpu(card):
    """The exact SDF with its straight-through gradient, card vs CPU."""
    mesh = pt.mesh.icosphere_mesh(0.2, 2)
    results = []
    for dev in (card, torch.device("cpu")):
        fac = pt.MeshObjectFactory("ball", mesh=mesh, device=dev)
        p = _points(1, 300, dev, -0.4, 0.4).requires_grad_(True)
        v, g = pt.MeshSDF(fac)(p)
        (dp,) = torch.autograd.grad(v.sum(), p)
        results.append([x.detach().cpu() for x in (v, g, dp)])
    for a, b in zip(*results):
        assert (a - b).abs().max().item() <= 1e-5


def _far_points(seed, n, device):
    """Points 0.8-1.2 m from the origin, around a capsule 5 cm across: the
    capsule cache grid's far corner, where the expanded forms cancel most."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d *= rng.uniform(0.8, 1.2, (n, 1)) / np.linalg.norm(d, axis=1, keepdims=True)
    return torch.as_tensor(d.astype(np.float32), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 129, 5000])
def test_nowind_kernel_matches_plain_on_card(card, P):
    """The no-winding sweep shares K1's arithmetic and build: distances,
    closest points and face ids bit for bit; the winding is all zeros."""
    tri = _scene(card).tri
    pts = _points(P, P, card)
    before = mesh_closest_query_nowind_cuda.launches
    d1, c1, f1, w1 = mesh_closest_query_nowind_cuda(pts, tri)
    torch.cuda.synchronize()
    assert mesh_closest_query_nowind_cuda.launches == before + 1
    d0, c0, f0, _ = tpt.mesh_closest_query(pts, tri, winding=False)
    assert torch.equal(d0, d1) and torch.equal(c0, c1) and torch.equal(f0, f1)
    assert not w1.any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["near", "ragged", "far"])
def test_mma_kernel_matches_plain_on_card(card, case):
    """The tensor-core sweep against the expanded plain version: distance,
    the closest point on the chosen face and the face contract within 1e-5
    (3xTF32 products keep ~21 bits), winding within 1e-3."""
    if case == "far":
        cap = pt.mesh.capsule_mesh(radius=0.045, height=0.18, segments=14, rings=5)
        tri = pt.mesh.MeshScene.from_mesh(cap, device=card).tri
        pts = _far_points(3, 4000, card)
    else:
        tri = _scene(card).tri
        if case == "ragged":  # F = 13: a tile tail and a step tail
            tri = tri[:13].contiguous()
        pts = _points(7, 3001, card)
    before = mesh_closest_query_mma_cuda.launches
    out = mesh_closest_query_mma_cuda(pts, tri)
    torch.cuda.synchronize()
    assert mesh_closest_query_mma_cuda.launches == before + 1
    err = sr.sweep_errors(out, tpt.mesh_closest_query_expanded(pts, tri), pts, tri)
    assert max(err["dist"], err["closest"], err["face"]) <= 1e-5, err
    assert err["winding"] <= 1e-3, err


@pytest.mark.cuda
def test_contracted_build_is_close_on_card(card):
    """K1's source built with contraction: rounding differences only."""
    tri = _scene(card).tri
    pts = _points(11, 2000, card)
    err = sr.sweep_errors(mesh_closest_query_contracted_cuda(pts, tri),
                          tpt.mesh_closest_query(pts, tri), pts, tri)
    assert max(err["dist"], err["closest"], err["face"]) <= 1e-5, err


@pytest.mark.cuda
def test_fma_probe_matches_plain_on_card(card):
    """Fused multiply-adds against a multiply then an add: rtol 1e-5 in a
    recurrence that contracts (|a| < 1), at 1 and 2 iterations before the
    chains settle and at 100; with a = 1 each chain counts its steps, so the
    iteration count is checked too."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0.5, 0.9, 1000).astype(np.float32), device=card)
    y = torch.as_tensor(rng.uniform(0.01, 0.1, 1000).astype(np.float32), device=card)
    inputs = [(x, y, 1), (x, y, 2), (x, y, 100),
              (torch.ones_like(x), torch.full_like(y, 2.0 ** -10), 100)]
    for a, b, iters in inputs:
        before = fma_probe_cuda.launches
        out = fma_probe_cuda(a, b, iters)
        torch.cuda.synchronize()
        assert fma_probe_cuda.launches == before + 1
        ref = fma_probe(a, b, iters)
        assert ((out - ref).abs() / ref.abs()).max().item() <= 1e-5, iters
