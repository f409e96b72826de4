"""The port's CUDA kernel on the card: against its plain version, its launch
count and its input checks.  Imports neither JAX nor the JAX package, so it
runs on a GPU machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tests marked ``cuda`` skip without a CUDA device."""

import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch.ops import point_triangle as tpt
from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda


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


def test_wrapper_rejects_other_devices():
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mesh_closest_query_cuda(meta, torch.empty((2, 3, 3), device="meta"))


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
