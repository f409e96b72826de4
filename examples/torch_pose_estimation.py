"""Object pose estimation by chamfer-distance gradient descent with the
port's exact mesh SDF (the twin of ``pose_estimation.py``).

Given points observed on an object's surface in the world frame, recover
the object's pose by minimizing the one-sided chamfer cost ``mean(sdf(T^-1
p)^2)``, differentiable end to end through the rigid transform and the
exact ``MeshSDF`` (the closest-point kernel runs on every step on the
card).  16 pose hypotheses are optimized together, then scored with
``batch_chamfer_dist``.

Run:  python examples/torch_pose_estimation.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch import mesh as mesh_mod
from pytorch_volumetric_tpu_torch import transforms as tfm
from pytorch_volumetric_tpu_torch.utils.batching import resolve_device

SMOKE = bool(os.environ.get("PVT_EXAMPLE_SMOKE"))


def rot_from_6d(r6):
    """Rotation matrices ``[B, 3, 3]`` (columns b1, b2, b3) from 6D
    parameters, by Gram-Schmidt."""
    a1, a2 = r6[..., :3], r6[..., 3:]
    b1 = a1 / (torch.linalg.vector_norm(a1, dim=-1, keepdim=True) + 1e-9)
    a2p = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = a2p / (torch.linalg.vector_norm(a2p, dim=-1, keepdim=True) + 1e-9)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="default: CUDA")
    dev = resolve_device(parser.parse_args(argv).device)

    # -- object + observed surface points in an unknown pose -----------------
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    m = mesh_mod.capsule_mesh(radius=0.08, height=0.3, segments=16, rings=6)
    d = tempfile.mkdtemp(prefix="pvt_pose_")
    path = os.path.join(d, "capsule.obj")
    mesh_mod.save_obj(m, path)
    obj = pt.MeshObjectFactory(path, device=dev)
    sdf = pt.MeshSDF(obj)

    pts_obj, _, _ = pt.sample_mesh_points(obj, num_points=200, seed=1, name="capsule",
                                          dbpath=os.path.join(d, "points.npz"))
    true_rot = tfm.euler_angles_to_matrix(torch.tensor([0.4, -0.3, 0.9]), "XYZ").numpy()
    true_pos = np.array([0.15, -0.1, 0.25], dtype=np.float32)
    pts_world = torch.as_tensor(pts_obj.cpu().numpy() @ true_rot.T + true_pos, device=dev)

    # -- B pose hypotheses, parameterized as (translation, 6D rotation) ------
    B = 16
    t = torch.as_tensor(rng.normal(0, 0.2, (B, 3)).astype(np.float32), device=dev)
    r6 = torch.tensor([1.0, 0, 0, 0, 1, 0]).repeat(B, 1) + 0.3 * torch.randn((B, 6),
                                                                             generator=gen)
    t.requires_grad_(True)
    r6 = r6.to(dev).requires_grad_(True)

    def loss_fn():
        R = rot_from_6d(r6)                                   # [B, 3, 3]
        # object-frame points of each hypothesis: R^T (p - t)
        p_obj = torch.einsum("bij,bni->bnj", R, pts_world[None] - t[:, None])
        dist, _ = sdf.raw_query(p_obj.reshape(-1, 3))
        return (dist.reshape(B, -1) ** 2).mean(dim=-1).sum()

    opt = torch.optim.Adam([t, r6], lr=2e-2)
    iters = 40 if SMOKE else 300
    for it in range(iters):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
        if it % 50 == 0 or it == iters - 1:
            print(f"iter {it:3d}  total chamfer {float(loss.detach()):.6f}", file=sys.stderr)

    # -- score final hypotheses with the library metric ----------------------
    with torch.no_grad():
        R = rot_from_6d(r6)
        world_to_obj = torch.eye(4, device=dev).repeat(B, 1, 1)
        world_to_obj[:, :3, :3] = R.transpose(1, 2)
        world_to_obj[:, :3, 3] = -torch.einsum("bij,bi->bj", R, t)
        err = pt.batch_chamfer_dist(world_to_obj, pts_world, obj_factory=obj, scale=1000.0)
        best = int(torch.argmin(err))
        pos_err = float(torch.linalg.vector_norm(t[best] - torch.as_tensor(true_pos, device=dev)))
    print(f"best hypothesis {best}: chamfer {float(err[best]):.3f}, "
          f"translation error {pos_err * 1000:.1f} mm", file=sys.stderr)
    if not SMOKE:  # smoke runs too few iterations to converge fully
        assert pos_err < 0.02, "pose estimate did not converge"
    assert np.isfinite(pos_err)
    print("ok")
    return pos_err


if __name__ == "__main__":
    main()
