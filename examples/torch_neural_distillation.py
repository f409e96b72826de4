"""Distill the port's exact robot SDF into a learned configuration-space
field (the twin of ``neural_distillation.py``).

1. The exact oracle: the procedural 7-DOF arm as a ``RobotSDF`` with
   cached link fields.
2. Distillation: ``fit_config_space_sdf`` samples (q, x, d, grad) tuples
   from the oracle and trains ``f(q, x)``, a sine MLP on Fourier-lifted
   points, with direct value and gradient supervision.
3. A collision-clearance descent through the learned field
   (``model.value``): the per-point cost is a few matrix products,
   independent of links, triangles and voxels, and the derivative w.r.t.
   the joint configuration is plain autograd.  The result is checked on
   the exact field.

Run:  python examples/torch_neural_distillation.py [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch.models import fit_config_space_sdf
from pytorch_volumetric_tpu_torch.utils.batching import resolve_device
from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm

# PVT_EXAMPLE_SMOKE=1: a tiny model and budget for the smoke test
SMOKE = bool(os.environ.get("PVT_EXAMPLE_SMOKE"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="default: CUDA")
    dev = resolve_device(parser.parse_args(argv).device)

    # -- 1. exact oracle -----------------------------------------------------
    d = tempfile.mkdtemp(prefix="pvt_neural_")
    urdf_path, end_link = make_serial_arm(d, num_joints=7)
    chain = pt.build_serial_chain_from_urdf(open(urdf_path).read(), end_link, device=dev)
    robot = pt.RobotSDF(chain, path_prefix=d, link_sdf_cls=pt.cache_link_sdf_factory(
        resolution=0.06 if SMOKE else 0.03, padding=0.15,
        cache_path=os.path.join(d, "cache.npz")))

    # -- 2. distillation -----------------------------------------------------
    t0 = time.perf_counter()
    model, losses = fit_config_space_sdf(
        robot, key=0, width=32 if SMOKE else 128, depth=3 if SMOKE else 4,
        fourier=16 if SMOKE else 64, n_configs=8 if SMOKE else 128,
        pts_per_config=64 if SMOKE else 1024, steps=30 if SMOKE else 1500,
        batch=256 if SMOKE else 4096, lr=1e-3, device=dev)
    print(f"distilled in {time.perf_counter() - t0:.1f}s; "
          f"loss {float(losses[:50].mean()):.4f} -> {float(losses[-50:].mean()):.4f}")

    # accuracy on held-out configurations
    rng = np.random.default_rng(7)
    lims = robot.chain.get_joint_limits()
    qs = torch.as_tensor(rng.uniform(lims[:, 0], lims[:, 1], (8, 7)).astype(np.float32),
                         device=dev)
    pts = torch.as_tensor(rng.uniform(-0.8, 0.8, (2048, 3)).astype(np.float32), device=dev)
    with torch.no_grad():
        robot.set_joint_configuration(qs)
        v_gt, _ = robot(pts)
        v, _ = model.set_joint_configuration(qs)(pts)
    err = (v - v_gt).cpu().numpy()
    shell = np.abs(v_gt.cpu().numpy()) < 0.1
    loss_last = float(losses[-1])
    assert np.isfinite(loss_last), loss_last
    print(f"held-out rmse: overall {np.sqrt((err ** 2).mean()):.4f}, "
          f"near-surface {np.sqrt((err[shell] ** 2).mean()):.4f}")

    # -- 3. clearance descent through the learned field ----------------------
    obstacles = torch.as_tensor(np.array([0.35, 0.0, 0.7], dtype=np.float32)
                                + 0.12 * rng.normal(size=(256, 3)).astype(np.float32),
                                device=dev)
    margin = 0.08
    q = torch.as_tensor(rng.uniform(-0.3, 0.3, (7,)).astype(np.float32),
                        device=dev).requires_grad_(True)
    opt = torch.optim.Adam([q], lr=3e-2)
    for _ in range(10 if SMOKE else 60):
        opt.zero_grad()
        loss = torch.relu(margin - model.value(q, obstacles)).pow(2).mean()
        loss.backward()
        opt.step()
    print(f"clearance loss after descent: {float(loss.detach()):.3e}")

    # verify against the EXACT field: did the descent through the learned
    # model clear the obstacles?
    with torch.no_grad():
        robot.set_joint_configuration(q.detach()[None])
        v_exact, _ = robot(obstacles)
    print(f"exact min clearance at solution: {float(v_exact.min()):.4f} "
          f"(margin target {margin})")
    return float(v_exact.min())


if __name__ == "__main__":
    main()
