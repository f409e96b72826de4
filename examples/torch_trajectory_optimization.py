"""Gradient-based trajectory optimization through the port's differentiable
robot SDF (the twin of ``trajectory_optimization.py``).

A 7-DOF arm moves between two configurations while keeping clearance from
an obstacle point cloud.  Batched FK over every waypoint, per-link cached
SDF lookups of the obstacle points, the min-union, a hinge clearance loss
and a smoothness prior are differentiated w.r.t. the whole trajectory by
autograd (the lookups' derivatives are their analytic gradients).

Run:  python examples/torch_trajectory_optimization.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch.sdf import compose_query
from pytorch_volumetric_tpu_torch.utils.batching import resolve_device
from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm

# PVT_EXAMPLE_SMOKE=1 shrinks every knob so the smoke test runs each example
# end to end in seconds on the same code paths
SMOKE = bool(os.environ.get("PVT_EXAMPLE_SMOKE"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="default: CUDA")
    dev = resolve_device(parser.parse_args(argv).device)

    # -- robot: procedural 7-DOF capsule arm with voxel-cached link SDFs -----
    d = tempfile.mkdtemp(prefix="pvt_example_")
    urdf_path, end_link = make_serial_arm(d, num_joints=7)
    chain = pt.build_serial_chain_from_urdf(open(urdf_path).read(), end_link, device=dev)
    robot = pt.RobotSDF(chain, path_prefix=d, link_sdf_cls=pt.cache_link_sdf_factory(
        resolution=0.06 if SMOKE else 0.03, padding=0.15,
        cache_path=os.path.join(d, "cache.npz")))

    # -- obstacle: a ball of points the arm must clear -----------------------
    rng = np.random.default_rng(0)
    center = np.array([0.35, 0.0, 0.7], dtype=np.float32)
    obstacle = torch.as_tensor(
        center + 0.12 * rng.normal(size=(64 if SMOKE else 256, 3)).astype(np.float32),
        device=dev)

    # -- trajectory: T waypoints between fixed endpoints ---------------------
    T, M = (8 if SMOKE else 24), 7
    q_start = torch.zeros(M, device=dev)
    q_goal = torch.tensor([1.2, -0.6, 0.8, 0.9, -0.5, 0.4, 0.0], device=dev)
    alphas = torch.linspace(0.0, 1.0, T, device=dev)[:, None]
    q_init = q_start * (1 - alphas) + q_goal * alphas  # straight line

    children = tuple(s.raw_query for s in robot.sdf.sdfs)
    margin = 0.08

    def loss_fn(q_mid):
        q = torch.cat([q_start[None], q_mid, q_goal[None]])  # [T, M]
        m, m_inv = robot._link_transforms(q)
        # negative SDF = penetration; hinge at `margin` clearance
        sdf_val, _ = compose_query(children, m, m_inv, T, obstacle)
        clearance = (margin - sdf_val).clamp(min=0.0).pow(2).sum()
        smooth = (q[1:] - q[:-1]).pow(2).sum()
        return 40.0 * clearance + smooth, sdf_val.min()

    q_mid = q_init[1:-1].clone().requires_grad_(True)
    opt = torch.optim.Adam([q_mid], lr=3e-2)
    iters = 25 if SMOKE else 120
    for it in range(iters):
        opt.zero_grad()
        loss, min_sdf = loss_fn(q_mid)
        loss.backward()
        opt.step()
        if it % 20 == 0 or it == iters - 1:
            print(f"iter {it:3d}  loss {float(loss.detach()):8.4f}  "
                  f"min clearance {float(min_sdf):+.3f} m", file=sys.stderr)

    # re-evaluate at the final iterate (the loop reports the pre-update value)
    with torch.no_grad():
        final_min = float(loss_fn(q_mid)[1])
    print(f"final min clearance along trajectory: {final_min:+.3f} m "
          f"(target > 0, margin {margin})", file=sys.stderr)
    if not SMOKE:  # few smoke iterations may not fully clear
        assert final_min > 0.0, "trajectory still in collision"
    print("ok")
    return final_min


if __name__ == "__main__":
    main()
