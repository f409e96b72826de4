"""Export the port's robot SDF for serving, then consume it through the two
files alone (the twin of ``serving_export.py``).

Producer: build the robot (URDF, meshes, voxel-cache sweep), then
``export_robot_query`` writes a ``torch.export`` program of the fused FK ->
per-link SDF -> min-union query and an ``.npz`` sidecar of the per-link
tables.

Consumer: ``load_robot_query`` needs only those two files: no URDF, no
mesh, no cache build.  The program keeps its analytic backward, so the
derivative w.r.t. the joint angles works in the serving process.

Run:  python examples/torch_serving_export.py [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch.utils.batching import resolve_device
from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm
from pytorch_volumetric_tpu_torch.utils.serving import export_robot_query, load_robot_query

SMOKE = bool(os.environ.get("PVT_EXAMPLE_SMOKE"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="default: CUDA")
    dev = resolve_device(parser.parse_args(argv).device)
    d = tempfile.mkdtemp(prefix="pvt_serving_")
    M = 3 if SMOKE else 7

    # -- producer ------------------------------------------------------------
    urdf_path, end_link = make_serial_arm(d, num_joints=M)
    chain = pt.build_serial_chain_from_urdf(open(urdf_path).read(), end_link, device=dev)
    robot = pt.RobotSDF(chain, path_prefix=d, link_sdf_cls=pt.cache_link_sdf_factory(
        resolution=0.06 if SMOKE else 0.03, padding=0.15,
        cache_path=os.path.join(d, "cache.npz")))
    artifact = os.path.join(d, "arm_query.pt2")
    export_robot_query(robot, n_configs=16, n_points=1024, path=artifact)
    print(f"artifact: {os.path.getsize(artifact)} B, tables sidecar: "
          f"{os.path.getsize(artifact + '.tables.npz')} B")

    # -- consumer (only the two files) ---------------------------------------
    query = load_robot_query(artifact, device=dev)
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.uniform(-0.5, 0.5, (16, M)).astype(np.float32), device=dev)
    pts = torch.as_tensor(rng.uniform(-0.6, 0.6, (1024, 3)).astype(np.float32), device=dev)
    with torch.no_grad():
        val, grad = query(q, pts)
    print(f"query ok: val {tuple(val.shape)}, grad {tuple(grad.shape)}, "
          f"min clearance {float(val.min()):.4f}")

    # gradient-based planning in the serving process: push the configurations
    # away from the points
    qq = q.clone().requires_grad_(True)
    loss = torch.relu(0.05 - query(qq, pts)[0]).pow(2).sum()
    (g,) = torch.autograd.grad(loss, qq)
    assert bool(torch.isfinite(g).all())
    print(f"joint-angle gradient through the artifact: |g| = {float(g.abs().sum()):.4f}")
    return float(g.abs().sum())


if __name__ == "__main__":
    main()
