#!/usr/bin/env python3
"""The port's config-space distillation against the JAX package's at the
same settings, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/neural_fit_parity_torch.py [--steps 1200]

Both packages distill the 2-joint procedural arm (exact mesh links) at the
JAX package's test settings (tests/test_neural_sdf.py: width 96, depth 4,
48 Fourier features, 64 configurations x 1,024 points, batch 4,096, lr
1e-3) and are scored as that test scores them: the loss's first and last
50 steps, the RMSE against the exact robot at 4 fresh configurations x
256 points, overall and in the |d| < 0.1 shell.  The two packages' random
streams differ, so the fits differ; the scores say whether they learn
alike.  Prints one line per package (a few minutes on the CPU)."""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1200)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    import pytorch_volumetric_tpu as pv
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu.models import fit_config_space_sdf
    from pytorch_volumetric_tpu.utils.robots import make_serial_arm

    kw = dict(width=96, depth=4, fourier=48, n_configs=64, pts_per_config=1024,
              steps=args.steps, batch=4096, lr=1e-3)
    with tempfile.TemporaryDirectory() as d:
        urdf, end = make_serial_arm(d, num_joints=2, segments=6, rings=2)
        text = open(urdf).read()
        robot_j = pv.RobotSDF(pv.build_serial_chain_from_urdf(text, end), path_prefix=d)
        robot_t = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device="cpu"),
                              path_prefix=d)
        rng = np.random.default_rng(3)
        lims = robot_j.chain.get_joint_limits()
        qs = rng.uniform(lims[:, 0], lims[:, 1], (4, 2)).astype(np.float32)
        pts = rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32)
        robot_j.set_joint_configuration(jnp.asarray(qs))
        v_gt = np.asarray(robot_j(jnp.asarray(pts))[0])
        shell = np.abs(v_gt) < 0.1
        for name in ("port", "jax"):
            t0 = time.perf_counter()
            if name == "jax":
                model, losses = fit_config_space_sdf(robot_j, key=0, **kw)
                v = np.asarray(model.set_joint_configuration(jnp.asarray(qs))(
                    jnp.asarray(pts))[0])
            else:
                model, losses = pt.fit_config_space_sdf(robot_t, 0, device="cpu", **kw)
                with torch.no_grad():
                    v = model.set_joint_configuration(torch.as_tensor(qs))(
                        torch.as_tensor(pts))[0].numpy()
            l = np.asarray(losses)
            err = v - v_gt
            print(f"{name}: {time.perf_counter() - t0:.1f} s on the CPU; loss "
                  f"{l[:50].mean():.5g} -> {l[-50:].mean():.5g}; RMSE overall "
                  f"{np.sqrt((err ** 2).mean()):.5f}, shell |d| < 0.1 "
                  f"({int(shell.sum())} points) {np.sqrt((err[shell] ** 2).mean()):.5f}",
                  flush=True)


if __name__ == "__main__":
    main()
