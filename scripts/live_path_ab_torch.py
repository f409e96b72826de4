#!/usr/bin/env python3
"""Times of the port's live query paths, to compare two checkouts on one GPU.

    python3 scripts/live_path_ab_torch.py --tree DIR [--label NAME] [--reps N]

Imports ``pytorch_volumetric_tpu_torch`` and ``chip_smoke``'s headline
inputs from the checkout ``DIR``, builds the headline arm (7-DOF
``make_serial_arm``) with cached links (``cache_link_sdf_factory(0.02,
1.0)``), exact ``MeshSDF`` links and narrow-band links
(``narrow_band_link_sdf_factory()``), and times ``RobotSDF.query``'s
forward and forward + backward (``d(v.sum() + g.sum())/dq``) over 200
configurations x 15,251 points, the cached arm's ``query_grid`` (forward,
forward + backward, values only), and the host time of one call of each
kernel's wrapper on 32 points (launch-bound, so the wrapper's own
dispatch shows).  Prints one JSON line.  Run it on two trees in turns in
one call (parent, change, change, parent) to compare them on one card.
"""

import argparse
import json
import os
import sys
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="the checkout to import the port from")
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda
    from pytorch_volumetric_tpu_torch.ops.narrow_band_cuda import narrow_band_query_cuda
    from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    assert os.path.dirname(pt.__file__).startswith(tree), pt.__file__
    device = torch.device("cuda", 0)
    out = {"label": args.label or tree, "device": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as tmp:
        arm_dir = os.path.join(tmp, "arm")
        make_serial_arm(arm_dir, num_joints=7)
        text = open(os.path.join(arm_dir, "arm.urdf")).read()
        q, pts = cs.headline_inputs(device)

        def arm(link_sdf_cls):
            return pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                               path_prefix=arm_dir, link_sdf_cls=link_sdf_cls)

        arms = {"cached": arm(pt.cache_link_sdf_factory(
                    resolution=0.02, padding=1.0, cache_path=os.path.join(tmp, "c.npz"))),
                "exact": arm(pt.MeshSDF),
                "narrow_band": arm(pt.narrow_band_link_sdf_factory(
                    cache_path=os.path.join(tmp, "nb.npz")))}
        for name, robot in arms.items():
            fwd, fb = cs.time_robot(robot, q, pts, device, args.reps)
            out[f"{name}_fwd_ms"], out[f"{name}_fb_ms"] = fwd, fb
        robot = arms["cached"]
        qr, res = cs.QUERY_RANGE, cs.QUERY_RES

        def grid_fwd():
            with torch.no_grad():
                robot.query_grid(q, qr, res)

        def grid_fb():
            qq = q.detach().clone().requires_grad_(True)
            v, g = robot.query_grid(qq, qr, res)
            torch.autograd.grad(v.sum() + g.sum(), qq)

        out["grid_fwd_ms"] = cs.time_ms(grid_fwd, device, reps=args.reps)
        out["grid_fb_ms"] = cs.time_ms(grid_fb, device, reps=args.reps)
        out["grid_values_only_ms"] = cs.time_ms(
            lambda: robot.query_grid(q, qr, res, values_only=True), device, reps=args.reps)

        # one wrapper call on 32 points: host time per call over 500 calls
        few = pts[:32].contiguous()
        scene = arms["exact"].sdf.sdfs[1].obj_factory.scene
        link = arms["narrow_band"].sdf.sdfs[1]
        calls = {"k1_call_us": lambda: mesh_closest_query_cuda(few, scene.tri,
                                                               exterior_box=scene.exterior_box),
                 "nb_call_us": lambda: narrow_band_query_cuda(link.tables.smalls,
                                                              link.tables.big, few)}
        for key, call in calls.items():
            for _ in range(50):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                call()
            torch.cuda.synchronize()
            out[key] = (time.perf_counter() - t0) / 500 * 1e6
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
