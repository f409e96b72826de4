"""One rank of the port's two-process gloo run (``tests/test_torch_parallel.py``).

    python torch_parallel_worker.py RANK PORT DIR

``DIR`` holds ``inputs.npz`` (the queries, the arm's and the wrench's
triangle tables from the JAX package) and ``wrench_factory.pkl`` (a pickled
``MeshObjectFactory``).  The rank joins a world of two on
``localhost:PORT`` (CPU, gloo), runs the sharded robot query on 2x1 and 1x2
meshes, ``TriangleShardedMeshSDF`` over a 2-way triangle axis (1D, and 2D
with a point axis) and five collision steps on 1x2, and writes its local
blocks to ``DIR/rank{RANK}.npz``.  It imports nothing of JAX.
"""

import json
import os
import pickle
import sys

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch import parallel, state
from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm

ARM = dict(num_joints=3, segments=6, rings=2)
MESHES = ((2, 1), (1, 2))


def main(rank: int, port: str, work: str) -> None:
    torch.set_num_threads(1)  # tiny shapes; the test's other workers share the cores
    assert parallel.init_distributed(f"localhost:{port}", num_processes=2, process_id=rank,
                                     device="cpu") == (rank, 2)
    inp = dict(np.load(os.path.join(work, "inputs.npz")))
    arm_dir = os.path.join(work, f"arm{rank}")
    urdf, end = make_serial_arm(arm_dir, **ARM)
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(open(urdf).read(), end, device="cpu"),
                        path_prefix=arm_dir)
    n_links = len(robot.sdf.sdfs)
    state.load_robot_tables(robot, [{"tri": inp[f"tri{i}"], "normals": inp[f"normals{i}"]}
                                    for i in range(n_links)])
    out, audits = {}, {}
    for nc, npt in MESHES:
        mesh = parallel.make_device_mesh(n_config=nc, n_point=npt, device="cpu")
        fn = parallel.sharded_robot_query(robot, mesh)
        v, g = fn(inp["q"], inp["pts"])
        out[f"v_{nc}x{npt}"], out[f"g_{nc}x{npt}"] = v.to_local(), g.to_local()
        audits[f"{nc}x{npt}"] = parallel.audit_sharded_callable(fn, inp["q"], inp["pts"])

    with open(os.path.join(work, "wrench_factory.pkl"), "rb") as f:
        fac = pickle.load(f)
    fac._scene = state.scene_from_numpy(inp["wrench_tri"], inp["wrench_normals"],
                                        fac.scene.num_faces, device="cpu")
    wp = torch.as_tensor(inp["wrench_pts"])
    mesh1d = init_device_mesh("cpu", (2,), mesh_dim_names=("tri",))
    sharded = parallel.TriangleShardedMeshSDF(fac, mesh1d)
    out["tri_v"], out["tri_g"] = sharded(wp)
    out["tri_dist"], out["tri_closest"], _, out["tri_wind"] = sharded.full_query(wp)
    p = wp.clone().requires_grad_(True)
    (out["tri_dp"],) = torch.autograd.grad(sharded.raw_query(p)[0].sum(), p)
    for shape in ((2, 1), (1, 2)):
        mesh2d = init_device_mesh("cpu", shape, mesh_dim_names=("tri", "point"))
        s2 = parallel.TriangleShardedMeshSDF(fac, mesh2d, axis="tri", point_axis="point")
        v2, g2 = s2(wp)
        tag = f"{shape[0]}x{shape[1]}"
        out[f"tri2d_v_{tag}"], out[f"tri2d_g_{tag}"] = v2.to_local(), g2.to_local()

    mesh = parallel.make_device_mesh(n_config=1, n_point=2, device="cpu")
    step = parallel.make_collision_step(robot, lambda ps: torch.optim.Adam(ps, lr=0.05),
                                        margin=0.15, mesh=mesh)
    q, st = inp["q_step"], step.init(inp["q_step"])
    losses = []
    for _ in range(5):
        q, st, loss = step(q, st, inp["pts"])
        losses.append(float(loss))
    out["step_q"], out["step_losses"] = q.to_local(), np.asarray(losses)
    audits["step"] = parallel.audit_sharded_callable(step, q, st, inp["pts"])

    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()})
    print(f"DIST_OK {rank} " + json.dumps(audits), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
