#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytorch_volumetric_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. setup: the card's name and power limit, TF32 off, every kernel built from
   ``pytorch_volumetric_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel);
2. the closest-point + winding kernel against its plain PyTorch version on
   the card, on ragged and tiny shapes and at the headline shapes, with its
   time, the plain version's time and the derived bound;
3. the exact-link robot (7-DOF arm, ``MeshSDF`` links: the kernel on every
   query), 200 configurations x 15,251 points, checked against the plain
   sweep on the card;
4. the headline cached-link robot (``cache_link_sdf_factory(0.02, 1.0)``):
   cache build, then 200 x 15,251 value+gradient queries and their gradient
   w.r.t. the joint angles, checked against the CPU path on the same tables;
5. one JSON line with every kernel's launches and times, then the result
   line ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense, 700 W): FP32 outside the tensor cores
# and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per point-triangle pair in the sweep, the count the JAX
# package's cost model uses (ops/pallas/closest_point.py); the 3 square
# roots, ~5 divisions and the atan2 of each pair are on top of it
FLOPS_PER_PAIR = 110

N_CONFIGS = 200
QUERY_RANGE = np.array([[-1.0, 0.5], [0.02, 0.02], [-0.2, 0.8]])
QUERY_RES = 0.01
N_CHECK = 8


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def log(msg):
    print(msg, flush=True)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps=5, warmup=1):
    """Median wall time of ``fn()`` in ms, each run ended by a device
    synchronise (CUDA events on the card)."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def sweep_bound_ms(n_points, n_faces):
    """Least time for a sweep of ``n_points`` over ``n_faces`` real
    triangles: the larger of its FP32 operations over the FP32 peak and its
    bytes (points and triangles read once, 24 B of outputs per point
    written once) over the memory rate."""
    ops_s = n_points * n_faces * FLOPS_PER_PAIR / PEAK_FP32_FLOPS
    bytes_s = (n_points * (12 + 24) + n_faces * 36) / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def face_contract_err(pts, tri, fid, dist_ref):
    """The chosen face must reach the minimal distance (ties on shared
    edges, vertices and coplanar faces may pick any tied face)."""
    from pytorch_volumetric_tpu_torch.ops.point_triangle import _closest_point_bary
    chosen = tri.index_select(0, fid)
    d2, _ = _closest_point_bary(pts[:, None, :], chosen[:, None, 0],
                                (chosen[:, 1] - chosen[:, 0])[:, None],
                                (chosen[:, 2] - chosen[:, 0])[:, None])
    return (torch.sqrt(d2[:, 0]) - dist_ref).abs().max().item()


def compare_sweep(name, pts, tri, device):
    """Kernel vs plain version on one input; returns the max abs error of
    distances and closest points."""
    from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda
    from pytorch_volumetric_tpu_torch.ops.point_triangle import mesh_closest_query
    before = mesh_closest_query_cuda.launches
    d1, c1, f1, w1 = mesh_closest_query_cuda(pts, tri)
    sync(device)
    if device.type == "cuda":
        check(mesh_closest_query_cuda.launches == before + 1, f"{name}: no launch")
    d0, c0, f0, w0 = mesh_closest_query(pts, tri)
    check(d1.shape == d0.shape and c1.shape == c0.shape and f1.dtype == torch.int32,
          f"{name}: output shapes")
    check(bool(torch.isfinite(d1).all() and torch.isfinite(c1).all()
               and torch.isfinite(w1).all()), f"{name}: non-finite output")
    err_d = (d1 - d0).abs().max().item()
    err_c = (c1 - c0).abs().max().item()
    err_w = (w1.abs() - w0.abs()).abs().max().item()
    err_f = face_contract_err(pts, tri, f1, d0)
    same_fid = (f1 == f0).float().mean().item()
    log(f"  {name}: P={pts.shape[0]} F={tri.shape[0]} |d|err={err_d:.3g} "
        f"|closest|err={err_c:.3g} |wind|err={err_w:.3g} face-contract err={err_f:.3g} "
        f"same face id {same_fid * 100:.2f}%")
    check(err_d <= 1e-5 and err_c <= 1e-5, f"{name}: distance/closest beyond 1e-5")
    check(err_w <= 1e-4, f"{name}: |winding| beyond 1e-4")
    check(err_f <= 1e-5, f"{name}: chosen face misses the minimal distance")
    return max(err_d, err_c)


def phase_kernel(device, capsule_points=100_000, grid_scale=1.0, reps=5):
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda
    from pytorch_volumetric_tpu_torch.ops.point_triangle import mesh_closest_query

    m = pt.mesh
    rng = np.random.default_rng(0)

    def rand_pts(n, lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (n, 3)).astype(np.float32), device=device)

    scene = m.MeshScene.from_mesh(m.icosphere_mesh(0.3, 2).concatenate(
        m.box_mesh((0.2, 0.3, 0.1), center=(0.4, 0.0, 0.0))), device=device)
    box_raw = torch.as_tensor(m.box_mesh((0.4, 0.6, 0.8)).triangles().astype(np.float32),
                              device=device)
    one_tri = torch.tensor([[[0.0, 0, 0], [0.3, 0, 0], [0, 0.2, 0.1]]], device=device)
    err = 0.0
    err = max(err, compare_sweep("icosphere+box", rand_pts(1000, -0.6, 0.8), scene.tri, device))
    for P in (1, 7, 129, 257):
        err = max(err, compare_sweep(f"ragged P={P}", rand_pts(P, -0.5, 0.5), scene.tri, device))
    err = max(err, compare_sweep("box, F=12 < tile", rand_pts(300, -0.8, 0.8), box_raw, device))
    err = max(err, compare_sweep("single triangle", rand_pts(300, -0.5, 0.5), one_tri, device))
    # points exactly on the surface (the normal override's regime)
    mesh = m.icosphere_mesh(0.3, 2)
    surf = torch.as_tensor(mesh.sample_points_uniformly(500, seed=1).astype(np.float32),
                           device=device)
    err = max(err, compare_sweep("on-surface points", surf, scene.tri, device))

    # the headline link mesh (the arm's capsule) at 1e5 points
    cap_mesh = m.capsule_mesh(radius=0.045, height=0.18, segments=14, rings=5)
    cap = m.MeshScene.from_mesh(cap_mesh, device=device)
    bb = cap_mesh.aabb()
    lo, hi = bb[:, 0] - 1.0, bb[:, 1] + 1.0
    err = max(err, compare_sweep("capsule 1e5", torch.as_tensor(
        rng.uniform(lo, hi, (capsule_points, 3)).astype(np.float32), device=device),
        cap.tri, device))

    # time it at the main path's shape: the capsule's cache-build grid
    # (resolution 0.02, padding 1.0), one launch over the whole grid
    res = 0.02 / grid_scale
    rng_grid = pt.get_divisible_range_by_resolution(res, np.stack([lo, hi], axis=1))
    _, grid = pt.get_coordinates_and_points_in_grid(res, rng_grid, device=device)
    P, Fp, F = grid.shape[0], cap.tri.shape[0], cap.num_faces
    ms = time_ms(lambda: mesh_closest_query_cuda(grid, cap.tri), device, reps=reps)
    plain_ms = time_ms(lambda: mesh_closest_query(grid, cap.tri), device,
                       reps=max(1, reps // 2))
    bound_ms, bound_by = sweep_bound_ms(P, F)
    log(f"  timing (capsule cache-build grid, one launch): P={P} x Fp={Fp} "
        f"(F={F} real): kernel {ms:.3f} ms = {P * Fp / ms / 1e6:.4g} G padded pairs/s "
        f"= {P * F / ms / 1e6:.4g} G real pairs/s; bound {bound_ms:.3f} ms ({bound_by}); "
        f"plain {plain_ms:.3f} ms; no single PyTorch call computes this function")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "pairs": P * Fp}


# ---------------------------------------------------------------------------
# robot phases
# ---------------------------------------------------------------------------

def headline_inputs(device, n_configs=N_CONFIGS, query_res=QUERY_RES):
    """The reference benchmark's 200 joint configurations (seeded) and
    151 x 1 x 101 query grid."""
    import pytorch_volumetric_tpu_torch as pt
    rng = np.random.default_rng(0)
    th0 = np.array([0.0, -np.pi / 4, 0.0, np.pi / 2, 0.0, np.pi / 4, 0.0], dtype=np.float32)
    th = np.concatenate([th0[None], th0 + rng.normal(0, 0.1, (n_configs - 1, 7))])
    q = torch.as_tensor(th.astype(np.float32), device=device)
    _, pts = pt.get_coordinates_and_points_in_grid(query_res, QUERY_RANGE, device=device)
    return q, pts


def query_objective_grad(robot, q, pts):
    """``d (v.sum() + g.sum()) / d q`` (the benchmark's objective)."""
    qq = q.detach().clone().requires_grad_(True)
    v, g = robot.query(qq, pts)
    (dq,) = torch.autograd.grad(v.sum() + g.sum(), qq)
    return v.detach(), g.detach(), dq


def time_robot(robot, q, pts, device, reps):
    def fwd():
        with torch.no_grad():
            robot.query(q, pts)

    def fwd_bwd():
        query_objective_grad(robot, q, pts)

    return time_ms(fwd, device, reps=reps), time_ms(fwd_bwd, device, reps=reps)


def phase_exact_robot(device, arm_dir, card, n_configs=N_CONFIGS, query_res=QUERY_RES,
                      reps=3):
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda

    text = open(os.path.join(arm_dir, "arm.urdf")).read()
    q, pts = headline_inputs(device, n_configs, query_res)

    mesh_closest_query_cuda.launches = 0
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=arm_dir)
    v, g, dq = query_objective_grad(robot, q, pts)
    sync(device)
    launches = mesh_closest_query_cuda.launches
    check(v.shape == (n_configs, pts.shape[0]) and g.shape == v.shape + (3,),
          "exact robot: output shape")
    check(bool(torch.isfinite(v).all() and torch.isfinite(g).all()
               and torch.isfinite(dq).all()), "exact robot: non-finite output")
    check(bool((v < 0).any() and (v > 0).any()), "exact robot: no inside/outside points")

    plain = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=arm_dir,
                        link_sdf_cls=lambda f: pt.MeshSDF(f, backend="torch"))
    vp, gp, dqp = query_objective_grad(plain, q[:N_CHECK], pts)
    err_v = (v[:N_CHECK] - vp).abs().max().item()
    err_g = (g[:N_CHECK] - gp).abs().max().item()
    err_dq = ((dq[:N_CHECK] - dqp).abs() / dqp.abs().clamp(min=1.0)).max().item()
    log(f"  exact robot vs plain sweep ({N_CHECK} configs): |val| err {err_v:.3g}, "
        f"|grad| err {err_g:.3g}, d/dq rel err {err_dq:.3g}")
    check(err_v <= 1e-5, "exact robot: values beyond 1e-5 of the plain sweep")
    check(err_dq <= 1e-4, "exact robot: d/dq beyond 1e-4 (relative) of the plain sweep")

    fwd_ms, fb_ms = time_robot(robot, q, pts, device, reps)
    n = q.shape[0] * pts.shape[0]
    log(f"  exact robot {q.shape[0]} x {pts.shape[0]}: forward {fwd_ms:.2f} ms "
        f"({n / fwd_ms / 1e3:.4g} M queries/s), forward+backward {fb_ms:.2f} ms "
        f"[{card}]; kernel launches on the path: {launches}")
    return launches


def phase_cached_robot(device, arm_dir, cache_dir, card, n_configs=N_CONFIGS,
                       query_res=QUERY_RES, resolution=0.02, reps=5):
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda

    text = open(os.path.join(arm_dir, "arm.urdf")).read()
    cache_path = os.path.join(cache_dir, "sdf_cache.npz")
    q, pts = headline_inputs(device, n_configs, query_res)

    # the main path: cache build (the kernel sweeps every unique link mesh
    # over its grid), then the batched value + gradient query and its
    # gradient w.r.t. the joint angles
    mesh_closest_query_cuda.launches = 0
    t0 = time.perf_counter()
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=arm_dir,
                        link_sdf_cls=pt.cache_link_sdf_factory(
                            resolution=resolution, padding=1.0, cache_path=cache_path))
    sync(device)
    build_s = time.perf_counter() - t0
    v, g, dq = query_objective_grad(robot, q, pts)
    sync(device)
    launches = mesh_closest_query_cuda.launches
    grids = [tuple(s.voxels.shape) for s in robot.sdf.sdfs]
    log(f"  cache build {build_s:.3f} s for {len(grids)} links, grids {sorted(set(grids))}")
    check(v.shape == (n_configs, pts.shape[0]) and g.shape == v.shape + (3,),
          "cached robot: output shape")
    check(bool(torch.isfinite(v).all() and torch.isfinite(g).all()
               and torch.isfinite(dq).all()), "cached robot: non-finite output")
    check(bool((v < 0).any() and (v > 0).any()), "cached robot: no inside/outside points")

    # the CPU path on the same tables (read back from the cache the build wrote)
    cpu = torch.device("cpu")
    ref = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=cpu),
                      path_prefix=arm_dir,
                      link_sdf_cls=pt.cache_link_sdf_factory(
                          resolution=resolution, padding=1.0, cache_path=cache_path))
    qc, pc = q[:N_CHECK].cpu(), pts.cpu()
    vc, gc, _ = query_objective_grad(ref, qc, pc)
    # nearest keys on both devices: a key may flip only where the point is
    # within rounding of a voxel boundary
    m_dev, _ = robot._link_transforms(q[:N_CHECK])
    m_cpu, _ = ref._link_transforms(qc)
    flipped = torch.zeros(vc.shape, dtype=torch.bool)
    S = len(robot.sdf.sdfs)
    for i, child in enumerate(ref.sdf.sdfs):
        lo = torch.as_tensor(child.voxels.lo.astype(np.float32))
        inv_res = torch.as_tensor(np.float32(1) / child.voxels.res.astype(np.float32))
        sl = slice(i * N_CHECK, (i + 1) * N_CHECK)
        f_dev = ((pt.transforms.transform_points(m_dev[sl], pts).cpu() - lo) * inv_res)
        f_cpu = (pt.transforms.transform_points(m_cpu[sl], pc) - lo) * inv_res
        k_dev, k_cpu = torch.round(f_dev), torch.round(f_cpu)
        diff = (k_dev != k_cpu).any(dim=-1)
        border = ((f_cpu - torch.floor(f_cpu) - 0.5).abs() < 1e-3).any(dim=-1)
        check(bool((border | ~diff).all()), f"link {i}: a nearest key moved off a boundary")
        flipped |= diff
    keep = ~flipped
    err_v = (v[:N_CHECK].cpu() - vc)[keep].abs().max().item()
    err_g = (g[:N_CHECK].cpu() - gc)[keep].abs().max().item()
    log(f"  cached robot vs CPU path ({N_CHECK} configs, {S} links): |val| err {err_v:.3g}, "
        f"|grad| err {err_g:.3g}; borderline points with a flipped key: "
        f"{int(flipped.sum())} of {flipped.numel()}")
    check(err_v <= 1e-5, "cached robot: values beyond 1e-5 of the CPU path")

    fwd_ms, fb_ms = time_robot(robot, q, pts, device, reps)
    n = q.shape[0] * pts.shape[0]
    log(f"  cached robot {q.shape[0]} x {pts.shape[0]}: cache build {build_s:.3f} s, "
        f"forward {fwd_ms:.3f} ms ({n / fwd_ms / 1e3:.4g} M queries/s), forward+backward "
        f"{fb_ms:.3f} ms ({n / fb_ms / 1e3:.4g} M queries/s) [{card}]; "
        f"kernel launches on the path: {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one CUDA device")
    import pytorch_volumetric_tpu_torch  # noqa: F401  (fails outside a checkout)
    from pytorch_volumetric_tpu_torch.ops import cuda_build
    from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    log("== phase 1: setup")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is enabled")
    t0 = time.perf_counter()
    built = cuda_build.build()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, out) in built.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    log("== phase 2: closest-point kernel vs plain version")
    k1 = phase_kernel(device)

    with tempfile.TemporaryDirectory() as tmp:
        arm_dir = os.path.join(tmp, "arm")
        make_serial_arm(arm_dir, num_joints=7)
        log("== phase 3: exact-link robot")
        exact_launches = phase_exact_robot(device, arm_dir, card)
        check(exact_launches > 0, "exact robot path launched no kernel")
        log("== phase 4: headline cached-link robot")
        cached_launches = phase_cached_robot(device, arm_dir, tmp, card)
        check(cached_launches > 0, "cached robot path launched no kernel")

    log("== phase 5: kernels")
    log(f"  launches: exact-link path {exact_launches}, cached-link path {cached_launches}; "
        f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "closest_point_sweep", "route": "cuda",
        "source": "pytorch_volumetric_tpu_torch/csrc/closest_point.cu",
        "replaces": "pytorch_volumetric_tpu/ops/pallas/closest_point.py:62",
        "launches": cached_launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
