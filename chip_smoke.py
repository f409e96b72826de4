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
5. chamfer metrics: ``PlausibleDiversity`` on a 16,384-face torus with
   32 estimated x 128 plausible poses x 500 model points (2.05 M point
   queries), once exact (the sweep kernel on every query) and once through a
   ``CachedSDF`` the kernel builds, each checked on a 4 x 4-pose subset
   against the plain sweep on the card;
6. the sweep's roofline probe (``bench/sweep_roofline.py``): the FP32
   multiply-add probe, the sweep without winding and the tensor-core sweep,
   each checked against its plain version on the card, then timed beside
   the sweep on the torus and at the capsule's cache-build grid;
7. the headline arm written as MJCF (mesh geoms on the same OBJ files):
   its 200 x 15,251 exact query must equal the URDF arm's;
8. one JSON line with every kernel's launches and times, then the result
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


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def sweep_cases(device, capsule_points=100_000):
    """``(name, points, triangles)`` every sweep kernel is held against its
    plain version on: ragged and tiny shapes, points on the surface, and the
    headline link mesh (the arm's capsule, edges 2-5 cm) with points up to
    1 m away, where the tensor-core sweep's expanded forms cancel most."""
    import pytorch_volumetric_tpu_torch as pt
    m = pt.mesh
    rng = np.random.default_rng(0)

    def rand_pts(n, lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (n, 3)).astype(np.float32), device=device)

    scene = m.MeshScene.from_mesh(m.icosphere_mesh(0.3, 2).concatenate(
        m.box_mesh((0.2, 0.3, 0.1), center=(0.4, 0.0, 0.0))), device=device)
    cases = [("icosphere+box", rand_pts(1000, -0.6, 0.8), scene.tri)]
    cases += [(f"ragged P={P}", rand_pts(P, -0.5, 0.5), scene.tri) for P in (1, 7, 129, 257)]
    cases.append(("box, F=12 < tile", rand_pts(300, -0.8, 0.8), torch.as_tensor(
        m.box_mesh((0.4, 0.6, 0.8)).triangles().astype(np.float32), device=device)))
    cases.append(("single triangle", rand_pts(300, -0.5, 0.5),
                  torch.tensor([[[0.0, 0, 0], [0.3, 0, 0], [0, 0.2, 0.1]]], device=device)))
    # points exactly on the surface (the normal override's regime)
    surf = m.icosphere_mesh(0.3, 2).sample_points_uniformly(500, seed=1)
    cases.append(("on-surface points", torch.as_tensor(surf.astype(np.float32), device=device),
                  scene.tri))
    cap_mesh = m.capsule_mesh(radius=0.045, height=0.18, segments=14, rings=5)
    bb = cap_mesh.aabb()
    cases.append((f"capsule, {capsule_points} points to 1 m away", torch.as_tensor(
        rng.uniform(bb[:, 0] - 1.0, bb[:, 1] + 1.0, (capsule_points, 3)).astype(np.float32),
        device=device), m.MeshScene.from_mesh(cap_mesh, device=device).tri))
    return cases


def compare_kernel(kind, case, pts, tri, device):
    """One launch of the sweep kernel ``sweep_roofline.SWEEPS[kind]`` against
    its plain version on one input; fails beyond its gates and returns its
    errors (``sweep_roofline.sweep_errors``).  The sweep kernel ("base")
    equals its plain version bit for bit, so it is held to the plain
    version's own closest point and to |winding| at every point; the probe's
    kernels to the closest point on the face they chose and to the winding
    off the surface."""
    from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr
    wrapper, plain, _ = sr.SWEEPS[kind]
    before = wrapper.launches
    out = wrapper(pts, tri)
    sync(device)
    if device.type == "cuda":
        check(wrapper.launches == before + 1, f"{kind}, {case}: no launch")
    ref = plain(pts, tri)
    d1, c1, f1, w1 = out
    check(d1.shape == ref[0].shape and c1.shape == ref[1].shape and f1.dtype == torch.int32,
          f"{kind}, {case}: output shapes")
    check(all(bool(torch.isfinite(t).all()) for t in (d1, c1, w1)),
          f"{kind}, {case}: non-finite output")
    e = sr.sweep_errors(out, ref, pts, tri)
    e["abs_winding"] = (w1.abs() - ref[3].abs()).abs().max().item()
    same_fid = (f1 == ref[2]).float().mean().item()
    log(f"    {case}: P={pts.shape[0]} F={tri.shape[0]} |d| {e['dist']:.3g}, |closest| "
        f"{e['closest_raw']:.3g} (on the chosen face {e['closest']:.3g}), face-contract "
        f"{e['face']:.3g}, |wind| {e['winding']:.3g} off the surface ({e['on_surface']} "
        f"points within {sr.WIND_MIN_DIST:g}), ||wind|| {e['abs_winding']:.3g} everywhere; "
        f"same face id {same_fid * 100:.2f}%")
    if kind == "base":
        check(e["dist"] <= 1e-5 and e["closest_raw"] <= 1e-5,
              f"{case}: distance/closest beyond 1e-5")
        check(e["abs_winding"] <= 1e-4, f"{case}: |winding| beyond 1e-4")
        check(e["face"] <= 1e-5, f"{case}: chosen face misses the minimal distance")
    else:
        check(sr.check_sweep(kind, e), f"{kind}, {case}: beyond its gates against the plain version")
    return e


def phase_kernel(device, capsule_points=100_000, grid_scale=1.0, reps=5):
    from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr
    from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda
    from pytorch_volumetric_tpu_torch.ops.point_triangle import mesh_closest_query

    err = 0.0
    for case, pts, tri in sweep_cases(device, capsule_points):
        e = compare_kernel("base", case, pts, tri, device)
        err = max(err, e["dist"], e["closest_raw"])

    # time it at the main path's shape: the capsule's cache-build grid
    # (resolution 0.02, padding 1.0), one launch over the whole grid
    grid, cap = sr.capsule_cache_grid(device, 0.02 / grid_scale)
    P, Fp, F = grid.shape[0], cap.tri.shape[0], cap.num_faces
    ms = time_ms(lambda: mesh_closest_query_cuda(grid, cap.tri), device, reps=reps)
    plain_ms = time_ms(lambda: mesh_closest_query(grid, cap.tri), device,
                       reps=max(1, reps // 2))
    bound_ms, bound_by = sr.sweep_bound_ms(P, F)
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


# ---------------------------------------------------------------------------
# phase 5: chamfer metrics
# ---------------------------------------------------------------------------

def random_poses(rng, n, rot_sigma, trans_sigma):
    """``n`` rigid transforms [n, 4, 4]: Rodrigues rotations of normal
    axis-angle vectors (``rot_sigma`` rad) and normal translations."""
    rv = rng.normal(0.0, rot_sigma, (n, 3))
    ang = np.linalg.norm(rv, axis=1)
    u = rv / np.maximum(ang, 1e-12)[:, None]
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -u[:, 2], u[:, 1], -u[:, 0]
    K = K - K.transpose(0, 2, 1)
    s, c = np.sin(ang)[:, None, None], np.cos(ang)[:, None, None]
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :3] = np.eye(3) + s * K + (1 - c) * (K @ K)
    m[:, :3, 3] = rng.normal(0.0, trans_sigma, (n, 3))
    return m


def chamfer_poses(device, n_est, n_plausible):
    """A ground-truth pose, plausible and estimated poses perturbed from it
    (0.05 rad, 1 cm), returned as ``(T_est_inv, T_p)`` float32 tensors."""
    rng = np.random.default_rng(0)
    gt = random_poses(rng, 1, 1.0, 0.1)
    T_p = gt @ random_poses(rng, n_plausible, 0.05, 0.01)
    T_est = gt @ random_poses(rng, n_est, 0.05, 0.01)
    return (torch.as_tensor(np.linalg.inv(T_est).astype(np.float32), device=device),
            torch.as_tensor(T_p.astype(np.float32), device=device))


def chamfer_subset_err(errors, ref):
    """Max relative error of a pairwise chamfer matrix's leading block."""
    k0, k1 = ref.shape
    return ((errors[:k0, :k1] - ref).abs() / ref.abs().clamp(min=1e-12)).max().item()


def phase_chamfer(device, tmp, card, n_est=32, n_plausible=128, n_points=500,
                  resolution=0.01, padding=0.06, reps=2, n_check=4):
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda

    path = os.path.join(tmp, "torus.obj")
    pt.mesh.save_obj(pt.mesh.torus_mesh(0.1, 0.03, 128, 64), path)
    factory = pt.MeshObjectFactory(path, device=device)
    pts, _, _ = pt.sample_mesh_points(factory, num_points=n_points, name=factory.name,
                                      dbpath=os.path.join(tmp, "model_points.npz"))
    T_est_inv, T_p = chamfer_poses(device, n_est, n_plausible)
    n_queries = n_est * n_plausible * n_points

    def evaluate(pd):
        errors = pd.compute_tf_pairwise_error_per_batch(T_est_inv, T_p)
        return errors, pd.do_evaluate_plausible_diversity_on_pairwise_chamfer_dist(errors)

    # exact: every model point of every pose pair through the sweep kernel
    mesh_closest_query_cuda.launches = 0
    t0 = time.perf_counter()
    pd = pt.PlausibleDiversity(factory, model_points_eval=pts)
    errors, ret = evaluate(pd)
    sync(device)
    first_s = time.perf_counter() - t0
    exact_launches = mesh_closest_query_cuda.launches
    check(errors.shape == (n_est, n_plausible), "chamfer: error matrix shape")
    check(bool(torch.isfinite(errors).all() and (errors >= 0).all()),
          "chamfer: non-finite or negative errors")
    exact_ms = time_ms(lambda: evaluate(pd), device, reps=reps, warmup=0)

    # cached: a CachedSDF the kernel builds, then nearest-voxel lookups
    mesh_closest_query_cuda.launches = 0
    t0 = time.perf_counter()
    obj_sdf = pt.CachedSDF(factory.name, resolution, factory.bounding_box(padding=padding),
                           pt.MeshSDF(factory), cache_path=os.path.join(tmp, "chamfer.npz"))
    sync(device)
    build_s = time.perf_counter() - t0
    pdc = pt.PlausibleDiversity(factory, model_points_eval=pts, obj_sdf=obj_sdf)
    errors_c, ret_c = evaluate(pdc)
    sync(device)
    cached_launches = mesh_closest_query_cuda.launches
    check(bool(torch.isfinite(errors_c).all()), "chamfer (cached): non-finite errors")
    cached_ms = time_ms(lambda: evaluate(pdc), device, reps=reps, warmup=0)

    # the plain sweep on the card, on a 4 x 4-pose subset: exact directly,
    # cached through a table the plain sweep builds
    plain = pt.PlausibleDiversity(factory, model_points_eval=pts,
                                  obj_sdf=pt.MeshSDF(factory, backend="torch"))
    ref = plain.compute_tf_pairwise_error_per_batch(T_est_inv[:n_check], T_p[:n_check])
    err_exact = chamfer_subset_err(errors, ref)
    ref_sdf = pt.CachedSDF(factory.name, resolution, factory.bounding_box(padding=padding),
                           pt.MeshSDF(factory, backend="torch"),
                           cache_path=os.path.join(tmp, "chamfer_plain.npz"))
    table_err = (obj_sdf.voxels.raw_data - ref_sdf.voxels.raw_data).abs().max().item()
    ref_c = pt.PlausibleDiversity(factory, model_points_eval=pts, obj_sdf=ref_sdf) \
        .compute_tf_pairwise_error_per_batch(T_est_inv[:n_check], T_p[:n_check])
    err_cached = chamfer_subset_err(errors_c, ref_c)
    log(f"  vs plain sweep ({n_check} x {n_check} poses): exact rel err {err_exact:.3g}, "
        f"cached rel err {err_cached:.3g} (cache table |err| {table_err:.3g})")
    check(err_exact <= 1e-5, "chamfer (exact): beyond 1e-5 relative of the plain sweep")
    check(err_cached <= 1e-5, "chamfer (cached): beyond 1e-5 relative of the plain sweep")
    log(f"  PlausibleDiversity {n_est} x {n_plausible} poses x {n_points} points "
        f"({n_queries} queries x {factory.scene.num_faces} faces): exact {exact_ms:.2f} ms "
        f"(first call {first_s * 1e3:.1f} ms), plausibility {ret.plausibility.item():.6g}, "
        f"coverage {ret.coverage.item():.6g}; cached: build {build_s:.3f} s "
        f"(grid {tuple(obj_sdf.voxels.shape)}), query {cached_ms:.3f} ms, "
        f"plausibility {ret_c.plausibility.item():.6g} [{card}]; kernel launches: "
        f"exact {exact_launches}, cached {cached_launches}")
    return exact_launches, cached_launches


# ---------------------------------------------------------------------------
# phase 6: the roofline probe's kernels
# ---------------------------------------------------------------------------

def phase_probe(device, card, reps=5):
    from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr
    from pytorch_volumetric_tpu_torch.ops.fma_probe import fma_probe_cuda

    errs = {"nowind": 0.0, "mxu": 0.0, "mxu_wind": 0.0}
    cases = sweep_cases(device)
    for kind in ("nowind", "mxu"):
        log(f"  {kind} vs its plain version:")
        for case, pts, tri in cases:
            e = compare_kernel(kind, case, pts, tri, device)
            errs[kind] = max(errs[kind], e["dist"], e["closest"])
            if kind == "mxu":
                errs["mxu_wind"] = max(errs["mxu_wind"], e["winding"])

    # the probe's own run (it checks each kernel against its plain version
    # at its first launch, then times it): the launches counted for them
    wrappers = [w for w, _, _ in sr.SWEEPS.values()] + [fma_probe_cuda]
    for w in wrappers:
        w.launches = 0
    out = sr.run(device, reps=reps)
    launches = {w.__name__: w.launches for w in wrappers}
    log(f"  launches in the probe run: {launches}")
    fma = out["fma"]
    log(f"  FP32 ceiling (fma_probe, {fma['n']} threads x {fma['iters']} x 32 FMAs): "
        f"{fma['tflops']:.3f} TFLOP/s in {fma['ms']:.4f} ms (bound {fma['bound_ms']:.4f} ms, "
        f"plain {fma['plain_ms']:.2f} ms, max rel err {fma['max_rel_err']:.3g} at 1, 2 and "
        f"{fma['iters']} iterations and counting steps) [{card}]")
    check(fma["ok"], "fma_probe: beyond rtol 1e-5 of the plain version, or above "
          f"{sr.GATE_FMA_PEAK} x the data-sheet peak")
    for cell in ("torus", "capsule_grid"):
        res = out[cell]
        log(f"  {cell} (P={res['points']} x F={res['faces']} real faces), 110-op model:")
        for name, r in res["sweeps"].items():
            e = r["errors"]
            log(f"    {name:9s} {r['ms']:9.3f} ms  {r['gpairs_s']:8.3f} G pairs/s  "
                f"{r['tflops_model']:6.3f} TFLOP/s = {100 * r['share_of_datasheet_peak']:.2f}% "
                f"of 67 TFLOP/s, {100 * r['share_of_measured_ceiling']:.2f}% of the measured "
                f"ceiling; bound {r['bound_ms']:.3f} ms"
                + (f"; plain {r['plain_ms']:.1f} ms" if "plain_ms" in r else "")
                + f"; errors |d| {e['dist']:.3g} |closest| {e['closest']:.3g} "
                f"face {e['face']:.3g} |wind| {e['winding']:.3g}")
            if r["gated"]:
                check(r["ok"], f"{name} on the {cell}: beyond its gates")
    check(out["ok"], "the roofline probe: a gate failed")
    return {"launches": launches, "fma": fma, "grid": out["capsule_grid"]["sweeps"],
            "errs": errs}


# ---------------------------------------------------------------------------
# phase 7: the arm as MJCF
# ---------------------------------------------------------------------------

def phase_mjcf(device, arm_dir, card, n_configs=N_CONFIGS, query_res=QUERY_RES, reps=3):
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda
    from pytorch_volumetric_tpu_torch.utils.robots import serial_arm_mjcf

    q, pts = headline_inputs(device, n_configs, query_res)
    mesh_closest_query_cuda.launches = 0
    robot = pt.RobotSDF(pt.build_serial_chain_from_mjcf(serial_arm_mjcf(), "link7",
                                                        device=device),
                        path_prefix=arm_dir)
    v, g, dq = query_objective_grad(robot, q, pts)
    sync(device)
    launches = mesh_closest_query_cuda.launches
    urdf = pt.RobotSDF(pt.build_serial_chain_from_urdf(
        open(os.path.join(arm_dir, "arm.urdf")).read(), "link7", device=device),
        path_prefix=arm_dir)
    check(robot.joint_names == urdf.joint_names, "MJCF robot: joint names differ")
    vu, gu, dqu = query_objective_grad(urdf, q, pts)
    err_v = (v - vu).abs().max().item()
    err_g = (g - gu).abs().max().item()
    err_dq = ((dq - dqu).abs() / dqu.abs().clamp(min=1.0)).max().item()
    log(f"  MJCF vs URDF arm ({q.shape[0]} x {pts.shape[0]}): |val| err {err_v:.3g}, "
        f"|grad| err {err_g:.3g}, d/dq rel err {err_dq:.3g}")
    check(err_v <= 1e-5 and err_g <= 1e-5, "MJCF robot: beyond 1e-5 of the URDF robot")
    check(err_dq <= 1e-5, "MJCF robot: d/dq beyond 1e-5 (relative) of the URDF robot")
    fwd_ms, fb_ms = time_robot(robot, q, pts, device, reps)
    log(f"  MJCF exact-link robot: forward {fwd_ms:.2f} ms, forward+backward {fb_ms:.2f} ms "
        f"[{card}]; kernel launches on the path: {launches}")
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
        log("== phase 5: chamfer metrics")
        chamfer_launches = phase_chamfer(device, tmp, card)
        check(min(chamfer_launches) > 0, "a chamfer run launched no kernel")
        log("== phase 6: roofline probe kernels vs plain versions")
        probe = phase_probe(device, card)
        for name, n in probe["launches"].items():
            check(n > 0, f"the probe run launched no {name}")
        log("== phase 7: the arm as MJCF")
        mjcf_launches = phase_mjcf(device, arm_dir, card)
        check(mjcf_launches > 0, "MJCF robot path launched no kernel")

    log("== phase 8: kernels")
    log(f"  closest_point_sweep launches: exact-link path {exact_launches}, cached-link "
        f"path {cached_launches}, chamfer exact/cached {chamfer_launches}, MJCF arm {mjcf_launches}; "
        f"total {time.perf_counter() - t_start:.1f} s")
    grid = probe["grid"]

    def probe_row(name, source, replaces, wrapper, r, err):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": probe["launches"][wrapper], "max_abs_err": err,
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    csrc = "pytorch_volumetric_tpu_torch/csrc/"
    log(json.dumps({"kernels": [
        {"name": "closest_point_sweep", "route": "cuda", "source": csrc + "closest_point.cu",
         "replaces": "pytorch_volumetric_tpu/ops/pallas/closest_point.py:62",
         "launches": cached_launches, "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None},
        probe_row("closest_point_sweep_nowind", csrc + "closest_point.cu",
                  "benchmarks/pallas_mxu_ab.py:48", "mesh_closest_query_nowind_cuda",
                  grid["nowind"], probe["errs"]["nowind"]),
        probe_row("closest_point_sweep_mma", csrc + "closest_point_mma.cu",
                  "benchmarks/pallas_mxu_ab.py:48", "mesh_closest_query_mma_cuda",
                  grid["mxu"], probe["errs"]["mxu"]),
        probe_row("fma_probe", csrc + "fma_probe.cu", "benchmarks/pallas_mfu.py:65",
                  "fma_probe_cuda", probe["fma"], probe["fma"]["max_abs_err"]),
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
