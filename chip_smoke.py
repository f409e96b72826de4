#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytorch_volumetric_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. setup: the card's name and power limit, TF32 off, every kernel built from
   ``pytorch_volumetric_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) and, beside them, the host runtime from
   ``pytorch_volumetric_tpu_torch/native`` (``g++``), all into the
   git-ignored ``pytorch_volumetric_tpu_torch/_build/``;
2. the closest-point + winding kernel against its plain PyTorch version on
   the card (distances, closest points and face ids exactly equal), on
   ragged and tiny shapes, padded, open and symmetric meshes, points
   straddling a mesh's box and at the headline shapes, with its time on the
   capsule's cache-build grid beside the redesign's predecessor's, the
   share of pairs it evaluated, the plain version's time and both bounds;
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
   each checked against its plain version on the card on every case of
   phase 2 (padding between real faces and points straddling a box
   included), then timed beside the sweep on the torus and at the
   capsule's cache-build grid, with the pairs each evaluated;
7. the headline arm written as MJCF (mesh geoms on the same OBJ files):
   its 200 x 15,251 exact query must equal the URDF arm's;
8. the coherent grid path: the headline arm from a fresh cache (the kernel
   runs in its build), ``RobotSDF.query_grid`` over 200 configurations x
   the 151 x 1 x 101 grid in 12-point tiles, its values, gradients and
   d/dq against ``RobotSDF.query`` on the card, ``values_only``, the
   residual lane's overflow, small single-child and trilinear cases, and
   its times beside phase 4's; the per-tile union runs as one kernel
   (``csrc/coherent_union.cu``, ``coherent_union_tile``): launched on the
   query (K1 only in the build), held bit for bit to its plain version on
   the query's own inputs (timed, with its bytes bound), at
   ``residual_frac=1e-9``, and on sphere unions of 2, 4 and 8 links at
   every seg of ``UNION_SEGS`` (1 to 100) with NaN and +-inf points;
9. the sweep kernel's launch counts on the paths of phases 3-8;
10. the narrow-band SDF of large meshes: its kernel (``csrc/narrow_band.cu``)
    against its plain version on the card (values, gradients and slots
    equal, else within 1e-6 / 1e-5 with the first difference printed) on
    the torus of the JAX package's tests with uniform, near-surface,
    on-surface, out-of-grid and cell-face points and ragged counts, a
    ``max_k=8`` build with demoted cells and an inverted mesh; then
    ``bench/bigmesh.py`` at the JAX package's bigmesh shape (327,680 faces,
    262,144 points, ``max_k`` 256 and 1024): the kernel beside its bound,
    its plain version and the exact sweep (K1), in-band values within 2e-5
    of K1's and the far field within a cell's diagonal; then the headline
    arm with ``narrow_band_link_sdf_factory()`` links, 200 configurations x
    15,251 points: its values, gradients and d/dq held to the same arm
    with ``backend="torch"`` links (the plain version on the card, on the
    kernel's own launches: equal, else within 1e-6 / 1e-5), to the
    exact-link arm where its links are exact (1e-4) and above it nowhere by
    more than 0.01, ``query_grid`` equal to
    ``query``, and the same arm on the JAX package's test build (a 0.06
    band) held to 1e-4 within 0.02 of the surface;
11. the neural SDF models: the headline arm distilled into a
    ``ConfigSpaceNeuralSDF`` at ``benchmarks/neural.py``'s settings (width
    128, depth 4, 96 Fourier features, 256 configurations x 2,048 points,
    4,000 steps of 8,192; oracle: phase 4's cached-link robot from its
    cache), gated by the JAX test's loss decrease, its RMSE against the
    oracle, its training step's ms; its value + gradient and value-only
    queries at 200 x 15,251 beside phases 4 and 8, held to the same
    weights on the CPU (npz from the card, identical arrays; values 1e-5,
    gradients 1e-4; bfloat16 2e-2 of the scale), d/dq finite;
    ``draw_sdf_slice`` of the model and of the robot equal to direct
    queries; ``fit_neural_sdf`` on phase 5's torus with an exact
    ``MeshSDF`` oracle (K1 on every oracle query), its npz on the CPU;
12. serving, debug and examples on the headline arm: its cached (phase 4's
    cache), exact and narrow-band (phase 10's) links exported at 200 x
    15,251 (``utils.serving``, ``torch.export``) and loaded in a fresh
    process that imports ``utils.serving`` alone, where one served query
    launches K1, or the narrow-band kernel, once per link (the served grid
    query the union kernel); the served
    values, gradients and d/dq against the live query (equal, else 1e-6 /
    1e-5 and phase 8's d/dq gate), with export, load, file sizes and served
    times beside the live ones; the grid export at phase 8's grid (and
    values only) against ``query_grid``; ``checked_query`` on the cached
    arm (equal, a NaN point caught, ``throw=False`` under
    ``set_sync_debug_mode("error")``); the four ``examples/torch_*.py`` at
    their full settings, each passing its own asserts;
13. ``parallel`` at world size 1 (NCCL, a 1 x 1 mesh): the sharded query of
    phase 4's cached arm, the exact arm (8 K1 launches a query) and phase
    10's narrow-band arm (8 NB launches), the coherent grid (phase 8's
    tiles through ``pad_for_mesh``; the union kernel, no K1), phase 11's
    model and phase 5's torus (2^17 points), each equal to its unsharded
    call (else 1e-6 / 1e-5) with both times, and five collision steps against the unsharded step (loss
    1e-6 relative, ``q`` 1e-5, the loss falls); the audit finds no
    collective in a forward and all-reduces only in the step.  Then a world
    of two ranks on this card (gloo; ``--parallel-rank``): the exact arm on
    2 x 1 and 1 x 2 meshes, ``TriangleShardedMeshSDF`` on a 2-way triangle
    axis of the torus (K1 on each rank's shard, no sign flip against
    ``MeshSDF``) and the collision step on 1 x 2 (its final ``q`` within
    twice the unsharded step's own reorder noise), each rank's blocks held
    to the unsharded result;
14. the north-star workload (``bench/northstar.py``, the JAX package's
    ``benchmarks/northstar.py`` shape): 200 configurations x 10^6 points in
    (3, 3, 3) tiles (1,061,208 padded), configuration chunks of 25 (smaller
    on OOM), each row's robot from a fresh cache (K1 in its build, none in
    its queries): the arm (8 links, nearest) forward, forward + backward and
    values only (a warm-up and 3 timed runs each), and one forward and one
    values only of the trilinear arm and of a free single link (the
    16,384-face torus, nearest and trilinear); per row the tile contract on
    the first chunk, a finite forward sum, the values-only sum equal to the
    forward's value part, NaN gradients only beyond the residual lane's
    capacity (the middle-tile share printed), and on the first 2
    configurations at every point the coherent values equal to
    ``compose_query``'s, gradients equal where finite (else 1e-6 / 1e-5),
    d/dq within 2e-4 of each configuration's largest, values only equal;
    the union kernel's launches per row (none missing on a nearest row) and
    the kernel held bit for bit to its plain version on the arm's first
    chunk, timed beside it and its bytes bound; the union's backward
    kernels (``tile_union_cotangents``) on that chunk's winners against the
    plain version in float64 (within 2e-5 of the terms' absolute sum, NaN
    where it has NaN, two calls equal bit for bit), timed beside the plain
    version and their bytes bound, and their launches on each row (one a
    differentiated chunk: the arm's warm-up and 3 timed runs x 8 chunks); and K1 on the torus's own
    cache-build grid (114 x 114 x 104 points
    against its 16,384 faces) held to the plain version as in phase 2;
15. the JAX side's last benchmark harnesses: ``bench/headline.py``
    (``bench.py``: 200 and 20 configurations x 15,251 points on the arm of
    phase 4's cache, forward and forward + backward, then its tight section,
    the arm at padding 0.1 from a fresh cache), ``bench/roofline_arm.py``
    (one north-star chunk, 25 x 1,061,208 points, in cumulative stages
    with their ms, deltas, created bytes, floors and launches) and
    ``bench/trilinear.py`` (nearest and trilinear caches of the
    16,384-face torus, generic and coherent rows, from a fresh cache); each
    JSON line printed and written to ``chiprun_out/harnesses.jsonl``; gates:
    on 2 configurations the headline's and the tight arm's coherent values
    equal to ``RobotSDF.query``'s (gradients equal, else 1e-6 / 1e-5; d/dq
    within 2e-4 of each configuration's largest), the roofline's ``union``
    sum equal to the ``values_only`` call's and its ``full`` value sum to
    ``union``'s, the trilinear coherent rows equal to the
    generic rows on the grid points (else 1e-6 / 1e-5), no ``*_error`` key
    and no NaN in any line, K1 in the tight arm's and the torus's builds
    and in no query; the union kernel launched, and held bit for bit to its
    plain version on the headline and tight arms' inputs;
16. the FK kernels (``csrc/fk.cu``, ``pvt::fk_link_transforms`` and its
    d/dq): on the headline arm at 25 and 200 configurations both
    transforms within 2e-6 of the plain chain walk on the card and d/dq
    (random cotangents on both outputs) within 2e-5 of its largest, one
    launch each way, then their times beside the plain walk's and their
    latency bound; the FK counters of phases 3, 4, 8 and 14 (every
    ``_link_transforms`` call took the kernel; one forward and one d/dq
    launch a differentiated query);
17. one JSON line with every kernel's launches and times, then the result
    line ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.

Rehearse a phase on the CPU by importing this file and calling its phase
function with ``torch.device("cpu")`` and small sizes (the kernels' wrappers
run their plain versions on CPU tensors, so launch counts stay 0); for
phase 10: ``phase_narrow_band(cpu, arm_dir, tmp, card, n_configs=4,
query_res=0.05, bigmesh=dict(max_ks=(8, 64), points=4096, reps=1,
plain_reps=1, subdiv=3, exact_points=1024))``; for phase 12:
``phase_serving(cpu, arm_dir, tmp, card, (1.0, 1.0), (1.0, 1.0), (1.0,
1.0), n_configs=4, query_res=0.05, resolution=0.1, reps=1,
example_args=("--device", "cpu"), example_env={"PVT_EXAMPLE_SMOKE":
"1"})`` (its serving process then runs on the CPU too); for phase 13, with
``sdf_cache.npz``, ``narrow_band.npz`` (each built when missing) and
phase 5's ``torus.obj`` in ``tmp`` and any ``ConfigSpaceNeuralSDF`` on the
CPU: ``phase_parallel(cpu, arm_dir, tmp, card, model, n_configs=4,
query_res=0.05, resolution=0.1, reps=1, n_torus=4096)`` (a world of one
over gloo, then two gloo ranks on the CPU); for phase 14:
``phase_northstar(cpu, tmp, card, n_configs=4, points_side=24, chunk=2,
build=dict(resolution=0.04, padding=0.3, arm_joints=3, torus=(0.1, 0.03,
32, 16)))`` (caches of 0.04 over the 0.01 grid give larger tiles than 27);
for phase 15, with ``CACHE_RES`` set to 0.1 in ``bench.headline`` and
``bench.roofline_arm`` and to 0.05 in ``bench.trilinear``, and
``bench.headline.REPS`` to 1: ``phase_harnesses(cpu, tmp, card, tmp,
n_configs=4, roofline=dict(chunk=2, points_side=8, reps=1),
trilinear=dict(points_side=8, reps=1))`` (~15 s; it builds
``tmp/sdf_cache.npz`` when phase 4 has not); for phase 16:
``phase_fk(cpu, arm_dir, card, reps=2)`` (both sides the plain walk there).
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
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
    """``(name, points, triangles, exterior box)`` every sweep kernel is
    held against its plain version on: ragged and tiny shapes, padding in
    the tail and in the middle, an open mesh (no box), points on the
    surface, exact ties on a symmetric mesh, warps mixing points inside and
    outside the box, and the headline link mesh (the arm's capsule, edges
    2-5 cm) with points up to 1 m away, where the tensor-core sweep's
    products cancel most.  The box is ``mesh.exterior_box`` of the
    triangles (None for an open surface); the sweep kernels that take one
    (``sweep_roofline.TAKES_BOX``) read it."""
    import pytorch_volumetric_tpu_torch as pt
    m = pt.mesh
    rng = np.random.default_rng(0)

    def rand_pts(n, lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (n, 3)).astype(np.float32), device=device)

    def case(name, pts, tri):
        tri = torch.as_tensor(tri, device=device).contiguous()
        return name, pts, tri, m.exterior_box(tri.cpu().numpy())

    scene = m.MeshScene.from_mesh(m.icosphere_mesh(0.3, 2).concatenate(
        m.box_mesh((0.2, 0.3, 0.1), center=(0.4, 0.0, 0.0))), device=device)
    cases = [case("icosphere+box (padding tail)", rand_pts(1000, -0.6, 0.8), scene.tri)]
    cases += [case(f"ragged P={P}", rand_pts(P, -0.5, 0.5), scene.tri)
              for P in (1, 7, 31, 33, 129, 257, 5000)]
    box = m.box_mesh((0.4, 0.6, 0.8)).triangles().astype(np.float32)
    cases.append(case("box, F=12 < tile", rand_pts(300, -0.8, 0.8), box))
    cases.append(case("open box (one face less)", rand_pts(300, -0.8, 0.8), box[1:]))
    cases.append(case("single triangle", rand_pts(300, -0.5, 0.5),
                      np.array([[[0.0, 0, 0], [0.3, 0, 0], [0, 0.2, 0.1]]], np.float32)))
    cap_mesh = m.capsule_mesh(radius=0.045, height=0.18, segments=14, rings=5)
    cap = m.MeshScene.from_mesh(cap_mesh, device=device)
    pad = torch.full((40, 3, 3), m.PAD_COORD, device=device)
    cases.append(case("capsule, padding in the middle", rand_pts(2000, -0.3, 0.3),
                      torch.cat([cap.tri[:100], pad, cap.tri[100:]])))
    # points exactly on the surface (the normal override's regime)
    surf = m.icosphere_mesh(0.3, 2).sample_points_uniformly(500, seed=1)
    cases.append(case("on-surface points", torch.as_tensor(surf.astype(np.float32),
                                                           device=device), scene.tri))
    # a symmetric mesh seen from a symmetric grid: many exact ties
    _, grid = pt.get_coordinates_and_points_in_grid(
        0.05, np.array([[-0.5, 0.5]] * 3), device=device)
    cases.append(case("centred box on a grid (ties)", grid.contiguous(), box))
    # a band around the capsule's box: warps of points inside and outside
    bb = cap_mesh.aabb()
    cases.append(case("capsule, points straddling its box", torch.as_tensor(
        rng.uniform(bb[:, 0] - 0.01, bb[:, 1] + 0.01, (5000, 3)).astype(np.float32),
        device=device), cap.tri))
    cases.append(case(f"capsule, {capsule_points} points to 1 m away", torch.as_tensor(
        rng.uniform(bb[:, 0] - 1.0, bb[:, 1] + 1.0, (capsule_points, 3)).astype(np.float32),
        device=device), cap.tri))
    return cases


def compare_kernel(kind, case, pts, tri, device, box=None):
    """One launch of the sweep kernel ``sweep_roofline.SWEEPS[kind]`` against
    its plain version on one input; fails beyond its gates and returns its
    errors (``sweep_roofline.sweep_errors``).  The sweep kernel ("base",
    given the case's exterior box) must equal its plain version's
    distances, closest points and face ids exactly, and |winding| within
    1e-4 at every point; the probe's kernels are held to the closest point
    on the face they chose and to the winding off the surface."""
    from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr
    from pytorch_volumetric_tpu_torch.ops.closest_point import LAUNCHES
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
    wrapper, plain, _ = sr.SWEEPS[kind]
    before = COUNTERS[LAUNCHES[wrapper]]
    out = wrapper(pts, tri, exterior_box=box) if kind in sr.TAKES_BOX else wrapper(pts, tri)
    sync(device)
    if device.type == "cuda":
        check(COUNTERS[LAUNCHES[wrapper]] == before + 1, f"{kind}, {case}: no launch")
    ref = plain(pts, tri)
    d1, c1, f1, w1 = out
    check(d1.shape == ref[0].shape and c1.shape == ref[1].shape and f1.dtype == torch.int32,
          f"{kind}, {case}: output shapes")
    check(all(bool(torch.isfinite(t).all()) for t in (d1, c1, w1)),
          f"{kind}, {case}: non-finite output")
    e = sr.sweep_errors(out, ref, pts, tri)
    e["abs_winding"] = (w1.abs() - ref[3].abs()).abs().max().item()
    e["exact"] = all(torch.equal(a, b) for a, b in zip(out[:3], ref[:3]))
    same_fid = (f1 == ref[2]).float().mean().item()
    log(f"    {case}: P={pts.shape[0]} F={tri.shape[0]}"
        f"{' (box)' if box is not None and kind in sr.TAKES_BOX else ''} |d| {e['dist']:.3g}, "
        f"|closest| {e['closest_raw']:.3g} (on the chosen face {e['closest']:.3g}), "
        f"face-contract {e['face']:.3g}, |wind| {e['winding']:.3g} off the surface "
        f"({e['on_surface']} points within {sr.WIND_MIN_DIST:g}), ||wind|| "
        f"{e['abs_winding']:.3g} everywhere; same face id {same_fid * 100:.2f}%; "
        f"bit-identical d/closest/fid: {e['exact']}")
    if kind == "base":
        check(e["exact"], f"{case}: distance, closest point or face id differs from the "
              "plain version")
        check(e["abs_winding"] <= 1e-4, f"{case}: |winding| beyond 1e-4")
    else:
        check(sr.check_sweep(kind, e), f"{kind}, {case}: beyond its gates against the plain version")
    return e


# K1 and the tensor-core sweep on the capsule's cache-build grid before
# their redesigns for Hopper, on an H100 80GB HBM3 at 700 W (PERF.md, the
# kernel table)
K1_GRID_MS_BEFORE = 6.276
MXU_GRID_MS_BEFORE = 7.5421


def phase_kernel(device, capsule_points=100_000, grid_scale=1.0, reps=5):
    from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr
    from pytorch_volumetric_tpu_torch.ops.closest_point import mesh_closest_query_cuda
    from pytorch_volumetric_tpu_torch.ops.point_triangle import mesh_closest_query

    err = 0.0
    for case, pts, tri, box in sweep_cases(device, capsule_points):
        e = compare_kernel("base", case, pts, tri, device, box)
        err = max(err, e["dist"], e["closest_raw"])

    # time it at the main path's shape: the capsule's cache-build grid
    # (resolution 0.02, padding 1.0), one launch over the whole grid with
    # the scene's exterior box, as MeshSDF calls it
    grid, cap = sr.capsule_cache_grid(device, 0.02 / grid_scale)
    P, Fp, F = grid.shape[0], cap.tri.shape[0], cap.num_faces
    box = cap.exterior_box
    ms = time_ms(lambda: mesh_closest_query_cuda(grid, cap.tri, exterior_box=box), device,
                 reps=reps)
    plain_ms = time_ms(lambda: mesh_closest_query(grid, cap.tri), device,
                       reps=max(1, reps // 2))
    ev = sr.evaluated_pairs(mesh_closest_query_cuda, grid, cap.tri, exterior_box=box)
    bound_ms, bound_by = sr.sweep_bound_ms(P, F)
    ev_ms, ev_by = sr.evaluated_bound_ms(P, F, ev["closest_pairs"], ev["winding_pairs"])
    share = ev["closest_pairs"] / (P * F)
    wshare = ev["winding_pairs"] / (P * F)
    log(f"  timing (capsule cache-build grid, one launch): P={P} x Fp={Fp} (F={F} real): "
        f"kernel {ms:.3f} ms (before the redesign: {K1_GRID_MS_BEFORE} ms on an H100 80GB "
        f"HBM3 at 700 W) = {P * F / ms / 1e6:.4g} G real pairs/s; pairs evaluated: closest point "
        f"{share * 100:.2f}%, solid angle {wshare * 100:.2f}% of {P * F} real pairs; "
        f"brute-force bound {bound_ms:.3f} ms ({bound_by}, 110 ops x every real pair); "
        f"bound over the evaluated pairs {ev_ms:.3f} ms ({ev_by}); plain {plain_ms:.3f} ms; "
        f"no single PyTorch call computes this function")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "pairs": P * Fp, "evaluated_share": share,
            "winding_share": wshare, "bound_evaluated_ms": ev_ms, "bound_evaluated_by": ev_by}


# ---------------------------------------------------------------------------
# robot phases
# ---------------------------------------------------------------------------

def headline_inputs(device, n_configs=N_CONFIGS, query_res=QUERY_RES):
    """The reference benchmark's 200 joint configurations (seeded,
    ``bench/headline.joint_configs``) and 151 x 1 x 101 query grid."""
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.bench.headline import joint_configs
    _, pts = pt.get_coordinates_and_points_in_grid(query_res, QUERY_RANGE, device=device)
    return joint_configs(n_configs, device), pts


def objective_grad(query, q, pts):
    """``query(q, pts) -> (v, g)`` and ``d (v.sum() + g.sum()) / d q`` (the
    benchmark's objective)."""
    qq = q.detach().clone().requires_grad_(True)
    v, g = query(qq, pts)
    (dq,) = torch.autograd.grad(v.sum() + g.sum(), qq)
    return v.detach(), g.detach(), dq


def query_objective_grad(robot, q, pts):
    """:func:`objective_grad` of ``robot.query``."""
    return objective_grad(robot.query, q, pts)


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
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS

    text = open(os.path.join(arm_dir, "arm.urdf")).read()
    q, pts = headline_inputs(device, n_configs, query_res)

    COUNTERS["kernel.closest_point_sweep"] = 0
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=arm_dir)
    fk_reset()
    v, g, dq = query_objective_grad(robot, q, pts)
    sync(device)
    launches = COUNTERS["kernel.closest_point_sweep"]
    fk_counts(device, "exact robot query", 1, 1)
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
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS

    text = open(os.path.join(arm_dir, "arm.urdf")).read()
    cache_path = os.path.join(cache_dir, "sdf_cache.npz")
    q, pts = headline_inputs(device, n_configs, query_res)

    # the main path: cache build (the kernel sweeps every unique link mesh
    # over its grid), then the batched value + gradient query and its
    # gradient w.r.t. the joint angles
    COUNTERS["kernel.closest_point_sweep"] = 0
    t0 = time.perf_counter()
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=arm_dir,
                        link_sdf_cls=pt.cache_link_sdf_factory(
                            resolution=resolution, padding=1.0, cache_path=cache_path))
    sync(device)
    build_s = time.perf_counter() - t0
    fk_reset()
    v, g, dq = query_objective_grad(robot, q, pts)
    sync(device)
    launches = COUNTERS["kernel.closest_point_sweep"]
    fk_counts(device, "cached robot query", 1, 1)
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
    nonfinite_lookup(robot, ref, q[:2], device)

    fwd_ms, fb_ms = time_robot(robot, q, pts, device, reps)
    n = q.shape[0] * pts.shape[0]
    log(f"  cached robot {q.shape[0]} x {pts.shape[0]}: cache build {build_s:.3f} s, "
        f"forward {fwd_ms:.3f} ms ({n / fwd_ms / 1e3:.4g} M queries/s), forward+backward "
        f"{fb_ms:.3f} ms ({n / fb_ms / 1e3:.4g} M queries/s) [{card}]; "
        f"kernel launches on the path: {launches}")
    return launches, fwd_ms, fb_ms


NONFINITE = np.array([[np.nan, np.nan, np.nan], [np.nan, 0.0, 0.3], [-0.5, np.nan, 0.1],
                      [0.1, 0.02, np.nan], [np.inf, 0.02, 0.3], [-np.inf, 0.02, 0.3],
                      [0.2, np.inf, 0.1], [np.nan, np.inf, 0.0], [0.3, 0.02, 0.4]], np.float32)


def nonfinite_lookup(robot, ref, q, device):
    """NaN and +-inf points through the cached lookup on the card against
    the CPU path on the same tables: NaN at the same places, the rest
    within 1e-5 (keys convert as the JAX package's: NaN to 0).  Also
    prints what a raw float -> int64 cast gives on the card."""
    pts = torch.as_tensor(NONFINITE, device=device)
    with torch.no_grad():
        v, g = robot.query(q, pts)
        vc, gc = ref.query(q.cpu(), pts.cpu())
    for name, a, b in (("values", v.cpu(), vc), ("gradients", g.cpu(), gc)):
        same_nan = torch.equal(torch.isnan(a), torch.isnan(b))
        fin = torch.isfinite(a) & torch.isfinite(b)
        err = (a - b)[fin].abs().max().item() if bool(fin.any()) else 0.0
        same_inf = torch.equal(torch.isinf(a), torch.isinf(b))
        log(f"  NaN/inf points on the card vs the CPU path, {name}: NaN at the same places "
            f"{same_nan}, inf at the same places {same_inf}, finite |d| {err:.3g} "
            f"({int(torch.isnan(b).sum())} NaN of {b.numel()})")
        check(same_nan and same_inf and err <= 1e-5,
              f"cached robot: NaN/inf points on the card differ from the CPU path ({name})")
    check(bool(torch.isfinite(vc[:, 0]).all()),
          "cached robot: a NaN point did not read the links' first cell")
    raw = torch.tensor([float("nan"), float("inf"), -float("inf")], device=device)
    log(f"  a raw float -> int64 cast of (NaN, inf, -inf) on the card: "
        f"{raw.to(torch.int64).tolist()} (the port converts keys with float_keys)")


# ---------------------------------------------------------------------------
# the coherent union kernel against its plain version (phases 8, 14, 15)
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's memory rate (NVIDIA's data sheet)
UNION_SEGS = (1, 4, 12, 27, 32, 33, 64, 100)


def same_bits(a, b):
    """``a`` and ``b`` equal bit for bit, every NaN taken as one pattern
    (``torch.where`` writes Python's NaN, the card's arithmetic its own
    canonical NaN; the plain version mixes both): shapes, dtypes, the NaN
    places and every other bit, the sign of a zero included."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def union_inputs(robot, ft, q, pts, seg):
    """``(tables, points, T, Rb, seg)`` exactly as
    ``compose_query_coherent`` hands them to the per-tile union for the
    configurations ``q``: the world points and the union children's
    obj_to_link rows and rotations."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    children = tuple(robot.sdf.sdfs)
    fast = tsdf._coherent_plan(children).bricks
    S, B = len(children), q.shape[0]
    with torch.no_grad():
        m, m_inv = robot._link_transforms(q)
        T_all = m.reshape(S, B, 4, 4)
        R_back = m_inv.reshape(S, B, 4, 4)[..., :3, :3]
        T = torch.stack([T_all[i] for i in fast])
        Rb = torch.stack([R_back[i] for i in fast])
    return tuple(ft), pts, T, Rb, seg


def _distinct(keys, size):
    """The number of distinct entries of ``keys``, integers in ``[0,
    size)``."""
    seen = torch.zeros(size, dtype=torch.bool, device=keys.device)
    seen[keys] = True
    return int(seen.sum())


def union_bound(tables, points, T, seg, cap=None):
    """``(bound_ms, bytes)``: the bytes the union must move at least, over
    3.35 TB/s, each input byte counted once however often the call reads
    it.  Read: the world points (12 B each, once over every configuration
    and link: the kernel forms the link-frame points in registers); the
    obj_to_link rows (48 B a link and configuration) and the rotations (36
    B); each distinct value cell that an in-grid point reads (4 B; a (link,
    brick row, cell) counted once over all configurations and tiles); each
    distinct cell of the winners' gradient bricks (12 B: three channels; a
    (winner, brick row, cell) counted once) that an in-grid point of a tile
    outside the residual lane reads, and each distinct packed (value, grad)
    row (its 12 B of gradient) that an in-grid point of a lane tile within
    the capacity reads.  Written: val (4 B a point) and g_obj (12), win
    (8), g_link (12).  Values only (``cap`` None): the points, the
    obj_to_link rows, the value cells and val.  The small per-link fields
    and the residual lane's tile flags are left out.  The cells are found
    from the link-frame points, which only this count writes."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    C, B = T.shape[:2]
    F = points.shape[0]
    FS, N = F // seg, B * F
    dev = points.device

    def bases(name):
        b = tsdf._coherent_row_bases([getattr(t, name) for t in tables])
        return torch.as_tensor(b[:-1], device=dev).view(C, 1, 1), int(b[-1])

    with torch.no_grad():
        pts_c = tsdf._link_points(T, points, seg)
        v, valid, flat, row, cell, _ = tsdf._nearest_union(tables, pts_c)
        del pts_c
        vb, v_rows = bases("bricks")
        cells = _distinct((((row + vb) * 64)[..., None] + cell)[valid], v_rows * 64)
        nbytes = F * 12 + C * B * 48 + cells * 4 + N * 4
        if cap is None:
            return nbytes / HBM_BYTES_PER_S * 1e3, nbytes
        win, pick = tsdf._first_min(v)
        del v
        bvalid = pick(valid)
        middle = tsdf._tile_candidate_ids(win, bvalid, C)[1]
        if middle is None:
            middle = lane = torch.zeros((B, FS), dtype=torch.bool, device=dev)
        else:
            lane = middle & ~tsdf._residual_tiles(middle, cap)[1]
        gb, g_rows = bases("gbricks")
        gkey = pick((((row + gb) * 64)[..., None] + cell))
        gcells = _distinct(gkey[bvalid & ~middle[..., None]], g_rows * 64)
        vg_rows = _distinct(pick(flat)[bvalid & lane[..., None]],
                            sum(int(t.vg.shape[0]) for t in tables))
    nbytes += C * B * 36 + (gcells + vg_rows) * 12 + N * (12 + 8 + 12)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


FP32_OPS_PER_S = 67e12  # one H100 SXM's FP32 rate (NVIDIA's data sheet)
# CU-T's operations a (configuration, link, point): the transform 18, the
# trilinear cell 15, the 8 weights 19 and the value lerp 16; a
# (configuration, point) with gradients: the winner's three lerps 48 and the
# rotation 15
TRI_OPS_LINK, TRI_OPS_WINNER = 68, 63


def union_kind(tri=False):
    """``(op, plain forward, plain values only, launch counter, bound)`` of
    the nearest union (CU) or, with ``tri``, the trilinear union (CU-T)."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from pytorch_volumetric_tpu_torch.ops.coherent_union import coherent_union_tile
    from pytorch_volumetric_tpu_torch.ops.coherent_union_tri import coherent_union_tile_tri
    if tri:
        return (coherent_union_tile_tri, tsdf._union_tile_tri_eval, tsdf._union_values_tri_eval,
                "kernel.coherent_union_tile_tri", union_tri_bound)
    return (coherent_union_tile, tsdf._union_tile_eval, tsdf._union_values_eval,
            "kernel.coherent_union_tile", union_bound)


def union_tri_bound(tables, points, T, seg, cap=None):
    """``(bound_ms, bytes, ops_ms, ops)``: CU-T's least time by bytes over
    3.35 TB/s, each input byte counted once however often the call reads it,
    and by operations (:data:`TRI_OPS_LINK`, :data:`TRI_OPS_WINNER`) over
    67 TFLOP/s.  Read: the world points (12 B each), the obj_to_link rows
    (48 B a link and configuration) and the rotations (36 B); each distinct
    value-brick cell that an in-grid point's lerp reads (4 B; a (link, brick
    row, cell) counted once over all configurations, tiles and corners);
    each distinct cell of the winners' gradient bricks (12 B) that an
    in-grid point of a tile outside the residual lane reads, and each
    distinct packed row (12 B of gradient) that an in-grid point of a lane
    tile within the capacity reads.  Written: val (4 B a point), g_obj
    (12), win (8), g_link (12).  Values only (``cap`` None): the points,
    the obj_to_link rows, the value cells and val."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    C, B = T.shape[:2]
    F = points.shape[0]
    FS, N = F // seg, B * F
    dev = points.device

    def corner_cells(keys, rows):
        # the distinct cells of every corner of the lower corners ``keys``
        seen = torch.zeros(rows, dtype=torch.bool, device=dev)
        for delta in tsdf._DELTA5:
            seen[keys + delta] = True
        return int(seen.sum())

    def bases(name):
        b = tsdf._coherent_row_bases([getattr(t, name) for t in tables])
        return torch.as_tensor(b[:-1], device=dev).view(C, 1, 1), int(b[-1])

    with torch.no_grad():
        pts_c = tsdf._link_points(T, points, seg)
        v, (valid, flat0, _, row, base5, _, _) = tsdf._trilinear_union_values(tables, pts_c)
        del pts_c
        vb, v_rows = bases("tbricks")
        cells = corner_cells((((row + vb) * 125)[..., None] + base5)[valid],
                             v_rows * 125)
        nbytes = F * 12 + C * B * 48 + cells * 4 + N * 4
        ops = N * C * TRI_OPS_LINK
        if cap is not None:
            win, pick = tsdf._first_min(v)
            del v
            bvalid = pick(valid)
            middle = tsdf._tile_candidate_ids(win, bvalid, C)[1]
            if middle is None:
                middle = lane = torch.zeros((B, FS), dtype=torch.bool, device=dev)
            else:
                lane = middle & ~tsdf._residual_tiles(middle, cap)[1]
            gb, g_rows = bases("tgbricks")
            gkey = pick((((row + gb) * 125)[..., None] + base5))
            gcells = corner_cells(gkey[bvalid & ~middle[..., None]], g_rows * 125)
            at = bvalid & lane[..., None]
            strides = torch.stack([t.strides for t in tables])[win[at]]
            seen = torch.zeros(sum(int(t.vg.shape[0]) for t in tables), dtype=torch.bool,
                               device=dev)
            for offs in tsdf._CORNERS:
                seen[pick(flat0)[at] + (strides * torch.tensor(offs, device=dev)).sum(-1)] = True
            nbytes += C * B * 36 + (gcells + int(seen.sum())) * 12 + N * (12 + 8 + 12)
            ops += N * TRI_OPS_WINNER
    return (nbytes / HBM_BYTES_PER_S * 1e3, nbytes, ops / FP32_OPS_PER_S * 1e3, ops)


def union_kernel_times(tables, points, T, Rb, seg, cap, reps=5, tri=False):
    """Times of one union call, forward and values only: ``ms`` (CUDA
    events around ``reps`` back-to-back calls of the op: the union kernel
    and, with more than three links, the cumsum and the poison pass),
    ``kernel_ms`` (the union kernel's own device time, from a profiler
    trace), ``plain_ms`` (the plain version on the card: the link-frame
    points by ``transforms.transform_points``, then the union).  ``tri``:
    the trilinear union (CU-T)."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from pytorch_volumetric_tpu_torch.utils.profiling import device_time, kernel_time
    op, plain_fwd, plain_vo = union_kind(tri)[:3]
    link = lambda p: tsdf._link_points(T, p, seg)
    out = {}
    for name, kern, plain in (
            ("forward", lambda p: op(tables, p, T, seg, Rb, cap),
             lambda p: plain_fwd(tables, cap, link(p), Rb)),
            ("values_only", lambda p: op(tables, p, T, seg, values_only=True),
             lambda p: plain_vo(tables, link(p)))):
        r = {"ms": device_time(kern, points, reps=reps) * 1e3,
             "plain_ms": device_time(plain, points, reps=2) * 1e3}
        r["kernel_ms"], r["calls_ms"] = None, {}
        if points.device.type == "cuda":
            _, _, by_name = kernel_time(kern, points, reps=reps, by_name=True)
            r["kernel_ms"] = sum(s for k, s in by_name.items() if "union_" in k) * 1e3
            r["calls_ms"] = {k[:60]: s * 1e3 for k, s in by_name.items()}
        out[name] = r
    return out


def compare_union(name, tables, points, T, Rb, seg, residual_frac=None, timed=False,
                  tri=False):
    """The union kernel (``pvt::coherent_union_tile``, which forms the
    link-frame points ``T @ points`` in registers) against its plain
    version (``sdf._union_tile_eval`` and ``_union_values_eval`` on
    ``sdf._link_points``) on the same inputs: forward (``val``, ``g_obj``,
    ``win``, ``g_link``) and values only, every output bit for bit
    (:func:`same_bits`); on CPU tensors both sides are the plain version.
    With ``tri`` the trilinear union's (``pvt::coherent_union_tile_tri``,
    CU-T, against ``_union_tile_tri_eval`` and ``_union_values_tri_eval``).
    ``residual_frac``: the residual lane's fraction (``sdf.RESIDUAL_FRAC``
    when None).  With ``timed`` the times (:func:`union_kernel_times`) and
    the bound of this run's inputs.  Returns ``{max_abs_err, ...}`` (0: the
    check fails on any difference)."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
    op, plain_fwd, plain_vo, counter, bound = union_kind(tri)
    device = points.device
    C, B = T.shape[:2]
    FS = points.shape[0] // seg
    frac = tsdf.RESIDUAL_FRAC if residual_frac is None else residual_frac
    cap = tsdf.residual_capacity(B * FS, frac)
    before = COUNTERS[counter]
    with torch.no_grad():
        out = op(tables, points, T, seg, Rb, cap)
        vo = op(tables, points, T, seg, values_only=True)
        sync(device)
        if device.type == "cuda":
            check(COUNTERS[counter] == before + 2, f"{name}: the kernel did not launch")
        pts_c = tsdf._link_points(T, points, seg)
        ref = plain_fwd(tables, cap, pts_c, Rb)
        ref_vo = plain_vo(tables, pts_c)
        del pts_c
    same = [same_bits(a, b) for a, b in zip(out, ref)] + [same_bits(vo, ref_vo)]
    n_nan = int(torch.isnan(ref[3]).any(dim=-1).sum())
    log(f"    {name}: C={C} B={B} FS={FS} seg={seg}, residual_frac {frac:g} (capacity {cap}): "
        f"bit for bit (val, g_obj, win, g_link, values only) {same}; NaN gradients {n_nan}")
    check(all(same), f"{name}: the union kernel differs from its plain version")
    res = {"max_abs_err": 0.0}
    del out, vo, ref, ref_vo
    if timed:
        res["times"] = union_kernel_times(tables, points, T, Rb, seg, cap, tri=tri)
        res["bound_ms"], res["bound_bytes"], *ops = bound(tables, points, T, seg, cap)
        res["values_bound_ms"], _, *ops_vo = bound(tables, points, T, seg)
        if tri:
            res["ops_bound_ms"], res["ops"] = ops
            res["values_ops_bound_ms"], _ = ops_vo
            log(f"    {name}: operations bound {res['ops_bound_ms']:.4f} ms ({res['ops']:.4g} "
                f"operations), values only {res['values_ops_bound_ms']:.4f} ms")
        t = res["times"]
        log(f"    {name}: forward {t['forward']['ms']:.4f} ms (kernel "
            f"{t['forward']['kernel_ms']} device ms; calls {t['forward']['calls_ms']}), "
            f"plain {t['forward']['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_bytes'] / 1e9:.3f} GB); values only {t['values_only']['ms']:.4f} ms "
            f"(kernel {t['values_only']['kernel_ms']} device ms), plain "
            f"{t['values_only']['plain_ms']:.4f} ms, bound {res['values_bound_ms']:.4f} ms")
    return res


def union_backward_bound(C, B, N):
    """``(bound_ms, bytes)`` of the union's backward at ``C`` children,
    ``B`` configurations and ``N`` points: read win (8 B), g_link (12),
    ct_val (4) and ct_g (12) a (configuration, point) and the points (12 B
    each) once, write d_T and d_Rb (25 floats a child and configuration);
    over 3.35 TB/s."""
    nbytes = B * N * 36 + N * 12 + C * B * 25 * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def compare_union_backward(name, tables, points, T, Rb, seg, reps=5):
    """The union's backward (``ops.coherent_union.tile_union_cotangents``:
    the kernels on the card) on the winners and link-frame gradients of the
    union kernel over ``T @ points``, cotangents of ones (the
    north star's ``v.sum() + g.sum()``), against the plain version in
    float64: NaN where it has NaN, else within 2e-5 of the terms' absolute
    sum (float32 sums: ~120 additions a term, 120 * 2^-24 = 7.2e-6); two
    calls equal bit for bit.  Returns ``{max_rel_err, ms, kernel_ms,
    plain_ms, bound_ms, bound_bytes}``: ``ms`` by CUDA events around
    ``reps`` calls, ``kernel_ms`` the backward kernels' device time (a
    profiler trace), ``plain_ms`` the plain version in float32."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from pytorch_volumetric_tpu_torch.ops import coherent_union as cu
    from pytorch_volumetric_tpu_torch.utils.profiling import device_time, kernel_time
    C, B = T.shape[:2]
    N = points.shape[0]
    FS = N // seg
    cap = tsdf.residual_capacity(B * FS)
    with torch.no_grad():
        _, _, win, g_link = cu.coherent_union_tile(tables, points, T, seg, Rb, cap)
        ct_val = torch.ones((B, FS, seg), device=points.device)
        ct_g = torch.ones((B, FS, seg, 3), device=points.device)
        args = (win, g_link, ct_val, ct_g, points)
        out = cu.tile_union_cotangents(*args, C)
        again = cu.tile_union_cotangents(*args, C)
        sync(points.device)
        f64 = [t.double() for t in args[1:]]
        ref = cu.tile_union_cotangents_plain(win, *f64, C)
        mag = cu.tile_union_cotangents_plain(win, *(t.abs() for t in f64), C)
    rel, same_nan = 0.0, True
    for a, r, m in zip(out, ref, mag):
        nan = torch.isnan(r)
        same_nan &= torch.equal(torch.isnan(a), nan)
        rel = max(rel, float(((a.double() - r).abs() / m.clamp(min=1e-30))[~nan].max()))
    repeat = all(same_bits(a, b) for a, b in zip(out, again))
    res = {"max_rel_err": rel}
    res["ms"] = device_time(lambda *a: cu.tile_union_cotangents(*a, C), *args, reps=reps) * 1e3
    res["plain_ms"] = device_time(lambda *a: cu.tile_union_cotangents_plain(*a, C), *args,
                                  reps=2) * 1e3
    res["kernel_ms"], res["calls_ms"] = None, {}
    if points.device.type == "cuda":
        _, _, by_name = kernel_time(lambda *a: cu.tile_union_cotangents(*a, C), *args,
                                    reps=reps, by_name=True)
        res["kernel_ms"] = sum(v for k, v in by_name.items() if "union_backward" in k) * 1e3
        res["calls_ms"] = {k[:60]: v * 1e3 for k, v in by_name.items()}
    res["bound_ms"], res["bound_bytes"] = union_backward_bound(C, B, N)
    log(f"    {name}: C={C} B={B} N={N}: NaN where the float64 plain version has NaN "
        f"{same_nan} ({int(torch.isnan(ref[0]).sum())} in d_T), largest error over the terms' "
        f"absolute sum {rel:.3g}, two calls bit for bit {repeat}; {res['ms']:.4f} ms (kernels "
        f"{res['kernel_ms']} device ms; calls {res['calls_ms']}), plain {res['plain_ms']:.4f} "
        f"ms, bound {res['bound_ms']:.4f} ms ({res['bound_bytes'] / 1e9:.3f} GB)")
    check(same_nan and rel <= 2e-5 and repeat,
          f"{name}: the union's backward differs from its plain version")
    return res


def union_cases(device, tmp, n_configs=3, n_tiles=96):
    """``(name, tables, points, T, Rb, seg)``: sphere caches (0.04 over
    [-0.5, 0.5]^3) of radius 0.02 centred on a circle of 0.012, 2, 4 and 8
    of them, so that tiles at the circle's centre see 4 or more winners;
    world points in tiles of every seg of :data:`UNION_SEGS` at random
    centres (most within 0.06 of the centre, some up to 0.8 away: out of
    the grid), their points within 0.01 of the centre (inside a brick) or,
    in every ninth tile, 0.1 (a tile that breaks the contract: the offsets
    clamp to 3); some points NaN or +-inf in one or all coordinates; ``T``
    each sphere's frame after a random rotation about the centre, one a
    configuration, jittered by up to 0.003 a link and configuration; random
    rotations ``Rb``."""
    import pytorch_volumetric_tpu_torch as pt
    rng = np.random.default_rng(7)
    spheres = []
    for i in range(8):
        spheres.append(pt.CachedSDF(f"u{i}", 0.04, np.array([[-0.5, 0.5]] * 3),
                                    pt.SphereSDF(0.02, device=device),
                                    cache_path=os.path.join(tmp, "union_cases.npz")))
    cases = []
    for C in (2, 4, 8):
        tables = pt.sdf.coherent_fast_tables(spheres[:C])
        ang = 2 * np.pi * np.arange(C) / C + 0.3
        shift = np.stack([0.012 * np.cos(ang), 0.012 * np.sin(ang), np.zeros(C)], 1)
        for seg in UNION_SEGS:
            far = rng.random(n_tiles) < 0.15
            centre = np.where(far[:, None], rng.uniform(-0.8, 0.8, (n_tiles, 3)),
                              rng.uniform(-0.06, 0.06, (n_tiles, 3)))
            spread = np.where(np.arange(n_tiles) % 9 == 8, 0.1, 0.01)[:, None]
            flat = (centre[:, None] + rng.uniform(-1, 1, (n_tiles, seg, 3))
                    * spread[..., None]).reshape(-1, 3).astype(np.float32)
            bad = rng.choice(len(flat), size=max(3, len(flat) // 50), replace=False)
            for j, k in enumerate(bad):
                flat[k, j % 3] = (np.nan, np.inf, -np.inf)[j % 3]
                if j % 7 == 0:
                    flat[k] = np.nan
            # each link's frame: a rotation of the world a configuration, then
            # the sphere's offset taken off, jittered per link and configuration
            T = np.tile(np.eye(4), (C, n_configs, 1, 1))
            T[..., :3, :3] = np.stack([_random_rotation(rng) for _ in range(n_configs)])
            T[..., :3, 3] = rng.uniform(-0.003, 0.003, (C, n_configs, 3)) - shift[:, None]
            Rb = np.stack([[_random_rotation(rng) for _ in range(n_configs)] for _ in range(C)])
            cases.append((f"{C} spheres, seg {seg}", tables,
                          *(torch.as_tensor(x.astype(np.float32), device=device).contiguous()
                            for x in (flat, T, Rb)), seg))
    return cases


def _random_rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


def norm_order_probe(device, n=4_000_000):
    """Mismatches of three summation orders against
    ``torch.linalg.vector_norm`` over a last dimension of 3 on 4 M random
    float32 vectors (magnitudes 1e-6 to 1e3): the union kernel writes the
    AABB distance as ``sqrt((x0^2 + x2^2) + x1^2)``, the order this
    reduction takes on the card.  ``{order: mismatches}``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 3)) * 10.0 ** rng.uniform(-6, 3, (n, 1))
    x = torch.as_tensor(x.astype(np.float32), device=device)
    ref = torch.linalg.vector_norm(x, dim=-1)
    sq = x * x
    orders = {"(0+1)+2": (sq[:, 0] + sq[:, 1]) + sq[:, 2],
              "(0+2)+1": (sq[:, 0] + sq[:, 2]) + sq[:, 1],
              "0+(1+2)": sq[:, 0] + (sq[:, 1] + sq[:, 2])}
    out = {k: int((torch.sqrt(v) != ref).sum()) for k, v in orders.items()}
    log(f"    vector_norm's order on {device.type}: mismatches of {n} {out}")
    return out


def union_case_checks(device, tmp):
    """Every case of :func:`union_cases` at the default residual fraction
    and at 1e-9; fails unless an overflow case put NaN somewhere (the lane
    overflows where a case has middle tiles)."""
    overflowed = False
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    for name, tables, points, T, Rb, seg in union_cases(device, tmp):
        for frac in (tsdf.RESIDUAL_FRAC, 1e-9):
            compare_union(name, tables, points, T, Rb, seg, frac)
            if frac < 1e-6 and len(tables) > 3:
                with torch.no_grad():
                    cap = tsdf.residual_capacity(T.shape[1] * (points.shape[0] // seg), frac)
                    g = tsdf._union_tile_eval(tables, cap, tsdf._link_points(T, points, seg),
                                              Rb)[3]
                overflowed |= bool(torch.isnan(g).any())
    check(overflowed, "no union case overflowed the residual lane at residual_frac 1e-9")


# ---------------------------------------------------------------------------
# phase 8: the coherent grid path
# ---------------------------------------------------------------------------

def exact_or_gate(name, v, g, vr, gr):
    """The brick path's values and gradients ``(v, g)`` against the generic
    path's ``(vr, gr)`` on the same device: equal, or else the count and
    the kind of each difference printed and JAX's non-CPU tolerance
    (1e-6 value, 1e-5 gradient) applied."""
    dv = v != vr
    dg = (g != gr).any(dim=-1)
    if not bool(dv.any() or dg.any()):
        log(f"    {name}: bit-identical to the generic path ({v.numel()} points)")
        return True
    err_v = (v - vr).abs().max().item()
    err_g = (g - gr).abs().max().item()
    ulp = (v - vr).abs() <= torch.finfo(v.dtype).eps * vr.abs()
    log(f"    {name}: differs from the generic path at {int(dv.sum())} values (max |d| "
        f"{err_v:.3g}; {int((dv & ulp).sum())} within one ulp, so rounding, not a voxel "
        f"or winner) and {int(dg.sum())} gradients (max |d| {err_g:.3g}; "
        f"{int((dg & ~dv).sum())} with equal values: a tie or the rotation's rounding)")
    check(err_v <= 1e-6 and err_g <= 1e-5,
          f"{name}: beyond 1e-6 (value) / 1e-5 (gradient) of the generic path")
    return False


def coherent_small_cases(device, tmp):
    """``(name, composition, resolution, range, cache resolution)``: sphere
    caches through the single-child, single-trilinear and trilinear-union
    routes (the headline arm takes the nearest per-tile union)."""
    import pytorch_volumetric_tpu_torch as pt
    rng_pd = np.array([[-0.6, 0.6], [0.0, 0.0], [-0.6, 0.6]])
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.array([[c, -s, 0, 0.1], [s, c, 0, -0.05], [0, 0, 1, 0.02], [0, 0, 0, 1]],
                   np.float32)
    cases = []
    for interp in ("nearest", "trilinear"):
        cache = pt.CachedSDF(f"ball_{interp}", 0.04, np.array([[-0.5, 0.5]] * 3),
                             pt.SphereSDF(0.3, device=device), interpolation=interp,
                             cache_path=os.path.join(tmp, "coherent_small.npz"))
        tsf = pt.Transform3d(matrix=torch.as_tensor(np.stack([rot, np.eye(4, dtype=np.float32)]),
                                                    device=device))
        cases.append((f"single {interp} child", pt.ComposedSDF([cache], tsf), 0.02, rng_pd, 0.04))
    children, mats = [], []
    for i in range(4):
        children.append(pt.CachedSDF(f"j{i}", 0.04, np.array([[-0.5, 0.5]] * 3),
                                     pt.SphereSDF(0.05, device=device), interpolation="trilinear",
                                     cache_path=os.path.join(tmp, "coherent_small.npz")))
        m = np.eye(4, dtype=np.float32)
        ang = np.pi / 2 * i + 0.3
        m[0, 3], m[1, 3] = -0.03 * np.cos(ang), -0.03 * np.sin(ang)
        mats.append(m)
    cases.append(("trilinear union of 4", pt.ComposedSDF(
        children, pt.Transform3d(matrix=torch.as_tensor(np.stack(mats), device=device))),
        0.02, np.array([[-0.2, 0.2], [-0.2, 0.2], [-0.1, 0.1]]), 0.04))
    return cases


def phase_coherent(device, arm_dir, tmp, card, generic_ms, n_configs=N_CONFIGS,
                   query_res=QUERY_RES, resolution=0.02, reps=5):
    """``RobotSDF.query_grid`` on the headline arm from a fresh cache:
    8 nearest links on the per-tile winner union, ``seg`` = 12."""
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS

    text = open(os.path.join(arm_dir, "arm.urdf")).read()
    q, pts_g = headline_inputs(device, n_configs, query_res)

    def objective_grad(fn):
        qq = q.detach().clone().requires_grad_(True)
        v, g = fn(qq)
        (dq,) = torch.autograd.grad(v.sum() + g.sum(), qq)
        return v.detach().reshape(q.shape[0], -1), g.detach().reshape(q.shape[0], -1, 3), dq

    # the main path, from a fresh cache: the build (K1) and the grid query
    # with its gradient w.r.t. the joint angles (the union kernel)
    COUNTERS["kernel.closest_point_sweep"] = 0
    COUNTERS["kernel.coherent_union_tile"] = 0
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=arm_dir,
                        link_sdf_cls=pt.cache_link_sdf_factory(
                            resolution=resolution, padding=1.0,
                            cache_path=os.path.join(tmp, "coherent_cache.npz")))
    sync(device)
    build_launches = COUNTERS["kernel.closest_point_sweep"]
    fk_reset()
    v, g, dq = objective_grad(lambda qq: robot.query_grid(qq, QUERY_RANGE, query_res))
    fk_counts(device, "query_grid", 1, 1)
    sync(device)
    launches = COUNTERS["kernel.closest_point_sweep"]
    union_launches = COUNTERS["kernel.coherent_union_tile"]
    check(launches == build_launches, "coherent path: K1 ran in the grid query")
    log(f"  launches on the main path: K1 {build_launches} (the cache build; 0 in the query), "
        f"coherent_union_tile {union_launches}")

    children = tuple(robot.sdf.sdfs)
    _, fast, generic, min_res = tsdf._coherent_plan(children)
    pts, take, seg = pt.get_coherent_tile_points(query_res, QUERY_RANGE, cache_resolution=min_res,
                                                 device=device)
    tables = tsdf.coherent_fast_tables(children)
    T = q.shape[0] * pts.shape[0] // seg
    cap = min(T, max(int(np.ceil(T * 0.04)), 32))
    log(f"  {len(fast)} nearest links on the brick path, {len(generic)} generic; seg = {seg}, "
        f"{pts.shape[0]} padded points in {pts.shape[0] // seg} tiles ({len(take)} taken); "
        f"brick rows per link {T} (the generic path's rows: {q.shape[0] * len(take)}); "
        f"tables per link (MB): vg {tables[0].vg.numel() * 4 / 1e6:.1f}, bricks "
        f"{tables[0].bricks.numel() * 4 / 1e6:.1f}, "
        f"gbricks {tables[0].gbricks.numel() * 4 / 1e6:.1f}")
    check(seg == 12 and len(fast) == len(children) == 8 and not generic,
          "coherent path: expected 8 nearest links on 12-point tiles")
    check(all(t.gbricks is not None and t.bricks4 is None for t in tables),
          "coherent path: the 8-link union must carry gradient bricks and no bricks4")
    robot.set_joint_configuration(q[:N_CHECK])
    check(robot.sdf.check_coherent_contract(pts, seg=seg),
          f"coherent path: the tiles break the contract on {N_CHECK} configurations")
    check(bool(torch.isfinite(v).all() and torch.isfinite(g).all() and torch.isfinite(dq).all()),
          "coherent path: non-finite output")

    vr, gr, dqr = objective_grad(lambda qq: robot.query(qq, pts_g))
    exact = exact_or_gate(f"query_grid vs query ({q.shape[0]} x {len(take)})", v, g, vr, gr)
    # d/dq sums 15,251 points' terms per configuration in float32, so the
    # order of the sums alone moves a small component by ~1e-3: the gate is
    # 2e-4 of each configuration's largest |d/dq|, and the generic path's
    # own noise (its points in another order) is printed beside it
    perm = torch.as_tensor(np.random.default_rng(1).permutation(pts_g.shape[0]), device=device)
    _, _, dqp = objective_grad(lambda qq: robot.query(qq, pts_g[perm]))
    scale = dqr.abs().amax(dim=1, keepdim=True).clamp(min=1.0)

    def dq_errs(a):
        return (((a - dqr).abs() / (2e-4 + 2e-4 * dqr.abs())).max().item(),
                ((a - dqr).abs() / (2e-4 * scale)).max().item())

    (tile_el, tile_sc), (perm_el, perm_sc) = dq_errs(dq), dq_errs(dqp)
    log(f"    d(v.sum()+g.sum())/dq: max |d| {(dq - dqr).abs().max().item():.3g}; of the gate "
        f"2e-4 x each configuration's largest |d/dq| (max {dqr.abs().max().item():.4g}): "
        f"{tile_sc:.3g}; of rtol = atol = 2e-4 per component: {tile_el:.3g}. The generic "
        f"path on its points reordered: max |d| {(dqp - dqr).abs().max().item():.3g}, "
        f"{perm_sc:.3g} and {perm_el:.3g} of the same gates")
    check(tile_sc <= 1.0, "coherent path: d/dq beyond 2e-4 of the generic path")
    with torch.no_grad():
        vo = robot.query_grid(q, QUERY_RANGE, query_res, values_only=True)
    check(torch.equal(vo.reshape(q.shape[0], -1), v), "values_only differs from the full values")

    # the residual lane: middle tiles (>= 4 distinct winners) beyond a
    # capacity of 1 get NaN gradients, each holding at least one
    m, m_inv = robot._link_transforms(q)
    with torch.no_grad():
        _, g_of = tsdf.compose_query_coherent(children, m, m_inv, q.shape[0], pts, seg=seg,
                                              residual_frac=1e-9)
    nan_tiles = int(torch.isnan(g_of).reshape(q.shape[0], -1, seg * 3).any(dim=-1).sum())
    log(f"    middle tiles (>= 4 distinct winners): {nan_tiles + 1} of {T} "
        f"({(nan_tiles + 1) / T * 100:.3f}%), capacity {cap} at residual_frac 0.04; "
        f"at residual_frac 1e-9 (capacity 1) {nan_tiles} tiles NaN")
    check(nan_tiles > 0, "residual_frac=1e-9 left every gradient finite")
    check(nan_tiles + 1 <= cap, "more middle tiles than the default capacity")

    # the union kernel against its plain version on this path's own inputs,
    # at the default capacity (timed) and at 1e-9, then on the sphere cases
    # (every seg of UNION_SEGS, NaN and +-inf points)
    u_in = union_inputs(robot, tables, q, pts, seg)
    union = compare_union(f"union kernel, {q.shape[0]} x {pts.shape[0]}", *u_in, timed=True)
    compare_union("union kernel, residual_frac 1e-9", *u_in, residual_frac=1e-9)
    union_case_checks(device, tmp)
    union["norm_order_mismatches"] = norm_order_probe(device)
    del u_in

    for name, comp, res, rng_pd, cache_res in coherent_small_cases(device, tmp):
        pts_t, take_t, seg_t = pt.get_coherent_tile_points(res, rng_pd, cache_resolution=cache_res,
                                                           device=device)
        _, pts_r = pt.get_coordinates_and_points_in_grid(res, rng_pd, device=device)
        check(comp.check_coherent_contract(pts_t, seg=seg_t), f"{name}: contract")
        vc, gc = comp.query_coherent(pts_t, seg=seg_t)
        vs, gs = comp(pts_r)
        tk = torch.as_tensor(take_t, device=device)
        exact &= exact_or_gate(f"{name}, seg {seg_t}", vc[..., tk], gc[..., tk, :], vs, gs)

    robot.set_joint_configuration(q)

    def fwd():
        with torch.no_grad():
            robot.query_grid(q, QUERY_RANGE, query_res)

    def values_only():
        robot.query_grid(q, QUERY_RANGE, query_res, values_only=True)

    def fwd_bwd():
        objective_grad(lambda qq: robot.query_grid(qq, QUERY_RANGE, query_res))

    fwd_ms = time_ms(fwd, device, reps=reps)
    fb_ms = time_ms(fwd_bwd, device, reps=reps)
    vo_ms = time_ms(values_only, device, reps=reps)
    n = q.shape[0] * len(take)
    log(f"  coherent grid path {q.shape[0]} x {len(take)}: forward {fwd_ms:.3f} ms "
        f"({n / fwd_ms / 1e3:.4g} M queries/s), forward+backward {fb_ms:.3f} ms, values_only "
        f"{vo_ms:.3f} ms; the generic cached path in phase 4: forward {generic_ms[0]:.3f} ms, "
        f"forward+backward {generic_ms[1]:.3f} ms [{card}]; kernel launches on the path "
        f"(its cache build): {launches}; bit-identical everywhere: {exact}")
    union["launches"] = union_launches
    return launches, fwd_ms, vo_ms, union


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
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS

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
    COUNTERS["kernel.closest_point_sweep"] = 0
    t0 = time.perf_counter()
    pd = pt.PlausibleDiversity(factory, model_points_eval=pts)
    errors, ret = evaluate(pd)
    sync(device)
    first_s = time.perf_counter() - t0
    exact_launches = COUNTERS["kernel.closest_point_sweep"]
    check(errors.shape == (n_est, n_plausible), "chamfer: error matrix shape")
    check(bool(torch.isfinite(errors).all() and (errors >= 0).all()),
          "chamfer: non-finite or negative errors")
    exact_ms = time_ms(lambda: evaluate(pd), device, reps=reps, warmup=0)

    # cached: a CachedSDF the kernel builds, then nearest-voxel lookups
    COUNTERS["kernel.closest_point_sweep"] = 0
    t0 = time.perf_counter()
    obj_sdf = pt.CachedSDF(factory.name, resolution, factory.bounding_box(padding=padding),
                           pt.MeshSDF(factory), cache_path=os.path.join(tmp, "chamfer.npz"))
    sync(device)
    build_s = time.perf_counter() - t0
    pdc = pt.PlausibleDiversity(factory, model_points_eval=pts, obj_sdf=obj_sdf)
    errors_c, ret_c = evaluate(pdc)
    sync(device)
    cached_launches = COUNTERS["kernel.closest_point_sweep"]
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
    from pytorch_volumetric_tpu_torch.ops.closest_point import LAUNCHES
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS

    errs = {"nowind": 0.0, "mxu": 0.0, "mxu_wind": 0.0}
    cases = sweep_cases(device)
    for kind in ("nowind", "mxu"):
        log(f"  {kind} vs its plain version:")
        for case, pts, tri, box in cases:
            e = compare_kernel(kind, case, pts, tri, device, box)
            errs[kind] = max(errs[kind], e["dist"], e["closest"])
            if kind == "mxu":
                errs["mxu_wind"] = max(errs["mxu_wind"], e["winding"])

    # the probe's own run (it checks each kernel against its plain version
    # at its first launch, then times it): the launches counted for them
    keys = {w.__name__: LAUNCHES[w] for w, _, _ in sr.SWEEPS.values()}
    keys["fma_probe_cuda"] = "kernel.fma_probe"
    for key in keys.values():
        COUNTERS[key] = 0
    out = sr.run(device, reps=reps)
    launches = {name: COUNTERS[key] for name, key in keys.items()}
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
                f"ceiling; brute-force bound {r['bound_ms']:.3f} ms"
                + (f" (over the {100 * r['evaluated_share']:.1f}% of pairs evaluated: "
                   f"{r['bound_evaluated_ms']:.3f} ms)" if "bound_evaluated_ms" in r else "")
                + (f"; plain {r['plain_ms']:.1f} ms" if "plain_ms" in r else "")
                + f"; errors |d| {e['dist']:.3g} |closest| {e['closest']:.3g} "
                f"face {e['face']:.3g} |wind| {e['winding']:.3g}")
            if r["gated"]:
                check(r["ok"], f"{name} on the {cell}: beyond its gates")
    for cell in ("torus", "capsule_grid"):
        mxu, k1 = out[cell]["sweeps"]["mxu"], out[cell]["sweeps"]["base"]
        log(f"  mxu on the {cell}: {mxu['ms']:.4f} ms"
            + (f" (before its redesign: {MXU_GRID_MS_BEFORE} ms on an H100 80GB HBM3 at 700 W)"
               if cell == "capsule_grid" else "")
            + f", K1 {k1['ms']:.4f} ms; closest points evaluated: mxu "
            f"{mxu['closest_pairs']}, K1 {k1['closest_pairs']}; solid angles: mxu "
            f"{mxu['winding_pairs']}, K1 {k1['winding_pairs']}; bound over them: mxu "
            f"{mxu['bound_evaluated_ms']:.4f} ms, K1 {k1['bound_evaluated_ms']:.4f} ms [{card}]")
    check(out["ok"], "the roofline probe: a gate failed")
    return {"launches": launches, "fma": fma, "grid": out["capsule_grid"]["sweeps"],
            "errs": errs}


# ---------------------------------------------------------------------------
# phase 7: the arm as MJCF
# ---------------------------------------------------------------------------

def phase_mjcf(device, arm_dir, card, n_configs=N_CONFIGS, query_res=QUERY_RES, reps=3):
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
    from pytorch_volumetric_tpu_torch.utils.robots import serial_arm_mjcf

    q, pts = headline_inputs(device, n_configs, query_res)
    COUNTERS["kernel.closest_point_sweep"] = 0
    robot = pt.RobotSDF(pt.build_serial_chain_from_mjcf(serial_arm_mjcf(), "link7",
                                                        device=device),
                        path_prefix=arm_dir)
    v, g, dq = query_objective_grad(robot, q, pts)
    sync(device)
    launches = COUNTERS["kernel.closest_point_sweep"]
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


# ---------------------------------------------------------------------------
# phase 10: the narrow-band SDF
# ---------------------------------------------------------------------------

def arm_gates(name, v, v_ex, exact_within):
    """A narrow-band arm's values ``v`` against the exact-link arm's
    ``v_ex``: within 1e-4 where ``|v_ex| < exact_within``, and above it
    nowhere by more than 0.01 (the far field and the box fallback
    underestimate)."""
    near = v_ex.abs() < exact_within
    err_near = (v - v_ex)[near].abs().max().item() if bool(near.any()) else float("nan")
    over = (v - v_ex).max().item()
    log(f"  narrow-band arm ({name}) vs exact-link arm ({v.shape[0]} x {v.shape[1]}): |val| "
        f"err {err_near:.3g} at the {int(near.sum())} points within {exact_within:.4g} of the "
        f"surface; largest v_nb - v_exact {over:.3g}; largest |v_nb - v_exact| "
        f"{(v - v_ex).abs().max().item():.3g}")
    check(bool(near.any()) and err_near <= 1e-4,
          f"narrow-band arm ({name}): beyond 1e-4 of the exact-link arm near the surface")
    check(over <= 0.01, f"narrow-band arm ({name}): above the exact-link arm by more than 0.01")


def phase_narrow_band(device, arm_dir, tmp, card, n_configs=N_CONFIGS, query_res=QUERY_RES,
                      bigmesh=None, reps=3):
    """The narrow-band kernel against its plain version, the bigmesh
    benchmark (``bench.bigmesh.run``) and the headline arm with
    narrow-band links."""
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.bench import bigmesh as bm
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS

    err = 0.0
    log("  kernel vs plain version:")
    for name, smalls, big, pts in bm.kernel_cases(device):
        c = bm.compare(smalls, big, pts)
        log(f"    {name}: P={pts.shape[0]}, K={big.cand.shape[1]}: equal {c['equal']}, slots "
            f"equal {c['slots_equal']}, max |d| value {c['value_err']:.3g} gradient "
            f"{c['grad_err']:.3g}, {c['nan_values']} NaN values"
            + (f"; first difference: {c['first_difference']}"
                                      if "first_difference" in c else ""))
        check(c["ok"], f"narrow band, {name}: differs from the plain version")
        err = max(err, c["max_abs_err"])

    log("  bigmesh (bench/bigmesh.py):")
    COUNTERS["kernel.narrow_band_query"] = 0
    big_out = bm.run(device, log=lambda m: log(f"    {m}"), **(bigmesh or {}))
    sync(device)
    bigmesh_launches = COUNTERS["kernel.narrow_band_query"]
    check(big_out["ok"], "bigmesh: a gate failed (kernel vs plain, in-band vs the exact "
          "sweep, or the far field)")
    for r in big_out["builds"].values():
        err = max(err, r["kernel_vs_plain"]["max_abs_err"])

    # the headline arm with narrow-band links, from a fresh cache (the 7
    # capsule links share one build)
    text = open(os.path.join(arm_dir, "arm.urdf")).read()
    q, pts = headline_inputs(device, n_configs, query_res)
    COUNTERS["kernel.narrow_band_query"] = 0
    t0 = time.perf_counter()
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=arm_dir, link_sdf_cls=pt.narrow_band_link_sdf_factory(
                            cache_path=os.path.join(tmp, "narrow_band.npz")))
    build_s = time.perf_counter() - t0
    v, g, dq = query_objective_grad(robot, q, pts)
    sync(device)
    arm_launches = COUNTERS["kernel.narrow_band_query"]
    check(v.shape == (n_configs, pts.shape[0]) and g.shape == v.shape + (3,),
          "narrow-band robot: output shape")
    check(bool(torch.isfinite(v).all() and torch.isfinite(g).all() and torch.isfinite(dq).all()),
          "narrow-band robot: non-finite output")

    # the kernel on the arm's own launches (its points, mostly far field and
    # outside the grids) against the plain version on the card: the same
    # arm on the same cached tables with backend="torch"
    plain = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=arm_dir, link_sdf_cls=pt.narrow_band_link_sdf_factory(
                            cache_path=os.path.join(tmp, "narrow_band.npz"), backend="torch"))
    before = COUNTERS["kernel.narrow_band_query"]
    vp, gp, dqp = query_objective_grad(plain, q, pts)
    sync(device)
    check(COUNTERS["kernel.narrow_band_query"] == before,
          "the plain narrow-band arm launched the kernel")
    dv, dg = v != vp, (g != gp).any(dim=-1)
    err_v, err_g = (v - vp).abs().max().item(), (g - gp).abs().max().item()
    err_dq = ((dq - dqp).abs() / dqp.abs().clamp(min=1.0)).max().item()
    first = ""
    if bool(dv.any() or dg.any()):
        c, i = (int(x) for x in torch.nonzero(dv | dg)[0])
        first = (f"; first difference: configuration {c}, point {i} {pts[i].tolist()}: kernel "
                 f"{v[c, i].item()!r} {g[c, i].tolist()}, plain {vp[c, i].item()!r} "
                 f"{gp[c, i].tolist()}")
    log(f"  narrow-band arm, kernel vs plain version on the card ({v.shape[0]} x {v.shape[1]}, "
        f"{arm_launches} launches): {int(dv.sum())} values and {int(dg.sum())} gradients "
        f"differ, max |d| value {err_v:.3g} gradient {err_g:.3g}, d/dq rel {err_dq:.3g}{first}")
    check(not bool(dv.any() or dg.any()) and torch.equal(dq, dqp),
          "narrow-band arm: the kernel's values, gradients or d/dq differ from its plain "
          "version's")
    err = max(err, err_v, err_g)
    del plain, vp, gp, dqp
    # the kernel on each of the arm's own launches (link-frame points):
    # equal to the plain version again, timed beside its bound
    calls = bm.link_launches(robot, q, pts)
    check(len(calls) == (arm_launches if device.type == "cuda" else len(robot.sdf.sdfs)),
          "narrow-band arm: bench.bigmesh.link_launches does "
          "not give the path's launches (one per narrow-band link)")
    arm = bm.launch_times(calls, reps=reps * 3)
    del calls
    check(arm["equal"], "narrow-band arm: a launch differs from the plain version")
    log(f"  narrow-band kernel per arm launch ({arm['launches']} launches, "
        f"{arm['points'] // max(arm['launches'], 1)} points and "
        f"{arm['in_band'] / max(arm['launches'], 1):.0f} in band each): {arm['ms']:.4f} ms "
        + (f"(device kernels {arm['kernel_ms']:.4f} ms, {arm['kernels_per_call']:g} per call"
           if arm["kernel_ms"] is not None else "(device kernels not measured")
        + f"), bound {arm['bound_ms']:.4f} ms, "
        f"plain {arm['plain_ms']:.3f} ms [{card}]")

    exact = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=arm_dir)
    with torch.no_grad():
        v_ex, _ = exact.query(q, pts)
    # at the defaults (cells of diag / 96, a band of 4 cells) a link is exact
    # within band - half_diag of its surface, and its far field
    # underestimates by at most a cell diagonal: the union is exact where
    # the exact arm's value is below band - 3 half diagonals
    half = max(0.5 * float(torch.linalg.vector_norm(s.tables.res)) for s in robot.sdf.sdfs)
    exact_within = min(s.band for s in robot.sdf.sdfs) - 3 * half
    arm_gates("defaults", v, v_ex, exact_within)
    # the JAX package's own robot test build (tests/test_narrow_band.py:116):
    # a 0.06 band, exact within 0.02 of the surface
    jax_build = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                            path_prefix=arm_dir, link_sdf_cls=pt.narrow_band_link_sdf_factory(
                                cell_res=0.015, band=0.06, padding=0.1,
                                cache_path=os.path.join(tmp, "narrow_band.npz")))
    with torch.no_grad():
        arm_gates("cells 0.015, band 0.06", jax_build.query(q, pts)[0], v_ex, 0.02)
    vg, gg = robot.query_grid(q, QUERY_RANGE, query_res)
    exact_or_gate("query_grid vs query (narrow-band links)", vg.reshape(v.shape),
                  gg.reshape(g.shape), v, g)
    fwd_ms, fb_ms = time_robot(robot, q, pts, device, reps)
    n = q.shape[0] * pts.shape[0]
    cells = sorted({tuple(s.tables.dims.tolist()) + (s.tables.cand.shape[1],)
                    for s in robot.sdf.sdfs})
    log(f"  narrow-band arm {q.shape[0]} x {pts.shape[0]}: build {build_s:.2f} s (grids and K "
        f"{cells}), forward {fwd_ms:.2f} ms ({n / fwd_ms / 1e3:.4g} M queries/s), "
        f"forward+backward {fb_ms:.2f} ms [{card}]; narrow-band launches on the path "
        f"{arm_launches}, in the bigmesh run {bigmesh_launches}")
    return {"max_abs_err": err, "bigmesh": big_out, "arm_launches": arm_launches,
            "bigmesh_launches": bigmesh_launches, "arm_fwd_ms": fwd_ms, "arm_fb_ms": fb_ms,
            "arm_launch": arm}


# ---------------------------------------------------------------------------
# phase 11: the neural SDF models
# ---------------------------------------------------------------------------

# benchmarks/neural.py's distillation of the headline arm
NEURAL_FIT = dict(width=128, depth=4, fourier=96, n_configs=256, pts_per_config=2048,
                  steps=4000, batch=8192, lr=1e-3, activation="sine")


def loss_gate(name, losses):
    """The JAX package's test gate (tests/test_neural_sdf.py): the mean of
    the last 50 losses below half the mean of the first 50; prints the
    losses' quarters as benchmarks/neural.py does."""
    l = losses.detach().cpu().numpy()
    check(l.shape[0] >= 100 and bool(np.isfinite(l).all()), f"{name}: non-finite losses")
    qtr = [float(l[max(0, i * len(l) // 4 - 25):i * len(l) // 4 + 25].mean())
           for i in range(1, 4)]
    first, last = float(l[:50].mean()), float(l[-50:].mean())
    log(f"    {name}: loss {first:.5g} -> {last:.5g} (quarters {[f'{x:.5g}' for x in qtr]})")
    check(last < 0.5 * first, f"{name}: the loss did not halve (the JAX test's gate)")


def rmse(err, mask=None):
    err = err if mask is None else err[mask]
    return float(torch.sqrt(torch.mean(err ** 2)))


def neural_card_vs_cpu(model, q, pts, device):
    """The model on the card against the same weights on the CPU (an npz
    written on the card and loaded there, arrays identical): values within
    1e-5, gradients within 1e-4 (summation order alone: ~3e-7 and ~1e-6
    on the distilled arm); then bfloat16 compute (the card's tensor
    cores against the CPU's float32 products of bfloat16-rounded operands)
    within 2e-2 of the values' and gradients' scales.  Returns the largest
    differences per dtype."""
    import pytorch_volumetric_tpu_torch as pt
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "neural.npz")
        model.save(path)
        cpu_model = pt.ConfigSpaceNeuralSDF.load(path, device="cpu")
    same = all(torch.equal(a.detach().cpu(), b) for pair_a, pair_b in zip(model.params,
                                                                         cpu_model.params)
               for a, b in zip(pair_a, pair_b))
    same &= all(torch.equal(getattr(model, k).cpu(), getattr(cpu_model, k))
                for k in ("fourier_B", "q_lo", "q_hi"))
    log(f"    npz written on the card, loaded on the CPU: arrays identical {same}")
    check(same, "neural npz: the CPU's arrays differ from the card's")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model.compute_dtype = cpu_model.compute_dtype = dtype
        v, g = model.query(q, pts)
        vc, gc = cpu_model.query(q.cpu(), pts.cpu())
        ev, eg = (v.cpu() - vc).abs().max().item(), (g.cpu() - gc).abs().max().item()
        sv, sg = vc.abs().max().item(), gc.abs().max().item()
        name = str(dtype).replace("torch.", "")
        out[name] = (ev, eg)
        log(f"    {name} on the card vs the CPU ({q.shape[0]} x {pts.shape[0]}): max |d| value "
            f"{ev:.3g} (scale {sv:.3g}), gradient {eg:.3g} (scale {sg:.3g})")
        if dtype == torch.float32:
            check(ev <= 1e-5 and eg <= 1e-4, "neural model: the card differs from the CPU "
                  "beyond 1e-5 (values) / 1e-4 (gradients)")
        else:
            check(ev <= 2e-2 * sv and eg <= 2e-2 * sg, "neural model, bfloat16: the card's "
                  "tensor-core products differ from the CPU's beyond 2e-2 of the scale")
    model.compute_dtype = torch.float32
    return out


def time_train_step(model, n_rows, device, M, steps=200):
    """ms per training step of ``_fit`` in steady state: ``steps`` steps on
    a copy of the model's weights over a random dataset of the distill's
    size (a step's work does not depend on the data)."""
    from pytorch_volumetric_tpu_torch.models import neural_sdf as tn
    params = tn.MLP([(W.detach().clone(), b.detach().clone()) for W, b in model.params])
    gen = torch.Generator(device=device).manual_seed(1)
    qx = torch.rand((n_rows, M + 3), generator=gen, device=device) * 2 - 1
    v = torch.rand((n_rows,), generator=gen, device=device) - 0.5
    g = torch.nn.functional.normalize(torch.randn((n_rows, 3), generator=gen, device=device),
                                      dim=-1)

    def run(n):
        tn._fit(params, lambda b: model._features(b[..., :M], b[..., M:]), gen, qx, v, g, n,
                NEURAL_FIT["batch"], NEURAL_FIT["lr"], 0.1, 30.0, torch.float32, "sine")

    run(5)
    return time_ms(lambda: run(steps), device, reps=1, warmup=0) / steps


def phase_neural(device, arm_dir, cache_dir, tmp, card, generic_ms, coherent_ms,
                 n_configs=N_CONFIGS, query_res=QUERY_RES, resolution=0.02, fit=None,
                 torus_fit=None, reps=5, n_check=(4, 2048)):
    """The headline arm distilled into a ``ConfigSpaceNeuralSDF`` at
    benchmarks/neural.py's settings (oracle: phase 4's cached-link robot
    from its cache), queried at the headline shape; ``fit_neural_sdf`` on
    phase 5's torus with an exact ``MeshSDF`` oracle (K1 on every oracle
    query); npz from the card to the CPU; ``draw_sdf_slice``."""
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS

    fit = dict(NEURAL_FIT, **(fit or {}))
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmul precision is "
          "not 'highest' (TF32)")
    text = open(os.path.join(arm_dir, "arm.urdf")).read()
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=arm_dir,
                        link_sdf_cls=pt.cache_link_sdf_factory(
                            resolution=resolution, padding=1.0,
                            cache_path=os.path.join(cache_dir, "sdf_cache.npz")))
    M = len(robot.joint_names)
    sync(device)
    t0 = time.perf_counter()
    model, losses = robot.distill(key=0, **fit)
    sync(device)
    fit_s = time.perf_counter() - t0
    check(isinstance(model, pt.ConfigSpaceNeuralSDF) and model.device.type == device.type,
          "distill: the model is not on the robot's device")
    step_ms = time_train_step(model, fit["n_configs"] * fit["pts_per_config"], device, M)
    log(f"  distill ({fit['n_configs']} configurations x {fit['pts_per_config']} points, "
        f"width {fit['width']}, depth {fit['depth']}, fourier {fit['fourier']}, "
        f"{fit['steps']} steps of {fit['batch']}): {fit_s:.2f} s with the oracle sweep; "
        f"a training step {step_ms:.4f} ms in steady state [{card}]")
    loss_gate("distill", losses)

    # accuracy against the oracle on fresh configurations and points
    rng = np.random.default_rng(1)
    lims = robot.chain.get_joint_limits()
    qs_test = torch.as_tensor(rng.uniform(lims[:, 0], lims[:, 1], (8, M)).astype(np.float32),
                              device=device)
    pts_test = torch.as_tensor(rng.uniform(-0.8, 0.8, (4096, 3)).astype(np.float32),
                               device=device)
    robot.set_joint_configuration(qs_test)
    with torch.no_grad():
        v_gt, _ = robot(pts_test)
    v_est, _ = model.set_joint_configuration(qs_test)(pts_test)
    shell = v_gt.abs() < 0.1
    err = v_est - v_gt
    log(f"    RMSE against the oracle (8 configurations x 4096 points): overall "
        f"{rmse(err):.5f}, near-surface shell (|d| < 0.1, {int(shell.sum())} points) "
        f"{rmse(err, shell):.5f}")
    check(bool(torch.isfinite(v_est).all()), "distilled model: non-finite values")

    # the headline query
    q, pts = headline_inputs(device, n_configs, query_res)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    v, g = model.query(q, pts)
    sync(device)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else 0.0
    check(v.shape == (q.shape[0], pts.shape[0]) and g.shape == v.shape + (3,),
          "neural query: output shape")
    check(bool(torch.isfinite(v).all() and torch.isfinite(g).all()), "neural query: non-finite")
    del v, g
    qq = q[:1].detach().clone().requires_grad_(True)
    vq, _ = model.query(qq, pts[:256])
    (dq,) = torch.autograd.grad(vq.sum(), qq)
    log(f"    d(v.sum())/dq at one configuration: finite {bool(torch.isfinite(dq).all())}, "
        f"max |d/dq| {dq.abs().max().item():.4g}")
    check(bool(torch.isfinite(dq).all()) and dq.abs().max().item() > 0,
          "neural query: d/dq not finite or zero")

    def value_grad():
        model.query(q, pts)

    def value_only():
        with torch.no_grad():
            model.value(q[:, None], pts)

    vg_ms = time_ms(value_grad, device, reps=reps)
    vo_ms = time_ms(value_only, device, reps=reps)
    model.compute_dtype = torch.bfloat16
    vg16_ms = time_ms(value_grad, device, reps=reps)
    vo16_ms = time_ms(value_only, device, reps=reps)
    model.compute_dtype = torch.float32
    n = q.shape[0] * pts.shape[0]
    log(f"  neural query {q.shape[0]} x {pts.shape[0]}: value + gradient {vg_ms:.3f} ms "
        f"({n / vg_ms / 1e3:.4g} M queries/s; peak memory {peak_gb:.2f} GB), value only "
        f"{vo_ms:.3f} ms ({n / vo_ms / 1e3:.4g} M queries/s); bfloat16 products: "
        f"{vg16_ms:.3f} / {vo16_ms:.3f} ms; the cached-link robot (phase 4): forward "
        f"{generic_ms[0]:.3f} ms, forward+backward {generic_ms[1]:.3f} ms; the coherent "
        f"grid path (phase 8): forward {coherent_ms[0]:.3f} ms, values only "
        f"{coherent_ms[1]:.3f} ms [{card}]")
    card_vs_cpu = neural_card_vs_cpu(model, q[:n_check[0]], pts[:n_check[1]], device)

    # draw_sdf_slice of the model at one configuration and of the robot
    robot.set_joint_configuration(q[0])
    for name, s in (("model.at_config(q)", model.at_config(q[0])), ("cached robot", robot)):
        val, grad, sp, *_ = pt.draw_sdf_slice(s, QUERY_RANGE, resolution=query_res,
                                              do_plot=False)
        with torch.no_grad():
            vd, gd = s(sp)
        same = torch.equal(val, vd) and torch.equal(grad, gd)
        log(f"    draw_sdf_slice of the {name}: {val.numel()} points, values and gradients "
            f"equal to a direct query at the returned points: {same}")
        check(same, f"draw_sdf_slice of the {name} differs from a direct query")

    # fit_neural_sdf on the torus, exact MeshSDF oracle (K1)
    path = os.path.join(tmp, "torus_neural.obj")
    pt.mesh.save_obj(pt.mesh.torus_mesh(0.1, 0.03, 128, 64), path)
    torus = pt.MeshSDF(pt.MeshObjectFactory(path, device=device))
    COUNTERS["kernel.closest_point_sweep"] = 0
    t0 = time.perf_counter()
    tmodel, tlosses = pt.fit_neural_sdf(torus, key=0, device=device, **(torus_fit or {}))
    sync(device)
    torus_s = time.perf_counter() - t0
    torus_launches = COUNTERS["kernel.closest_point_sweep"]
    loss_gate("fit_neural_sdf, torus", tlosses)
    bb = torus.surface_bounding_box(padding=0.1)
    u = torch.rand((65536, 3), generator=torch.Generator(device=device).manual_seed(2),
                   device=device)
    p_eval = bb[:, 0] + u * (bb[:, 1] - bb[:, 0])
    with torch.no_grad():
        d_ex, _ = torus(p_eval)
    d_nn, _ = tmodel(p_eval)
    near = d_ex.abs() < 0.02
    terr = d_nn - d_ex
    log(f"  fit_neural_sdf on the {torus.obj_factory.scene.num_faces}-face torus: "
        f"{torus_s:.2f} s, K1 launches {torus_launches}; RMSE against the exact mesh "
        f"(65,536 points in the padded box): overall {rmse(terr):.5f}, shell |d| < 0.02 "
        f"({int(near.sum())} points) {rmse(terr, near):.5f} [{card}]")
    check(bool(torch.isfinite(d_nn).all()), "torus model: non-finite values")
    with tempfile.TemporaryDirectory() as d:
        tp = os.path.join(d, "torus.npz")
        tmodel.save(tp)
        back = pt.NeuralSDF.load(tp, device="cpu")
    check(all(torch.equal(a.detach().cpu(), b) for pa, pb in zip(tmodel.params, back.params)
              for a, b in zip(pa, pb)) and torch.equal(tmodel.fourier_B.cpu(), back.fourier_B),
          "torus model: the npz loaded on the CPU differs")
    return {"fit_s": fit_s, "step_ms": step_ms, "value_grad_ms": vg_ms, "value_only_ms": vo_ms,
            "peak_gb": peak_gb, "torus_launches": torus_launches, "torus_s": torus_s,
            "card_vs_cpu": card_vs_cpu, "model": model}


# ---------------------------------------------------------------------------
# phase 12: serving, debug and examples
# ---------------------------------------------------------------------------

EXAMPLES = ("torch_trajectory_optimization.py", "torch_pose_estimation.py",
            "torch_neural_distillation.py", "torch_serving_export.py")


def serve_consumer(jobs_path):
    """The serving side of phase 12, in a process of its own that imports
    ``pytorch_volumetric_tpu_torch.utils.serving`` and nothing else of the
    port but its counters, ``utils.profiling.COUNTERS`` (the loader registers
    the kernels' ops): each job's program and sidecar loaded on the card,
    one served query's kernel launches counted,
    values, gradients and ``d(v.sum() + g.sum())/dq`` written to an npz,
    and the served forward and forward + backward timed.  Prints one JSON
    line: ``name -> {load_s, fwd_ms, fb_ms, launches}``."""
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
    from pytorch_volumetric_tpu_torch.utils.serving import load_robot_query

    with open(jobs_path) as f:
        jobs = json.load(f)
    kernels = ("closest_point_sweep", "narrow_band_query")
    report = {}
    for job in jobs:
        device = torch.device(job["device"])
        t0 = time.perf_counter()
        query = load_robot_query(job["path"], device=device)
        with np.load(job["inputs"]) as d:
            q = torch.as_tensor(d["q"], device=device)
            pts = torch.as_tensor(d["pts"], device=device)
        sync(device)
        load_s = time.perf_counter() - t0
        with torch.no_grad():
            query(q, pts)  # first call: the kernels' libraries load
            sync(device)
            for k in kernels:
                COUNTERS[f"kernel.{k}"] = 0
            query(q, pts)
            sync(device)
        launches = {k: COUNTERS[f"kernel.{k}"] for k in kernels}
        v, g, dq = objective_grad(query, q, pts)

        def fwd():
            with torch.no_grad():
                query(q, pts)

        report[job["name"]] = {
            "load_s": load_s, "launches": launches,
            "fwd_ms": time_ms(fwd, device, reps=job["reps"]),
            "fb_ms": time_ms(lambda: objective_grad(query, q, pts), device, reps=job["reps"])}
        np.savez(job["out"], v=v.cpu().numpy(), g=g.cpu().numpy(), dq=dq.cpu().numpy())
        del query
    print(json.dumps(report), flush=True)


def equal_gate(name, v, g, vr, gr, what="served", ref="live query"):
    """``(v [A, P], g [A, P, 3])`` against a reference's on the card:
    equal, else the first difference printed and 1e-6 (value) / 1e-5
    (gradient) applied.  Returns whether they are equal."""
    dv, dg = v != vr, (g != gr).any(dim=-1)
    if bool(dv.any() or dg.any()):
        c, i = (int(x) for x in torch.nonzero(dv | dg)[0])
        log(f"    {name}: {int(dv.sum())} values and {int(dg.sum())} gradients differ from the "
            f"{ref}, max |d| value {(v - vr).abs().max().item():.3g} gradient "
            f"{(g - gr).abs().max().item():.3g}; first at configuration {c}, point {i}: "
            f"{what} {v[c, i].item()!r} {g[c, i].tolist()}, {ref} {vr[c, i].item()!r} "
            f"{gr[c, i].tolist()}")
        check((v - vr).abs().max().item() <= 1e-6 and (g - gr).abs().max().item() <= 1e-5,
              f"{name}: the {what} query is beyond 1e-6 / 1e-5 of the {ref}")
    return not bool(dv.any() or dg.any())


def served_gate(name, v, g, vr, gr, dq, dqr):
    """Served ``(v, g, dq)`` against the live query's on the card:
    :func:`equal_gate`; d/dq equal or within 2e-4 of each configuration's
    largest |d/dq| (phase 8's gate)."""
    vg_same = equal_gate(name, v, g, vr, gr)
    scale = dqr.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    dq_rel = ((dq - dqr).abs() / (2e-4 * scale)).max().item()
    log(f"    {name}: served values and gradients equal to the live query's "
        f"{vg_same}, d/dq equal {torch.equal(dq, dqr)} (max |d| "
        f"{(dq - dqr).abs().max().item():.3g}, {dq_rel:.3g} of the 2e-4 gate)")
    check(bool(torch.isfinite(dq).all()) and dq_rel <= 1.0,
          f"{name}: d/dq through the served program beyond 2e-4 of the live query's")
    return vg_same and torch.equal(dq, dqr)


def phase_serving(device, arm_dir, tmp, card, generic_ms, coherent_ms, nb_ms,
                  n_configs=N_CONFIGS, query_res=QUERY_RES, resolution=0.02, reps=5,
                  examples=EXAMPLES, example_args=(), example_env=None):
    """The headline arm served: its cached (phase 4's cache), exact and
    narrow-band (phase 10's cache) links exported at 200 x 15,251 and
    loaded in a fresh process, the grid export at the coherent cell's grid,
    ``checked_query`` on the cached arm, and the four ``examples/torch_*.py``
    at their full settings."""
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.utils import serving
    from pytorch_volumetric_tpu_torch.utils.debug import QueryCheckError, checked_query
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS

    text = open(os.path.join(arm_dir, "arm.urdf")).read()
    q, pts = headline_inputs(device, n_configs, query_res)

    def arm(link_sdf_cls=pt.MeshSDF):
        return pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                           path_prefix=arm_dir, link_sdf_cls=link_sdf_cls)

    arms = {"cached": arm(pt.cache_link_sdf_factory(
                resolution=resolution, padding=1.0, cache_path=os.path.join(tmp, "sdf_cache.npz"))),
            "exact": arm(),
            "narrow_band": arm(pt.narrow_band_link_sdf_factory(
                cache_path=os.path.join(tmp, "narrow_band.npz")))}
    live_ms = {"cached": generic_ms, "exact": None, "narrow_band": nb_ms}
    serve_dir = os.path.join(tmp, "serving")
    os.makedirs(serve_dir, exist_ok=True)
    inputs = os.path.join(serve_dir, "inputs.npz")
    np.savez(inputs, q=q.cpu().numpy(), pts=pts.cpu().numpy())
    jobs, live, stats = [], {}, {}
    for name, robot in arms.items():
        path = os.path.join(serve_dir, f"{name}.pt2")
        stats[name] = serving.export_robot_query(robot, q.shape[0], pts.shape[0], path)
        live[name] = query_objective_grad(robot, q, pts)
        jobs.append({"name": name, "path": path, "inputs": inputs, "reps": reps,
                     "device": str(device),
                     "out": os.path.join(serve_dir, f"{name}.out.npz")})
    del arms["exact"], arms["narrow_band"]
    jobs_path = os.path.join(serve_dir, "jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve", jobs_path],
                          capture_output=True, text=True, timeout=900)
    consumer_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the serving process failed:\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-6000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  the serving process (imports utils.serving only): {consumer_s:.1f} s in all")
    served_launches = {}
    for job in jobs:
        name, r, s = job["name"], report[job["name"]], stats[job["name"]]
        with np.load(job["out"]) as d:
            v, g, dq = (torch.as_tensor(d[k], device=device) for k in ("v", "g", "dq"))
        vr, gr, dqr = live[name]
        served_gate(f"{name} links", v, g, vr, gr, dq, dqr)
        lm = live_ms[name]
        log(f"  {name} links {q.shape[0]} x {pts.shape[0]}: export {s['export_s']:.2f} s, "
            f"sidecar write {s['sidecar_s']:.2f} s, artifact {s['artifact_bytes']} B, sidecar "
            f"{s['sidecar_bytes']} B; load {r['load_s']:.2f} s; served forward "
            f"{r['fwd_ms']:.3f} ms, forward+backward {r['fb_ms']:.3f} ms"
            + (f" (live, phase {4 if name == 'cached' else 10}: {lm[0]:.3f} / {lm[1]:.3f} ms)"
               if lm else "") + f"; kernel launches per served query {r['launches']} [{card}]")
        served_launches[name] = r["launches"]
    n_links = len(arms["cached"].sdf.sdfs) if device.type == "cuda" else 0
    check(served_launches["exact"]["closest_point_sweep"] == n_links,
          f"the served exact-link query did not launch K1 once per link ({n_links})")
    check(served_launches["narrow_band"]["narrow_band_query"] == n_links,
          f"the served narrow-band query did not launch its kernel once per link ({n_links})")
    check(served_launches["cached"] == {"closest_point_sweep": 0, "narrow_band_query": 0},
          "the served cached-link query launched a kernel")
    del live

    # the grid export at the coherent cell's grid, loaded here
    robot = arms["cached"]

    def grid_objective(fn):
        qq = q.detach().clone().requires_grad_(True)
        v, g = fn(qq)
        (dq,) = torch.autograd.grad(v.sum() + g.sum(), qq)
        return v.detach().reshape(q.shape[0], -1), g.detach().reshape(q.shape[0], -1, 3), dq

    for values_only in (False, True):
        path = os.path.join(serve_dir, "grid_v.pt2" if values_only else "grid.pt2")
        s = serving.export_robot_grid_query(robot, q.shape[0], QUERY_RANGE, query_res, path,
                                            values_only=values_only)
        t0 = time.perf_counter()
        grid_query = serving.load_robot_grid_query(path, device=device)
        sync(device)
        load_s = time.perf_counter() - t0
        if values_only:
            with torch.no_grad():
                vo = grid_query(q).reshape(q.shape[0], -1)
            check(torch.equal(vo, vg), "the served values-only grid differs from the served grid")
            ms = time_ms(lambda: grid_query(q), device, reps=reps)
            log(f"  grid export, values only: export {s['export_s']:.2f} s, sidecar write "
                f"{s['sidecar_s']:.2f} s ({s['sidecar_bytes']} B), artifact "
                f"{s['artifact_bytes']} B, load {load_s:.2f} s; served {ms:.3f} ms (live, phase "
                f"8: {coherent_ms[1]:.3f} ms); equal to the served grid's values [{card}]")
            continue
        COUNTERS["kernel.coherent_union_tile"] = 0
        vg, gg, dq = grid_objective(grid_query)
        sync(device)
        served_launches["grid"] = {"coherent_union_tile": COUNTERS["kernel.coherent_union_tile"]}
        check(COUNTERS["kernel.coherent_union_tile"] > 0 or device.type != "cuda",
              "the served grid query launched no coherent_union_tile")
        vgr, ggr, dqr = grid_objective(lambda qq: robot.query_grid(qq, QUERY_RANGE, query_res))
        served_gate("grid export vs query_grid", vg, gg, vgr, ggr, dq, dqr)
        del vgr, ggr

        def fwd():
            with torch.no_grad():
                grid_query(q)

        ms = time_ms(fwd, device, reps=reps)
        fb = time_ms(lambda: grid_objective(grid_query), device, reps=reps)
        log(f"  grid export {q.shape[0]} x {vg.shape[1]} ({len(robot.sdf.sdfs)} links on the "
            f"brick path): export {s['export_s']:.2f} s, sidecar write {s['sidecar_s']:.2f} s "
            f"({s['sidecar_bytes']} B), artifact {s['artifact_bytes']} B, load {load_s:.2f} s; "
            f"served forward {ms:.3f} ms, forward+backward {fb:.3f} ms (live, phase 8: forward "
            f"{coherent_ms[0]:.3f} ms) [{card}]")
        del grid_query

    # checked_query on the cached arm at the headline shape
    robot.set_joint_configuration(q)
    with torch.no_grad():
        v0, g0 = robot.raw_query(pts)
        v1, g1 = checked_query(robot)(pts)
        check(torch.equal(v0, v1) and torch.equal(g0, g1),
              "checked_query: results differ from the unchecked query")
        bad = pts.clone()
        bad[7, 1] = float("nan")
        try:
            checked_query(robot)(bad)
            fail("checked_query: a NaN point did not raise")
        except QueryCheckError as e:
            check("non-finite query points" in str(e), f"checked_query: wrong guard: {e}")
        # any host sync raises in this mode (the card only)
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            err, _ = checked_query(robot, throw=False)(bad)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
        check(err.get() == "non-finite query points",
              f"checked_query(throw=False): {err.get()!r}")
        plain_ms = time_ms(lambda: robot.raw_query(pts), device, reps=reps)
        checked_ms = time_ms(lambda: checked_query(robot)(pts), device, reps=reps)
        lazy_ms = time_ms(lambda: checked_query(robot, throw=False)(pts), device, reps=reps)
    log(f"  checked_query, cached arm {q.shape[0]} x {pts.shape[0]}: equal to the unchecked "
        f"query; a NaN point raises 'non-finite query points'; throw=False ran under "
        f"set_sync_debug_mode('error'); unchecked {plain_ms:.3f} ms, checked {checked_ms:.3f} "
        f"ms, throw=False {lazy_ms:.3f} ms [{card}]")
    del arms, robot

    # the four examples at their full settings
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **(example_env or {}))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    example_s = {}
    for script in examples:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.join(root, "examples", script),
                            *example_args], capture_output=True, text=True, timeout=900,
                           env=env, cwd=tmp)
        example_s[script] = time.perf_counter() - t0
        tail = (p.stdout.strip().splitlines() or [""])[-1]
        err_tail = [ln for ln in p.stderr.strip().splitlines() if "Warning" not in ln][-2:]
        log(f"  {script}: {example_s[script]:.1f} s, exit {p.returncode}; {' | '.join(err_tail)}"
            f" | {tail} [{card}]")
        check(p.returncode == 0, f"{script} failed:\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    return {"served_launches": served_launches, "examples_s": example_s}


# ---------------------------------------------------------------------------
# phase 13: parallel
# ---------------------------------------------------------------------------

def counted(device, fn):
    """``fn()`` with every kernel's launch count set to 0 just before it
    and read just after: ``(result, {kernel: launches})``."""
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
    kernels = ("closest_point_sweep", "narrow_band_query", "coherent_union_tile")
    for k in kernels:
        COUNTERS[f"kernel.{k}"] = 0
    out = fn()
    sync(device)
    return out, {k: COUNTERS[f"kernel.{k}"] for k in kernels}


def audit_gate(name, counts, step=False):
    """A forward's collective histogram must be empty; a step's all-reduce
    only, with at least one."""
    from pytorch_volumetric_tpu_torch import parallel
    log(f"    audit, {name}: {counts}")
    if step:
        parallel.assert_collectives(counts, allowed=("all-reduce",), require=("all-reduce",))
    else:
        parallel.assert_collectives(counts, allowed=())


def no_grad_ms(fn, device, reps):
    def run():
        with torch.no_grad():
            fn()
    return time_ms(run, device, reps=reps)


def torus_points(device, factory, n):
    """``n`` points (seeded) in the torus's box padded by 0.05."""
    bb = torch.as_tensor(factory.bounding_box(padding=0.05), dtype=torch.float32, device=device)
    u = torch.rand((n, 3), generator=torch.Generator(device=device).manual_seed(3),
                   device=device)
    return bb[:, 0] + u * (bb[:, 1] - bb[:, 0])


def collision_steps(robot, q, pts, mesh, steps=5, reorders=0):
    """``steps`` Adam steps (lr 0.05, margin 0.1) with ``mesh`` and without,
    their losses and ``q`` side by side, gated: loss within 1e-6 relative
    at every step, ``q`` within 1e-5 after the first step and the loss
    falls.  The final ``q`` is held to 1e-5, or with ``reorders`` to twice
    the largest deviation of the unsharded step run on that many
    permutations of the points (the same step summed in another order:
    Adam divides each joint's gradient by its own running scale, so a
    gradient summed to near zero over 15,251 points moves ``q`` by more
    than its rounding).  Returns the sharded step, its state, its ``q``,
    the unsharded step, its state, its ``q`` and the number of step calls."""
    from pytorch_volumetric_tpu_torch import parallel

    def adam(ps):
        return torch.optim.Adam(ps, lr=0.05)

    step = parallel.make_collision_step(robot, adam, margin=0.1, mesh=mesh)
    ref = parallel.make_collision_step(robot, adam, margin=0.1)
    cr = mesh.get_local_rank("config")

    def q_err(q_sharded, q_ref):
        q_loc = q_sharded.to_local()
        return (q_loc - q_ref[cr * q_loc.shape[0]:(cr + 1) * q_loc.shape[0]]).abs().max().item()

    qs, st = q, step.init(q)
    qr, sr = q, ref.init(q)
    losses, errs = [], []
    for _ in range(steps):
        qs, st, loss = step(qs, st, pts)
        qr, sr, loss_r = ref(qr, sr, pts)
        losses.append((float(loss), float(loss_r)))
        errs.append(q_err(qs, qr))
    noise = 0.0
    for k in range(reorders):
        perm = torch.randperm(pts.shape[0], generator=torch.Generator().manual_seed(k))
        qp, sp = q, ref.init(q)
        for _ in range(steps):
            qp, sp, _ = ref(qp, sp, pts[perm.to(pts.device)])
        noise = max(noise, (qp - qr).abs().max().item())
    tol = max(1e-5, 2 * noise)
    err_l = max(abs(a - b) / max(abs(b), 1e-30) for a, b in losses)
    log(f"    collision step x{steps} (Adam, lr 0.05, margin 0.1): losses {[a for a, _ in losses]} "
        f"(unsharded {[b for _, b in losses]}); loss rel err {err_l:.3g}; |q| err per step "
        f"{[f'{e:.3g}' for e in errs]}"
        + (f"; the unsharded step's own reorder noise ({reorders} permutations) {noise:.3g}, "
           f"gate {tol:.3g}" if reorders else ""))
    check(err_l <= 1e-6 and errs[0] <= 1e-5 and errs[-1] <= tol,
          f"collision step: beyond 1e-6 (loss, relative) / 1e-5 (q, first step) / {tol:.3g} "
          f"(q, last step) of the unsharded step")
    check(losses[-1][0] < losses[0][0], "collision step: the loss did not fall")
    return step, st, qs, ref, sr, qr, steps * (2 + reorders)


def phase_parallel(device, arm_dir, tmp, card, model, n_configs=N_CONFIGS,
                   query_res=QUERY_RES, resolution=0.02, reps=5, n_torus=1 << 17,
                   rank_timeout=600):
    """``parallel`` at world size 1 in this process (NCCL on the card): the
    sharded robot queries (phase 4's cached arm, the exact arm, phase 10's
    narrow-band arm), the coherent grid, the neural model of phase 11, the
    SDF query on phase 5's torus and the collision step, each against its
    unsharded call with both times, and the collective audit; then a world
    of two ranks on this card (gloo, ``--parallel-rank``)."""
    import torch.distributed as dist
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch import parallel
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from torch.distributed.tensor import DTensor

    check(parallel.init_distributed() == (0, 1), "init_distributed() is not (0, 1) alone")
    mesh = parallel.make_device_mesh(device=device)
    backend = dist.get_backend()
    log(f"  world of one: mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
        f"{mesh.device_type}, backend {backend}")
    check(tuple(mesh.shape) == (1, 1) and mesh.device_type == device.type,
          "make_device_mesh: not a 1 x 1 mesh on the device")
    check(device.type != "cuda" or backend == "nccl", "make_device_mesh: not NCCL on the card")
    text = open(os.path.join(arm_dir, "arm.urdf")).read()
    q, pts = headline_inputs(device, n_configs, query_res)

    def arm(link_sdf_cls=pt.MeshSDF):
        return pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                           path_prefix=arm_dir, link_sdf_cls=link_sdf_cls)

    arms = {"cached": arm(pt.cache_link_sdf_factory(
                resolution=resolution, padding=1.0, cache_path=os.path.join(tmp, "sdf_cache.npz"))),
            "exact": arm(),
            "narrow_band": arm(pt.narrow_band_link_sdf_factory(
                cache_path=os.path.join(tmp, "narrow_band.npz")))}
    n_links = len(arms["exact"].sdf.sdfs) if device.type == "cuda" else 0
    expect = {"cached": (0, 0), "exact": (n_links, 0), "narrow_band": (0, n_links)}
    res = {"launches": {}, "ms": {}}

    def report(name, launches, ms, ms_ref, ref_name):
        res["launches"][name], res["ms"][name] = launches, (ms, ms_ref)
        log(f"  sharded {name} {q.shape[0]} x {pts.shape[0]} (1 x 1 mesh): {ms:.3f} ms, "
            f"unsharded {ref_name} {ms_ref:.3f} ms; kernel launches {launches} [{card}]")

    for name, robot in arms.items():
        fn = parallel.sharded_robot_query(robot, mesh)
        with torch.no_grad():
            (v, g), launches = counted(device, lambda: fn(q, pts))
            vr, gr = robot.query(q, pts)
        check(isinstance(v, DTensor) and tuple(v.shape) == tuple(vr.shape),
              f"sharded {name} query: not a DTensor of the query's shape")
        equal_gate(f"sharded {name} links", v.to_local(), g.to_local(), vr, gr,
                   "sharded", "unsharded query")
        check((launches["closest_point_sweep"], launches["narrow_band_query"]) == expect[name],
              f"sharded {name} query: launches {launches}, expected {expect[name]}")
        report(f"{name} links", launches, no_grad_ms(lambda: fn(q, pts), device, reps),
               no_grad_ms(lambda: robot.query(q, pts), device, reps), "RobotSDF.query")
        audit_gate(f"sharded {name} query", parallel.audit_sharded_callable(fn, q, pts))
        del v, g, vr, gr

    # the coherent grid: phase 8's tiles, padded for the mesh
    robot = arms["cached"]
    min_res = tsdf.coherent_min_cache_resolution(tuple(robot.sdf.sdfs))
    pts_t, take, seg = pt.get_coherent_tile_points(query_res, QUERY_RANGE,
                                                   cache_resolution=min_res, device=device)
    pts_t, orig = parallel.pad_for_mesh(pts_t, mesh, parallel.POINT_AXIS, segment=seg)
    take = torch.as_tensor(take, device=device)
    fn = parallel.sharded_robot_query_coherent(robot, mesh, seg=seg)
    with torch.no_grad():
        (v, g), launches = counted(device, lambda: fn(q, pts_t))
        vr, gr = robot.query_grid(q, QUERY_RANGE, query_res)
    check(launches["closest_point_sweep"] == 0 and (launches["coherent_union_tile"] > 0
                                                    or device.type != "cuda"),
          f"sharded coherent grid: launches {launches}, expected the union kernel and no K1")
    A = q.shape[0]
    equal_gate(f"sharded coherent grid ({seg}-point tiles)", v.to_local()[:, :orig][:, take],
               g.to_local()[:, :orig][:, take], vr.reshape(A, -1), gr.reshape(A, -1, 3),
               "sharded", "query_grid")
    vo = parallel.sharded_robot_query_coherent(robot, mesh, values_only=True, seg=seg)(q, pts_t)
    check(torch.equal(vo.to_local(), v.to_local()), "sharded coherent values_only differs")
    report("coherent grid", launches, no_grad_ms(lambda: fn(q, pts_t), device, reps),
           no_grad_ms(lambda: robot.query_grid(q, QUERY_RANGE, query_res), device, reps),
           "query_grid")
    audit_gate("sharded coherent query", parallel.audit_sharded_callable(fn, q, pts_t))
    del v, g, vr, gr, vo

    # phase 11's distilled model
    fn = parallel.sharded_neural_robot_query(model, mesh)
    (v, g), launches = counted(device, lambda: fn(q, pts))
    vr, gr = model.query(q, pts)
    equal_gate("sharded neural model", v.to_local().detach(), g.to_local().detach(),
               vr.detach(), gr.detach(), "sharded", "unsharded query")
    del v, g, vr, gr
    report("neural model", launches, time_ms(lambda: fn(q, pts), device, reps=reps),
           time_ms(lambda: model.query(q, pts), device, reps=reps), "model.query")
    audit_gate("sharded neural query", parallel.audit_sharded_callable(fn, q, pts))

    # phase 5's torus, its points over every rank
    torus = pt.MeshSDF(pt.MeshObjectFactory(os.path.join(tmp, "torus.obj"), device=device))
    tp = torus_points(device, torus.obj_factory, n_torus)
    fn = parallel.sharded_sdf_query(torus, mesh)
    with torch.no_grad():
        (v, g), launches = counted(device, lambda: fn(tp))
        vr, gr = torus(tp)
    equal_gate(f"sharded torus SDF ({n_torus} points)", v.to_local()[None], g.to_local()[None],
               vr[None], gr[None], "sharded", "unsharded query")
    check(launches["closest_point_sweep"] == (1 if device.type == "cuda" else 0),
          f"sharded torus SDF: launches {launches}")
    report(f"torus SDF ({torus.obj_factory.scene.num_faces} faces, {n_torus} points)",
           launches, no_grad_ms(lambda: fn(tp), device, reps),
           no_grad_ms(lambda: torus(tp), device, reps), "MeshSDF")
    audit_gate("sharded SDF query", parallel.audit_sharded_callable(fn, tp))

    # the collision step on the exact arm
    robot = arms["exact"]
    (step, st, qs, ref, sr, qr, calls), launches = counted(
        device, lambda: collision_steps(robot, q, pts, mesh))
    check(launches["closest_point_sweep"] == calls * n_links,
          f"collision steps: K1 launches {launches}, expected {calls * n_links} ({calls} steps)")
    res["step_launches"] = launches["closest_point_sweep"] // calls
    report("collision step", {"closest_point_sweep": res["step_launches"]},
           time_ms(lambda: step(qs, st, pts), device, reps=reps),
           time_ms(lambda: ref(qr, sr, pts), device, reps=reps), "step (mesh=None)")
    audit_gate("collision step", parallel.audit_sharded_callable(step, qs, st, pts), step=True)
    del arms, robot, step, ref
    dist.destroy_process_group()

    # a world of two ranks on this card
    port = free_port()
    jobs = {"arm_dir": arm_dir, "tmp": tmp, "device": str(device), "n_configs": n_configs,
            "query_res": query_res, "reps": reps, "n_torus": n_torus}
    jobs_path = os.path.join(tmp, "parallel_jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    t0 = time.perf_counter()
    procs, logs = [], []
    for r in range(2):
        out = open(os.path.join(tmp, f"parallel_rank{r}.log"), "w+")
        logs.append(out)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       "--parallel-rank", str(r), str(port), jobs_path],
                                      stdout=out, stderr=subprocess.STDOUT, text=True))
    try:
        # a rank that fails leaves the other waiting in a collective: stop both
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            check(time.perf_counter() - t0 < rank_timeout,
                  f"the parallel ranks ran past {rank_timeout} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    ranks = []
    for r, (p, out) in enumerate(zip(procs, logs)):
        out.seek(0)
        lines = out.read().splitlines()
        out.close()
        check(p.returncode == 0, f"parallel rank {r} failed (exit {p.returncode}):\n"
              + "\n".join(lines[-60:]))
        for line in lines[:-1]:
            log(f"  [rank {r}] {line}")
        ranks.append(json.loads(lines[-1]))
    log(f"  world of two on one card (gloo): {time.perf_counter() - t0:.1f} s in all; both "
        f"ranks share the card, so their times are no scaling figure")
    for r in ranks:
        check(r["launches"]["triangle"] == (1 if device.type == "cuda" else 0),
              f"rank {r['rank']}: the triangle-sharded query did not launch K1 once")
    res["ranks"] = ranks
    return res


# ---------------------------------------------------------------------------
# phase 14: the north-star workload
# ---------------------------------------------------------------------------

# (robot, interpolation, variants, timed runs, warm-up runs): the arm row
# all three variants, the other rows one forward and one values_only
NORTHSTAR_ROWS = (("arm", "nearest", ("forward", "forward_backward", "values_only"), 3, 1),
                  ("arm", "trilinear", ("forward", "values_only"), 1, 0),
                  ("free_link", "nearest", ("forward", "values_only"), 1, 0),
                  ("free_link", "trilinear", ("forward", "values_only"), 1, 0))


def coherent_reference_gate(name, what, v, g, dq, vr, gr, dqr):
    """The coherent path's ``(v, g, dq)`` against a reference's on the same
    configurations and points: values equal, gradients equal where finite
    (else 1e-6 / 1e-5), d(v.sum()+g.sum())/dq within 2e-4 of each
    configuration's largest.  Returns whether the gradients were equal too."""
    finite = torch.isfinite(g).all(dim=-1)
    exact = exact_or_gate(f"{name}: {what} ({v.shape[0]} x {v.shape[1]}, "
                          f"{int((~finite).sum())} NaN gradients beyond the lane)",
                          v[finite], g[finite], vr.detach()[finite], gr.detach()[finite])
    check(torch.equal(v, vr.detach()), f"{name}: coherent values differ from the reference")
    scale = dqr.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    dq_sc = ((dq - dqr).abs() / (2e-4 * scale)).max().item()
    log(f"    {name}: d/dq max |d| {(dq - dqr).abs().max().item():.3g} of largest "
        f"{dqr.abs().max().item():.4g}: {dq_sc:.3g} of the gate (2e-4 of each configuration's "
        f"largest)")
    check(dq_sc <= 1.0, f"{name}: d/dq beyond 2e-4 of the reference's")
    return exact


def northstar_generic_gate(name, robot, ft, q2, pts, seg):
    """The first configurations ``q2`` at every point: the coherent values
    and gradients (the bench's chunk query) against ``compose_query`` on
    the same tables (:func:`coherent_reference_gate`), NaN gradients only
    in tiles beyond the residual lane's capacity, and ``values_only``
    equal to the values."""
    from functools import partial
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from pytorch_volumetric_tpu_torch.bench import northstar as ns
    children = tuple(robot.sdf.sdfs)
    B = q2.shape[0]
    v, g, dq = ns.chunk_grad(robot, ft, q2, pts, seg)
    qq = q2.detach().clone().requires_grad_(True)
    m, m_inv = robot._link_transforms(qq)
    vr, gr = tsdf.compose_query(tuple(partial(s.raw_query_with, s.raw_query_aux())
                                      for s in children), m, m_inv, B, pts)
    (dqr,) = torch.autograd.grad(vr.sum() + gr.sum(), qq)
    audit = ns.audit_chunk(robot, ft, q2, pts, seg)
    check(audit["nan_outside_overflow"] == 0,
          f"{name}: NaN gradients outside the tiles beyond the residual lane's capacity")
    exact = coherent_reference_gate(name, "coherent vs compose_query", v, g, dq, vr, gr, dqr)
    vo = ns.chunk_query(robot, ft, q2, pts, seg, values_only=True)
    check(torch.equal(vo, v), f"{name}: values_only differs from the values")
    return exact


def northstar_build_gate(name, robot, device):
    """K1 at a free link's own cache build: the cache's grid against the
    link's whole scene (the 16,384-face torus) with its exterior box, in
    one launch, held to the plain version by ``compare_kernel``'s rules
    (distance, closest point and face id exact, |winding| within 1e-4).
    Phase 2 holds K1 at the arm's build shape, the capsule's grid."""
    import pytorch_volumetric_tpu_torch as pt
    (cache,) = robot.sdf.sdfs
    scene = cache.gt_sdf.obj_factory.scene
    _, grid = pt.get_coordinates_and_points_in_grid(cache.resolution, cache.ranges,
                                                    device=device)
    t0 = time.perf_counter()
    compare_kernel("base", f"{name}: the cache-build grid", grid.contiguous(), scene.tri, device,
                   scene.exterior_box)
    log(f"    {name}: K1 against the plain version on the build grid in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_northstar(device, tmp, card, n_configs=N_CONFIGS, points_side=100, chunk=25,
                    rows=NORTHSTAR_ROWS, n_generic=2, build=None):
    """``bench/northstar.py`` at the JAX package's north-star shape: 200
    configurations x 10^6 points in (3, 3, 3) tiles, each row's robot from
    a fresh cache (K1 in its build).  ``build``: keyword arguments for
    ``northstar.build_robot`` (smaller robots to rehearse on the CPU)."""
    from pytorch_volumetric_tpu_torch.bench import northstar as ns
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
    out = {"rows": {}, "build_launches": {}, "query_launches": {}, "union_launches": {},
           "union_tri_launches": {}, "union_backward_launches": {}}
    exact = True
    for kind, interp, variants, row_reps, warmup in rows:
        name = ns.metric_name(kind, interp)
        # the main path: the build (K1) and the chunked queries (the union
        # kernel on the nearest rows: the arm's forward, and values only)
        COUNTERS["kernel.closest_point_sweep"] = 0
        COUNTERS["kernel.coherent_union_tile"] = 0
        COUNTERS["kernel.coherent_union_tile_tri"] = 0
        COUNTERS["kernel.tile_union_backward"] = 0
        fk_reset()
        row, (robot, ft, q, pts, seg) = ns.northstar(
            kind, interp, device, os.path.join(tmp, f"northstar_{kind}_{interp}"), n_configs,
            points_side, chunk, variants, row_reps, warmup, build, log)
        sync(device)
        fk_counts(device, f"northstar {name}")
        launches = COUNTERS["kernel.closest_point_sweep"]
        out["union_launches"][name] = COUNTERS["kernel.coherent_union_tile"]
        out["union_tri_launches"][name] = COUNTERS["kernel.coherent_union_tile_tri"]
        out["union_backward_launches"][name] = COUNTERS["kernel.tile_union_backward"]
        check(COUNTERS["kernel.coherent_union_tile"] > 0 or interp != "nearest"
              or device.type != "cuda",
              f"{name}: no coherent_union_tile launch")
        # the arm's trilinear links take the trilinear union (CU-T); the free
        # link's lone trilinear cache takes neither union
        check(COUNTERS["kernel.coherent_union_tile_tri"] > 0
              or (kind, interp) != ("arm", "trilinear") or device.type != "cuda",
              f"{name}: no coherent_union_tile_tri launch")
        # one backward launch a differentiated chunk on the card: the
        # forward_backward variant's warm-up and timed runs over every chunk
        # (more if an out-of-memory retry ran a larger chunk first)
        bwd_launches = COUNTERS["kernel.tile_union_backward"]
        bwd_want = 0
        if "forward_backward" in variants and device.type == "cuda":
            bwd_want = (warmup + row_reps) * math.ceil(n_configs / row["chunk"])
        check(bwd_launches == bwd_want or (row["chunk"] != chunk and bwd_launches > bwd_want),
              f"{name}: {bwd_launches} tile_union_backward launches, want {bwd_want}")
        if points_side == 100:
            check(seg == 27 and row["padded_points"] == 1_061_208 and row["points"] == 10 ** 6,
                  f"{name}: expected 1,061,208 padded points in 27-point tiles")
        r = row["residual"]
        log(f"    chunk {row['chunk']}; middle tiles per chunk {r['middle_tiles_per_chunk']} of "
            f"capacity {r['capacity_per_chunk']} ({r['tiles_per_chunk']} tiles a chunk; largest "
            f"share of the capacity {r['max_middle_share_of_capacity']:.4f}); NaN gradient "
            f"entries {row['nan_gradient_entries']}; K1 launches {launches} (build "
            f"{row['k1_launches_build']}); gates {row['gates']}")
        for g_name, ok in row["gates"].items():
            check(ok, f"{name}: gate {g_name} failed")
        check(launches == row["k1_launches_build"], f"{name}: K1 ran in a query")
        if kind == "free_link" and interp == "nearest":
            # the trilinear row's build sweeps the same grid and scene
            northstar_build_gate(name, robot, device)
        exact &= northstar_generic_gate(name, robot, ft, q[:n_generic], pts, seg)
        if kind == "arm" and interp == "nearest":
            # the union kernel against its plain version on the first chunk
            out["union"] = compare_union(f"{name}: union kernel, chunk of {row['chunk']}",
                                         *union_inputs(robot, ft, q[:row["chunk"]], pts, seg),
                                         timed=True)
            out["union"]["launches"] = out["union_launches"][name]
            out["union_backward"] = compare_union_backward(
                f"{name}: the union's backward, chunk of {row['chunk']}",
                *union_inputs(robot, ft, q[:row["chunk"]], pts, seg))
            out["union_backward"]["launches"] = out["union_backward_launches"][name]
            if device.type == "cuda":
                torch.cuda.empty_cache()
        if kind == "arm" and interp == "trilinear":
            # CU-T against its plain version on the first chunk, timed
            out["union_tri"] = compare_union(
                f"{name}: trilinear union kernel, chunk of {row['chunk']}",
                *union_inputs(robot, ft, q[:row["chunk"]], pts, seg), timed=True, tri=True)
            out["union_tri"]["launches"] = out["union_tri_launches"][name]
            if device.type == "cuda":
                torch.cuda.empty_cache()
        out["rows"][name] = row
        out["build_launches"][name] = row["k1_launches_build"]
        out["query_launches"][name] = launches - row["k1_launches_build"]
        del robot, ft
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for name, r in out["rows"].items():
        for variant, v in r["variants"].items():
            rate = v.get("queries_per_s", v.get("values_per_s"))
            log(f"  {name} {variant}: {v['ms']:.3f} ms (runs "
                f"{', '.join(f'{t:.3f}' for t in v['ms_runs'])}), {rate / 1e6:.2f} M/s, peak "
                f"{(v['peak_bytes'] or float('nan')) / 1e9:.2f} GB, chunk {r['chunk']} [{card}]")
    log(f"  bit-identical to compose_query everywhere gated: {exact}; coherent_union_tile "
        f"launches per row {out['union_launches']}; coherent_union_tile_tri launches per row "
        f"{out['union_tri_launches']}; tile_union_backward launches per row "
        f"{out['union_backward_launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 15: the benchmark harnesses (bench.py, roofline_arm.py, trilinear.py)
# ---------------------------------------------------------------------------

def finite_numbers(obj):
    """Every number in a JSON-like object is finite."""
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(finite_numbers(v) for v in obj)
    return not isinstance(obj, float) or np.isfinite(obj)


def harness_line(name, line, out_dir):
    """A harness's JSON line: printed, appended to ``out_dir/harnesses.jsonl``
    and gated (no ``*_error`` key, every number finite)."""
    text = json.dumps(line)
    log(f"  {name}: {text}")
    with open(os.path.join(out_dir, "harnesses.jsonl"), "a") as f:
        f.write(text + "\n")
    errors = [k for k in line.get("extra", {}) if k.endswith("_error")]
    check(not errors, f"{name}: the line holds {errors}")
    check(finite_numbers(line), f"{name}: a number in the line is not finite")


def harness_arm_gate(name, arm, inputs, n_check=2):
    """The first ``n_check`` configurations of a headline arm: the
    harness's coherent query against ``RobotSDF.query`` on the same tile
    points (:func:`coherent_reference_gate`)."""
    from pytorch_volumetric_tpu_torch.bench import northstar as ns
    q, pts, _, seg = inputs
    q2 = q[:n_check]
    v, g, dq = ns.chunk_grad(arm["robot"], arm["ft"], q2, pts, seg)
    vr, gr, dqr = query_objective_grad(arm["robot"], q2, pts)
    check(bool(torch.isfinite(v).all() and torch.isfinite(g).all() and torch.isfinite(dq).all()),
          f"{name}: non-finite output")
    return coherent_reference_gate(name, "coherent vs RobotSDF.query", v, g, dq, vr, gr, dqr)


def phase_harnesses(device, tmp, card, out_dir, n_configs=N_CONFIGS, roofline=None,
                    trilinear=None):
    """``bench/headline.py`` (with its tight section), ``bench/roofline_arm.py``
    and ``bench/trilinear.py`` at their full sizes: the headline and the
    roofline arm read phase 4's cache (``tmp/sdf_cache.npz``), the tight arm
    and the torus build their own (K1).  ``roofline`` and ``trilinear``:
    keyword arguments of their ``run`` (smaller sizes to rehearse on the
    CPU).  Returns each cache build's K1 launches and the union kernel's
    launches in each harness's own run, the count set to 0 just before the
    run and read just after (the gates' and comparisons' launches not
    counted)."""
    from pytorch_volumetric_tpu_torch.bench import headline as hl
    from pytorch_volumetric_tpu_torch.bench import roofline_arm as ra
    from pytorch_volumetric_tpu_torch.bench import trilinear as tl
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
    open(os.path.join(out_dir, "harnesses.jsonl"), "w").close()
    union = {}
    t0 = time.perf_counter()
    COUNTERS["kernel.coherent_union_tile"] = 0
    _, arms = hl.run(device, tmp, n_configs, ("tight",),
                     emit=lambda ln: harness_line("headline", ln, out_dir), log=log)
    sync(device)
    union["headline"] = COUNTERS["kernel.coherent_union_tile"]
    builds = {k: arms[k]["build_launches"] for k in ("headline", "tight")}
    log(f"  headline: {time.perf_counter() - t0:.1f} s")
    q, pts, _, seg = arms["inputs"]
    for name in ("headline", "tight"):
        harness_arm_gate(name, arms[name], arms["inputs"])
        # the union kernel against its plain version on the arm's own inputs
        compare_union(f"{name}: union kernel", *union_inputs(
            arms[name]["robot"], arms[name]["ft"], q, pts, seg))
    del arms

    t0 = time.perf_counter()
    launches0 = COUNTERS["kernel.closest_point_sweep"]
    COUNTERS["kernel.coherent_union_tile"] = 0
    line = ra.run(device, tmp, cache_path=os.path.join(tmp, "sdf_cache.npz"), log=log,
                  **(roofline or {}))
    sync(device)
    union["roofline"] = COUNTERS["kernel.coherent_union_tile"]
    builds["roofline"] = COUNTERS["kernel.closest_point_sweep"] - launches0
    check(line.pop("ok"), f"roofline: a gate failed: {line['extra']['gates']}")
    harness_line("roofline", line, out_dir)
    x = line["extra"]
    log(f"  roofline: chunk {x['chunk']} x {x['points']} padded points, {x['links']} links; "
        f"full {x['stage_ms']['full']:.3f} ms; {time.perf_counter() - t0:.1f} s [{card}]")
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    COUNTERS["kernel.coherent_union_tile"] = 0
    line, builds["trilinear"] = tl.run(device, os.path.join(tmp, "harness_trilinear"), log=log,
                                       **(trilinear or {}))
    sync(device)
    union["trilinear"] = COUNTERS["kernel.coherent_union_tile"]
    check(line.pop("ok"), f"trilinear: coherent rows differ from the generic rows: "
                          f"{line['extra']['coherent_gate']}")
    harness_line("trilinear", line, out_dir)
    log(f"  trilinear: {time.perf_counter() - t0:.1f} s [{card}]")
    return builds, union


# ---------------------------------------------------------------------------
# phase 16: the FK kernels (and their counters on the paths of phases 3-14)
# ---------------------------------------------------------------------------

FK_COUNTERS = ("kernel.fk_link_transforms", "kernel.fk_link_transforms_backward",
               "path.fk_fused", "path.fk_plain")
FP32_LATENCY_CYCLES = 4  # a dependent FP32 add or multiply on Hopper
# (forward, d/dq) FK launches on each path :func:`fk_counts` read, by name
FK_LAUNCHES = {}
SM_CLOCK_HZ = 1.98e9  # one H100 SXM's largest SM clock (NVIDIA's data sheet)


def fk_reset():
    """Set the FK kernels' launch counts and FK's path counts to 0."""
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
    for k in FK_COUNTERS:
        COUNTERS[k] = 0


def fk_counts(device, name, forward=None, backward=None):
    """The FK counters since :func:`fk_reset`: ``(forward launches, d/dq
    launches)``.  On the card every ``_link_transforms`` call must have
    taken the kernel (``path.fk_fused`` == forward launches, no
    ``path.fk_plain``), with ``forward`` / ``backward`` launches when
    given; on the CPU every call takes the plain walk and nothing launches.
    Also kept in ``FK_LAUNCHES[name]``."""
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
    sync(device)
    c = {k: COUNTERS[k] for k in FK_COUNTERS}
    fwd, bwd = c["kernel.fk_link_transforms"], c["kernel.fk_link_transforms_backward"]
    if device.type == "cuda":
        check(c["path.fk_plain"] == 0 and fwd == c["path.fk_fused"] > 0,
              f"{name}: FK did not take the kernel on every call ({c})")
        check(forward is None or fwd == forward, f"{name}: {fwd} FK launches, want {forward}")
        check(backward is None or bwd == backward,
              f"{name}: {bwd} FK d/dq launches, want {backward}")
    else:
        check(fwd == bwd == c["path.fk_fused"] == 0, f"{name}: FK launched on the CPU")
    FK_LAUNCHES[name] = (fwd, bwd)
    return fwd, bwd


def fk_chain_ops(desc):
    """``(forward, d/dq)``: the longest chain of dependent float32
    operations in the kernels' design for the robot ``desc`` describes
    (``csrc/fk.cu``, built with ``-fmad=false``): a 4x4 product is 4 deep
    (a multiply, then three adds), and only the world matrix's chain is
    counted (a joint's motion is computed beside it).  Forward: each frame
    with a joint applies its origin (4), an actuated one its motion (4
    more); a link then takes ``invert_tf`` (4), the product with its offset
    (4) and ``invert_tf`` again (4).  d/dq: the tangent takes the origin
    (4), the motion (a product and an add, 5); a link then takes
    ``invert_tf``'s tangent (5), the product (4), the tangent again (5) and
    the contraction with the cotangents (a multiply and 16 adds, then 2
    more adds into the sum)."""
    from pytorch_volumetric_tpu_torch.ops import fk as fk_ops
    fwd, bwd = [], []
    for parent, kind, _, flags in desc.frames.tolist():
        f0, b0 = (0, 0) if parent < 0 else (fwd[parent], bwd[parent])
        if not flags & fk_ops.NO_JOINT:
            actuated = kind != fk_ops.FIXED
            f0, b0 = f0 + 4 + 4 * actuated, b0 + 4 + 5 * actuated
        fwd.append(f0)
        bwd.append(b0)
    links = desc.link_frames.tolist()
    return (max(fwd[f] for f in links) + 12,
            max(bwd[f] for f in links) + 5 + 4 + 5 + 17 + 2)


def fk_bound(desc, A, M):
    """The kernels' bounds at ``A`` configurations of ``M`` joints:
    ``{"forward": {...}, "backward": {...}}``, each ``bound_ms`` the larger
    of the bytes a call must move at HBM rate (``q`` in and both
    ``[L*A, 4, 4]`` outputs out; d/dq: ``q`` and both cotangents in, ``dq``
    out) and its longest dependent chain (:func:`fk_chain_ops`) at
    ``FP32_LATENCY_CYCLES`` a step and ``SM_CLOCK_HZ``.  At the arm's shapes
    the chain is the larger: FK is latency bound, no roofline share."""
    L = desc.link_frames.shape[0]
    out_bytes = 2 * L * A * 64
    chain = fk_chain_ops(desc)
    res = {}
    for (name, nbytes), ops in zip((("forward", A * M * 4 + out_bytes),
                                    ("backward", 2 * A * M * 4 + out_bytes)), chain):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        chain_ms = ops * FP32_LATENCY_CYCLES / SM_CLOCK_HZ * 1e3
        res[name] = {"bound_ms": max(bytes_ms, chain_ms),
                     "bound_by": "latency" if chain_ms >= bytes_ms else "bytes",
                     "bound_bytes": nbytes, "bound_chain_ops": ops}
    return res


def host_us(fn, device, reps):
    """Host microseconds a call: ``reps`` calls enqueued, then one
    synchronise, over the calls."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e6


def phase_fk(device, arm_dir, card, configs=(25, 200), reps=100):
    """The FK kernels (``csrc/fk.cu`` behind ``pvt::fk_link_transforms``)
    on the headline arm against their plain version on the card
    (``ops.fk.link_transforms_plain`` and its autograd): at each batch in
    ``configs`` (the north-star chunk and the headline batch) both outputs
    within 2e-6 and d/dq from random cotangents on both within 2e-5 of its
    largest |d/dq| (at least 2e-5), one launch each way; then each
    kernel's times beside its plain version's and its bound
    (:func:`fk_bound`).  Returns ``{A: row}``."""
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.bench.headline import joint_configs
    from pytorch_volumetric_tpu_torch.ops import fk as fk_ops
    from pytorch_volumetric_tpu_torch.utils.profiling import device_time, kernel_time

    text = open(os.path.join(arm_dir, "arm.urdf")).read()
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=arm_dir)
    desc = robot._fk_desc
    L, M = len(robot.sdf_to_link_name), len(robot.joint_names)
    out = {}
    for A in configs:
        q = joint_configs(A, device)
        rng = np.random.default_rng(A)
        g_m, g_minv = (torch.as_tensor(g, device=device) for g in
                       rng.standard_normal((2, L * A, 4, 4)).astype(np.float32))

        def with_dq(fn):
            qq = q.detach().clone().requires_grad_(True)
            m, m_inv = fn(qq)
            (dq,) = torch.autograd.grad((m, m_inv), qq, (g_m, g_minv))
            return m.detach(), m_inv.detach(), dq

        fk_reset()
        m, m_inv, dq = with_dq(robot._link_transforms)
        launches = fk_counts(device, f"FK at A = {A}", 1, 1)
        pm, pm_inv, pdq = with_dq(lambda x: fk_ops.link_transforms_plain(x, *desc))
        err = max(float((m - pm).abs().max()), float((m_inv - pm_inv).abs().max()))
        scale = max(1.0, float(pdq.abs().max()))
        dq_err = float((dq - pdq).abs().max()) / scale
        log(f"  FK at A = {A} ({L} links, {M} joints): |m|, |m^-1| err {err:.3g} (gate 2e-6), "
            f"d/dq err {dq_err:.3g} of max(1, max |d/dq|) = {scale:.4g} (gate 2e-5); "
            f"launches forward, d/dq {launches}")
        check(err <= 2e-6, f"FK at A = {A}: transforms beyond 2e-6 of the plain walk")
        check(dq_err <= 2e-5, f"FK at A = {A}: d/dq beyond 2e-5 of the plain walk's largest")

        def fwd(x):
            return fk_ops.fk_link_transforms(x, desc)

        def bwd(x):
            return fk_ops.fk_link_transforms_backward_op(g_m, g_minv, x, *desc)

        def plain_fwd(x):
            return fk_ops.link_transforms_plain(x, *desc)

        def plain_fwd_bwd(x):
            x = x.detach().requires_grad_(True)
            return torch.autograd.grad(plain_fwd(x), x, (g_m, g_minv))

        bound = fk_bound(desc, A, M)
        row = {"configs": A, "links": L, "max_abs_err": err, "dq_err_of_max": dq_err}
        for name, kern, kname in (("forward", fwd, "fk_forward"), ("backward", bwd, "fk_backward")):
            r = {"ms": device_time(kern, q, reps=reps) * 1e3,
                 "host_us": host_us(lambda: kern(q), device, reps), "kernel_ms": None}
            if device.type == "cuda":
                _, _, by_name = kernel_time(kern, q, reps=reps, by_name=True)
                r["kernel_ms"] = sum(s for k, s in by_name.items() if kname in k) * 1e3
            row[name] = {**r, **bound[name]}
        plain_ms = device_time(plain_fwd, q, reps=10) * 1e3
        row["forward"]["plain_ms"] = plain_ms
        row["backward"]["plain_ms"] = device_time(plain_fwd_bwd, q, reps=10) * 1e3 - plain_ms
        row["forward"]["plain_host_us"] = host_us(lambda: plain_fwd(q), device, 10)
        if device.type == "cuda":
            row["forward"]["plain_kernels"] = kernel_time(plain_fwd, q, reps=5)[1]
            row["backward"]["plain_kernels"] = (kernel_time(plain_fwd_bwd, q, reps=5)[1]
                                                - row["forward"]["plain_kernels"])
        for name in ("forward", "backward"):
            r = row[name]
            log(f"  FK {name} at A = {A}: {r['ms']:.4f} ms a call (kernel {r['kernel_ms']} "
                f"device ms; host {r['host_us']:.1f} us), plain {r['plain_ms']:.4f} ms "
                f"({r.get('plain_kernels')} kernels), bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']}: {r['bound_chain_ops']} dependent ops, "
                f"{r['bound_bytes']} bytes) [{card}]")
        out[A] = row
    return out


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_rank(rank, port, jobs_path):
    """One rank of phase 13's world of two (gloo, both on one card): the
    exact arm's sharded query on 2 x 1 and 1 x 2 meshes (points through
    ``pad_for_mesh``), ``TriangleShardedMeshSDF`` over a 2-way triangle
    axis on phase 5's torus against ``MeshSDF`` and five collision steps on
    1 x 2 against the unsharded step, each block held to the unsharded
    result on this rank.  Prints its log, then one JSON line."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch import parallel

    with open(jobs_path) as f:
        jobs = json.load(f)
    device = torch.device(jobs["device"])
    if device.type == "cpu":  # a rehearsal: two ranks share the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    reps = jobs["reps"]
    check(parallel.init_distributed(f"localhost:{port}", 2, rank, device=device,
                                    backend="gloo") == (rank, 2), "init_distributed")
    text = open(os.path.join(jobs["arm_dir"], "arm.urdf")).read()
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, "link7", device=device),
                        path_prefix=jobs["arm_dir"])
    q, pts = headline_inputs(device, jobs["n_configs"], jobs["query_res"])
    A, P = q.shape[0], pts.shape[0]
    with torch.no_grad():
        vr, gr = robot.query(q, pts)
    rep = {"rank": rank, "launches": {}, "ms": {}, "audits": {}}
    for nc, npt in ((2, 1), (1, 2)):
        tag = f"{nc}x{npt}"
        mesh = parallel.make_device_mesh(nc, npt, device=device)
        padded, _ = parallel.pad_for_mesh(pts, mesh, parallel.POINT_AXIS)
        fn = parallel.sharded_robot_query(robot, mesh)
        with torch.no_grad():
            (v, g), launches = counted(device, lambda: fn(q, padded))
        v, g = v.to_local(), g.to_local()
        a0 = mesh.get_local_rank("config") * v.shape[0]
        p0 = mesh.get_local_rank("point") * v.shape[1]
        cols = min(P - p0, v.shape[1])
        equal_gate(f"rank {rank}, {tag} mesh, block [{a0}:{a0 + v.shape[0]}, {p0}:{p0 + cols}]",
                   v[:, :cols], g[:, :cols], vr[a0:a0 + v.shape[0], p0:p0 + cols],
                   gr[a0:a0 + v.shape[0], p0:p0 + cols], "sharded", "unsharded query")
        rep["launches"][f"query_{tag}"] = launches["closest_point_sweep"]
        rep["ms"][f"query_{tag}"] = no_grad_ms(lambda: fn(q, padded), device, reps)
        rep["audits"][f"query_{tag}"] = parallel.audit_sharded_callable(fn, q, padded)
        audit_gate(f"rank {rank}, {tag} query", rep["audits"][f"query_{tag}"])
        log(f"rank {rank}, {tag} mesh: block {tuple(v.shape)} of {A} x {padded.shape[0]}, "
            f"{rep['ms'][f'query_{tag}']:.3f} ms, K1 launches {launches['closest_point_sweep']}")
        del v, g
    rep["ms"]["query_unsharded"] = no_grad_ms(lambda: robot.query(q, pts), device, reps)
    log(f"rank {rank}, the unsharded query {A} x {P} in the same window: "
        f"{rep['ms']['query_unsharded']:.3f} ms")

    fac = pt.MeshObjectFactory(os.path.join(jobs["tmp"], "torus.obj"), device=device)
    ts = parallel.TriangleShardedMeshSDF(fac, init_device_mesh(device.type, (2,),
                                                               mesh_dim_names=("tri",)))
    tp = torus_points(device, fac, jobs["n_torus"])
    ref = pt.MeshSDF(fac)
    with torch.no_grad():
        (v, g), launches = counted(device, lambda: ts(tp))
        v0, g0 = ref(tp)
    agree = torch.sign(v) == torch.sign(v0)
    flips = int((~agree).sum())
    err_v = (v - v0)[agree].abs().max().item()
    err_g = (g - g0)[agree].abs().max().item()
    rep["launches"]["triangle"] = launches["closest_point_sweep"]
    rep["ms"]["triangle"] = no_grad_ms(lambda: ts(tp), device, reps)
    rep["ms"]["triangle_unsharded"] = no_grad_ms(lambda: ref(tp), device, reps)
    rep["sign_flips"], rep["triangle_errs"] = flips, (err_v, err_g)
    log(f"rank {rank}, triangle-sharded torus ({fac.scene.num_faces} faces, shard "
        f"{ts.shard_size} of {fac.scene.padded_faces} padded, {tp.shape[0]} points): sign flips "
        f"{flips}; where the sign agrees |val| err {err_v:.3g}, |grad| err {err_g:.3g}; "
        f"equal {torch.equal(v, v0) and torch.equal(g, g0)}; {rep['ms']['triangle']:.3f} ms "
        f"(MeshSDF {rep['ms']['triangle_unsharded']:.3f} ms); K1 launches "
        f"{launches['closest_point_sweep']}")
    check(flips == 0 and err_v <= 1e-6 and err_g <= 1e-5,
          "triangle-sharded torus: sign flips, or beyond 1e-6 / 1e-5 of MeshSDF")

    mesh = parallel.make_device_mesh(1, 2, device=device)
    even = pts[:P - P % 2]
    (step, st, qs, _, _, _, calls), launches = counted(
        device, lambda: collision_steps(robot, q, even, mesh, reorders=3))
    rep["launches"]["step"] = launches["closest_point_sweep"] // calls
    rep["ms"]["step"] = time_ms(lambda: step(qs, st, even), device, reps=reps)
    log(f"rank {rank}, collision step on 1 x 2 ({A} x {even.shape[0]}): "
        f"{rep['ms']['step']:.3f} ms, K1 launches per step {rep['launches']['step']}")
    rep["audits"]["step"] = parallel.audit_sharded_callable(step, qs, st, even)
    audit_gate(f"rank {rank}, collision step on 1 x 2", rep["audits"]["step"], step=True)
    dist.destroy_process_group()
    print(json.dumps(rep), flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one CUDA device")
    import pytorch_volumetric_tpu_torch  # noqa: F401  (fails outside a checkout)
    from pytorch_volumetric_tpu_torch import native
    from pytorch_volumetric_tpu_torch.ops import cuda_build
    from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
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
    # the host runtime (g++) builds beside the kernels (nvcc)
    native_build = threading.Thread(target=native.get_lib, daemon=True)
    native_build.start()
    built = cuda_build.build()
    native_build.join()
    native.get_lib()  # raises here if its build failed
    log(f"  built {sorted(built)} and {os.path.basename(native.library_path())} in "
        f"{time.perf_counter() - t0:.1f} s")
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
        cached_launches, *generic_ms = phase_cached_robot(device, arm_dir, tmp, card)
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
        log("== phase 8: the coherent grid path")
        coherent_launches, *coherent_ms, union8 = phase_coherent(device, arm_dir, tmp, card,
                                                                 generic_ms)
        check(coherent_launches > 0, "the coherent path's cache build launched no kernel")
        check(union8["launches"] > 0, "query_grid launched no coherent_union_tile")
        log("== phase 9: the sweep's launches")
        log(f"  closest_point_sweep launches: exact-link path {exact_launches}, cached-link "
            f"path {cached_launches}, chamfer exact/cached {chamfer_launches}, "
            f"MJCF arm {mjcf_launches}, coherent grid path {coherent_launches}")
        log("== phase 10: the narrow-band SDF")
        nb = phase_narrow_band(device, arm_dir, tmp, card)
        check(nb["bigmesh_launches"] > 0, "bigmesh launched no narrow-band kernel")
        check(nb["arm_launches"] > 0, "the narrow-band robot launched no narrow-band kernel")
        log("== phase 11: the neural SDF models")
        neural = phase_neural(device, arm_dir, tmp, tmp, card, generic_ms, coherent_ms)
        check(neural["torus_launches"] > 0, "fit_neural_sdf's exact oracle launched no kernel")
        log("== phase 12: serving, debug and examples")
        served = phase_serving(device, arm_dir, tmp, card, generic_ms, coherent_ms,
                               (nb["arm_fwd_ms"], nb["arm_fb_ms"]))
        log("== phase 13: parallel")
        t0 = time.perf_counter()
        par = phase_parallel(device, arm_dir, tmp, card, neural.pop("model"))
        log(f"  phase 13: {time.perf_counter() - t0:.1f} s")
        log("== phase 14: the north-star workload")
        t0 = time.perf_counter()
        north = phase_northstar(device, tmp, card)
        for name, n in north["build_launches"].items():
            check(n > 0, f"{name}: the cache build launched no kernel")
        log(f"  closest_point_sweep launches (phase 9's table, continued): north-star "
            f"path builds {north['build_launches']}, its queries {north['query_launches']}")
        log(f"  phase 14: {time.perf_counter() - t0:.1f} s")
        log("== phase 15: the benchmark harnesses")
        t0 = time.perf_counter()
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        # the main path: the three harnesses (K1 in the tight arm's and the
        # torus's cache builds, none in a query)
        COUNTERS["kernel.closest_point_sweep"] = 0
        builds, harness_union = phase_harnesses(device, tmp, card, out_dir)
        sync(device)
        harness_launches = COUNTERS["kernel.closest_point_sweep"]
        for name in ("headline", "roofline"):
            check(harness_union[name] > 0, f"{name}: the harness launched no coherent_union_tile")
        check(builds["tight"] > 0, "the tight arm's cache build launched no kernel")
        check(builds["trilinear"] > 0, "the torus's cache build launched no kernel")
        check(harness_launches == sum(builds.values()), "K1 ran in a harness's query")
        log(f"  closest_point_sweep launches (phase 9's table, continued): harness builds "
            f"{builds}, their queries {harness_launches - sum(builds.values())}; "
            f"coherent_union_tile launches {harness_union}")
        log(f"  phase 15: {time.perf_counter() - t0:.1f} s")
        log("== phase 16: the FK kernels")
        fk = phase_fk(device, arm_dir, card)
        log(f"  FK launches (forward, d/dq) on the paths driven: {FK_LAUNCHES}")

    log("== phase 17: kernels")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    grid = probe["grid"]

    def bounds(r):
        """A sweep's bound over the pairs it evaluated in this run (its
        counters), when it counts them, with the brute-force bound (every
        real pair) beside it."""
        if "bound_evaluated_ms" not in r:
            return {"bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
        return {"bound_ms": r["bound_evaluated_ms"], "bound_by": r["bound_evaluated_by"],
                "bound_counts": "pairs evaluated in this run",
                "brute_force_bound_ms": r["bound_ms"], "brute_force_bound_by": r["bound_by"]}

    def probe_row(name, source, replaces, wrapper, r, err):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": probe["launches"][wrapper], "max_abs_err": err,
                "ms": r["ms"], "plain_ms": r["plain_ms"], **bounds(r), "library_ms": None}

    csrc = "pytorch_volumetric_tpu_torch/csrc/"

    def narrow_band_row(nb):
        """The narrow-band kernel at bigmesh's shape with no demoted cell
        (max_k 1024), max_k 256 beside it; launches on the arm's query."""
        builds = nb["bigmesh"]["builds"]
        main_b = builds[max(builds, key=int)]
        keys = ("ms", "kernel_ms", "kernels_per_call", "plain_ms", "bound_ms", "bound_by")
        arm = nb["arm_launch"]
        return {"name": "narrow_band_query", "route": "cuda", "source": csrc + "narrow_band.cu",
                "replaces": "pytorch_volumetric_tpu/ops/narrow_band.py:254",
                "replaces_note": "XLA fusion (_query_impl), no Pallas kernel",
                "launches": nb["arm_launches"], "launches_bigmesh": nb["bigmesh_launches"],
                "launches_served_query": served["served_launches"]["narrow_band"][
                    "narrow_band_query"],
                "launches_sharded_query": par["launches"]["narrow_band links"][
                    "narrow_band_query"],
                "max_abs_err": nb["max_abs_err"], **{k: main_b[k] for k in keys},
                "library_ms": None, "shape": f"bigmesh, max_k {main_b['max_k']}, K "
                f"{main_b['K']}, {main_b['work']['in_band']} in-band points",
                **{f"max_k_{k}": {x: r[x] for x in keys + ("K",)}
                   for k, r in builds.items() if r is not main_b},
                "arm_launch": {k: arm[k] for k in ("ms", "kernel_ms", "kernels_per_call",
                                                   "plain_ms", "bound_ms", "launches",
                                                   "points", "in_band")}}

    def union_row():
        """The coherent union kernel at the north-star chunk (the arm's 8
        links x 25 configurations x 1,061,208 points, seg 27), launches on
        phase 14's arm row; phase 8's headline shape beside it."""
        u, h = north["union"], union8
        fwd, vo = u["times"]["forward"], u["times"]["values_only"]
        small = lambda r: {k: r[k] for k in ("ms", "kernel_ms", "plain_ms")}
        return {"name": "coherent_union_tile", "route": "cuda",
                "source": csrc + "coherent_union.cu",
                "replaces": "pytorch_volumetric_tpu/sdf.py:1005",
                "replaces_note": "XLA program (_coherent_union_lookup_tile; values only "
                                 "_coherent_union_values, :817), no Pallas kernel",
                "launches": u["launches"],
                "launches_northstar_rows": north["union_launches"],
                "launches_query_grid": union8["launches"],
                "launches_served_grid": served["served_launches"]["grid"][
                    "coherent_union_tile"],
                "launches_sharded_coherent": par["launches"]["coherent grid"][
                    "coherent_union_tile"],
                "launches_harnesses": harness_union,
                # compare_union fails on any bit that differs
                "max_abs_err": max(u["max_abs_err"], h["max_abs_err"]),
                **small(fwd), "bound_ms": u["bound_ms"], "bound_by": "bytes",
                "bound_bytes": u["bound_bytes"], "library_ms": None,
                "shape": "north-star chunk: 8 links x 25 x 1,061,208 points, seg 27",
                "values_only": {**small(vo), "bound_ms": u["values_bound_ms"]},
                "norm_order_mismatches": h["norm_order_mismatches"],
                "headline_200x15504": {**small(h["times"]["forward"]),
                                       "bound_ms": h["bound_ms"],
                                       "values_only": {**small(h["times"]["values_only"]),
                                                       "bound_ms": h["values_bound_ms"]}}}

    def union_tri_row():
        """The trilinear union kernel (CU-T) at the north-star chunk (the
        trilinear arm's 8 links x 25 configurations x 1,061,208 points, seg
        27), launches on phase 14's rows."""
        u = north["union_tri"]
        fwd, vo = u["times"]["forward"], u["times"]["values_only"]
        small = lambda r: {k: r[k] for k in ("ms", "kernel_ms", "plain_ms")}
        return {"name": "coherent_union_tile_tri", "route": "cuda",
                "source": csrc + "coherent_union_tri.cu",
                "replaces": "pytorch_volumetric_tpu/sdf.py:1263",
                "replaces_note": "XLA program (_coherent_union_lookup_tile_tri), no Pallas "
                                 "kernel",
                "launches": u["launches"],
                "launches_northstar_rows": north["union_tri_launches"],
                "max_abs_err": u["max_abs_err"],
                **small(fwd), "bound_ms": u["bound_ms"], "bound_by": "bytes",
                "bound_bytes": u["bound_bytes"], "ops_bound_ms": u["ops_bound_ms"],
                "ops": u["ops"], "library_ms": None,
                "shape": "north-star chunk: 8 trilinear links x 25 x 1,061,208 points, seg 27",
                "values_only": {**small(vo), "bound_ms": u["values_bound_ms"],
                                "ops_bound_ms": u["values_ops_bound_ms"]}}

    def union_backward_row():
        """The union's backward kernels at the north-star chunk (8 links x
        25 configurations x 1,061,208 points: the arm's first chunk's
        winners, cotangents of ones), launches on phase 14's arm row."""
        u = north["union_backward"]
        return {"name": "tile_union_backward", "route": "cuda",
                "source": csrc + "coherent_union.cu",
                "replaces": "pytorch_volumetric_tpu/sdf.py:1228",
                "replaces_note": "XLA program (bwd of _coherent_union_lookup_tile's "
                                 "custom VJP), no Pallas kernel",
                "launches": u["launches"],
                "launches_northstar_rows": north["union_backward_launches"],
                "max_rel_err": u["max_rel_err"],
                **{k: u[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms",
                                     "bound_bytes")},
                "bound_by": "bytes", "library_ms": None,
                "shape": "north-star chunk: 8 links x 25 x 1,061,208 points"}

    def fk_row():
        """The FK kernels at the headline batch (200 configurations of the
        arm, 8 links), the north-star chunk (25) beside it; launches on
        phase 4's query (forward and d/dq) and on the other paths driven."""
        keys = ("ms", "kernel_ms", "host_us", "plain_ms", "plain_kernels", "plain_host_us",
                "bound_ms", "bound_by", "bound_bytes", "bound_chain_ops")
        main_r, chunk_r = fk[200], fk[25]
        return {"name": "fk_link_transforms", "route": "cuda", "source": csrc + "fk.cu",
                "replaces": "pytorch_volumetric_tpu/kinematics.py:217",
                "replaces_note": "jnp chain walk (Chain.fk_matrices, then "
                                 "model_to_sdf.py RobotSDF._link_transforms), no Pallas kernel",
                "launches": FK_LAUNCHES["cached robot query"][0],
                "launches_backward": FK_LAUNCHES["cached robot query"][1],
                "launches_paths": FK_LAUNCHES,
                "max_abs_err": max(r["max_abs_err"] for r in fk.values()),
                "dq_err_of_max": max(r["dq_err_of_max"] for r in fk.values()),
                **{k: main_r["forward"].get(k) for k in keys}, "library_ms": None,
                "shape": "arm, 8 links x 200 configurations",
                "backward": {k: main_r["backward"].get(k) for k in keys},
                "configs_25": {d: {k: chunk_r[d].get(k) for k in keys}
                               for d in ("forward", "backward")}}

    log(json.dumps({"kernels": [
        {"name": "closest_point_sweep", "route": "cuda", "source": csrc + "closest_point.cu",
         "replaces": "pytorch_volumetric_tpu/ops/pallas/closest_point.py:62",
         "launches": cached_launches, "launches_coherent_path": coherent_launches,
         "launches_neural_fit": neural["torus_launches"],
         "launches_served_query": served["served_launches"]["exact"]["closest_point_sweep"],
         "launches_sharded_query": par["launches"]["exact links"]["closest_point_sweep"],
         "launches_triangle_sharded": [r["launches"]["triangle"] for r in par["ranks"]],
         "launches_collision_step": par["step_launches"],
         "launches_northstar_build": north["build_launches"],
         "launches_northstar_queries": north["query_launches"],
         "launches_harness_builds": builds,
         "launches_harness_queries": harness_launches - sum(builds.values()),
         "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], **bounds(k1), "library_ms": None},
        probe_row("closest_point_sweep_nowind", csrc + "closest_point.cu",
                  "benchmarks/pallas_mxu_ab.py:48", "mesh_closest_query_nowind_cuda",
                  grid["nowind"], probe["errs"]["nowind"]),
        probe_row("closest_point_sweep_mma", csrc + "closest_point_mma.cu",
                  "benchmarks/pallas_mxu_ab.py:48", "mesh_closest_query_mma_cuda",
                  grid["mxu"], probe["errs"]["mxu"]),
        probe_row("fma_probe", csrc + "fma_probe.cu", "benchmarks/pallas_mfu.py:65",
                  "fma_probe_cuda", probe["fma"], probe["fma"]["max_abs_err"]),
        narrow_band_row(nb),
        union_row(),
        union_tri_row(),
        union_backward_row(),
        fk_row(),
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve"]:
        serve_consumer(sys.argv[2])
    elif sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
