"""Roofline probe of the closest-point sweep on one GPU.

    python -m pytorch_volumetric_tpu_torch.bench.sweep_roofline [--points N]

The counterpart of the JAX package's ``benchmarks/pallas_mfu.py`` and
``benchmarks/pallas_mxu_ab.py``.  It answers what bounds the sweep kernel
(``csrc/closest_point.cu``, "base"):

1. the card's measured FP32 ceiling, from the multiply-add probe
   (``csrc/fma_probe.cu``, 2 operations per multiply-add);
2. the winding sum's share of the sweep, from the same kernel without it
   ("nowind");
3. whether the tensor cores can take the pairwise products at float32
   accuracy, and whether that is faster at the pairs K1 evaluates ("mxu",
   ``csrc/closest_point_mma.cu``, 3xTF32, with K1's work-skipping);
4. what the main path's ``-fmad=false`` build costs ("base_fmad": the same
   source with multiply-add contraction on; its errors are reported, not
   gated).

What each of the sweep kernel's levers buys is measured by
``scripts/sweep_variants_torch.py``.

Each sweep runs on a procedural torus of 16,384 faces with 2^17 points
uniform in [-0.2, 0.2]^3, and at the main path's shape, the capsule link's
cache-build grid (1,267,875 points x 384 padded faces); the sweep kernel
and the tensor-core sweep get the scene's exterior box, as ``MeshSDF``
passes it.  Each kernel's first launch is checked against its plain
version on an evenly strided subset of 4,096 points; then its time is the
mean of ``--reps`` launches timed with CUDA events.  Shares of the FP32
peak use the JAX package's model of 110 FP32 operations per (point, real
triangle) pair; the pair counters of K1, nowind and mxu give the pairs each
evaluated and a second bound over those alone.

Prints one JSON line; exits non-zero without a CUDA device, when a gated
kernel disagrees with its plain version, or when the FP32 ceiling comes
out above the data sheet's peak.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from functools import partial

import numpy as np
import torch

from pytorch_volumetric_tpu_torch import mesh as mesh_mod
from pytorch_volumetric_tpu_torch.ops import point_triangle as tpt
from pytorch_volumetric_tpu_torch.ops.closest_point import (
    mesh_closest_query_contracted_cuda, mesh_closest_query_cuda,
    mesh_closest_query_mma_cuda, mesh_closest_query_nowind_cuda)
from pytorch_volumetric_tpu_torch.ops.fma_probe import fma_probe, fma_probe_cuda, flops
from pytorch_volumetric_tpu_torch.utils.profiling import device_time
from pytorch_volumetric_tpu_torch.voxel import (
    get_coordinates_and_points_in_grid, get_divisible_range_by_resolution)

# H100 SXM data-sheet peaks (dense, 700 W): FP32 outside the tensor cores,
# TF32 on the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per (point, real triangle) pair, the JAX package's model
FLOPS_PER_PAIR = 110
# (FP32, TF32 tensor-core) operations per pair that each sweep does, for its
# bound.  base: the 110-operation model.  nowind: the model scaled by the
# closest-point part's share of csrc/closest_point.cu's own count of FP32
# additions, multiplications, divisions and square roots per pair (81 of
# 148; the winding is the other 67).  mxu (csrc/closest_point_mma.cu), on
# the same scale: the closest point less the 39 operations of d1..d6, which
# its products take over, plus the 4 subtractions of d3..d6 (46); the
# solid angle from the products' squared distances and numerator: 3 square
# roots, 17 additions and multiplications of the denominator, the atan2 and
# the sum (23, where the direct form takes 67); and the products as issued,
# 2 x 16 multiply-adds per column (3xTF32 in K = 16): 2 columns for the
# closest point, 4 for the solid angle.
CLOSEST_OPS = FLOPS_PER_PAIR * 81 / 148
WINDING_OPS = FLOPS_PER_PAIR * 67 / 148
MXU_CLOSEST_OPS = (FLOPS_PER_PAIR * 46 / 148, 2 * 32)
MXU_WINDING_OPS = (FLOPS_PER_PAIR * 23 / 148, 4 * 32)
SWEEP_OPS = {"base": (FLOPS_PER_PAIR, 0), "base_fmad": (FLOPS_PER_PAIR, 0),
             "nowind": (CLOSEST_OPS, 0),
             "mxu": (MXU_CLOSEST_OPS[0] + MXU_WINDING_OPS[0],
                     MXU_CLOSEST_OPS[1] + MXU_WINDING_OPS[1])}
# (FP32, TF32) operations per pair whose closest point, and per pair whose
# solid angle, a kernel evaluated, for the bound over the pairs its counters
# report (they skip padding, culled clusters' closest points and the solid
# angles outside a closed mesh's box).  The mxu kernel's solid angles near a
# group come from the direct forms, which cost more: the bound counts them
# at the products' price, so it stays a lower bound.
EVALUATED_OPS = {"base": ((CLOSEST_OPS, 0), (WINDING_OPS, 0)),
                 "nowind": ((CLOSEST_OPS, 0), (WINDING_OPS, 0)),
                 "mxu": (MXU_CLOSEST_OPS, MXU_WINDING_OPS)}

# name -> (kernel wrapper, plain version, gated against the plain version)
SWEEPS = {
    "base": (mesh_closest_query_cuda, tpt.mesh_closest_query, True),
    "nowind": (mesh_closest_query_nowind_cuda,
               partial(tpt.mesh_closest_query, winding=False), True),
    "mxu": (mesh_closest_query_mma_cuda, tpt.mesh_closest_query_expanded, True),
    "base_fmad": (mesh_closest_query_contracted_cuda, tpt.mesh_closest_query, False),
}
# the sweeps that take the scene's exterior box, as the main path passes it
TAKES_BOX = ("base", "base_fmad", "mxu")
# gates against the plain version: distance and closest point (float32
# rounding of one arithmetic, amplified by the expanded forms up to ~1e-6 at
# 1 m), |winding| (summation order, and the expanded solid angle for mxu)
GATE_DIST = 1e-5
GATE_WIND = 1e-3
GATE_FMA_RTOL = 1e-5
# a measured FP32 ceiling above the data-sheet peak by more than this
# factor means the probe did less work than it counts
GATE_FMA_PEAK = 1.05
# the winding is compared only at points farther than this from the
# surface: a point on a face sees it at a solid angle of +-2 pi or 0, and
# which one is decided by rounding (the sign there comes from |winding| >
# 0.5 of a value near 0.5, for a distance near 0)
WIND_MIN_DIST = 1e-4


def torus_inputs(device, points: int = 1 << 17):
    """The probe's mesh and points: ``torus_mesh(0.1, 0.03, 128, 64)``
    (16,384 faces) and ``points`` uniform in [-0.2, 0.2]^3 (seed 0)."""
    scene = mesh_mod.MeshScene.from_mesh(mesh_mod.torus_mesh(0.1, 0.03, 128, 64),
                                         device=device)
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-0.2, 0.2, (points, 3)).astype(np.float32),
                          device=device)
    return pts, scene


def capsule_cache_grid(device, resolution: float = 0.02, padding: float = 1.0):
    """The main path's sweep: the headline arm's capsule link and its
    cache-build grid (``cache_link_sdf_factory(0.02, 1.0)``)."""
    cap_mesh = mesh_mod.capsule_mesh(radius=0.045, height=0.18, segments=14, rings=5)
    scene = mesh_mod.MeshScene.from_mesh(cap_mesh, device=device)
    bb = cap_mesh.aabb()
    grid_range = get_divisible_range_by_resolution(
        resolution, np.stack([bb[:, 0] - padding, bb[:, 1] + padding], axis=1))
    _, grid = get_coordinates_and_points_in_grid(resolution, grid_range, device=device)
    return grid, scene


def sweep_bound_ms(n_points: int, n_faces: int, fp32_ops: float = FLOPS_PER_PAIR,
                   tf32_ops: float = 0):
    """Least time for a sweep of ``n_points`` over ``n_faces`` real
    triangles: the larger of its operations per pair over the peaks of
    their type (FP32 lanes, TF32 tensor cores) and its bytes (points and
    triangles read once, 24 B of outputs per point) over the memory rate.
    Returns ``(ms, "operations" | "bytes")``."""
    pairs = n_points * n_faces
    ops_s = max(pairs * fp32_ops / PEAK_FP32_FLOPS, pairs * tf32_ops / PEAK_TF32_FLOPS)
    bytes_s = (n_points * (12 + 24) + n_faces * 36) / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def evaluated_bound_ms(n_points: int, n_faces: int, closest_pairs: int,
                       winding_pairs: int, kind: str = "base"):
    """Least time for the pairs a sweep kernel evaluated: its
    ``EVALUATED_OPS`` per closest-point pair and per solid-angle pair over
    the peaks of their type, or its bytes over the memory rate (as
    :func:`sweep_bound_ms`).  Returns ``(ms, "operations" | "bytes")``."""
    (cf, ct), (wf, wt) = EVALUATED_OPS[kind]
    ops_s = max((closest_pairs * cf + winding_pairs * wf) / PEAK_FP32_FLOPS,
                (closest_pairs * ct + winding_pairs * wt) / PEAK_TF32_FLOPS)
    bytes_s = (n_points * (12 + 24) + n_faces * 36) / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def evaluated_pairs(wrapper, pts, tri, **kwargs) -> dict:
    """One launch of the sweep kernel (or its no-winding instantiation)
    with its pair counters: the (point, real triangle) pairs whose closest
    point, and whose solid angle, it evaluated.  Zeros on the CPU, where
    the plain version evaluates every pair and counts nothing."""
    counters = torch.zeros(2, dtype=torch.int64, device=pts.device)
    wrapper(pts, tri, counters=counters, **kwargs)
    closest, winding = (int(x) for x in counters.tolist())
    return {"closest_pairs": closest, "winding_pairs": winding}


def fma_bound_ms(n: int, iters: int):
    ops_s = flops(n, iters) / PEAK_FP32_FLOPS
    bytes_s = 12 * n / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def sweep_errors(out, ref, pts, tri) -> dict:
    """Errors of a kernel's ``out`` against its plain version's ``ref`` on
    ``pts``.  ``closest`` is measured against the plain closest point on the
    face the kernel chose, and ``face`` is how far that face misses the
    minimal distance: equidistant faces (shared edges, symmetric parts of a
    mesh) may be chosen either way, with different closest points.
    ``winding`` covers the points farther than ``WIND_MIN_DIST`` from the
    surface (``on_surface`` counts the others)."""
    d1, c1, f1, w1 = out
    d0, c0, _, w0 = ref
    chosen = tri.index_select(0, f1)
    d2c, cpc = tpt._closest_point_bary(pts[:, None, :], chosen[:, None, 0],
                                       (chosen[:, 1] - chosen[:, 0])[:, None],
                                       (chosen[:, 2] - chosen[:, 0])[:, None])
    off = d0 > WIND_MIN_DIST
    return {"dist": (d1 - d0).abs().max().item(),
            "closest": (c1 - cpc[:, 0]).abs().max().item(),
            "closest_raw": (c1 - c0).abs().max().item(),
            "face": (torch.sqrt(d2c[:, 0]) - d0).abs().max().item(),
            "winding": (w1 - w0)[off].abs().max().item() if bool(off.any()) else 0.0,
            "on_surface": int((~off).sum())}


def check_sweep(name: str, errors: dict) -> bool:
    """Whether a gated kernel meets its gates (nowind computes no winding)."""
    ok = max(errors["dist"], errors["closest"], errors["face"]) <= GATE_DIST
    if name != "nowind":
        ok = ok and errors["winding"] <= GATE_WIND
    return ok


def time_sweeps(pts, scene, names=tuple(SWEEPS), reps: int = 10,
                check_points: int = 4096, plain_reps: int = 0,
                fp32_ceiling: float = None) -> dict:
    """Check each named kernel's first launch against its plain version on
    a strided subset of ``check_points`` points, then time ``reps``
    launches.  With ``plain_reps`` the plain version is timed on all points
    too.  Shares are under the 110-operation model, of the data-sheet FP32
    peak and of ``fp32_ceiling`` (FLOP/s) when given."""
    tri = scene.tri
    P, F = pts.shape[0], scene.num_faces
    stride = max(1, P // check_points)
    sub = pts[::stride].contiguous()
    results, plain_ms = {}, {}
    for name in names:
        wrapper, plain, gated = SWEEPS[name]
        kw = {"exterior_box": scene.exterior_box} if name in TAKES_BOX else {}
        bound_ms, bound_by = sweep_bound_ms(P, F, *SWEEP_OPS[name])
        out = wrapper(pts, tri, **kw)
        errors = sweep_errors([x[::stride] for x in out], plain(sub, tri), sub, tri)
        ms = device_time(lambda p, t: wrapper(p, t, **kw), pts, tri, reps=reps, warmup=0) * 1e3
        model_flops = P * F * FLOPS_PER_PAIR / (ms / 1e3)
        r = {"ms": ms, "gpairs_s": P * F / ms / 1e6,
             "gpairs_padded_s": P * tri.shape[0] / ms / 1e6,
             "tflops_model": model_flops / 1e12,
             "share_of_datasheet_peak": model_flops / PEAK_FP32_FLOPS,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "errors": errors, "gated": gated,
             "ok": check_sweep(name, errors) if gated else None}
        if name in EVALUATED_OPS:
            r.update(evaluated_pairs(wrapper, pts, tri, **kw))
            r["evaluated_share"] = r["closest_pairs"] / (P * F)
            r["bound_evaluated_ms"], r["bound_evaluated_by"] = evaluated_bound_ms(
                P, F, r["closest_pairs"], r["winding_pairs"], name)
        if fp32_ceiling:
            r["share_of_measured_ceiling"] = model_flops / fp32_ceiling
        if plain_reps:
            if plain not in plain_ms:  # base_fmad shares base's plain version
                plain_ms[plain] = device_time(plain, pts, tri, reps=plain_reps,
                                              warmup=0) * 1e3
            r["plain_ms"] = plain_ms[plain]
        results[name] = r
    return results


def fma_errors(x, y, iters: int):
    """(max abs, max rel) error of the probe kernel against its plain
    version on one input."""
    out, ref = fma_probe_cuda(x, y, iters), fma_probe(x, y, iters)
    return (out - ref).abs().max().item(), ((out - ref).abs() / ref.abs()).max().item()


def measure_fma(device, iters: int = 4096, reps: int = 10, plain_reps: int = 1,
                n: int = None) -> dict:
    """The FP32 ceiling: the multiply-add probe over ``n`` elements, by
    default enough threads to fill every SM at full occupancy (2,048 each),
    checked against its plain version and timed.

    The check (rtol 1e-5: one rounding per step against two) runs the
    probe's inputs at 1, 2 and ``iters`` iterations: with ``a`` in
    [0.5, 0.9] every chain settles on ``b / (1 - a)`` within ~100 steps, so
    only the short runs see the recurrence.  The iteration count itself is
    checked at ``iters`` with ``a = 1``, where each chain adds ``b = 2^-10``
    once per step (exact in both versions) and a skipped iteration moves the
    sum by ~2e-4 of itself.  ``ok`` also needs the rate within
    ``GATE_FMA_PEAK`` of the data-sheet peak."""
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count * 2048
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0.5, 0.9, n).astype(np.float32), device=device)
    y = torch.as_tensor(rng.uniform(0.01, 0.1, n).astype(np.float32), device=device)
    errs = [fma_errors(x, y, k) for k in (1, 2, iters)]
    errs.append(fma_errors(torch.ones_like(x), torch.full_like(y, 2.0 ** -10), iters))
    ms = device_time(fma_probe_cuda, x, y, iters, reps=reps, warmup=0) * 1e3
    bound_ms, bound_by = fma_bound_ms(n, iters)
    tflops = flops(n, iters) / (ms / 1e3) / 1e12
    rel = max(e[1] for e in errs)
    r = {"n": n, "iters": iters, "ms": ms, "tflops": tflops,
         "max_abs_err": max(e[0] for e in errs), "max_rel_err": rel,
         "ok": rel <= GATE_FMA_RTOL and tflops <= GATE_FMA_PEAK * PEAK_FP32_FLOPS / 1e12,
         "bound_ms": bound_ms, "bound_by": bound_by}
    if plain_reps:
        r["plain_ms"] = device_time(fma_probe, x, y, iters, reps=plain_reps,
                                    warmup=0) * 1e3
    return r


def clock_summary(samples: str) -> dict:
    """Min / median / max SM clock (MHz) and peak power draw (W) from
    ``nvidia-smi --query-gpu=clocks.sm,power.draw --format=csv,noheader,nounits``
    lines."""
    sm, power = [], []
    for line in samples.splitlines():
        fields = [f.strip() for f in line.split(",")]
        try:
            sm.append(float(fields[0]))
            power.append(float(fields[1]))
        except (ValueError, IndexError):
            continue
    if not sm:
        return {"samples": 0}
    sm.sort()
    return {"samples": len(sm), "sm_mhz_min": sm[0], "sm_mhz_median": sm[len(sm) // 2],
            "sm_mhz_max": sm[-1], "power_w_max": max(power)}


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def run(device, points: int = 1 << 17, reps: int = 10, fma_iters: int = 4096) -> dict:
    """The whole probe on ``device``: the FP32 ceiling, then the four sweeps
    on the torus and at the capsule cache grid (with the plain versions'
    times there, one run each).  ``ok``: every gate held."""
    fma = measure_fma(device, fma_iters, reps)
    ceiling = fma["tflops"] * 1e12
    pts, scene = torus_inputs(device, points)
    torus = time_sweeps(pts, scene, reps=reps, fp32_ceiling=ceiling)
    grid, cap = capsule_cache_grid(device)
    capsule = time_sweeps(grid, cap, reps=reps, plain_reps=1, fp32_ceiling=ceiling)
    ok = fma["ok"] and all(r["ok"] for sweeps in (torus, capsule)
                           for r in sweeps.values() if r["gated"])
    return {"metric": "sweep_roofline", "ok": ok, "fma": fma,
            "torus": {"points": points, "faces": scene.num_faces, "sweeps": torus},
            "capsule_grid": {"points": grid.shape[0], "faces": cap.num_faces,
                             "padded_faces": cap.tri.shape[0], "sweeps": capsule},
            "flop_model_per_pair": FLOPS_PER_PAIR,
            "datasheet_fp32_tflops": PEAK_FP32_FLOPS / 1e12}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=1 << 17)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--fma-iters", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_roofline: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    # the card's clock and power, sampled every 100 ms while the probe runs
    sampler = subprocess.Popen(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits", "-lms", "100"],
                               stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        out = run(device, args.points, args.reps, args.fma_iters)
    finally:
        sampler.terminate()
        samples, _ = sampler.communicate(timeout=60)
    out["clocks"] = clock_summary(samples)
    out["device"] = {"name": torch.cuda.get_device_name(0), "card": card_name()}
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
