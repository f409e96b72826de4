"""Large-mesh benchmark of the narrow-band SDF on one GPU.

    python -m pytorch_volumetric_tpu_torch.bench.bigmesh [--max-k 256 1024]

The port's twin of the JAX package's ``benchmarks/bigmesh.py``, at its
shape: a subdivided icosphere (radius 0.5, 7 subdivisions: 327,680 faces),
262,144 points (half uniform in [-0.7, 0.7]^3, half at radius 0.5 +- twice
the band, from numpy's generator seeded 0), cells of 0.015, a band of 0.01
and a grid margin of 0.15.  For each ``max_k`` (256 as bigmesh runs; 1024
demotes no cell) it builds the tables (the native host runtime) and
reports:

- the build's seconds, ``K``, the candidate table's MB, the band cells and
  the cells demoted for having ``max_k`` candidates or more;
- the kernel's time (``csrc/narrow_band.cu``, the mean of 20
  calls timed with CUDA events; ``kernel_ms``: its device kernels' own
  time from a ``torch.profiler`` trace, ``kernels_per_call`` of them) and
  queries/s, beside its bound: the
  larger of the bytes this run must touch (points and outputs, the meta
  rows of the cells hit, the real candidate rows of the band cells hit,
  each in-band point's pseudonormal) over 3.35 TB/s and 60.2 FP32
  operations (``sweep_roofline.CLOSEST_OPS``) per (in-band point, real
  candidate) pair over 67 TFLOP/s (the rows that pad a cell's list up to
  ``K`` are left out of both);
- the plain PyTorch version's time on the card (its reference: it must
  give the same values, gradients and slots bit for bit, NaN at the same
  places);
- the exact sweep (K1, ``MeshSDF``) on the first and the last 65,536
  points, with its queries/s on the first, and the narrow band's largest
  error against it in the band and in the far field, each point classed by
  its cell's actual slot.  In the band the error must stay within 2e-5; in
  the far field within the first-order step's bound, the cell's diagonal.

Prints one JSON line; exits non-zero without a CUDA device or when a gate
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Tuple

import numpy as np
import torch

from pytorch_volumetric_tpu_torch import mesh as mesh_mod
from pytorch_volumetric_tpu_torch.mesh import PAD_COORD
# CLOSEST_OPS: FP32 operations per closest-point pair, the count behind the
# sweep kernel's evaluated-pairs bound
from pytorch_volumetric_tpu_torch.bench.sweep_roofline import (
    CLOSEST_OPS, PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, card_name)
from pytorch_volumetric_tpu_torch.ops import narrow_band as nb
from pytorch_volumetric_tpu_torch.ops.narrow_band_cuda import narrow_band_query_cuda
from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS, device_time, kernel_time

RADIUS, SUBDIV, POINTS = 0.5, 7, 262_144
CELL_RES, BAND, PADDING = 0.015, 0.01, 0.15
MAX_KS = (256, 1024)
EXACT_POINTS = 65_536
# gate: in-band values against the exact sweep (the JAX package's own
# tests/test_narrow_band.py gate); the kernel must equal its plain version
GATE_BAND = 2e-5


def bigmesh_points(n: int = POINTS, radius: float = RADIUS, band: float = BAND) -> np.ndarray:
    """bigmesh's points: the first half uniform in [-0.7, 0.7]^3, the second
    at random directions and radius ``radius`` +- ``2 * band``."""
    rng = np.random.default_rng(0)
    n_far = n // 2
    far = rng.uniform(-0.7, 0.7, (n_far, 3)).astype(np.float32)
    dirs = rng.normal(size=(n - n_far, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radii = radius + rng.uniform(-2 * band, 2 * band, (len(dirs), 1)).astype(np.float32)
    return np.concatenate([far, dirs * radii])


def work(smalls: nb.NarrowBandSmalls, big: nb.NarrowBandBig, points: torch.Tensor,
         slot: torch.Tensor) -> dict:
    """What a query of ``points`` must touch and compute, from its
    classification ``slot``: bytes (each input read once, each output
    written once) and FP32 operations.  Only a cell's real candidates
    count: the ``PAD_COORD`` rows that fill its list up to ``K`` are never
    the answer (``pairs_padded`` counts them too; ``warp_rounds`` counts the
    kernel's rounds of 32 rows per in-band point, up to the first that
    meets padding)."""
    in_grid, _, cidx = nb.cell_index(smalls, points)
    band = slot >= 0
    K = big.cand.shape[1]
    n_band = int(band.sum())
    real = real_counts(big)
    cells = int(torch.unique(cidx[in_grid]).numel())
    hit = torch.unique(slot[band]).to(torch.int64)
    slot_rows = int(real[hit].sum())
    per_point = real[slot[band].to(torch.int64)]
    pairs = int(per_point.sum())
    # the kernel's warp rounds: 32 rows each, up to the first that meets padding
    rounds = int((per_point // 32 + 1).clamp(max=-(-K // 32)).sum())
    n = points.shape[0]
    nbytes = (n * 12 + n * 16          # points in, value and gradient out
              + cells * 5 * 4          # meta rows of the cells hit
              + slot_rows * 10 * 4     # real candidate rows of the band cells hit
              + n_band * 3 * 4)        # each in-band point's pseudonormal
    ops = pairs * CLOSEST_OPS
    return {"points": n, "in_band": n_band, "far": int((slot == nb.FAR).sum()),
            "out_of_grid": int((slot == nb.OUT_OF_GRID).sum()), "cells_hit": cells,
            "band_cells_hit": int(hit.numel()), "candidate_rows_hit": slot_rows,
            "mean_candidates": pairs / max(n_band, 1), "pairs": pairs,
            "pairs_padded": n_band * K, "warp_rounds": rounds, "bytes": nbytes,
            "fp32_ops": ops}


def bound_ms(w: dict):
    """The least time the card could take for the work ``w``, and which of
    bytes and operations sets it."""
    t_bytes = w["bytes"] / PEAK_BYTES_PER_S
    t_ops = w["fp32_ops"] / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _same(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise equality that counts NaN in both as equal."""
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def _max_diff(a: torch.Tensor, b: torch.Tensor, same: torch.Tensor) -> float:
    """The largest |a - b| where they differ (inf where one is NaN)."""
    if not bool((~same).any()):
        return 0.0
    return torch.nan_to_num((a - b)[~same].abs(), nan=float("inf")).max().item()


def compare(smalls, big, points, eps: float = 1e-3) -> dict:
    """One kernel launch against the plain version on the same inputs.
    ``ok``: slots, values and gradients equal bit for bit, NaN at the same
    places (NaN in both counts as equal, NaN in one as a difference), and
    finite at every finite point unless the table holds non-finite rows;
    the first differing point and its cause are reported."""
    before = COUNTERS["kernel.narrow_band_query"]
    v, g, s = narrow_band_query_cuda(smalls, big, points, eps, with_slots=True)
    if points.device.type == "cuda":
        torch.cuda.synchronize(points.device)
        if COUNTERS["kernel.narrow_band_query"] != before + 1:
            raise RuntimeError("narrow_band_query_cuda did not launch")
    vr, gr, sr = nb._query_impl(smalls, big, points, eps)
    same_v, same_g = _same(v, vr), _same(g, gr)
    dv = ~same_v
    dg = ~same_g.all(dim=-1)
    out = {"points": points.shape[0], "slots_equal": bool(torch.equal(s, sr)),
           "equal": not bool(dv.any() or dg.any()),
           "value_err": _max_diff(v, vr, same_v), "grad_err": _max_diff(g, gr, same_g),
           "nan_values": int(torch.isnan(vr).sum())}
    out["max_abs_err"] = max(out["value_err"], out["grad_err"])
    fin = torch.isfinite(points).all(dim=-1)
    out["finite"] = bool(torch.isfinite(v[fin]).all() and torch.isfinite(g[fin]).all()
                         or not torch.isfinite(big.cand).all())
    if not out["equal"]:
        i = int(torch.nonzero(dv | dg)[0, 0])
        kind = {nb.FAR: "far field", nb.OUT_OF_GRID: "out of the grid"}.get(
            int(sr[i]), f"in band (slot {int(sr[i])})")
        near = abs(vr[i].item()) < eps
        out["first_difference"] = (
            f"point {i} {points[i].tolist()}, {kind}{', within eps of the surface' if near else ''}:"
            f" kernel {v[i].item()!r} {g[i].tolist()}, plain {vr[i].item()!r} {gr[i].tolist()}")
    out["ok"] = out["slots_equal"] and out["equal"] and out["finite"]
    return out


def link_launches(robot, q: torch.Tensor, points: torch.Tensor):
    """The inputs ``(smalls, big, points)`` of the kernel launches that
    ``robot.query(q, points)`` makes for its ``NarrowBandMeshSDF`` links
    (backend "auto"): each such link's tables and the query points in its
    frame under every configuration, as ``sdf.compose_query`` hands them to
    the link."""
    from pytorch_volumetric_tpu_torch import transforms as tfm
    from pytorch_volumetric_tpu_torch.sdf import NarrowBandMeshSDF

    q_flat, flat = q.reshape(-1, q.shape[-1]), points.reshape(-1, 3)
    links = robot.sdf.sdfs
    with torch.no_grad():
        m, _ = robot._link_transforms(q_flat)
        pts = tfm.transform_points(m, flat).reshape(len(links), -1, 3)
    return [(s.tables.smalls, s.tables.big, pts[i].contiguous()) for i, s in enumerate(links)
            if isinstance(s, NarrowBandMeshSDF) and s.backend == "auto"]


def launch_times(calls, reps: int = 10, plain_reps: int = 2) -> dict:
    """The kernel on the recorded launches ``(smalls, big, points)``, each
    held to its plain version (``compare``), then timed, as means per
    launch: ``ms`` (CUDA events around back-to-back runs of all the
    launches), ``kernel_ms`` (the device kernels' own time, one
    ``utils.profiling.kernel_time`` trace of them all), the plain version's
    ``plain_ms`` and ``bound_ms`` (``work`` on each launch's own points and
    slots)."""
    n = len(calls)
    out = {"launches": n, "kernel_ms": None, "plain_ms": 0.0, "bound_ms": 0.0,
           "equal": True, "points": 0, "in_band": 0}
    for smalls, big, p in calls:
        out["equal"] = out["equal"] and compare(smalls, big, p)["ok"]
        out["plain_ms"] += device_time(lambda x: nb._query_impl(smalls, big, x, 1e-3), p,
                                       reps=plain_reps) * 1e3 / n
        _, _, slot = narrow_band_query_cuda(smalls, big, p, with_slots=True)
        w = work(smalls, big, p, slot)
        out["bound_ms"] += bound_ms(w)[0] / n
        out["points"] += w["points"]
        out["in_band"] += w["in_band"]

    def run_all(_):
        for smalls, big, p in calls:
            narrow_band_query_cuda(smalls, big, p)

    probe = calls[0][2]
    out["ms"] = device_time(run_all, probe, reps=reps) * 1e3 / n
    if probe.device.type == "cuda":
        k_s, k_n = kernel_time(run_all, probe, reps=reps)
        out["kernel_ms"], out["kernels_per_call"] = k_s * 1e3 / n, k_n / n
    return out


def real_counts(big: nb.NarrowBandBig) -> torch.Tensor:
    """``[S]`` real candidates of each slot (its rows that are not
    ``PAD_COORD`` padding)."""
    return (big.cand[:, :, 0] != PAD_COORD).sum(dim=1)


def _band_cells(tb) -> Tuple[np.ndarray, np.ndarray]:
    """The band cells' flat indices and their slots."""
    slot = tb.meta[:, 4].cpu().numpy()
    cells = np.nonzero(slot >= 0)[0]
    return cells, slot[cells].astype(np.int64)


def _points_in_cells(tb, cells, n_per: int, rng) -> np.ndarray:
    """``n_per`` points inside each of ``cells`` (flat indices), kept off
    the cell faces."""
    ijk = np.stack(np.unravel_index(cells, tb.dims.numpy()), axis=-1)
    u = rng.uniform(0.05, 0.95, (len(cells), n_per, 3))
    lo, res = tb.lo.numpy().astype(np.float64), tb.res.numpy().astype(np.float64)
    return (lo + (ijk[:, None] + u) * res).reshape(-1, 3).astype(np.float32)


def nonfinite_points(tb, n: int, rng) -> np.ndarray:
    """``n`` points in the grid's box, a third of them with NaN, +inf or
    -inf in one coordinate and a few with two, plus for each axis NaN
    points whose other keys name a band cell on the grid's first layer
    (NaN keys are 0), where one is: those run the cascade on NaN
    distances."""
    lo, res, dims = tb.lo.numpy(), tb.res.numpy(), tb.dims.numpy()
    p = rng.uniform(lo, lo + res * dims, (n, 3)).astype(np.float32)
    bad = rng.random(n) < 1 / 3
    p[bad, rng.integers(0, 3, int(bad.sum()))] = rng.choice(
        np.array([np.nan, np.inf, -np.inf], np.float32), int(bad.sum()))
    two = np.nonzero(bad)[0][::7]
    p[two, (rng.integers(0, 3, len(two)) + 1) % 3] = np.nan
    cells, _ = _band_cells(tb)
    ijk = np.stack(np.unravel_index(cells, dims), axis=-1)
    extra = []
    for d in range(3):
        first = cells[ijk[:, d] == 0]
        if len(first):
            q = _points_in_cells(tb, first[:8], 4, rng)
            q[:, d] = np.nan
            extra.append(q)
    return np.concatenate([p] + extra)


def kernel_cases(device):
    """``(name, smalls, big, points)``: the inputs the kernel is held to its
    plain version on.  The 2,304-face torus of the JAX package's tests with
    uniform, near-band, on-surface, out-of-grid and cell-face points (3 ulp
    from a face in every coordinate) and ragged counts; dense cells (many
    points in a few band cells); cells of 31, 32 and 33 real candidates
    (one round of the warp, and one row either side of it) where the
    builds have them; NaN and +-inf coordinates, also on a torus built
    with no margin, whose first cell layer is in the band; NaN rows in some
    cells' lists (NaN distances: the first NaN wins, as in argmin); an
    icosphere built with ``max_k=8`` (demoted cells); an inverted
    icosphere; and a mesh of every face twice (exact distance ties)."""
    rng = np.random.default_rng(0)
    torus = mesh_mod.torus_mesh(0.3, 0.12, 48, 24)
    ico = mesh_mod.icosphere_mesh(0.2, 2)
    builds = {"torus": (torus, dict(cell_res=0.03, band=0.1, padding=0.2)),
              "torus, no margin": (torus, dict(cell_res=0.03, band=0.1, padding=0.0)),
              "icosphere, max_k=8": (ico, dict(cell_res=0.03, band=0.06, padding=0.1, max_k=8)),
              "inverted icosphere": (mesh_mod.TriangleMesh(ico.vertices, ico.faces[:, ::-1]),
                                     dict(cell_res=0.03, band=0.06, padding=0.1)),
              "duplicated faces": (ico.concatenate(ico),
                                   dict(cell_res=0.03, band=0.06, padding=0.1))}
    tables = {k: nb.build_narrow_band_tables(m, device=device, **kw)
              for k, (m, kw) in builds.items()}

    def pts(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    def cell_faces(t, n):
        lo, res, dims = t.lo.numpy(), t.res.numpy(), t.dims.numpy()
        k = rng.integers(0, dims + 1, (n, 3))
        p = (lo.astype(np.float64) + k * res.astype(np.float64)).astype(np.float32)
        return p + rng.integers(-3, 4, (n, 3)).astype(np.float32) * np.spacing(p)

    t = tables["torus"]
    surf = torus.sample_points_uniformly(5000, seed=1)
    cases = [("torus, uniform", t, pts(rng.uniform(-0.55, 0.55, (20000, 3)))),
             ("torus, near the surface", t, pts(surf + rng.normal(0, 0.03, surf.shape))),
             ("torus, on the surface", t, pts(surf)),
             ("torus, cell faces", t, pts(cell_faces(t, 50000))),
             ("torus, out of the grid", t, pts(rng.uniform(-3, 3, (5000, 3))))]
    cases += [(f"torus, ragged P={n}", t, pts(rng.uniform(-0.5, 0.5, (n, 3))))
              for n in (1, 7, 31, 33, 129, 5000)]
    cells, slots = _band_cells(t)
    real = real_counts(t.big).cpu().numpy()
    dense = cells[np.argsort(-real[slots], kind="stable")[:4]]
    cases.append(("torus, dense cells (4 cells x 2,000 points)", t,
                  pts(_points_in_cells(t, dense, 2000, rng))))
    for n_real in (31, 32, 33):
        hit = cells[real[slots] == n_real][:16]
        if len(hit):
            cases.append((f"torus, cells of {n_real} real candidates", t,
                          pts(_points_in_cells(t, hit, 64, rng))))
    cases.append(("torus, NaN and inf coordinates", t, pts(nonfinite_points(t, 20000, rng))))
    t0 = tables["torus, no margin"]
    cases.append(("torus with no margin, NaN and inf coordinates", t0,
                  pts(nonfinite_points(t0, 20000, rng))))
    # NaN corners in rows 5 and 40 of the first 64 slots' lists (where
    # real): the first NaN distance wins in lane 5 or in lane 8's second round
    cand = t.cand.clone()
    for k in (5, 40):
        rows = cand[:64, k]
        rows[(rows[:, 0] != PAD_COORD), :9] = float("nan")
    t_nan = nb.NarrowBandTables(*t[:5], cand, *t[6:])
    first = cells[slots < 64]
    cases.append(("torus, NaN rows", t_nan, pts(_points_in_cells(t, first, 16, rng))))
    for name in ("icosphere, max_k=8", "inverted icosphere", "duplicated faces"):
        cases.append((name, tables[name], pts(rng.uniform(-0.35, 0.35, (20000, 3)))))
    return [(name, tb.smalls, tb.big, p.contiguous()) for name, tb, p in cases]


def run(device, max_ks=MAX_KS, points: int = POINTS, reps: int = 20, plain_reps: int = 3,
        subdiv: int = SUBDIV, exact_points: int = EXACT_POINTS, log=print) -> dict:
    """The benchmark on ``device`` for each ``max_k``; ``ok``: every gate
    held."""
    import pytorch_volumetric_tpu_torch as pt

    t0 = time.perf_counter()
    m = mesh_mod.icosphere_mesh(radius=RADIUS, subdivisions=subdiv)
    with tempfile.TemporaryDirectory(prefix="pvt_bigmesh_") as tmp:
        # written and read back, as bigmesh does (9 significant digits)
        path = os.path.join(tmp, "sphere.obj")
        mesh_mod.save_obj(m, path)
        fac = pt.MeshObjectFactory(path, device=device)
    log(f"icosphere: {len(fac._mesh.faces)} faces, written and read back in "
        f"{time.perf_counter() - t0:.1f} s")
    pts = torch.as_tensor(bigmesh_points(points), device=device)
    n_exact = min(exact_points, points)
    probes = {"first": pts[:n_exact].contiguous(), "last": pts[-n_exact:].contiguous()}

    exact = pt.MeshSDF(fac)
    with torch.no_grad():
        ref = {k: exact.raw_query(p)[0] for k, p in probes.items()}
    exact_ms = device_time(lambda p: exact.raw_query(p), probes["first"], reps=2) * 1e3
    out = {"faces": len(fac._mesh.faces), "points": points, "exact_points": n_exact,
           "exact_ms": exact_ms, "exact_qps": n_exact / exact_ms * 1e3, "builds": {}}
    log(f"exact sweep (K1) on the first {n_exact} points: {exact_ms:.3f} ms = "
        f"{out['exact_qps'] / 1e6:.4f} M queries/s")

    ok = True
    for max_k in max_ks:
        t0 = time.perf_counter()
        sdf = pt.NarrowBandMeshSDF(fac, cell_res=CELL_RES, band=BAND, padding=PADDING,
                                   max_k=max_k)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        build_s = time.perf_counter() - t0
        tb = sdf.tables
        smalls, big = tb.smalls, tb.big
        meta = big.meta
        demoted = int(((meta[:, 0].abs() <= BAND) & (meta[:, 4] < 0)).sum())
        K, S = big.cand.shape[1], big.cand.shape[0]
        r = {"max_k": max_k, "build_s": build_s, "K": K, "cells": meta.shape[0],
             "band_cells": S, "demoted_cells": demoted,
             "cand_mb": big.cand.numel() * 4 / 1e6}

        cmp = compare(smalls, big, pts)
        _, _, slot = narrow_band_query_cuda(smalls, big, pts, with_slots=True)
        w = work(smalls, big, pts, slot)
        r["bound_ms"], r["bound_by"] = bound_ms(w)
        r["ms"] = device_time(lambda p: narrow_band_query_cuda(smalls, big, p), pts,
                              reps=reps) * 1e3
        if device.type == "cuda":
            k_s, r["kernels_per_call"] = kernel_time(
                lambda p: narrow_band_query_cuda(smalls, big, p), pts, reps=reps)
            r["kernel_ms"] = k_s * 1e3
        r["plain_ms"] = device_time(lambda p: nb._query_impl(smalls, big, p, 1e-3), pts,
                                    reps=plain_reps) * 1e3
        r["qps"] = points / r["ms"] * 1e3
        r.update(work=w, kernel_vs_plain=cmp)

        # against the exact sweep, each point classed by its cell's slot
        errs = {"band": 0.0, "far": 0.0, "band_points": 0, "far_points": 0}
        far_bound = float(torch.linalg.vector_norm(smalls.res))
        for key, p in probes.items():
            v, _, s = narrow_band_query_cuda(smalls, big, p, with_slots=True)
            e = (v - ref[key]).abs()
            for name, mask in (("band", s >= 0), ("far", s == nb.FAR)):
                if bool(mask.any()):
                    errs[name] = max(errs[name], e[mask].max().item())
                    errs[f"{name}_points"] += int(mask.sum())
        r["vs_exact"] = dict(errs, far_bound=far_bound)
        r["ok"] = (cmp["ok"] and errs["band"] <= GATE_BAND and errs["far"] <= far_bound
                   and errs["band_points"] > 0)
        ok = ok and r["ok"]
        out["builds"][str(max_k)] = r
        log(f"max_k={max_k}: build {build_s:.2f} s, K={K}, {S} band cells ({demoted} "
            f"demoted), {r['cand_mb']:.1f} MB candidates; kernel {r['ms']:.4f} ms = "
            f"{r['qps'] / 1e6:.2f} M queries/s (bound {r['bound_ms']:.4f} ms, {r['bound_by']}; "
            f"{w['in_band']} in-band points x {w['mean_candidates']:.1f} real candidates = "
            f"{w['pairs']} pairs ({w['pairs_padded']} with the padding rows), "
            f"{w['bytes'] / 1e6:.1f} MB); "
            f"plain {r['plain_ms']:.3f} ms; kernel vs plain: equal {cmp['equal']}, slots equal "
            f"{cmp['slots_equal']}, max |d| {cmp['max_abs_err']:.3g}"
            + (f" ({cmp['first_difference']})" if "first_difference" in cmp else "")
            + f"; vs exact: band {errs['band']:.3g} ({errs['band_points']} points), far "
            f"{errs['far']:.3g} ({errs['far_points']} points, bound {far_bound:.4f})")
        del sdf, tb, smalls, big, meta
    out["ok"] = ok
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-k", type=int, nargs="+", default=list(MAX_KS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bigmesh: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    out = run(device, tuple(args.max_k), log=lambda s: print(s, file=sys.stderr, flush=True))
    out["device"] = {"name": torch.cuda.get_device_name(0), "card": card_name()}
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
