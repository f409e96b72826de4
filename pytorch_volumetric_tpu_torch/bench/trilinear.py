"""Trilinear against nearest ``CachedSDF`` lookups on one GPU.

    python -m pytorch_volumetric_tpu_torch.bench.trilinear [--points-side 100]
        [--reps 5] [--device cuda|cpu]

The port's twin of the JAX package's ``benchmarks/trilinear.py``, at its
drill shapes with the 16,384-face torus ``mesh.torus_mesh(0.1, 0.03, 128,
64)`` standing in for the YCB drill, whose mesh this repository does not
hold (one link's lookup cost depends on its grid, not on its faces): a
``nearest`` and a ``trilinear`` ``CachedSDF`` at ``CACHE_RES`` (0.01) over the
torus's ``bounding_box(padding=0.3)``, from one fresh cache file (K1 runs
in the first one's build; the second reads its grid).  Rows:

  nearest_generic / trilinear_generic   ``raw_query_with(raw_query_aux(), p)``
      on M points uniform in +-0.25 (``numpy.random.default_rng(0)``)
  nearest_coherent / trilinear_coherent ``compose_query_coherent`` of a
      one-child ``ComposedSDF`` with the identity transform over the
      ``side^3`` grid at half the cache resolution, centred on the origin,
      in coherent tiles (4-channel 4x4x4 and 5x5x5 bricks)

Each row sums every output (``v.sum() + g.sum()``) and gives its ms (the
median of 3 samples of ``--reps`` calls between CUDA events, after a
warm-up; ``headline.time_median``) and M q/s over the M real grid points.
Gate: on the grid points each coherent row's values equal its generic
row's (else within 1e-6, gradients 1e-5), and the tiles keep the coherent
contract.  Prints one JSON line: ``metric`` ``trilinear_vs_nearest``,
``value`` = the trilinear generic row's M q/s.  Exits non-zero without a
CUDA device (unless ``--device cpu``) or when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Callable, Dict

import numpy as np
import torch

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch import sdf as tsdf
from pytorch_volumetric_tpu_torch.bench import headline as hl
from pytorch_volumetric_tpu_torch.bench import northstar as ns
from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS

METRIC = "trilinear_vs_nearest"
CACHE_RES = 0.01
PADDING = 0.3
V_TOL, G_TOL = 1e-6, 1e-5
STAND_IN = ("16,384-face torus mesh.torus_mesh(0.1, 0.03, 128, 64) standing in for the YCB "
            "drill (not in this repository)")


def build_caches(directory: str, device, torus=ns.TORUS):
    """``(nearest, trilinear)`` ``CachedSDF`` of the torus over its
    ``bounding_box(padding=0.3)``, from one fresh cache file in
    ``directory``."""
    os.makedirs(directory, exist_ok=True)
    obj = os.path.join(directory, "torus.obj")
    pt.mesh.save_obj(pt.mesh.torus_mesh(*torus), obj)
    fac = pt.MeshObjectFactory(obj, device=device)
    gt = pt.MeshSDF(fac)
    bb = fac.bounding_box(padding=PADDING)
    kw = dict(cache_path=os.path.join(directory, "sdf_cache_torus_tri.npz"), device=device)
    return (pt.CachedSDF("torus_tri", CACHE_RES, bb, gt, **kw),
            pt.CachedSDF("torus_tri", CACHE_RES, bb, gt, interpolation="trilinear", **kw))


def single_child(child):
    """``(composition, (children, m, m_inv, tables))``: a one-child
    ``ComposedSDF`` with the identity transform, and its arguments to
    ``compose_query_coherent``."""
    comp = pt.ComposedSDF([child], pt.Transform3d(
        matrix=torch.eye(4, device=child.device)[None], device=child.device))
    return comp, (tuple(comp.sdfs), comp.obj_frame_to_link_frame.get_matrix(),
                  comp.link_frame_to_obj_frame, tsdf.coherent_fast_tables(comp.sdfs))


def generic(cache, p):
    with torch.no_grad():
        return cache.raw_query_with(cache.raw_query_aux(), p)


def coherent(composition, p, seg):
    children, m, m_inv, ft = composition
    with torch.no_grad():
        return tsdf.compose_query_coherent(children, m, m_inv, 1, p, fast_tables=ft, seg=seg)


def summed(outputs) -> torch.Tensor:
    return sum(x.sum() for x in outputs)


def coherent_gate(cache, composition, pts, seg) -> Dict[str, object]:
    """The coherent row's values and gradients against the generic row's
    on the same grid points: ``exact`` (bit for bit), the largest
    differences and ``ok`` (exact, or within 1e-6 / 1e-5)."""
    v, g = generic(cache, pts)
    vc, gc = coherent(composition, pts, seg)
    vc, gc = vc[0], gc[0]
    exact = torch.equal(v, vc) and torch.equal(g, gc)
    dv, dg = (v - vc).abs().max().item(), (g - gc).abs().max().item()
    return {"exact": exact, "max_abs_value": dv, "max_abs_gradient": dg,
            "ok": exact or (dv <= V_TOL and dg <= G_TOL)}


def run(device, directory: str, points_side: int = 100, reps: int = 5,
        log: Callable[[str], None] = lambda s: None):
    """The benchmark from a fresh cache in ``directory``.  Returns ``(line,
    build_launches)``: the JSON line (with ``ok``) and K1's launches in the
    caches' build."""
    launches0 = COUNTERS["kernel.closest_point_sweep"]
    nearest, trilin = build_caches(directory, device)
    ns._sync(device)
    build_launches = COUNTERS["kernel.closest_point_sweep"] - launches0
    log(f"caches ready ({tuple(nearest.voxels.shape)} grid); K1 launches in the build: "
        f"{build_launches}")
    res = CACHE_RES / 2
    lo = -0.5 * res * (points_side - 1)
    qr = np.array([[lo, lo + res * (points_side - 1)]] * 3)
    pts_c, take_idx, seg = pt.get_coherent_tile_points(res, qr, cache_resolution=CACHE_RES,
                                                       device=device)
    M = len(take_idx)
    rng = np.random.default_rng(0)
    pts_r = torch.as_tensor(rng.uniform(-0.25, 0.25, (M, 3)), dtype=torch.float32,
                            device=device)
    results, gate = {}, {}

    def row(name, fn):
        t = hl.time_median(fn, device, reps=reps)[0]
        results[name] = {"ms": round(t * 1e3, 4), "mqps": round(M / t / 1e6, 2)}
        log(f"{name:24s}: {t * 1e3:9.4f} ms -> {M / t / 1e6:8.2f}M q/s")

    for label, cache in (("nearest", nearest), ("trilinear", trilin)):
        row(f"{label}_generic", lambda c=cache: summed(generic(c, pts_r)))
    for label, cache in (("nearest", nearest), ("trilinear", trilin)):
        composed, comp = single_child(cache)
        if not composed.check_coherent_contract(pts_c, seg=seg):
            raise RuntimeError(f"{label}: the {seg}-point tiles break the coherent contract")
        row(f"{label}_coherent", lambda c=comp: summed(coherent(c, pts_c, seg)))
        gate[label] = coherent_gate(cache, comp, pts_c, seg)
        log(f"  {label}: coherent vs generic on the grid points {gate[label]}")
    line = {"metric": METRIC, "value": results["trilinear_generic"]["mqps"],
            "unit": f"M q/s trilinear generic ({M} pts, torus cache res {CACHE_RES})",
            "extra": {**results, "stand_in": STAND_IN, "coherent_gate": gate},
            "ok": all(g["ok"] for g in gate.values())}
    return line, build_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points-side", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5, help="calls a timed sample")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("trilinear: needs a CUDA device (--device cpu runs on the CPU)", file=sys.stderr)
        return 1
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        line, _ = run(device, tmp, args.points_side, args.reps,
                      log=lambda s: print(s, file=sys.stderr, flush=True))
    ok = line.pop("ok")
    print(json.dumps({**line, "device": hl.device_info(device)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
