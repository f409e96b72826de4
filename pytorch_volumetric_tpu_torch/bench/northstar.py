"""North-star workload on one GPU: 200 configurations x 10^6 points a step.

    python -m pytorch_volumetric_tpu_torch.bench.northstar [--configs 200]
        [--points-side 100] [--chunk 25] [--robot arm|free_link]
        [--interp nearest|trilinear]

The port's twin of the JAX package's ``benchmarks/northstar.py``, at its
shape: a ``side^3`` grid (100^3 = 10^6 points) at 0.01 from -0.5, laid out
by ``get_coherent_tile_points`` for the links' 0.02 caches in (3, 3, 3)
tiles (``seg = 27``, 1,061,208 padded points), and joint angles from
``numpy.random.default_rng(0).normal(0, 0.3, (N, n_dof))`` as float32.
Robots (cache links ``cache_link_sdf_factory(resolution=0.02,
padding=1.0)``, built from a fresh cache, so K1 runs in the build):

- ``arm``: the 7-DOF ``make_serial_arm``, 8 links on the per-tile winner
  union (``nearest``) or the multi-child trilinear union (``trilinear``);
- ``free_link``: ``make_free_object_urdf`` on the 16,384-face torus
  ``mesh.torus_mesh(0.1, 0.03, 128, 64)``, a free single link (6 DOF) on
  the single-child 4-channel bricks (``nearest``) or 5x5x5 bricks
  (``trilinear``).  The JAX script's ``drill`` and ``mesh_arm`` rows read
  meshes that are not in this repository.

The brick tables (``coherent_fast_tables``) are built once, outside the
timed loop.  A step loops in Python over configuration chunks of
``--chunk``; each chunk runs ``robot._link_transforms`` then
``compose_query_coherent``.  Three variants, as the JAX script's:
``forward`` (sum over chunks of ``v.sum() + g.sum()``),
``forward_backward`` (per chunk ``l + (dl/dq_chunk).sum()``) and
``values_only``.  Each chunk's terms stay on the device; one synchronise
ends a run.  A variant is run once to warm up, then timed 3 times
with CUDA events around the whole chunk loop (median and spread).  Queries
count ``N x M`` with ``M`` = 10^6 real points, not the padded ones.  On
``torch.cuda.OutOfMemoryError`` (and only that) the attempt's memory is
freed and the row is run again at the next smaller divisor of ``N``, on
the same device and path.

Prints one JSON line: per variant its ms, queries/s (values/s for
``values_only``), the chunk and the peak ``max_memory_allocated``; K1's
launches in the cache build and per query (0); the residual lane's middle
tiles per chunk against its capacity; the NaN gradient entries; the card.
Exits non-zero without a CUDA device or when a gate fails: a non-finite
forward sum, a ``values_only`` sum other than the forward's value part, a
NaN gradient outside the tiles beyond the residual lane's capacity, a K1
launch in a query, or a first chunk that breaks the tile contract.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch import sdf as tsdf
from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS

LO, RES = -0.5, 0.01
CACHE_RES, CACHE_PADDING = 0.02, 1.0
TORUS = (0.1, 0.03, 128, 64)  # 2 x 128 x 64 = 16,384 faces
REPS = 3  # timed runs of a variant (their median is reported)
VARIANTS = ("forward", "forward_backward", "values_only")
ROBOTS = ("arm", "free_link")


def metric_name(robot: str, interp: str) -> str:
    """The JAX script's metric names, the torus row as ``_free_link``."""
    name = "northstar_200x1e6" if robot == "arm" else f"northstar_200x1e6_{robot}"
    return name if interp == "nearest" else f"{name}_{interp}"


def build_robot(robot: str, interp: str, directory: str, device, cache_path: str,
                resolution: float = CACHE_RES, padding: float = CACHE_PADDING,
                arm_joints: int = 7, torus=TORUS) -> Tuple[pt.RobotSDF, int]:
    """The row's robot with cached links (built now, K1 in the build when
    ``cache_path`` is fresh) and its number of joints."""
    from pytorch_volumetric_tpu_torch.utils.robots import make_free_object_urdf, make_serial_arm
    if robot == "arm":
        urdf, end = make_serial_arm(os.path.join(directory, "arm"), num_joints=arm_joints)
        prefix = os.path.join(directory, "arm")
    elif robot == "free_link":
        prefix = os.path.join(directory, "free_link")
        os.makedirs(prefix, exist_ok=True)
        obj = os.path.join(prefix, "torus.obj")
        pt.mesh.save_obj(pt.mesh.torus_mesh(*torus), obj)
        urdf, end = make_free_object_urdf(prefix, obj, object_name="torus")
    else:
        raise ValueError(f"unknown robot {robot!r}")
    chain = pt.build_serial_chain_from_urdf(open(urdf).read(), end, device=device)
    r = pt.RobotSDF(chain, path_prefix=prefix, link_sdf_cls=pt.cache_link_sdf_factory(
        resolution=resolution, padding=padding, cache_path=cache_path, interpolation=interp))
    return r, len(r.joint_names)


def northstar_points(points_side: int, cache_resolution: float, device, res: float = RES,
                     lo: float = LO):
    """``(pts [F, 3], take_idx [M], seg)``: the ``side^3`` grid at ``res``
    from ``lo`` in coherent tiles for caches of ``cache_resolution``."""
    query_range = np.array([[lo, lo + res * (points_side - 1)]] * 3)
    return pt.get_coherent_tile_points(res, query_range, cache_resolution=cache_resolution,
                                       device=device)


def joint_configs(n_configs: int, n_dof: int, device, seed: int = 0) -> torch.Tensor:
    """The JAX script's joint angles: N(0, 0.3) from numpy's generator."""
    q = np.random.default_rng(seed).normal(0, 0.3, (n_configs, n_dof)).astype(np.float32)
    return torch.as_tensor(q, device=device)


def chunk_query(robot, ft, q_chunk: torch.Tensor, pts: torch.Tensor, seg: int,
                values_only: bool = False):
    """One chunk: ``robot._link_transforms`` then ``compose_query_coherent``
    on the tables ``ft``; ``(v [C, F], g [C, F, 3])``, or ``v`` alone."""
    m, m_inv = robot._link_transforms(q_chunk)
    return tsdf.compose_query_coherent(tuple(robot.sdf.sdfs), m, m_inv, q_chunk.shape[0], pts,
                                       fast_tables=ft, seg=seg, values_only=values_only)


def chunk_grad(robot, ft, q_chunk, pts, seg):
    """``(v, g, dl/dq)`` of a chunk, ``l = v.sum() + g.sum()``."""
    qc = q_chunk.detach().clone().requires_grad_(True)
    v, g = chunk_query(robot, ft, qc, pts, seg)
    (dq,) = torch.autograd.grad(v.sum() + g.sum(), qc)
    return v.detach(), g.detach(), dq


def chunk_terms(variant: str, robot, ft, q_chunk, pts, seg) -> torch.Tensor:
    """A chunk's two terms of the step, ``[2]`` on the device: ``(v.sum(),
    g.sum())`` for ``forward``, ``(l, (dl/dq).sum())`` for
    ``forward_backward``, ``(v.sum(), 0)`` for ``values_only``.  Their sum
    is the JAX script's per-chunk scalar."""
    if variant == "forward":
        with torch.no_grad():
            v, g = chunk_query(robot, ft, q_chunk, pts, seg)
            return torch.stack([v.sum(), g.sum()])
    if variant == "forward_backward":
        qc = q_chunk.detach().clone().requires_grad_(True)
        v, g = chunk_query(robot, ft, qc, pts, seg)
        loss = v.sum() + g.sum()
        (dq,) = torch.autograd.grad(loss, qc)
        return torch.stack([loss.detach(), dq.sum()])
    if variant == "values_only":
        v = chunk_query(robot, ft, q_chunk, pts, seg, values_only=True)
        return torch.stack([v.sum(), torch.zeros((), dtype=v.dtype, device=v.device)])
    raise ValueError(f"unknown variant {variant!r}")


def run_variant(variant: str, robot, ft, q: torch.Tensor, pts, seg, chunk: int) -> torch.Tensor:
    """The step over every chunk: ``[N // chunk, 2]`` chunk terms, left on
    the device (no synchronise)."""
    if q.shape[0] % chunk:
        raise ValueError(f"chunk {chunk} does not divide {q.shape[0]} configurations")
    return torch.stack([chunk_terms(variant, robot, ft, qc, pts, seg) for qc in q.split(chunk)])


def step_scalar(terms: torch.Tensor) -> float:
    """The JAX script's scalar: each chunk's terms summed, then the chunks."""
    return float(terms.sum(dim=1).sum())


def chunk_candidates(n: int, start: int) -> Iterator[int]:
    """The JAX script's chunk sizes: ``start`` (at most ``n``) lowered to a
    divisor of ``n``, then halved and lowered again, down to 1."""
    c = min(start, n)
    while c >= 1:
        while n % c:
            c -= 1
        yield c
        c //= 2


def with_oom_retry(run: Callable[[int], dict], n: int, start: int,
                   log: Callable[[str], None] = lambda s: None) -> Tuple[int, dict]:
    """``(chunk, run(chunk))`` at the first chunk of :func:`chunk_candidates`
    that does not run out of device memory.  Only
    ``torch.cuda.OutOfMemoryError`` is retried (any other exception
    propagates, as does an OOM at chunk 1); before a retry the attempt's
    tensors are dropped and the caching allocator's blocks released."""
    if n < 1:
        raise ValueError(f"no chunk size for {n} configurations")
    for c in chunk_candidates(n, start):
        try:
            return c, run(c)
        except torch.cuda.OutOfMemoryError as e:
            if c == 1:
                raise
            log(f"chunk={c} ran out of device memory ({str(e)[:160]}); retrying smaller")
        # the exception and the frames it held are gone here
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_variant(variant: str, robot, ft, q, pts, seg, chunk: int, reps: int = REPS,
                 warmup: int = 1) -> dict:
    """A variant's warm-up run(s), then ``reps`` runs timed with CUDA events
    around the whole chunk loop (wall clock on the CPU).  Returns the
    median ms, every run's ms, the spread, the peak memory from before the
    warm-up, the last run's scalar and its value term, and the K1 launches
    during the runs."""
    device = pts.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = COUNTERS["kernel.closest_point_sweep"]
    for _ in range(warmup):
        run_variant(variant, robot, ft, q, pts, seg, chunk)
    _sync(device)
    times, terms = [], None
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            terms = run_variant(variant, robot, ft, q, pts, seg, chunk)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            terms = run_variant(variant, robot, ft, q, pts, seg, chunk)
            times.append((time.perf_counter() - t0) * 1e3)
    return {"ms": float(np.median(times)), "ms_runs": times,
            "spread_ms": float(max(times) - min(times)),
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
            "sum": step_scalar(terms), "value_sum": float(terms[:, 0].sum()),
            "k1_launches": COUNTERS["kernel.closest_point_sweep"] - launches0,
            "terms": terms}


def audit_chunk(robot, ft, q_chunk, pts, seg) -> dict:
    """One chunk's residual lane and NaN gradients: the middle tiles (>= 4
    distinct winners) against the capacity, the NaN gradient entries, and
    those outside the tiles beyond the capacity (the JAX semantics: exact,
    or NaN there)."""
    children = tuple(robot.sdf.sdfs)
    C, F = q_chunk.shape[0], pts.shape[0]
    with torch.no_grad():
        v, g = chunk_query(robot, ft, q_chunk, pts, seg)
        m, _ = robot._link_transforms(q_chunk)
        middle = tsdf.coherent_middle_tiles(children, m, C, pts, fast_tables=ft, seg=seg)
        nan = torch.isnan(g).reshape(C, F // seg, seg * 3)
        if middle is None:
            overflow = torch.zeros(nan.shape[:2], dtype=torch.bool, device=nan.device)
            n_middle = 0
        else:
            _, overflow = tsdf._residual_tiles(middle, tsdf.residual_capacity(middle.numel()))
            n_middle = int(middle.sum())
        return {"middle_tiles": n_middle, "capacity": tsdf.residual_capacity(C * (F // seg)),
                "tiles": C * (F // seg), "nan_entries": int(nan.sum()),
                "nan_outside_overflow": int((nan & ~overflow[..., None]).sum()),
                "nonfinite_values": int((~torch.isfinite(v)).sum())}


def run_row(robot, ft, q, pts, take_idx, seg, chunk: int, variants: Sequence[str] = VARIANTS,
            reps: int = REPS, warmup: int = 1,
            log: Callable[[str], None] = lambda s: None) -> dict:
    """Every variant of one row at ``chunk`` (see :func:`time_variant`),
    then the audit of each chunk.  Queries count ``N x len(take_idx)``."""
    n_q = q.shape[0] * len(take_idx)
    out = {}
    for variant in variants:
        r = time_variant(variant, robot, ft, q, pts, seg, chunk, reps=reps, warmup=warmup)
        rate = n_q / (r["ms"] * 1e-3)
        r["values_per_s" if variant == "values_only" else "queries_per_s"] = rate
        peak = r["peak_bytes"]
        log(f"  {variant} (chunk {chunk}): {r['ms']:.3f} ms median of {r['ms_runs']}, "
            f"{rate / 1e6:.2f} M/s, peak {peak / 1e9 if peak else float('nan'):.2f} GB, "
            f"sum {r['sum']:.6e}")
        out[variant] = r
    audits = [audit_chunk(robot, ft, qc, pts, seg) for qc in q.split(chunk)]
    return {"variants": out, "audits": audits}


def row_gates(row: dict) -> Dict[str, bool]:
    """The row's own arithmetic: a finite forward sum, the ``values_only``
    sum equal to the forward's value part (the values are bit-identical
    across variants), no NaN gradient outside the overflow tiles, no K1
    launch in a query."""
    v = row["variants"]
    gates = {"nan_only_beyond_capacity": all(a["nan_outside_overflow"] == 0
                                             for a in row["audits"]),
             "no_k1_in_queries": all(r["k1_launches"] == 0 for r in v.values())}
    if "forward" in v:
        gates["forward_sum_finite"] = math.isfinite(v["forward"]["sum"])
        if "values_only" in v:
            gates["values_only_sum_equals_forward"] = (
                v["values_only"]["value_sum"] == v["forward"]["value_sum"])
    return gates


def northstar(robot_kind: str, interp: str, device, workdir: str, n_configs: int = 200,
              points_side: int = 100, chunk: int = 25, variants: Sequence[str] = VARIANTS,
              reps: int = REPS, warmup: int = 1, build: Optional[dict] = None,
              log: Callable[[str], None] = lambda s: None):
    """One row of the benchmark, from a fresh cache in ``workdir``
    (``build``: keyword arguments of :func:`build_robot`).  Returns ``(out,
    (robot, ft, q, pts, seg))``: the JSON row, then the robot, its brick
    tables and the inputs."""
    launches0 = COUNTERS["kernel.closest_point_sweep"]
    robot, n_dof = build_robot(robot_kind, interp, workdir, device,
                               os.path.join(workdir, f"{robot_kind}_{interp}.npz"),
                               **(build or {}))
    _sync(device)
    build_launches = COUNTERS["kernel.closest_point_sweep"] - launches0
    children = tuple(robot.sdf.sdfs)
    pts, take_idx, seg = northstar_points(points_side,
                                          tsdf.coherent_min_cache_resolution(children), device)
    q = joint_configs(n_configs, n_dof, device)
    log(f"{metric_name(robot_kind, interp)}: {len(children)} links, seg={seg}, "
        f"{pts.shape[0]} padded points (M={len(take_idx)}), {n_configs} configurations; "
        f"K1 launches in the cache build: {build_launches}")
    ft = tsdf.coherent_fast_tables(children)
    robot.set_joint_configuration(q[:min(chunk, n_configs)])
    contract = bool(robot.sdf.check_coherent_contract(pts, seg=seg))
    log(f"  tile contract on the first chunk: {contract}; reckoned at chunk {chunk}: "
        f"transformed points {len(children) * chunk * pts.shape[0] * 12 / 1e9:.2f} GB, an int64 "
        f"key tensor {len(children) * chunk * pts.shape[0] * 24 / 1e9:.2f} GB")

    def attempt(c):
        return run_row(robot, ft, q, pts, take_idx, seg, c, variants, reps, warmup, log)

    chunk_used, row = with_oom_retry(attempt, n_configs, chunk, log)
    log(f"  chunk used: {chunk_used}")
    gates = {**row_gates(row), "tile_contract_first_chunk": contract}
    audits = row["audits"]
    out = {"metric": metric_name(robot_kind, interp), "robot": robot_kind, "interp": interp,
           "links": len(children), "configs": n_configs, "points": len(take_idx),
           "padded_points": int(pts.shape[0]), "seg": seg, "chunk": chunk_used,
           "k1_launches_build": build_launches, "k1_launches_per_query": max(
               r["k1_launches"] for r in row["variants"].values()),
           "variants": {k: {x: y for x, y in r.items() if x != "terms"}
                        for k, r in row["variants"].items()},
           "residual": {"capacity_per_chunk": audits[0]["capacity"],
                        "tiles_per_chunk": audits[0]["tiles"],
                        "middle_tiles_per_chunk": [a["middle_tiles"] for a in audits],
                        "max_middle_share_of_capacity": max(
                            a["middle_tiles"] / a["capacity"] for a in audits)},
           "nan_gradient_entries": sum(a["nan_entries"] for a in audits),
           "gates": gates, "ok": all(gates.values())}
    if "forward" in out["variants"]:
        out["value"] = out["variants"]["forward"]["queries_per_s"]
        out["unit"] = f"config-point queries/s ({n_configs} configs x {len(take_idx)} pts, fwd)"
    return out, (robot, ft, q, pts, seg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", type=int, default=200)
    ap.add_argument("--points-side", type=int, default=100,
                    help="the query grid is side^3 points")
    ap.add_argument("--chunk", type=int, default=25,
                    help="configurations per chunk to start from (on OOM the next "
                         "smaller divisor of --configs)")
    ap.add_argument("--robot", choices=ROBOTS, default="arm")
    ap.add_argument("--interp", choices=["nearest", "trilinear"], default="nearest")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("northstar: needs a CUDA device", file=sys.stderr)
        return 1
    from pytorch_volumetric_tpu_torch.bench.sweep_roofline import card_name
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        out = northstar(args.robot, args.interp, device, tmp, args.configs, args.points_side,
                        args.chunk, log=lambda s: print(s, file=sys.stderr, flush=True))[0]
    out["device"] = {"name": torch.cuda.get_device_name(0), "card": card_name()}
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
