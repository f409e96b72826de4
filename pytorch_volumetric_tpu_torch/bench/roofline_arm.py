"""One north-star chunk of the arm on one GPU, timed in stages.

    python -m pytorch_volumetric_tpu_torch.bench.roofline_arm [--chunk 25]
        [--points-side 100] [--reps 4] [--device cuda|cpu]

The port's twin of the JAX package's ``benchmarks/roofline_arm.py``: one
configuration chunk of ``bench/northstar.py``'s arm row (``B = --chunk``
configurations, the first ``B`` of its N(0, 0.3) draws from seed 0) x the
``side^3`` grid at half the cache resolution (100^3 at 0.01 from -0.5, in
(3, 3, 3) tiles: 1,061,208 padded points) x the 8 nearest cached links
(``cache_link_sdf_factory(CACHE_RES, 1.0)``, ``CACHE_RES`` = 0.02).  The
chunk runs in stages, each a whole run from the joint angles; its delta is
its time less that of the stage it builds on (``DELTA_BASE``).  The stages
of the path the library runs, where the union is one kernel that forms the
link-frame points in registers from the world points and the links'
transforms (``ops/coherent_union.py``, ``csrc/coherent_union.cu``; its
plain version on the CPU):

  fk           ``RobotSDF._link_transforms``: the links' obj_to_link rows
  union        + the union kernel, values only (``sdf._coherent_union_values``),
               delta against fk
  full         ``compose_query_coherent``'s forward: the union kernel with
               its gradients and winners (``sdf._coherent_union_lookup_tile``),
               delta against fk
  fwd_bwd      + ``d(v.sum() + g.sum()) / dq`` (delta against full)

and, for comparison, the plain version's chain: the link-frame points it
reads, then ``sdf._union_values_eval``'s steps (``sdf._nearest_union``'s own
functions), cumulative from transform:

  transform     + ``transforms.transform_points`` -> ``pts_c [C, B, FS, seg,
                3]`` (delta against fk)

  plain_keys    + ``sdf._nearest_keys`` (the in-grid mask and the clamped keys)
  plain_anchor  + ``sdf._nearest_anchor``: each tile's brick row, each point's
                cell in it and the int64 packed-row index ``flat``
  plain_cells   + ``sdf._nearest_cells`` of each child's value bricks
  plain_union   + ``sdf._nearest_select`` (the AABB fallback, the ``where``),
                ``amin``: the values-only result of the plain version

A stage returns the sums of the tensors it hands on (as the JAX script's
stages sum every live output; eager PyTorch drops no dead work, so the
sums only make the stages' results comparable).  Each stage is timed with
CUDA events, a warm-up then ``--reps`` runs, the median.  In
separate runs: the launches, the device ms and the top kernels of one
traced run with the port's functions labelled (``utils.profiling.kernel_owners``), and the
bytes of every tensor the stage creates, counted from shapes and dtypes
(every non-aliasing operator's outputs), with those bytes' floor at 3.35
TB/s.  Stage outputs are freed before the next stage runs; on
``torch.cuda.OutOfMemoryError`` the whole measurement runs again at the
next smaller divisor of the chunk (``northstar.with_oom_retry``).

Gates, bit for bit: ``union``'s sum equals a direct ``values_only`` call
of ``compose_query_coherent`` (the stages' transforms and tile layout are
the library's), ``full``'s value sum equals ``union``'s (``full`` is
``compose_query_coherent``'s forward itself, so it is held to the
values-only path: the per-tile winners' values against the ``amin``), and
``plain_union``'s sum equals ``union``'s (the kernel against its plain
version).
The JAX script's TPU gather cost model and XLA ``cost_analysis`` have no
counterpart here: the bytes count stands in their place.

Prints one JSON line: ``metric`` ``northstar_arm_chunk_roofline``,
``value`` = B x M / ``full`` s over the M real points.  Exits non-zero
without a CUDA device (unless ``--device cpu``) or when a gate fails; on
the CPU (the tests) the wall clock times the stages and no launches are
counted.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from pytorch_volumetric_tpu_torch import sdf as tsdf
from pytorch_volumetric_tpu_torch.bench import headline as hl
from pytorch_volumetric_tpu_torch.bench import northstar as ns

METRIC = "northstar_arm_chunk_roofline"
CACHE_RES = ns.CACHE_RES  # the links' cache resolution; the grid takes half of it
PLAIN = ("plain_keys", "plain_anchor", "plain_cells", "plain_union")
PIECEWISE = ("fk", "union", "transform") + PLAIN
STAGES = ("fk", "union", "full", "fwd_bwd", "transform") + PLAIN
# the stage each delta is taken against
DELTA_BASE = {"union": "fk", "full": "fk", "fwd_bwd": "full", "transform": "fk",
              "plain_keys": "transform", "plain_anchor": "plain_keys",
              "plain_cells": "plain_anchor", "plain_union": "plain_cells"}
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's memory rate (NVIDIA's data sheet)
TOP_KERNELS = 5


def stage_outputs(stage: str, robot, ft, q: torch.Tensor, pts: torch.Tensor, seg: int):
    """The tensors the chunk's nearest union hands on at the end of
    ``stage`` (one of :data:`PIECEWISE`), computed without gradients: ``fk``
    the links' obj_to_link rows ``[S * B, 4, 4]``, ``union`` the kernel's
    values-only result ``[B, F]`` (``sdf._coherent_union_values``), the
    ``transform`` and ``plain_*`` stages the plain version's link-frame
    points and steps (``sdf._nearest_union``'s own), in its order,
    ``plain_union`` its values-only result."""
    S, B, F = len(ft), q.shape[0], pts.shape[0]
    with torch.no_grad():
        m, _ = robot._link_transforms(q)
        if stage == "fk":
            return (m,)
        T = m.reshape(S, B, 4, 4)
        if stage == "union":
            return (tsdf._coherent_union_values(ft, pts, T, seg).reshape(B, F),)
        pts_c = tsdf._link_points(T, pts, seg)
        if stage == "transform":
            return (pts_c,)
        valid, kc = tsdf._nearest_keys(ft, pts_c)
        if stage == "plain_keys":
            return valid, kc
        row, cell, flat = tsdf._nearest_anchor(ft, kc)
        del kc
        if stage == "plain_anchor":
            return valid, row, cell, flat
        v_in = tsdf._nearest_cells(ft, row, cell)
        if stage == "plain_cells":
            return valid, v_in, flat
        if stage == "plain_union":
            v, _ = tsdf._nearest_select(ft, pts_c, valid, v_in)
            return (v.amin(dim=0).reshape(B, F),)
    raise ValueError(f"unknown piecewise stage {stage!r}")


def stage_sums(stage: str, robot, ft, q, pts, seg) -> torch.Tensor:
    """The stage's result: the float64 sums of the tensors it hands on
    (``full``: ``[v.sum(), g.sum()]``; ``fwd_bwd``: ``[l, (dl/dq).sum()]``
    with ``l = v.sum() + g.sum()``)."""
    if stage == "full":
        return ns.chunk_terms("forward", robot, ft, q, pts, seg).double()
    if stage == "fwd_bwd":
        return ns.chunk_terms("forward_backward", robot, ft, q, pts, seg).double()
    return torch.stack([x.sum().double() for x in stage_outputs(stage, robot, ft, q, pts, seg)])


class CreatedBytes(TorchDispatchMode):
    """Counts the bytes of every tensor created inside the mode: the
    outputs of each operator whose schema returns no alias (views and
    in-place operators write no new tensor)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if all(r.alias_info is None for r in func._schema.returns):
            self.ops += 1
            self.bytes += sum(t.numel() * t.element_size() for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
        return out


def created_bytes(fn: Callable[[], object]) -> Dict[str, int]:
    """``{"bytes", "ops"}`` of one run of ``fn()`` under :class:`CreatedBytes`."""
    with CreatedBytes() as counter:
        fn()
    return {"bytes": counter.bytes, "ops": counter.ops}


def profile_stage(fn: Callable[[], object], top: int = TOP_KERNELS) -> dict:
    """Launches, device ms and the top kernels of one traced run of
    ``fn()`` on the card, each kernel with the labelled caller that
    launched most of its time (``utils.profiling.kernel_owners``)."""
    from pytorch_volumetric_tpu_torch.utils import profiling
    # this module too: its stages' own steps and sums get a label
    prof, labels = profiling.annotated_profile(fn, profiling.PORT_MODULES + (__name__,))
    kernels = profiling.device_kernels(prof, labels)
    owner = {}
    for r in profiling.kernel_owners(prof, labels):  # the largest first
        owner.setdefault(r["kernel"], r["caller"])
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return {"launches": sum(n for n, _ in kernels.values()),
            "kernel_ms": sum(ms for _, ms in kernels.values()),
            "top": [[name[:80], owner.get(name, "not linked to an operator"), n, ms]
                    for name, (n, ms) in ranked]}


def measure(robot, ft, q, pts, seg, reps: int = 4,
            log: Callable[[str], None] = lambda s: None) -> dict:
    """Every stage of the chunk ``q``: its ms (median of ``reps`` runs
    after a warm-up), spread, result, created bytes and, on the card, its
    profile."""
    device = pts.device
    out = {}
    for stage in STAGES:
        def fn(stage=stage):  # the name resolves at call time: profile_stage labels it
            return stage_sums(stage, robot, ft, q, pts, seg)

        med, lo, hi = hl.time_median(fn, device, reps=1, samples=reps)
        r = {"ms": med * 1e3, "spread_ms": (hi - lo) * 1e3, "sums": fn().tolist(),
             **created_bytes(fn)}
        r["floor_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        if device.type == "cuda":
            r.update(profile_stage(fn))
        log(f"  {stage:10s}: {r['ms']:9.3f} ms (spread {r['spread_ms']:.3f}), created "
            f"{r['bytes'] / 1e9:.3f} GB in {r['ops']} operators (floor {r['floor_ms']:.3f} ms)"
            + (f", {r['launches']} launches, {r['kernel_ms']:.3f} device ms"
               if "launches" in r else ""))
        out[stage] = r
    return out


def gates(robot, ft, q, pts, seg, stages: dict) -> Dict[str, bool]:
    """``union``'s sum equals a direct ``values_only`` call's, ``full``'s
    value sum equals ``union``'s and ``plain_union``'s equals ``union``'s,
    bit for bit."""
    with torch.no_grad():
        m, m_inv = robot._link_transforms(q)
        vo = tsdf.compose_query_coherent(tuple(robot.sdf.sdfs), m, m_inv, q.shape[0], pts,
                                         fast_tables=ft, seg=seg, values_only=True)
        union = [vo.sum().double().item()]
    return {"union_equals_values_only": stages["union"]["sums"] == union,
            "full_values_equal_union": stages["full"]["sums"][0] == union[0],
            "plain_union_equals_union": stages["plain_union"]["sums"] == union}


def run(device, directory: str, chunk: int = 25, points_side: int = 100, reps: int = 4,
        cache_path: str = None,
        log: Callable[[str], None] = lambda s: None) -> dict:
    """The benchmark with the arm's files in ``directory`` (its cache in
    ``cache_path``, default ``directory/sdf_cache.npz``: read when it holds
    these settings' grids).  Returns the JSON line, with ``ok``."""
    robot, n_dof = ns.build_robot("arm", "nearest", directory, device,
                                  cache_path or os.path.join(directory, "sdf_cache.npz"),
                                  resolution=CACHE_RES)
    children = tuple(robot.sdf.sdfs)
    plan = tsdf._coherent_plan(children)
    if plan.route != "tile_union" or plan.generic or len(children) < 4:
        raise ValueError("the roofline stages need a union of nearest cached links")
    pts, take_idx, seg = ns.northstar_points(points_side, CACHE_RES, device,
                                             res=CACHE_RES / 2)
    ft = tsdf.coherent_fast_tables(children)
    q_all = ns.joint_configs(chunk, n_dof, device)
    log(f"chunk B={chunk}, F={pts.shape[0]} (M={len(take_idx)}), seg={seg}, "
        f"links={len(children)}")

    def attempt(c):
        robot.set_joint_configuration(q_all[:c])
        if not robot.sdf.check_coherent_contract(pts, seg=seg):
            raise RuntimeError(f"the {seg}-point tiles break the coherent contract")
        stages = measure(robot, ft, q_all[:c], pts, seg, reps=reps, log=log)
        return stages, gates(robot, ft, q_all[:c], pts, seg, stages)

    B, (stages, gate) = ns.with_oom_retry(attempt, chunk, chunk, log)
    ms = {k: r["ms"] for k, r in stages.items()}
    delta = {k: ms[k] - ms[DELTA_BASE[k]] if k in DELTA_BASE else ms[k] for k in STAGES}
    log(f"  gates {gate}")
    M = len(take_idx)
    extra = {"stage_ms": ms, "delta_ms": delta,
             "stage_spread_ms": {k: r["spread_ms"] for k, r in stages.items()},
             "stage_bytes": {k: r["bytes"] for k, r in stages.items()},
             "stage_floor_ms": {k: r["floor_ms"] for k, r in stages.items()},
             "launches": {k: r.get("launches") for k, r in stages.items()},
             "kernel_ms": {k: r.get("kernel_ms") for k, r in stages.items()},
             "top_kernels": {k: r.get("top") for k, r in stages.items()},
             "gates": gate,
             "chunk": B, "seg": seg, "links": len(children), "points": int(pts.shape[0])}
    return {"metric": METRIC, "value": B * M / (ms["full"] * 1e-3),
            "unit": f"config-point queries/s (one {B}x{M} chunk, fwd)", "extra": extra,
            "ok": all(gate.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=25,
                    help="configurations in the chunk (the north-star chunk size)")
    ap.add_argument("--points-side", type=int, default=100)
    ap.add_argument("--reps", type=int, default=4, help="timed runs of each stage")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("roofline_arm: needs a CUDA device (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 1
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        out = run(device, tmp, args.chunk, args.points_side, args.reps,
                  log=lambda s: print(s, file=sys.stderr, flush=True))
    ok = out.pop("ok")
    print(json.dumps({**out, "device": hl.device_info(device)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
