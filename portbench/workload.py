"""The benchmark's workload generators: robot assets and inputs from a seed.

Frozen copies, so that the yardstick does not move with the program:

- the mesh generators (``meshes/<kind>.py``) and ``save_obj`` are
  ``pytorch_volumetric_tpu_torch/mesh.py``'s;
- the URDF writers (``robots/<kind>.py``) are
  ``pytorch_volumetric_tpu_torch/utils/robots.py``'s ``make_serial_arm``
  and ``make_free_object_urdf``;
- the grid and the joint-angle draws follow ``bench/headline.py`` and
  ``bench/northstar.py``, with the draws moved onto the device and keyed by
  the run's seed.

A configuration file (``configs/<name>.json``) names the robot; a mix file
(``mixes/<name>.json``) names the shapes and distributions.  Both sides, the
program and the reference, get the same files and the same tensors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from portbench import plugins


# ---------------------------------------------------------------------------
# meshes and robots, found by kind
# ---------------------------------------------------------------------------

def make_mesh(spec: dict, base: str = plugins.BENCH_DIR):
    """The mesh of a specification: ``{"kind": <meshes/kind.py>, <its
    parameters>}``, or ``{"parts": [<specification>, ...]}``, the parts
    concatenated in order (``TriangleMesh.concatenate``'s).  Returns
    ``(vertices float64 [V, 3], faces int32 [F, 3])``."""
    if "parts" in spec:
        vs, fs, n = [], [], 0
        for part in spec["parts"]:
            v, f = make_mesh(part, base)
            vs.append(v)
            fs.append(f + n)
            n += len(v)
        return np.concatenate(vs, axis=0), np.concatenate(fs, axis=0).astype(np.int32)
    params = dict(spec)
    return plugins.load("meshes", params.pop("kind"), base).make(**params)


def save_obj(vertices: np.ndarray, faces: np.ndarray, path: str) -> None:
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for t in faces + 1:
            f.write(f"f {t[0]} {t[1]} {t[2]}\n")


@dataclass
class Assets:
    directory: str      # the URDF's mesh paths are relative to it
    urdf_path: str
    end_link: str


def write_robot(cfg: dict, directory: str, base: str = plugins.BENCH_DIR) -> Assets:
    """The configuration's robot (meshes as OBJ, the URDF) in ``directory``,
    by the writer ``robots/<robot.kind>.py``."""
    os.makedirs(directory, exist_ok=True)
    return plugins.load("robots", cfg["robot"]["kind"], base).write(cfg, directory, base)


# ---------------------------------------------------------------------------
# inputs from the seed
# ---------------------------------------------------------------------------

def grid_coords(query_range, resolution: float) -> List[np.ndarray]:
    """The grid's float32 coordinates per dimension (``np.arange`` with an
    inclusive upper bound), the values a grid query is given."""
    return [np.arange(lo, hi + 0.9 * resolution, resolution, dtype=np.float32)
            for lo, hi in np.asarray(query_range, dtype=np.float64)]


def grid_points(coords: List[np.ndarray], flat_idx: torch.Tensor) -> torch.Tensor:
    """World points ``[..., 3]`` (float64) of raster indices into the grid."""
    sizes = [len(c) for c in coords]
    dev = flat_idx.device
    out, rest = [], flat_idx
    for d in range(len(sizes) - 1, -1, -1):
        c = torch.as_tensor(coords[d], dtype=torch.float64, device=dev)
        out.append(c[rest % sizes[d]])
        rest = rest // sizes[d]
    return torch.stack(out[::-1], dim=-1)


@dataclass
class Inputs:
    """One run's inputs.  ``q [P, N, dof]``: ``P`` batches of ``N`` joint
    configurations, step ``s`` takes batch ``s % P``; ``points [M, 3]``
    (float32) for a point query, None for a grid; ``n_points`` real points a
    configuration; sample positions ``sample_cfg``/``sample_pt [P, K, S]``
    (configuration within the chunk, point) for chunk ``k`` of batch ``b``;
    ``dq_cfg [P, D]``: configurations (within the batch) whose d/dq is
    checked (:func:`dq_configurations`)."""
    q: torch.Tensor
    points: Optional[torch.Tensor]
    coords: Optional[List[np.ndarray]]
    n_points: int
    sample_cfg: torch.Tensor
    sample_pt: torch.Tensor
    dq_cfg: Optional[torch.Tensor]


def seed_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_inputs(cfg: dict, mix: dict, seed: int, device) -> Inputs:
    """The run's inputs, drawn on ``device`` from ``seed``: every seed gets
    the same shapes and counts, only the values differ."""
    gen = seed_generator(seed, device)
    dof = len(cfg["home_q"])
    P, N = mix["pool"], mix["configs"]
    c = mix["q"]
    home = torch.as_tensor(cfg["home_q"], dtype=torch.float32, device=device)
    if c.get("mean", "home") == "zero":
        home = torch.zeros_like(home)
    if c["dist"] != "normal":
        raise ValueError(f"unknown joint distribution {c['dist']!r}")
    q = home + c["sigma"] * torch.randn((P, N, dof), generator=gen, device=device)
    if c.get("home_first"):
        q[:, 0] = home
    points, coords = None, None
    if "grid" in mix:
        coords = grid_coords(mix["grid"]["range"], mix["grid"]["resolution"])
        n_points = int(np.prod([len(x) for x in coords]))
    else:
        p = mix["points"]
        if p["dist"] != "uniform":
            raise ValueError(f"unknown point distribution {p['dist']!r}")
        box = torch.as_tensor(p["box"], dtype=torch.float32, device=device)
        u = torch.rand((p["count"], 3), generator=gen, device=device)
        points = box[:, 0] + u * (box[:, 1] - box[:, 0])
        n_points = p["count"]
    chunk = mix["chunk"]
    K, S = N // chunk, mix["sample"]["per_chunk"]
    sample_cfg = torch.randint(0, chunk, (P, K, S), generator=gen, device=device)
    sample_pt = torch.randint(0, n_points, (P, K, S), generator=gen, device=device)
    dq_cfg = None
    if mix.get("backward"):
        dq_cfg = dq_configurations(mix, gen, device)
    return Inputs(q, points, coords, n_points, sample_cfg, sample_pt, dq_cfg)


def dq_configurations(mix: dict, gen: torch.Generator, device) -> torch.Tensor:
    """``[P, D]``: the ``D = sample.dq_configs`` configurations of each batch
    whose d/dq is checked, stratified by chunk: the ``j``-th of batch ``b``
    lies in chunk ``(b * D + j) % K``, at an offset drawn from the seed, so
    that over the pool every chunk position of a step is checked once
    ``P * D >= K``.  Two in one chunk differ."""
    P, N, chunk = mix["pool"], mix["configs"], mix["chunk"]
    K, D = N // chunk, mix["sample"]["dq_configs"]
    out = torch.empty((P, D), dtype=torch.long, device=device)
    for b in range(P):
        ks = [(b * D + j) % K for j in range(D)]
        for k in sorted(set(ks)):
            js = [j for j in range(D) if ks[j] == k]
            off = torch.randperm(chunk, generator=gen, device=device)[:len(js)]
            out[b, js] = k * chunk + off
    return out


def world_points(inputs: Inputs, idx: torch.Tensor) -> torch.Tensor:
    """Float64 world points of point indices ``idx``."""
    if inputs.points is not None:
        return inputs.points[idx].to(torch.float64)
    return grid_points(inputs.coords, idx)


def all_world_points(inputs: Inputs, device) -> torch.Tensor:
    """Every real query point, float64 ``[M, 3]``, in the output's order."""
    return world_points(inputs, torch.arange(inputs.n_points, device=device))


def chunk_bounds(mix: dict) -> List[Tuple[int, int]]:
    chunk = mix["chunk"]
    return [(k * chunk, (k + 1) * chunk) for k in range(mix["configs"] // chunk)]
