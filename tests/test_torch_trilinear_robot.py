"""The trilinear-cached arm (the benchmark's ``arm7tri``) on the CPU at the
arm sizes of ``portbench/tests/tiny.py``: the port's ``RobotSDF.query_grid``
(the trilinear union) and ``RobotSDF.query`` (each link's 8-corner gather),
with d/dq, against the plain reference of ``portbench/links/cached.trilinear.py``,
which knows nothing of the port.

Tolerances, and why each holds the port and fails the TF32 control (the
reference in float32 with TF32 operands in FK's matrix products):

- values within 1e-6 m of the reference's interval: the port's float32
  link-frame points and lerp weights round at ~1e-7 m over the arm's metre,
  the cache holds float32 values; TF32's 10-bit FK moves a link-frame point
  by ~1e-4 m, and the smooth lerp moves the value with it;
- gradients within 1e-4 a component where the reference's is settled: the
  cache holds K1's float32 gradients, lerped with float32 weights; TF32
  moves the lerp's weights, at a cell of 0.1 m, by ~1e-3;
- d/dq within 1e-5 of each configuration's largest |d/dq|, beyond the
  reference's rounding slack: float32 sums over the grid's points; TF32's
  FK moves every term.
"""

import os

import numpy as np
import pytest
import torch

from portbench import harness, judge, workload
from portbench.reference import Reference
from pytorch_volumetric_tpu_torch.utils import profiling
from torch_cpu_guard import warm_sqrt

warm_sqrt()

CPU = torch.device("cpu")
VALUE_TOL, GRAD_TOL, DQ_TOL = 1e-6, 1e-4, 1e-5
# the query grid: tiny.py's grid1m, 20^3 points at 0.05, half the cache's 0.1
GRID = np.array([[-0.5, 0.45]] * 3)
GRID_RES = 0.05


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    """``arm7tri`` at tiny.py's arm settings (cache resolution 0.1, padding
    0.2): the program's robot and the reference, from one set of files."""
    tmp = str(tmp_path_factory.mktemp("arm7tri"))
    cfg = harness.load_config("arm7tri")
    cfg["links"].update(resolution=0.1, padding=0.2)
    assets = workload.write_robot(cfg, os.path.join(tmp, "robot"))
    robot = harness.Program(cfg, assets, CPU, os.path.join(tmp, "c.npz")).robot
    g = torch.Generator().manual_seed(11)
    q = 0.3 * torch.randn(3, 7, generator=g)
    return robot, Reference(cfg, assets, CPU), q


def grid_points():
    """The grid's points in ``query_grid``'s output order (the benchmark's
    own generator)."""
    coords = workload.grid_coords(GRID, GRID_RES)
    n = int(np.prod([len(c) for c in coords]))
    return workload.grid_points(coords, torch.arange(n)).float()


def scattered_points():
    g = torch.Generator().manual_seed(12)
    return torch.rand(600, 3, generator=g) * torch.tensor([1.5, 1.0, 1.0]) \
        + torch.tensor([-1.0, -0.5, -0.2])


def value_gaps(ref, q, pts, v, g):
    """The judge's value and gradient gaps of answers ``v [C, N]``, ``g [C,
    N, 3]`` at every configuration and point, the reference's admissible
    answers and the queries they were asked of."""
    qs = q[:, None].expand(-1, len(pts), -1).reshape(-1, q.shape[1])
    ps = pts[None].expand(len(q), -1, -1).reshape(-1, 3).double()
    e = ref.expected(qs, ps)
    rec = {"k": 0, "v": v.reshape(-1), "g": g.reshape(-1, 3), "dq": None}
    return judge.call_gaps(rec, e, {}, len(q)), e, qs, ps


def dq_gap(ref, q, pts, dq):
    """The largest d/dq gap beyond the f64 reference's slack, over each
    configuration's largest |d/dq|."""
    worst = 0.0
    for i in range(len(q)):
        want, slack = ref.dq(q[i], pts.double())
        gap = torch.clamp((dq[i].double() - want).abs() - slack, min=0)
        worst = max(worst, float(gap.max() / want.abs().max()))
    return worst


def differentiated(call, q):
    qq = q.clone().requires_grad_(True)
    v, g = call(qq)
    (dq,) = torch.autograd.grad(v.sum() + g.sum(), qq)
    return v.detach(), g.detach(), dq


def control_holds_no_tolerance(ref, q, pts, qs, ps, e):
    """The TF32 control fails each tolerance: value, gradient and d/dq."""
    v, g = ref.answers(qs, ps, "tf32")
    out = judge.call_gaps({"k": 0, "v": v, "g": g, "dq": None}, e, {}, len(q))
    dq = torch.stack([ref.dq(q[i], pts.double(), mode="tf32")[0] for i in range(len(q))])
    return (out["value_gap_m"] > VALUE_TOL and out["grad_gap"] > GRAD_TOL
            and dq_gap(ref, q, pts, dq) > DQ_TOL)


def test_query_grid_takes_the_trilinear_union_and_agrees_with_the_reference(arm):
    robot, ref, q = arm
    before = profiling.COUNTERS.copy()
    v, g, dq = differentiated(lambda qq: robot.query_grid(qq, GRID, GRID_RES), q)
    counted = profiling.COUNTERS - before
    assert counted["path.grid_coherent"] == 1 and counted["path.coherent_trilinear"] == 1
    assert counted["path.link_trilinear"] == 0
    pts = grid_points()
    out, e, qs, ps = value_gaps(ref, q, pts, v.reshape(len(q), -1), g.reshape(len(q), -1, 3))
    assert out["value_gap_m"] < VALUE_TOL and out["grad_gap"] < GRAD_TOL, out
    assert e["g_ok"].float().mean() > 0.9
    assert torch.isfinite(dq).all() and dq_gap(ref, q, pts, dq) < DQ_TOL
    assert control_holds_no_tolerance(ref, q, pts, qs, ps, e)


def test_query_reads_each_link_by_its_corners_and_agrees_with_the_reference(arm):
    robot, ref, q = arm
    pts = scattered_points()
    before = profiling.COUNTERS.copy()
    v, g, dq = differentiated(lambda qq: robot.query(qq, pts), q)
    assert (profiling.COUNTERS - before)["path.link_trilinear"] == 8
    out, e, qs, ps = value_gaps(ref, q, pts, v, g)
    assert out["value_gap_m"] < VALUE_TOL and out["grad_gap"] < GRAD_TOL, out
    assert dq_gap(ref, q, pts, dq) < DQ_TOL
    assert control_holds_no_tolerance(ref, q, pts, qs, ps, e)
