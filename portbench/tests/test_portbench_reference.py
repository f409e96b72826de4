"""The plain reference against the program on the CPU at a tiny size, its
refusal of perturbed answers, the no-JAX rule, and the roofline arithmetic
on a case counted by hand."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness, judge, roofline, workload
from portbench.reference import Reference, tf32
from portbench.tests.tiny import tiny_base


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    """The tiny arm: the program's robot and the reference, from one set of
    files, and queries drawn here."""
    import pytorch_volumetric_tpu_torch as pt
    tmp = str(tmp_path_factory.mktemp("arm"))
    cfg = harness.load_config("arm7", tiny_base(tmp))
    assets = workload.write_robot(cfg, os.path.join(tmp, "robot"))
    cpu = torch.device("cpu")
    prog = harness.Program(cfg, assets, cpu, os.path.join(tmp, "c.npz"))
    g = torch.Generator().manual_seed(3)
    q = torch.tensor(cfg["home_q"]) + 0.3 * torch.randn(4, 7, generator=g)
    pts = torch.rand(500, 3, generator=g) * torch.tensor([1.5, 1.0, 1.0]) \
        + torch.tensor([-1.0, -0.5, -0.2])
    return prog.robot, Reference(cfg, assets, cpu), q, pts


def gaps(ref, q, pts, v, g):
    qs = q[:, None].expand(-1, len(pts), -1).reshape(-1, q.shape[1])
    ps = pts[None].expand(len(q), -1, -1).reshape(-1, 3).double()
    e = ref.expected(qs, ps)
    rec = {"k": 0, "v": v.reshape(-1), "g": g.reshape(-1, 3), "dq": None}
    return judge.call_gaps(rec, e, {}, len(q)), e


def test_reference_agrees_with_the_program(arm):
    robot, ref, q, pts = arm
    v, g = robot.query(q, pts)
    out, e = gaps(ref, q, pts, v, g)
    assert out["value_gap_m"] < 1e-6 and out["grad_gap"] < 1e-4
    assert e["g_ok"].float().mean() > 0.9
    qq = q.clone().requires_grad_(True)
    v2, g2 = robot.query(qq, pts)
    (dq,) = torch.autograd.grad(v2.sum() + g2.sum(), qq)
    for i in range(len(q)):
        ref_dq, slack = ref.dq(q[i], pts.double())
        gap = torch.clamp((dq[i].double() - ref_dq).abs() - slack, min=0)
        assert float(gap.max() / ref_dq.abs().max()) < 1e-5


def test_reference_rejects_perturbed_answers(arm):
    robot, ref, q, pts = arm
    v, g = robot.query(q, pts)
    assert gaps(ref, q, pts, v + 1e-3, g)[0]["value_gap_m"] > 5e-4
    g2 = g.clone()
    g2[..., 0] = -g2[..., 0]
    assert gaps(ref, q, pts, v, g2)[0]["grad_gap"] > 0.1
    v3 = v.clone()
    v3[0, 0] = float("nan")
    assert gaps(ref, q, pts, v3, g)[0]["value_gap_m"] == float("inf")


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -11 + 2 ** -14, 3.0, -1.0 - 2 ** -10])
    assert tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 3.0, -1.0 - 2 ** -10]


def test_roofline_counts_a_case_by_hand(tmp_path):
    """One link, one configuration at the origin, two points: one in the
    grid (one cell), one outside it."""
    cfg = {"name": "one", "robot": {"kind": "free_object", "object_name": "box",
                                    "mesh": {"kind": "cylinder", "radius": 0.1, "height": 0.2,
                                             "segments": 8}},
           "home_q": [0.0] * 6,
           "links": {"sdf": "cached", "resolution": 0.05, "padding": 0.1,
                     "interpolation": "nearest", "out_of_bounds": "bounding_box"}}
    assets = workload.write_robot(cfg, str(tmp_path))
    ref = Reference(cfg, assets, torch.device("cpu"))
    q = torch.zeros(1, 6)
    world = torch.tensor([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0], [0.001, 0.0, 0.0]],
                         dtype=torch.float64)
    w = roofline.lookup_work(ref, q, world, gradients=True)
    # two in-grid points share the cell at the origin
    assert w["cells"] == 1
    assert w["bytes"] == 12 * 3 + 48 * 1 + 1 * 16 + 3 * 16
    assert w["flops"] == 3 * (18 + 6 + 1) + 3 * 15
    least = roofline.least_seconds(w, "NVIDIA H100 80GB HBM3")
    assert least["bound"] == "bytes" and np.isclose(least["seconds"], w["bytes"] / 3.35e12)
    assert roofline.least_seconds(w, "another card") is None


def _top_levels(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=harness.REPO_DIR, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_the_harness_and_nothing_of_the_program_in_the_reference():
    tops = _top_levels("import portbench.run, portbench.harness, portbench.control, "
                       "portbench.trace\nimport pytorch_volumetric_tpu_torch")
    assert not tops & set(harness.FORBIDDEN)
    # the port's name begins with the JAX package's: names compare whole
    assert "pytorch_volumetric_tpu_torch" in tops
    assert "pytorch_volumetric_tpu" not in tops
    ref_tops = _top_levels("import portbench.reference, portbench.judge, portbench.roofline, "
                           "portbench.workload")
    assert not ref_tops & (set(harness.FORBIDDEN) | {"pytorch_volumetric_tpu_torch"})
