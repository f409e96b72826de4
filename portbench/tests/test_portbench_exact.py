"""The exact-link cell (``arm7exact.points15k.fwd``) on the CPU at the tiny
sizes of ``tiny.py``: the port's exact robot against the ``mesh.exact``
reference, planted faults and the control reading not correct, the cell's
files found by name, and the exact floor's arithmetic on a case counted by
hand."""

import os

import numpy as np
import pytest
import torch

from portbench import control, exact_work, harness, judge, plugins, roofline, workload
from portbench.reference import Reference, link_kind
from portbench.tests.tiny import SEED, tiny_base

CELL = "arm7exact.points15k.fwd"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny_base(str(tmp_path_factory.mktemp("portbench")))


@pytest.fixture(scope="module")
def arm(base, tmp_path_factory):
    """The exact arm's files, the reference from them, and configurations
    and points drawn here."""
    tmp = str(tmp_path_factory.mktemp("exact"))
    cfg = harness.load_config("arm7exact", base)
    assets = workload.write_robot(cfg, os.path.join(tmp, "robot"), base)
    g = torch.Generator().manual_seed(5)
    q = torch.tensor(cfg["home_q"]) + 0.3 * torch.randn(4, 7, generator=g)
    pts = torch.rand(400, 3, generator=g) * torch.tensor([1.5, 1.0, 1.0]) \
        + torch.tensor([-1.0, -0.5, -0.2])
    return cfg, assets, Reference(cfg, assets, CPU, base), q, pts


def program(cfg, assets, base):
    return harness.Program(cfg, assets, CPU, "unused.npz", base).robot


def gaps(ref, q, pts, v, g):
    """The judge's numbers for the answers ``v [C, N]``, ``g [C, N, 3]`` of
    every configuration at every point."""
    qs = q[:, None].expand(-1, len(pts), -1).reshape(-1, q.shape[1])
    ps = pts[None].expand(len(q), -1, -1).reshape(-1, 3).double()
    rec = {"k": 0, "v": v.reshape(-1), "g": g.reshape(-1, 3), "dq": None}
    return judge.call_gaps(rec, ref.expected(qs, ps), {}, len(q))


def test_the_cell_and_its_kind_are_found_by_name():
    import pytorch_volumetric_tpu_torch as pt
    b = harness.load_benchmark()
    cell = harness.find_cell(b, CELL)
    cfg, mix = harness.load_config(cell["config"]), harness.load_mix(cell["traffic"])
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("arm7exact", "points15k.fwd", 1)
    assert link_kind(cfg["links"]) == "mesh.exact" and cfg["reduced"] == []
    assert plugins.load("links", "mesh.exact").program_link_cls(pt, cfg["links"], "x") is pt.MeshSDF
    assert mix["entry"] == "query" and mix["backward"] is False
    assert set(harness.load_limits(CELL)) == {"value_gap_m", "grad_gap"}
    assert {m["name"] for m in harness.cell_metrics(b, CELL, False)} == {"queries_per_s",
                                                                         "setup_s"}
    assert {m["name"] for m in harness.cell_metrics(b, CELL, True)} == {
        "exact.device_ms_per_call", "exact_roofline"}
    for name in ("exact.device_ms_per_call", "exact_roofline"):
        assert callable(harness.load_reader(name))


def test_the_exact_robot_agrees_with_the_reference(arm, base):
    cfg, assets, ref, q, pts = arm
    robot = program(cfg, assets, base)
    with torch.no_grad():
        v, g = robot.query(q, pts)
    out = gaps(ref, q, pts, v, g)
    limits = harness.load_limits(CELL)
    assert all(out[k] <= limits[k] for k in limits), out
    assert out["value_gap_m"] < 1e-6 and out["grad_gap"] < 1e-3


def test_a_dropped_face_is_caught(arm, base, monkeypatch):
    """The program's base link loses its first face; points 5 mm off that
    face, on both sides, read far from the reference."""
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.mesh import MeshScene
    cfg, assets, ref, q, _ = arm
    built = []

    class Dropped(pt.MeshSDF):
        def __init__(self, obj_factory, **kwargs):
            if not built:
                s = obj_factory.scene
                obj_factory._scene = MeshScene(s.tri[1:].contiguous(), s.normals[1:].contiguous(),
                                               s.num_faces - 1)
            built.append(1)
            super().__init__(obj_factory, **kwargs)

    monkeypatch.setattr(pt, "MeshSDF", Dropped)
    robot = program(cfg, assets, base)
    tri, n = ref.tables[0].tri[0], ref.tables[0].normals[0]
    near = tri.mean(0) + torch.tensor([[0.005], [-0.005]], dtype=torch.float64) * n
    _, l2o = ref.link_poses(q[:1])
    pts = Reference.apply(l2o[0, 0], near).float()
    with torch.no_grad():
        v, g = robot.query(q[:1], pts)
    assert gaps(ref, q[:1], pts, v, g)["value_gap_m"] > 1e-3


def test_a_flipped_sign_makes_the_run_incorrect(base, monkeypatch):
    from pytorch_volumetric_tpu_torch import sdf

    signed = sdf.signed_closest_query

    def flipped(*args, **kwargs):
        closest, val, grad, normal = signed(*args, **kwargs)
        return closest, -val, -grad, normal

    monkeypatch.setattr(sdf, "signed_closest_query", flipped)
    line = harness.run_cell(CELL, SEED, 0.3, False, device="cpu", base=base)
    assert line["correct"] is False and line["failed"] > 0
    assert line["checks"]["value_gap_m"]["value"] > 1e-3


def test_a_run_is_correct(base):
    line = harness.run_cell(CELL, SEED, 0.3, False, device="cpu", base=base)
    line.pop("_run")
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"queries_per_s", "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0


def test_the_control_fails(base):
    out = control.run_control(CELL, SEED, "cpu", base=base)
    assert out["correct"] is False, out["checks"]


def test_the_exact_floor_counts_a_case_by_hand(arm):
    """Two configurations over three points: 8 links (the base's mesh of 80
    faces serves one, the capsule's of 280 seven), counted from what the
    lookup roofline asks each link."""
    _, _, ref, q, pts = arm
    exact_work.ASKS.clear()
    roofline.lookup_work(ref, q[:2], pts[:3].double(), gradients=True)
    assert len(exact_work.ASKS) == 8 * 2
    w = exact_work.call_work(exact_work.ASKS, 2 * 3)
    assert (w["configurations"], w["points"], w["links"]) == (2, 3, 8)
    assert w["bytes"] == 12 * 3 + 16 * 6 + 36 * (80 + 280) + 48 * 8 * 2
    assert w["flops"] == 6 * 8 * (18 + 73 + 1) + 6 * 15
    assert w["brute_force_pairs"] == 6 * (80 + 7 * 280)
    # two counted calls give the same work a call
    roofline.lookup_work(ref, q[2:], pts[:3].double(), gradients=True)
    assert exact_work.call_work(exact_work.ASKS, 6) == w
    assert exact_work.call_work(exact_work.ASKS, 5) is None
    least = roofline.least_seconds(w, "NVIDIA H100 80GB HBM3")
    assert least["bound"] == "bytes"
    assert np.isclose(least["seconds"], w["bytes"] / 3.35e12)


def test_the_k1_reader_sums_the_sweep_kernels_by_name():
    read = harness.load_reader("exact.device_ms_per_call")
    ops = [["void (anonymous namespace)::closest_point_sweep_kernel<true>(float const*)", 0.08],
           ["void closest_point_sweep_mma_kernel(float const*)", 1.0],
           ["void at::native::elementwise_kernel", 0.5]]
    run = {"plain": {"calls": 4, "device_ops": ops}}
    assert np.isclose(read(run), 0.08 / 4 * 1e3)
    assert read({"plain": {"calls": 4, "device_ops": ops[1:]}}) is None
    assert read({"plain": None}) is None


def test_a_labelled_sweep_finds_its_key_where_the_table_is_keyed_by_function(monkeypatch):
    """A program whose sweep looks its launch counter up by wrapper function:
    the labelled window's copy of the wrapper finds its original's key once
    the link kind has built the class, and the originals keep theirs."""
    import sys
    import types
    from portbench import trace

    def sweep(points):
        return points

    names = ("stand_in_port", "stand_in_port.ops", "stand_in_port.ops.closest_point")
    mods = [types.ModuleType(n) for n in names]
    for n, m in zip(names, mods):
        monkeypatch.setitem(sys.modules, n, m)
    mods[0].MeshSDF = object
    mods[2].LAUNCHES = {sweep: "kernel.closest_point_sweep"}
    kind = plugins.load("links", "mesh.exact")
    labelled = trace._annotate(sweep, "ops.closest_point.sweep")
    with pytest.raises(KeyError):
        mods[2].LAUNCHES[labelled]
    assert kind.program_link_cls(mods[0], {}, "x") is object
    assert mods[2].LAUNCHES[labelled] == mods[2].LAUNCHES[sweep] == "kernel.closest_point_sweep"
    with pytest.raises(KeyError):
        mods[2].LAUNCHES[trace._annotate(len, "len")]
