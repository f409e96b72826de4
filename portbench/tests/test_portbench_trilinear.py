"""The trilinear-link cell (``arm7tri.grid1m.fwdbwd``) on the CPU at the tiny
sizes of ``tiny.py`` (with the arm's cache settings there, resolution 0.1
and padding 0.2): the cell's files found by name, the ``cached.trilinear``
reference against the port's caches, a run correct and planted faults and
the control reading not correct, the lookup roofline's count of its cells,
and the cell's per-layer metrics, none of which reads the labelled
window's layer split."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import control, harness, plugins, roofline, workload
from portbench.reference import Reference, link_kind
from portbench.tests.tiny import SEED, tiny_base

CELL = "arm7tri.grid1m.fwdbwd"
CPU = torch.device("cpu")
# the cell's per-layer metrics: the trace's launches and idle share, the
# host's wait a call and the window's peak, none from ``summarise``'s
# ``layer_s``, which counts many of this route's kernels twice
PER_LAYER = {"entry.launches_per_call", "entry.host_ms_per_call", "device.idle_share",
             "device.peak_gb"}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The tiny files, ``arm7tri`` at the tiny arm's cache settings."""
    base = tiny_base(str(tmp_path_factory.mktemp("portbench")))
    path = os.path.join(base, "configs", "arm7tri.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["links"].update(resolution=0.1, padding=0.2)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return base


@pytest.fixture(scope="module")
def arm(base, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("trilinear"))
    cfg = harness.load_config("arm7tri", base)
    assets = workload.write_robot(cfg, os.path.join(tmp, "robot"), base)
    prog = harness.Program(cfg, assets, CPU, os.path.join(tmp, "c.npz"), base)
    return prog.robot, Reference(cfg, assets, CPU, base)


def run(base, seconds=0.3, trace=False):
    return harness.run_cell(CELL, SEED, seconds, trace, device="cpu", base=base)


def test_the_cell_and_its_kind_are_found_by_name():
    import pytorch_volumetric_tpu_torch as pt
    b = harness.load_benchmark()
    cell = harness.find_cell(b, CELL)
    cfg, mix = harness.load_config(cell["config"]), harness.load_mix(cell["traffic"])
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("arm7tri", "grid1m.fwdbwd", 1)
    assert link_kind(cfg["links"]) == "cached.trilinear" and cfg["reduced"] == []
    # arm7's robot and caches; only the interpolation differs
    arm7 = harness.load_config("arm7")
    assert {k: v for k, v in cfg["links"].items() if k != "interpolation"} == \
        {k: v for k, v in arm7["links"].items() if k != "interpolation"}
    assert cfg["robot"] == arm7["robot"] and cfg["home_q"] == arm7["home_q"]
    made = plugins.load("links", "cached.trilinear").program_link_cls(pt, cfg["links"], "x.npz")
    assert callable(made)
    assert mix["entry"] == "query_grid" and mix["backward"] is True
    assert set(harness.load_limits(CELL)) == {"value_gap_m", "grad_gap", "dq_gap"}
    assert {m["name"] for m in harness.cell_metrics(b, CELL, False)} == {"queries_per_s",
                                                                         "setup_s"}
    assert {m["name"] for m in harness.cell_metrics(b, CELL, True)} == PER_LAYER


def test_the_table_reads_the_ports_caches(arm):
    """Each link's lerp (the reference's exact corners) against the port's
    own link SDF at the same link-frame points, in and out of the grid."""
    robot, ref = arm
    g = torch.Generator().manual_seed(7)
    for link, table in zip(robot.sdf.sdfs, ref.tables):
        assert link.interpolation == "trilinear"
        bb = table.bb
        x = bb[:, 0] - 0.4 + torch.rand(3000, 3, generator=g, dtype=torch.float64) \
            * (bb[:, 1] - bb[:, 0] + 0.8)
        v, grad = link.raw_query(x.float())
        v_ref, g_ref = table.lookup(x.float().double(), "f32")
        inside = ((x - table.lo) * table.inv_res + 0.5).floor()
        inside = ((inside >= 0) & (inside < table.n)).all(-1)
        assert inside.any() and (~inside).any()
        assert torch.allclose(v.double(), v_ref, atol=1e-6)
        c = table.candidates(x.float().double())
        ok = ~c["gamb"]
        assert torch.allclose(grad.double()[ok], g_ref[ok], atol=1e-4)


def test_a_run_is_correct(base):
    line = run(base)
    line.pop("_run")
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"queries_per_s", "setup_s"}


def test_a_traced_run_reads_no_device_metric_on_the_cpu(base):
    line = run(base, trace=True)
    line.pop("_run")
    assert line["correct"] is True
    # the host's clock reads on the CPU too; the card's trace and peak do not
    assert set(line["metrics"]) == {"entry.host_ms_per_call"}


@pytest.mark.parametrize("fault", ["mirrored_weights", "nearest_corner"])
def test_a_planted_fault_makes_the_run_incorrect(base, fault, monkeypatch):
    """The program's corner weights mirrored (``w`` for ``1 - w``), or every
    corner's weight put on the nearest corner: a run reads not correct."""
    from pytorch_volumetric_tpu_torch import sdf
    weight = sdf._corner_weight

    def faulty(w, offs):
        if fault == "mirrored_weights":
            return weight(1.0 - w, offs)
        return weight(torch.round(w), offs)

    monkeypatch.setattr(sdf, "_corner_weight", faulty)
    line = run(base)
    assert line["correct"] is False and line["failed"] > 0
    assert line["checks"]["value_gap_m"]["value"] > 1e-3


def test_the_control_fails(base):
    out = control.run_control(CELL, SEED, "cpu", base=base)
    assert out["correct"] is False, out["checks"]


def test_the_lookup_roofline_counts_a_trilinear_case_by_hand(tmp_path):
    """One link, two configurations, three points: two in one cell of the
    grid, one outside it.  The cells are the union over the configurations
    of the in-grid points' 8 corners."""
    cfg = {"name": "one", "robot": {"kind": "free_object", "object_name": "box",
                                    "mesh": {"kind": "cylinder", "radius": 0.1, "height": 0.2,
                                             "segments": 8}},
           "home_q": [0.0] * 6,
           "links": {"sdf": "cached", "resolution": 0.05, "padding": 0.1,
                     "interpolation": "trilinear", "out_of_bounds": "bounding_box"}}
    assets = workload.write_robot(cfg, str(tmp_path))
    ref = Reference(cfg, assets, CPU)
    q = torch.zeros(2, 6)
    q[1, 0] = 0.05   # the second configuration moves the link by one cell in x
    world = torch.tensor([[0.001, 0.002, 0.003], [5.0, 0.0, 0.0], [0.004, 0.003, 0.002]],
                         dtype=torch.float64)
    x = world.float().double()
    assert ref.tables[0].cells_read(x).numel() == 2 * 8
    w = roofline.lookup_work(ref, q, world, gradients=True)
    # two cells, one a configuration, sharing a face of 4 corners
    assert w["cells"] == 12


def test_the_cells_metrics_read_no_layer_split():
    """A run whose labelled window's layer split is garbage reads the same:
    the cell's readers take the plain window's launches and busy time, the
    host's clock and the peak."""
    run = {"plain": {"calls": 8, "launches": 80000, "busy_s": 4.4, "window_s": 4.5},
           "host_call_s": [0.27, 0.26, 0.28], "window_peak_bytes": 28.7e9,
           "annotated": {"calls": 8, "layer_s": {"lookup": 4.0}}}
    garbled = dict(run, annotated={"calls": 8, "layer_s": {"lookup": 8.0, "backward": 0.0}})
    for name in PER_LAYER:
        read = harness.load_reader(name)
        assert read(run) is not None and read(run) == read(garbled), name
    assert harness.load_reader("entry.launches_per_call")(run) == 10000
    assert harness.load_reader("device.peak_gb")(run) == pytest.approx(28.7)
