"""The port's spans and counters (``utils/profiling``) on the CPU: the
``pvt.*`` spans at the robot query's layer boundaries and how they nest,
their cost with no profiler running, the path and kernel counters, and the
benchmark's reading of the spans (``portbench/program_trace.py``): host
self times, the backward's layers, and an export that holds no span."""

import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import pytorch_volumetric_tpu_torch as pt
from portbench import program_trace
from portbench.trace import BACKWARD, CALL, WINDOW
from pytorch_volumetric_tpu_torch.utils import profiling
from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm
from torch_cpu_guard import warm_sqrt

warm_sqrt()

CPU = torch.device("cpu")
GRID = np.array([[-0.4, 0.2], [0.0, 0.0], [-0.1, 0.5]])
# the links cache at 0.04: a grid at 0.02 takes the coherent path, one at
# 0.03 (coarser than half the cache) the generic query
COHERENT, FALLBACK = 0.02, 0.03


def _arm(tmp_path_factory, interpolation="nearest"):
    d = str(tmp_path_factory.mktemp("arm"))
    urdf, end = make_serial_arm(d, num_joints=3, segments=8, rings=2)
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(open(urdf).read(), end, device=CPU),
                        path_prefix=d, link_sdf_cls=pt.cache_link_sdf_factory(
                            resolution=0.04, padding=0.3, interpolation=interpolation,
                            cache_path=str(tmp_path_factory.mktemp("cache") / "c.npz")))
    q = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (3, 3)).astype(np.float32))
    return robot, q


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    return _arm(tmp_path_factory)


@pytest.fixture(scope="module")
def tri_arm(tmp_path_factory):
    """The arm on trilinear caches: its grid takes the trilinear union."""
    return _arm(tmp_path_factory, "trilinear")


CALLS = {
    "query": lambda robot, q: robot.query(
        q, torch.as_tensor(np.random.default_rng(1).uniform(-0.4, 0.4, (50, 3)),
                           dtype=torch.float32)),
    "query_grid": lambda robot, q: robot.query_grid(q, GRID, COHERENT),
    "query_grid_fallback": lambda robot, q: robot.query_grid(q, GRID, FALLBACK),
}
# the spans each call opens, each with its enclosing program span
NESTING = {
    "query": {("pvt.query", None), ("pvt.fk", "pvt.query"), ("pvt.lookup", "pvt.query")},
    "query_grid": {("pvt.query_grid", None), ("pvt.fk", "pvt.query_grid"),
                   ("pvt.lookup", "pvt.query_grid")},
    "query_grid_fallback": {("pvt.query_grid", None), ("pvt.query", "pvt.query_grid"),
                            ("pvt.fk", "pvt.query"), ("pvt.lookup", "pvt.query")},
}


def _traced(fn, wrt=None):
    """A CPU trace of ``fn()`` inside the benchmark's window and call spans
    (and, given ``wrt``, d(v.sum() + g.sum())/d wrt in its span)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW), record_function(CALL):
            out = fn()
            if wrt is not None:
                with record_function(BACKWARD):
                    torch.autograd.grad(out[0].sum() + out[1].sum(), wrt)
    return prof


def _parent_span(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("pvt."):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.mark.parametrize("call", sorted(CALLS))
def test_spans_nest_at_the_layer_boundaries(arm, call):
    robot, q = arm
    prof = _traced(lambda: CALLS[call](robot, q))
    found = {(e.name, _parent_span(e)) for e in prof.events() if e.name.startswith("pvt.")}
    assert found == NESTING[call]


def test_spans_cost_one_check_without_a_profiler(arm, monkeypatch):
    """With no profiler running, no span enters ``record_function``, and
    every span is the one shared no-op."""
    robot, q = arm

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for call in CALLS.values():
        call(robot, q)
    assert profiling.span("pvt.fk") is profiling.span("pvt.lookup")
    with pytest.raises(AssertionError):
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.span("pvt.fk")


@pytest.mark.parametrize("resolution,path,branch", [
    (COHERENT, "path.grid_coherent", "path.coherent_tile_union"),
    (FALLBACK, "path.grid_fallback", None)])
def test_query_grid_counts_its_path(arm, resolution, path, branch):
    robot, q = arm
    before = profiling.COUNTERS.copy()
    for values_only in (False, True):
        robot.query_grid(q, GRID, resolution, values_only=values_only)
    counted = profiling.COUNTERS - before
    want = {path: 2, "path.fk_plain": 2}  # FK's chain walk: CPU tensors
    if branch:
        want[branch] = 2
    assert dict(counted) == want


def test_the_fallback_logs_once_per_grid(arm, caplog):
    robot, q = arm
    grid = GRID + 0.01  # a grid no other test asked for
    with caplog.at_level(logging.INFO, logger="pytorch_volumetric_tpu_torch.model_to_sdf"):
        for _ in range(3):
            robot.query_grid(q, grid, FALLBACK)
    assert sum("generic query path" in r.getMessage() for r in caplog.records) == 1


def test_the_fallback_builds_its_grid_once(arm, monkeypatch):
    """The fallback keeps its grid's points: a second call builds none."""
    from pytorch_volumetric_tpu_torch import model_to_sdf
    robot, q = arm
    grid = GRID + 0.02  # a grid no other test asked for
    built = []
    build = model_to_sdf.get_coordinates_and_points_in_grid

    def counted(*args, **kwargs):
        built.append(kwargs.get("get_points", True))
        return build(*args, **kwargs)

    monkeypatch.setattr(model_to_sdf, "get_coordinates_and_points_in_grid", counted)
    first = robot.query_grid(q, grid, FALLBACK)
    second = robot.query_grid(q, grid, FALLBACK)
    assert built.count(True) == 1
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.fixture(scope="module")
def balls(tmp_path_factory):
    """Two cached spheres of each interpolation."""
    d = tmp_path_factory.mktemp("balls")
    return {(interp, i): pt.CachedSDF(f"{interp}{i}", 0.05, np.array([[-0.5, 0.5]] * 3),
                                      pt.SphereSDF(0.3, device=CPU), interpolation=interp,
                                      cache_path=str(d / f"{interp}{i}.npz"))
            for interp in ("nearest", "trilinear") for i in range(2)}


# the children of each composition by name, and the branches its coherent
# query counts; every route but the two unions writes link-frame points
# (path.link_points), and so does a generic child beside a union; a
# trilinear cache on the generic sub-path counts path.link_trilinear
LINKS = {"path.link_points": 1}
TRILINEAR_LINK = {"path.link_trilinear": 1}
BRANCHES = {
    "single": ([("nearest", 0)], {"path.coherent_single": 1, **LINKS}),
    "tile_union": ([("nearest", 0), ("nearest", 1)], {"path.coherent_tile_union": 1}),
    "trilinear": ([("trilinear", 0)], {"path.coherent_trilinear": 1, **LINKS}),
    "trilinear_union": ([("trilinear", 0), ("trilinear", 1)], {"path.coherent_trilinear": 1}),
    "generic": (["sphere", "box"], {"path.coherent_generic": 1, **LINKS}),
    "mixed": (["box", ("nearest", 0)],
              {"path.coherent_single": 1, "path.coherent_generic": 1, **LINKS}),
    "mixed_union": (["box", ("nearest", 0), ("nearest", 1)],
                    {"path.coherent_tile_union": 1, "path.coherent_generic": 1, **LINKS}),
    # a trilinear cache beside a nearest one, or alone beside a primitive: generic
    "mixed_interp": ([("trilinear", 0), ("nearest", 0)],
                     {"path.coherent_single": 1, "path.coherent_generic": 1, **LINKS,
                      **TRILINEAR_LINK}),
    "trilinear_and_box": ([("trilinear", 0), "box"],
                          {"path.coherent_generic": 1, **LINKS, **TRILINEAR_LINK}),
}
# the counter of each route of sdf._coherent_plan
ROUTE_COUNTERS = {"single": "path.coherent_single", "tile_union": "path.coherent_tile_union",
                  "trilinear": "path.coherent_trilinear",
                  "trilinear_union": "path.coherent_trilinear"}


def _branch_children(balls, name):
    primitives = {"sphere": pt.SphereSDF(0.3, device=CPU),
                  "box": pt.BoxSDF((0.2, 0.3, 0.4), device=CPU)}
    return tuple(primitives[k] if isinstance(k, str) else balls[k] for k in BRANCHES[name][0])


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_the_coherent_query_counts_its_branches(balls, name):
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    children = _branch_children(balls, name)
    m = torch.eye(4).repeat(len(children), 1, 1)
    pts, _ = pt.get_coherent_grid_points(0.025, np.array([[-0.2, 0.2], [0.0, 0.0], [-0.2, 0.2]]),
                                         device=CPU)
    before = profiling.COUNTERS.copy()
    tsdf.compose_query_coherent(children, m, m, 1, pts)
    assert dict(profiling.COUNTERS - before) == BRANCHES[name][1]


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_the_coherent_plan_routes_as_the_counters_say(balls, name):
    """``sdf._coherent_plan`` picks the route whose counter the query
    counts, puts every child on the brick route or the generic sub-path,
    and the three public helpers read the same plan."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    children = _branch_children(balls, name)
    plan = tsdf._coherent_plan(children)
    counted = {ROUTE_COUNTERS.get(plan.route), "path.coherent_generic" if plan.generic else None}
    assert counted - {None} == set(BRANCHES[name][1]) - set(LINKS) - set(TRILINEAR_LINK)
    assert sorted(plan.bricks + plan.generic) == list(range(len(children)))
    assert all(isinstance(children[i], pt.CachedSDF) for i in plan.bricks)
    tables = tsdf.coherent_fast_tables(children)
    assert len(tables) == len(plan.bricks)
    if plan.route is not None:
        need = tsdf._ROUTE_BRICKS[plan.route][2]
        assert all(getattr(t, need) is not None for t in tables)
    assert tsdf.coherent_min_cache_resolution(children) == plan.min_res == (
        0.05 if plan.bricks else None)
    assert len(tsdf.coherent_generic_aux(children)) == len(plan.generic)


# the arm's cases keep the ids they had before the trilinear arm's
@pytest.mark.parametrize("fixture,values_only",
                         [("arm", False), ("arm", True), ("tri_arm", False), ("tri_arm", True)],
                         ids=["False", "True", "tri_arm-False", "tri_arm-True"])
def test_the_arm_grid_writes_no_link_points(request, fixture, values_only):
    """The arm's grid query takes the nearest union, or on trilinear caches
    the trilinear union, whose kernel forms the link-frame points itself:
    ``path.link_points`` stays 0, forward and values only."""
    robot, q = request.getfixturevalue(fixture)
    route = {"arm": "path.coherent_tile_union", "tri_arm": "path.coherent_trilinear"}[fixture]
    before = profiling.COUNTERS.copy()
    robot.query_grid(q, GRID, COHERENT, values_only=values_only)
    counted = profiling.COUNTERS - before
    assert counted[route] == 1 and counted["path.link_points"] == 0


@pytest.mark.parametrize("name", ["mixed_union", "mixed"])
def test_a_mixed_composition_equals_compose_query(balls, name):
    """Cached children beside a primitive (on the nearest union, or alone):
    the primitive's own link-frame points only, and the coherent query's
    values and gradients equal ``compose_query``'s bit for bit, its values
    only too, and its d/d transforms within float32 sums' reordering."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from pytorch_volumetric_tpu_torch import transforms as tfm
    children = _branch_children(balls, name)
    S, B = len(children), 2
    rng = np.random.default_rng(4)
    m = torch.eye(4).repeat(S * B, 1, 1)
    m[:, :3, 3] = torch.as_tensor(rng.uniform(-0.05, 0.05, (S * B, 3)), dtype=torch.float32)
    c, s_ = np.cos(0.4), np.sin(0.4)
    m[1::2, :2, :2] = torch.tensor([[c, -s_], [s_, c]], dtype=torch.float32)
    pts, _ = pt.get_coherent_grid_points(0.025, np.array([[-0.4, 0.4], [0.0, 0.0], [-0.4, 0.4]]),
                                         device=CPU)

    def grads(query):
        mm = m.clone().requires_grad_(True)
        v, g = query(mm)
        return v, g, torch.autograd.grad(v.sum() + g.sum(), mm)[0]

    raws = tuple(ch.raw_query for ch in children)
    v, g, dm = grads(lambda mm: tsdf.compose_query_coherent(children, mm, tfm.invert_tf(mm), B,
                                                             pts))
    vr, gr, dmr = grads(lambda mm: tsdf.compose_query(raws, mm, tfm.invert_tf(mm), B, pts))
    assert torch.equal(v, vr) and torch.equal(g, gr)
    vo = tsdf.compose_query_coherent(children, m, tfm.invert_tf(m), B, pts, values_only=True)
    assert torch.equal(vo, vr)
    assert torch.allclose(dm, dmr, rtol=1e-4, atol=1e-4)


def test_union_tables_without_gradient_bricks_are_refused(balls, monkeypatch):
    """A nearest union's tables without ``gbricks`` are malformed: the
    query raises before it transforms a point."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    children = _branch_children(balls, "tile_union")
    fast = tuple(t._replace(gbricks=None) for t in tsdf.coherent_fast_tables(children))
    m = torch.eye(4).repeat(len(children), 1, 1)
    pts, _ = pt.get_coherent_grid_points(0.025, np.array([[-0.2, 0.2], [0.0, 0.0], [-0.2, 0.2]]),
                                         device=CPU)

    def refuse(*args):
        raise AssertionError("transformed points before refusing the tables")

    monkeypatch.setattr(tsdf.tfm, "transform_points", refuse)
    for values_only in (False, True):
        with pytest.raises(ValueError, match="gbricks"):
            tsdf.compose_query_coherent(children, m, m, 1, pts, fast_tables=fast,
                                        values_only=values_only)


@pytest.fixture(scope="module")
def exact_arm(tmp_path_factory):
    """An arm of 8 links with RobotSDF's default link SDFs: exact meshes."""
    d = str(tmp_path_factory.mktemp("exact_arm"))
    urdf, end = make_serial_arm(d, num_joints=7, segments=8, rings=2)
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(open(urdf).read(), end, device=CPU),
                        path_prefix=d, device=CPU)
    q = torch.as_tensor(np.random.default_rng(2).uniform(-1, 1, (2, 7)).astype(np.float32))
    return robot, q


def test_exact_links_open_their_span_once_a_link(exact_arm):
    """Each exact link's query opens ``pvt.exact`` inside ``pvt.lookup``, and
    the benchmark's reader keeps it as a layer of its own."""
    robot, q = exact_arm
    prof = _traced(lambda: CALLS["query"](robot, q))
    spans = [(e.name, _parent_span(e)) for e in prof.events() if e.name.startswith("pvt.")]
    assert set(spans) == NESTING["query"] | {("pvt.exact", "pvt.lookup")}
    assert spans.count(("pvt.exact", "pvt.lookup")) == 8
    layers = program_trace.program_layers(prof)
    assert set(layers["host_self_s"]) == {"entry", "fk", "lookup", "pvt.exact", "outside"}
    assert sum(layers["host_self_s"].values()) == pytest.approx(layers["window_s"], rel=0.01)


@pytest.mark.parametrize("links,want", [("exact_arm", 8), ("arm", 0)])
def test_link_exact_counts_each_exact_link_a_call(request, links, want):
    robot, q = request.getfixturevalue(links)
    before = profiling.COUNTERS.copy()
    CALLS["query"](robot, q)
    assert (profiling.COUNTERS - before)["path.link_exact"] == want


def test_counters_add_up():
    before = profiling.COUNTERS["path.test_only"]
    profiling.count("path.test_only")
    profiling.count("path.test_only", 2)
    assert profiling.COUNTERS["path.test_only"] == before + 3
    del profiling.COUNTERS["path.test_only"]


@pytest.mark.parametrize("call", sorted(CALLS))
def test_host_self_times_sum_to_the_window(arm, call):
    robot, q = arm
    prof = _traced(lambda: CALLS[call](robot, q))
    layers = program_trace.program_layers(prof)
    self_s = layers["host_self_s"]
    assert set(self_s) == {"entry", "fk", "lookup", "outside"}
    assert all(s > 0 for s in self_s.values()), self_s
    assert sum(self_s.values()) == pytest.approx(layers["window_s"], rel=0.01)
    assert layers["calls"] == 1


@pytest.mark.parametrize("call", ["query", "query_grid"])
def test_backward_steps_take_their_forward_layer(arm, call):
    """The un-tiling gather's ``IndexBackward0`` belongs to the entry, FK's
    ``CosBackward0`` to FK and the benchmark's own ``SumBackward0`` to no
    layer; on the generic path there is no un-tiling gather."""
    robot, q = arm
    qq = q.clone().requires_grad_(True)
    prof = _traced(lambda: CALLS[call](robot, qq), wrt=qq)
    host = prof.events()
    forward = program_trace.forward_ops(host)
    found = {}
    for e in host:
        if e.name in ("IndexBackward0", "CosBackward0", "SumBackward0"):
            linked = program_trace.linked_forward(e.cpu_parent, forward)
            found.setdefault(e.name, set()).add(
                (linked.name,) + program_trace.op_layer(e, forward))
    want = {"CosBackward0": {("aten::cos", "backward", "fk")},
            "SumBackward0": {("aten::sum", "backward", "outside")}}
    if call == "query_grid":
        want["IndexBackward0"] = {("aten::index", "backward", "entry")}
    assert found == want


def test_a_renamed_span_is_a_layer_of_its_own(arm, monkeypatch):
    """A span renamed in the program reads as a new layer: FK's time leaves
    ``fk`` and does not move into the layer around it."""
    robot, q = arm
    span = profiling.span
    monkeypatch.setattr(profiling, "span", lambda name, sink=None: span(
        "pvt.forward_kinematics" if name == "pvt.fk" else name, sink))
    layers = program_trace.program_layers(_traced(lambda: CALLS["query_grid"](robot, q)))
    self_s = layers["host_self_s"]
    assert "fk" not in self_s and self_s["pvt.forward_kinematics"] > 0
    assert sum(self_s.values()) == pytest.approx(layers["window_s"], rel=0.01)


def test_an_export_holds_no_span(arm):
    """``torch.export`` of the fused query (as ``utils.serving`` exports
    it) traces with no profiler running: no profiler operator in the graph."""
    from pytorch_volumetric_tpu_torch.utils import serving
    robot, _ = arm
    fn, leaves = robot.fused_query_fn()
    inputs = (torch.zeros((2, len(robot.joint_names))), torch.zeros((16, 3)))
    with torch.enable_grad():
        program = torch.export.export(serving._Program(fn), inputs + tuple(leaves))
    targets = {str(n.target) for m in program.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes}
    assert any("pvt." in t for t in targets)  # the exported query's own ops
    assert not [t for t in targets if "profiler" in t or "record_function" in t]


@pytest.fixture(scope="module")
def trilinear_arm(tmp_path_factory):
    """The 3-joint arm (4 links) with trilinear caches: its grid takes the
    trilinear union, its points the generic query."""
    d = str(tmp_path_factory.mktemp("trilinear_arm"))
    urdf, end = make_serial_arm(d, num_joints=3, segments=8, rings=2)
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(open(urdf).read(), end, device=CPU),
                        path_prefix=d, link_sdf_cls=pt.cache_link_sdf_factory(
                            resolution=0.04, padding=0.3, interpolation="trilinear",
                            cache_path=str(tmp_path_factory.mktemp("cache") / "t.npz")))
    q = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (3, 3)).astype(np.float32))
    return robot, q


@pytest.mark.parametrize("call,spans", [("query_grid", 1), ("query", 4)])
def test_trilinear_links_open_their_span_in_the_lookup(trilinear_arm, call, spans):
    """The trilinear union (one span a call) and each trilinear link's
    generic query (one a link) open ``pvt.trilinear`` inside ``pvt.lookup``;
    the benchmark's reader keeps it as a layer of its own."""
    robot, q = trilinear_arm
    prof = _traced(lambda: CALLS[call](robot, q))
    found = [(e.name, _parent_span(e)) for e in prof.events() if e.name.startswith("pvt.")]
    assert set(found) == NESTING[call] | {("pvt.trilinear", "pvt.lookup")}
    assert found.count(("pvt.trilinear", "pvt.lookup")) == spans
    layers = program_trace.program_layers(prof)
    assert set(layers["host_self_s"]) == {"entry", "fk", "lookup", "pvt.trilinear", "outside"}
    assert layers["host_self_s"]["pvt.trilinear"] > 0
    assert sum(layers["host_self_s"].values()) == pytest.approx(layers["window_s"], rel=0.01)


@pytest.mark.parametrize("links,call,want", [
    ("trilinear_arm", "query", {"path.link_trilinear": 4}),
    ("trilinear_arm", "query_grid", {"path.link_trilinear": 0, "path.coherent_trilinear": 1}),
    ("arm", "query", {"path.link_trilinear": 0}),
    ("arm", "query_grid", {"path.link_trilinear": 0, "path.coherent_trilinear": 0})])
def test_link_trilinear_counts_each_trilinear_link_a_generic_call(request, links, call, want):
    robot, q = request.getfixturevalue(links)
    before = profiling.COUNTERS.copy()
    CALLS[call](robot, q)
    counted = profiling.COUNTERS - before
    assert {k: counted[k] for k in want} == want
