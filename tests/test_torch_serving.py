"""The port's served robot query (``utils.serving`` on ``torch.export``)
against its live query and the JAX package's served query (CPU): export
and load through the two files only, the tables in the sidecar and not the
artifact, the kernels as registered op nodes, and the analytic backward
kept through export -> save -> load for cached, exact and narrow-band
links."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu.utils import serving as jserving
from pytorch_volumetric_tpu.utils.robots import make_serial_arm
from pytorch_volumetric_tpu_torch import state
from pytorch_volumetric_tpu_torch.ops.closest_point import closest_point_sweep
from pytorch_volumetric_tpu_torch.ops.narrow_band_cuda import grid_lists, narrow_band_query_op
from pytorch_volumetric_tpu_torch.ops.straight_through import (
    straight_through, tile_winner_straight_through)
from pytorch_volumetric_tpu_torch.utils import serving
from torch_cpu_guard import warm_sqrt

warm_sqrt()

N_CONFIGS, N_POINTS = 4, 64
NB_BUILD = dict(cell_res=0.02, band=0.06, padding=0.1)
QR = np.array([[-0.3, 0.1], [0.0, 0.0], [-0.1, 0.3]])


def _cached_factory(d, resolution=0.05):
    return dict(resolution=resolution, padding=0.2, cache_path=os.path.join(d, "cache.npz"))


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("arm"))
    urdf, end = make_serial_arm(d, num_joints=3, segments=6, rings=2)
    return d, open(urdf).read(), end


def _port_robot(arm, link_sdf_cls):
    d, text, end = arm
    return pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device="cpu"), path_prefix=d,
                       link_sdf_cls=link_sdf_cls)


@pytest.fixture(scope="module")
def cached(arm, tmp_path_factory):
    """The cached arm in both packages, the port's links on the JAX
    package's tables."""
    d, text, end = arm
    rj = pv.RobotSDF(pv.build_serial_chain_from_urdf(text, end), path_prefix=d,
                     link_sdf_cls=pv.cache_link_sdf_factory(
                         **_cached_factory(str(tmp_path_factory.mktemp("jc")))))
    rt = _port_robot(arm, pt.cache_link_sdf_factory(
        **_cached_factory(str(tmp_path_factory.mktemp("tc")))))
    state.load_robot_tables(rt, [
        {"val": np.asarray(s.voxels.raw_data), "grad": np.asarray(s.voxels_grad),
         "surface_bb": np.asarray(s.surface_bounding_box())} for s in rj.sdf.sdfs])
    return rj, rt


@pytest.fixture(scope="module")
def served(arm, cached, tmp_path_factory):
    """Each arm exported once and loaded on the CPU: ``name -> (robot,
    path, query)``."""
    robots = {"cached": cached[1], "exact": _port_robot(arm, pt.MeshSDF),
              "narrow_band": _port_robot(arm, pt.narrow_band_link_sdf_factory(**NB_BUILD))}
    d = tmp_path_factory.mktemp("served")
    out = {}
    for name, robot in robots.items():
        path = str(d / f"{name}.pt2")
        serving.export_robot_query(robot, N_CONFIGS, N_POINTS, path)
        out[name] = (robot, path, serving.load_robot_query(path, device="cpu"))
    return out


def _inputs(seed, A=N_CONFIGS, P=N_POINTS, scale=0.5):
    """Configurations, and points around the arm (inside and outside)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-0.3, 0.3, (P, 2)), rng.uniform(-0.1, 0.7, (P, 1))],
                         axis=1)
    return rng.uniform(-scale, scale, (A, 3)).astype(np.float32), pts.astype(np.float32)


def _value_grad_dq(query, q, pts):
    """``(val, grad, d(v.sum() + g.sum())/dq, d v.sum()/dpts)`` as numpy."""
    qq = torch.as_tensor(q).requires_grad_(True)
    pp = torch.as_tensor(pts).requires_grad_(True)
    v, g = query(qq, pp)
    dq, dp = torch.autograd.grad(v.sum() + g.sum(), (qq, pp))
    return [x.detach().numpy() for x in (v, g, dq, dp)]


def test_export_load_roundtrip(served):
    """The loaded program equals the live query and the configured robot."""
    robot, _, query = served["cached"]
    q, pts = _inputs(0, scale=1.0)
    v, g = query(q, pts)
    assert v.shape == (N_CONFIGS, N_POINTS) and g.shape == (N_CONFIGS, N_POINTS, 3)
    vq, gq = robot.query(q, pts)
    assert torch.equal(v, vq) and torch.equal(g, gq)
    robot.set_joint_configuration(q)
    v_ref, g_ref = robot(pts)
    np.testing.assert_allclose(v.numpy(), v_ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), atol=1e-6)


def test_artifact_excludes_tables(served, arm, tmp_path):
    """The tables live in the sidecar: a grid twice as fine (over 4x the
    table bytes) leaves the artifact's size unchanged."""
    def table_bytes(p):
        with np.load(p + serving.TABLES_SUFFIX) as d:
            return sum(d[k].nbytes for k in d.files if k != "n_leaves")

    _, path, _ = served["cached"]
    fine = _port_robot(arm, pt.cache_link_sdf_factory(**_cached_factory(str(tmp_path), 0.025)))
    path_fine = str(tmp_path / "fine.pt2")
    serving.export_robot_query(fine, N_CONFIGS, N_POINTS, path_fine)
    assert table_bytes(path_fine) > 4 * table_bytes(path)
    a0, a1 = os.path.getsize(path), os.path.getsize(path_fine)
    assert abs(a1 - a0) < 0.2 * a0, (a0, a1)
    # every table byte is in the sidecar, none in the artifact
    assert a1 < table_bytes(path_fine)


@pytest.mark.parametrize("name", ["cached", "exact", "narrow_band"])
def test_loaded_artifact_differentiable(served, name):
    """d/dq and d/dpts through the loaded program equal the live query's:
    the straight-through ops keep their backward through export -> save ->
    load (an inlined autograd.Function would leave none)."""
    robot, _, query = served[name]
    q, pts = _inputs(2)
    loaded = _value_grad_dq(query, q, pts)
    live = _value_grad_dq(robot.query, q, pts)
    for a, b in zip(loaded, live):
        np.testing.assert_array_equal(a, b)
    assert np.abs(loaded[2]).max() > 1e-3, "no derivative reached the joint angles"


@pytest.mark.parametrize("name,op,plain_marker", [
    ("exact", "pvt.closest_point_sweep.default", "aten.atan2"),
    ("narrow_band", "pvt.narrow_band_query.default", "aten.nonzero"),
])
def test_exported_graph_holds_kernel_ops(served, name, op, plain_marker):
    """The kernel is one op node per link; the plain version (the sweep's
    solid angles, the narrow band's in-band selection) is not traced in."""
    robot, path, _ = served[name]
    program = torch.export.load(path)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(op) == len(robot.sdf.sdfs)
    assert targets.count("pvt.straight_through.default") == len(robot.sdf.sdfs)
    assert not [t for t in targets if plain_marker in t or "argmin" in t]


def test_fused_query_fn_matches_query_and_jax(cached):
    """``fused_query_fn`` is ``query``'s program, and agrees with the JAX
    package's on the same tables."""
    rj, rt = cached
    q, pts = _inputs(3, A=5, P=200, scale=1.0)
    fn, leaves = rt.fused_query_fn()
    assert len(leaves) == len(rt.sdf.sdfs)
    v, g = fn(torch.as_tensor(q), torch.as_tensor(pts), *leaves)
    vq, gq = rt.query(q, pts)
    assert torch.equal(v, vq) and torch.equal(g, gq)
    fnj, leaves_j = rj.fused_query_fn()
    vj, gj = jax.jit(fnj)(jnp.asarray(q), jnp.asarray(pts), *leaves_j)
    assert (np.asarray(vj) < 0).any() and (np.asarray(vj) > 0).any()
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=0, atol=1e-5)


def test_loaded_artifact_matches_jax_artifact(served, cached, tmp_path):
    """The port's loaded program against the JAX package's loaded artifact
    (``jax.export``, CPU) on the same inputs and tables: values, gradients
    and d/dq."""
    rj, _ = cached
    path = str(tmp_path / "jax_arm.bin")
    jserving.export_robot_query(rj, n_configs=N_CONFIGS, n_points=N_POINTS, path=path)
    jquery = jserving.load_robot_query(path)
    _, _, query = served["cached"]
    q, pts = _inputs(4)
    v, g, dq, _ = _value_grad_dq(query, q, pts)
    vj, gj = jquery(jnp.asarray(q), jnp.asarray(pts))
    dqj = jax.grad(lambda qq: sum(x.sum() for x in jquery(qq, jnp.asarray(pts))))(jnp.asarray(q))
    np.testing.assert_allclose(v, np.asarray(vj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g, np.asarray(gj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dq, np.asarray(dqj), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(dqj).max())))


def test_export_grid_query_roundtrip(cached, tmp_path):
    """The grid export reproduces ``query_grid`` exactly (values,
    gradients, d/dq, values-only) and refuses a grid too coarse for the
    cache."""
    _, robot = cached
    path = str(tmp_path / "grid.pt2")
    serving.export_robot_grid_query(robot, n_configs=3, query_range=QR, resolution=0.025,
                                    path=path)
    query = serving.load_robot_grid_query(path, device="cpu")
    q = torch.as_tensor(_inputs(0, A=3)[0])
    v, g, dq = _grid_value_grad_dq(query, q)
    vr, gr, dqr = _grid_value_grad_dq(lambda qq: robot.query_grid(qq, QR, 0.025), q)
    assert v.shape == vr.shape == (3, 17, 1, 17) and g.shape == gr.shape
    assert torch.equal(v, vr) and torch.equal(g, gr) and torch.equal(dq, dqr)
    assert bool(torch.isfinite(dq).all()) and float(dq.abs().max()) > 1e-3

    path_v = str(tmp_path / "grid_v.pt2")
    serving.export_robot_grid_query(robot, n_configs=3, query_range=QR, resolution=0.025,
                                    path=path_v, values_only=True)
    assert torch.equal(serving.load_robot_grid_query(path_v, device="cpu")(q), v)
    with pytest.raises(ValueError, match="too coarse"):
        serving.export_robot_grid_query(robot, n_configs=3, query_range=QR, resolution=0.05,
                                        path=str(tmp_path / "x.pt2"))


def _grid_value_grad_dq(query, q):
    qq = q.clone().requires_grad_(True)
    v, g = query(qq)
    (dq,) = torch.autograd.grad(v.sum() + g.sum(), qq)
    return v.detach(), g.detach(), dq


def test_loader_runs_on_cuda_unless_asked(served):
    """A loader given no device takes CUDA; without a GPU it raises rather
    than run on the CPU."""
    _, path, _ = served["exact"]
    if torch.cuda.is_available():
        q, pts = _inputs(0)
        v, _ = serving.load_robot_query(path)(q, pts)
        assert v.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.load_robot_query(path)


def test_kernel_ops_pass_opcheck(served):
    """The two kernel ops' schemas and fake implementations hold against
    their CPU implementations (the plain versions) on the arms' own
    inputs."""
    robot = served["exact"][0]
    tri = robot.sdf.sdfs[1].raw_query_aux()[0]
    pts = torch.as_tensor(_inputs(5, P=100)[1])
    checks = ("test_schema", "test_faketensor")
    torch.library.opcheck(closest_point_sweep, (pts, tri, None, 2048, 512), test_utils=checks)
    nb_link = served["narrow_band"][0].sdf.sdfs[1]
    grid_f, grid_i = grid_lists(nb_link.tables.smalls)
    for with_slots in (False, True):
        torch.library.opcheck(narrow_band_query_op, (pts, *nb_link.tables.big, grid_f, grid_i,
                                                     1e-3, with_slots), test_utils=checks)


def test_straight_through_ops_pass_opcheck():
    """The straight-through ops: schema, fake implementation and
    registered autograd."""
    rng = np.random.default_rng(6)

    def t(*shape, grad=False):
        return torch.tensor(rng.normal(size=shape).astype(np.float32), requires_grad=grad)

    win = torch.as_tensor(rng.integers(0, 3, (2, 4, 5)))
    cases = [(straight_through, (t(7), t(7, 3), t(7, 3, grad=True))),
             (tile_winner_straight_through, (t(2, 4, 5), t(2, 4, 5, 3), win, t(2, 4, 5, 3),
                                             t(20, 3, grad=True), t(3, 2, 4, 4, grad=True),
                                             t(3, 2, 3, 3, grad=True)))]
    for op, args in cases:
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor",
                                                    "test_autograd_registration"))


def test_straight_through_keeps_every_bit():
    """The value passes through bit for bit (inf, -0.0, NaN), and its
    derivative is the analytic gradient."""
    val = torch.tensor([float("inf"), -0.0, float("nan"), 1.5])
    grad = torch.tensor([[1.0, 0, 0], [0, 1, 0], [0, 0, 1], [0.6, 0.8, 0]])
    pts = torch.tensor([[float("inf"), 0, 0], [0.0, 0, 0], [0, 0, 1], [1, 2, 3]],
                       requires_grad=True)
    out = straight_through(val, grad, pts)
    assert torch.equal(out.view(torch.int32)[[0, 1, 3]], val.view(torch.int32)[[0, 1, 3]])
    assert torch.isnan(out[2])
    (d,) = torch.autograd.grad(out[[0, 1, 3]].sum(), pts)
    assert torch.equal(d, grad * torch.tensor([1.0, 1, 0, 1])[:, None])


def test_visual_offset_transform_matches_jax(arm):
    """``Visual.offset_transform`` on the chain's device, equal to the JAX
    package's."""
    d, text, end = arm
    cj = pv.build_serial_chain_from_urdf(text, end)
    ct = pt.build_serial_chain_from_urdf(text, end, device="cpu")
    for name in ct.get_frame_names():
        for vt, vj in zip(ct.find_frame(name).link.visuals, cj.find_frame(name).link.visuals):
            m = vt.offset_transform().get_matrix()
            assert m.device.type == "cpu"
            np.testing.assert_array_equal(m.numpy(), np.asarray(vj.offset_transform().get_matrix()))
