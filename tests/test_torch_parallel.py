"""The port's ``parallel`` package against the JAX package's on the same
seeded inputs (CPU, gloo): at world size 1 in this process (a 1x1 mesh
against JAX's 4x2 mesh of the virtual CPU devices) the sharded robot
(exact and cached links), coherent, neural and SDF queries, the collision
step against optax, ``init_distributed`` and the collective audit; and in
a world of two processes (``torch_parallel_worker.py``) the 2x1 and 1x2
meshes, ``TriangleShardedMeshSDF`` on a 2-way triangle axis (1D and 2D)
and the collision step on 1x2, their blocks assembled here and held to
JAX's sharded functions on two devices.  Triangle and cache tables cross
with ``state``."""

import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu import mesh as jmesh
from pytorch_volumetric_tpu import parallel as jpar
from pytorch_volumetric_tpu.models import neural_sdf as jn
from pytorch_volumetric_tpu.utils.robots import make_serial_arm
from pytorch_volumetric_tpu_torch import parallel as tpar
from pytorch_volumetric_tpu_torch import state
from test_torch_coherent import _give_jax_bricks
from torch_cpu_guard import warm_sqrt
from torch_parallel_worker import ARM, MESHES
from torch.distributed.tensor import Replicate, Shard

warm_sqrt()

CPU = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
COHERENT_RANGE = np.array([[-0.4, 0.2], [0.0, 0.0], [-0.1, 0.5]])


def adam():
    return lambda ps: torch.optim.Adam(ps, lr=0.05)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _exact_tables(rj):
    return [{"tri": np.asarray(s.obj_factory.scene.tri),
             "normals": np.asarray(s.obj_factory.scene.normals)} for s in rj.sdf.sdfs]


def _arm_pair(d, text, end, link_j=None, link_t=None):
    kw_j = {} if link_j is None else {"link_sdf_cls": link_j}
    kw_t = {} if link_t is None else {"link_sdf_cls": link_t}
    rj = pv.RobotSDF(pv.build_serial_chain_from_urdf(text, end), path_prefix=d, **kw_j)
    rt = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device=CPU), path_prefix=d,
                     **kw_t)
    return rj, rt


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two-process run, started first so that it overlaps the tests of
    this process: ``(JAX exact arm, inputs, wrench factory, rank outputs,
    rank reports)`` once both ranks are done."""
    work = tmp_path_factory.mktemp("spawn")
    urdf, end = make_serial_arm(str(work / "jax_arm"), **ARM)
    rj = pv.RobotSDF(pv.build_serial_chain_from_urdf(open(urdf).read(), end),
                     path_prefix=str(work / "jax_arm"))
    wrench = str(work / "wrench.obj")
    jmesh.save_obj(jmesh.wrench_mesh(), wrench)
    fj = pv.MeshObjectFactory(wrench)
    rng = np.random.default_rng(0)
    inp = {"q": rng.uniform(-0.5, 0.5, (8, 3)).astype(np.float32),
           "pts": rng.uniform(-0.4, 0.4, (16, 3)).astype(np.float32),
           "q_step": rng.uniform(-0.3, 0.3, (4, 3)).astype(np.float32),
           "wrench_pts": rng.uniform(-0.2, 0.2, (256, 3)).astype(np.float32),
           "wrench_tri": np.asarray(fj.scene.tri), "wrench_normals": np.asarray(fj.scene.normals)}
    for i, t in enumerate(_exact_tables(rj)):
        inp[f"tri{i}"], inp[f"normals{i}"] = t["tri"], t["normals"]
    np.savez(work / "inputs.npz", **inp)
    with open(work / "wrench_factory.pkl", "wb") as f:
        pickle.dump(pt.MeshObjectFactory(wrench, device=CPU), f)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                               str(r), port, str(work)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=str(work))
             for r in range(2)]

    def results():
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300)[0])
            except subprocess.TimeoutExpired:
                for pp in procs:
                    pp.kill()
                raise
        reports = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} failed:\n{out}"
            line = [ln for ln in out.splitlines() if ln.startswith(f"DIST_OK {r} ")]
            assert line, out
            reports.append(json.loads(line[0].split(" ", 2)[2]))
        ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]
        return rj, inp, fj, ranks, reports

    yield results
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def world(spawned):
    """A world of one on an in-memory store (gloo), destroyed after this
    module, as test workers run other modules after it."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield tpar.make_device_mesh(device=CPU)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def exact_arms(tmp_path_factory):
    """The 3-joint arm of ``tests/test_parallel.py`` with exact links; the
    port's links hold the JAX package's triangles."""
    d = str(tmp_path_factory.mktemp("arm"))
    urdf, end = make_serial_arm(d, num_joints=3, link_length=0.2, segments=10, rings=3)
    rj, rt = _arm_pair(d, open(urdf).read(), end)
    state.load_robot_tables(rt, _exact_tables(rj))
    return rj, rt


@pytest.fixture(scope="module")
def cached_arms(tmp_path_factory):
    """The coherent test's arm with cached links (res 0.04, padding 0.3);
    the port's links hold the JAX package's grids, and the JAX caches get
    their brick tables from the numpy build of ``test_torch_coherent``."""
    d = str(tmp_path_factory.mktemp("carm"))
    cache = tmp_path_factory.mktemp("cache")
    urdf, end = make_serial_arm(d, num_joints=3, segments=8, rings=2)
    rj, rt = _arm_pair(d, open(urdf).read(), end,
                       pv.cache_link_sdf_factory(resolution=0.04, padding=0.3,
                                                 cache_path=str(cache / "j.npz")),
                       pt.cache_link_sdf_factory(resolution=0.04, padding=0.3,
                                                 cache_path=str(cache / "t.npz")))
    state.load_robot_tables(rt, [
        {"val": np.asarray(s.voxels.raw_data), "grad": np.asarray(s.voxels_grad),
         "surface_bb": np.asarray(s.surface_bounding_box())} for s in rj.sdf.sdfs])
    for c in rj.sdf.sdfs:
        _give_jax_bricks(c)
    return rj, rt


def _jax_mesh(n_config, n_point):
    devices = np.array(jax.devices()[:n_config * n_point]).reshape(n_config, n_point)
    return Mesh(devices, (jpar.CONFIG_AXIS, jpar.POINT_AXIS))


def _robot_inputs():
    rng = np.random.default_rng(0)
    return (rng.uniform(-1, 1, (8, 3)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32))


def test_exports_every_name_of_the_jax_package():
    public = {n for n in dir(jpar) if not n.startswith("_")}
    assert public <= {n for n in dir(tpar) if not n.startswith("_")}
    assert tpar.COLLECTIVE_OPS == jpar.COLLECTIVE_OPS
    assert (tpar.CONFIG_AXIS, tpar.POINT_AXIS) == (jpar.CONFIG_AXIS, jpar.POINT_AXIS)


def test_init_distributed_single_process_noop():
    """No coordinator and no launcher: ``(0, 1)``, twice; the mesh needs a
    device unless given the CPU."""
    assert tpar.init_distributed() == (0, 1)
    assert tpar.init_distributed() == (0, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpar.make_device_mesh()


def test_factories_pickle_without_their_tensors(tmp_path):
    """A cached-link factory (from its file) and an in-memory-mesh factory
    rebuild the same triangles and normals, device included."""
    d = str(tmp_path)
    urdf, end = make_serial_arm(d, num_joints=2, segments=6, rings=2)
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(open(urdf).read(), end, device=CPU),
                        path_prefix=d, link_sdf_cls=pt.cache_link_sdf_factory(
                            resolution=0.05, padding=0.1, cache_path=str(tmp_path / "c.npz")))
    file_fac = robot.sdf.sdfs[-1].gt_sdf.obj_factory
    mem_fac = pt.MeshObjectFactory("wrench", mesh=pt.mesh.wrench_mesh(), scale=1.5,
                                   weld_tolerance=1e-6, device=CPU)
    for fac in (file_fac, mem_fac):
        blob = pickle.dumps(fac)
        assert b"_rebuild_tensor" not in blob  # no tensor travels
        back = pickle.loads(blob)
        assert type(back) is type(fac) and back.device == fac.device
        assert back.name == fac.name and back.scale == fac.scale
        assert torch.equal(back.scene.tri, fac.scene.tri)
        assert torch.equal(back.scene.normals, fac.scene.normals)
    assert pickle.loads(pickle.dumps(file_fac)).path_prefix == d


@pytest.mark.parametrize("links", ["exact", "cached"])
def test_sharded_robot_query_matches_jax(world, exact_arms, cached_arms, links):
    rj, rt = exact_arms if links == "exact" else cached_arms
    q, pts = _robot_inputs()
    v, g = tpar.sharded_robot_query(rt, world)(q, pts)
    assert v.shape == (8, 64) and g.shape == (8, 64, 3)
    assert v.placements == (Shard(0), Shard(1))
    vj, gj = jpar.sharded_robot_query(rj, _jax_mesh(4, 2))(jnp.asarray(q), jnp.asarray(pts))
    assert np.abs(v.full_tensor().numpy() - np.asarray(vj)).max() < 1e-5
    assert np.abs(g.full_tensor().numpy() - np.asarray(gj)).max() < 1e-4
    vr, gr = rt.query(q, pts)
    assert torch.equal(v.to_local(), vr) and torch.equal(g.to_local(), gr)
    # a DTensor input in the query's own layout is taken as it is
    q_d = tpar.sharding._sharded(torch.as_tensor(q), world, (Shard(0), Replicate()))
    vd, _ = tpar.sharded_robot_query(rt, world)(q_d, pts)
    assert torch.equal(vd.to_local(), vr)


def test_sharded_coherent_matches_jax(world, cached_arms):
    rj, rt = cached_arms
    q, _ = _robot_inputs()
    mesh_j = _jax_mesh(4, 2)
    pts, _ = pt.get_coherent_grid_points(0.02, COHERENT_RANGE, device=CPU)
    v, g = tpar.sharded_robot_query_coherent(rt, world)(q, pts)
    vj, gj = jpar.sharded_robot_query_coherent(rj, mesh_j)(jnp.asarray(q),
                                                           jnp.asarray(pts.numpy()))
    assert np.abs(v.full_tensor().numpy() - np.asarray(vj)).max() < 1e-5
    assert np.abs(g.full_tensor().numpy() - np.asarray(gj)).max() < 1e-4
    rt.set_joint_configuration(q)
    vr, gr = rt.sdf.query_coherent(pts)
    assert torch.equal(v.to_local(), vr) and torch.equal(g.to_local(), gr)

    vo = tpar.sharded_robot_query_coherent(rt, world, values_only=True)(q, pts)
    assert vo.shape == v.shape and torch.equal(vo.to_local(), v.to_local())
    assert not vo.requires_grad

    # the tiled layout, padded for the mesh, against the generic query
    pts_t, take_t, seg_t = pt.get_coherent_tile_points(0.02, COHERENT_RANGE,
                                                       cache_resolution=0.04, device=CPU)
    assert seg_t == 12
    pts_t, orig_t = tpar.pad_for_mesh(pts_t, world, tpar.POINT_AXIS, segment=seg_t)
    v_t, _ = tpar.sharded_robot_query_coherent(rt, world, seg=seg_t)(q, pts_t)
    _, pts_g = pt.get_coordinates_and_points_in_grid(0.02, COHERENT_RANGE, device=CPU)
    v_g, _ = rt.query(q, pts_g)
    assert torch.equal(v_t.to_local()[:, :orig_t][:, torch.as_tensor(take_t)], v_g)
    pts_tj, orig_tj = jpar.pad_for_mesh(jnp.asarray(pts_t[:orig_t].numpy()), mesh_j,
                                        jpar.POINT_AXIS, segment=seg_t)
    v_tj, _ = jpar.sharded_robot_query_coherent(rj, mesh_j, seg=seg_t)(jnp.asarray(q), pts_tj)
    assert orig_tj == orig_t
    assert np.abs(v_t.to_local()[:, :orig_t].numpy()
                  - np.asarray(v_tj)[:, :orig_t]).max() < 1e-5


def test_coherent_precondition_and_padding(world, cached_arms):
    """A per-rank chunk that is not whole groups raises the JAX package's
    error; ``pad_for_mesh(segment=4)`` pads to a conforming shape."""
    _, rt = cached_arms
    q, _ = _robot_inputs()
    pts, _ = pt.get_coherent_grid_points(0.02, COHERENT_RANGE, device=CPU)
    fn = tpar.sharded_robot_query_coherent(rt, world)
    with pytest.raises(ValueError, match="multiples of 4"):
        fn(q, pts[:14])
    padded, orig = tpar.pad_for_mesh(pts[:14], world, tpar.POINT_AXIS, segment=4)
    assert orig == 14 and padded.shape == (16, 3) and not padded[14:].any()
    v_pad, _ = fn(q, padded)
    v_all, _ = fn(q, pts)
    assert torch.equal(v_pad.to_local()[:, :12], v_all.to_local()[:, :12])
    with pytest.raises(ValueError, match="!= 1 ranks"):
        tpar.make_device_mesh(2, 1, device=CPU)


def test_init_distributed_inside_a_world(world):
    """A repeat call is a no-op; one that asks for another world raises."""
    assert tpar.init_distributed() == (0, 1)
    assert tpar.init_distributed("localhost:1", num_processes=1, process_id=0) == (0, 1)
    with pytest.raises(ValueError, match="already runs as rank 0 of 1"):
        tpar.init_distributed("localhost:1", num_processes=2, process_id=1, device=CPU)


def test_sharded_neural_query_matches_jax(world, tmp_path):
    """Random JAX weights through npz (``test_torch_neural_sdf``'s
    tolerances: 1e-5 / 1e-4 of the scale)."""
    rng = np.random.default_rng(1)
    B = jnp.asarray((1.5 * rng.normal(size=(3, 16))).astype(np.float32))
    cs = jn.ConfigSpaceNeuralSDF(
        jn.mlp_init(jax.random.PRNGKey(3), 2 + 32, 32, 3), B,
        np.array([-1.0, -2.0], np.float32), np.array([1.0, 1.5], np.float32),
        np.array([[-0.5, 0.5]] * 3, np.float32))
    path = str(tmp_path / "cs.npz")
    cs.save(path)
    model = pt.ConfigSpaceNeuralSDF.load(path, device=CPU)
    q = rng.uniform(-0.5, 0.5, (4, 2)).astype(np.float32)
    pts = rng.uniform(-0.4, 0.4, (16, 3)).astype(np.float32)
    v, g = tpar.sharded_neural_robot_query(model, world)(q, pts)
    vj, gj = jpar.sharded_neural_robot_query(cs, _jax_mesh(4, 2))(jnp.asarray(q),
                                                                 jnp.asarray(pts))
    assert v.shape == (4, 16) and g.shape == (4, 16, 3)
    vj, gj = np.asarray(vj), np.asarray(gj)
    np.testing.assert_allclose(v.full_tensor().numpy(), vj,
                               atol=1e-5 * max(float(np.abs(vj).max()), 1e-2))
    np.testing.assert_allclose(g.full_tensor().numpy(), gj, atol=1e-4 * float(np.abs(gj).max()))
    assert tpar.audit_sharded_callable(tpar.sharded_neural_robot_query(model, world),
                                       q, pts) == {}


def test_sharded_sdf_query_matches_jax(world, tmp_path):
    p = str(tmp_path / "s.obj")
    jmesh.save_obj(jmesh.icosphere_mesh(0.2, 2), p)
    sj = pv.MeshSDF(pv.MeshObjectFactory(p))
    fac = pt.MeshObjectFactory(p, device=CPU)
    fac._scene = state.scene_from_numpy(sj.obj_factory.scene.tri, sj.obj_factory.scene.normals,
                                        sj.obj_factory.scene.num_faces, device=CPU)
    st = pt.MeshSDF(fac)
    pts = np.random.default_rng(1).uniform(-0.4, 0.4, (128, 3)).astype(np.float32)
    fn = tpar.sharded_sdf_query(st, world)
    v, g = fn(pts)
    assert fn.extra_args[0] is fac.scene.tri
    vj, gj = jpar.sharded_sdf_query(sj, _jax_mesh(8, 1))(jnp.asarray(pts))
    assert np.abs(v.full_tensor().numpy() - np.asarray(vj)).max() < 1e-6
    assert np.abs(g.full_tensor().numpy() - np.asarray(gj)).max() < 1e-5
    assert tpar.audit_sharded_callable(fn, pts) == {}


def test_collision_step_matches_optax(world, exact_arms):
    """Five Adam steps on the 1x1 mesh and unsharded against optax.adam on
    JAX's 2x4 mesh: loss rtol 1e-5, ``q`` 1e-5; the loss falls."""
    rj, rt = exact_arms
    rng = np.random.default_rng(2)
    q0 = rng.uniform(-0.3, 0.3, (4, 3)).astype(np.float32)
    pts = rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    step = tpar.make_collision_step(rt, adam(), margin=0.15, mesh=world)
    step_ref = tpar.make_collision_step(rt, adam(), margin=0.15)
    step_j = jpar.make_collision_step(rj, optax.adam(0.05), margin=0.15, mesh=_jax_mesh(2, 4))
    q, s = q0, step.init(q0)
    q_r, s_r = q0, step_ref.init(q0)
    q_j, s_j = jnp.asarray(q0), optax.adam(0.05).init(jnp.asarray(q0))
    losses = []
    for _ in range(5):
        q, s, loss = step(q, s, pts)
        q_r, s_r, loss_r = step_ref(q_r, s_r, pts)
        q_j, s_j, loss_j = step_j(q_j, s_j, jnp.asarray(pts))
        assert float(loss) == float(loss_r)
        assert torch.equal(q.to_local(), q_r)
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
        np.testing.assert_allclose(q.full_tensor().numpy(), np.asarray(q_j), atol=1e-5)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert q.placements == (Shard(0), Replicate())


def test_collective_audit(world, exact_arms, cached_arms):
    """The sharded forwards dispatch no collective; the collision step
    all-reduces and does nothing else."""
    _, rt = exact_arms
    q, pts = _robot_inputs()
    fn = tpar.sharded_robot_query(rt, world)
    log = tpar.optimized_hlo(fn, q, pts)
    assert "aten." in log
    tpar.assert_collectives(tpar.audit_sharded_callable(fn, q, pts), allowed=())
    _, crt = cached_arms
    cpts, _ = pt.get_coherent_grid_points(0.02, COHERENT_RANGE, device=CPU)
    tpar.assert_collectives(tpar.audit_sharded_callable(
        tpar.sharded_robot_query_coherent(crt, world), q, cpts), allowed=())
    step = tpar.make_collision_step(rt, adam(), margin=0.15, mesh=world)
    counts = tpar.audit_sharded_callable(step, q[:4], step.init(q[:4]), pts)
    tpar.assert_collectives(counts, allowed=("all-reduce",), require=("all-reduce",))
    assert counts["all-reduce"] == 2
    with pytest.raises(AssertionError, match="unexpected"):
        tpar.assert_collectives(counts, allowed=())
    # torch's collectives map to the XLA opcodes
    y = torch.ones(3)
    with tpar.audit._DispatchLog() as log:
        dist.all_reduce(y)
        dist.broadcast(y, 0)
        dist.all_gather_into_tensor(torch.empty(3), y)
    assert tpar.count_collectives("\n".join(log.lines)) == {
        "all-reduce": 1, "collective-broadcast": 1, "all-gather": 1}


def test_two_process_gloo(spawned):
    """Both ranks' blocks, assembled, against JAX's sharded functions on
    two devices: robot query 1e-5 / 1e-4, triangle-sharded SDF 1e-6 /
    1e-5 (as ``tests/test_parallel.py``), collision step loss rtol 1e-5 and
    ``q`` 1e-5; the forwards dispatched no collective, the step all-reduces
    only."""
    rj, inp, fj, ranks, reports = spawned()
    q, pts = jnp.asarray(inp["q"]), jnp.asarray(inp["pts"])
    for nc, npt in MESHES:
        tag = f"{nc}x{npt}"
        vj, gj = (np.asarray(x) for x in jpar.sharded_robot_query(rj, _jax_mesh(nc, npt))(q, pts))
        # rank r sits at (r // npt, r % npt) of the mesh
        v = np.block([[ranks[c * npt + p][f"v_{tag}"] for p in range(npt)] for c in range(nc)])
        g = np.concatenate([np.concatenate([ranks[c * npt + p][f"g_{tag}"] for p in range(npt)],
                                           axis=1) for c in range(nc)], axis=0)
        assert v.shape == (8, 16) and g.shape == (8, 16, 3)
        assert np.abs(v - vj).max() < 1e-5, tag
        assert np.abs(g - gj).max() < 1e-4, tag
        assert all(r[tag] == {} for r in reports)

    wp = jnp.asarray(inp["wrench_pts"])
    ts_j = jpar.TriangleShardedMeshSDF(fj, Mesh(np.array(jax.devices()[:2]), ("tri",)))
    v0, g0 = (np.asarray(x) for x in pv.MeshSDF(fj)(wp))
    v1, g1 = (np.asarray(x) for x in ts_j(wp))
    d1, c1, _, w1 = (np.asarray(x) for x in ts_j.full_query(wp))
    for r in ranks:  # the 1D layout: every rank holds the whole result
        np.testing.assert_allclose(r["tri_v"], v1, atol=1e-6)
        np.testing.assert_allclose(r["tri_g"], g1, atol=1e-5)
        np.testing.assert_allclose(r["tri_v"], v0, atol=1e-6)
        np.testing.assert_allclose(r["tri_g"], g0, atol=1e-5)
        np.testing.assert_allclose(r["tri_dp"], r["tri_g"], atol=1e-5)
        np.testing.assert_allclose(r["tri_dist"], d1, atol=1e-6)
        np.testing.assert_allclose(r["tri_closest"], c1, atol=1e-6)
        np.testing.assert_allclose(r["tri_wind"], w1, atol=1e-5)
    for shape in ((2, 1), (1, 2)):
        tag = f"{shape[0]}x{shape[1]}"
        ts2 = jpar.TriangleShardedMeshSDF(
            fj, Mesh(np.array(jax.devices()[:2]).reshape(shape), ("tri", "point")),
            axis="tri", point_axis="point")
        v2, g2 = (np.asarray(x) for x in ts2(wp))
        # ranks along the point axis hold consecutive blocks
        order = [0] if shape[1] == 1 else [0, 1]
        vb = np.concatenate([ranks[r][f"tri2d_v_{tag}"] for r in order])
        gb = np.concatenate([ranks[r][f"tri2d_g_{tag}"] for r in order])
        np.testing.assert_allclose(vb, v2, atol=1e-6)
        np.testing.assert_allclose(gb, g2, atol=1e-5)
        if shape[1] == 1:
            np.testing.assert_array_equal(ranks[1][f"tri2d_v_{tag}"], vb)

    opt = optax.adam(0.05)
    step_j = jpar.make_collision_step(rj, opt, margin=0.15, mesh=_jax_mesh(1, 2))
    q_j, s_j = jnp.asarray(inp["q_step"]), opt.init(jnp.asarray(inp["q_step"]))
    losses = []
    for _ in range(5):
        q_j, s_j, loss = step_j(q_j, s_j, pts)
        losses.append(float(loss))
    for r in ranks:  # a 1x2 mesh: q replicated over the point axis
        np.testing.assert_allclose(r["step_losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["step_q"], np.asarray(q_j), atol=1e-5)
    assert losses[-1] < losses[0]
    for r in reports:
        tpar.assert_collectives(r["step"], allowed=("all-reduce",), require=("all-reduce",))
