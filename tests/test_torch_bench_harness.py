"""The port's last benchmark harnesses (``bench/headline.py``,
``bench/roofline_arm.py``, ``bench/trilinear.py``) against the JAX
package, on the CPU at a tiny size: the 7-joint arm with caches of 0.1
(padding 1.0, and the tight arm's 0.1) over the headline grid at 0.05 (672
tile points in (4, 3) tiles), 4 configurations from numpy's seeded
generator; the roofline chunk of 2 configurations x 8^3 points (seg = 27);
nearest and trilinear caches of 0.05 on a 1,024-face torus.  Both packages
read one cache file, built by the port; the JAX caches get their brick
tables from ``test_torch_coherent``'s numpy build.  The JAX package runs
one jitted program per arm.  The module's workers take two torch threads
(restored after), so that its many small operators keep their pace beside
the run's other workers.

Tolerances (the coherent path's, as ``test_torch_northstar``): per point,
values equal or within 1e-6 and gradients within 1e-5; d/dq within 2e-4 of
each configuration's largest |d/dq| (at least 1); the headline's scalar
``query_sum`` within 1e-5 of the magnitude of what it sums.  Within the
port, the roofline's ``full`` and ``union`` stages equal
``compose_query_coherent`` and its ``values_only`` call bit for bit.
Each module's ``main`` at a tiny size (its ``CACHE_RES``, and the
headline's ``REPS``, patched) prints JSON lines with the key set of
``bench.py`` (or of the JAX script) for the sections ported.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu.sdf import coherent_fast_tables as jax_fast_tables
from pytorch_volumetric_tpu.sdf import compose_query_coherent as jax_compose_coherent
from pytorch_volumetric_tpu_torch import sdf as tsdf
from pytorch_volumetric_tpu_torch import transforms as tfm
from pytorch_volumetric_tpu_torch.bench import headline as hl
from pytorch_volumetric_tpu_torch.bench import northstar as ns
from pytorch_volumetric_tpu_torch.bench import roofline_arm as ra
from pytorch_volumetric_tpu_torch.bench import trilinear as tl
from test_torch_coherent import _give_jax_bricks
from torch_cpu_guard import warm_sqrt

warm_sqrt()

CPU = torch.device("cpu")
CACHE_RES, N_CONFIGS = 0.1, 4
TORUS_RES, TORUS = 0.05, (0.1, 0.03, 32, 16)
MAIN_CACHE_RES = 0.1  # each main's caches (the trilinear main's on its 16,384-face torus)
V_TOL, G_TOL, DQ_TOL, SCALAR_RTOL = 1e-6, 1e-5, 2e-4, 1e-5
# at th0, links 2-4's boxes have coplanar faces; a winner moved between
# them moves d/dq of the third and fourth joints
TIED_LINKS, TIED_JOINTS = {2, 3, 4}, [2, 3]

# bench.py:231-250 (the headline rows) and :492-497 (bench_tight), the keys
# its spread_extra writes included; "<key>_spread_outlier" flags are optional
BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_PY_EXTRA = {
    "forward_ms", "forward_backward_ms", "baseline_qps", "n_configs",
    "forward_ms_spread", "forward_backward_ms_spread",
    "forward_ms_20_configs", "vs_baseline_20_configs", "forward_20_configs_ms_spread",
    "tight_dense_forward_qps_M", "tight_dense_forward_backward_qps_M",
    "tight_dense_forward_ms_spread", "tight_dense_forward_backward_ms_spread"}
# benchmarks/roofline_arm.py:202-217: the keys kept; its TPU cost model and
# XLA cost_analysis give way to the bytes count and the launches
ROOFLINE_KEYS = {"metric", "value", "unit", "extra"}
ROOFLINE_EXTRA_KEPT = {"stage_ms", "delta_ms", "chunk", "seg", "links", "points"}
ROOFLINE_EXTRA_PORT = {"stage_bytes", "stage_floor_ms", "launches", "stage_spread_ms",
                       "kernel_ms", "top_kernels", "gates"}
# benchmarks/trilinear.py:110-115: one {"ms", "mqps"} row per path
TRILINEAR_KEYS = {"metric", "value", "unit", "extra"}
TRILINEAR_ROWS = {"nearest_generic", "trilinear_generic", "nearest_coherent",
                  "trilinear_coherent"}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_robot(arm_dir, cache_path, padding):
    from pytorch_volumetric_tpu.utils.robots import make_serial_arm
    urdf, end = make_serial_arm(arm_dir, num_joints=7)
    rj = pv.RobotSDF(pv.build_serial_chain_from_urdf(open(urdf).read(), end),
                     path_prefix=arm_dir, link_sdf_cls=pv.cache_link_sdf_factory(
                         resolution=CACHE_RES, padding=padding, cache_path=cache_path))
    for c in rj.sdf.sdfs:
        _give_jax_bricks(c)
    return rj


def _jax_query(rj, q, pts, seg):
    """The JAX package's jitted ``compose_query_coherent`` of ``rj`` at
    ``q``: ``(v, g, d(v.sum() + g.sum())/dq)``."""
    children = tuple(rj.sdf.sdfs)

    def loss(qq, p, ft):
        m, m_inv = rj._link_transforms(qq)
        v, g = jax_compose_coherent(children, m, m_inv, qq.shape[0], p, fast_tables=ft,
                                    seg=seg)
        return v.sum() + g.sum(), (v, g)

    (_, (v, g)), dq = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(q.numpy()), jnp.asarray(pts.numpy()), jax_fast_tables(children))
    return np.asarray(v), np.asarray(g), np.asarray(dq)


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """The headline and the tight arm of the port (``hl.run``'s inputs and
    arms, built without its timed rows) and of the JAX package on the same
    cache files, with the JAX package's ``(v, g, dq)`` at the inputs."""
    d = str(tmp_path_factory.mktemp("arm"))
    q = hl.joint_configs(N_CONFIGS, CPU)
    pts, take, seg = hl.grid_points(CACHE_RES, CPU)
    out = {"inputs": (q, pts, take, seg)}
    for arm, cache, padding in (("headline", "sdf_cache.npz", hl.PADDING),
                                ("tight", "sdf_cache_tight.npz", hl.TIGHT_PADDING)):
        path = os.path.join(d, cache)
        robot = hl.build_arm(d, CPU, path, padding, CACHE_RES)
        rj = _jax_robot(os.path.join(d, "arm"), path, padding)
        out[arm] = {"robot": robot, "ft": hl.prepare(robot, q, pts, seg), "jax": rj,
                    "jax_out": _jax_query(rj, q, pts, seg)}
    return out


def _close(v, g, vj, gj, dq=None, dqj=None, keep=True):
    """Values and gradients per point; d/dq where ``keep`` (a mask of its
    shape) holds."""
    dv = np.abs(v - vj)
    assert (dv == 0).all() or dv.max() <= V_TOL, dv.max()
    assert np.abs(g - gj).max() <= G_TOL
    if dq is not None:
        scale = np.maximum(np.abs(dqj).max(axis=1, keepdims=True), 1.0)
        bad = (np.abs(dq - dqj) > DQ_TOL * scale) & keep
        assert not bad.any(), np.argwhere(bad)


def _winner_moves(robot, ft, rj, q, pts, seg):
    """``[B, F]`` bool: where each point's winner of the port's nearest
    union (``sdf._nearest_union``, ``_first_min``) moves when the JAX
    package's link transforms stand in for the port's (the same
    arithmetic, 1 ulp apart in places).  Asserts that each such point is a
    tie: both winners are links 2-4, and under either transforms their
    values are within two float32 ulps."""
    S, B, F = len(ft), q.shape[0], pts.shape[0]
    m, _ = robot._link_transforms(q)
    mj = torch.from_numpy(np.array(rj._link_transforms(jnp.asarray(q.numpy()))[0]))
    vals, wins = [], []
    with torch.no_grad():
        for mm in (m, mj):
            pts_c = tfm.transform_points(mm, pts).reshape(S, B, F // seg, seg, 3)
            v = tsdf._nearest_union(ft, pts_c)[0].reshape(S, B, F)
            vals.append(v)
            wins.append(tsdf._first_min(v)[0])
    moved = wins[0] != wins[1]
    w = torch.stack([x[moved] for x in wins])  # [2, n]: the port's, the JAX package's
    assert set(w.flatten().tolist()) <= TIED_LINKS, w
    for v in vals:
        pair = v.reshape(S, -1)[:, moved.reshape(-1)].gather(0, w)
        ulp = np.spacing(pair.abs().amax(dim=0).numpy())
        assert ((pair[0] - pair[1]).abs().numpy() <= 2 * ulp).all()
    return moved.numpy()


@pytest.mark.parametrize("arm", ["headline", "tight"])
def test_headline_query_sum_matches_jax(arms, arm):
    """On the tight arm, configuration 0 is ``th0``, where joint 4 is at 0
    and links 2-4's boxes have coplanar faces: at a few points their AABB
    distances tie to two ulps, and the 1-ulp differences of the two packages'
    transforms move those points' winners among these links
    (:func:`_winner_moves`), which moves d/dq of the third and fourth
    joints while values and gradients agree.  There those two joints are
    held to the port's generic path (``RobotSDF.query``), as chip_smoke
    holds them on the card, and every other joint to the JAX package."""
    q, pts, take, seg = arms["inputs"]
    assert seg == 12 and pts.shape[0] == 672 and len(take) == 651
    np.testing.assert_array_equal(q.numpy(), hl.joint_configs(N_CONFIGS, CPU).numpy())
    a = arms[arm]
    robot, ft = a["robot"], a["ft"]
    vj, gj, dqj = a["jax_out"]
    v, g, dq = ns.chunk_grad(robot, ft, q, pts, seg)
    tied = _winner_moves(robot, ft, a["jax"], q, pts, seg).any(axis=1)
    assert tied.tolist() == [arm == "tight", False, False, False]
    keep = np.ones(dq.shape, bool)
    keep[np.ix_(tied, TIED_JOINTS)] = False
    _close(v.numpy(), g.numpy(), vj, gj, dq.numpy(), dqj, keep)
    if tied.any():
        qq = q[tied].clone().requires_grad_(True)
        vr, gr = robot.query(qq, pts)
        (dqr,) = torch.autograd.grad(vr.sum() + gr.sum(), qq)
        assert torch.equal(v[tied], vr.detach()) and torch.equal(g[tied], gr.detach())
        _close(v[tied].numpy(), g[tied].numpy(), vr.detach().numpy(), gr.detach().numpy(),
               dq[tied].numpy(), dqr.numpy())
    s = float(hl.forward(robot, ft, q, pts, seg))
    assert abs(s - float(vj.sum() + gj.sum())) <= SCALAR_RTOL * float(
        np.abs(vj).sum() + np.abs(gj).sum())
    assert float(hl.forward_backward(robot, ft, q, pts, seg)) == float(dq.sum())


@pytest.fixture(scope="module")
def roofline_case(arms):
    """The roofline chunk: 2 configurations of the north-star draw on the
    headline arm's cache (``ra.run``'s robot), 8^3 points at 0.05."""
    robot, ft = arms["headline"]["robot"], arms["headline"]["ft"]
    pts, take, seg = ns.northstar_points(8, CACHE_RES, CPU, res=CACHE_RES / 2)
    q = ns.joint_configs(2, 7, CPU)
    return robot, ft, q, pts, seg


def test_roofline_stages_equal_the_coherent_path(roofline_case):
    robot, ft, q, pts, seg = roofline_case
    assert seg == 27 and pts.shape[0] == 729
    children = tuple(robot.sdf.sdfs)
    m, m_inv = robot._link_transforms(q)
    with torch.no_grad():
        v, g = tsdf.compose_query_coherent(children, m, m_inv, 2, pts, fast_tables=ft, seg=seg)
        vo = tsdf.compose_query_coherent(children, m, m_inv, 2, pts, fast_tables=ft, seg=seg,
                                         values_only=True)
    (union,) = ra.stage_outputs("union", robot, ft, q, pts, seg)
    assert torch.equal(union, vo) and torch.equal(union, v)
    assert ra.stage_sums("union", robot, ft, q, pts, seg).tolist() == [vo.sum().double().item()]
    assert ra.stage_sums("full", robot, ft, q, pts, seg).tolist() == [
        v.sum().double().item(), g.sum().double().item()]
    stages = ra.measure(robot, ft, q, pts, seg, reps=1)
    assert list(stages) == list(ra.STAGES)
    gate = ra.gates(robot, ft, q, pts, seg, stages)
    assert list(gate) == ["union_equals_values_only", "full_values_equal_union"]
    assert all(gate.values())


def test_roofline_stages_match_jax(arms):
    """``union``, ``full`` and ``fwd_bwd`` on the headline arm's inputs
    against the JAX package's program there."""
    q, pts, _, seg = arms["inputs"]
    a = arms["headline"]
    robot, ft = a["robot"], a["ft"]
    vj, gj, dqj = a["jax_out"]
    (union,) = ra.stage_outputs("union", robot, ft, q, pts, seg)
    assert np.abs(union.numpy() - vj).max() <= V_TOL
    full = ra.stage_sums("full", robot, ft, q, pts, seg)
    for x, xj in zip(full.tolist(), (vj, gj)):
        assert abs(x - float(xj.sum())) <= SCALAR_RTOL * float(np.abs(xj).sum())
    fb = ra.stage_sums("fwd_bwd", robot, ft, q, pts, seg)
    assert abs(fb[1].item() - float(dqj.sum())) <= DQ_TOL * max(np.abs(dqj).max(), 1.0) * dqj.size


def test_roofline_stage_outputs_and_bytes(roofline_case):
    robot, ft, q, pts, seg = roofline_case
    S, B, F = len(ft), q.shape[0], pts.shape[0]
    shapes = {st: [tuple(x.shape) for x in ra.stage_outputs(st, robot, ft, q, pts, seg)]
              for st in ra.PIECEWISE}
    tile = (S, B, F // seg, seg)
    assert shapes["transform"] == [tile + (3,)]
    assert shapes["keys"] == [tile, tile + (3,)]
    assert shapes["anchor"] == [tile, (S, B, F // seg), tile, tile]
    assert shapes["cells"] == [tile, tile, tile]
    assert shapes["union"] == [(B, F)]
    # every stage creates at least the tensors it hands on, and more than
    # the stage before (the piecewise stages are cumulative)
    created = [ra.created_bytes(lambda st=st: ra.stage_sums(st, robot, ft, q, pts, seg))
               for st in ra.STAGES]
    assert all(a["bytes"] < b["bytes"] for a, b in zip(created[:5], created[1:5]))
    assert created[0]["bytes"] >= S * B * F * 3 * 4

    with ra.CreatedBytes() as counter:
        x = torch.ones(10) + 1          # two new float32 tensors: 80 bytes
        y = x.view(2, 5)                # a view: nothing new
        y.add_(1)                       # in place: nothing new
        z = torch.zeros(3, dtype=torch.int64)  # 24 bytes
    assert counter.bytes == 80 + 24 and counter.ops == 3 and z.shape == (3,)


@pytest.fixture(scope="module")
def torus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torus"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "CACHE_RES", TORUS_RES)
        nearest, trilin = tl.build_caches(d, CPU, torus=TORUS)
    obj = os.path.join(d, "torus.obj")
    bb = pt.MeshObjectFactory(obj, device=CPU).bounding_box(padding=tl.PADDING)
    gt = pv.MeshSDF(pv.MeshObjectFactory(obj))
    kw = dict(cache_path=os.path.join(d, "sdf_cache_torus_tri.npz"))
    jn = pv.CachedSDF("torus_tri", TORUS_RES, bb, gt, **kw)
    jt = pv.CachedSDF("torus_tri", TORUS_RES, bb, gt, interpolation="trilinear", **kw)
    for c in (jn, jt):
        _give_jax_bricks(c)
    return {"nearest": (nearest, jn), "trilinear": (trilin, jt)}


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_trilinear_rows_match_jax(torus, interp):
    cache, cj = torus[interp]
    np.testing.assert_array_equal(cache.voxels.raw_data.numpy(), np.asarray(cj.voxels.raw_data))
    rng = np.random.default_rng(0)
    pts_r = rng.uniform(-0.25, 0.25, (500, 3)).astype(np.float32)
    v, g = tl.generic(cache, torch.as_tensor(pts_r))
    vj, gj = cj.raw_query_with(cj.raw_query_aux(), jnp.asarray(pts_r))
    _close(v.numpy(), g.numpy(), np.asarray(vj), np.asarray(gj))

    res = TORUS_RES / 2
    lo = -0.5 * res * 7
    qr = np.array([[lo, lo + res * 7]] * 3)
    pts_c, _, seg = pt.get_coherent_tile_points(res, qr, cache_resolution=TORUS_RES, device=CPU)
    composed, comp = tl.single_child(cache)
    assert composed.check_coherent_contract(pts_c, seg=seg)
    vc, gc = tl.coherent(comp, pts_c, seg)
    cjc = pv.ComposedSDF([cj], pv.Transform3d(matrix=jnp.eye(4)[None]))
    vcj, gcj = jax_compose_coherent(tuple(cjc.sdfs), cjc.obj_frame_to_link_frame.get_matrix(),
                                    cjc.link_frame_to_obj_frame, 1, jnp.asarray(pts_c.numpy()),
                                    fast_tables=jax_fast_tables(cjc.sdfs), seg=seg)
    _close(vc.numpy(), gc.numpy(), np.asarray(vcj), np.asarray(gcj))
    gate = tl.coherent_gate(cache, comp, pts_c, seg)
    assert gate["ok"] and gate["exact"], gate


def _lines(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert out
    return [json.loads(x) for x in out]


def _extra_keys(line):
    return {k for k in line["extra"] if not k.endswith("_spread_outlier")}


def test_headline_main_prints_bench_py_keys(capsys, monkeypatch):
    monkeypatch.setattr(hl, "CACHE_RES", MAIN_CACHE_RES)
    monkeypatch.setattr(hl, "REPS", 1)
    assert hl.main(["--device", "cpu", "--configs", "20"]) == 0
    first, last = _lines(capsys)
    assert set(last) == BENCH_PY_KEYS | {"device"} and last["device"] == {"name": "cpu"}
    assert _extra_keys(last) == BENCH_PY_EXTRA
    assert _extra_keys(first) == {k for k in BENCH_PY_EXTRA if not k.startswith("tight_")}
    assert last["metric"] == "robot_sdf_query_throughput" and last["extra"]["n_configs"] == 20
    assert last["unit"] == "config-point queries/s (20 configs x 651 pts, 8 cached links)"
    assert hl.main(["--device", "cpu", "--configs", "4", "--sections"]) == 0
    (only,) = _lines(capsys)
    assert "forward_ms_20_configs" not in only["extra"]


def test_roofline_main_prints_the_scripts_keys(capsys, monkeypatch):
    monkeypatch.setattr(ra, "CACHE_RES", MAIN_CACHE_RES)
    assert ra.main(["--device", "cpu", "--chunk", "2", "--points-side", "8", "--reps", "1"]) == 0
    (line,) = _lines(capsys)
    assert set(line) == ROOFLINE_KEYS | {"device"}
    assert set(line["extra"]) == ROOFLINE_EXTRA_KEPT | ROOFLINE_EXTRA_PORT
    assert line["metric"] == "northstar_arm_chunk_roofline"
    assert list(line["extra"]["stage_ms"]) == list(ra.STAGES)
    assert line["extra"]["chunk"] == 2 and line["extra"]["points"] == 729


def test_trilinear_main_prints_the_scripts_keys(capsys, monkeypatch):
    monkeypatch.setattr(tl, "CACHE_RES", MAIN_CACHE_RES)
    assert tl.main(["--device", "cpu", "--points-side", "8", "--reps", "1"]) == 0
    (line,) = _lines(capsys)
    assert set(line) == TRILINEAR_KEYS | {"device"}
    assert set(line["extra"]) == TRILINEAR_ROWS | {"stand_in", "coherent_gate"}
    assert all(set(line["extra"][r]) == {"ms", "mqps"} for r in TRILINEAR_ROWS)
    assert line["value"] == line["extra"]["trilinear_generic"]["mqps"]


def test_mains_refuse_the_cpu_unless_asked(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod in (hl, ra, tl):
        assert mod.main([]) == 1
        assert "needs a CUDA device" in capsys.readouterr().err
