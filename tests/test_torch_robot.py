"""The port's kinematics and robot SDF against the JAX package on the same
inputs (CPU): FK on serial, branching and mimic-joint robots, and
``RobotSDF.query`` values and gradients w.r.t. joint angles and points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu.utils.robots import make_serial_arm
from pytorch_volumetric_tpu_torch import state
from pytorch_volumetric_tpu_torch.utils import robots as trobots
from torch_cpu_guard import warm_sqrt

warm_sqrt()

BRANCHING_URDF = """
<robot name="two_arm">
  <link name="base"/>
  <link name="torso">
    <visual><origin xyz="0 0 0.15"/>
      <geometry><cylinder radius="0.06" length="0.3"/></geometry></visual>
  </link>
  <link name="arm_l">
    <visual><origin xyz="0 0.1 0" rpy="0.1 0.2 0.3"/>
      <geometry><box size="0.05 0.2 0.05"/></geometry></visual>
  </link>
  <link name="arm_r">
    <visual><origin xyz="0 -0.1 0"/>
      <geometry><box size="0.05 0.2 0.05"/></geometry></visual>
  </link>
  <link name="hand_r">
    <visual><geometry><sphere radius="0.04"/></geometry></visual>
  </link>
  <joint name="waist" type="revolute">
    <origin xyz="0 0 0.05"/><parent link="base"/><child link="torso"/>
    <axis xyz="0 0 1"/><limit lower="-3" upper="3" effort="1" velocity="1"/>
  </joint>
  <joint name="shoulder_l" type="revolute">
    <origin xyz="0 0.08 0.3" rpy="0.3 -0.2 0.1"/><parent link="torso"/><child link="arm_l"/>
    <axis xyz="1 0 0"/><limit lower="-3" upper="3" effort="1" velocity="1"/>
  </joint>
  <joint name="shoulder_r" type="revolute">
    <origin xyz="0 -0.08 0.3"/><parent link="torso"/><child link="arm_r"/>
    <axis xyz="1 0 0"/><limit lower="-3" upper="3" effort="1" velocity="1"/>
  </joint>
  <joint name="wrist_r" type="prismatic">
    <origin xyz="0 -0.2 0"/><parent link="arm_r"/><child link="hand_r"/>
    <axis xyz="0 -2 0"/><limit lower="0" upper="0.2" effort="1" velocity="1"/>
  </joint>
</robot>
"""

MIMIC_URDF = """
<robot name="gripper">
  <link name="base"/><link name="f1"/><link name="f2"/>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="f1"/>
    <origin xyz="0.1 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-1.0" upper="1.0"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="base"/><child link="f2"/>
    <origin xyz="-0.1 0 0"/><axis xyz="0 0 1"/>
    <mimic joint="j1" multiplier="-1.0" offset="0.2"/>
  </joint>
</robot>
"""


def _assert_fk_match(cj, ct, q, atol=1e-6):
    fj = cj.fk_matrices(jnp.asarray(q))
    ft = ct.fk_matrices(torch.as_tensor(q))
    assert set(fj) == set(ft)
    for name in fj:
        np.testing.assert_allclose(ft[name].numpy(), np.asarray(fj[name]), atol=atol,
                                   err_msg=name)


def test_procedural_assets_match(tmp_path):
    """The port writes byte-identical robot files."""
    urdf_j, end_j = make_serial_arm(str(tmp_path / "j"), num_joints=3, segments=6, rings=2)
    urdf_t, end_t = trobots.make_serial_arm(str(tmp_path / "t"), num_joints=3,
                                            segments=6, rings=2)
    assert end_j == end_t
    for f in ("arm.urdf", "link0.obj", "link_cap.obj"):
        with open(tmp_path / "j" / f) as a, open(tmp_path / "t" / f) as b:
            assert a.read() == b.read(), f


def test_fk_serial_arm(tmp_path):
    urdf, end = make_serial_arm(str(tmp_path), num_joints=7)
    text = open(urdf).read()
    cj = pv.build_serial_chain_from_urdf(text, end)
    ct = pt.build_serial_chain_from_urdf(text, end, device="cpu")
    assert ct.get_joint_parameter_names() == cj.get_joint_parameter_names()
    np.testing.assert_array_equal(ct.get_joint_limits(), cj.get_joint_limits())
    q = np.random.default_rng(0).uniform(-2, 2, (5, 7)).astype(np.float32)
    _assert_fk_match(cj, ct, q)
    end_j = np.asarray(cj.forward_kinematics(jnp.asarray(q), end_only=True).get_matrix())
    end_t = ct.forward_kinematics(q, end_only=True).get_matrix().numpy()
    np.testing.assert_allclose(end_t, end_j, atol=1e-6)


def test_fk_branching_tree():
    cj = pv.build_chain_from_urdf(BRANCHING_URDF)
    ct = pt.build_chain_from_urdf(BRANCHING_URDF, device="cpu")
    assert ct.get_joint_parameter_names() == ["waist", "shoulder_l", "shoulder_r", "wrist_r"]
    q = np.random.default_rng(1).uniform(-1, 1, (3, 2, 4)).astype(np.float32)
    _assert_fk_match(cj, ct, q)


def test_fk_mimic_joint():
    cj = pv.build_chain_from_urdf(MIMIC_URDF)
    ct = pt.build_chain_from_urdf(MIMIC_URDF, device="cpu")
    assert ct.get_joint_parameter_names() == ["j1"]
    q = np.array([[0.37], [-0.8]], dtype=np.float32)
    _assert_fk_match(cj, ct, q)


def test_primitive_robot_query_matches_jax():
    """A branching robot of primitive links through the whole query."""
    rj = pv.RobotSDF(pv.build_chain_from_urdf(BRANCHING_URDF))
    rt = pt.RobotSDF(pt.build_chain_from_urdf(BRANCHING_URDF, device="cpu"))
    rng = np.random.default_rng(2)
    q = rng.uniform(-0.8, 0.8, (3, 4)).astype(np.float32)
    pts = rng.uniform(-0.4, 0.4, (64, 3)).astype(np.float32)
    vj, gj = (np.asarray(x) for x in rj.query(jnp.asarray(q), jnp.asarray(pts)))
    vt, gt = (x.numpy() for x in rt.query(q, pts))
    assert np.abs(vt - vj).max() < 1e-5
    assert np.abs(gt - gj).max() < 1e-4
    rj.set_joint_configuration(jnp.asarray(q))
    rt.set_joint_configuration(q)
    np.testing.assert_allclose(rt.link_bounding_boxes().numpy(),
                               np.asarray(rj.link_bounding_boxes()), atol=1e-6)


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """The small cached arm in both packages; the port's links hold the JAX
    package's tables."""
    d = str(tmp_path_factory.mktemp("arm"))
    urdf, end = make_serial_arm(d, num_joints=3, segments=6, rings=2)
    text = open(urdf).read()
    cache_dir = tmp_path_factory.mktemp("cache")
    rj = pv.RobotSDF(pv.build_serial_chain_from_urdf(text, end), path_prefix=d,
                     link_sdf_cls=pv.cache_link_sdf_factory(
                         resolution=0.05, padding=0.1,
                         cache_path=str(cache_dir / "jax.npz")))
    rt = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device="cpu"),
                     path_prefix=d,
                     link_sdf_cls=pt.cache_link_sdf_factory(
                         resolution=0.05, padding=0.1,
                         cache_path=str(cache_dir / "port.npz")))
    own = list(rt.sdf.sdfs)
    state.load_robot_tables(rt, [
        {"val": np.asarray(s.voxels.raw_data), "grad": np.asarray(s.voxels_grad),
         "surface_bb": np.asarray(s.surface_bounding_box())} for s in rj.sdf.sdfs])
    return d, text, end, rj, rt, own


def _query_inputs(seed=3, A=4, P=200):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.5, 1.5, (A, 3)).astype(np.float32)
    pts = np.concatenate([rng.uniform(-0.3, 0.3, (P, 2)),
                          rng.uniform(-0.1, 0.7, (P, 1))], axis=1).astype(np.float32)
    return q, pts


def _jax_query_grads(robot, q, pts, with_grad_term=False):
    def obj(qq, pp):
        v, g = robot.query(qq, pp)
        return v.sum() + (g.sum() if with_grad_term else 0.0)

    v, g = robot.query(jnp.asarray(q), jnp.asarray(pts))
    dq, dp = jax.grad(obj, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(pts))
    return [np.asarray(x) for x in (v, g, dq, dp)]


def _torch_query_grads(robot, q, pts, with_grad_term=False):
    qt = torch.as_tensor(q).requires_grad_(True)
    pt_ = torch.as_tensor(pts).requires_grad_(True)
    v, g = robot.query(qt, pt_)
    obj = v.sum() + (g.sum() if with_grad_term else 0.0)
    dq, dp = torch.autograd.grad(obj, (qt, pt_))
    return [x.detach().numpy() for x in (v, g, dq, dp)]


@pytest.mark.parametrize("with_grad_term", [False, True])
def test_cached_robot_query_matches_jax(arms, with_grad_term):
    """Values, gradients, d/dq and d/dpts on identical link tables; with
    ``with_grad_term`` the objective is ``v.sum() + g.sum()``, which also
    differentiates the gradient's rotation back into the robot frame."""
    *_, rj, rt, _ = arms
    q, pts = _query_inputs()
    vj, gj, dqj, dpj = _jax_query_grads(rj, q, pts, with_grad_term)
    vt, gt, dqt, dpt = _torch_query_grads(rt, q, pts, with_grad_term)
    assert vt.shape == (4, 200) and gt.shape == (4, 200, 3)
    assert (vj < 0).any() and (vj > 0).any()
    assert np.abs(vt - vj).max() < 1e-5
    assert np.abs(gt - gj).max() < 1e-4
    assert np.abs(dqt - dqj).max() < 1e-4
    assert np.abs(dpt - dpj).max() < 1e-4


def test_cached_robot_own_build_values(arms):
    """The port's own cache build gives the same robot values."""
    *_, rj, rt, own = arms
    rt_own = pt.RobotSDF.__new__(pt.RobotSDF)
    rt_own.__dict__.update(rt.__dict__)
    rt_own.sdf = pt.ComposedSDF(own, None)
    q, pts = _query_inputs(seed=4)
    vj, _ = rj.query(jnp.asarray(q), jnp.asarray(pts))
    vt, _ = rt_own.query(q, pts)
    assert np.abs(vt.numpy() - np.asarray(vj)).max() < 1e-5


def test_set_configuration_call_matches_query(arms):
    *_, rj, rt, _ = arms
    q, pts = _query_inputs(seed=5, A=3, P=50)
    rt.set_joint_configuration(q)
    v1, g1 = rt(pts)
    v2, g2 = rt.query(q, pts)
    assert torch.equal(v1, v2) and torch.equal(g1, g2)
    rj.set_joint_configuration(jnp.asarray(q))
    np.testing.assert_allclose(rt.surface_bounding_box(padding=0.0).numpy(),
                               np.asarray(rj.surface_bounding_box(padding=0.0)), atol=1e-6)
    np.testing.assert_allclose(rt.link_bounding_boxes().numpy(),
                               np.asarray(rj.link_bounding_boxes()), atol=1e-6)


def test_exact_link_robot_matches_jax(arms):
    """Exact MeshSDF links (the sweep on every query), holding the JAX
    package's triangle tables."""
    d, text, end, *_ = arms
    rj = pv.RobotSDF(pv.build_serial_chain_from_urdf(text, end), path_prefix=d)
    rt = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device="cpu"),
                     path_prefix=d)
    scenes = [s.obj_factory.scene for s in rj.sdf.sdfs]
    for s, js in zip(rt.sdf.sdfs, scenes):
        np.testing.assert_array_equal(s.obj_factory.scene.tri.numpy(), np.asarray(js.tri))
    state.load_robot_tables(rt, [{"tri": np.asarray(js.tri), "normals": np.asarray(js.normals)}
                                 for js in scenes])
    q, pts = _query_inputs(seed=6, A=2, P=100)
    vj, gj, dqj, dpj = _jax_query_grads(rj, q, pts)
    vt, gt, dqt, dpt = _torch_query_grads(rt, q, pts)
    assert np.abs(vt - vj).max() < 1e-5
    assert np.abs(gt - gj).max() < 1e-4
    assert np.abs(dqt - dqj).max() < 1e-4
    assert np.abs(dpt - dpj).max() < 1e-4
