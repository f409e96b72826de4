"""The port's SDF (Gazebo) and MJCF (MuJoCo) parsers against the JAX
package's on the same documents (CPU): chain structure (frames, joints,
limits, visuals) and FK matrices, mirroring ``test_kinematics_formats.py``,
plus the MJCF form of the procedural arm against its URDF.

FK tolerance 1e-6: both build the same float32 joint tables, but the 4x4
products round in different orders (``torch.matmul`` against XLA)."""

import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu import kinematics as jk
from pytorch_volumetric_tpu_torch import kinematics as tk
from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm, serial_arm_mjcf

URDF = """
<robot name="two_link">
  <link name="base"/>
  <link name="l1">
    <visual><origin xyz="0 0 0.1"/><geometry><box size="0.1 0.1 0.2"/></geometry></visual>
  </link>
  <link name="l2">
    <visual><geometry><sphere radius="0.05"/></geometry></visual>
  </link>
  <joint name="j1" type="revolute">
    <origin xyz="0 0 0.1"/>
    <parent link="base"/><child link="l1"/>
    <axis xyz="0 0 1"/>
    <limit lower="-2" upper="2" effort="1" velocity="1"/>
  </joint>
  <joint name="j2" type="prismatic">
    <origin xyz="0 0 0.2"/>
    <parent link="l1"/><child link="l2"/>
    <axis xyz="0 1 0"/>
    <limit lower="-0.5" upper="0.5" effort="1" velocity="1"/>
  </joint>
</robot>
"""

SDF = """
<sdf version="1.6">
  <model name="two_link">
    <link name="base"><pose>0 0 0 0 0 0</pose></link>
    <link name="l1">
      <pose>0 0 0.1 0 0 0</pose>
      <visual name="v1"><pose>0 0 0.1 0 0 0</pose>
        <geometry><box><size>0.1 0.1 0.2</size></box></geometry></visual>
    </link>
    <link name="l2">
      <pose>0 0 0.3 0 0 0</pose>
      <visual name="v2"><geometry><sphere><radius>0.05</radius></sphere></geometry></visual>
    </link>
    <joint name="j1" type="revolute">
      <parent>base</parent><child>l1</child>
      <axis><xyz>0 0 1</xyz><limit><lower>-2</lower><upper>2</upper></limit></axis>
    </joint>
    <joint name="j2" type="prismatic">
      <parent>l1</parent><child>l2</child>
      <axis><xyz>0 1 0</xyz><limit><lower>-0.5</lower><upper>0.5</upper></limit></axis>
    </joint>
  </model>
</sdf>
"""

# rotated link and visual poses, a mesh with scale, a cylinder, a joint
# pose, a model-frame axis, a one-sided limit, a world-anchored joint and an
# unsupported joint type
SDF_RICH = """
<sdf version="1.6">
  <model name="other"><link name="x"/></model>
  <model name="rich">
    <link name="base"><pose>0.1 0 0 0 0 0.3</pose>
      <visual><pose>0 0 0.02 0.1 0.2 0.3</pose>
        <geometry><mesh><uri>base.obj</uri><scale>2 2 2</scale></mesh></geometry></visual>
    </link>
    <link name="a"><pose>0.2 0.1 0.3 0.3 -0.2 0.5</pose>
      <visual><geometry><cylinder><radius>0.03</radius><length>0.2</length></cylinder>
      </geometry></visual>
    </link>
    <link name="b"><pose>0.25 0.1 0.5 0 0.4 0</pose></link>
    <link name="c"><pose>0.3 0.2 0.6 0 0 0</pose></link>
    <joint name="anchor" type="fixed"><parent>world</parent><child>base</child></joint>
    <joint name="ja" type="revolute">
      <pose>0 0.02 0.01 0 0 0.2</pose>
      <parent>base</parent><child>a</child>
      <axis><xyz>0 1 0</xyz><limit><lower>-1</lower></limit></axis>
    </joint>
    <joint name="jb" type="prismatic">
      <parent>a</parent><child>b</child>
      <axis><xyz>1 0 0</xyz><use_parent_model_frame>true</use_parent_model_frame></axis>
    </joint>
    <joint name="jc" type="ball"><parent>b</parent><child>c</child></joint>
  </model>
</sdf>
"""

MJCF = """
<mujoco model="two_link">
  <compiler angle="radian"/>
  <worldbody>
    <body name="l1" pos="0 0 0.1">
      <joint name="j1" type="hinge" axis="0 0 1" range="-2 2"/>
      <geom type="box" size="0.05 0.05 0.1" pos="0 0 0.1"/>
      <body name="l2" pos="0 0 0.2">
        <joint name="j2" type="slide" axis="0 1 0" range="-0.5 0.5"/>
        <geom type="sphere" size="0.05"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

# degrees, every orientation attribute, defaults classes (nested, childclass,
# class=), fromto capsules and cylinders, meshes with scale, a joint pos
# offset, unnamed bodies, an unsupported joint and an unknown mesh
MJCF_RICH = """
<mujoco>
  <asset><mesh name="m" file="parts/m.stl" scale="0.5 0.5 0.5"/><mesh file="x/plain.obj"/></asset>
  <default>
    <joint axis="0 1 0" range="-45 45"/>
    <geom type="capsule" size="0.02 0.05"/>
    <default class="arm"><geom type="box" size="0.01 0.02 0.03"/>
      <default class="tip"><joint type="slide" axis="1 0 0" range="-0.1 0.2"/></default>
    </default>
  </default>
  <worldbody>
    <geom type="sphere" size="0.3" pos="0 0 -0.3"/>
    <body name="q" pos="0.1 0 0" quat="0.9 0.1 0.3 0.2">
      <joint name="jq" pos="0 0.05 0"/>
      <geom/>
      <body name="e" pos="0 0.1 0" euler="10 20 30" childclass="arm">
        <joint name="je"/>
        <geom/><geom type="mesh" mesh="m" euler="0 90 0"/><geom type="mesh" mesh="plain"/>
        <geom type="mesh" mesh="missing"/>
        <body pos="0 0 0.1" axisangle="1 1 0 30">
          <joint name="ja" class="tip"/>
          <geom type="cylinder" fromto="0 0 0 0.1 0 0.1" size="0.01"/>
          <body pos="0.1 0 0" xyaxes="0 1 0 -1 0 0.2">
            <joint name="jx" type="ball"/>
            <geom type="capsule" fromto="0 0 0 0 0 -0.2" size="0.02"/>
            <body name="z" zaxis="0.3 0.4 0.5"><joint name="jz" type="hinge" axis="1 1 1"/>
              <geom type="ellipsoid" size="0.1 0.1 0.1"/></body>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


def _assert_same_chain(jc, tc):
    """Same frames, joints (type, origin, axis, limits, offset, links) and
    visuals (type, parameters, offset)."""
    assert tc.get_joint_parameter_names() == jc.get_joint_parameter_names()
    assert tc.get_frame_names() == jc.get_frame_names()
    np.testing.assert_array_equal(tc.get_joint_limits(), jc.get_joint_limits())
    for name in jc.get_frame_names():
        jf, tf = jc.find_frame(name), tc.find_frame(name)
        assert (jf.joint is None) == (tf.joint is None)
        if jf.joint is not None:
            a, b = jf.joint, tf.joint
            assert (a.name, a.joint_type, a.parent_link, a.child_link, a.limits) == \
                (b.name, b.joint_type, b.parent_link, b.child_link, b.limits)
            np.testing.assert_allclose(b.origin, a.origin, atol=1e-7)
            np.testing.assert_allclose(b.axis, a.axis, atol=1e-7)
            if a.joint_offset is None:
                assert b.joint_offset is None
            else:
                np.testing.assert_allclose(b.joint_offset, a.joint_offset, atol=1e-7)
        assert len(jf.link.visuals) == len(tf.link.visuals)
        for va, vb in zip(jf.link.visuals, tf.link.visuals):
            assert va.geom_type == vb.geom_type
            assert len(va.geom_param) == len(vb.geom_param)
            for pa, pb in zip(va.geom_param, vb.geom_param):
                if isinstance(pa, str) or pa is None:
                    assert pa == pb
                else:
                    np.testing.assert_allclose(pb, pa, atol=1e-7)
            np.testing.assert_allclose(vb.offset, va.offset, atol=1e-7)


def _assert_same_fk(jc, tc, q):
    j = {k: np.asarray(v.get_matrix()) for k, v in jc.forward_kinematics(q).items()}
    t = {k: v.get_matrix().numpy() for k, v in
         tc.forward_kinematics(torch.as_tensor(q)).items()}
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], atol=1e-6)


def _q(seed, n, m):
    return np.random.default_rng(seed).uniform(-1, 1, (n, m)).astype(np.float32)


@pytest.mark.parametrize("doc", [SDF, SDF_RICH], ids=["two_link", "rich"])
def test_sdf_chain_matches_jax(doc):
    name = None if doc is SDF else "rich"
    jc = jk.build_chain_from_sdf(doc, name)
    tc = tk.build_chain_from_sdf(doc, name, device="cpu")
    _assert_same_chain(jc, tc)
    _assert_same_fk(jc, tc, _q(0, 3, tc.n_joints))


@pytest.mark.parametrize("doc", [MJCF, MJCF_RICH], ids=["two_link", "rich"])
def test_mjcf_chain_matches_jax(doc):
    jc = jk.build_chain_from_mjcf(doc)
    tc = tk.build_chain_from_mjcf(doc, device="cpu")
    _assert_same_chain(jc, tc)
    _assert_same_fk(jc, tc, _q(1, 3, tc.n_joints))


def test_formats_match_urdf():
    """The two-link robot in SDF and MJCF gives the URDF's FK (the JAX
    test's claim, on the port)."""
    cu = pt.build_chain_from_urdf(URDF, device="cpu")
    q = torch.as_tensor(_q(2, 4, 2))
    ref = cu.forward_kinematics(q)
    for chain in (pt.build_chain_from_sdf(SDF, device="cpu"),
                  pt.build_chain_from_mjcf(MJCF, device="cpu")):
        assert chain.get_joint_parameter_names() == ["j1", "j2"]
        out = chain.forward_kinematics(q)
        for f in ("l1", "l2"):
            np.testing.assert_allclose(out[f].get_matrix().numpy(),
                                       ref[f].get_matrix().numpy(), atol=1e-6)


def test_joint_offsets_conjugate_the_motion():
    """A hinge placed inside its body (MJCF ``pos``, SDF joint ``<pose>``)
    rotates about the offset point: T(body) T(off) R(q) T(-off)."""
    mjcf = """<mujoco><compiler angle="radian"/><worldbody>
      <body name="b" pos="0.1 0 0"><joint name="j" type="hinge" axis="0 0 1" pos="0 0.05 0"/>
      <geom type="sphere" size="0.02"/></body></worldbody></mujoco>"""
    sdf = """<sdf version="1.6"><model name="m"><link name="base"/>
      <link name="b"><pose>0.1 0 0 0 0 0</pose></link>
      <joint name="j" type="revolute"><pose>0 0.05 0 0 0 0</pose>
      <parent>base</parent><child>b</child><axis><xyz>0 0 1</xyz></axis></joint>
      </model></sdf>"""

    def T(x, y, z):
        t = np.eye(4)
        t[:3, 3] = (x, y, z)
        return t

    for chain, th in ((pt.build_chain_from_mjcf(mjcf, device="cpu"), 0.9),
                      (pt.build_chain_from_sdf(sdf, device="cpu"), -0.4)):
        m = chain.forward_kinematics(torch.tensor([th]))["b"].get_matrix()[0].numpy()
        Rz = np.eye(4)
        Rz[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        np.testing.assert_allclose(m, T(0.1, 0, 0) @ T(0, 0.05, 0) @ Rz @ T(0, -0.05, 0),
                                   atol=1e-6)


def test_mjcf_sizes_and_degrees():
    doc = """<mujoco><worldbody><body name="b" euler="0 0 90">
      <joint name="j" type="hinge" axis="0 0 1" range="-90 90"/>
      <geom type="capsule" size="0.03 0.1"/>
      <geom type="capsule" fromto="0 0 0 0 0.2 0" size="0.05"/>
      <geom type="box" size="0.1 0.2 0.3"/></body></worldbody></mujoco>"""
    c = pt.build_chain_from_mjcf(doc, device="cpu")
    f = c.find_frame("b")
    np.testing.assert_allclose(f.joint.limits, (-np.pi / 2, np.pi / 2))
    m = c.forward_kinematics(torch.zeros(1))["b"].get_matrix()[0].numpy()
    np.testing.assert_allclose(m[:3, :3], [[0, -1, 0], [1, 0, 0], [0, 0, 1]], atol=1e-6)
    cap, seg, box = f.link.visuals
    assert cap.geom_type == "capsule" and cap.geom_param == (0.03, 0.2)
    np.testing.assert_allclose(seg.geom_param, (0.05, 0.2), atol=1e-7)
    np.testing.assert_allclose(seg.offset[:3, 3], [0, 0.1, 0], atol=1e-7)
    np.testing.assert_allclose(seg.offset[:3, :3] @ [0, 0, 1], [0, 1, 0], atol=1e-7)
    np.testing.assert_allclose(box.geom_param[0], [0.2, 0.4, 0.6])


def test_serial_chains_and_errors():
    # the serial form reads the first model
    sc = pt.build_serial_chain_from_sdf(
        SDF_RICH.replace('<model name="other"><link name="x"/></model>', ""), "b",
        device="cpu")
    assert sc.get_frame_names() == ["world", "base", "a", "b"]
    sm = pt.build_serial_chain_from_mjcf(MJCF_RICH, "z", root_link_name="e", device="cpu")
    assert sm.get_frame_names()[0] == "e" and sm.get_frame_names()[-1] == "z"
    with pytest.raises(ValueError, match="no <model>"):
        pt.build_chain_from_sdf(SDF, "missing", device="cpu")
    with pytest.raises(ValueError, match="not found"):
        pt.build_chain_from_mjcf(MJCF, body="missing", device="cpu")
    with pytest.raises(ValueError, match="worldbody"):
        pt.build_chain_from_mjcf("<mujoco/>", device="cpu")


def test_robot_sdf_from_mjcf_primitives_matches_jax():
    doc = """<mujoco><compiler angle="radian"/><worldbody>
      <body name="l1" pos="0 0 0.05"><joint name="j1" type="hinge" axis="0 0 1"/>
        <geom type="capsule" size="0.04 0.08" pos="0 0 0.08"/>
        <body name="l2" pos="0 0 0.16"><joint name="j2" type="hinge" axis="0 1 0"/>
          <geom type="capsule" size="0.03 0.06" pos="0 0 0.06"/></body>
      </body></worldbody></mujoco>"""
    q = np.array([[0.0, 0.0], [0.5, -0.7]], dtype=np.float32)
    pts = np.random.default_rng(3).uniform(-0.3, 0.4, (64, 3)).astype(np.float32)
    jv, jg = pv.RobotSDF(jk.build_chain_from_mjcf(doc)).query(q, pts)
    tv, tg = pt.RobotSDF(tk.build_chain_from_mjcf(doc, device="cpu")).query(q, pts)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)


def test_arm_mjcf_matches_its_urdf(tmp_path):
    """The procedural arm's MJCF text: the same links and FK as its URDF in
    the port, and the same chain in the JAX package's parser."""
    urdf_path, end = make_serial_arm(str(tmp_path), num_joints=7)
    doc = serial_arm_mjcf()
    cm = pt.build_serial_chain_from_mjcf(doc, end, device="cpu")
    cu = pt.build_serial_chain_from_urdf(open(urdf_path).read(), end, device="cpu")
    assert cm.get_joint_parameter_names() == cu.get_joint_parameter_names()
    q = torch.as_tensor(_q(4, 3, 7))
    fm, fu = cm.fk_matrices(q), cu.fk_matrices(q)
    for name in cu.get_frame_names():
        assert torch.equal(fm[name], fu[name])
    _assert_same_chain(jk.build_chain_from_mjcf(doc), tk.build_chain_from_mjcf(doc, device="cpu"))
