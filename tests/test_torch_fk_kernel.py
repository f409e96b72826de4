"""FK as one op (``ops/fk.py``, ``pvt::fk_link_transforms``): the robot's
descriptor, the op's plain CPU kernels against ``RobotSDF._link_transforms``'
chain walk, its fake, its export, and the d/dq kernel's forward-mode design
mirrored in torch; on the card, the kernels against the plain walk, their
launch counts, the served program's node and second derivatives.  Imports
neither JAX nor the JAX package, so it runs on a GPU machine without them:

    python -m pytest --noconftest -q tests/test_torch_fk_kernel.py

Tests marked ``cuda`` skip without a CUDA device."""

import os

import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch import transforms as tfm
from pytorch_volumetric_tpu_torch.ops import fk as fk_ops
from pytorch_volumetric_tpu_torch.utils import profiling, serving
from pytorch_volumetric_tpu_torch.utils.robots import make_free_object_urdf, make_serial_arm

CPU = torch.device("cpu")

BRANCHING_URDF = """
<robot name="two_arm">
  <link name="base"/>
  <link name="torso">
    <visual><origin xyz="0 0 0.15"/>
      <geometry><cylinder radius="0.06" length="0.3"/></geometry></visual>
    <visual><origin xyz="0 0.02 0.31" rpy="0.4 0 0"/>
      <geometry><sphere radius="0.05"/></geometry></visual>
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
  <link name="base"><visual><geometry><box size="0.1 0.05 0.02"/></geometry></visual></link>
  <link name="f1"><visual><origin xyz="0 0.03 0"/>
    <geometry><box size="0.01 0.06 0.01"/></geometry></visual></link>
  <link name="f2"><visual><origin xyz="0 0.03 0"/>
    <geometry><box size="0.01 0.06 0.01"/></geometry></visual></link>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="f1"/>
    <origin xyz="0.1 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-1.0" upper="1.0"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="base"/><child link="f2"/>
    <origin xyz="-0.1 0 0" rpy="0 0 0.3"/><axis xyz="0 0 1"/>
    <mimic joint="j1" multiplier="-0.7" offset="0.2"/>
  </joint>
</robot>
"""

# hinges and a slide placed inside their bodies: each motion is conjugated
# by the joint offset
OFFSET_MJCF = """<mujoco><compiler angle="radian"/><worldbody>
  <body name="b1" pos="0.1 0 0"><joint name="h1" type="hinge" axis="0 0 1" pos="0 0.05 0"/>
    <geom type="sphere" size="0.02"/>
    <body name="b2" pos="0 0.2 0" euler="0.3 0 0">
      <joint name="h2" type="hinge" axis="1 1 0" pos="0.02 0 0.03"/>
      <geom type="box" size="0.02 0.05 0.02" pos="0 0.05 0"/>
      <body name="b3" pos="0 0.1 0"><joint name="s3" type="slide" axis="0 1 0" pos="0 0 0.01"/>
        <geom type="sphere" size="0.015"/></body>
    </body>
  </body></worldbody></mujoco>"""

FIXED_URDF = """
<robot name="rigid">
  <link name="base"><visual><geometry><box size="0.2 0.2 0.05"/></geometry></visual></link>
  <link name="post"><visual><origin xyz="0 0 0.1"/>
    <geometry><cylinder radius="0.02" length="0.2"/></geometry></visual></link>
  <link name="cap"><visual><geometry><sphere radius="0.03"/></geometry></visual></link>
  <joint name="f1" type="fixed"><parent link="base"/><child link="post"/>
    <origin xyz="0.05 0 0.025" rpy="0 0.1 0"/></joint>
  <joint name="f2" type="fixed"><parent link="post"/><child link="cap"/>
    <origin xyz="0 0 0.2"/></joint>
</robot>
"""

# "rooted" is the branching tree's serial chain torso -> hand_r: its root
# frame keeps the joint (waist) that hangs it from the cut-off base
ROBOTS = ("arm7", "free6", "branching", "mimic", "offsets", "fixed", "rooted")
# per robot, each frame's (parent, kind, q index, flags) in topological order
R, P, X, N = fk_ops.REVOLUTE, fk_ops.PRISMATIC, fk_ops.FIXED, fk_ops.NO_JOINT
EXPECTED = {
    "arm7": [(-1, X, -1, N)] + [(k, R, k, 0) for k in range(7)],
    "free6": [(-1, X, -1, N), (0, P, 0, 0), (1, P, 1, 0), (2, P, 2, 0), (3, R, 3, 0),
              (4, R, 4, 0), (5, R, 5, 0)],
    "branching": [(-1, X, -1, N), (0, R, 0, 0), (1, R, 1, 0), (1, R, 2, 0), (3, P, 3, 0)],
    "mimic": [(-1, X, -1, N), (0, R, 0, 0), (0, R, 0, fk_ops.MIMIC)],
    "offsets": [(-1, X, -1, N), (0, R, 0, fk_ops.JOINT_OFFSET), (1, R, 1, fk_ops.JOINT_OFFSET),
                (2, P, 2, fk_ops.JOINT_OFFSET)],
    "fixed": [(-1, X, -1, N), (0, X, -1, 0), (1, X, -1, 0)],
    "rooted": [(-1, R, 0, 0), (0, R, 1, 0), (1, P, 2, 0)],
}


def make_robot(name: str, directory: str, device) -> pt.RobotSDF:
    """One of :data:`ROBOTS` on ``device``; mesh links are plain ``MeshSDF``s."""
    if name == "arm7":
        urdf, end = make_serial_arm(directory, num_joints=7, segments=6, rings=2)
        chain = pt.build_serial_chain_from_urdf(open(urdf).read(), end, device=device)
        return pt.RobotSDF(chain, path_prefix=directory, device=device)
    if name == "free6":
        pt.mesh.save_obj(pt.mesh.box_mesh((0.1, 0.05, 0.02)), os.path.join(directory, "obj.obj"))
        urdf, _ = make_free_object_urdf(directory, "obj.obj")
        chain = pt.build_chain_from_urdf(open(urdf).read(), device=device)
        return pt.RobotSDF(chain, path_prefix=directory, device=device)
    if name == "offsets":
        return pt.RobotSDF(pt.build_chain_from_mjcf(OFFSET_MJCF, device=device), device=device)
    if name == "rooted":
        chain = pt.build_serial_chain_from_urdf(BRANCHING_URDF, "hand_r", root_link_name="torso",
                                                device=device)
        return pt.RobotSDF(chain, device=device)
    text = {"branching": BRANCHING_URDF, "mimic": MIMIC_URDF, "fixed": FIXED_URDF}[name]
    return pt.RobotSDF(pt.build_chain_from_urdf(text, device=device), device=device)


def configs(robot: pt.RobotSDF, A: int, seed: int, device) -> torch.Tensor:
    M = len(robot.joint_names)
    q = np.random.default_rng(seed).uniform(-2.0, 2.0, (A, M)).astype(np.float32)
    return torch.as_tensor(q, device=device)


def cotangents(robot: pt.RobotSDF, A: int, seed: int, device):
    n = len(robot.sdf_to_link_name) * A
    g = np.random.default_rng(seed + 1).standard_normal((2, n, 4, 4)).astype(np.float32)
    return torch.as_tensor(g[0], device=device), torch.as_tensor(g[1], device=device)


def plain(robot: pt.RobotSDF, q: torch.Tensor):
    """The plain walk over the robot's descriptor (held bit for bit to
    :func:`chain_walk` on the CPU below)."""
    return fk_ops.link_transforms_plain(q, *robot._fk_desc)


def chain_walk(robot: pt.RobotSDF, q: torch.Tensor):
    """The link transforms from ``Chain.fk_matrices``, each SDF link's
    ``offset^-1 o FK(link)^-1`` and its inverse: what the descriptor walk
    must reproduce."""
    fk = robot.chain.fk_matrices(q)
    mats = [tfm.mm(robot._offset_inv[i], tfm.invert_tf(fk[name]))
            for i, name in enumerate(robot.sdf_to_link_name)]
    m = torch.cat(mats, dim=0)
    return m, tfm.invert_tf(m)


def dq_of(fn, q, g_m, g_minv, create_graph=False):
    q = q.detach().requires_grad_(True)
    m, m_inv = fn(q)
    if not m.requires_grad:  # the plain walk of a robot with no actuated joint
        return m, m_inv, torch.zeros_like(q), q
    (dq,) = torch.autograd.grad((m, m_inv), q, (g_m, g_minv), create_graph=create_graph,
                                allow_unused=True)
    return m, m_inv, (torch.zeros_like(q) if dq is None else dq), q


@pytest.fixture(scope="module")
def cpu_robots(tmp_path_factory):
    return {name: make_robot(name, str(tmp_path_factory.mktemp(name)), CPU) for name in ROBOTS}


# -- CPU -----------------------------------------------------------------------


@pytest.mark.parametrize("name", ROBOTS)
def test_descriptor_encodes_the_tree(cpu_robots, name):
    robot = cpu_robots[name]
    desc = robot._fk_desc
    chain = robot.chain
    assert [tuple(r) for r in desc.frames.tolist()] == EXPECTED[name]
    frame_names = chain.get_frame_names()
    assert desc.link_frames.tolist() == [frame_names.index(n) for n in robot.sdf_to_link_name]
    assert torch.equal(desc.offset_inv, robot._offset_inv)
    origins, axes, offsets = chain._static
    for f, fname in enumerate(frame_names):
        assert torch.equal(desc.origins[f], origins[fname])
        assert torch.equal(desc.axes[f], axes[fname])
        if fname in offsets:
            assert torch.equal(desc.joint_offsets[f, 0], offsets[fname][0])
            assert torch.equal(desc.joint_offsets[f, 1], offsets[fname][1])
        else:
            assert torch.equal(desc.joint_offsets[f], torch.eye(4).expand(2, 4, 4))
    mim = desc.mimic.tolist()
    if name == "mimic":
        assert mim == [[1.0, 0.0], [1.0, 0.0], [-0.7, 0.2]]  # Python floats, exact
    else:
        assert all(row == [1.0, 0.0] for row in mim)
    assert desc.frames.dtype == desc.link_frames.dtype == torch.int32
    assert desc.mimic.dtype == torch.float64


@pytest.mark.parametrize("A", [1, 25])
@pytest.mark.parametrize("name", ROBOTS)
def test_op_on_the_cpu_is_the_plain_walk_bit_for_bit(cpu_robots, name, A):
    """``_link_transforms`` on the CPU and the op's CPU kernels against the
    chain walk of ``Chain.fk_matrices``: both outputs and d/dq from random
    cotangents on both, equal in every bit."""
    robot = cpu_robots[name]
    q = configs(robot, A, seed=A, device=CPU)
    g_m, g_minv = cotangents(robot, A, seed=A, device=CPU)
    m_ref, minv_ref, dq_ref, _ = dq_of(lambda x: chain_walk(robot, x), q, g_m, g_minv)
    before = profiling.COUNTERS.copy()
    m, m_inv, dq, _ = dq_of(robot._link_transforms, q, g_m, g_minv)
    assert dict(profiling.COUNTERS - before) == {"path.fk_plain": 1}
    assert torch.equal(m, m_ref) and torch.equal(m_inv, minv_ref)
    assert torch.equal(dq, dq_ref)
    m, m_inv, dq, _ = dq_of(lambda x: fk_ops.fk_link_transforms(x, robot._fk_desc), q, g_m,
                            g_minv)
    assert torch.equal(m, m_ref) and torch.equal(m_inv, minv_ref)
    assert torch.equal(dq, dq_ref)
    assert m.shape == (len(robot.sdf_to_link_name) * A, 4, 4)


@pytest.mark.parametrize("name", ["arm7", "mimic", "rooted"])
def test_plain_path_keeps_second_derivatives(cpu_robots, name):
    """The CPU path's d/dq is differentiable again: its second derivative
    is the chain walk's, bit for bit."""
    robot = cpu_robots[name]
    q = configs(robot, 3, seed=8, device=CPU)
    g_m, g_minv = cotangents(robot, 3, seed=8, device=CPU)
    second = []
    for fn in (robot._link_transforms, lambda x: chain_walk(robot, x)):
        _, _, dq, qq = dq_of(fn, q, g_m, g_minv, create_graph=True)
        (d2,) = torch.autograd.grad((dq * dq).sum(), qq)
        second.append(d2)
    assert torch.equal(second[0], second[1])
    assert second[0].abs().max() > 0


@pytest.mark.parametrize("extra", [-1, 1])
def test_a_wrong_joint_count_raises(cpu_robots, extra):
    """Both branches read ``q`` by the descriptor's joint indices, so a
    ``q`` of another width is refused before either runs."""
    robot = cpu_robots["mimic"]
    q = torch.zeros(3, len(robot.joint_names) + extra)
    with pytest.raises(ValueError, match="joint values"):
        robot._link_transforms(q)


def test_fake_gives_the_shapes(cpu_robots):
    from torch._subclasses.fake_tensor import FakeTensorMode

    robot = cpu_robots["branching"]
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        q = mode.from_tensor(configs(robot, 7, 0, CPU))
        desc = [mode.from_tensor(t) for t in robot._fk_desc]
        m, m_inv = fk_ops.fk_link_transforms_op(q, *desc)
        g = mode.from_tensor(torch.zeros(5 * 7, 4, 4))
        dq = fk_ops.fk_link_transforms_backward_op(g, g, q, *desc)
    assert tuple(m.shape) == tuple(m_inv.shape) == (5 * 7, 4, 4)
    assert m.dtype == m_inv.dtype == torch.float32
    assert tuple(dq.shape) == (7, 4)


def test_ops_pass_opcheck(cpu_robots):
    """The forward op passes every check.  The backward op's CPU kernel
    runs ``torch.func.vjp``, whose wrapped tensors the schema and fake
    cross-checks cannot read, so it takes the registration check here; its
    fake is held by the test above and its values by the bit-for-bit test."""
    robot = cpu_robots["mimic"]
    q = configs(robot, 3, 1, CPU).requires_grad_(True)
    torch.library.opcheck(fk_ops.fk_link_transforms_op, (q, *robot._fk_desc))
    g_m, g_minv = cotangents(robot, 3, 1, CPU)
    torch.library.opcheck(fk_ops.fk_link_transforms_backward_op,
                          (g_m, g_minv, q.detach(), *robot._fk_desc),
                          test_utils="test_autograd_registration")


class _Program(torch.nn.Module):
    def __init__(self, desc):
        super().__init__()
        self.desc = desc

    def forward(self, q):
        return fk_ops.fk_link_transforms(q, self.desc)


def test_export_keeps_one_node_and_d_dq(cpu_robots, tmp_path):
    robot = cpu_robots["branching"]
    q = configs(robot, 6, 2, CPU)
    with torch.enable_grad():
        program = torch.export.export(_Program(robot._fk_desc), (q,))
    path = str(tmp_path / "fk.pt2")
    torch.export.save(program, path)
    loaded = torch.export.load(path)
    nodes = [n for n in loaded.graph.nodes if n.op == "call_function"
             and n.target is torch.ops.pvt.fk_link_transforms.default]
    assert len(nodes) == 1
    g_m, g_minv = cotangents(robot, 6, 2, CPU)
    m_ref, minv_ref, dq_ref, _ = dq_of(robot._link_transforms, q, g_m, g_minv)
    m, m_inv, dq, _ = dq_of(loaded.module(), q, g_m, g_minv)
    assert torch.equal(m, m_ref) and torch.equal(m_inv, minv_ref)
    assert torch.equal(dq, dq_ref)


def test_second_derivative_through_the_op_raises(cpu_robots):
    robot = cpu_robots["branching"]
    q = configs(robot, 2, 3, CPU)
    g_m, g_minv = cotangents(robot, 2, 3, CPU)
    _, _, dq, qq = dq_of(lambda x: fk_ops.fk_link_transforms(x, robot._fk_desc), q, g_m,
                         g_minv, create_graph=True)
    with pytest.raises(RuntimeError, match="no autograd formula"):
        torch.autograd.grad(dq.sum(), qq)


def _invert_tangent(m, dm):
    """``invert_tf``'s derivative at ``m`` along ``dm``: (dR^T, -(dR^T t + R^T dt))."""
    R, t, dR, dt = m[..., :3, :3], m[..., :3, 3], dm[..., :3, :3], dm[..., :3, 3]
    out = torch.zeros_like(dm)
    out[..., :3, :3] = dR.transpose(-1, -2)
    out[..., :3, 3] = -((dR.transpose(-1, -2) @ t[..., None])[..., 0]
                        + (R.transpose(-1, -2) @ dt[..., None])[..., 0])
    return out


def _forward_mode_dq(q, desc, g_m, g_minv):
    """``csrc/fk.cu :: fk_backward``'s design in torch: per actuated joint
    ``j``, every frame's world matrix and its tangent dW/dq_j down the tree
    (a mimic joint's value moves by its multiplier), then both outputs'
    tangents through ``invert_tf``'s linearisation, contracted with their
    cotangents."""
    A, M = q.shape
    mim = desc.mimic.tolist()
    dq = torch.zeros_like(q)
    for j in range(M):
        W, T = [], []
        for f, (parent, kind, src, flags) in enumerate(desc.frames.tolist()):
            if parent < 0:
                w, t = torch.eye(4).expand(A, 4, 4), torch.zeros(A, 4, 4)
            else:
                w, t = W[parent], T[parent]
            if flags & fk_ops.NO_JOINT:
                W.append(w)
                T.append(t)
                continue
            w, t = w @ desc.origins[f], t @ desc.origins[f]
            if kind != fk_ops.FIXED:
                mult, off = mim[f] if flags & fk_ops.MIMIC else (1.0, 0.0)
                x = mult * q[:, src] + off if flags & fk_ops.MIMIC else q[:, src]
                dx = (mult if src == j else 0.0) * torch.ones_like(x)
                mot = torch.eye(4).repeat(A, 1, 1)
                dmot = torch.zeros(A, 4, 4)
                a = desc.axes[f]
                if kind == fk_ops.PRISMATIC:
                    mot[:, :3, 3] = a * x[:, None]
                    dmot[:, :3, 3] = a * dx[:, None]
                else:
                    u = a / torch.clamp(torch.linalg.vector_norm(a), min=1e-12)
                    K = torch.tensor([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])
                    c, s = torch.cos(x)[:, None, None], torch.sin(x)[:, None, None]
                    uu = u[:, None] * u[None, :]
                    mot[:, :3, :3] = c * torch.eye(3) + s * K + (1 - c) * uu
                    dmot[:, :3, :3] = (-s * torch.eye(3) + c * K + s * uu) * dx[:, None, None]
                if flags & fk_ops.JOINT_OFFSET:
                    j0, j1 = desc.joint_offsets[f]
                    mot, dmot = j0 @ mot @ j1, j0 @ dmot @ j1
                w, t = w @ mot, t @ mot + w @ dmot
            W.append(w)
            T.append(t)
        for i, fr in enumerate(desc.link_frames.tolist()):
            ol = desc.offset_inv[i] @ tfm.invert_tf(W[fr])
            dol = desc.offset_inv[i] @ _invert_tangent(W[fr], T[fr])
            rows = slice(i * A, (i + 1) * A)
            dq[:, j] += ((g_m[rows] * dol).sum((-1, -2))
                         + (g_minv[rows] * _invert_tangent(ol, dol)).sum((-1, -2)))
    return dq


@pytest.mark.parametrize("name", ROBOTS)
def test_forward_mode_design_gives_autograds_d_dq(cpu_robots, name):
    """The d/dq kernel's forward-mode algorithm, run in torch in float32,
    against autograd's reverse mode through the plain walk: the same
    derivative, different rounding (the bound below is the one the card
    test holds the kernel to)."""
    robot = cpu_robots[name]
    q = configs(robot, 25, 4, CPU)
    g_m, g_minv = cotangents(robot, 25, 4, CPU)
    _, _, dq_ref, _ = dq_of(robot._link_transforms, q, g_m, g_minv)
    dq = _forward_mode_dq(q, robot._fk_desc, g_m, g_minv)
    assert dq.shape == dq_ref.shape
    torch.testing.assert_close(dq, dq_ref, rtol=0, atol=dq_tolerance(dq_ref))


def dq_tolerance(dq_ref: torch.Tensor) -> float:
    """d/dq's bound for two float32 evaluations in different orders: each
    entry sums 2 x 16 x L products of cotangents (N(0, 1)) with tangents of
    size ~1 through chains of up to 9 rounded 4x4 products.  Forward and
    reverse mode read 1.2-2.3e-7 of the largest |d/dq| apart here (and the
    kernel 1.4-1.5e-7 from autograd on the card at A = 25 and 200), so 2e-5
    of it (at least 2e-5) leaves ~100x room without hiding a wrong term,
    which moves an entry by O(1)."""
    return 2e-5 * max([1.0] + dq_ref.abs().flatten().tolist())


# -- the card --------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FK kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_robots(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FK kernels have no CPU mode")
    dev = torch.device("cuda")
    return {name: make_robot(name, str(tmp_path_factory.mktemp(name)), dev) for name in ROBOTS}


@pytest.mark.cuda
@pytest.mark.parametrize("A", [1, 25, 200, 1000])
@pytest.mark.parametrize("name", ROBOTS)
def test_kernels_match_the_plain_walk(card, card_robots, name, A):
    """Both outputs within 2e-6 (float32 rounding of ~9 chained products of
    entries below ~2, summed in cuBLAS's order in the plain walk), d/dq
    within :func:`dq_tolerance`; one launch each way and one fused path per
    call."""
    robot = card_robots[name]
    q = configs(robot, A, seed=A + 7, device=card)
    g_m, g_minv = cotangents(robot, A, seed=A + 7, device=card)
    m_ref, minv_ref, dq_ref, _ = dq_of(lambda x: plain(robot, x), q, g_m, g_minv)
    before = profiling.COUNTERS.copy()
    m, m_inv, dq, _ = dq_of(robot._link_transforms, q, g_m, g_minv)
    torch.cuda.synchronize()
    counted = dict(profiling.COUNTERS - before)
    want = {"path.fk_fused": 1, "kernel.fk_link_transforms": 1}
    if robot.joint_names:
        want["kernel.fk_link_transforms_backward"] = 1
    assert counted == want
    torch.testing.assert_close(m, m_ref, rtol=0, atol=2e-6)
    torch.testing.assert_close(m_inv, minv_ref, rtol=0, atol=2e-6)
    torch.testing.assert_close(dq, dq_ref, rtol=0, atol=dq_tolerance(dq_ref))


@pytest.mark.cuda
def test_second_derivative_on_the_card_raises(card, card_robots):
    robot = card_robots["arm7"]
    q = configs(robot, 4, 5, card)
    g_m, g_minv = cotangents(robot, 4, 5, card)
    _, _, dq, qq = dq_of(robot._link_transforms, q, g_m, g_minv, create_graph=True)
    with pytest.raises(RuntimeError, match="no autograd formula"):
        torch.autograd.grad(dq.sum(), qq)


@pytest.mark.cuda
def test_served_query_holds_the_fk_node(card, card_robots, tmp_path):
    """``fused_query_fn`` exported on the card keeps FK as one
    ``pvt::fk_link_transforms`` node, and the loaded program's d/dq is the
    live query's."""
    robot = card_robots["branching"]
    path = str(tmp_path / "q.pt2")
    serving.export_robot_query(robot, 4, 64, path)
    graph = torch.export.load(path).graph
    nodes = [n for n in graph.nodes if n.op == "call_function"
             and n.target is torch.ops.pvt.fk_link_transforms.default]
    assert len(nodes) == 1
    query = serving.load_robot_query(path, device=card)
    q = configs(robot, 4, 6, card).requires_grad_(True)
    pts = torch.as_tensor(np.random.default_rng(6).uniform(-0.4, 0.4, (64, 3)).astype(np.float32),
                          device=card)
    v, g = query(q, pts)
    (dq,) = torch.autograd.grad(v.sum() + g.sum(), q)
    v_ref, g_ref = robot.query(q, pts)
    (dq_ref,) = torch.autograd.grad(v_ref.sum() + g_ref.sum(), q)
    assert torch.equal(v, v_ref) and torch.equal(g, g_ref)
    torch.testing.assert_close(dq, dq_ref, rtol=0, atol=1e-6)
