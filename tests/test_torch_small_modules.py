"""The port's small modules against the JAX package on the same inputs
(CPU): the voxel containers and ``voxel_down_sample``, ``is_inside``, the
SDF slice and the posed link meshes (under Agg), the transform functions
(deterministic ones equal, random ones by their properties), the batching
helpers, the factory's drawing hooks, and the flat namespace."""

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pytorch_volumetric_tpu as pv  # noqa: E402
import pytorch_volumetric_tpu_torch as pt  # noqa: E402
from pytorch_volumetric_tpu import transforms as jtf  # noqa: E402
from pytorch_volumetric_tpu.utils.robots import make_serial_arm  # noqa: E402
from pytorch_volumetric_tpu_torch import transforms as ttf  # noqa: E402
from pytorch_volumetric_tpu_torch.utils import batching  # noqa: E402
from pytorch_volumetric_tpu_torch.visualization import fmt  # noqa: E402
from torch_cpu_guard import warm_sqrt  # noqa: E402

warm_sqrt()

CPU = "cpu"


def T(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


# ---------------------------------------------------------------------------
# voxels and volume (twins of tests/test_voxel.py)
# ---------------------------------------------------------------------------

def _known(grid):
    pos, val = grid.get_known_pos_and_values()
    pos, val = np.asarray(pos), np.asarray(val)
    order = np.lexsort(pos.T[::-1])
    return pos[order], val[order]


def test_voxel_grid_set_get_matches_jax():
    gj = pv.VoxelGrid(0.1, [(0, 1), (0, 1)])
    gt = pt.VoxelGrid(0.1, [(0, 1), (0, 1)], device=CPU)
    assert isinstance(gt, pt.Voxels)
    pts = np.array([[0.2, 0.3], [0.71, 0.68]], np.float32)
    gj[jnp.asarray(pts)] = jnp.array([1.5, 2.5])
    gt[T(pts)] = T([1.5, 2.5])
    probe = np.array([[0.2, 0.3], [0.71, 0.68], [0.24, 0.26], [0.9, 0.1]], np.float32)
    np.testing.assert_array_equal(gt[T(probe)].numpy(), np.asarray(gj[jnp.asarray(probe)]))
    np.testing.assert_array_equal(gt[T(probe)].numpy(), [1.5, 2.5, 1.5, 0.0])
    for a, b in zip(_known(gt), _known(gj)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert gt.get_voxel_values().shape == tuple(np.asarray(gj.get_voxel_values()).shape)
    np.testing.assert_allclose(gt.get_voxel_center_points().numpy(),
                               np.asarray(gj.get_voxel_center_points()), atol=1e-6)


def test_expanding_voxel_grid_matches_jax():
    gj = pv.ExpandingVoxelGrid(0.1, [(0, 0.5), (0, 0.5)])
    gt = pt.ExpandingVoxelGrid(0.1, [(0, 0.5), (0, 0.5)], device=CPU)
    for pts, val in (([[0.2, 0.2]], 1.0), ([[1.3, -0.4]], 2.0), ([[0.31, 0.29]], 3.0)):
        gj[jnp.asarray(pts)] = val
        gt[T(pts)] = val
        np.testing.assert_allclose(gt.range_per_dim, gj.range_per_dim, atol=1e-9)
    assert gt.range_per_dim[0][1] >= 1.3 and gt.range_per_dim[1][0] <= -0.4
    probe = np.array([[0.2, 0.2], [1.3, -0.4], [0.31, 0.29], [0.0, 0.0]], np.float32)
    np.testing.assert_array_equal(gt[T(probe)].numpy(), [1.0, 2.0, 3.0, 0.0])
    np.testing.assert_array_equal(gt[T(probe)].numpy(), np.asarray(gj[jnp.asarray(probe)]))
    for a, b in zip(_known(gt), _known(gj)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_voxel_set():
    s = pt.VoxelSet(torch.zeros((0, 3)), torch.zeros((0,)))
    s[T([[1.0, 2, 3]])] = T([4.0])
    s[T([[0.5, 0, 0]])] = 5.0
    pos, val = s.get_known_pos_and_values()
    assert pos.shape == (2, 3) and val.tolist() == [4.0, 5.0]
    with pytest.raises(RuntimeError):
        s[T([[1.0, 2, 3]])]


def test_resize_to_fit_matches_jax():
    gj = pv.VoxelGrid(0.1, [(0, 2), (0, 2)])
    gt = pt.VoxelGrid(0.1, [(0, 2), (0, 2)], device=CPU)
    pts = np.array([[0.5, 0.5], [0.8, 0.9]], np.float32)
    gj[jnp.asarray(pts)] = jnp.array([1.0, 2.0])
    gt[T(pts)] = T([1.0, 2.0])
    gj.resize_to_fit()
    gt.resize_to_fit()
    np.testing.assert_allclose(gt.range_per_dim, gj.range_per_dim, atol=1e-6)
    assert gt.range_per_dim[0][0] >= 0.3 and gt.range_per_dim[0][1] <= 1.0
    np.testing.assert_array_equal(gt[T(pts)].numpy(), [1.0, 2.0])
    empty = pt.VoxelGrid(0.1, [(0, 1)] * 2, device=CPU)
    empty.resize_to_fit()
    assert empty.get_voxel_values().shape == (11, 11)


def test_setitem_below_range_does_not_wrap():
    """Writes below the grid's lower bound are dropped, not wrapped onto
    the far edge."""
    g = pt.VoxelGrid(0.1, [(0.0, 1.0)] * 3, dtype=torch.bool, device=CPU)
    g[T([[-0.35, 0.5, 0.5], [2.0, 0.5, 0.5]])] = True
    pts, _ = g.get_known_pos_and_values()
    assert pts.shape[0] == 0


def test_degenerate_flat_dimension_grid():
    """A span snapped to zero keeps one coordinate with a nonzero index
    resolution: reads at the plane hit the slice, far reads miss."""
    g = pt.VoxelGrid(0.1, [(0.0, 1.0), (0.0, 1.0), (0.5, 0.5)], device=CPU)
    g[T([[0.5, 0.5, 0.5]])] = 3.0
    assert float(g[T([[0.5, 0.5, 0.5]])][0]) == 3.0
    assert float(g[T([[0.5, 0.5, 7.0]])][0]) == 0.0


@pytest.mark.parametrize("ignore_flat_dim", [False, True])
def test_voxel_down_sample_matches_jax(ignore_flat_dim):
    """The reference's down-sampling contract (count bound, reconstruction
    within 2 new resolutions) and the JAX package's centers, on a surface
    and on a flat cloud whose last dimension is dropped and put back."""
    N = 60
    x = np.linspace(-2, 2, N)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    if ignore_flat_dim:
        pts = np.stack((xx.ravel(), yy.ravel(), np.full(N * N, 0.3)), -1)
        rng = np.array([[-3.0, 3.0], [-3.0, 3.0], [0.3, 0.3]])
    else:
        pts = np.stack((xx.ravel(), yy.ravel(), (np.sin(xx) + 2 * np.cos(yy)).ravel()), -1)
        rng = None
    res = 0.2
    c_t = pt.voxel_down_sample(pts, res, range_per_dim=rng, ignore_flat_dim=ignore_flat_dim,
                               device=CPU).numpy()
    c_j = np.asarray(pv.voxel_down_sample(pts, res, range_per_dim=rng,
                                          ignore_flat_dim=ignore_flat_dim))
    key = lambda c: c[np.lexsort(c.T[::-1])]  # noqa: E731
    np.testing.assert_allclose(key(c_t), key(c_j), atol=1e-6)
    assert c_t.shape[0] < pts.shape[0] * (4 / N) / res
    if ignore_flat_dim:
        np.testing.assert_array_equal(c_t[:, 2], np.float32(0.3))
    else:
        np.testing.assert_allclose(np.sin(c_t[:, 0]) + 2 * np.cos(c_t[:, 1]), c_t[:, 2],
                                   atol=2 * res)
    assert pt.voxel_down_sample(np.zeros((0, 3)), res, device=CPU).shape == (0, 3)
    assert pt.bounds_contain_another_bounds([[0, 2], [0, 2]], [[0.5, 1], [0, 2]])
    assert not pt.bounds_contain_another_bounds([[0, 2], [0, 2]], [[-0.5, 1], [0, 2]])


def test_is_inside_matches_jax_and_keeps_dtypes():
    rng = np.array([[0.0, 1.0], [0.0, 2.0]])
    pts = np.array([[0.5, 1.0], [1.5, 1.0], [1.0, 2.0], [-0.1, 0.0]])
    want = np.asarray(pv.is_inside(pts, rng))
    for dtype in (torch.float32, torch.float64, torch.int64):
        got = pt.is_inside(torch.as_tensor(pts).to(dtype), rng)
        assert got.dtype == torch.bool
        if dtype != torch.int64:
            np.testing.assert_array_equal(got.numpy(), want)
    # integer points against a float range promote (1 <= 1.5 holds, not 1 <= 1)
    ints = pt.is_inside(torch.tensor([[1, 1], [2, 1]]), torch.tensor([[0.5, 1.5], [0.0, 2.0]]))
    assert ints.tolist() == [True, False]
    # float64 points within float32's epsilon of a bound keep their answer
    edge = pt.is_inside(torch.tensor([[1.0 + 1e-12, 1.0]], dtype=torch.float64), rng)
    assert edge.tolist() == [False]
    assert pt.is_inside(pts.tolist(), rng, device=CPU).tolist() == want.tolist()


# ---------------------------------------------------------------------------
# visualization (twins of tests/test_visualization.py)
# ---------------------------------------------------------------------------

def test_fmt():
    assert fmt(0) == "surface"
    assert fmt(1.0) == "1" and fmt(0.25) == "0.2" and fmt(-0.5) == "-0.5"


def test_draw_sdf_slice_matches_jax(tmp_path):
    """The plot path under Agg, and values equal to JAX's MeshSDF at the
    points the slice returns."""
    import matplotlib.pyplot as plt

    p = str(tmp_path / "s.obj")
    pt.mesh.save_obj(pt.mesh.icosphere_mesh(0.2, 2), p)
    s = pt.MeshSDF(pt.MeshObjectFactory(p, device=CPU))
    qr = np.array([[-0.3, 0.3], [0.0, 0.0], [-0.3, 0.3]])
    val, grad, pts, ax, c1, c2, v = pt.draw_sdf_slice(s, qr, resolution=0.05, plot_grad=True)
    assert ax is not None and c1 is not None and c2 is not None
    assert any(type(a).__name__ == "Quiver" for a in ax.get_children())
    assert abs(float(np.min(v)) + 0.2) < 0.02
    plt.savefig(str(tmp_path / "slice.png"))
    plt.close("all")
    assert (tmp_path / "slice.png").exists()
    v_j, g_j = pv.MeshSDF(pv.MeshObjectFactory(p))(jnp.asarray(pts.numpy()))
    np.testing.assert_allclose(val.numpy(), np.asarray(v_j), atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(g_j), atol=1e-4)
    with pytest.raises(RuntimeError):
        pt.draw_sdf_slice(s, np.array([[-0.3, 0.3]] * 3), resolution=0.05, do_plot=False)


def test_draw_sdf_slice_takes_the_coherent_route(tmp_path):
    """A composition of cached children goes through the brick path; its
    values equal the generic query at the returned points."""
    ball = pt.CachedSDF("ball", 0.04, np.array([[-0.5, 0.5]] * 3),
                        pt.SphereSDF(0.3, device=CPU), cache_path=str(tmp_path / "c.npz"))
    comp = pt.ComposedSDF([ball], pt.Transform3d(matrix=torch.eye(4)[None]))
    calls = []
    real = comp.query_coherent
    comp.query_coherent = lambda *a, **k: calls.append(1) or real(*a, **k)
    qr = np.array([[-0.4, 0.4], [0.0, 0.0], [-0.4, 0.4]])
    val, grad, pts, *_ = pt.draw_sdf_slice(comp, qr, resolution=0.02, do_plot=False)
    assert calls and val.shape == (41 * 41,)
    v_ref, g_ref = comp(pts)
    np.testing.assert_array_equal(val.numpy(), v_ref.numpy())
    np.testing.assert_array_equal(grad.numpy(), g_ref.numpy())


def test_get_transformed_meshes_matches_jax(tmp_path):
    d = str(tmp_path)
    urdf, end = make_serial_arm(d, num_joints=2, segments=6, rings=2)
    text = open(urdf).read()
    q = np.array([0.3, -0.4], np.float32)
    rj = pv.RobotSDF(pv.build_serial_chain_from_urdf(text, end), path_prefix=d)
    rt = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device=CPU), path_prefix=d)
    rj.set_joint_configuration(jnp.asarray(q))
    rt.set_joint_configuration(torch.as_tensor(q))
    world = pt.Translate(0.1, 0.0, -0.2, device=CPU)
    mj = pv.visualization.get_transformed_meshes(rj, pv.Translate(0.1, 0.0, -0.2))
    mt = pt.get_transformed_meshes(rt, world)
    assert len(mt) == len(mj) == 3
    for a, b in zip(mt, mj):
        np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-5)
        np.testing.assert_array_equal(a.faces, b.faces)
    assert pt.get_transformed_meshes(rt)[1].aabb()[2, 1] > 0.15


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def test_deterministic_transforms_match_jax():
    R = np.asarray(jax.jit(jtf.random_rotations, static_argnums=1)(jax.random.PRNGKey(0), 16))
    # include the branch cases: identity, 180-degree turns about each axis
    R = np.concatenate([R, np.eye(3)[None], np.diag([1.0, -1, -1])[None],
                        np.diag([-1.0, 1, -1])[None], np.diag([-1.0, -1, 1])[None]]).astype(
        np.float32)
    np.testing.assert_allclose(ttf.matrix_to_quaternion(T(R)).numpy(),
                               np.asarray(jax.jit(jtf.matrix_to_quaternion)(R)), atol=1e-6)
    ang = np.array([[0.3, -0.5, 1.2], [-1.0, 0.2, 2.5]], np.float32)
    m = ttf.euler_angles_to_matrix(T(ang))
    np.testing.assert_allclose(ttf.matrix_to_euler_angles_xyz(m).numpy(),
                               np.asarray(jax.jit(jtf.matrix_to_euler_angles_xyz)(np.asarray(m))),
                               atol=1e-6)
    np.testing.assert_allclose(ttf.matrix_to_euler_angles_xyz(m).numpy(), ang, atol=1e-5)
    np.testing.assert_allclose(ttf.translation_tf(0.1, -0.2, 0.3, device=CPU).numpy(),
                               np.asarray(jtf.translation_tf(0.1, -0.2, 0.3)), atol=0)
    tf = np.array(jax.jit(lambda r: jtf.make_tf(pos=jnp.array([1.0, -2.0, 0.5]), rot=r))(R[:4]))
    tf[1, :3, :3] *= 2.0  # not rigid: the inverse-transpose matters
    n = np.random.default_rng(0).normal(size=(4, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(ttf.transform_normals(T(tf), T(n)).numpy(),
                               np.asarray(jax.jit(jtf.transform_normals)(tf, n)), atol=1e-6)
    one = ttf.Transform3d(matrix=T(tf[0]), device=CPU)
    np.testing.assert_allclose(one.transform_normals(T(n[0])).numpy(),
                               np.asarray(jax.jit(jtf.transform_normals)(tf[0], n[0])),
                               atol=1e-6)
    r6 = ttf.matrix_to_rotation_6d(T(R))
    np.testing.assert_array_equal(r6.numpy(), np.asarray(jtf.matrix_to_rotation_6d(R)))


def _assert_rotations(R):
    R = R.numpy().reshape(-1, 3, 3)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (len(R), 1, 1)),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_random_transforms_by_their_properties():
    g = torch.Generator().manual_seed(3)
    _assert_rotations(pt.random_rotation(g, device=CPU))
    Rs = ttf.random_rotations(g, 256, device=CPU)
    _assert_rotations(Rs)
    # uniform on SO(3): the mean rotation is ~0, the trace's mean is ~0
    assert np.abs(Rs.numpy().mean(axis=0)).max() < 0.15
    q = ttf.matrix_to_quaternion(Rs)
    np.testing.assert_allclose(ttf.quaternion_to_matrix(q).numpy(), Rs.numpy(), atol=1e-5)
    again = ttf.random_rotations(torch.Generator().manual_seed(3), 2, device=CPU)
    assert again.shape == (2, 3, 3)

    base = pt.Transform3d(pos=torch.tensor([0.5, 0.0, 0.0]), device=CPU)
    pert = base.sample_perturbations(512, radian_sigma=0.05, translation_sigma=0.01,
                                     generator=torch.Generator().manual_seed(7))
    m = pert.get_matrix()
    assert m.shape == (512, 4, 4)
    _assert_rotations(m[:, :3, :3])
    dt = m[:, :3, 3].numpy() - np.array([0.5, 0, 0])
    assert abs(dt.std() - 0.01) < 0.002 and np.abs(dt).max() < 0.06
    # rotation angle of R: its vector ~ N(0, 0.05^2 I), so E[angle^2] = 3 * 0.05^2
    cos = np.clip((np.trace(m[:, :3, :3].numpy(), axis1=1, axis2=2) - 1) / 2, -1, 1)
    assert abs(np.mean(np.arccos(cos) ** 2) / (3 * 0.05 ** 2) - 1) < 0.2
    np.testing.assert_array_equal(m[:, 3].numpy(), np.tile([0, 0, 0, 1.0], (512, 1)))
    default = base.sample_perturbations(4, 0.05, 0.01)
    assert torch.equal(default.get_matrix(), base.sample_perturbations(4, 0.05, 0.01).get_matrix())


# ---------------------------------------------------------------------------
# batching, factory hooks, namespace
# ---------------------------------------------------------------------------

def test_batching_helpers():
    x = torch.arange(24.0).reshape(2, 3, 4)
    flat, unflatten = batching.flatten_batch(x)
    assert flat.shape == (6, 4)
    assert unflatten(flat[:, :2]).shape == (2, 3, 2)
    flat0, unflatten0 = batching.flatten_batch(torch.zeros(4))
    assert flat0.shape == (1, 4) and unflatten0(flat0).shape == (4,)
    a = np.ones((2, 3))
    assert batching.np_pad_to(a, 2) is a
    padded = batching.np_pad_to(a, 5, axis=1, value=-1.0)
    assert padded.shape == (2, 5) and (padded[:, 3:] == -1).all()


def test_factory_drawing_hooks(tmp_path):
    p = str(tmp_path / "b.obj")
    pt.mesh.save_obj(pt.mesh.box_mesh((0.1, 0.2, 0.3)), p)
    fac = pt.MeshObjectFactory(p, scale=2.0, vis_frame_pos=(0.1, 0, 0), device=CPU)
    assert fac.make_collision_obj(0.0) == (None, None)
    seen = {}

    class Drawer:
        def draw_mesh(self, name, path, pose, **kw):
            seen.update(name=name, path=path, pose=pose, **kw)
            return 7

    assert fac.draw_mesh(Drawer(), "obj", ([0, 0, 0], [0, 0, 0, 1]), (1, 0, 0, 1)) == 7
    assert seen["path"] == p and seen["scale"] == 2.0
    np.testing.assert_allclose(seen["vis_frame_pos"], [0.2, 0, 0])


def _init_exports(package) -> set:
    """The names a package's ``__init__.py`` binds by its own imports (its
    source, not ``vars``: importing a submodule elsewhere in the process
    adds it as an attribute too)."""
    import ast

    tree = ast.parse(open(package.__file__).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


def test_namespace_is_a_superset_of_the_jax_package():
    """Every public name of ``pytorch_volumetric_tpu/__init__.py`` is
    exported by the port's ``__init__``."""
    jax_names = _init_exports(pv)
    assert {"NeuralSDF", "draw_sdf_slice", "is_inside", "models", "robots"} <= jax_names
    missing = sorted(jax_names - _init_exports(pt))
    assert not missing, missing
    assert all(hasattr(pt, n) for n in jax_names)
    for name in ("NeuralSDF", "ConfigSpaceNeuralSDF", "fit_neural_sdf",
                 "fit_config_space_sdf"):
        assert getattr(pt, name) is getattr(pt.models, name)
