"""The port's public surface against the JAX package's.

The ``Transform3d`` members (indexing, ``dtype``, ``compose``,
``transform_points``, ``to``, ``device``) are held to the JAX class on the
CPU on the same inputs (tolerance 1e-6 absolute: the same float32 products
in the same order), and the keywords the port accepts for the reference's
signatures are exercised.

The surface test reads both packages' sources with ``ast`` (nothing is
imported): for every module of the JAX package, each public class and
top-level function must exist in the port's module of the same path, with
every public method (and property) and every parameter name the JAX one
has.  Each difference the port keeps on purpose is listed in ``ALLOWED``
with its reason; the scan must find exactly those, so a new hole fails the
first test and a stale entry fails the second.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu import transforms as jtf
from pytorch_volumetric_tpu_torch import transforms as ttf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "pytorch_volumetric_tpu")
PORT_PKG = os.path.join(ROOT, "pytorch_volumetric_tpu_torch")
ATOL = 1e-6

_PYTREE = "the JAX pytree protocol; torch tensors need no registration"
_KEY = "a JAX PRNG key; the port draws from a torch.Generator (`generator`)"
_PALLAS = ("the Pallas sweep; the port's counterpart is ops/closest_point.py "
           "(K1 in csrc/closest_point.cu)")
_PLATFORM = "a JAX device or platform list; the port names a torch device"

# (module path, name, member or parameter) -> reason
ALLOWED = {
    ("mesh.py", "MeshScene", "tree_flatten"): _PYTREE,
    ("mesh.py", "MeshScene", "tree_unflatten"): _PYTREE,
    ("transforms.py", "Transform3d", "tree_flatten"): _PYTREE,
    ("transforms.py", "Transform3d", "tree_unflatten"): _PYTREE,
    ("transforms.py", "random_rotation", "key"): _KEY,
    ("transforms.py", "random_rotations", "key"): _KEY,
    ("transforms.py", "sample_perturbations", "key"): _KEY,
    ("transforms.py", "Transform3d.sample_perturbations", "key"): _KEY,
    ("visualization.py", "draw_sdf_slice", "key"): _KEY,
    ("visualization.py", "draw_sdf_slice", "device"):
        "the slice is evaluated where the SDF's tables live",
    ("ops/narrow_band.py", "make_straight_through_query", None):
        "a jax.custom_vjp builder; the port's counterpart is "
        "ops/straight_through.py",
    ("ops/pallas/closest_point.py", "pallas_closest_query_soa", None): _PALLAS,
    ("ops/pallas/closest_point.py", "mesh_closest_query_pallas", None): _PALLAS,
    ("utils/batching.py", "as_float_array", None):
        "its counterpart is as_float_tensor",
    ("parallel/sharding.py", "make_device_mesh", "devices"): _PLATFORM,
    ("utils/serving.py", "export_robot_query", "platforms"): _PLATFORM,
    ("utils/serving.py", "export_robot_grid_query", "platforms"): _PLATFORM,
}


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _public(name):
    return not name.startswith("_") or (name.startswith("__") and name.endswith("__"))


def _surface(path):
    """``{name: params}`` for a module's public functions and
    ``{name: {method: params}}`` for its public classes, or None when the
    file does not exist."""
    if not os.path.exists(path):
        return None
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = {m.name: _params(m) for m in node.body
                              if isinstance(m, ast.FunctionDef) and _public(m.name)}
    return out


def surface_differences(jax_pkg=JAX_PKG, port_pkg=PORT_PKG):
    """Every (module, name, member or parameter) the JAX package has and
    the port lacks; ``None`` in the last place when the whole function or
    class is missing."""
    diffs = set()
    for root, _, files in os.walk(jax_pkg):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), jax_pkg).replace(os.sep, "/")
            js = _surface(os.path.join(jax_pkg, rel))
            ts = _surface(os.path.join(port_pkg, rel)) or {}
            for name, spec in js.items():
                if name not in ts:
                    diffs.add((rel, name, None))
                elif isinstance(spec, list):
                    diffs |= {(rel, name, p) for p in spec if p not in ts[name]}
                else:
                    for m, ps in spec.items():
                        if m not in ts[name]:
                            diffs.add((rel, name, m))
                        else:
                            diffs |= {(rel, f"{name}.{m}", p) for p in ps
                                      if p not in ts[name][m]}
    return diffs


def test_surface_differences_are_exactly_the_allowlist():
    diffs = surface_differences()
    assert diffs - set(ALLOWED) == set(), "the port lacks these"
    assert set(ALLOWED) - diffs == set(), "allowlisted, yet the port has these"


@pytest.mark.parametrize("entry", sorted(ALLOWED, key=str), ids=str)
def test_allowlist_entry_is_a_real_difference(entry):
    """Each entry, taken out of the allowlist, makes the surface check
    fail: it names a difference the scan finds."""
    assert ALLOWED[entry]
    rest = {k: v for k, v in ALLOWED.items() if k != entry}
    assert surface_differences() - set(rest) == {entry}


def test_surface_scan_sees_a_removed_member(tmp_path):
    """A port module with ``Transform3d.compose`` deleted shows up as a
    difference (the scan reads the file, not an import)."""
    port = tmp_path / "port"
    src = open(os.path.join(PORT_PKG, "transforms.py")).read()
    tree = ast.parse(src)
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "Transform3d":
            node.body = [m for m in node.body
                         if not (isinstance(m, ast.FunctionDef) and m.name == "compose")]
    port.mkdir()
    (port / "transforms.py").write_text(ast.unparse(tree))
    diffs = {d for d in surface_differences(port_pkg=str(port))
             if d[0] == "transforms.py"}
    assert ("transforms.py", "Transform3d", "compose") in diffs
    assert ("transforms.py", "Transform3d", "transform_points") not in diffs


# ---------------------------------------------------------------------------
# Transform3d (tests/test_transforms.py's cases, held to the JAX class)
# ---------------------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(matrix):
    m = np.array(matrix, dtype=np.float32)
    return jtf.Transform3d(matrix=jnp.asarray(m)), ttf.Transform3d(matrix=torch.as_tensor(m))


def _random_tf(seed, n):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return np.asarray(jtf.make_tf(pos=jnp.asarray(t), rot=jnp.asarray(q)))


def test_transform3d_stack_and_transform_points():
    j = jtf.Translate(0.1, 0, 0).stack(jtf.Translate(-0.2, 0, 0.2))
    t = ttf.Translate(0.1, 0, 0, device="cpu").stack(ttf.Translate(-0.2, 0, 0.2, device="cpu"))
    assert tuple(t.get_matrix().shape) == (2, 4, 4)
    out = t.transform_points(torch.zeros(5, 3))
    assert tuple(out.shape) == (2, 5, 3)
    np.testing.assert_allclose(_np(out), _np(j.transform_points(jnp.zeros((5, 3)))), atol=ATOL)
    np.testing.assert_allclose(_np(out[0, :, 0]), 0.1, atol=ATOL)
    np.testing.assert_allclose(_np(out[1, :, 2]), 0.2, atol=ATOL)


@pytest.mark.parametrize("mshape,pshape", [((4, 4), (7, 3)), ((1, 4, 4), (7, 3)),
                                           ((3, 4, 4), (7, 3)), ((3, 4, 4), (3, 7, 3)),
                                           ((4, 4), (2, 7, 3))])
def test_transform3d_transform_points_shapes(mshape, pshape):
    """The squeeze rule: a ``[4, 4]`` matrix and ``[N, 3]`` points give
    ``[N, 3]``; anything else goes through the ``[B, 4, 4]`` batch."""
    n = int(np.prod(mshape[:-2], dtype=int))
    m = _random_tf(1, n).reshape(mshape)
    pts = np.random.default_rng(2).normal(size=pshape).astype(np.float32)
    j, t = _pair(m)
    want = _np(j.transform_points(jnp.asarray(pts)))
    got = t.transform_points(torch.as_tensor(pts))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want, atol=ATOL)
    # numpy points are accepted as the JAX class accepts them
    np.testing.assert_allclose(_np(t.transform_points(pts)), want, atol=ATOL)


def test_transform3d_compose_order():
    """``a.compose(b)`` applies ``b`` first (rotate, then translate)."""
    rot = jtf.axis_angle_to_matrix(jnp.array([0.0, 0, 1.0]), jnp.pi / 2)
    ja = jtf.Transform3d(pos=jnp.array([1.0, 0, 0]))
    jb = jtf.Transform3d(rot=rot)
    ta = ttf.Transform3d(pos=torch.tensor([1.0, 0, 0]))
    tb = ttf.Transform3d(rot=torch.as_tensor(np.asarray(rot)))
    p = np.array([[1.0, 0, 0]], dtype=np.float32)
    got = ta.compose(tb).transform_points(torch.as_tensor(p))
    np.testing.assert_allclose(_np(got)[0], [[1.0, 1.0, 0.0]], atol=ATOL)
    np.testing.assert_allclose(_np(got), _np(ja.compose(jb).transform_points(p)), atol=ATOL)


def test_transform3d_compose_many_batched():
    ms = [_random_tf(s, 3) for s in (3, 4, 5)]
    js, ts = zip(*[_pair(m) for m in ms])
    want = js[0].compose(js[1], js[2]).get_matrix()
    got = ts[0].compose(ts[1], ts[2]).get_matrix()
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    # a single transform broadcasts against a batch
    j1, t1 = _pair(ms[0][0])
    np.testing.assert_allclose(_np(t1.compose(ts[1]).get_matrix()),
                               _np(j1.compose(js[1]).get_matrix()), atol=1e-5)


@pytest.mark.parametrize("item", [0, -1, slice(1, 3), np.array([2, 0])], ids=str)
def test_transform3d_getitem(item):
    j, t = _pair(_random_tf(6, 4))
    jm, tm = j[item].get_matrix(), t[item].get_matrix()
    assert tuple(tm.shape) == jm.shape
    np.testing.assert_array_equal(_np(tm), _np(jm))
    assert len(t[item]) == len(j[item])


def test_transform3d_dtype_device_and_to():
    j, t = _pair(_random_tf(7, 2))
    assert t.dtype == torch.float32 and str(j.dtype) == "float32"
    assert t.device == torch.device("cpu")
    t64 = t.to(dtype=torch.float64)
    assert t64.dtype == torch.float64 and t64.device == t.device
    np.testing.assert_array_equal(_np(t64.get_matrix()), _np(t.get_matrix()).astype(np.float64))
    # the dtype carries through the members that make new transforms
    assert t64.inverse().dtype == torch.float64
    assert t64.compose(t64).dtype == torch.float64
    assert t64[0].dtype == torch.float64
    assert t64.stack(t64).dtype == torch.float64
    assert t64.transform_points(np.zeros((3, 3))).dtype == torch.float64
    assert t.to(device="cpu").device == torch.device("cpu")
    assert t.to().dtype == torch.float32


def test_reference_keywords_are_accepted(tmp_path):
    mesh = pt.mesh.box_mesh((0.2, 0.3, 0.4))
    scene = pt.mesh.MeshScene.from_mesh(mesh, dtype=torch.float32, device="cpu")
    jscene = pv.mesh.MeshScene.from_mesh(pv.mesh.box_mesh((0.2, 0.3, 0.4)), dtype=jnp.float32)
    np.testing.assert_array_equal(_np(scene.tri), _np(jscene.tri))
    assert pt.mesh.MeshScene.from_mesh(mesh, dtype=torch.float64,
                                       device="cpu").tri.dtype == torch.float64

    rng_ = np.array([[0.0, 0.3], [0.0, 0.4], [0.0, 0.5]])
    jv = pv.voxel.VoxelGrid(0.1, rng_, dtype=jnp.float32).voxels
    tv = pt.voxel.VoxelGrid(0.1, rng_, dtype=torch.float32, device="cpu").voxels
    rng = np.random.default_rng(0)
    keys = np.stack([rng.integers(0, n, 16) for n in jv.shape], axis=-1)
    want = np.asarray(jv.ravel_multi_index(jnp.asarray(keys, jnp.int32), shape=jv.shape))
    # the grid's own shape sets the strides, whatever ``shape`` says
    got = tv.ravel_multi_index(torch.as_tensor(keys), shape=None)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(tv.ravel_multi_index(torch.as_tensor(keys),
                                                           shape=tv.shape)), want)

    obj = pt.sdf.MeshObjectFactory(mesh=mesh, device="cpu")
    p, n, _ = pt.sdf.sample_mesh_points(obj, num_points=32, name="box",
                                        dbpath=str(tmp_path / "pts.npz"),
                                        device="cpu", cache=None)
    assert tuple(p.shape) == (32, 3) and tuple(n.shape) == (32, 3)
