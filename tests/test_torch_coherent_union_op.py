"""The coherent per-tile nearest union as the op ``pvt::coherent_union_tile``
(``ops/coherent_union.py``; its kernel ``csrc/coherent_union.cu`` runs only
on the card) on the CPU, where the op is the plain version.  The op takes
the world points and the children's obj_to_link rows ``T``; its CPU kernel
forms the link-frame points with ``transforms.transform_points`` first.

- against the JAX package's ``_coherent_union_lookup_tile`` and
  ``_coherent_union_values`` fed the link-frame points that the port's
  ``transform_points`` makes (tiles around the junction of 2 and 4 cached
  spheres, some tiles out of the grid, NaN and +-inf points, each
  configuration a random rotation and shift of the junction's frames,
  random rotations ``Rb``), at the default residual fraction and at 1e-9,
  where the lane overflows.  Tolerances are the coherent path's
  against the JAX package (``test_torch_coherent``): values 1e-5,
  gradients 1e-4, winners and NaN places equal;
- the op's CPU kernel bit for bit the plain ``_union_tile_eval`` on
  ``transform_points(T, points)`` in the tile layout;
- the op's schema and fake implementation (``torch.library.opcheck``) and
  the wrapper's refusals;
- the kernel's design mirrored in torch: the winner by an in-order scan,
  the middle tiles as those with four or more distinct in-grid winners
  (the lanes' four-smallest lists merged as the kernel merges them), each
  point's gradient from its winner alone, then the overflow poisoned in a
  second pass (a cumsum of the tile flags) -- equal to the plain
  ``_union_tile_eval``, the lane overflowing or not;
- a served grid query (``utils/serving``) whose graph holds the op, equal to
  the live ``query_grid``.

The trilinear union's op ``pvt::coherent_union_tile_tri``
(``ops/coherent_union_tri.py``, kernel ``csrc/coherent_union_tri.cu``,
CU-T) on trilinear caches of the same junctions: its schema and fake
implementation, its CPU kernel bit for bit the plain ``_union_tile_tri_eval``
and ``_union_values_tri_eval`` on ``transform_points(T, points)``, the
wrapper's refusals, CU-T's design mirrored in torch (each child's
trilinear cell, the tile's anchor from its lanes' minimum lower corners,
the 8-corner lerps from 0 plus the first term, the winner by an in-order
scan, its gradient from its own gradient brick or, in a middle tile, its
packed rows, the values only in amin's four-accumulator fold) equal to the
plain version, and a served grid of a trilinear arm whose graph holds the
op.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu import sdf as jsdf
from pytorch_volumetric_tpu.sdf import coherent_fast_tables as jax_fast_tables
from pytorch_volumetric_tpu_torch import sdf as tsdf
from pytorch_volumetric_tpu_torch.ops import coherent_union as cu
from pytorch_volumetric_tpu_torch.ops import coherent_union_tri as cut
from pytorch_volumetric_tpu_torch.utils import serving
from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm
from test_torch_coherent import _junction
from torch_cpu_guard import warm_sqrt

warm_sqrt()

V_TOL, G_TOL = 1e-5, 1e-4
SEG, B, FS = 12, 2, 48


@pytest.fixture(scope="module")
def junctions(tmp_path_factory):
    """``C -> (JAX composition, port composition)`` for 2 and 4 spheres."""
    return {c: _junction(str(tmp_path_factory.mktemp(f"j{c}")), n_children=c) for c in (2, 4)}


@pytest.fixture(scope="module")
def tri_junctions(tmp_path_factory):
    """The junctions on trilinear caches, the spheres on a circle of 0.03:
    ``C -> (JAX composition, port composition)``.  The smooth field's
    winners meet at the centre only where the spheres stand apart: tiles
    around it then hold four winners."""
    return {c: _junction(str(tmp_path_factory.mktemp(f"t{c}")), n_children=c, radius=0.03,
                         interpolation="trilinear") for c in (2, 4)}


def _rotations(rng, shape):
    q, r = np.linalg.qr(rng.normal(size=shape + (3, 3)))
    return (q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]).astype(np.float32)


def _inputs(ct, seed, seg=SEG, fs=FS, near=0.05):
    """``(points [FS * seg, 3], T [C, B, 4, 4], Rb [C, B, 3, 3])`` in
    numpy: one world point set of tiles at random centres (most within
    ``near`` of the junction, one in six up to 0.8 away: out of the grid),
    their points within 0.01 of the centre; in one tile in eight one
    coordinate of every point is NaN, +inf or -inf (every fourth such tile
    all NaN), so that the tile keeps the contract (the JAX package reads a
    tile that breaks it through a one-hot that misses, the port clamps its
    offsets: they differ there by design).  ``T``: each child's frame (the
    junction's frames translate) after a random rotation about the junction
    and a shift of up to 0.003, one for each configuration."""
    rng = np.random.default_rng(seed)
    far = rng.random(fs) < 1 / 6
    centre = np.where(far[:, None], rng.uniform(-0.8, 0.8, (fs, 3)),
                      rng.uniform(-near, near, (fs, 3)))
    obj = (centre[:, None] + rng.uniform(-0.01, 0.01, (fs, seg, 3))).astype(np.float32)
    for j, f in enumerate(rng.choice(fs, size=max(4, fs // 8), replace=False)):
        obj[f, :, j % 3] = (np.nan, np.inf, -np.inf)[j % 3]
        if j % 4 == 3:
            obj[f] = np.nan
    m = ct.obj_frame_to_link_frame.get_matrix().numpy()
    pose = np.tile(np.eye(4), (B, 1, 1))
    pose[:, :3, :3] = _rotations(rng, (B,))
    pose[:, :3, 3] = rng.uniform(-0.003, 0.003, (B, 3))
    T = np.einsum("cij,bjk->cbik", m, pose).astype(np.float32)
    return obj.reshape(-1, 3), T, _rotations(rng, (len(m), B))


def _link_points(points, T, seg=SEG):
    """The children's link-frame points ``[C, B, FS, seg, 3]`` as the port's
    ``transforms.transform_points`` makes them."""
    return tsdf._link_points(torch.as_tensor(T), torch.as_tensor(points), seg).numpy()


def _port(ct, points, T, Rb, frac, values_only=False, seg=SEG):
    tables = tsdf.coherent_fast_tables(tuple(ct.sdfs))
    cap = tsdf.residual_capacity(T.shape[1] * (points.shape[0] // seg), frac)
    with torch.no_grad():
        return cu.coherent_union_tile(tables, torch.as_tensor(points), torch.as_tensor(T), seg,
                                      torch.as_tensor(Rb), cap, values_only=values_only)


def _jax(cj, pts_c, Rb, frac, seg=SEG):
    """The JAX package's union on the same link-frame points, in the port's
    ``[B, FS, seg]`` layout: ``(val, g_obj, win)`` and the values-only
    ``val``."""
    children = tuple(cj.sdfs)
    smalls = [c._coherent_tables() for c in children]
    ft = jax_fast_tables(children)
    bricks = tuple(t.bricks for t in ft)
    g_cat = jnp.concatenate([t.gbricks for t in ft])
    vg_cat = jnp.concatenate([t.vg for t in ft])
    lookup = jsdf._coherent_union_lookup_tile(
        smalls, [(b.shape, b.dtype) for b in bricks], (g_cat.shape, g_cat.dtype),
        (vg_cat.shape, vg_cat.dtype), (Rb.shape, Rb.dtype), seg=seg, residual_frac=frac)
    pj = jnp.asarray(np.swapaxes(pts_c, 2, 3))
    val, g_obj, win = jax.jit(lookup)(pj, bricks, g_cat, vg_cat, jnp.asarray(Rb))
    vo = jax.jit(jsdf._coherent_union_values(smalls, seg=seg))(pj, bricks)
    return tuple(np.swapaxes(np.asarray(x), 1, 2) for x in (val, g_obj, win, vo))


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = ~np.isnan(a)
    np.testing.assert_array_equal(np.isinf(a[fin]), np.isinf(b[fin]))
    fin &= np.isfinite(a)
    assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= tol


@pytest.mark.parametrize("C,frac", [(2, 0.04), (4, 0.04), (4, 1e-9)])
def test_op_matches_jax(junctions, C, frac):
    cj, ct = junctions[C]
    points, T, Rb = _inputs(ct, seed=C)
    pts_c = _link_points(points, T)
    val, g_obj, win, g_link = _port(ct, points, T, Rb, frac)
    vj, gj, wj, voj = _jax(cj, pts_c, Rb, frac)
    assert val.shape == (B, FS, SEG) and g_obj.shape == g_link.shape == (B, FS, SEG, 3)
    assert win.dtype == torch.int64
    np.testing.assert_array_equal(win.numpy(), wj)
    _close(val, vj, V_TOL)
    _close(g_obj, gj, G_TOL)
    vo = _port(ct, points, T, Rb, frac, values_only=True)
    _close(vo, voj, V_TOL)
    assert torch.equal(vo, val)
    finite = np.isfinite(pts_c).all(axis=(0, -1))
    assert np.isnan(pts_c).any() and np.isinf(pts_c).any()
    if C > 3:
        # tiles of four winners exist, and at 1e-9 the lane (one tile)
        # overflows: NaN gradients at finite points
        middle = tsdf._tile_candidate_ids(win, _valid_of_winner(ct, pts_c, win), C)[1]
        assert int(middle.sum()) >= 2
        overflow = torch.isnan(g_link).any(dim=-1) & torch.as_tensor(finite)
        assert bool(overflow.any()) == (frac < 1e-6)


def _valid_of_winner(ct, pts_c, win):
    tables = tsdf.coherent_fast_tables(tuple(ct.sdfs))
    valid = tsdf._nearest_union(tables, torch.as_tensor(pts_c))[1]
    return valid.gather(0, win[None])[0]


def _op_args(ct, points, T, Rb, values_only, mod=cu):
    tables = tsdf.coherent_fast_tables(tuple(ct.sdfs))
    return (torch.as_tensor(points), torch.as_tensor(T),
            torch.as_tensor(Rb) if not values_only else torch.empty(0),
            *mod.op_args(tables, values_only), SEG,
            tsdf.residual_capacity(B * (points.shape[0] // SEG)), values_only)


# the nearest cases keep the ids they had before the trilinear op's
@pytest.mark.parametrize("union,values_only",
                         [("nearest", False), ("nearest", True), ("tri", False), ("tri", True)],
                         ids=["False", "True", "tri-False", "tri-True"])
def test_op_schema_and_fake(request, union, values_only):
    mod = {"nearest": cu, "tri": cut}[union]
    op = {"nearest": cu.coherent_union_tile_op, "tri": cut.coherent_union_tile_tri_op}[union]
    _, ct = request.getfixturevalue({"nearest": "junctions", "tri": "tri_junctions"}[union])[4]
    args = _op_args(ct, *_inputs(ct, seed=5, fs=8), values_only, mod)
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                                           else [mode.from_tensor(t) for t in a]
                                           if isinstance(a, list) else a for a in args))
    for r, f in zip(real, fake):
        assert r.shape == f.shape and r.dtype == f.dtype
    assert real[0].shape == (B, 8, SEG)
    if values_only:
        assert all(r.numel() == 0 for r in real[1:])


def test_wrapper_refuses_what_the_kernel_does_not_take(junctions):
    _, ct = junctions[4]
    tables = tsdf.coherent_fast_tables(tuple(ct.sdfs))
    points, T, Rb = (torch.as_tensor(x) for x in _inputs(ct, seed=6, fs=4))
    with pytest.raises(ValueError, match="unsupported device"):
        cu.coherent_union_tile(tables, points.to("meta"), T.to("meta"), SEG, Rb.to("meta"), 32)
    with pytest.raises(ValueError, match="residual lane's capacity"):
        cu.coherent_union_tile(tables, points, T, SEG, Rb)

    def cuda_impl(pts, t, rb, seg=SEG, values_only=False, **change):
        fields = dict(zip(cu.FIELDS, cu.op_args(tables, values_only)))
        fields.update(change)
        return cu._coherent_union_tile_op_cuda(pts, t, rb, *fields.values(), seg, 32,
                                               values_only)

    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_impl(points, T, Rb)
    with pytest.raises(ValueError, match="capacity must be >= 0"):
        cu._coherent_union_tile_op_cuda(points, T, Rb, *cu.op_args(tables), SEG, -1, False)
    with pytest.raises(ValueError, match=r"points must be \[F, 3\]"):
        cuda_impl(points[..., :2], T, Rb)
    with pytest.raises(ValueError, match="must be a multiple of seg=5"):
        cuda_impl(points, T, Rb, seg=5)
    with pytest.raises(TypeError, match="points must be float32"):
        cuda_impl(points.double(), T, Rb)
    with pytest.raises(ValueError, match=r"T must be \[C, B, 4, 4\]"):
        cuda_impl(points, T[..., :3, :], Rb)
    with pytest.raises(TypeError, match="T must be float32"):
        cuda_impl(points, T.double(), Rb)
    with pytest.raises(ValueError, match="Rb must be"):
        cuda_impl(points, T, Rb[:, :1])
    with pytest.raises(ValueError, match="Rb must be"):
        cuda_impl(points, T[:, :1].contiguous(), Rb)
    with pytest.raises(ValueError, match="points must be contiguous"):
        cuda_impl(points.t().contiguous().t(), T, Rb)
    with pytest.raises(ValueError, match="T must be contiguous"):
        cuda_impl(points, T.transpose(0, 1).contiguous().transpose(0, 1), Rb)
    with pytest.raises(ValueError, match="tensors for 4 children"):
        cuda_impl(points, T, Rb, bricks=[t.bricks for t in tables[:3]])
    with pytest.raises(TypeError, match=r"n\[0\] must be torch.int64"):
        cuda_impl(points, T, Rb, n=[t.n.int() for t in tables])
    with pytest.raises(ValueError, match=r"gbricks\[1\] must be \[rows, 3, 64\]"):
        cuda_impl(points, T, Rb, gbricks=[t.gbricks[:, :2] if i == 1 else t.gbricks
                                          for i, t in enumerate(tables)])


@pytest.mark.parametrize("C,frac", [(2, 0.04), (4, 0.04), (4, 1e-9)])
def test_op_cpu_kernel_is_the_plain_version_on_transformed_points(junctions, C, frac):
    """The op's CPU kernel (the CUDA kernel's plain version) equals
    ``_union_tile_eval`` on ``transform_points(T, points)`` in the tile
    layout bit for bit: every output's bits, ``-0.0`` and NaN places
    included (NaN taken as one pattern), and the values only.  A zero row
    of ``-0.0`` in configuration 0's rotations plants ``-0.0`` in
    ``g_obj``."""
    _, ct = junctions[C]
    points, T, Rb = _inputs(ct, seed=20 + C)
    Rb[:, 0, 2] = -0.0
    tables = tsdf.coherent_fast_tables(tuple(ct.sdfs))
    cap = tsdf.residual_capacity(B * FS, frac)
    pts_c = pt.transforms.transform_points(torch.as_tensor(T), torch.as_tensor(points)).reshape(
        C, B, FS, SEG, 3)
    with torch.no_grad():
        out = _port(ct, points, T, Rb, frac)
        ref = tsdf._union_tile_eval(tables, cap, pts_c, torch.as_tensor(Rb))
        vo = _port(ct, points, T, Rb, frac, values_only=True)
        ref_vo = tsdf._union_values_eval(tables, pts_c)
    for a, b in zip(out + (vo,), ref + (ref_vo,)):
        assert _same_bits(a, b)
    assert torch.isnan(out[1]).any() and torch.isnan(out[3]).any()
    assert bool(((out[1] == 0) & torch.signbit(out[1])).any())


def _same_bits(a, b):
    """Equal bit for bit (``-0.0`` apart from ``0.0``), every NaN taken as
    one pattern."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def _kernel_emulation(tables, pts_c, Rb, lanes=None):
    """The kernel's raw outputs, before its poison pass: ``(val, g_obj,
    win, g_link, middle [B, FS], mask [B, FS, seg])``.  Per child the plain
    steps; the winner by an in-order scan (NaN first, else strictly less);
    a tile is middle when it holds four or more distinct in-grid winners,
    found from each lane's four smallest distinct winners (``lanes``: the
    number of lanes a tile's points are dealt to, one point a lane when
    None) merged by four successive minima above the last; each point's
    gradient from its winner alone: the AABB fallback out of the grid, its
    packed row in a middle tile, else its gradient-brick cell."""
    C = len(tables)
    v, valid, flat, row, cell, g_oob = tsdf._nearest_union(tables, pts_c)
    best, win = v[0], torch.zeros(v.shape[1:], dtype=torch.int64)
    for c in range(1, C):
        take = torch.where(torch.isnan(v[c]), ~torch.isnan(best), v[c] < best)
        best, win = torch.where(take, v[c], best), torch.where(take, c, win)
    pick = lambda x: x.gather(0, win.view((1,) + win.shape + (1,) * (x.dim() - 4)).expand(
        (1,) + x.shape[1:]))[0]
    bvalid = pick(valid)
    middle = _middle_by_lane_lists(torch.where(bvalid, win, -1), lanes) & (C > 3)
    g_cell = torch.stack([t.gbricks[row[c][..., None], :, cell[c]] for c, t in
                          enumerate(tables)])           # [C, B, FS, seg, 3]
    g_row = torch.stack([t.vg[flat[c] - int(tsdf._vg_offsets(tables)[c]), 1:4]
                         for c, t in enumerate(tables)])
    g = torch.where(middle[..., None, None], pick(g_row), pick(g_cell))
    g = torch.where(bvalid[..., None], g, pick(g_oob))
    return best, tsdf._rotate_winners(Rb, win, g), win, g, middle, middle[..., None] & bvalid


def _middle_by_lane_lists(w, lanes):
    """``[B, FS]``: four or more distinct non-negative entries in a tile of
    ``w [B, FS, seg]``, as the kernel finds them (see
    :func:`_kernel_emulation`)."""
    B_, FS_, seg = w.shape
    none = math.inf
    out = torch.zeros((B_, FS_), dtype=torch.bool)
    for b in range(B_):
        for f in range(FS_):
            pts = [x for x in w[b, f].tolist()]
            n = seg if lanes is None else lanes
            lists = []
            for lane in range(n):
                s = sorted(set(x for x in pts[lane::n] if x >= 0))[:4]
                lists.append(s + [none] * (4 - len(s)))
            d = min(s[0] for s in lists)
            for _ in range(3):
                if d == none:
                    break
                d = min(next((x for x in s if x > d), none) for s in lists)
            out[b, f] = d != none
    return out


def _poison(middle, mask, g_obj, g_link, cap):
    """The kernel's second pass: the middle tiles whose inclusive cumsum
    of the flags exceeds the capacity get NaN at their in-grid points."""
    rank = torch.cumsum(middle.reshape(-1).to(torch.int32), 0).reshape(middle.shape)
    bad = ((middle & (rank > cap))[..., None] & mask)[..., None]
    return torch.where(bad, float("nan"), g_obj), torch.where(bad, float("nan"), g_link)


def _same(a, b):
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)]))


@pytest.mark.parametrize("frac", [0.04, 1e-9])
@pytest.mark.parametrize("C,seg,lanes", [(2, 12, None), (4, 12, None), (4, 27, None),
                                         (4, 64, 32), (4, 100, 32)])
def test_kernel_design_equals_plain(junctions, frac, C, seg, lanes):
    _, ct = junctions[C]
    tables = tsdf.coherent_fast_tables(tuple(ct.sdfs))
    points, T, Rb = _inputs(ct, seed=10 + seg, seg=seg, fs=24, near=0.02)
    pts_c, Rb = torch.as_tensor(_link_points(points, T, seg)), torch.as_tensor(Rb)
    with torch.no_grad():
        val, g_obj, win, g_link, middle, mask = _kernel_emulation(tables, pts_c, Rb, lanes)
        cap = tsdf.residual_capacity(middle.numel(), frac)
        g_obj, g_link = _poison(middle, mask, g_obj, g_link, cap)
        ref = tsdf._union_tile_eval(tables, cap, pts_c, Rb)
    assert _same(val, ref[0]) and torch.equal(win, ref[2])
    assert _same(g_obj, ref[1]) and _same(g_link, ref[3])
    if C > 3:
        assert int(middle.sum()) >= 2
        finite = torch.isfinite(pts_c).all(dim=-1).all(dim=0)
        assert bool(torch.isnan(g_link[finite]).any()) == (frac < 1e-6)


def test_served_grid_query_holds_the_op(tmp_path):
    """A grid export of a 4-link cached arm: its graph calls the op, and the
    loaded query equals ``query_grid`` (values, gradients, values only)."""
    urdf, end = make_serial_arm(str(tmp_path), num_joints=3, segments=6, rings=2)
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(open(urdf).read(), end, device="cpu"),
                        path_prefix=str(tmp_path), link_sdf_cls=pt.cache_link_sdf_factory(
                            resolution=0.05, padding=0.2,
                            cache_path=os.path.join(str(tmp_path), "cache.npz")))
    assert len(robot.sdf.sdfs) == 4
    qr = np.array([[-0.3, 0.1], [0.0, 0.0], [-0.1, 0.3]])
    q = torch.as_tensor(np.random.default_rng(3).normal(0, 0.4, (2, 3)).astype(np.float32))
    for values_only in (False, True):
        path = str(tmp_path / f"grid_{values_only}.pt2")
        serving.export_robot_grid_query(robot, n_configs=2, query_range=qr, resolution=0.025,
                                        path=path, values_only=values_only)
        # values only: the no-grad region is a submodule of the program
        targets = {str(n.target) for m in torch.export.load(path).graph_module.modules()
                   if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
                   if n.op == "call_function"}
        assert "pvt.coherent_union_tile.default" in targets, targets
        query = serving.load_robot_grid_query(path, device="cpu")
        with torch.no_grad():
            out = query(q)
            ref = robot.query_grid(q, qr, 0.025, values_only=values_only)
        if values_only:
            assert torch.equal(out, ref)
        else:
            assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_op_module_knows_nothing_of_sdf():
    """The layering: ``ops/coherent_union.py`` and ``ops/coherent_union_tri.py``
    import nothing of ``sdf`` (which imports them and registers the ops' CPU
    kernels), and the residual lane's fraction is not defined a second time
    there: the callers pass the capacity."""
    import ast
    for mod in (cu, cut):
        tree = ast.parse(open(mod.__file__).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [f"{n.module}.{a.name}" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) for a in n.names]
        assert not [x for x in names if "sdf" in x.split(".")], names
        assert "residual_frac" not in open(mod.__file__).read()


# ---------------------------------------------------------------------------
# the trilinear union's op, pvt::coherent_union_tile_tri (CU-T)
# ---------------------------------------------------------------------------

def _tri_plain(ct, points, T, Rb, frac, seg=SEG):
    """The plain version on ``transform_points(T, points)`` in the tile
    layout: ``(val, g_obj, win, g_link)`` and the values only."""
    tables = tsdf.coherent_fast_tables(tuple(ct.sdfs))
    C, B_ = T.shape[:2]
    cap = tsdf.residual_capacity(B_ * (points.shape[0] // seg), frac)
    pts_c = pt.transforms.transform_points(torch.as_tensor(T), torch.as_tensor(points)).reshape(
        C, B_, -1, seg, 3)
    with torch.no_grad():
        return (tsdf._union_tile_tri_eval(tables, cap, pts_c, torch.as_tensor(Rb)),
                tsdf._union_values_tri_eval(tables, pts_c))


@pytest.mark.parametrize("C,frac", [(2, 0.04), (4, 0.04), (4, 1e-9)])
def test_tri_op_cpu_kernel_is_the_plain_version_on_transformed_points(tri_junctions, C, frac):
    """``pvt::coherent_union_tile_tri``'s CPU kernel equals the plain
    ``_union_tile_tri_eval`` and ``_union_values_tri_eval`` on the link-frame
    points bit for bit (``-0.0`` planted in ``g_obj`` through a zero row of
    ``-0.0`` in configuration 0's rotations; NaN in the overflowed middle
    tiles at 1e-9), and the values only equal the forward's values."""
    _, ct = tri_junctions[C]
    points, T, Rb = _inputs(ct, seed=30 + C, near=0.01)
    Rb[:, 0, 2] = -0.0
    tables = tsdf.coherent_fast_tables(tuple(ct.sdfs))
    cap = tsdf.residual_capacity(B * FS, frac)
    with torch.no_grad():
        out = cut.coherent_union_tile_tri(tables, torch.as_tensor(points), torch.as_tensor(T),
                                          SEG, torch.as_tensor(Rb), cap)
        vo = cut.coherent_union_tile_tri(tables, torch.as_tensor(points), torch.as_tensor(T),
                                         SEG, values_only=True)
    ref, ref_vo = _tri_plain(ct, points, T, Rb, frac)
    assert out[0].shape == (B, FS, SEG) and out[2].dtype == torch.int64
    for a, b in zip(out + (vo,), ref + (ref_vo,)):
        assert _same_bits(a, b)
    assert _same_bits(vo, out[0])  # NaN points lerp NaN weights
    assert bool(((out[1] == 0) & torch.signbit(out[1])).any())
    finite = torch.isfinite(torch.as_tensor(_link_points(points, T))).all(-1).all(0)
    assert bool(torch.isnan(out[3][finite]).any()) == (C > 3 and frac < 1e-6)


def test_tri_wrapper_refuses_what_the_kernel_does_not_take(tri_junctions):
    _, ct = tri_junctions[4]
    tables = tsdf.coherent_fast_tables(tuple(ct.sdfs))
    points, T, Rb = (torch.as_tensor(x) for x in _inputs(ct, seed=7, fs=4))
    with pytest.raises(ValueError, match="unsupported device"):
        cut.coherent_union_tile_tri(tables, points.to("meta"), T.to("meta"), SEG,
                                    Rb.to("meta"), 32)
    with pytest.raises(ValueError, match="residual lane's capacity"):
        cut.coherent_union_tile_tri(tables, points, T, SEG, Rb)
    for name in ("tgbricks", "tbricks"):
        bare = tuple(t._replace(**{name: None}) for t in tables)
        with pytest.raises(ValueError, match=f"tables lack {name}"):
            cut.coherent_union_tile_tri(bare, points, T, SEG, Rb, 32)
    # values only reads no gradient bricks
    bare = tuple(t._replace(tgbricks=None) for t in tables)
    assert cut.coherent_union_tile_tri(bare, points, T, SEG, values_only=True).shape == (
        B, 4, SEG)

    def cuda_impl(pts, t, rb, seg=SEG, values_only=False, **change):
        fields = dict(zip(cut.FIELDS, cut.op_args(tables, values_only)))
        fields.update(change)
        return cut._coherent_union_tile_tri_op_cuda(pts, t, rb, *fields.values(), seg, 32,
                                                    values_only)

    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_impl(points, T, Rb)
    with pytest.raises(ValueError, match="capacity must be >= 0"):
        cut._coherent_union_tile_tri_op_cuda(points, T, Rb, *cut.op_args(tables), SEG, -1,
                                             False)
    with pytest.raises(ValueError, match=r"points must be \[F, 3\]"):
        cuda_impl(points[..., :2], T, Rb)
    with pytest.raises(ValueError, match="must be a multiple of seg=5"):
        cuda_impl(points, T, Rb, seg=5)
    with pytest.raises(TypeError, match="points must be float32"):
        cuda_impl(points.double(), T, Rb)
    with pytest.raises(ValueError, match=r"T must be \[C, B, 4, 4\]"):
        cuda_impl(points, T[..., :3, :], Rb)
    with pytest.raises(ValueError, match="Rb must be"):
        cuda_impl(points, T, Rb[:, :1])
    with pytest.raises(ValueError, match="points must be contiguous"):
        cuda_impl(points.t().contiguous().t(), T, Rb)
    with pytest.raises(ValueError, match="tensors for 4 children"):
        cuda_impl(points, T, Rb, tbricks=[t.tbricks for t in tables[:3]])
    with pytest.raises(TypeError, match=r"strides\[0\] must be torch.int64"):
        cuda_impl(points, T, Rb, strides=[t.strides.int() for t in tables])
    with pytest.raises(TypeError, match=r"tbricks\[2\] must be torch.float32"):
        cuda_impl(points, T, Rb, tbricks=[t.tbricks.double() if i == 2 else t.tbricks
                                          for i, t in enumerate(tables)])
    with pytest.raises(ValueError, match=r"tbricks\[0\] must be \[rows, 125\]"):
        cuda_impl(points, T, Rb, tbricks=[t.tbricks[:, :64].contiguous() for t in tables])
    with pytest.raises(ValueError, match=r"tgbricks\[1\] must be \[rows, 3, 125\]"):
        cuda_impl(points, T, Rb, tgbricks=[t.tgbricks[:, :2] if i == 1 else t.tgbricks
                                           for i, t in enumerate(tables)])
    with pytest.raises(ValueError, match=r"vg\[3\] must be contiguous"):
        cuda_impl(points, T, Rb, vg=[t.vg.t().contiguous().t() if i == 3 else t.vg
                                     for i, t in enumerate(tables)])
    with pytest.raises(ValueError, match="lies on meta"):
        cuda_impl(points, T, Rb, vg=[t.vg.to("meta") for t in tables])


def _corner_weights(w):
    """CU-T's 8 weights in corner order: corner k's offset in dimension d is
    bit d of k, its weight ``(wd0 * wd1) * wd2`` with ``wd = w`` or ``1 - w``."""
    lo = 1.0 - w
    return [((w[..., 0] if k & 1 else lo[..., 0]) * (w[..., 1] if k & 2 else lo[..., 1]))
            * (w[..., 2] if k & 4 else lo[..., 2]) for k in range(8)]


def _lerp(read, wt, step):
    """CU-T's lerp: ``0 + wt[0] * read(0)``, then ``+ wt[k] * read(step(k))``
    in corner order."""
    acc = torch.zeros_like(wt[0])
    for k in range(8):
        acc = acc + wt[k] * read(step(k))
    return acc


def _tri_kernel_emulation(tables, pts_c, Rb, lanes=None):
    """CU-T's raw outputs, before the poison pass: ``(val, g_obj, win,
    g_link, middle [B, FS], mask [B, FS, seg], values only)``.  Per child
    (each reading its own tables, no concatenation) the lane's steps: the
    trilinear cell (the in-grid mask from the rounded key, the lower corner
    from the clamped floor, the weights), the tile's anchor from the
    minimum lower corner over its lanes, the value lerp of the child's
    5x5x5 value brick row or the AABB distance; the winner by an in-order
    scan (NaN first, else strictly less) and the values only folded as
    amin's four accumulators; middle tiles from the lanes' four-smallest
    lists; each point's gradient from its winner alone: the AABB fallback
    out of the grid, the exact lerp of its packed rows in a middle tile,
    else the lerp of its gradient brick row."""
    C = len(tables)
    per_child = []
    for t, p in zip(tables, pts_c):
        n_f = t.n.to(p.dtype)
        f = (p - t.lo) * t.inv_res

        def key(x):  # float_keys: NaN 0, clamped to [-1, n]
            return torch.minimum(torch.nan_to_num(x, nan=0.0).clamp(min=-1.0), n_f).long()

        k = key(torch.round(f))
        valid = ((k >= 0) & (k < t.n)).all(dim=-1)
        fc = torch.minimum(f.clamp(min=0.0), n_f - 1)
        i0 = torch.minimum(key(torch.floor(fc)).clamp(min=0), t.n - 2)
        w = fc - i0.to(p.dtype)
        corner2 = torch.div(i0.amin(dim=-2), 2, rounding_mode="floor")  # the tile's lanes
        off = (i0 - 2 * corner2[..., None, :]).clamp(max=3)
        row = (corner2 * t.bstrides).sum(dim=-1)[..., None]
        base5 = off[..., 0] * 25 + off[..., 1] * 5 + off[..., 2]
        flat0 = (i0 * t.strides).sum(dim=-1)
        wt = _corner_weights(w)
        step = lambda k: (k & 1) * 25 + ((k >> 1) & 1) * 5 + ((k >> 2) & 1)
        v_in = _lerp(lambda d: torch.take(t.tbricks, row * 125 + base5 + d), wt, step)
        dist, g_oob = tsdf._aabb_distance_grad(t.bb, p)
        g_brick = torch.stack([_lerp(lambda d: torch.take(t.tgbricks, row * 375 + ch * 125
                                                          + base5 + d), wt, step)
                               for ch in range(3)], dim=-1)
        rows = lambda k: flat0 + (k & 1) * t.strides[0] + ((k >> 1) & 1) * t.strides[1] + (
            (k >> 2) & 1) * t.strides[2]
        g_rows = torch.stack([_lerp(lambda r: t.vg[r, 1 + ch], wt, rows) for ch in range(3)],
                             dim=-1)
        per_child.append((torch.where(valid, v_in, dist), valid, g_brick, g_rows, g_oob))
    v, valid, g_brick, g_rows, g_oob = (torch.stack(x) for x in zip(*per_child))
    best, win = v[0], torch.zeros(v.shape[1:], dtype=torch.int64)
    acc = [torch.full_like(best, math.inf) for _ in range(4)]
    min_nan = lambda a, b: torch.where(torch.isnan(a) | (a < b), a, b)
    for c in range(C):
        acc[c % 4] = min_nan(acc[c % 4], v[c])
        if c:
            take = torch.where(torch.isnan(v[c]), ~torch.isnan(best), v[c] < best)
            best, win = torch.where(take, v[c], best), torch.where(take, c, win)
    values_only = min_nan(min_nan(min_nan(acc[0], acc[1]), acc[2]), acc[3])
    pick = lambda x: x.gather(0, win.view((1,) + win.shape + (1,) * (x.dim() - 4)).expand(
        (1,) + x.shape[1:]))[0]
    bvalid = pick(valid)
    middle = _middle_by_lane_lists(torch.where(bvalid, win, -1), lanes) & (C > 3)
    g = torch.where(middle[..., None, None], pick(g_rows), pick(g_brick))
    g = torch.where(bvalid[..., None], g, pick(g_oob))
    return (best, tsdf._rotate_winners(Rb, win, g), win, g, middle, middle[..., None] & bvalid,
            values_only)


@pytest.mark.parametrize("frac", [0.04, 1e-9])
@pytest.mark.parametrize("C,seg,lanes", [(2, 4, None), (4, 4, None), (2, 27, None),
                                         (4, 27, None), (4, 64, 32)])
def test_tri_kernel_design_equals_plain(tri_junctions, frac, C, seg, lanes):
    """CU-T's design (:func:`_tri_kernel_emulation`, then the poison pass)
    equals the plain ``_union_tile_tri_eval`` bit for bit (NaN as one
    pattern, ``-0.0`` apart from ``0.0``), and its values only
    ``_union_values_tri_eval``, at the default seg 4, the north star's 27
    and the one-tile-a-warp shape's 64, the lane overflowing or not."""
    _, ct = tri_junctions[C]
    tables = tsdf.coherent_fast_tables(tuple(ct.sdfs))
    # 4-point tiles hold four winners only at the junction's centre
    points, T, Rb = _inputs(ct, seed=40 + seg, seg=seg, fs=64 if seg == 4 else 24,
                            near=0.0 if seg == 4 else 0.01)
    Rb[:, 0, 1] = -0.0
    pts_c, Rb = torch.as_tensor(_link_points(points, T, seg)), torch.as_tensor(Rb)
    with torch.no_grad():
        val, g_obj, win, g_link, middle, mask, vo = _tri_kernel_emulation(tables, pts_c, Rb,
                                                                          lanes)
        cap = tsdf.residual_capacity(middle.numel(), frac)
        g_obj, g_link = _poison(middle, mask, g_obj, g_link, cap)
        ref = tsdf._union_tile_tri_eval(tables, cap, pts_c, Rb)
        ref_vo = tsdf._union_values_tri_eval(tables, pts_c)
    for a, b in zip((val, g_obj, win, g_link, vo), ref + (ref_vo,)):
        assert _same_bits(a, b)
    assert bool(((g_obj == 0) & torch.signbit(g_obj)).any())
    if C > 3:
        assert int(middle.sum()) >= 2
        finite = torch.isfinite(pts_c).all(dim=-1).all(dim=0)
        assert bool(torch.isnan(g_link[finite]).any()) == (frac < 1e-6)


def test_served_trilinear_grid_query_holds_the_op(tmp_path):
    """A grid export of a 4-link arm on trilinear caches: its graph calls
    ``pvt::coherent_union_tile_tri``, and the loaded query equals
    ``query_grid`` (values, gradients, values only)."""
    urdf, end = make_serial_arm(str(tmp_path), num_joints=3, segments=6, rings=2)
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(open(urdf).read(), end, device="cpu"),
                        path_prefix=str(tmp_path), link_sdf_cls=pt.cache_link_sdf_factory(
                            resolution=0.05, padding=0.2, interpolation="trilinear",
                            cache_path=os.path.join(str(tmp_path), "cache.npz")))
    assert tsdf._coherent_plan(tuple(robot.sdf.sdfs)).route == "trilinear_union"
    qr = np.array([[-0.3, 0.1], [0.0, 0.0], [-0.1, 0.3]])
    q = torch.as_tensor(np.random.default_rng(4).normal(0, 0.4, (2, 3)).astype(np.float32))
    for values_only in (False, True):
        path = str(tmp_path / f"tri_grid_{values_only}.pt2")
        serving.export_robot_grid_query(robot, n_configs=2, query_range=qr, resolution=0.025,
                                        path=path, values_only=values_only)
        targets = {str(n.target) for m in torch.export.load(path).graph_module.modules()
                   if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
                   if n.op == "call_function"}
        assert "pvt.coherent_union_tile_tri.default" in targets, targets
        query = serving.load_robot_grid_query(path, device="cpu")
        with torch.no_grad():
            out = query(q)
            ref = robot.query_grid(q, qr, 0.025, values_only=values_only)
        if values_only:
            assert torch.equal(out, ref)
        else:
            assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
