"""The port's coherent brick-gather path against the port's generic path
(bit for bit on the CPU) and against the JAX package's jitted coherent path
(CPU): point layouts, brick tables, every lookup of
``compose_query_coherent``, the residual lane and its overflow, the
contract check, ``RobotSDF.query_grid`` and ``ComposedSDF.get_voxel_view``.
The port's cached children hold the JAX package's tables."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu import transforms as jtfm
from pytorch_volumetric_tpu.sdf import coherent_fast_tables as jax_fast_tables
from pytorch_volumetric_tpu.sdf import compose_query_coherent as jax_compose_coherent
from pytorch_volumetric_tpu.utils.robots import make_serial_arm
from pytorch_volumetric_tpu_torch import sdf as tsdf
from pytorch_volumetric_tpu_torch import state
from torch_cpu_guard import warm_sqrt

warm_sqrt()

CPU = "cpu"
# a tile of the (4, 3) or (3, 3, 3) layout around the junction's centre sees
# all 4 winning children
JUNCTION_RANGE = np.array([[-0.07, 0.05], [-0.07, 0.05], [-0.04, 0.04]])


def _port_cache(cj, name):
    """A port ``CachedSDF`` holding the JAX cache's tables."""
    return state.cached_sdf_from_numpy(
        name, cj.resolution, cj.ranges, np.asarray(cj.voxels.raw_data),
        np.asarray(cj.voxels_grad), np.asarray(cj.surface_bounding_box()),
        device=CPU, interpolation=cj.interpolation)


def _np_bricks(vg, n, cols, width, lanes):
    """Brick rows built in numpy, in the JAX package's layout: overlapping
    stride-2 ``width^3`` windows, channel-major, each channel padded to
    ``lanes`` cells."""
    nb = (n - 1) // 2 + 1
    vol = vg[:, cols].reshape(tuple(n) + (len(cols),))
    vol = np.pad(vol, [(0, int(p)) for p in 2 * nb + width - 2 - n] + [(0, 0)])
    cells = [vol[ux:ux + 2 * nb[0] - 1:2, uy:uy + 2 * nb[1] - 1:2, uz:uz + 2 * nb[2] - 1:2]
             for ux in range(width) for uy in range(width) for uz in range(width)]
    b = np.stack(cells, axis=3).reshape(-1, width ** 3, len(cols)).transpose(0, 2, 1)
    return np.pad(b, ((0, 0), (0, 0), (0, lanes - width ** 3))).reshape(len(b), -1)


def _np_brick_kinds(vg, n):
    return {"bricks": _np_bricks(vg, n, [0], 4, 64),
            "bricks4": _np_bricks(vg, n, [0, 1, 2, 3], 4, 64),
            "gbricks": _np_bricks(vg, n, [1, 2, 3], 4, 64),
            "bricks5": _np_bricks(vg, n, [0, 1, 2, 3], 5, 128),
            "tbricks": _np_bricks(vg, n, [0], 5, 128),
            "tgbricks": _np_bricks(vg, n, [1, 2, 3], 5, 128)}


def _give_jax_bricks(c):
    """Install every brick kind on a JAX cache from :func:`_np_brick_kinds`
    (the JAX package builds them with one compiled slice per cell, minutes
    for this file; ``test_brick_tables_match_jax`` holds the numpy build to
    the JAX package's own)."""
    small = c._coherent_tables(with_value_bricks=False)  # no brick built
    kinds = _np_brick_kinds(np.asarray(c._vg), np.asarray(c.voxels.shape))
    c._coherent_cache = small._replace(**{k: jnp.asarray(v) for k, v in kinds.items()})


def _compositions(children_j, mats):
    mats = np.asarray(mats, dtype=np.float32)
    for c in children_j:
        if isinstance(c, pv.CachedSDF):
            _give_jax_bricks(c)
    cj = pv.ComposedSDF(children_j, pv.Transform3d(matrix=jnp.asarray(mats)))
    ct = pt.ComposedSDF([_port_cache(c, f"c{i}") if isinstance(c, pv.CachedSDF)
                         else c for i, c in enumerate(children_j)],
                        pt.Transform3d(matrix=torch.as_tensor(mats)))
    return cj, ct


def _junction(tmp, n_children=4, radius=0.012, interpolation="nearest"):
    """Small cached spheres centred on a circle of ``radius``: a tile
    around the circle's centre sees every angular sector at once."""
    children, mats = [], []
    for i in range(n_children):
        children.append(pv.CachedSDF(f"j{i}", 0.04, np.array([[-0.5, 0.5]] * 3),
                                     pv.SphereSDF(0.02), interpolation=interpolation,
                                     cache_path=os.path.join(tmp, f"j{i}.npz")))
        ang = 2 * np.pi * i / n_children + 0.3  # off the grid's axes: no exact ties
        m = np.eye(4, dtype=np.float32)
        m[0, 3], m[1, 3] = -radius * np.cos(ang), -radius * np.sin(ang)
        mats.append(m)
    return _compositions(children, mats)


def _rotated_mats():
    R = np.asarray(jtfm.euler_angles_to_matrix(jnp.asarray([0.3, -0.5, 0.9]), "XYZ"))
    return np.stack([np.asarray(jtfm.make_tf(pos=[0.15, -0.05, 0.1], rot=R)),
                     np.asarray(jtfm.make_tf(pos=[-0.2, 0.1, 0.0], rot=R.T))])


@pytest.fixture(scope="module")
def unions(tmp_path_factory):
    """(JAX, port) compositions, one for each route of the brick path."""
    d = str(tmp_path_factory.mktemp("unions"))
    ball = pv.SphereSDF(0.3)
    out = {"junction": _junction(d),
           "junction_tri": _junction(d, interpolation="trilinear")}
    for interp in ("nearest", "trilinear"):
        c = pv.CachedSDF(f"ball_{interp}", 0.05, np.array([[-0.5, 0.5]] * 3), ball,
                         interpolation=interp, cache_path=os.path.join(d, "ball.npz"))
        out[f"single_{interp}"] = _compositions([c], _rotated_mats())
    # exact value ties: an analytic box (index 0) and a cache of the same box,
    # whose AABB fallback equals the box's distance
    path = os.path.join(d, "b.obj")
    pv.mesh.save_obj(pv.mesh.box_mesh((0.2, 0.2, 0.2)), path)
    fac = pv.MeshObjectFactory(path)
    cached = pv.CachedSDF("b", 0.08, fac.bounding_box(padding=0.1), pv.MeshSDF(fac),
                          cache_path=os.path.join(d, "b.npz"))
    _give_jax_bricks(cached)
    cj = pv.ComposedSDF([pv.BoxSDF((0.2, 0.2, 0.2)), cached],
                        pv.Transform3d(matrix=jnp.tile(jnp.eye(4)[None], (2, 1, 1))))
    ct = pt.ComposedSDF([pt.BoxSDF((0.2, 0.2, 0.2), device=CPU), _port_cache(cached, "b")],
                        pt.Transform3d(matrix=torch.eye(4).repeat(2, 1, 1)))
    out["ties"] = (cj, ct)
    return out


def _layout(res, qr, cache_res, kind):
    """The same layout from both packages, checked equal."""
    if kind == "line":
        pj, take = pv.get_coherent_grid_points(res, qr)
        pp, take_t = pt.get_coherent_grid_points(res, qr, device=CPU)
        seg = seg_t = 4
    else:
        pj, take, seg = pv.get_coherent_tile_points(res, qr, cache_resolution=cache_res)
        pp, take_t, seg_t = pt.get_coherent_tile_points(res, qr, cache_resolution=cache_res,
                                                        device=CPU)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(take_t, take)
    assert seg_t == seg
    return pj, pp, take, seg


def _check(cj, ct, res, qr, cache_res, kind="tile"):
    """Coherent == generic (port, bit for bit) and == JAX's jitted coherent
    path (1e-5 value, 1e-4 gradient); values_only == the full values."""
    pj, pp, take, seg = _layout(res, qr, cache_res, kind)
    assert ct.check_coherent_contract(pp, seg=seg)
    assert cj.check_coherent_contract(pj, seg=seg)
    _, pg = pt.get_coordinates_and_points_in_grid(res, qr, device=CPU)
    vg, gg = ct(pg)
    vc, gc = ct.query_coherent(pp, seg=seg)
    tk = torch.as_tensor(take)
    assert torch.isfinite(gc).all()
    assert torch.equal(vc[..., tk], vg) and torch.equal(gc[..., tk, :], gg)
    vj, gj = cj.query_coherent(pj, seg=seg)
    assert np.abs(vc.numpy() - np.asarray(vj)).max() < 1e-5
    assert np.abs(gc.numpy() - np.asarray(gj)).max() < 1e-4
    vo = ct.query_coherent(pp, seg=seg, values_only=True)
    assert torch.equal(vo, vc) and not vo.requires_grad
    return pp, seg, vc, gc


LAYOUTS = [
    ("line", 0.02, [[-0.6, 0.3], [0.01, 0.01], [-0.3, 0.7]], None, 4),
    ("tile", 0.02, [[0.0, 0.0], [0.0, 0.0], [-0.1, 0.2]], None, 4),
    ("tile", 0.02, [[-0.3, 0.3], [0.0, 0.0], [-0.1, 0.2]], None, 12),
    ("tile", 0.02, [[-0.1, 0.1], [-0.1, 0.15], [-0.1, 0.2]], None, 27),
    ("tile", 0.01, [[-0.1, 0.1], [-0.1, 0.15], [-0.1, 0.2]], 0.04, None),
    ("tile", 0.02, [[-0.1, 0.1]] * 3, 0.0, 1),
    ("tile", 0.01, [[-1.0, 0.5], [0.02, 0.02], [-0.2, 0.8]], 0.02, 12),
]


@pytest.mark.parametrize("kind,res,qr,cache_res,want_seg", LAYOUTS)
def test_layouts_match_jax(kind, res, qr, cache_res, want_seg):
    """Points, ``take_idx`` and ``seg`` equal the JAX package's; the taken
    points are the raster grid."""
    qr = np.asarray(qr)
    _, pp, take, seg = _layout(res, qr, cache_res, kind)
    if want_seg is not None:
        assert seg == want_seg
    assert pp.shape[0] % seg == 0
    _, pg = pt.get_coordinates_and_points_in_grid(res, qr, device=CPU)
    assert torch.equal(pp[torch.as_tensor(take)], pg)


def test_brick_tables_match_jax(unions, tmp_path):
    """Every brick kind of the port holds the numpy build's cells (the JAX
    layout's 125 -> 128 lane padding dropped), and the numpy build equals
    the JAX package's own value bricks; multi-child unions carry no
    ``bricks4``, one child no ``gbricks``."""
    cj = pv.CachedSDF("ball", 0.1, np.array([[-0.5, 0.45]] * 3), pv.SphereSDF(0.3),
                      cache_path=str(tmp_path / "ball.npz"))
    n = np.asarray(cj.voxels.shape)
    kinds = _np_brick_kinds(np.asarray(cj._vg), n)
    np.testing.assert_array_equal(np.asarray(cj._coherent_tables().bricks), kinds["bricks"])
    ct = _port_cache(cj, "ball")
    assert ct._coherent_tables().bricks4 is None
    tt = ct._coherent_tables(with_grad_bricks=True, with_gradonly_bricks=True,
                             with_tri_bricks=True, with_tri_value_bricks=True,
                             with_tri_gradonly_bricks=True)
    assert tt.bricks is not None  # upgraded in place
    for name, table in tt._asdict().items():
        if name not in kinds:
            continue
        width = 4 if name in ("bricks", "bricks4", "gbricks") else 5
        ref = kinds[name].reshape(len(kinds[name]), -1, 64 if width == 4 else 128)
        np.testing.assert_array_equal(table.reshape(ref.shape[:2] + (-1,)).numpy(),
                                      ref[..., :width ** 3], err_msg=name)
    _, ct_j = unions["junction"]
    assert all(t.bricks4 is None and t.gbricks is not None
               for t in tsdf.coherent_fast_tables(ct_j.sdfs))
    _, ct_1 = unions["single_nearest"]
    (t1,) = tsdf.coherent_fast_tables(ct_1.sdfs)
    assert t1.bricks4 is not None and t1.gbricks is None


def _winner_counts(ct, pp, seg):
    v = torch.stack([c(pt.transforms.transform_points(m, pp))[0] for c, m in
                     zip(ct.sdfs, ct.obj_frame_to_link_frame.get_matrix())])
    return torch.tensor([len(set(w.tolist())) for w in v.argmin(dim=0).reshape(-1, seg)])


@pytest.mark.parametrize("name", ["junction", "junction_tri"])
def test_union_residual_lane(unions, name):
    """Four children around a junction: tiles with 4 winners take the
    residual lane, and the union stays bit-identical to the generic path."""
    cj, ct = unions[name]
    pp, seg, _, _ = _check(cj, ct, 0.02, JUNCTION_RANGE, 0.04)
    assert (_winner_counts(ct, pp, seg) >= 4).any(), "no tile reaches the residual lane"


@pytest.mark.parametrize("name", ["junction", "junction_tri"])
def test_residual_overflow_poisons_jax_tiles(unions, name):
    """At ``residual_frac=1e-9`` the middle tiles beyond the lane's single
    slot get NaN gradients, the same tiles as JAX's; values and the other
    gradients are unchanged."""
    cj, ct = unions[name]
    pj, pp, _, seg = _layout(0.02, JUNCTION_RANGE, 0.04, "tile")
    children = tuple(ct.sdfs)
    m, mi = ct.obj_frame_to_link_frame.get_matrix(), ct.link_frame_to_obj_frame
    v_ref, g_ref = tsdf.compose_query_coherent(children, m, mi, 1, pp, seg=seg)
    v_of, g_of = tsdf.compose_query_coherent(children, m, mi, 1, pp, seg=seg,
                                             residual_frac=1e-9)
    assert torch.equal(v_of, v_ref)
    nan = torch.isnan(g_of).any(dim=-1)
    assert nan.any()
    assert torch.equal(g_of[~nan], g_ref[~nan])
    jchildren = tuple(cj.sdfs)
    ft = jax_fast_tables(jchildren)
    fn = jax.jit(lambda mm, mmi, p: jax_compose_coherent(
        jchildren, mm, mmi, 1, p, fast_tables=ft, seg=seg, residual_frac=1e-9))
    _, gj = fn(cj.obj_frame_to_link_frame.get_matrix(), cj.link_frame_to_obj_frame, pj)
    np.testing.assert_array_equal(nan.numpy(), np.isnan(np.asarray(gj)).any(axis=-1))


@pytest.mark.parametrize("name", ["single_nearest", "single_trilinear"])
@pytest.mark.parametrize("kind", ["line", "tile"])
def test_single_child_routes(unions, name, kind):
    """One cached child under two rotated poses: the (value, gradient)
    4x4x4 bricks or, trilinear, the 5x5x5 bricks; in, out of and across
    the grid's bounds."""
    cj, ct = unions[name]
    pp, seg, _, _ = _check(cj, ct, 0.02, np.array([[-0.8, 0.8], [0.0, 0.0], [-0.8, 0.8]]),
                           0.05, kind)
    # d/d transform through the straight-through lookups: the generic path's
    m0 = ct.obj_frame_to_link_frame.get_matrix()

    def grad_of(query):
        m = m0.clone().requires_grad_(True)
        comp = pt.ComposedSDF(ct.sdfs, pt.Transform3d(matrix=m))
        v, g = query(comp)
        (dm,) = torch.autograd.grad(v.sum() + g.sum(), m)
        return dm

    d_coh = grad_of(lambda c: c.query_coherent(pp, seg=seg))
    d_gen = grad_of(lambda c: c(pp))
    assert torch.allclose(d_coh, d_gen, rtol=1e-4, atol=1e-5)


def test_mixed_fast_generic_ties(unions):
    """A generic child (index 0) tied exactly with a cached child: the
    coherent path keeps the generic path's first-wins winner."""
    cj, ct = unions["ties"]
    pp, seg, _, _ = _check(cj, ct, 0.04, np.array([[-0.4, 0.4]] * 3), 0.08, "line")
    v_box, _ = ct.sdfs[0].raw_query(pp)
    v_cache, _ = ct.sdfs[1].raw_query(pp)
    assert int((v_box == v_cache).sum()) > 100


def test_values_only_generic_children():
    """Primitives only: every child generic, values_only still equal."""
    ct = pt.ComposedSDF([pt.SphereSDF(0.3, device=CPU), pt.BoxSDF((0.2, 0.3, 0.4), device=CPU)],
                        pt.Transform3d(matrix=torch.eye(4).repeat(2, 1, 1)))
    pp, _ = pt.get_coherent_grid_points(0.05, np.array([[-0.4, 0.4], [0.0, 0.0], [-0.4, 0.4]]),
                                        device=CPU)
    v, g = ct.query_coherent(pp)
    vg, gg = ct(pp)
    assert torch.equal(v, vg) and torch.equal(g, gg)
    assert torch.equal(ct.query_coherent(pp, values_only=True), v)


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """The 3-joint arm with cached links (res 0.04) in both packages; the
    port's links hold the JAX package's tables."""
    d = str(tmp_path_factory.mktemp("arm"))
    urdf, end = make_serial_arm(d, num_joints=3, segments=8, rings=2)
    text = open(urdf).read()
    cache = tmp_path_factory.mktemp("cache")
    rj = pv.RobotSDF(pv.build_serial_chain_from_urdf(text, end), path_prefix=d,
                     link_sdf_cls=pv.cache_link_sdf_factory(
                         resolution=0.04, padding=0.3, cache_path=str(cache / "j.npz")))
    rt = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device=CPU), path_prefix=d,
                     link_sdf_cls=pt.cache_link_sdf_factory(
                         resolution=0.04, padding=0.3, cache_path=str(cache / "t.npz")))
    state.load_robot_tables(rt, [
        {"val": np.asarray(s.voxels.raw_data), "grad": np.asarray(s.voxels_grad),
         "surface_bb": np.asarray(s.surface_bounding_box())} for s in rj.sdf.sdfs])
    for c in rj.sdf.sdfs:
        _give_jax_bricks(c)
    q = np.random.default_rng(0).uniform(-1, 1, (3, 3)).astype(np.float32)
    rj.set_joint_configuration(jnp.asarray(q))
    rt.set_joint_configuration(q)
    return rj, rt, q


ARM_RANGE = np.array([[-0.4, 0.2], [0.0, 0.0], [-0.1, 0.5]])


def test_arm_union_and_contract(arms):
    """The arm's union on a 2D slice and a 3D block; the contract check
    agrees with JAX's, and ``debug_check`` raises where it fails."""
    rj, rt, _ = arms
    _check(rj.sdf, rt.sdf, 0.02, np.array([[-0.6, 0.3], [0.01, 0.01], [-0.3, 0.7]]), 0.04)
    _check(rj.sdf, rt.sdf, 0.02, np.array([[-0.3, 0.2], [-0.15, 0.2], [-0.1, 0.5]]), 0.04)
    bad = np.random.default_rng(0).uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    # tiles chosen for a cache twice as coarse break the real grid's bricks
    pj, pp, _, seg = _layout(0.02, np.array([[-0.3, 0.2], [-0.15, 0.2], [-0.1, 0.5]]),
                             0.08, "tile")
    for pts_j, pts_t, s in ((jnp.asarray(bad), torch.as_tensor(bad), 4), (pj, pp, seg),
                            (pj[:-1], pp[:-1], seg)):
        assert not rj.sdf.check_coherent_contract(pts_j, seg=s)
        assert not rt.sdf.check_coherent_contract(pts_t, seg=s)
        with pytest.raises(ValueError, match="coherence contract"):
            rt.sdf.query_coherent(pts_t, seg=s, debug_check=True)


@pytest.mark.parametrize("resolution", [0.02, 0.03])
def test_query_grid(arms, resolution):
    """``query_grid`` equals ``query`` on the raster grid bit for bit and
    JAX's ``query_grid`` within 1e-5 / 1e-4; at 0.03 (coarser than half the
    links' 0.04) it takes the generic route; values_only equals it too."""
    rj, rt, q = arms
    v, g = rt.query_grid(q, ARM_RANGE, resolution)
    _, pg = pt.get_coordinates_and_points_in_grid(resolution, ARM_RANGE, device=CPU)
    vr, gr = rt.query(q, pg)
    assert v.shape == (3,) + tuple(v.shape[1:]) and g.shape == v.shape + (3,)
    assert torch.equal(v.reshape(3, -1), vr) and torch.equal(g.reshape(3, -1, 3), gr)
    vj, gj = rj.query_grid(jnp.asarray(q), ARM_RANGE, resolution)
    assert np.abs(v.numpy() - np.asarray(vj)).max() < 1e-5
    assert np.abs(g.numpy() - np.asarray(gj)).max() < 1e-4
    vo = rt.query_grid(q, ARM_RANGE, resolution, values_only=True)
    assert torch.equal(vo, v) and not vo.requires_grad


def _dq(robot, q, fn):
    qq = torch.as_tensor(q).requires_grad_(True)
    v, g = fn(robot, qq)
    (dq,) = torch.autograd.grad(v.sum() + g.sum(), qq)
    return dq


def test_query_grid_joint_gradient(arms):
    """d(v.sum() + g.sum())/dq through the per-tile winner path equals the
    generic path's within 2e-4 (its backward rotates R^T g_obj) and JAX's
    through its own ``query_grid`` within 2e-4."""
    rj, rt, q = arms
    _, pg = pt.get_coordinates_and_points_in_grid(0.02, ARM_RANGE, device=CPU)
    d_tile = _dq(rt, q, lambda r, qq: r.query_grid(qq, ARM_RANGE, 0.02))
    d_gen = _dq(rt, q, lambda r, qq: r.query(qq, pg))
    assert torch.isfinite(d_tile).all()
    np.testing.assert_allclose(d_tile.numpy(), d_gen.numpy(), rtol=2e-4, atol=2e-4)

    def obj(qq):
        v, g = rj.query_grid(qq, ARM_RANGE, 0.02)
        return v.sum() + g.sum()

    d_jax = np.asarray(jax.grad(obj)(jnp.asarray(q)))
    np.testing.assert_allclose(d_tile.numpy(), d_jax, rtol=2e-4, atol=2e-4)


def test_voxel_view_matches_jax(arms):
    """``ComposedSDF.get_voxel_view`` through the tiles equals the generic
    raster (bit for bit) and JAX's view; its fallback still answers."""
    rj, rt, q = arms
    rj.set_joint_configuration(jnp.asarray(q[0]))
    rt.set_joint_configuration(q[0])
    try:
        qr = np.array([[-0.3, 0.2], [-0.1, 0.1], [-0.1, 0.4]])
        vt = rt.sdf.get_voxel_view(pt.VoxelGrid(0.02, qr, device=CPU))
        vj = rj.sdf.get_voxel_view(pv.VoxelGrid(0.02, qr))
        grid = pt.VoxelGrid(0.02, qr, device=CPU)
        vr, _ = rt.sdf(grid.get_voxel_center_points())
        assert torch.equal(vt.raw_data, vr.reshape(vt.raw_data.shape))
        assert np.abs(vt.raw_data.numpy() - np.asarray(vj.raw_data)).max() < 1e-5
        assert float(vt.invalid_value(torch.tensor([[5.0, 5.0, 5.0]]))[0]) > 1.0
        # the base view (a cache's own grid) and the filtered points
        link = rt.sdf.sdfs[1]
        assert link.get_voxel_view() is link.voxels
        inside = link.get_filtered_points(lambda v: v < 0, pt.VoxelGrid(0.04, qr, device=CPU))
        assert inside.shape[1] == 3
    finally:
        rj.set_joint_configuration(jnp.asarray(q))
        rt.set_joint_configuration(q)
