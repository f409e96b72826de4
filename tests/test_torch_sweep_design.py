"""The exactness arguments of the sweep kernel's design
(``pytorch_volumetric_tpu_torch/csrc/closest_point.cu``), checked on the
CPU with plain-torch mirrors of its pieces, since the kernel itself runs
only on the card (``test_torch_cuda.py``):

(a) select, then divide: the kernel's cascade equals the plain version's
    ``_region_cascade`` bit for bit;
(b) the boundary test that decides which meshes get an exterior box;
(c) the winding number outside a closed mesh's grown box is 0 to rounding
    (here and in the JAX package), and not outside an open one's;
(d) cluster culling never skips a face that could be the result, and the
    culled sweep returns the plain version's distances and face ids.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_volumetric_tpu import mesh as jm
from pytorch_volumetric_tpu.ops import point_triangle as jpt
from pytorch_volumetric_tpu_torch import mesh as tm
from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr
from pytorch_volumetric_tpu_torch.ops import cuda_build
from pytorch_volumetric_tpu_torch.ops import point_triangle as tpt
from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm
from torch_cpu_guard import warm_sqrt

warm_sqrt()
CPU = torch.device("cpu")
F32 = np.float32


def _kernel_constants(source="closest_point.cu"):
    """The ``constexpr`` constants of a kernel's source."""
    with open(os.path.join(cuda_build.CSRC_DIR, source)) as f:
        src = f.read()
    return {name: float(value) for name, value in
            re.findall(r"constexpr (?:int|float) (k\w+) = ([0-9.e+-]+)f?;", src)}


K = _kernel_constants()
# the tensor-core sweep's: the same culling, 16 points a warp
KM = _kernel_constants("closest_point_mma.cu")


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=F32))


# ---------------------------------------------------------------------------
# (a) select, then divide
# ---------------------------------------------------------------------------

def _safe_den(den):
    return torch.where(den.abs() < 1e-30, 1e-30, den)


def _select_then_divide(p, a, ab, ac):
    """The kernel's ``closest_pair`` in torch: the region flags first, then
    one quotient for the winning edge (or the interior's v) and one for the
    interior's w."""
    dot = tpt._dot
    ap = p - a
    d1, d2 = dot(ab, ap), dot(ac, ap)
    bp = ap - ab
    d3, d4 = dot(ab, bp), dot(ac, bp)
    cp = ap - ac
    d5, d6 = dot(ab, cp), dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    e43, e56 = d4 - d3, d5 - d6
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & (e43 >= 0) & (e56 >= 0)
    num = torch.where(on_ab, d1, torch.where(on_ac, d2, torch.where(on_bc, e43, vb)))
    den = torch.where(on_ab, d1 - d3, torch.where(on_ac, d2 - d6,
                                                  torch.where(on_bc, e43 + e56, denom)))
    q1 = num / _safe_den(den)
    q2 = vc / _safe_den(denom)
    v, w = q1, q2
    v, w = torch.where(on_bc, 1.0 - q1, v), torch.where(on_bc, q1, w)
    v, w = torch.where(on_ac, 0.0, v), torch.where(on_ac, q1, w)
    v, w = torch.where(on_ab, q1, v), torch.where(on_ab, 0.0, w)
    v, w = torch.where(in_c, 0.0, v), torch.where(in_c, 1.0, w)
    v, w = torch.where(in_b, 1.0, v), torch.where(in_b, 0.0, w)
    v, w = torch.where(in_a, 0.0, v), torch.where(in_a, 0.0, w)
    closest = a + v[..., None] * ab + w[..., None] * ac
    diff = closest - p
    return dot(diff, diff), closest


def _degenerate_triangles():
    """Zero-area, sliver, collinear and needle triangles, and a tiny one."""
    return _t([
        [[0, 0, 0], [0, 0, 0], [0, 0, 0]],              # a point
        [[0, 0, 0], [1, 0, 0], [2, 0, 0]],              # collinear
        [[0, 0, 0], [1, 0, 0], [0.5, 1e-7, 0]],         # sliver
        [[0, 0, 0], [1, 0, 0], [1, 0, 0]],              # repeated corner
        [[0, 0, 0], [1e-3, 0, 0], [0, 0.5, 0.3]],       # needle
        [[0.1, 0.2, 0.3], [0.1 + 1e-6, 0.2, 0.3], [0.1, 0.2 + 1e-6, 0.3]],
        [[0, 0, 0], [0.3, 0, 0], [0, 0.2, 0.1]],
    ])


@pytest.mark.parametrize("kind", ["random", "degenerate", "on_features"])
def test_select_then_divide_equals_cascade(kind):
    """Each quotient the kernel keeps is the same IEEE division of the same
    operands as the plain version's, so distances and closest points are
    bit-identical (NaN where the plain version gives NaN)."""
    rng = np.random.default_rng(3)
    if kind == "random":
        tri = _t(rng.normal(size=(64, 3, 3)))
        pts = _t(rng.normal(scale=2.0, size=(256, 3)))
    else:
        tri = _degenerate_triangles() if kind == "degenerate" else _t(rng.normal(size=(16, 3, 3)))
        # corners, edge midpoints and thirds, centroids, and points off them
        c = tri.reshape(-1, 3)
        mids = (tri + tri[:, [1, 2, 0]]) / 2
        thirds = tri + (tri[:, [1, 2, 0]] - tri) / 3
        cen = tri.mean(dim=1)
        pts = torch.cat([c, mids.reshape(-1, 3), thirds.reshape(-1, 3), cen,
                         c + _t(rng.normal(scale=1e-3, size=c.shape)),
                         _t(rng.normal(size=(64, 3)))])
    p = pts[:, None, :]
    a, ab, ac = tri[None, :, 0], (tri[:, 1] - tri[:, 0])[None], (tri[:, 2] - tri[:, 0])[None]
    d_ref, c_ref = tpt._closest_point_bary(p, a, ab, ac)
    d_new, c_new = _select_then_divide(p, a, ab, ac)
    torch.testing.assert_close(d_new, d_ref, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(c_new, c_ref, rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# (b) the boundary test
# ---------------------------------------------------------------------------

def _closed_meshes():
    return {"box": tm.box_mesh((0.4, 0.6, 0.8)), "icosphere": tm.icosphere_mesh(0.3, 2),
            "capsule": tm.capsule_mesh(radius=0.045, height=0.18, segments=14, rings=5),
            "torus": tm.torus_mesh(0.1, 0.03, 32, 16), "cylinder": tm.cylinder_mesh(0.05, 0.1)}


@pytest.mark.parametrize("name", list(_closed_meshes()))
def test_procedural_meshes_are_closed(name):
    mesh = _closed_meshes()[name]
    tri = mesh.triangles().astype(F32)
    assert not tm.has_boundary(tri)
    scene = tm.MeshScene.from_mesh(mesh, device=CPU)  # padded with PAD_COORD rows
    assert scene.tri.shape[0] > len(tri) or len(tri) % 128 == 0
    box = scene.exterior_box
    aabb = mesh.aabb().astype(F32)
    assert box is not None and box.dtype == F32 and box.shape == (2, 3)
    assert (box[0] < aabb[:, 0]).all() and (box[1] > aabb[:, 1]).all()
    assert (box[1] - box[0]).max() < (1.001 + 2 * tm.EXTERIOR_MARGIN_EXTENT) * (aabb[:, 1] - aabb[:, 0]).max()


def test_headline_arm_links_are_closed(tmp_path):
    """The arm's OBJ files, read back as the robot path reads them."""
    make_serial_arm(str(tmp_path), num_joints=7)
    objs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".obj"))
    assert objs
    for f in objs:
        mesh = tm.read_triangle_mesh(os.path.join(tmp_path, f))
        assert tm.MeshScene.from_mesh(mesh, device=CPU).exterior_box is not None, f


def test_open_surfaces_get_no_box():
    box = tm.box_mesh().triangles().astype(F32)
    assert tm.has_boundary(box[1:])            # one triangle less
    assert tm.has_boundary(box[:1])            # a single triangle
    flipped = box.copy()
    flipped[0] = flipped[0, [0, 2, 1]]         # one face turned over
    assert tm.has_boundary(flipped)
    pad = np.full((5, 3, 3), tm.PAD_COORD, F32)
    assert not tm.has_boundary(np.concatenate([box[:6], pad, box[6:]]))
    assert tm.has_boundary(pad) and tm.exterior_box(pad) is None
    assert tm.exterior_box(box[1:]) is None
    # -0.0 and +0.0 are one position
    mesh = tm.box_mesh(center=(0.5, 0.5, 0.5))
    tri = mesh.triangles().astype(F32)
    tri[tri == 0] = np.float32(-0.0)
    tri[0][tri[0] == 0] = np.float32(0.0)
    assert not tm.has_boundary(tri)


def test_scene_from_numpy_tables_gets_the_box():
    from pytorch_volumetric_tpu_torch.state import scene_from_numpy
    ref = tm.MeshScene.from_mesh(tm.icosphere_mesh(0.2, 1), device=CPU)
    scene = scene_from_numpy(ref.tri.numpy(), ref.normals.numpy(), ref.num_faces, device=CPU)
    np.testing.assert_array_equal(scene.exterior_box, ref.exterior_box)


# ---------------------------------------------------------------------------
# (c) the winding number outside the box
# ---------------------------------------------------------------------------

def _outside_points(box, rng, n=600):
    """Points strictly outside ``box``: just outside each face (within
    1e-4 of the grown box) and up to 1 m away."""
    lo, hi = box[0].astype(np.float64), box[1].astype(np.float64)
    size = hi - lo
    near = rng.uniform(lo, hi, (n, 3))
    axis = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n)
    eps = rng.uniform(1e-6, 1e-4, n)
    near[np.arange(n), axis] = np.where(side, hi[axis] + eps, lo[axis] - eps)
    far = rng.uniform(lo - 1.0, hi + 1.0, (4 * n, 3))
    far = far[((far < lo) | (far > hi)).any(axis=1)]
    pts = np.concatenate([near, far]).astype(F32)
    out = ((pts < box[0]) | (pts > box[1])).any(axis=1)
    return pts[out]


@pytest.mark.parametrize("name", ["box", "icosphere", "capsule", "torus"])
def test_winding_vanishes_outside_a_closed_mesh_box(name):
    """Where the kernel writes 0, the plain sweep (port and JAX package)
    sums to 0 within 1e-5."""
    mesh = _closed_meshes()[name]
    scene = tm.MeshScene.from_mesh(mesh, device=CPU)
    pts = _outside_points(scene.exterior_box, np.random.default_rng(4))
    _, _, _, w = tpt.mesh_closest_query(torch.as_tensor(pts), scene.tri)
    assert w.abs().max().item() <= 1e-5
    js = jm.MeshScene.from_mesh(getattr(jm, {"box": "box_mesh", "icosphere": "icosphere_mesh",
                                             "capsule": "capsule_mesh",
                                             "torus": "torus_mesh"}[name])(
        *{"box": ((0.4, 0.6, 0.8),), "icosphere": (0.3, 2),
          "capsule": (0.045, 0.18, 14, 5), "torus": (0.1, 0.03, 32, 16)}[name]))
    wj = np.asarray(jpt.mesh_closest_query(jnp.asarray(pts), js.tri)[3])
    assert np.abs(wj).max() <= 1e-5


def test_open_triangle_winding_near_its_flat_box_is_half():
    """A single triangle seen from just above its interior, outside its
    flat bounding box: winding ~0.5, which is why an open mesh never takes
    the shortcut."""
    tri = _t([[[0, 0, 0], [0.3, 0, 0], [0, 0.2, 0]]])
    assert tm.exterior_box(tri.numpy()) is None
    pts = _t([[0.05, 0.05, 1e-4], [0.1, 0.02, 1e-5], [0.02, 0.1, -1e-4]])
    _, _, _, w = tpt.mesh_closest_query(pts, tri)
    np.testing.assert_allclose(w.abs().numpy(), 0.5, atol=2e-3)


# ---------------------------------------------------------------------------
# (d) cluster culling
# ---------------------------------------------------------------------------

def _is_thin(ab, ac):
    x0 = ab[..., 1] * ac[..., 2] - ab[..., 2] * ac[..., 1]
    x1 = ab[..., 2] * ac[..., 0] - ab[..., 0] * ac[..., 2]
    x2 = ab[..., 0] * ac[..., 1] - ab[..., 1] * ac[..., 0]
    cross2 = x0 * x0 + x1 * x1 + x2 * x2
    l2 = torch.maximum(tpt._dot(ab, ab), tpt._dot(ac, ac))
    return ~(cross2 >= F32(K["kThin"]) * (l2 * l2))


def _clusters(tri, tile=int(K["kTriTile"])):
    """The kernel's clusters: each tile of ``tile`` rows compacted to its
    real triangles, cut into runs of ``kCluster``; returns a list of (face
    ids, grown box lo, hi)."""
    size = int(K["kCluster"])
    pad = (tri == F32(tm.PAD_COORD)).flatten(1).all(dim=1)
    out = []
    for f0 in range(0, tri.shape[0], tile):
        ids = torch.arange(f0, min(f0 + tile, tri.shape[0]))
        ids = ids[~pad[ids]]
        for k in range(0, len(ids), size):
            cid = ids[k:k + size]
            t = tri[cid]
            lo = t.reshape(-1, 3).min(dim=0).values
            hi = t.reshape(-1, 3).max(dim=0).values
            m = torch.maximum(-lo, hi).max()
            eta = F32(K["kCullAbs"]) * m
            if bool(_is_thin(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]).any()):
                lo, hi = torch.full((3,), -np.inf), torch.full((3,), np.inf)
            else:
                lo, hi = lo - eta, hi + eta
            out.append((cid, lo, hi))
    return out


def _seed_bound(pts, tri):
    """The kernel's upper bound on each point's final best: distances to
    the first corner of every ``kCluster``-th well-shaped triangle, with
    the margins."""
    rel, ab = F32(K["kCullRel"]), F32(K["kCullAbs"])
    bound = torch.full((pts.shape[0],), np.inf)
    for f in range(0, tri.shape[0], int(K["kCluster"])):
        t = tri[f]
        if bool(_is_thin(t[1] - t[0], t[2] - t[0])):
            continue
        eta = ab * t.abs().max()
        slack = eta * eta * (F32(1) + F32(1) / rel)
        d = t[0] - pts
        u = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]) * (F32(1) + F32(2) * rel) + slack
        bound = torch.minimum(bound, u)
    return bound


def _culled_sweep(pts, tri, warp=32, tile=int(K["kTriTile"])):
    """The kernel's sweep in torch, one warp = ``warp`` consecutive points
    and tiles of ``tile`` rows: the plain version's per-pair distances
    visited cluster by cluster, a cluster skipped when the kernel would skip
    it, then the first padding triangle merged by (d2, face id).  Returns
    (d2, face id, share of real pairs evaluated) and asserts on every skip
    that no skipped face could be the result: its distance is >= the
    running best (a lower id holds it) or > the final minimum."""
    P = pts.shape[0]
    tri_a, ab, ac = tri[None, :, 0], (tri[:, 1] - tri[:, 0])[None], (tri[:, 2] - tri[:, 0])[None]
    d2_all, _ = tpt._closest_point_bary(pts[:, None], tri_a, ab, ac)
    final = d2_all.min(dim=1).values
    W = -(-P // warp)
    live = torch.arange(W * warp) < P
    padded = torch.cat([pts, pts[:1].expand(W * warp - P, 3)])
    bound = _seed_bound(padded, tri).reshape(W, warp)
    p = padded.reshape(W, warp, 3)
    best = torch.full((W, warp), np.inf)
    fid = torch.zeros((W, warp), dtype=torch.int64)
    d2w = torch.cat([d2_all, d2_all[:1].expand(W * warp - P, -1)]).reshape(W, warp, -1)
    finalw = torch.cat([final, final[:1].expand(W * warp - P)]).reshape(W, warp)
    livew = live.reshape(W, warp)
    rel = F32(K["kCullRel"])
    evaluated = 0
    for cid, lo, hi in _clusters(tri, tile):
        dd = torch.clamp(torch.maximum(lo - p, p - hi), min=0.0)
        lb = (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1] + dd[..., 2] * dd[..., 2]) \
            * (F32(1) - rel)
        skip = (~livew | (lb >= best) | (lb > bound)).all(dim=1)
        dc = d2w[:, :, cid]
        safe = (dc >= best[..., None]) | (dc > finalw[..., None]) | ~livew[..., None]
        assert bool(safe[skip].all()), "a culled cluster holds a face that could win"
        evaluated += int((~skip).sum()) * len(cid)
        cmin, arg = dc.min(dim=2)
        better = (cmin < best) & ~skip[:, None]
        best = torch.where(better, cmin, best)
        fid = torch.where(better, cid[arg], fid)
    pad = (tri == F32(tm.PAD_COORD)).flatten(1).all(dim=1).nonzero()
    if len(pad):
        j = int(pad[0])
        dj = d2w[:, :, j]
        take = (dj < best) | ((dj == best) & (j < fid))
        best, fid = torch.where(take, dj, best), torch.where(take, j, fid)
    n_real = int((~(tri == F32(tm.PAD_COORD)).flatten(1).all(dim=1)).sum())
    return best.reshape(-1)[:P], fid.reshape(-1)[:P], evaluated / (W * warp * n_real)


def _cull_cases():
    rng = np.random.default_rng(5)
    cap = tm.MeshScene.from_mesh(tm.capsule_mesh(0.045, 0.18, 14, 5), device=CPU)
    scene = tm.MeshScene.from_mesh(tm.icosphere_mesh(0.3, 2).concatenate(
        tm.box_mesh((0.2, 0.3, 0.1), center=(0.4, 0.0, 0.0))), device=CPU)
    grid, _ = sr.capsule_cache_grid(CPU)
    starts = rng.choice(grid.shape[0] // 32, 24, replace=False) * 32
    far = torch.cat([grid[s:s + 64] for s in starts])
    bb = cap.tri[:cap.num_faces].reshape(-1, 3)
    near = _t(rng.uniform(bb.min(0).values - 0.02, bb.max(0).values + 0.02, (768, 3)))
    surf = _t(tm.icosphere_mesh(0.3, 2).sample_points_uniformly(512, seed=2))
    # corners and face centres of the cluster boxes, and points just off them
    corners = []
    for _, lo, hi in _clusters(cap.tri):
        if bool(torch.isfinite(lo).all()):
            corners += [lo, hi, (lo + hi) / 2, torch.stack([lo[0], hi[1], lo[2]])]
    corners = torch.stack(corners)
    edge = torch.cat([corners, corners + _t(rng.normal(scale=1e-4, size=corners.shape))])
    return {"capsule grid warps": (far, cap.tri), "near the capsule": (near, cap.tri),
            "on the icosphere": (surf, scene.tri), "icosphere+box, near": (
                _t(rng.uniform(-0.5, 0.7, (1000, 3))), scene.tri),
            "cluster box corners": (edge.contiguous(), cap.tri)}


def _check_culling(case, *design):
    pts, tri = _cull_cases()[case]
    d2, fid, share = _culled_sweep(pts, tri, *design)
    dist, _, f_ref, _ = tpt.mesh_closest_query(pts, tri, winding=False)
    assert torch.equal(torch.sqrt(d2), dist)
    assert torch.equal(fid.to(torch.int32), f_ref)
    assert 0.0 < share <= 1.0
    if case == "capsule grid warps":
        assert share < 0.6  # the grid's warps skip most clusters


@pytest.mark.parametrize("case", list(_cull_cases()))
def test_cluster_culling_is_exact(case):
    _check_culling(case)


@pytest.mark.parametrize("case", list(_cull_cases()))
def test_mma_cluster_culling_is_exact(case):
    """The tensor-core sweep culls the same boxes with warps of 16 points
    (each point's running best merged over the four threads that hold
    it) in tiles of its own size."""
    _check_culling(case, int(KM["kRows"]), int(KM["kTriTile"]))


def test_kernel_constants_are_read():
    assert K["kCluster"] >= 1 and K["kTriTile"] % K["kCluster"] == 0
    assert 0 < K["kCullRel"] < 0.1 and 0 < K["kCullAbs"] < 1e-3 and 0 < K["kThin"] < 1
    assert K["kPad"] == tm.PAD_COORD


def test_mma_kernel_constants_are_its_plain_versions():
    """The tensor-core sweep culls with K1's margins, and its groups, boxes
    and direct-solid-angle rule are the plain version's."""
    for name in ("kCluster", "kCullRel", "kCullAbs", "kThin", "kPad"):
        assert KM[name] == K[name], name
    assert KM["kTriTile"] == tpt.EXPANDED_TILE and KM["kCluster"] == tpt.EXPANDED_GROUP
    assert KM["kCullAbs"] == F32(tpt.CULL_ABS) and KM["kThin"] == F32(tpt.THIN)
    assert KM["kNear"] == tpt.EXPANDED_NEAR


def test_expanded_frames_are_the_kernel_groups():
    """``expanded_frames`` gives each real face the box of its cluster in
    the tensor-core kernel's tiles and the first corner of the cluster's
    first face as its origin, with padding anywhere; a padding face keeps
    its own corner."""
    cap = tm.MeshScene.from_mesh(tm.capsule_mesh(0.045, 0.18, 14, 5), device=CPU).tri
    pad = torch.full((11, 3, 3), F32(tm.PAD_COORD))
    thin = _t([[[0, 0, 0], [1, 0, 0], [0.5, 1e-7, 0]]])
    tri = torch.cat([pad[:3], cap[:70], pad, thin, cap[70:150]])
    frames = tpt.expanded_frames(tri)
    is_pad = (tri == F32(tm.PAD_COORD)).flatten(1).all(dim=1)
    seen = torch.zeros(tri.shape[0], dtype=torch.bool)
    for cid, lo, hi in _clusters(tri, int(KM["kTriTile"])):
        seen[cid] = True
        assert torch.equal(frames[cid, 0], tri[cid[0], 0].expand(len(cid), 3))
        assert torch.equal(frames[cid, 1], lo.expand(len(cid), 3))
        assert torch.equal(frames[cid, 2], hi.expand(len(cid), 3))
    assert torch.equal(seen, ~is_pad)
    assert torch.equal(frames[is_pad], tri[is_pad, :1].expand(-1, 3, 3))


# ---------------------------------------------------------------------------
# the readings' scripts
# ---------------------------------------------------------------------------

def _script(name):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_variant_sources_apply_to_the_kernel():
    """Each compile-time variant of ``scripts/sweep_variants_torch.py``
    changes the shipped source of its kernel (it raises if one no longer
    applies), and every row names one of them."""
    sv = _script("sweep_variants_torch")
    made = {}
    for kernel, make in (("K1", sv.variants), ("mxu", sv.mma_variants)):
        with open(os.path.join(cuda_build.CSRC_DIR, sv.SOURCES[kernel])) as f:
            src = f.read()
        out = make(src)
        assert out["shipped"] == src and len(set(out.values())) == len(out)
        made[kernel] = set(out)
    for kernel in made:
        assert {v for k, v, _ in sv.ROWS.values() if k == kernel} == made[kernel]


_SASS = """
        Function : _ZN4anon26closest_point_sweep_kernelILb1EEEvPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   LDS R2, [R3] ;
.L_x_1:
        /*0020*/                   FCHK P0, R4, R5 ;
        /*0030*/                   FCHK P1, R6, R7 ;
        /*0040*/                   MUFU.RSQ R8, R9 ;
        /*0050*/                   FADD R10, R10, R8 ;
        /*0060*/              @P0 BRA `(.L_x_1) ;
        /*0070*/                   FMNMX R11, R11, R2, PT ;
        /*0080*/              @P1 BRA `(.L_x_0) ;
        /*0090*/                   EXIT ;
"""


def test_sass_census_finds_innermost_loops():
    """The census reads each innermost loop (not the loops around it) and
    labels it by what it computes; the template arguments come from the
    mangled name."""
    sc = _script("sass_census_torch")
    funcs, labels = sc.parse(_SASS)
    (fn, insns), = funcs.items()
    found = sc.loops(insns, labels[fn])
    assert [len(span) for span in found] == [5]
    assert sc.loop_kind(found[0]) == "closest+winding"
    assert sc.loop_kind([i for i in found[0] if i[1] != "FCHK"]) == "winding"
    assert sc.loop_kind([i for i in found[0] if i[1] != "MUFU"]) == "closest"
    assert sc.census(found[0])["by_class"] == {"compare_select": 2, "mufu": 1, "fp32": 1,
                                               "control": 1}
    assert sc.template_args(fn) == {"winding": True}
    assert sc.template_args("_ZN4anon26closest_point_sweep_kernelILb0EEEvPKf") == {
        "winding": False}
