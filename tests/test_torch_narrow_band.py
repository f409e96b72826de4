"""The port's narrow-band SDF against the JAX package on the same inputs
(CPU): the mesh's pseudonormals and signed volume, the native runtime, the
eight tables, the npz cache across packages, the query against the JAX
package's jitted query, the straight-through gradient, and robots with
narrow-band links.  Skipped only without ``g++`` (both packages build their
native runtime with it)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu import mesh as jmesh
from pytorch_volumetric_tpu import native as jnative
from pytorch_volumetric_tpu.ops import narrow_band as jnb
from pytorch_volumetric_tpu.utils.robots import make_serial_arm
from pytorch_volumetric_tpu_torch import native as tnative
from pytorch_volumetric_tpu_torch import state
from pytorch_volumetric_tpu_torch.ops import narrow_band as tnb
from pytorch_volumetric_tpu_torch.ops.narrow_band_cuda import narrow_band_query_cuda
from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS
from torch_cpu_guard import warm_sqrt

warm_sqrt()

pytestmark = pytest.mark.skipif(not tnative.available(),
                                reason="g++ unavailable: no native runtime to build")

CPU = torch.device("cpu")
# the torus of tests/test_narrow_band.py (2,304 faces) and its build
TORUS = dict(major_radius=0.3, minor_radius=0.12, major_segments=48, minor_segments=24)
TORUS_BUILD = dict(cell_res=0.03, band=0.1, padding=0.2)


def _torus():
    return jmesh.torus_mesh(**TORUS)


def _inverted_icosphere():
    m = jmesh.icosphere_mesh(radius=0.2, subdivisions=2)
    return jmesh.TriangleMesh(m.vertices, m.faces[:, ::-1])


MESHES = {"torus": _torus,
          "icosphere": lambda: jmesh.icosphere_mesh(radius=0.2, subdivisions=2),
          "inverted icosphere": _inverted_icosphere}


def _port_mesh(m):
    return pt.mesh.TriangleMesh(m.vertices, m.faces)


def _factories(m, d, name):
    path = os.path.join(d, f"{name}.obj")
    jmesh.save_obj(m, path)
    return pv.MeshObjectFactory(path), pt.MeshObjectFactory(path, device="cpu")


@pytest.fixture(scope="module")
def torus_sdfs(tmp_path_factory):
    """The torus in both packages: JAX's ``NarrowBandMeshSDF``, the port's
    on JAX's tables, and the port's own build."""
    fj, ft = _factories(_torus(), str(tmp_path_factory.mktemp("torus")), "torus")
    nj = pv.NarrowBandMeshSDF(fj, **TORUS_BUILD)
    on_jax = state.narrow_band_sdf_from_numpy(ft, [np.asarray(a) for a in nj.tables])
    own = pt.NarrowBandMeshSDF(ft, **TORUS_BUILD)
    return nj, on_jax, own, ft


# ---------------------------------------------------------------------------
# (a) the mesh's signed volume and pseudonormals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MESHES))
def test_signed_volume_and_pseudonormals_equal_jax(name):
    m = MESHES[name]()
    tm = _port_mesh(m)
    assert tm.signed_volume() == m.signed_volume()
    assert (tm.signed_volume() < 0) == (name == "inverted icosphere")
    for a, b in zip(tm.pseudonormals(), m.pseudonormals()):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# (b) the native runtime
# ---------------------------------------------------------------------------

def test_native_closest_query_equals_jax(rng):
    tris = _torus().triangles().astype(np.float32)
    pts = rng.uniform(-0.5, 0.5, (3000, 3)).astype(np.float32)
    for a, b in zip(tnative.NativeScene(tris).closest_query(pts),
                    jnative.NativeScene(tris).closest_query(pts)):
        assert np.array_equal(a, b)


def _cell_inputs(m, cell_res, band, padding):
    """The arguments of ``build_cell_table`` as the narrow-band build makes
    them, from the JAX package's native scene."""
    tris = m.triangles().astype(np.float32)
    aabb = m.aabb()
    lo, hi = aabb[:, 0] - padding, aabb[:, 1] + padding
    dims = np.maximum(np.ceil((hi - lo) / cell_res).astype(np.int64), 1)
    res = (hi - lo) / dims
    ii = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij"), -1).reshape(-1, 3)
    dist = jnative.NativeScene(tris).closest_query((lo + (ii + 0.5) * res).astype(np.float32))[0]
    radius = np.where(dist <= band, dist + 0.5 * np.linalg.norm(res) + 1e-5, -1.0)
    return tris, lo, res, dims, radius.astype(np.float32)


def _sorted_rows(ids):
    """Each row's ids ascending, the -1 padding last."""
    big = np.iinfo(np.int32).max
    s = np.sort(np.where(ids < 0, big, ids), axis=1)
    return np.where(s == big, -1, s)


@pytest.mark.parametrize("name", ["torus", "icosphere"])
def test_native_cell_table_equals_jax(name):
    """The same candidates and counts.  The port's ids are ascending in each
    cell; the JAX package's are too below 1,024 faces (one thread fills
    them), and above it in an order left to thread timing."""
    m = MESHES[name]()
    args = _cell_inputs(m, 0.03, 0.1, 0.2)
    ids_t, counts_t = tnative.build_cell_table(*args, max_k=512)
    ids_j, counts_j = jnative.build_cell_table(*args, max_k=512)
    assert np.array_equal(counts_t, counts_j) and ids_t.shape == ids_j.shape
    assert np.array_equal(ids_t, _sorted_rows(ids_t))
    assert np.array_equal(ids_t, _sorted_rows(ids_j))
    if len(m.faces) < 1024:
        assert np.array_equal(ids_t, ids_j)
    again, _ = tnative.build_cell_table(*args, max_k=512)
    assert np.array_equal(ids_t, again)


def test_native_parse_obj_equals_jax(tmp_path):
    path = str(tmp_path / "torus.obj")
    jmesh.save_obj(_torus(), path)
    for a, b in zip(tnative.parse_obj_native(path), jnative.parse_obj_native(path)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_native_rejects_empty_mesh_and_missing_file(tmp_path):
    with pytest.raises(ValueError, match="empty"):
        tnative.NativeScene(np.zeros((0, 3, 3), dtype=np.float32))
    with pytest.raises(OSError):
        tnative.parse_obj_native(str(tmp_path / "missing.obj"))
    with pytest.raises(ValueError, match="empty"):
        tnb.build_narrow_band_host(pt.mesh.TriangleMesh(np.zeros((3, 3)), np.zeros((0, 3))),
                                   0.1, 0.1)


def test_native_library_is_built_outside_the_source_tree():
    path = tnative.library_path()
    assert os.path.exists(path) and os.sep + "_build" + os.sep in path
    assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(tnative._SRC)))


# ---------------------------------------------------------------------------
# (c) the eight tables
# ---------------------------------------------------------------------------

def _by_face_id(cand):
    """Candidate rows ordered by face id within each cell, padding last."""
    fid = cand[..., 9].view(np.int32)
    pad = (cand[..., :9] == pt.mesh.PAD_COORD).all(-1)
    order = np.argsort(np.where(pad, np.iinfo(np.int32).max, fid), axis=1, kind="stable")
    return np.take_along_axis(cand, order[..., None], axis=1)


BUILDS = {"torus": ("torus", TORUS_BUILD, 256),
          "icosphere": ("icosphere", dict(cell_res=0.03, band=0.06, padding=0.1), 256),
          "icosphere, max_k=8 (demoted cells)": (
              "icosphere", dict(cell_res=0.03, band=0.06, padding=0.1), 8),
          "inverted icosphere": (
              "inverted icosphere", dict(cell_res=0.03, band=0.06, padding=0.1), 256)}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_tables_byte_identical_to_jax(case, caplog):
    name, build, max_k = BUILDS[case]
    m = MESHES[name]()
    jt = [np.asarray(a) for a in jnb.build_narrow_band_tables(m, max_k=max_k, **build)]
    ht = tnb.build_narrow_band_host(_port_mesh(m), max_k=max_k, **build)
    for field, a, b in zip(tnb.NarrowBandTables._fields, jt, ht):
        if field == "cand" and len(m.faces) >= 1024:
            a = _by_face_id(a)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    if max_k == 8:
        assert "exceed max_k=8" in caplog.text
    if name == "inverted icosphere":
        assert "winds inward" in caplog.text


def test_grid_of_2_31_cells_is_refused():
    m = _port_mesh(MESHES["icosphere"]())
    with pytest.raises(ValueError, match="int32"):
        tnb.build_narrow_band_host(m, cell_res=2e-4, band=0.01)


# ---------------------------------------------------------------------------
# (d) the cache across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_loads_across_packages(tmp_path, writer, rng):
    m = MESHES["icosphere"]()
    fj, ft = _factories(m, str(tmp_path), "s")
    cache = str(tmp_path / "nb.npz")
    build = dict(cell_res=0.03, band=0.06, padding=0.1, cache_path=cache)
    if writer == "jax":
        first = [np.asarray(a) for a in pv.NarrowBandMeshSDF(fj, **build).tables]
    else:
        first = [t.numpy() for t in pt.NarrowBandMeshSDF(ft, **build).tables]
    # the reader must not build: its native runtime is out of reach
    saved = (jnative.available, tnative.get_lib)
    jnative.available = lambda: False
    tnative.get_lib = None
    try:
        if writer == "jax":
            second = [t.numpy() for t in pt.NarrowBandMeshSDF(ft, **build).tables]
        else:
            second = [np.asarray(a) for a in pv.NarrowBandMeshSDF(fj, **build).tables]
    finally:
        jnative.available, tnative.get_lib = saved
    for a, b in zip(first, second):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# (e) the query against the JAX package's jitted query
# ---------------------------------------------------------------------------

def _jax_classes(nj, pts):
    """Each point's slot (-1 far, -2 outside the grid) as the JAX package's
    jitted query computes its cell: the same compiled query on tables
    whose every cell is far with value -(cell index + 1) and no gradient."""
    big = nj.tables.big
    C = big.meta.shape[0]
    meta = jnp.zeros((C, 5), jnp.float32).at[:, 0].set(-1.0 - jnp.arange(C, dtype=jnp.float32))
    coded = big._replace(meta=meta.at[:, 4].set(-1.0))
    v = np.asarray(jax.jit(nj._st_query)(coded, jnp.asarray(pts), nj._eps)[0])
    cidx = np.rint(-v - 1.0).astype(np.int64)
    slots = np.asarray(big.meta)[:, 4].astype(np.int32)[np.clip(cidx, 0, C - 1)]
    return np.where(v < 0, slots, tnb.OUT_OF_GRID)


def _cell_face_points(tables, n, rng):
    """Points within 3 ulp of a cell face in every coordinate."""
    lo, res, dims = (np.asarray(t) for t in (tables.lo, tables.res, tables.dims))
    k = rng.integers(0, dims + 1, (n, 3))
    p = (lo.astype(np.float64) + k * res.astype(np.float64)).astype(np.float32)
    return (p + rng.integers(-3, 4, (n, 3)).astype(np.float32) * np.spacing(p)).astype(np.float32)


def _query_points(kind, nj, rng):
    if kind == "uniform":
        return rng.uniform(-0.55, 0.55, (3000, 3)).astype(np.float32)
    if kind == "band":
        pts, _, _ = _torus().sample_points_uniformly(3000, rng=rng, return_normals=True)
        return (pts + rng.normal(0, 0.03, pts.shape)).astype(np.float32)
    if kind == "surface":
        return _torus().sample_points_uniformly(2000, rng=rng).astype(np.float32)
    if kind == "cell faces":
        return _cell_face_points(nj.tables, 20000, rng)
    # out of the grid, and on its faces
    return np.concatenate([rng.uniform(-3, 3, (1000, 3)),
                           _cell_face_points(nj.tables, 4000, rng)]).astype(np.float32)


def _assert_matches_jax(nj, pts, vt, gt, slot):
    """The port's ``(vt, gt)`` against the JAX package's query on ``pts``
    (``slot``: the port's classification, equal to the jitted query's).

    - Jitted: values within 2e-6.
    - The JAX package's candidate cascade run eagerly (no contraction) on
      the candidate rows of each in-band point's cell: values and
      gradients within 1e-6.
    - Jitted gradients: within 1e-5, plus 1e-7 / |v| near the surface,
      wherever the jitted query agrees that closely with its own eager
      cascade (at least 99% of the points).  XLA contracts the jitted
      query's multiply-adds into fused multiply-adds (the port, like its
      kernel, rounds every operation): that moves the closest point by
      about an ulp, which ``(p - q) / d`` divides by the distance, and at
      near-ties it moves the winner itself (a point almost equidistant
      from two parts of the surface).
    """
    vt, gt, slot = vt.detach().numpy(), gt.detach().numpy(), np.asarray(slot)
    vj, gj = (np.asarray(x) for x in nj(jnp.asarray(pts)))
    assert np.abs(vt - vj).max() <= 2e-6
    ve, ge = vj.copy(), gj.copy()
    band = np.nonzero(slot >= 0)[0]
    cand = np.asarray(nj.tables.cand)
    for s in range(0, len(band), 1024):
        idx = band[s:s + 1024]
        v, g = jnb._candidate_query(jnp.asarray(pts[idx]), jnp.asarray(cand[slot[idx]]),
                                    nj.tables.pseudo, nj._eps)
        ve[idx], ge[idx] = np.asarray(v), np.asarray(g)
    assert np.abs(vt - ve)[band].max(initial=0.0) <= 1e-6
    assert np.abs(gt - ge)[band].max(initial=0.0) <= 1e-6
    gate = 1e-5 + 1e-7 / np.maximum(np.abs(vj), 1e-3)
    steady = np.abs(gj - ge).max(axis=-1) <= gate
    assert steady.mean() >= 0.99
    assert (np.abs(gt - gj).max(axis=-1)[steady] <= gate[steady]).all()


@pytest.mark.parametrize("kind", ["uniform", "band", "surface", "cell faces", "out of grid"])
def test_query_matches_jitted_jax(torus_sdfs, kind, rng):
    """On the JAX package's tables: the same classification (candidate
    slot, far field, out of the grid) as its jitted query, including points
    within 3 ulp of cell faces, and values and gradients within the gates
    of :func:`_assert_matches_jax`."""
    nj, on_jax, *_ = torus_sdfs
    pts = _query_points(kind, nj, rng)
    vt, gt, slot = tnb.narrow_band_query(on_jax.tables, torch.as_tensor(pts),
                                         backend="torch", with_slots=True)
    assert np.array_equal(slot.numpy(), _jax_classes(nj, pts))
    assert (slot >= 0).any()
    assert bool((slot == tnb.OUT_OF_GRID).any()) == (kind in ("uniform", "cell faces",
                                                             "out of grid"))
    _assert_matches_jax(nj, pts, vt, gt, slot)
    # through the entry point (its straight-through wrapper), equal
    v2, g2 = on_jax(pts)
    assert torch.equal(v2, vt) and torch.equal(g2, gt)


def test_own_build_matches_jax_query(torus_sdfs, rng):
    """The port's own torus tables (candidates in face order) give the JAX
    package's values within the same gates."""
    nj, _, own, _ = torus_sdfs
    pts = _query_points("band", nj, rng)
    vt, gt, slot = tnb.narrow_band_query(own.tables, torch.as_tensor(pts), with_slots=True)
    assert np.array_equal(slot.numpy(), _jax_classes(nj, pts))
    _assert_matches_jax(nj, pts, vt, gt, slot)


@pytest.mark.parametrize("case", ["icosphere, max_k=8 (demoted cells)", "inverted icosphere"])
def test_demoted_and_inverted_queries_match_jax(tmp_path, case, rng):
    name, build, max_k = BUILDS[case]
    fj, ft = _factories(MESHES[name](), str(tmp_path), "m")
    nj = pv.NarrowBandMeshSDF(fj, max_k=max_k, **build)
    nt = pt.NarrowBandMeshSDF(ft, max_k=max_k, **build)
    pts = rng.uniform(-0.3, 0.3, (3000, 3)).astype(np.float32)
    vt, gt, slot = tnb.narrow_band_query(nt.tables, torch.as_tensor(pts), with_slots=True)
    assert np.array_equal(slot.numpy(), _jax_classes(nj, pts))
    _assert_matches_jax(nj, pts, vt, gt, slot)
    # inside is negative whatever the winding
    assert vt[torch.as_tensor(np.linalg.norm(pts, axis=1) < 0.15)].max() < 0


def test_band_values_match_exact_mesh_sdf(torus_sdfs, rng):
    """In the band the narrow-band SDF is the exact one (the port's own
    ``MeshSDF``)."""
    *_, own, ft = torus_sdfs
    base = rng.uniform(-0.45, 0.45, (400, 3)).astype(np.float32)
    v_ex, g_ex = pt.MeshSDF(ft)(base)
    mask = v_ex.abs() < 0.06
    assert mask.sum() > 20
    v, g = own(base[mask.numpy()])
    assert (v - v_ex[mask]).abs().max().item() <= 2e-5
    assert (g - g_ex[mask]).abs().max().item() <= 1e-3


def test_wrapper_runs_the_plain_version_on_cpu(torus_sdfs, rng, monkeypatch):
    """On CPU tensors the kernel's wrapper runs the plain version (no
    launch), whatever the plain version's chunking; on other devices it
    raises."""
    _, on_jax, *_ = torus_sdfs
    smalls, big = on_jax.tables.smalls, on_jax.tables.big
    pts = torch.as_tensor(rng.uniform(-0.5, 0.5, (500, 3)).astype(np.float32))
    before = COUNTERS["kernel.narrow_band_query"]
    v, g, s = narrow_band_query_cuda(smalls, big, pts, with_slots=True)
    assert COUNTERS["kernel.narrow_band_query"] == before
    monkeypatch.setattr(tnb, "PAIRS_PER_CHUNK", 777)
    ref = tnb._query_impl(smalls, big, pts, 1e-3)
    for a, b in zip((v, g, s), ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        narrow_band_query_cuda(smalls, big, torch.empty((4, 3), device="meta"))


def test_sdf_backend_selects_the_plain_version(torus_sdfs, rng):
    """``NarrowBandMeshSDF(backend="torch")`` runs the plain version (equal
    to the wrapper's on the CPU, no launch); an unknown backend raises."""
    _, on_jax, _, ft = torus_sdfs
    pts = torch.as_tensor(rng.uniform(-0.5, 0.5, (500, 3)).astype(np.float32))
    before = COUNTERS["kernel.narrow_band_query"]
    v, g = pt.NarrowBandMeshSDF(ft, tables=on_jax.tables, backend="torch")(pts)
    assert COUNTERS["kernel.narrow_band_query"] == before
    vr, gr = on_jax(pts)
    assert torch.equal(v, vr) and torch.equal(g, gr)
    with pytest.raises(ValueError, match="unknown backend"):
        pt.NarrowBandMeshSDF(ft, tables=on_jax.tables, backend="triton")(pts)


# ---------------------------------------------------------------------------
# (f) the straight-through gradient
# ---------------------------------------------------------------------------

def test_straight_through_gradient(torus_sdfs, rng):
    nj, on_jax, *_ = torus_sdfs
    pts = rng.uniform(-0.4, 0.4, (64, 3)).astype(np.float32)
    offset = torch.zeros(3, requires_grad=True)
    v, _ = on_jax.raw_query(torch.as_tensor(pts) + offset)
    (d_off,) = torch.autograd.grad(v.sum(), offset)
    _, grads = on_jax(pts)
    assert torch.allclose(d_off, grads.sum(0), rtol=1e-4, atol=1e-5)
    gj = jax.grad(lambda o: nj.raw_query(jnp.asarray(pts) + o)[0].sum())(jnp.zeros(3))
    assert np.abs(d_off.numpy() - np.asarray(gj)).max() <= 1e-4


# ---------------------------------------------------------------------------
# (g, h) robots with narrow-band links, and JAX's tables installed
# ---------------------------------------------------------------------------

LINK_BUILD = dict(cell_res=0.015, band=0.06, padding=0.1)


@pytest.fixture(scope="module")
def nb_arms(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("arm"))
    urdf, end = make_serial_arm(d, num_joints=3, segments=10, rings=3)
    text = open(urdf).read()
    rj = pv.RobotSDF(pv.build_serial_chain_from_urdf(text, end), path_prefix=d,
                     link_sdf_cls=pv.narrow_band_link_sdf_factory(**LINK_BUILD))
    rt = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device="cpu"), path_prefix=d,
                     link_sdf_cls=pt.narrow_band_link_sdf_factory(**LINK_BUILD))
    return d, text, end, rj, rt


def _arm_inputs(seed, A=2, P=256):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (A, 3)).astype(np.float32),
            rng.uniform(-0.3, 0.3, (P, 3)).astype(np.float32))


def test_narrow_band_robot_matches_jax(nb_arms):
    """Values, gradients and d/dq, d/dpts of ``RobotSDF.query``; the links'
    tables are the port's own builds (small meshes: byte-identical)."""
    *_, rj, rt = nb_arms
    for sj, st in zip(rj.sdf.sdfs, rt.sdf.sdfs):
        assert isinstance(st, pt.NarrowBandMeshSDF)
        for a, b in zip(sj.tables, st.tables):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
    q, pts = _arm_inputs(0)

    def obj_j(qq, pp):
        v, g = rj.query(qq, pp)
        return v.sum() + g.sum()

    vj, gj = (np.asarray(x) for x in rj.query(jnp.asarray(q), jnp.asarray(pts)))
    dqj, dpj = jax.grad(obj_j, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(pts))
    qt = torch.as_tensor(q).requires_grad_(True)
    ptt = torch.as_tensor(pts).requires_grad_(True)
    vt, gt = rt.query(qt, ptt)
    dqt, dpt = torch.autograd.grad(vt.sum() + gt.sum(), (qt, ptt))
    assert (vj < 0).any() and (vj > 0).any()
    assert np.abs(vt.detach().numpy() - vj).max() <= 1e-5
    assert np.abs(gt.detach().numpy() - gj).max() <= 1e-4
    assert np.abs(dqt.numpy() - np.asarray(dqj)).max() <= 1e-4
    assert np.abs(dpt.numpy() - np.asarray(dpj)).max() <= 1e-4


def test_narrow_band_robot_against_exact_links(nb_arms):
    """Near the surface the narrow-band robot is the exact-link robot; it
    never overestimates by more than the far field's error."""
    d, text, end, _, rt = nb_arms
    exact = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device="cpu"),
                        path_prefix=d)
    q, pts = _arm_inputs(1)
    v_ex, _ = exact.query(q, pts)
    v_nb, _ = rt.query(q, pts)
    near = v_ex.abs() < 0.02
    assert near.any()
    assert (v_nb[near] - v_ex[near]).abs().max().item() <= 1e-4
    assert bool((v_nb <= v_ex + 0.01).all())


def test_narrow_band_robot_query_grid_equals_query(nb_arms):
    *_, rt = nb_arms
    q, _ = _arm_inputs(2, A=3)
    rng_pd = np.array([[-0.3, 0.3], [0.0, 0.0], [-0.1, 0.5]])
    vg, gg = rt.query_grid(q, rng_pd, 0.02)
    _, pts = pt.get_coordinates_and_points_in_grid(0.02, rng_pd, device="cpu")
    v, g = rt.query(q, pts)
    assert torch.equal(vg.reshape(v.shape), v) and torch.equal(gg.reshape(g.shape), g)


def test_link_launches_are_the_query_launches(nb_arms, monkeypatch):
    """``bench.bigmesh.link_launches`` gives the tables and link-frame
    points of every launch ``RobotSDF.query`` makes, in order, bit for bit
    (the card timings of the arm's launches rest on it)."""
    from pytorch_volumetric_tpu_torch.bench import bigmesh
    from pytorch_volumetric_tpu_torch.ops import narrow_band_cuda

    *_, rt = nb_arms
    q, pts = (torch.as_tensor(x) for x in _arm_inputs(4, A=3))
    seen = []

    def record(smalls, big, points, *args, **kwargs):
        seen.append((big, points.clone()))
        return narrow_band_query_cuda(smalls, big, points, *args, **kwargs)

    monkeypatch.setattr(narrow_band_cuda, "narrow_band_query_cuda", record)
    rt.query(q, pts)
    calls = bigmesh.link_launches(rt, q, pts)
    assert len(calls) == len(seen) == len(rt.sdf.sdfs)
    for (smalls, big, p), (big_seen, p_seen) in zip(calls, seen):
        assert all(a is b for a, b in zip(big, big_seen))
        assert torch.equal(p, p_seen) and p.is_contiguous()
    plain = pt.RobotSDF(rt.chain, path_prefix=nb_arms[0], link_sdf_cls=pt.
                        narrow_band_link_sdf_factory(backend="torch", **LINK_BUILD))
    assert bigmesh.link_launches(plain, q, pts) == []


def test_load_robot_tables_installs_jax_tables(nb_arms):
    """JAX's link tables installed with ``state.load_robot_tables``: the
    same query as the port's own build (byte-identical tables)."""
    d, text, end, rj, rt = nb_arms
    r2 = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device="cpu"), path_prefix=d,
                     link_sdf_cls=pt.narrow_band_link_sdf_factory(**LINK_BUILD))
    state.load_robot_tables(r2, [{f: np.asarray(a) for f, a in zip(s.tables._fields, s.tables)}
                                 for s in rj.sdf.sdfs])
    assert all(isinstance(s, pt.NarrowBandMeshSDF) for s in r2.sdf.sdfs)
    q, pts = _arm_inputs(3)
    for a, b in zip(r2.query(q, pts), rt.query(q, pts)):
        assert torch.equal(a, b)


def test_union_threads_tables_as_arguments(torus_sdfs):
    """A union reads the child's big tables at call time
    (``raw_query_aux``): swapping them changes the result."""
    _, on_jax, *_ = torus_sdfs
    composed = pt.ComposedSDF([on_jax], pt.Transform3d(matrix=torch.eye(4)[None]))
    pts = torch.tensor([[0.45, 0.0, 0.0], [0.0, 0.0, 0.3]])
    v0, _ = composed(pts)
    orig = on_jax.tables
    try:
        meta = orig.meta.clone()
        meta[:, 0] += 0.25
        on_jax.tables = orig._replace(meta=meta)
        v1, _ = composed(pts)
    finally:
        on_jax.tables = orig
    assert not torch.allclose(v0, v1)
    assert torch.equal(composed(pts)[0], v0)
