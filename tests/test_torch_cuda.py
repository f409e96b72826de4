"""The port's CUDA kernels on the card: against their plain versions, their
launch counts and their input checks.  Imports neither JAX nor the JAX
package, so it runs on a GPU machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tests marked ``cuda`` skip without a CUDA device."""

import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch.ops import point_triangle as tpt
from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr
from pytorch_volumetric_tpu_torch.ops.closest_point import (
    mesh_closest_query_contracted_cuda, mesh_closest_query_cuda,
    mesh_closest_query_mma_cuda, mesh_closest_query_nowind_cuda)
from pytorch_volumetric_tpu_torch.ops.fma_probe import fma_probe, fma_probe_cuda
from pytorch_volumetric_tpu_torch.bench import bigmesh
from pytorch_volumetric_tpu_torch.ops import narrow_band as tnb
from pytorch_volumetric_tpu_torch.ops.narrow_band_cuda import narrow_band_query_cuda
from pytorch_volumetric_tpu_torch.utils.profiling import COUNTERS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the closest-point kernel has no CPU mode")
    return torch.device("cuda")


def _scene(device):
    mesh = pt.mesh.icosphere_mesh(0.3, 2).concatenate(
        pt.mesh.box_mesh((0.2, 0.3, 0.1), center=(0.4, 0.0, 0.0)))
    return pt.mesh.MeshScene.from_mesh(mesh, device=device)


def _points(seed, n, device, lo=-0.6, hi=0.8):
    pts = np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)
    return torch.as_tensor(pts, device=device)


@pytest.mark.parametrize("wrapper", [
    mesh_closest_query_cuda, mesh_closest_query_nowind_cuda,
    mesh_closest_query_mma_cuda, mesh_closest_query_contracted_cuda])
def test_wrapper_rejects_other_devices(wrapper):
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(meta, torch.empty((2, 3, 3), device="meta"))


def test_fma_probe_rejects_other_devices():
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fma_probe_cuda(meta, meta, 4)


def _case(name, P, device):
    """``(points, triangles, exterior box)`` of one card case: with and
    without a padding tail, closed and open, points mixing inside and
    outside the box, and a symmetric mesh on a symmetric grid (exact
    ties)."""
    box = pt.mesh.box_mesh((0.4, 0.6, 0.8)).triangles().astype(np.float32)
    if name == "padded":
        tri = _scene(device).tri
        pts = _points(P, P, device)
    elif name == "unpadded":
        tri = torch.as_tensor(pt.mesh.icosphere_mesh(0.3, 2).triangles().astype(np.float32),
                              device=device)
        pts = _points(P, P, device)
    elif name == "open":
        tri = torch.as_tensor(box[1:], device=device)
        pts = _points(P, P, device, -0.8, 0.8)
    elif name == "straddling":
        tri = pt.mesh.MeshScene.from_mesh(pt.mesh.capsule_mesh(0.045, 0.18, 14, 5),
                                          device=device).tri
        pts = torch.as_tensor(np.random.default_rng(P).uniform(
            [-0.06, -0.06, -0.15], [0.06, 0.06, 0.15], (P, 3)).astype(np.float32), device=device)
    else:  # ties
        tri = torch.as_tensor(box, device=device)
        _, grid = pt.get_coordinates_and_points_in_grid(
            0.05, np.array([[-0.5, 0.5]] * 3), device=device)
        pts = grid[:P].contiguous()
    return pts, tri, pt.mesh.exterior_box(tri.cpu().numpy())


CASES = ["padded", "unpadded", "open", "straddling", "ties"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("P", [1, 31, 33, 5000])
def test_kernel_matches_plain_on_card(card, case, P):
    """Distances, closest points and face ids equal the plain version's bit
    for bit (both round every operation the same way, and padding, the
    exterior box and cluster culling skip only what cannot change them);
    the winding sums differ by summation order, and by the plain sum's
    rounding where the kernel writes 0 outside a closed mesh's box."""
    pts, tri, box = _case(case, P, card)
    assert (box is None) == (case == "open")
    before = COUNTERS["kernel.closest_point_sweep"]
    d1, c1, f1, w1 = mesh_closest_query_cuda(pts, tri, exterior_box=box)
    torch.cuda.synchronize()
    assert COUNTERS["kernel.closest_point_sweep"] == before + 1
    d0, c0, f0, w0 = tpt.mesh_closest_query(pts, tri)
    assert torch.equal(d0, d1) and torch.equal(c0, c1) and torch.equal(f0, f1)
    assert (w0.abs() - w1.abs()).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_checks_inputs(card):
    tri = _scene(card).tri
    pts = _points(0, 10, card)
    with pytest.raises(TypeError, match="float32"):
        mesh_closest_query_cuda(pts.double(), tri)
    with pytest.raises(ValueError, match="contiguous"):
        mesh_closest_query_cuda(pts.t().contiguous().t(), tri)
    with pytest.raises(ValueError, match=r"\[P, 3\]"):
        mesh_closest_query_cuda(pts[:, :2].contiguous(), tri)
    with pytest.raises(ValueError, match="same device"):
        mesh_closest_query_cuda(pts, tri.cpu())


@pytest.mark.cuda
def test_mesh_sdf_on_card_matches_cpu(card):
    """The exact SDF with its straight-through gradient, card vs CPU."""
    mesh = pt.mesh.icosphere_mesh(0.2, 2)
    results = []
    for dev in (card, torch.device("cpu")):
        fac = pt.MeshObjectFactory("ball", mesh=mesh, device=dev)
        p = _points(1, 300, dev, -0.4, 0.4).requires_grad_(True)
        v, g = pt.MeshSDF(fac)(p)
        (dp,) = torch.autograd.grad(v.sum(), p)
        results.append([x.detach().cpu() for x in (v, g, dp)])
    for a, b in zip(*results):
        assert (a - b).abs().max().item() <= 1e-5


def _far_points(seed, n, device):
    """Points 0.8-1.2 m from the origin, around a capsule 5 cm across: the
    capsule cache grid's far corner, where the expanded forms cancel most."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d *= rng.uniform(0.8, 1.2, (n, 1)) / np.linalg.norm(d, axis=1, keepdims=True)
    return torch.as_tensor(d.astype(np.float32), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("P", [1, 31, 33, 5000])
def test_nowind_kernel_matches_plain_on_card(card, case, P):
    """The no-winding sweep shares K1's arithmetic and build: distances,
    closest points and face ids bit for bit; the winding is all zeros."""
    pts, tri, _ = _case(case, P, card)
    before = COUNTERS["kernel.closest_point_sweep_nowind"]
    d1, c1, f1, w1 = mesh_closest_query_nowind_cuda(pts, tri)
    torch.cuda.synchronize()
    assert COUNTERS["kernel.closest_point_sweep_nowind"] == before + 1
    d0, c0, f0, _ = tpt.mesh_closest_query(pts, tri, winding=False)
    assert torch.equal(d0, d1) and torch.equal(c0, c1) and torch.equal(f0, f1)
    assert not w1.any()


@pytest.mark.cuda
def test_exterior_box_and_cull_counters_on_capsule_grid(card):
    """The main path's sweep (the capsule's cache-build grid with its
    exterior box): bit-identical to the plain version on a strided subset,
    and to itself without the box; its counters show culled pairs, and
    almost no solid angles with the box but every one without it."""
    grid, cap = sr.capsule_cache_grid(card)
    P, F = grid.shape[0], cap.num_faces
    no_box = torch.zeros(2, dtype=torch.int64, device=card)
    summed = mesh_closest_query_cuda(grid, cap.tri, counters=no_box)
    counters = torch.zeros(2, dtype=torch.int64, device=card)
    out = mesh_closest_query_cuda(grid, cap.tri, exterior_box=cap.exterior_box,
                                  counters=counters)
    for a, b in zip(out[:3], summed[:3]):
        assert torch.equal(a, b)
    closest, winding = counters.tolist()
    assert no_box.tolist() == [closest, P * F]
    assert 0 < closest < 0.6 * P * F and 0 < winding < 0.01 * P * F
    assert (out[3] - summed[3]).abs().max().item() <= 1e-4
    sub = grid[::97].contiguous()
    ref = tpt.mesh_closest_query(sub, cap.tri)
    for a, b in zip([x[::97] for x in out[:3]], ref[:3]):
        assert torch.equal(a, b)
    assert (out[3][::97] - ref[3]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["near", "ragged", "far", "straddling", "mid_padding"])
def test_mma_kernel_matches_plain_on_card(card, case):
    """The tensor-core sweep against the expanded plain version: distance,
    the closest point on the chosen face and the face contract within 1e-5
    (3xTF32 products keep ~21 bits), winding within 1e-3 off the surface;
    with the exterior box where the mesh is closed, and padding between
    real faces."""
    box = None
    if case in ("far", "straddling", "mid_padding"):
        cap = pt.mesh.capsule_mesh(radius=0.045, height=0.18, segments=14, rings=5)
        tri = pt.mesh.MeshScene.from_mesh(cap, device=card).tri
        if case == "far":
            pts = _far_points(3, 4000, card)
        elif case == "straddling":
            pts, tri, box = _case("straddling", 5000, card)
        else:
            pad = torch.full((40, 3, 3), pt.mesh.PAD_COORD, device=card)
            tri = torch.cat([tri[:100], pad, tri[100:]])
            pts = _points(5, 2000, card, -0.3, 0.3)
    else:
        tri = _scene(card).tri
        if case == "ragged":  # F = 13: a tile tail and a group tail
            tri = tri[:13].contiguous()
        pts = _points(7, 3001, card)
    before = COUNTERS["kernel.closest_point_sweep_mma"]
    out = mesh_closest_query_mma_cuda(pts, tri, exterior_box=box)
    torch.cuda.synchronize()
    assert COUNTERS["kernel.closest_point_sweep_mma"] == before + 1
    err = sr.sweep_errors(out, tpt.mesh_closest_query_expanded(pts, tri), pts, tri)
    assert max(err["dist"], err["closest"], err["face"]) <= 1e-5, err
    assert err["winding"] <= 1e-3, err


@pytest.mark.cuda
def test_mma_counters_on_capsule_grid(card):
    """The tensor-core sweep on the main path's grid with the exterior box:
    its counters show culled pairs and almost no solid angles, and without
    the box every solid angle; the results stay within the gates of its
    plain version on a strided subset."""
    grid, cap = sr.capsule_cache_grid(card)
    P, F = grid.shape[0], cap.num_faces
    no_box = torch.zeros(2, dtype=torch.int64, device=card)
    summed = mesh_closest_query_mma_cuda(grid, cap.tri, counters=no_box)
    counters = torch.zeros(2, dtype=torch.int64, device=card)
    out = mesh_closest_query_mma_cuda(grid, cap.tri, exterior_box=cap.exterior_box,
                                      counters=counters)
    closest, winding = counters.tolist()
    assert no_box.tolist() == [closest, P * F]
    assert 0 < closest < 0.6 * P * F and 0 < winding < 0.01 * P * F
    assert (out[3] - summed[3]).abs().max().item() <= 1e-4
    sub = grid[::97].contiguous()
    err = sr.sweep_errors([x[::97] for x in out], tpt.mesh_closest_query_expanded(sub, cap.tri),
                          sub, cap.tri)
    assert sr.check_sweep("mxu", err), err


@pytest.mark.cuda
def test_contracted_build_is_close_on_card(card):
    """K1's source built with contraction: rounding differences only."""
    tri = _scene(card).tri
    pts = _points(11, 2000, card)
    err = sr.sweep_errors(mesh_closest_query_contracted_cuda(pts, tri),
                          tpt.mesh_closest_query(pts, tri), pts, tri)
    assert max(err["dist"], err["closest"], err["face"]) <= 1e-5, err


@pytest.mark.cuda
def test_fma_probe_matches_plain_on_card(card):
    """Fused multiply-adds against a multiply then an add: rtol 1e-5 in a
    recurrence that contracts (|a| < 1), at 1 and 2 iterations before the
    chains settle and at 100; with a = 1 each chain counts its steps, so the
    iteration count is checked too."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0.5, 0.9, 1000).astype(np.float32), device=card)
    y = torch.as_tensor(rng.uniform(0.01, 0.1, 1000).astype(np.float32), device=card)
    inputs = [(x, y, 1), (x, y, 2), (x, y, 100),
              (torch.ones_like(x), torch.full_like(y, 2.0 ** -10), 100)]
    for a, b, iters in inputs:
        before = COUNTERS["kernel.fma_probe"]
        out = fma_probe_cuda(a, b, iters)
        torch.cuda.synchronize()
        assert COUNTERS["kernel.fma_probe"] == before + 1
        ref = fma_probe(a, b, iters)
        assert ((out - ref).abs() / ref.abs()).max().item() <= 1e-5, iters


@pytest.mark.cuda
def test_narrow_band_kernel_matches_plain_on_card(card):
    """Values, gradients and slots equal to the plain version's on every
    case of ``bench.bigmesh.kernel_cases`` (the torus with uniform,
    near-surface, on-surface, out-of-grid and cell-face points, ragged
    counts, dense cells, cells of 31-33 real candidates, NaN and inf
    points, NaN rows, demoted cells, an inverted mesh, duplicated
    faces): the same keys, cascade, winner and sums,
    rounded the same way (``-fmad=false``), NaN at the same places."""
    for name, smalls, big, pts in bigmesh.kernel_cases(card):
        before = COUNTERS["kernel.narrow_band_query"]
        c = bigmesh.compare(smalls, big, pts)
        assert COUNTERS["kernel.narrow_band_query"] == before + 1, name
        assert c["ok"], (name, c.get("first_difference"))


@pytest.mark.cuda
def test_narrow_band_kernel_checks_inputs(card):
    t = tnb.build_narrow_band_tables(pt.mesh.icosphere_mesh(0.2, 1), 0.05, 0.1, device=card)
    pts = _points(0, 10, card, -0.3, 0.3)
    with pytest.raises(TypeError, match="float32"):
        narrow_band_query_cuda(t.smalls, t.big, pts.double())
    with pytest.raises(ValueError, match="contiguous"):
        narrow_band_query_cuda(t.smalls, t.big, pts.t().contiguous().t())
    with pytest.raises(ValueError, match=r"\[P, 3\]"):
        narrow_band_query_cuda(t.smalls, t.big, pts[:, :2].contiguous())
    with pytest.raises(ValueError, match="same device"):
        narrow_band_query_cuda(t.smalls, tnb.NarrowBandBig(*(x.cpu() for x in t.big)), pts)


@pytest.mark.cuda
def test_narrow_band_sdf_on_card_matches_cpu(card):
    """The narrow-band SDF with its straight-through gradient, card (the
    kernel) vs CPU (the plain version)."""
    mesh = pt.mesh.icosphere_mesh(0.2, 2)
    results = []
    for dev in (card, torch.device("cpu")):
        fac = pt.MeshObjectFactory("ball", mesh=mesh, device=dev)
        p = _points(1, 3000, dev, -0.35, 0.35).requires_grad_(True)
        v, g = pt.NarrowBandMeshSDF(fac, cell_res=0.03, band=0.06)(p)
        (dp,) = torch.autograd.grad(v.sum(), p)
        results.append([x.detach().cpu() for x in (v, g, dp)])
    for a, b in zip(*results):
        assert (a - b).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_bf16_product_on_card_matches_plain(card):
    """The neural models' bfloat16 product on the tensor cores (``torch.mm``
    with ``out_dtype=float32``) against its plain version (float32 products
    of the bfloat16-rounded operands), values and the first and second
    derivatives that training takes.  The values are float32 sums of exact
    products (1e-5 of their scale); both derivatives are rounded to
    bfloat16, where another summation order can move an element by a
    rounding step (2^-8 to 2^-7 of it): 1e-2 of their scale."""
    from pytorch_volumetric_tpu_torch.models import neural_sdf as tn
    gen = torch.Generator(device=card).manual_seed(0)
    a = torch.randn((513, 96), generator=gen, device=card).requires_grad_(True)
    b = torch.randn((96, 64), generator=gen, device=card).requires_grad_(True)
    outs = []
    for fn in (tn._bf16_product, tn._bf16_product_plain):
        y = fn(a, b)
        (da,) = torch.autograd.grad(torch.sin(y).sum(), a, create_graph=True)
        (db,) = torch.autograd.grad((da ** 2).sum(), b)
        outs.append((y.detach(), da.detach(), db))
    for (x, ref), rel in zip(zip(*outs), (1e-5, 1e-2, 1e-2)):
        scale = ref.abs().max().item()
        assert (x - ref).abs().max().item() <= rel * scale


@pytest.mark.cuda
def test_neural_model_on_card_matches_cpu(card):
    """A ``ConfigSpaceNeuralSDF`` query (values, per-configuration spatial
    gradients, d/dq) on the card against the same weights on the CPU."""
    from pytorch_volumetric_tpu_torch.models import neural_sdf as tn
    results = []
    for dev in (card, torch.device("cpu")):
        params = tn.mlp_init(0, 7 + 32, 64, 4, device="cpu")
        model = pt.ConfigSpaceNeuralSDF(
            [(W.detach().to(dev), b.detach().to(dev)) for W, b in params],
            torch.linspace(-3, 3, 48).reshape(3, 16), -torch.ones(7), torch.ones(7),
            [[-1.0, 1.0]] * 3, device=dev)
        q = torch.linspace(-0.9, 0.9, 21, device=dev).reshape(3, 7).requires_grad_(True)
        p = _points(2, 500, dev, -0.5, 0.5)
        v, g = model.query(q, p)
        (dq,) = torch.autograd.grad(v.sum() + g.sum(), q)
        results.append([x.detach().cpu() for x in (v, g, dq)])
    for (a, b), tol in zip(zip(*results), (1e-4, 1e-3, 1e-3)):
        assert (a - b).abs().max().item() <= tol * max(b.abs().max().item(), 1.0)


@pytest.mark.cuda
def test_kernel_ops_fake_shapes_match_card(card):
    """The two kernels' registered ops: their fake implementations give the
    shapes, dtypes and devices of the kernels' real outputs on the card
    (``torch.library.opcheck``), with and without slots."""
    from pytorch_volumetric_tpu_torch.ops.closest_point import closest_point_sweep
    from pytorch_volumetric_tpu_torch.ops.narrow_band_cuda import (
        grid_lists, narrow_band_query_op)
    checks = ("test_schema", "test_faketensor")
    scene = _scene(card)
    pts = _points(3, 777, card)
    box = None if scene.exterior_box is None else scene.exterior_box.reshape(-1).tolist()
    torch.library.opcheck(closest_point_sweep, (pts, scene.tri, box, 2048, 512),
                          test_utils=checks)
    t = tnb.build_narrow_band_tables(pt.mesh.icosphere_mesh(0.2, 2), 0.03, 0.06, device=card)
    grid_f, grid_i = grid_lists(t.smalls)
    for with_slots in (False, True):
        torch.library.opcheck(narrow_band_query_op, (pts, *t.big, grid_f, grid_i, 1e-3,
                                                     with_slots), test_utils=checks)


@pytest.mark.cuda
def test_served_exact_query_launches_k1(card, tmp_path):
    """An exact-link arm exported on the card and loaded there: one served
    query launches K1 once per link, and equals the live query in values,
    gradients and d/dq."""
    from pytorch_volumetric_tpu_torch.utils import robots, serving
    urdf, end = robots.make_serial_arm(str(tmp_path), num_joints=3, segments=8, rings=3)
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(open(urdf).read(), end, device=card),
                        path_prefix=str(tmp_path))
    path = str(tmp_path / "exact.pt2")
    serving.export_robot_query(robot, 3, 500, path)
    query = serving.load_robot_query(path)
    rng = np.random.default_rng(4)
    q = torch.as_tensor(rng.uniform(-1, 1, (3, 3)).astype(np.float32), device=card)
    pts = _points(5, 500, card, -0.3, 0.6)
    query(q, pts)
    torch.cuda.synchronize()
    before = COUNTERS["kernel.closest_point_sweep"]
    query(q, pts)
    torch.cuda.synchronize()
    assert COUNTERS["kernel.closest_point_sweep"] == before + len(robot.sdf.sdfs)
    outs = []
    for fn in (query, robot.query):
        qq = q.clone().requires_grad_(True)
        v, g = fn(qq, pts)
        (dq,) = torch.autograd.grad(v.sum() + g.sum(), qq)
        outs.append((v.detach(), g.detach(), dq))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_labelled_sweep_still_counts(card, tmp_path, monkeypatch):
    """An exact-link arm queried with K1's wrapper replaced by a labelled one,
    as a profiler's labels replace it: one launch a link counted under its
    key, and one ``path.link_exact`` a link."""
    import functools
    from pytorch_volumetric_tpu_torch.ops import closest_point
    from pytorch_volumetric_tpu_torch.utils import robots
    original = closest_point.mesh_closest_query_cuda

    @functools.wraps(original)
    def labelled(*args, **kwargs):
        with torch.profiler.record_function("ops.closest_point.mesh_closest_query_cuda"):
            return original(*args, **kwargs)

    monkeypatch.setattr(closest_point, "mesh_closest_query_cuda", labelled)
    urdf, end = robots.make_serial_arm(str(tmp_path), num_joints=3, segments=8, rings=3)
    robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(open(urdf).read(), end, device=card),
                        path_prefix=str(tmp_path))
    q = torch.zeros((2, 3), device=card)
    before = COUNTERS.copy()
    robot.query(q, _points(6, 500, card, -0.3, 0.6))
    torch.cuda.synchronize()
    counted = COUNTERS - before
    L = len(robot.sdf.sdfs)
    assert counted["kernel.closest_point_sweep"] == counted["path.link_exact"] == L


def _union_case(device, C, seg, tmp_path, n_configs=3, n_tiles=64, route="tile_union",
                radius=0.012):
    """The per-tile union's inputs: ``C`` cached spheres (radius 0.02,
    0.04 voxels) centred on a circle of ``radius`` (0.012), with the tables
    of the brick ``route`` (the nearest union's, or ``"trilinear_union"``'s
    on trilinear caches); one world point set of tiles
    within 0.05 of its centre (every ninth one spread over 0.1: it breaks
    the contract and its offsets clamp), points NaN or +-inf in one or all
    coordinates; ``T``: each sphere's frame after a random rotation about
    the centre and a shift of up to 0.003, one for each configuration;
    random rotations ``Rb``.  Returns ``(tables, points, T, Rb)``."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    rng = np.random.default_rng(C * 100 + seg)
    interp = "trilinear" if route == "trilinear_union" else "nearest"
    tables = tuple(pt.CachedSDF(f"u{i}", 0.04, np.array([[-0.5, 0.5]] * 3),
                                pt.SphereSDF(0.02, device=device), interpolation=interp,
                                cache_path=str(tmp_path / f"union_{interp}.npz"))._coherent_tables(
        **tsdf._ROUTE_BRICKS[route][0]) for i in range(C))
    ang = 2 * np.pi * np.arange(C) / C + 0.3
    shift = np.stack([radius * np.cos(ang), radius * np.sin(ang), np.zeros(C)], 1)
    spread = np.where(np.arange(n_tiles) % 9 == 8, 0.1, 0.01)[:, None, None]
    obj = rng.uniform(-0.05, 0.05, (n_tiles, 1, 3)) + rng.uniform(
        -1, 1, (n_tiles, seg, 3)) * spread
    flat = obj.reshape(-1, 3)
    for j, k in enumerate(rng.choice(len(flat), size=max(3, len(flat) // 40), replace=False)):
        flat[k, j % 3] = (np.nan, np.inf, -np.inf)[j % 3]
        if j % 5 == 0:
            flat[k] = np.nan

    def rotations(shape):
        R, r = np.linalg.qr(rng.normal(size=shape + (3, 3)))
        return R * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]

    T = np.tile(np.eye(4), (C, n_configs, 1, 1))
    T[..., :3, :3] = rotations((n_configs,))[None]
    T[..., :3, 3] = rng.uniform(-0.003, 0.003, (C, n_configs, 3)) - shift[:, None]
    return tables, *(torch.as_tensor(x.astype(np.float32), device=device)
                     for x in (flat, T, rotations((C, n_configs))))


def _same_bits(a, b):
    """Equal bit for bit, every NaN taken as one pattern."""
    nan = torch.isnan(a) if a.is_floating_point() else torch.zeros_like(a, dtype=torch.bool)
    if not torch.equal(nan, torch.isnan(b) if b.is_floating_point() else nan):
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("seg", [1, 12, 27, 32, 64])
def test_coherent_union_kernel_matches_plain_on_card(card, tmp_path, C, seg):
    """The union kernel (``csrc/coherent_union.cu``), which forms each
    link-frame point from the world points and ``T`` in registers, against
    its plain version (``sdf._union_tile_eval``, ``sdf._union_values_eval``
    on ``transforms.transform_points(T, points)``) on the card: ``val``,
    ``g_obj``, ``win``, ``g_link`` and the values-only ``val`` bit for bit,
    at the default residual fraction and at 1e-9, one launch a call."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from pytorch_volumetric_tpu_torch.ops.coherent_union import coherent_union_tile
    tables, points, T, Rb = _union_case(card, C, seg, tmp_path)
    pts_c = tsdf._link_points(T, points, seg)
    assert torch.isnan(pts_c).any() and torch.isinf(pts_c).any()
    for frac in (tsdf.RESIDUAL_FRAC, 1e-9):
        cap = tsdf.residual_capacity(pts_c.shape[1] * pts_c.shape[2], frac)
        before = COUNTERS["kernel.coherent_union_tile"]
        out = coherent_union_tile(tables, points, T, seg, Rb, cap)
        vo = coherent_union_tile(tables, points, T, seg, values_only=True)
        torch.cuda.synchronize()
        assert COUNTERS["kernel.coherent_union_tile"] == before + 2
        ref = tsdf._union_tile_eval(tables, cap, pts_c, Rb)
        for name, a, b in zip(("val", "g_obj", "win", "g_link"), out, ref):
            assert _same_bits(a, b), (name, frac)
        assert _same_bits(vo, tsdf._union_values_eval(tables, pts_c)), frac
        if C > 3 and seg > 3 and frac < 1e-6:  # the lane overflows
            assert torch.isnan(out[3][torch.isfinite(pts_c).all(-1).all(0)]).any()


@pytest.mark.cuda
def test_coherent_union_checks_inputs(card, tmp_path):
    from pytorch_volumetric_tpu_torch.ops.coherent_union import coherent_union_tile
    tables, points, T, Rb = _union_case(card, 4, 12, tmp_path, n_tiles=4)
    with pytest.raises(TypeError, match="float32"):
        coherent_union_tile(tables, points, T.double(), 12, Rb, 32)
    with pytest.raises(TypeError, match="Rb must be float32"):
        coherent_union_tile(tables, points, T, 12, Rb.double(), 32)
    with pytest.raises(ValueError, match=r"T must be \[C, B, 4, 4\]"):
        coherent_union_tile(tables, points, T[..., :3, :], 12, Rb, 32)
    with pytest.raises(ValueError, match="Rb must be"):
        coherent_union_tile(tables, points, T[:, :1], 12, Rb, 32)
    with pytest.raises(ValueError, match="tensors for 3 children"):
        coherent_union_tile(tables, points, T[:3], 12, Rb[:3], 32)
    with pytest.raises(ValueError, match="multiple of seg=5"):
        coherent_union_tile(tables, points, T, 5, Rb, 32)
    with pytest.raises(ValueError, match="T lies on cpu"):
        coherent_union_tile(tables, points, T.cpu(), 12, Rb, 32)
    with pytest.raises(ValueError, match="Rb lies on cpu"):
        coherent_union_tile(tables, points, T, 12, Rb.cpu(), 32)
    cpu_tables = tuple(t._replace(vg=t.vg.cpu()) for t in tables)
    with pytest.raises(ValueError, match="lies on cpu"):
        coherent_union_tile(cpu_tables, points, T, 12, Rb, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("seg", [1, 4, 12, 27, 32, 64])
def test_coherent_union_tri_kernel_matches_plain_on_card(card, tmp_path, C, seg):
    """CU-T (``csrc/coherent_union_tri.cu``), which forms each link-frame
    point from the world points and ``T`` in registers and lerps each
    child's 5x5x5 brick rows there, against its plain version
    (``sdf._union_tile_tri_eval``, ``sdf._union_values_tri_eval`` on
    ``transforms.transform_points(T, points)``) on the card: ``val``,
    ``g_obj``, ``win``, ``g_link`` and the values-only ``val`` bit for bit,
    at the default residual fraction and at 1e-9, one launch a call."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from pytorch_volumetric_tpu_torch.ops.coherent_union_tri import coherent_union_tile_tri
    tables, points, T, Rb = _union_case(card, C, seg, tmp_path, route="trilinear_union",
                                        radius=0.03)
    pts_c = tsdf._link_points(T, points, seg)
    assert torch.isnan(pts_c).any() and torch.isinf(pts_c).any()
    for frac in (tsdf.RESIDUAL_FRAC, 1e-9):
        cap = tsdf.residual_capacity(pts_c.shape[1] * pts_c.shape[2], frac)
        before = COUNTERS["kernel.coherent_union_tile_tri"]
        out = coherent_union_tile_tri(tables, points, T, seg, Rb, cap)
        vo = coherent_union_tile_tri(tables, points, T, seg, values_only=True)
        torch.cuda.synchronize()
        assert COUNTERS["kernel.coherent_union_tile_tri"] == before + 2
        ref = tsdf._union_tile_tri_eval(tables, cap, pts_c, Rb)
        for name, a, b in zip(("val", "g_obj", "win", "g_link"), out, ref):
            assert _same_bits(a, b), (name, frac)
        assert _same_bits(vo, tsdf._union_values_tri_eval(tables, pts_c)), frac
        # the lane overflows (the smooth field's 4-point tiles here hold no
        # four winners)
        if C > 3 and seg > 4 and frac < 1e-6:
            assert torch.isnan(out[3][torch.isfinite(pts_c).all(-1).all(0)]).any()


@pytest.mark.cuda
def test_coherent_union_tri_checks_inputs(card, tmp_path):
    from pytorch_volumetric_tpu_torch.ops import coherent_union_tri as cut
    tables, points, T, Rb = _union_case(card, 4, 12, tmp_path, n_tiles=4,
                                        route="trilinear_union")
    with pytest.raises(TypeError, match="float32"):
        cut.coherent_union_tile_tri(tables, points, T.double(), 12, Rb, 32)
    with pytest.raises(ValueError, match="Rb must be"):
        cut.coherent_union_tile_tri(tables, points, T[:, :1], 12, Rb, 32)
    with pytest.raises(ValueError, match="tensors for 3 children"):
        cut.coherent_union_tile_tri(tables, points, T[:3], 12, Rb[:3], 32)
    with pytest.raises(ValueError, match="T lies on cpu"):
        cut.coherent_union_tile_tri(tables, points, T.cpu(), 12, Rb, 32)
    with pytest.raises(ValueError, match="tables lack tgbricks"):
        cut.coherent_union_tile_tri(tuple(t._replace(tgbricks=None) for t in tables), points,
                                    T, 12, Rb, 32)
    cpu_tables = tuple(t._replace(tbricks=t.tbricks.cpu()) for t in tables)
    with pytest.raises(ValueError, match="lies on cpu"):
        cut.coherent_union_tile_tri(cpu_tables, points, T, 12, Rb, 32)
    for values_only in (False, True):
        torch.library.opcheck(
            cut.coherent_union_tile_tri_op,
            (points, T, Rb if not values_only else points.new_empty(0),
             *cut.op_args(tables, values_only), 12, 32, values_only),
            test_utils=("test_schema", "test_faketensor"))


@pytest.mark.cuda
def test_coherent_union_op_fake_shapes_match_card(card, tmp_path):
    from pytorch_volumetric_tpu_torch.ops import coherent_union as cu
    tables, points, T, Rb = _union_case(card, 4, 27, tmp_path, n_tiles=8)
    for values_only in (False, True):
        torch.library.opcheck(
            cu.coherent_union_tile_op,
            (points, T, Rb if not values_only else points.new_empty(0),
             *cu.op_args(tables, values_only), 27, 32, values_only),
            test_utils=("test_schema", "test_faketensor"))


def _backward_case(device, B, N, C, seed, plant):
    """The tile union backward's inputs at ``B`` configurations x ``N``
    points of ``C`` children: winners in runs of ~1,000 points (as a
    coherent grid's are), every tenth point's drawn at random, gradients,
    cotangents and points N(0, 1), and NaN, +inf and -inf planted in each
    of g_link, ct_val and ct_g at configuration 0 (``plant="b0"``), or in
    the points (``"points"``: every configuration's)."""
    rng = np.random.default_rng(seed)
    win = (np.arange(N)[None] // 1000 + np.arange(B)[:, None]) % C
    scatter = rng.random((B, N)) < 0.1
    win[scatter] = rng.integers(0, C, int(scatter.sum()))
    g_link, ct_g = (rng.normal(size=(B, N, 3)).astype(np.float32) for _ in range(2))
    ct_val = rng.normal(size=(B, N)).astype(np.float32)
    points = rng.normal(size=(N, 3)).astype(np.float32)
    for a in ((g_link[0], ct_val[0], ct_g[0]) if plant == "b0" else (points,)):
        flat = a.reshape(-1)
        for k, x in zip(rng.choice(flat.size, 3, replace=False), (np.nan, np.inf, -np.inf)):
            flat[k] = x
    return tuple(torch.as_tensor(a, device=device) for a in (win, g_link, ct_val, ct_g, points))


@pytest.mark.cuda
@pytest.mark.parametrize("plant", ["b0", "points"])
@pytest.mark.parametrize("B, N", [(200, 15_504), (25, 1_061_208)])
def test_tile_union_backward_kernel_matches_plain_on_card(card, B, N, plant):
    """The tile union's backward kernels (``csrc/coherent_union.cu``) at
    the headline (200 x 15,504) and north-star chunk (25 x 1,061,208)
    shapes against the plain version in float64: NaN and +-inf where it
    has them, else within 2e-5 of the terms' absolute sum (each term sees
    at most ~120 float32 additions on its way, 120 * 2^-24 = 7.2e-6, plus
    two roundings of its product); two calls equal bit for bit; one launch
    counted a call."""
    from pytorch_volumetric_tpu_torch.ops import coherent_union as cu
    C = 8
    win, g_link, ct_val, ct_g, points = _backward_case(card, B, N, C, B, plant)
    before = COUNTERS["kernel.tile_union_backward"]
    out = cu.tile_union_cotangents(win, g_link, ct_val, ct_g, points, C)
    again = cu.tile_union_cotangents(win, g_link, ct_val, ct_g, points, C)
    torch.cuda.synchronize()
    assert COUNTERS["kernel.tile_union_backward"] == before + 2
    f64 = [t.double() for t in (g_link, ct_val, ct_g, points)]
    ref = cu.tile_union_cotangents_plain(win, *f64, C)
    mag = cu.tile_union_cotangents_plain(win, *(t.abs() for t in f64), C)
    for name, a, b, r, m in zip(("d_T", "d_Rb"), out, again, ref, mag):
        assert _same_bits(a, b), name
        a = a.double()
        assert torch.equal(torch.isnan(a), torch.isnan(r)), name
        inf = torch.isinf(r)
        assert torch.equal(a[inf], r[inf]), name
        ok = ~torch.isnan(r) & ~inf
        assert ok.any(), name
        assert ((a[ok] - r[ok]).abs() <= 2e-5 * m[ok]).all(), name
    assert torch.isnan(ref[0]).any()


@pytest.mark.cuda
def test_tile_union_backward_one_launch_a_differentiated_call(card, tmp_path, monkeypatch):
    """A differentiated coherent query over a union of four cached spheres
    launches the backward kernels once, and its d/d obj_to_link equals the
    plain version's within 2e-5 of the largest entry (float32 sums in
    other orders)."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from pytorch_volumetric_tpu_torch import transforms as tfm
    from pytorch_volumetric_tpu_torch.ops import coherent_union as cu
    from pytorch_volumetric_tpu_torch.ops import straight_through as st
    C, B = 4, 3
    children = [pt.CachedSDF(f"u{i}", 0.04, np.array([[-0.5, 0.5]] * 3),
                             pt.SphereSDF(0.02, device=card),
                             cache_path=str(tmp_path / "union.npz")) for i in range(C)]
    pts, _, seg = pt.get_coherent_tile_points(0.02, np.array([[-0.12, 0.12]] * 3),
                                              cache_resolution=0.04, device=card)
    rng = np.random.default_rng(3)
    m = np.tile(np.eye(4, dtype=np.float32), (C * B, 1, 1))
    ang = 2 * np.pi * np.repeat(np.arange(C), B) / C
    m[:, 0, 3], m[:, 1, 3] = 0.03 * np.cos(ang), 0.03 * np.sin(ang)
    m[:, :3, 3] += rng.normal(scale=0.005, size=(C * B, 3))
    m = torch.as_tensor(m, device=card).requires_grad_()

    def d_m():
        v, g = tsdf.compose_query_coherent(children, m, tfm.invert_tf(m), B, pts, seg=seg)
        return torch.autograd.grad(v.sum() + g.sum(), m)[0]

    before = COUNTERS["kernel.tile_union_backward"]
    got = d_m()
    torch.cuda.synchronize()
    assert COUNTERS["kernel.tile_union_backward"] == before + 1
    monkeypatch.setattr(st, "tile_union_cotangents", cu.tile_union_cotangents_plain)
    want = d_m()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-5 * want.abs().max()
