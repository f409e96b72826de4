"""The roofline probe's plain versions against the JAX package on the same
inputs (CPU): the sweep without winding and the expanded (tensor-core)
sweep against JAX's XLA ``mesh_closest_query``, the multiply-add probe
against a ``jax.numpy`` transcription of ``benchmarks/pallas_mfu.py``'s
``fma_kernel``, the procedural meshes, the profiling helpers and the
probe's CPU-side arithmetic.  The kernels themselves run only on the card
(``test_torch_cuda.py``).  The JAX probe kernel of ``pallas_mxu_ab.py``
has no interpret mode and is compared through the XLA sweep, as that probe
checks itself."""

import os

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
from pytorch_volumetric_tpu_torch.ops.closest_point import (
    LAUNCHES, mesh_closest_query_contracted_cuda, mesh_closest_query_mma_cuda,
    mesh_closest_query_nowind_cuda)
from pytorch_volumetric_tpu_torch.ops.fma_probe import fma_probe, fma_probe_cuda, flops
from pytorch_volumetric_tpu_torch.utils import profiling
from torch_cpu_guard import warm_sqrt

warm_sqrt()

CPU = torch.device("cpu")


def _cases():
    """(name, triangles [F, 3, 3], points [P, 3]) float32: a small torus with
    points around it, the arm's capsule link (edges 2-5 cm) with points
    0.8-1.2 m away, where the expanded forms cancel most, and the capsule
    with points within 1 cm of its box, near the surface, where the solid
    angle is most sensitive."""
    rng = np.random.default_rng(0)
    torus = tm.torus_mesh(0.1, 0.03, 24, 12).triangles().astype(np.float32)
    near = rng.uniform(-0.2, 0.2, (800, 3)).astype(np.float32)
    cap = tm.capsule_mesh(radius=0.045, height=0.18, segments=14, rings=5)
    far = rng.normal(size=(800, 3))
    far *= rng.uniform(0.8, 1.2, (800, 1)) / np.linalg.norm(far, axis=1, keepdims=True)
    bb = cap.aabb()
    band = rng.uniform(bb[:, 0] - 0.01, bb[:, 1] + 0.01, (800, 3)).astype(np.float32)
    cap_tri = cap.triangles().astype(np.float32)
    return [("torus", torus, near),
            ("capsule, far points", cap_tri, far.astype(np.float32)),
            ("capsule, points straddling its box", cap_tri, band)]


@pytest.fixture(scope="module", params=_cases(), ids=lambda c: c[0])
def case(request):
    _, tri, pts = request.param
    ref = [np.asarray(x) for x in jpt.mesh_closest_query(jnp.asarray(pts), jnp.asarray(tri))]
    return torch.as_tensor(tri), torch.as_tensor(pts), ref


def _check_against_xla(out, tri, pts, ref, winding_tol):
    """Distance within 1e-5; the closest point within 1e-5 of the true
    closest point on the chosen face, and that face within 1e-5 of the
    minimal distance (equidistant faces may be chosen either way);
    winding within ``winding_tol`` where checked, at points farther than
    ``sweep_roofline.WIND_MIN_DIST`` from the surface (on a face the solid
    angle is +-2 pi or 0 by rounding)."""
    d, c, f, w = out
    d_ref, _, _, w_ref = ref
    assert np.abs(d.numpy() - d_ref).max() <= 1e-5
    chosen = tri[f.long()]
    d2, cp = tpt._closest_point_bary(pts[:, None], chosen[:, None, 0],
                                     (chosen[:, 1] - chosen[:, 0])[:, None],
                                     (chosen[:, 2] - chosen[:, 0])[:, None])
    assert (c - cp[:, 0]).abs().max().item() <= 1e-5
    assert np.abs(np.sqrt(d2[:, 0].numpy()) - d_ref).max() <= 1e-5
    if winding_tol is not None:
        off = d_ref > sr.WIND_MIN_DIST
        assert np.abs(w.numpy() - w_ref)[off].max() <= winding_tol


def test_nowind_plain_matches_xla(case):
    tri, pts, ref = case
    out = tpt.mesh_closest_query(pts, tri, winding=False, tri_chunk=128)
    _check_against_xla(out, tri, pts, ref, None)
    assert not out[3].any()


def test_expanded_plain_matches_xla(case):
    """The tensor-core kernel's arithmetic: winding within 1e-3 (the JAX
    probe's own gate; the groups' frames and the direct solid angle near a
    group keep it near 1e-5 here, straddling points included)."""
    tri, pts, ref = case
    out = tpt.mesh_closest_query_expanded(pts, tri, tri_chunk=100)
    _check_against_xla(out, tri, pts, ref, 1e-3)


@pytest.mark.parametrize("tri_chunk", [8, 36, 512])
def test_expanded_plain_independent_of_chunking(tri_chunk):
    """The expanded sweep's frames and boxes are the kernel's groups,
    formed once for the whole mesh, whatever the tile size: every chunking
    gives the same distances, closest points and faces bit for bit (the
    winding sum only by summation order)."""
    tri = torch.as_tensor(tm.torus_mesh(0.1, 0.03, 12, 8).triangles().astype(np.float32))
    pts = torch.as_tensor(np.random.default_rng(1).uniform(-0.2, 0.2, (300, 3))
                          .astype(np.float32))
    base = tpt.mesh_closest_query_expanded(pts, tri, tri_chunk=64)
    out = tpt.mesh_closest_query_expanded(pts, tri, tri_chunk=tri_chunk, point_chunk=77)
    for a, b in zip(base[:3], out[:3]):
        assert torch.equal(a, b)
    assert (base[3] - out[3]).abs().max().item() <= 1e-6


def test_wrappers_run_plain_versions_on_cpu():
    tri = torch.as_tensor(tm.wrench_mesh().triangles().astype(np.float32))
    pts = torch.as_tensor(np.random.default_rng(2).uniform(-0.1, 0.1, (200, 3))
                          .astype(np.float32))
    pairs = [(mesh_closest_query_nowind_cuda, lambda p, t: tpt.mesh_closest_query(
                 p, t, winding=False)),
             (mesh_closest_query_mma_cuda, tpt.mesh_closest_query_expanded),
             (mesh_closest_query_contracted_cuda, tpt.mesh_closest_query)]
    for wrapper, plain in pairs:
        before = profiling.COUNTERS[LAUNCHES[wrapper]]
        for a, b in zip(wrapper(pts, tri), plain(pts, tri)):
            assert torch.equal(a, b)
        assert profiling.COUNTERS[LAUNCHES[wrapper]] == before


@pytest.mark.parametrize("where", ["none", "tail", "middle", "head"])
def test_mma_takes_padding_anywhere(where):
    """The tensor-core sweep's frames are centred on real faces, so
    ``PAD_COORD`` rows anywhere leave its plain version (the wrapper on CPU
    tensors) within 1e-5 in distance and 1e-3 in winding of JAX's XLA
    sweep."""
    tri = torch.as_tensor(tm.torus_mesh(0.1, 0.03, 8, 6).triangles().astype(np.float32))
    pad = torch.full((5, 3, 3), tm.PAD_COORD)
    tri = {"none": tri, "tail": torch.cat([tri, pad]),
           "middle": torch.cat([tri[:40], pad, tri[40:]]), "head": torch.cat([pad, tri])}[where]
    pts = torch.as_tensor(np.random.default_rng(3).uniform(-0.2, 0.2, (100, 3))
                          .astype(np.float32))
    out = mesh_closest_query_mma_cuda(pts, tri)
    for a, b in zip(out, tpt.mesh_closest_query_expanded(pts, tri)):
        assert torch.equal(a, b)
    ref = [np.asarray(x) for x in jpt.mesh_closest_query(jnp.asarray(pts.numpy()),
                                                           jnp.asarray(tri.numpy()))]
    _check_against_xla(out, tri, pts, ref, 1e-3)


def test_expanded_products_equal_direct_forms():
    """The homogeneous products (``expanded_columns`` against the row
    ``(q, 1, |q|^2)``) give d1..d6, the squared corner distances and the
    solid angle's numerator of the direct forms, within float32 rounding of
    the terms they sum (points and corners of a few cm to 1 m)."""
    rng = np.random.default_rng(7)
    tri = torch.as_tensor(rng.uniform(-0.05, 0.05, (64, 3, 3)).astype(np.float32))
    q = torch.as_tensor((rng.normal(size=(96, 3)) * rng.uniform(0.01, 1.0, (96, 1)))
                        .astype(np.float32))[:, None]
    a, b, c = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
    m = tpt._products(q.expand(-1, 64, -1), tpt._dot(q, q).expand(-1, 64),
                      tpt.expanded_columns(a, b, c))
    ab, ac = b - a, c - a
    ab2, ac2, abac = tpt._dot(ab, ab), tpt._dot(ac, ac), tpt._dot(ab, ac)
    # the direct forms in float64
    a, b, c, qd = a.double(), b.double(), c.double(), q.double()
    ab, ac = b - a, c - a
    ap, bp, cp = qd - a, qd - b, qd - c
    direct = torch.stack([tpt._dot(ab, ap), tpt._dot(ac, ap), tpt._dot(ab, bp),
                          tpt._dot(ac, bp), tpt._dot(ab, cp), tpt._dot(ac, cp),
                          tpt._dot(ap, ap), tpt._dot(bp, bp), tpt._dot(cp, cp),
                          tpt._dot(-ap, tpt._cross(-bp, -cp))], dim=-1)
    d1, d2 = m[..., 0], m[..., 1]
    folded = torch.stack([d1, d2, d1 - ab2, d2 - abac, d1 - abac, d2 - ac2,
                          m[..., 3], m[..., 4], m[..., 5], m[..., 2]], dim=-1).double()
    # the size of the terms summed: |q| |v| for the products, |q|^2 and the
    # corners' squares for the distances, |q| |n| + |a| |b| |c| for the
    # numerator
    qn = q.double().norm(dim=-1)
    t = tri.double().norm(dim=-1).max(dim=-1).values[None]
    scale = torch.stack([(qn + t) * t] * 6 + [(qn + t) ** 2] * 3
                        + [(qn + t) * t * t], dim=-1)
    assert ((folded - direct).abs() / scale).max().item() <= 8 * 2.0 ** -24


def _fma_jax(x, y, iters):
    """``benchmarks/pallas_mfu.py`` ``fma_kernel`` (lines 65-79) in
    ``jax.numpy``: 8 chains, ``iters`` x 4 rounds of ``acc * a + b``."""
    a, b = jnp.asarray(x), jnp.asarray(y)
    accs = tuple(a * (0.1 * (i + 1)) for i in range(8))
    for _ in range(iters):
        for _ in range(4):
            accs = tuple(acc * a + b for acc in accs)
    out = accs[0]
    for acc in accs[1:]:
        out = out + acc
    return np.asarray(out)


@pytest.mark.parametrize("iters", [1, 3, 17])
def test_fma_probe_plain_matches_jax(iters):
    """rtol 1e-5: both round after each multiply and each add, so they
    agree to float32 rounding (XLA may fuse on the CPU)."""
    rng = np.random.default_rng(iters)
    x = rng.uniform(0.5, 0.9, 1024).astype(np.float32)
    y = rng.uniform(0.01, 0.1, 1024).astype(np.float32)
    out = fma_probe_cuda(torch.as_tensor(x), torch.as_tensor(y), iters)
    np.testing.assert_allclose(out.numpy(), _fma_jax(x, y, iters), rtol=1e-5)
    assert flops(1024, iters) == 2 * 32 * iters * 1024


@pytest.mark.parametrize("name, args", [
    ("torus_mesh", ()), ("torus_mesh", (0.1, 0.03, 128, 64)), ("torus_mesh", (2.0, 0.5, 7, 5)),
    ("wrench_mesh", ())])
def test_procedural_meshes_identical(name, args):
    a, b = getattr(jm, name)(*args), getattr(tm, name)(*args)
    assert np.array_equal(a.vertices, b.vertices) and a.vertices.dtype == b.vertices.dtype
    assert np.array_equal(a.faces, b.faces) and a.faces.dtype == b.faces.dtype


def test_probe_torus_is_the_stated_size():
    pts, scene = sr.torus_inputs(CPU, 64)
    assert scene.num_faces == 16384 and scene.tri.shape[0] == 16384
    assert pts.shape == (64, 3) and pts.abs().max().item() <= 0.2


def test_probe_bounds_and_gates():
    ms, by = sr.sweep_bound_ms(1_267_875, 280)
    assert by == "operations"
    assert ms == pytest.approx(1_267_875 * 280 * 110 / 67e12 * 1e3)
    ms, by = sr.fma_bound_ms(1000, 0)
    assert by == "bytes" and ms == pytest.approx(12_000 / 3.35e12 * 1e3)
    ok = {"dist": 1e-6, "closest": 1e-6, "face": 1e-6, "winding": 2e-3}
    assert sr.check_sweep("nowind", ok) and not sr.check_sweep("mxu", ok)
    # the mxu bound over evaluated pairs: FP32 lanes and tensor cores
    ms, by = sr.evaluated_bound_ms(1000, 10, 10 ** 8, 0, "mxu")
    assert by == "operations"
    assert ms == pytest.approx(10 ** 8 * sr.MXU_CLOSEST_OPS[0] / 67e12 * 1e3)
    assert sr.evaluated_bound_ms(1000, 10, 10 ** 8, 0, "base")[0] > ms
    assert not sr.check_sweep("base", dict(ok, winding=0.0, closest=2e-5))


def test_clock_summary_parses_nvidia_smi_samples():
    out = sr.clock_summary("1980, 356.10\n1755, 300.2\n[N/A], [N/A]\n1980, 120.0\n")
    assert out == {"samples": 3, "sm_mhz_min": 1755.0, "sm_mhz_median": 1980.0,
                   "sm_mhz_max": 1980.0, "power_w_max": 356.1}
    assert sr.clock_summary("") == {"samples": 0}


def test_probe_runs_plain_versions_on_cpu():
    """The probe's timing loop on CPU tensors (plain versions): each sweep
    is checked, timed and within its gates."""
    pts, _ = sr.torus_inputs(CPU, 64)
    scene = tm.MeshScene.from_mesh(tm.torus_mesh(0.1, 0.03, 16, 8), device=CPU)
    res = sr.time_sweeps(pts, scene, reps=1, check_points=16, plain_reps=1,
                         fp32_ceiling=1e12)
    assert set(res) == {"base", "nowind", "mxu", "base_fmad"}
    for name, r in res.items():
        assert r["ms"] > 0 and r["plain_ms"] > 0 and "share_of_measured_ceiling" in r
        assert r["ok"] is (True if r["gated"] else None), (name, r["errors"])
    fma = sr.measure_fma(CPU, iters=2, reps=1, n=256)
    assert fma["ok"] and fma["max_rel_err"] == 0.0


def test_fma_check_catches_skipped_iterations(monkeypatch):
    """A probe kernel that runs fewer iterations than it is asked for agrees
    with the plain version on the probe's own inputs once the chains have
    settled, but not on the step-counting input: the check fails it."""
    def short(x, y, iters):
        return fma_probe(x, y, iters - 1 if iters > 2 else iters)

    fma = sr.measure_fma(CPU, iters=40, reps=1, n=64)
    assert fma["ok"]
    monkeypatch.setattr(sr, "fma_probe_cuda", short)
    assert fma_probe(*[torch.full((64,), v) for v in (0.7, 0.05)], 40).allclose(
        short(*[torch.full((64,), v) for v in (0.7, 0.05)], 40), rtol=1e-5)
    assert not sr.measure_fma(CPU, iters=40, reps=1, n=64)["ok"]


def test_library_flags_are_hashed():
    """Each library carries its own -fmad setting, and the flags are part
    of its name: the contracted build of the sweep is a separate library."""
    for name, (source, flags) in cuda_build.SOURCES.items():
        assert os.path.exists(os.path.join(cuda_build.CSRC_DIR, source)), name
        assert sum(f.startswith("-fmad=") for f in cuda_build._flags(name)) == 1
    assert (cuda_build.library_path("closest_point")
            != cuda_build.library_path("closest_point_fmad"))


def test_profiling_helpers(tmp_path):
    x = torch.ones(1000)
    assert profiling.device_time(torch.sin, x, reps=2) > 0
    sink = {}
    with profiling.span("work", sink):
        torch.cos(x)
    with profiling.span("work", sink):
        torch.cos(x)
    assert set(sink) == {"work"} and sink["work"] > 0
    with profiling.trace(str(tmp_path)):
        torch.sin(x)
    assert any(n.endswith(".json") for n in os.listdir(tmp_path))
