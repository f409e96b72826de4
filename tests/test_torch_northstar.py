"""The north-star benchmark's chunk loop (``bench/northstar.py``) against
the JAX package's ``compose_query_coherent`` driven through
``benchmarks/northstar.py``'s chunk semantics (a loop over configuration
chunks of ``robot._link_transforms`` + ``compose_query_coherent``), on the
CPU at a tiny size that keeps the script's (3, 3, 3) tiles (``seg = 27``:
query res 0.02 over caches of 0.04): the 3-joint arm and a 1,024-face torus
free link, each nearest and trilinear, 4 configurations in chunks of 2.
Both packages read one cache file, built by the port; the JAX caches get
their brick tables from ``test_torch_coherent``'s numpy build.  The JAX
side runs the script's three variants of a chunk as one jitted program
per row.

Tolerances: per point, values equal or within 1e-6 and gradients within
1e-5 (JAX's non-CPU tolerance for the coherent path); per chunk, d(v.sum()
+ g.sum())/dq within 2e-4 of each configuration's largest |d/dq| (at
least 1), as chip_smoke's phase 8 holds the coherent path; each scalar of
the step (forward, forward + backward, values only) within 1e-5 relative to
the magnitude of what it sums (the absolute chunk terms): the terms
cancel (the forward + backward scalar of the arm is ~-910 from terms of
~10^4), and float32 sums of ~10^4 points in another order move each term
by ~1e-6 of itself.
Also the chunk sizes the OOM retry walks, and that it retries nothing but
``torch.cuda.OutOfMemoryError``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu.sdf import coherent_fast_tables as jax_fast_tables
from pytorch_volumetric_tpu.sdf import compose_query_coherent as jax_compose_coherent
from pytorch_volumetric_tpu.utils.robots import make_free_object_urdf, make_serial_arm
from pytorch_volumetric_tpu_torch import sdf as tsdf
from pytorch_volumetric_tpu_torch.bench import northstar as ns
from test_torch_coherent import _give_jax_bricks
from torch_cpu_guard import warm_sqrt

warm_sqrt()

CPU = torch.device("cpu")
N_CONFIGS, CHUNK = 4, 2
QUERY_RES, CACHE_RES = 0.02, 0.04
RANGES = {"arm": np.array([[-0.3, 0.2], [-0.15, 0.2], [-0.1, 0.5]]),
          "free_link": np.array([[-0.2, 0.2], [-0.2, 0.2], [-0.1, 0.1]])}
V_TOL, G_TOL, DQ_TOL, SCALAR_RTOL = 1e-6, 1e-5, 2e-4, 1e-5
ROWS = [("arm", "nearest"), ("arm", "trilinear"), ("free_link", "nearest"),
        ("free_link", "trilinear")]


def _robots(d, kind):
    """The row's URDF text and end link in ``d`` (the tiny arm or the torus)."""
    if kind == "arm":
        urdf, end = make_serial_arm(d, num_joints=3, segments=8, rings=2)
    else:
        obj = os.path.join(d, "torus.obj")
        pv.mesh.save_obj(pv.mesh.torus_mesh(0.1, 0.03, 32, 16), obj)
        urdf, end = make_free_object_urdf(d, obj, object_name="torus")
    return open(urdf).read(), end


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """Each row's (JAX robot, port robot) on one cache file (built by the
    port's sweep, read by the JAX package), the JAX caches with numpy-built
    bricks."""
    out = {}
    for kind in ("arm", "free_link"):
        d = str(tmp_path_factory.mktemp(kind))
        text, end = _robots(d, kind)
        for interp in ("nearest", "trilinear"):
            rt, rj = (pk.RobotSDF(chain, path_prefix=d, link_sdf_cls=pk.cache_link_sdf_factory(
                resolution=CACHE_RES, padding=0.3, interpolation=interp,
                cache_path=os.path.join(d, "cache.npz")))
                for pk, chain in ((pt, pt.build_serial_chain_from_urdf(text, end, device=CPU)),
                                  (pv, pv.build_serial_chain_from_urdf(text, end))))
            for a, b in zip(rt.sdf.sdfs, rj.sdf.sdfs):
                np.testing.assert_array_equal(a.voxels.raw_data.numpy(), b.voxels.raw_data)
                np.testing.assert_array_equal(a.voxels_grad.numpy(),
                                              np.asarray(b.voxels_grad).reshape(-1, 3))
            for c in rj.sdf.sdfs:
                _give_jax_bricks(c)
            out[(kind, interp)] = (rj, rt)
    return out


def _inputs(kind, n_dof):
    pj, take, seg = pv.get_coherent_tile_points(QUERY_RES, RANGES[kind],
                                                cache_resolution=CACHE_RES)
    pp, take_t, seg_t = pt.get_coherent_tile_points(QUERY_RES, RANGES[kind],
                                                    cache_resolution=CACHE_RES, device=CPU)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
    assert seg == seg_t == 27
    q = ns.joint_configs(N_CONFIGS, n_dof, CPU)
    return pj, pp, take_t, seg, q


def _jax_step(rj, q, pts, seg):
    """``benchmarks/northstar.py``'s three variants of a chunk, jitted (the
    tables ``ft`` an argument, as the script passes them) in one program,
    one chunk at a time: per chunk (v, g, dl/dq), and each variant's
    scalar."""
    children = tuple(rj.sdf.sdfs)
    ft = jax_fast_tables(children)

    def chunk_out(qc, p, ft, values_only=False):
        m, m_inv = rj._link_transforms(qc)
        return jax_compose_coherent(children, m, m_inv, CHUNK, p, fast_tables=ft, seg=seg,
                                    values_only=values_only)

    def chunk_loss(qc, p, ft):
        v, g = chunk_out(qc, p, ft)
        return v.sum() + g.sum(), (v, g)

    @jax.jit
    def chunk_step(qc, p, ft):
        (loss, (v, g)), gq = jax.value_and_grad(chunk_loss, has_aux=True)(qc, p, ft)
        return v, g, gq, loss, chunk_out(qc, p, ft, values_only=True).sum()

    outs, fwd, fb, vo = [], [], [], []
    for qc in jnp.asarray(q.numpy()).reshape(N_CONFIGS // CHUNK, CHUNK, -1):
        v, g, gq, loss, vo_sum = chunk_step(qc, pts, ft)
        outs.append((np.asarray(v), np.asarray(g), np.asarray(gq)))
        fwd.append(v.sum() + g.sum())
        fb.append(loss + gq.sum())
        vo.append(vo_sum)
    return outs, {"forward": float(jnp.stack(fwd).sum()),
                  "forward_backward": float(jnp.stack(fb).sum()),
                  "values_only": float(jnp.stack(vo).sum())}


@pytest.mark.parametrize("kind,interp", ROWS, ids=[f"{k}-{i}" for k, i in ROWS])
def test_chunk_loop_matches_jax_northstar(rows, kind, interp):
    rj, rt = rows[(kind, interp)]
    n_dof = len(rt.joint_names)
    pj, pp, take, seg, q = _inputs(kind, n_dof)
    ft = tsdf.coherent_fast_tables(tuple(rt.sdf.sdfs))
    outs_j, scalars_j = _jax_step(rj, q, pj, seg)

    # per point and per configuration, chunk by chunk, through the bench
    # module's chunk query and its d/dq
    for (vj, gj, dqj), qc in zip(outs_j, q.split(CHUNK)):
        v, g, dq = ns.chunk_grad(rt, ft, qc, pp, seg)
        assert v.shape == vj.shape and g.shape == gj.shape and dq.shape == dqj.shape
        dv = np.abs(v.numpy() - vj)
        assert (dv == 0).all() or dv.max() <= V_TOL, dv.max()
        assert np.abs(g.numpy() - gj).max() <= G_TOL
        assert torch.isfinite(g).all()
        scale = np.maximum(np.abs(dqj).max(axis=1, keepdims=True), 1.0)
        assert (np.abs(dq.numpy() - dqj) <= DQ_TOL * scale).all(), np.abs(dq.numpy() - dqj).max()

    row = ns.run_row(rt, ft, q, pp, take, seg, CHUNK, reps=1, warmup=0)
    for variant, want in scalars_j.items():
        r = row["variants"][variant]
        scale = float(r["terms"].abs().sum())
        assert abs(r["sum"] - want) <= SCALAR_RTOL * scale, (variant, r["sum"], want, scale)
    gates = ns.row_gates(row)
    assert all(gates.values()), gates
    assert row["variants"]["values_only"]["value_sum"] == \
        row["variants"]["forward"]["value_sum"]
    assert len(row["audits"]) == N_CONFIGS // CHUNK
    assert all(a["nan_entries"] == 0 for a in row["audits"])
    n_tiles = CHUNK * pp.shape[0] // seg
    assert all(a["tiles"] == n_tiles and a["capacity"] == tsdf.residual_capacity(n_tiles)
               for a in row["audits"])


def test_middle_tiles_are_the_residual_lanes_tiles(rows):
    """``coherent_middle_tiles`` on a 4-link union marks exactly the tiles
    whose gradients go NaN when the residual lane holds one tile (all but
    the first middle tile), and none on a single link."""
    _, rt = rows[("arm", "nearest")]
    pp, _, seg = pt.get_coherent_tile_points(QUERY_RES, RANGES["arm"],
                                             cache_resolution=CACHE_RES, device=CPU)
    # spread joint angles: links cross, so some tiles see 4 winners
    q = torch.as_tensor(np.random.default_rng(3).uniform(-2, 2, (8, 3)).astype(np.float32))
    children = tuple(rt.sdf.sdfs)
    m, m_inv = rt._link_transforms(q)
    middle = tsdf.coherent_middle_tiles(children, m, 8, pp, seg=seg)
    assert middle is not None and middle.shape == (8, pp.shape[0] // seg)
    assert int(middle.sum()) >= 2
    with torch.no_grad():
        _, g = tsdf.compose_query_coherent(children, m, m_inv, 8, pp, seg=seg,
                                           residual_frac=1e-9)
    nan_tiles = torch.isnan(g).reshape(8, -1, seg * 3).any(dim=-1)
    _, overflow = tsdf._residual_tiles(middle, tsdf.residual_capacity(middle.numel(), 1e-9))
    assert torch.equal(nan_tiles, overflow)
    assert int(middle.sum()) == int(nan_tiles.sum()) + (1 if middle.any() else 0)
    _, rf = rows[("free_link", "nearest")]
    mf, _ = rf._link_transforms(q[:, :1].repeat(1, 6))
    assert tsdf.coherent_middle_tiles(tuple(rf.sdf.sdfs), mf, 8, pp, seg=seg) is None


def test_chunk_candidates_walk_the_jax_scripts_divisors():
    assert list(ns.chunk_candidates(200, 25)) == [25, 10, 5, 2, 1]
    assert list(ns.chunk_candidates(200, 16)) == [10, 5, 2, 1]
    assert list(ns.chunk_candidates(4, 25)) == [4, 2, 1]
    assert list(ns.chunk_candidates(7, 3)) == [1]


def test_oom_retry_only_on_out_of_memory():
    tried = []

    def run(c):
        tried.append(c)
        if c > 5:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return {"chunk": c}

    assert ns.with_oom_retry(run, 200, 25) == (5, {"chunk": 5})
    assert tried == [25, 10, 5]

    def broken(c):
        tried.append(c)
        raise RuntimeError("not a memory error")

    tried.clear()
    with pytest.raises(RuntimeError, match="not a memory error"):
        ns.with_oom_retry(broken, 200, 25)
    assert tried == [25]

    def always_oom(c):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        ns.with_oom_retry(always_oom, 4, 4)


def test_metric_names_and_cpu_refusal(capsys):
    assert ns.metric_name("arm", "nearest") == "northstar_200x1e6"
    assert ns.metric_name("arm", "trilinear") == "northstar_200x1e6_trilinear"
    assert ns.metric_name("free_link", "trilinear") == "northstar_200x1e6_free_link_trilinear"
    if not torch.cuda.is_available():
        assert ns.main([]) == 1
        assert "needs a CUDA device" in capsys.readouterr().err
