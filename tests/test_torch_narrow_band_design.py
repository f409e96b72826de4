"""The narrow-band kernel's design, mirrored in torch on the CPU.

``csrc/narrow_band.cu`` runs on the card only.  These tests hold its design
to the plain version (``ops.narrow_band._query_impl``) at small sizes:

- lever A: a warp of 32 lanes splits each in-band point's rows (lane l
  takes rows k = l mod 32), stops after the first round that meets a
  padding row, keeps each lane's first best row and reduces (d2, k) across
  the lanes with xor shuffles in torch.argmin's order (the first NaN, else
  the least value, ties to the smaller row); a block's warps take its
  in-band points from a list in an order set by atomics;
- the invariant that stop rests on: a cell's list is padded only at its
  tail, in the port's builds and in the JAX package's.
"""

import numpy as np
import pytest
import torch

from pytorch_volumetric_tpu.ops import narrow_band as jnb
from pytorch_volumetric_tpu_torch import mesh as tmesh
from pytorch_volumetric_tpu_torch import native as tnative
from pytorch_volumetric_tpu_torch.bench import bigmesh
from pytorch_volumetric_tpu_torch.mesh import PAD_COORD
from pytorch_volumetric_tpu_torch.ops import narrow_band as tnb
from torch_cpu_guard import warm_sqrt

warm_sqrt()

pytestmark = pytest.mark.skipif(not tnative.available(),
                                reason="g++ unavailable: no native runtime to build")

CPU = torch.device("cpu")
WARP = 32
INT_MAX = 2 ** 31 - 1


def before(a, ka, b, kb):
    """``(a, ka)`` before ``(b, kb)`` in torch.argmin's order, elementwise:
    the kernel's ``before``."""
    na, nb = torch.isnan(a), torch.isnan(b)
    nan_case = na & (~nb | (ka < kb))
    return torch.where(na | nb, nan_case, (a < b) | ((a == b) & (ka < kb)))


def rounds_limit(cand_rows: torch.Tensor) -> torch.Tensor:
    """Lever A's rows per point ``[n]``: every round up to and including
    the first that meets a padding row (all K rows without one)."""
    n, K = cand_rows.shape[:2]
    pad = cand_rows[..., 0] == PAD_COORD
    first = torch.where(pad.any(dim=1), pad.to(torch.int8).argmax(dim=1), torch.full((n,), K))
    return torch.clamp((first // WARP + 1) * WARP, max=K)


def warp_winner(d2: torch.Tensor, limit: torch.Tensor) -> torch.Tensor:
    """Lever A's winner ``[n]`` over ``d2 [n, K]``, rows ``k < limit[n]``:
    each lane's sequential first best, then the xor-shuffle reduction."""
    n, K = d2.shape
    R = -(-K // WARP)
    inf = torch.full((n, WARP), float("inf"))
    best_d, best_k = inf.clone(), torch.full((n, WARP), INT_MAX)
    lanes = torch.arange(WARP)
    for r in range(R):
        k = r * WARP + lanes
        live = (k[None] < limit[:, None]) & (k[None] < K)
        d = d2[:, torch.clamp(k, max=K - 1)]
        take = live & before(d, k[None].expand(n, -1), best_d, best_k)
        best_d = torch.where(take, d, best_d)
        best_k = torch.where(take, k[None].expand(n, -1), best_k)
    off = WARP // 2
    while off:
        od, ok = best_d[:, lanes ^ off], best_k[:, lanes ^ off]
        take = before(od, ok, best_d, best_k)
        best_d, best_k = torch.where(take, od, best_d), torch.where(take, ok, best_k)
        off //= 2
    assert bool((best_k == best_k[:, :1]).all())  # every lane holds the winner
    return best_k[:, 0]


def mirror_query(smalls, big, points, eps=1e-3, order=None):
    """The query with lever A's winner for every in-band point (``order``:
    the in-band points in the order to run them): ``(val, grad, slot)``
    with the in-band rows written back by point index."""
    val, grad, slot = tnb._query_impl(smalls, big, points, eps)
    val, grad = val.clone(), grad.clone()
    band = torch.nonzero(slot >= 0)[:, 0] if order is None else order
    if band.numel():
        sl = slot[band].to(torch.int64)
        rows = big.cand.index_select(0, sl)
        fid_bits = big.cand.view(torch.int32)[..., 9].index_select(0, sl)
        p = points.index_select(0, band)
        d2, q, feat = tnb._candidate_pairs(p, rows)
        k = warp_winner(d2, rounds_limit(rows))
        assert torch.equal(k, torch.argmin(d2, dim=1))
        v, g = tnb._winner_query(p, d2, q, feat, fid_bits, k[:, None], big.pseudo, eps)
        val[band], grad[band] = v, g
    return val, grad, slot


@pytest.fixture(scope="module")
def cases():
    return bigmesh.kernel_cases(CPU)


def _assert_equal(out, ref, name):
    for a, b in zip(out, ref):
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
        assert bool(same.all()), name


@pytest.mark.parametrize("which", ["torus", "icosphere, max_k=8", "inverted icosphere",
                                   "duplicated faces", "NaN rows", "no margin, NaN and inf",
                                   "31, 32 and 33 real candidates", "dense cells"])
def test_lever_a_equals_plain(cases, which):
    """Lever A's split, stop and reduction give the plain version's values,
    gradients and slots on the kernel's own cases (exact ties on the
    duplicated faces; NaN distances in the NaN rows and at NaN points)."""
    picked = [c for c in cases if (which in c[0] if which != "torus" else
                                   c[0] in ("torus, uniform", "torus, near the surface"))
              or (which == "no margin, NaN and inf" and c[0].startswith("torus with no margin"))
              or (which == "31, 32 and 33 real candidates" and "real candidates" in c[0])]
    assert picked, which
    for name, smalls, big, pts in picked:
        ref = tnb._query_impl(smalls, big, pts, 1e-3)
        _assert_equal(mirror_query(smalls, big, pts), ref, name)


def test_lever_a_block_sharing_order(cases):
    """A block's in-band points run in its list's order (set by shared-
    memory atomics) and each result goes back to its own thread: the
    output does not depend on that order."""
    rng = np.random.default_rng(2)
    name, smalls, big, pts = next(c for c in cases if c[0] == "torus, near the surface")
    ref = tnb._query_impl(smalls, big, pts, 1e-3)
    band = torch.nonzero(ref[2] >= 0)[:, 0].numpy()
    blocks = band // 128
    order = np.concatenate([rng.permutation(band[blocks == b]) for b in np.unique(blocks)])
    assert not np.array_equal(order, band)
    _assert_equal(mirror_query(smalls, big, pts, order=torch.as_tensor(order)), ref, name)


def test_reduction_on_nan_and_ties():
    """The lanes' first best and the shuffle reduction pick torch.argmin's
    row on every pattern of NaN and ties, with and without a stop."""
    rng = np.random.default_rng(0)
    n, K = 4000, 75
    d2 = torch.as_tensor(rng.integers(0, 6, (n, K)).astype(np.float32))
    d2[torch.as_tensor(rng.random((n, K)) < 0.02)] = float("nan")
    d2[:5] = float("nan")                 # every row NaN
    d2[5:10] = 3.0                        # every row tied
    d2[10:15, 40] = -1.0                  # one least row in lane 8's second round
    d2[15:20] = float("inf")
    assert torch.isnan(d2).any(dim=1).float().mean() > 0.5
    for limit in (K, 64, 32, 1):
        lim = torch.full((n,), limit)
        assert torch.equal(warp_winner(d2, lim), torch.argmin(d2[:, :limit], dim=1)), limit


@pytest.mark.parametrize("case", ["torus", "icosphere, max_k=8", "duplicated faces"])
@pytest.mark.parametrize("package", ["port", "jax"])
def test_padding_is_tail_only(case, package):
    """Every cell's list: real rows first, ``PAD_COORD`` rows after (the
    stop after the first round that meets one skips no real row)."""
    ico = tmesh.icosphere_mesh(0.2, 2)
    meshes = {"torus": (tmesh.torus_mesh(0.3, 0.12, 48, 24),
                        dict(cell_res=0.03, band=0.1, padding=0.2)),
              "icosphere, max_k=8": (ico, dict(cell_res=0.03, band=0.06, padding=0.1,
                                               max_k=8)),
              "duplicated faces": (ico.concatenate(ico),
                                   dict(cell_res=0.03, band=0.06, padding=0.1))}
    m, kw = meshes[case]
    if package == "port":
        cand = tnb.build_narrow_band_host(m, **kw)[5]
    else:
        from pytorch_volumetric_tpu import mesh as jmesh
        jm = jmesh.TriangleMesh(m.vertices, m.faces)
        cand = np.asarray(jnb.build_narrow_band_tables(jm, **kw).cand)
    pad = cand[..., 0] == PAD_COORD
    assert (pad[:, 1:] >= pad[:, :-1]).all()
    # padding rows pad every corner and carry face id 0
    assert (cand[pad][:, :9] == PAD_COORD).all()
    assert (cand[pad][:, 9].view(np.int32) == 0).all()
    # a band cell holds a real candidate (its center's closest face)
    if pad.shape[0] > 1 or not pad.all():
        assert (~pad[:, 0]).all()
