"""The port's query guards (``utils.debug``) against the JAX package's
checkify guards (CPU): the same first failing guard with the same message,
results equal to the unchecked query, no host sync with ``throw=False``,
and the learned fields' looser gradient bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
import pytorch_volumetric_tpu_torch.utils as tutils
from pytorch_volumetric_tpu.utils import debug as jdebug
from pytorch_volumetric_tpu_torch.utils import debug
from pytorch_volumetric_tpu_torch.utils.debug import QueryCheckError, checked_query
from torch_cpu_guard import warm_sqrt

warm_sqrt()


def test_clean_query_passes():
    sdf = pt.SphereSDF(0.5, device="cpu")
    pts = torch.as_tensor(np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32))
    v, g = checked_query(sdf)(pts)
    v0, g0 = sdf.raw_query(pts)
    assert torch.equal(v, v0) and torch.equal(g, g0)


def test_nonfinite_input_raises():
    sdf = pt.SphereSDF(0.5, device="cpu")
    with pytest.raises(QueryCheckError, match="non-finite query"):
        checked_query(sdf)(torch.tensor([[float("nan"), 0.0, 0.0]]))


def test_bad_gradient_caught():
    def bad_raw(pts):
        return torch.linalg.vector_norm(pts, dim=-1), pts * 10.0  # not a unit direction

    with pytest.raises(QueryCheckError, match="gradient norm"):
        checked_query(bad_raw)(torch.ones((4, 3)))


def test_no_throw_mode_returns_the_error():
    sdf = pt.SphereSDF(0.5, device="cpu")
    err, (v, g) = checked_query(sdf, throw=False)(torch.ones((8, 3)))
    assert err.get() is None and v.shape == (8,)
    err.throw()
    err, _ = checked_query(sdf, throw=False)(torch.full((2, 3), float("inf")))
    assert err.get() == "non-finite query points"
    with pytest.raises(QueryCheckError, match="non-finite query points"):
        err.throw()


def _bad_raw(kind, xp):
    """A raw query failing the guards that ``kind`` names (several at
    once, so the order decides), written for ``xp`` (numpy-like: jnp or
    torch)."""
    norm = (lambda p: jnp.linalg.norm(p, axis=-1)) if xp is jnp else (
        lambda p: torch.linalg.vector_norm(p, dim=-1))

    def raw(pts):
        v, g = norm(pts) - 0.5, pts / norm(pts)[..., None]
        if "value" in kind:
            v = v * xp.inf
        if "grad" in kind:
            g = g * xp.nan
        if "norm" in kind:
            g = g * 3.0
        return v, g

    return raw


@pytest.mark.parametrize("kind,pts_bad", [
    ("", False), ("norm", False), ("grad", False), ("grad norm", False),
    ("value", False), ("value grad norm", False), ("value", True), ("", True),
])
def test_first_failing_guard_and_message_match_jax(kind, pts_bad):
    """The first failing guard, in the JAX package's order (points, values,
    gradients, norm), with its message text (JAX's adds checkify's own
    suffix)."""
    pts = np.random.default_rng(1).normal(size=(16, 3)).astype(np.float32)
    if pts_bad:
        pts[3, 1] = np.inf
    err_j, _ = jdebug.checked_query(_bad_raw(kind, jnp), throw=False)(jnp.asarray(pts))
    err_t, _ = checked_query(_bad_raw(kind, torch), throw=False)(torch.as_tensor(pts))
    msg_j, msg_t = err_j.get(), err_t.get()
    if msg_j is None:
        assert msg_t is None
        return
    assert msg_t is not None and msg_j == msg_t + " (`check` failed)", (msg_j, msg_t)


def test_jax_twin_raises_the_same_messages():
    """The JAX package's throwing form and the port's raise on the same
    inputs with the same text."""
    def torch_bad(pts):
        return torch.linalg.vector_norm(pts, dim=-1), pts * 10.0

    def jax_bad(pts):
        return jnp.linalg.norm(pts, axis=-1), pts * 10.0

    with pytest.raises(checkify.JaxRuntimeError) as ej:
        jdebug.checked_query(jax_bad)(jnp.ones((4, 3), dtype=jnp.float32))
    with pytest.raises(QueryCheckError) as et:
        checked_query(torch_bad)(torch.ones((4, 3)))
    assert str(ej.value).startswith(str(et.value))
    assert str(et.value) == "SDF gradient norm 17.32050895690918 exceeds the unit-direction bound"


def test_cached_sdf_guarded_through_its_tables(tmp_path):
    """An SDF with tables is guarded through ``raw_query_with``: equal to
    the unchecked query, out-of-range points caught."""
    m = pt.mesh.icosphere_mesh(0.3, 1)
    path = str(tmp_path / "ball.obj")
    pt.mesh.save_obj(m, path)
    fac = pt.MeshObjectFactory(path, device="cpu")
    sdf = pt.CachedSDF("ball", 0.05, fac.bounding_box(padding=0.1), pt.MeshSDF(fac),
                       cache_path=str(tmp_path / "c.npz"))
    pts = torch.as_tensor(np.random.default_rng(2).uniform(-0.5, 0.5, (200, 3))
                          .astype(np.float32))
    v, g = checked_query(sdf)(pts)
    v0, g0 = sdf.raw_query(pts)
    assert torch.equal(v, v0) and torch.equal(g, g0)
    with pytest.raises(QueryCheckError, match="non-finite query points"):
        checked_query(sdf)(torch.cat([pts, torch.tensor([[0.0, float("nan"), 0.0]])]))


def test_neural_models_loosen_the_gradient_bound():
    """A learned field's hint (10.0, as the JAX package's) replaces the
    unit-direction bound."""
    assert pt.NeuralSDF.max_grad_norm_hint == pv.models.NeuralSDF.max_grad_norm_hint == 10.0
    assert debug.DEFAULT_MAX_GRAD_NORM == jdebug.DEFAULT_MAX_GRAD_NORM

    def raw(pts):
        return torch.linalg.vector_norm(pts, dim=-1), pts * 5.0

    class Learned:
        max_grad_norm_hint = pt.NeuralSDF.max_grad_norm_hint
        raw_query = staticmethod(raw)

    pts = torch.ones((4, 3))
    checked_query(Learned())(pts)
    with pytest.raises(QueryCheckError, match="gradient norm"):
        checked_query(Learned(), max_grad_norm=1.0)(pts)


def test_utils_namespace_matches_jax():
    """The port's ``utils`` binds what the JAX package's binds."""
    import pytorch_volumetric_tpu.utils as jutils
    for name in ("flatten_batch", "np_pad_to", "checked_query", "guarded_raw_query",
                 "cdiv", "round_up", "pad_to", "NpzStore", "get_store"):
        assert hasattr(jutils, name) and hasattr(tutils, name), name
    x = np.arange(6.0).reshape(2, 3)
    assert np.array_equal(tutils.np_pad_to(x, 4), np.asarray(jax.device_get(
        jutils.np_pad_to(x, 4))))
    flat, unflatten = tutils.flatten_batch(torch.zeros((2, 5, 3)))
    assert flat.shape == (10, 3) and unflatten(flat[:, :1]).shape == (2, 5, 1)
