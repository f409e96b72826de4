"""The port's neural SDF models against the JAX package on the same inputs
(CPU): the MLP forward (float32 and bfloat16), the models' queries and
gradients on the same weights exchanged through npz both ways, the loss
and its parameter gradients, three optimizer steps against optax, the
dataset's near-surface projection on JAX's own random draws, the
per-configuration oracle query, and the port's own fits (judged by the
JAX test's loss gate, since the two packages' random streams differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu as pv
import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu.models import neural_sdf as jn
from pytorch_volumetric_tpu.utils.robots import make_serial_arm
from pytorch_volumetric_tpu_torch import state
from pytorch_volumetric_tpu_torch.models import neural_sdf as tn
from torch_cpu_guard import warm_sqrt

warm_sqrt()

# a bfloat16 network differs from another summation order of the same
# products where a hidden unit's float32 sum rounds to the other
# neighbouring bfloat16 value: one rounding step (2^-8 relative) of one
# unit, well under 1% of the output's scale
BF16_TOL = 1e-2


def _np_params(params):
    return [(np.asarray(W), np.asarray(b)) for W, b in params]


def _loss_converged(losses) -> bool:
    """The JAX test's gate (tests/test_neural_sdf.py): the mean of the
    last 50 losses below half the mean of the first 50."""
    l = np.asarray(losses)
    return float(l[-50:].mean()) < 0.5 * float(l[:50].mean())


@pytest.mark.parametrize("activation", ["sine", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_forward_matches_jax(activation, dtype):
    """``fourier_features`` and ``mlp_forward`` on JAX's ``mlp_init``
    weights: float32 within 1e-5, bfloat16 within ``BF16_TOL`` of the
    output's scale (the port's CPU route: float32 products of the
    bfloat16-rounded operands)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 0.5, (96, 3)).astype(np.float32)
    B = (1.5 * rng.normal(size=(3, 20))).astype(np.float32)
    ff_j = np.asarray(jn.fourier_features(jnp.asarray(x), jnp.asarray(B)))
    ff_t = tn.fourier_features(torch.as_tensor(x), torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(ff_t, ff_j, atol=1e-5)

    params = jn.mlp_init(jax.random.PRNGKey(1), 40, 32, 4, activation=activation)
    mp = state.mlp_params_from_numpy(_np_params(params), device="cpu")
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    y_j = np.asarray(jn.mlp_forward(params, jnp.asarray(ff_j), compute_dtype=jd,
                                    activation=activation))
    with torch.no_grad():
        y_t = tn.mlp_forward(mp, torch.tensor(ff_j), compute_dtype=td,
                             activation=activation).numpy()
    scale = float(np.abs(y_j).max())
    tol = 1e-5 * max(scale, 1e-2) if dtype == "float32" else BF16_TOL * scale
    assert y_t.shape == y_j.shape == (96,)
    np.testing.assert_allclose(y_t, y_j, atol=tol, rtol=0)


def _jax_models(tmp_path, activation="sine"):
    """A JAX NeuralSDF and ConfigSpaceNeuralSDF (M = 2) on ``mlp_init``
    weights, saved to npz."""
    rng = np.random.default_rng(1)
    B = jnp.asarray((1.5 * rng.normal(size=(3, 16))).astype(np.float32))
    bounds = np.array([[-0.5, 0.5]] * 3, np.float32)
    single = jn.NeuralSDF(jn.mlp_init(jax.random.PRNGKey(2), 32, 32, 3, activation=activation),
                          B, bounds, activation=activation)
    cs = jn.ConfigSpaceNeuralSDF(
        jn.mlp_init(jax.random.PRNGKey(3), 2 + 32, 32, 3, activation=activation), B,
        np.array([-1.0, -2.0], np.float32), np.array([1.0, 1.5], np.float32), bounds,
        activation=activation)
    ps, pc = str(tmp_path / "single_jax.npz"), str(tmp_path / "cs_jax.npz")
    single.save(ps)
    cs.save(pc)
    return single, cs, ps, pc


def _assert_npz_equal(a, b):
    with np.load(a) as da, np.load(b) as db:
        assert set(da.files) == set(db.files)
        for k in da.files:
            assert da[k].dtype == db[k].dtype, k
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)


@pytest.mark.parametrize("activation", ["sine", "relu"])
def test_neural_sdf_query_matches_jax_through_npz(tmp_path, activation):
    """JAX's npz loads into the port, whose values and autograd gradients
    match JAX's (1e-5 / 1e-4 relative to their scale); the port's npz is
    the same arrays and loads back into JAX."""
    single, _, ps, _ = _jax_models(tmp_path, activation)
    model = pt.NeuralSDF.load(ps, device="cpu")
    assert isinstance(model, pt.ObjectFrameSDF) and model.max_grad_norm_hint == 10.0
    pts = np.random.default_rng(4).uniform(-0.5, 0.5, (2, 50, 3)).astype(np.float32)
    v_j, g_j = single(jnp.asarray(pts))
    v_t, g_t = model(torch.as_tensor(pts))
    assert v_t.shape == (2, 50) and g_t.shape == (2, 50, 3)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j),
                               atol=1e-5 * max(float(jnp.abs(v_j).max()), 1e-2))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                               atol=1e-4 * float(jnp.abs(g_j).max()))
    # value-only path == raw_query's values
    np.testing.assert_array_equal(model.value(torch.as_tensor(pts)).detach().numpy(),
                                  v_t.numpy())
    back = str(tmp_path / "single_port.npz")
    model.save(back)
    _assert_npz_equal(ps, back)
    again = jn.NeuralSDF.load(back)
    np.testing.assert_array_equal(np.asarray(again(jnp.asarray(pts))[0]), np.asarray(v_j))
    bb = model.surface_bounding_box(padding=0.1).numpy()
    np.testing.assert_allclose(bb, np.asarray(single.surface_bounding_box(padding=0.1)))


def test_config_space_query_matches_jax_through_npz(tmp_path):
    """``query``, ``__call__`` (1-D and batched configurations) and
    ``at_config`` against JAX on the same weights, both ways through npz;
    the value is differentiable in ``q`` and the query's gradient w.r.t.
    ``q`` and the points matches ``jax.grad``."""
    _, cs, _, pc = _jax_models(tmp_path)
    model = pt.ConfigSpaceNeuralSDF.load(pc, device="cpu")
    rng = np.random.default_rng(5)
    q = rng.uniform(-1.0, 1.0, (3, 2)).astype(np.float32)
    pts = rng.uniform(-0.4, 0.4, (40, 3)).astype(np.float32)

    def close(a, b, rel):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, atol=rel * max(float(np.abs(b).max()), 1e-2))

    v_j, g_j = jax.jit(cs.query)(jnp.asarray(q), jnp.asarray(pts))
    v_t, g_t = model.query(torch.as_tensor(q), torch.as_tensor(pts))
    assert v_t.shape == (3, 40) and g_t.shape == (3, 40, 3)
    close(v_t, v_j, 1e-5)
    close(g_t, g_j, 1e-4)

    v1, g1 = model.set_joint_configuration(torch.as_tensor(q[0]))(torch.as_tensor(pts[:10]))
    assert v1.shape == (10,) and g1.shape == (10, 3)
    close(v1, v_j[0, :10], 1e-5)
    qb = rng.uniform(-1.0, 1.0, (2, 3, 2)).astype(np.float32)
    pb = pts[:12].reshape(2, 6, 3)
    vb_j, gb_j = cs.set_joint_configuration(jnp.asarray(qb))(jnp.asarray(pb))
    vb_t, gb_t = model.set_joint_configuration(torch.as_tensor(qb))(torch.as_tensor(pb))
    assert vb_t.shape == (2, 3, 2, 6) and gb_t.shape == (2, 3, 2, 6, 3)
    close(vb_t, vb_j, 1e-5)
    close(gb_t, gb_j, 1e-4)

    bound_j = cs.at_config(jnp.asarray(q[1]))
    bound_t = model.at_config(torch.as_tensor(q[1]))
    assert isinstance(bound_t, pt.ObjectFrameSDF)
    vj, gj = bound_j(jnp.asarray(pb))
    vt, gt = bound_t(torch.as_tensor(pb))
    close(vt, vj, 1e-5)
    close(gt, gj, 1e-4)
    with pytest.raises(ValueError, match="single"):
        model.at_config(torch.zeros(2, 2))

    # d/dq and d/dpts through the query's value and gradient
    def obj_j(qq, pp):
        v, g = cs.query(qq, pp)
        return jnp.sum(v) + jnp.sum(g)

    dq_j, dp_j = jax.jit(jax.grad(obj_j, argnums=(0, 1)))(jnp.asarray(q), jnp.asarray(pts))
    qt = torch.as_tensor(q).requires_grad_(True)
    ptt = torch.as_tensor(pts).requires_grad_(True)
    v, g = model.query(qt, ptt)
    dq_t, dp_t = torch.autograd.grad(v.sum() + g.sum(), (qt, ptt))
    close(dq_t, dq_j, 1e-4)
    close(dp_t, dp_j, 1e-4)
    # the value alone at one configuration, as tests/test_neural_sdf.py
    q1 = torch.tensor([0.3, -0.2], requires_grad=True)
    (dq1,) = torch.autograd.grad(model.value(q1, torch.tensor([[0.1, 0.0, 0.2]])).sum(), q1)
    dq1_j = jax.jit(jax.grad(lambda qq: jnp.sum(cs.value(qq, jnp.asarray([[0.1, 0.0, 0.2]])))))(
        jnp.asarray([0.3, -0.2]))
    assert bool(torch.isfinite(dq1).all()) and float(dq1.abs().max()) > 0.0
    close(dq1, dq1_j, 1e-4)

    back = str(tmp_path / "cs_port.npz")
    model.save(back)
    _assert_npz_equal(pc, back)
    again = jn.ConfigSpaceNeuralSDF.load(back)
    np.testing.assert_array_equal(np.asarray(jax.jit(again.query)(jnp.asarray(q),
                                                                  jnp.asarray(pts))[0]),
                                  np.asarray(v_j))


def test_load_checks_the_kind(tmp_path):
    _, _, ps, pc = _jax_models(tmp_path)
    with pytest.raises(ValueError, match="neural_sdf"):
        pt.NeuralSDF.load(pc, device="cpu")
    with pytest.raises(ValueError, match="config_space"):
        pt.ConfigSpaceNeuralSDF.load(ps, device="cpu")


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="activation"):
        tn.mlp_init(0, 8, 16, 3, activation="ReLU", device="cpu")
    mp = tn.mlp_init(0, 8, 16, 3, device="cpu")
    with pytest.raises(ValueError, match="activation"):
        tn.mlp_forward(mp, torch.zeros(2, 8), activation="tanh")


def _jax_loss(params, feats, pts, d, dg, grad_weight, w0, compute_dtype, activation):
    """The loss of the JAX package's ``_fit`` (neural_sdf.py:227-233)."""
    def scalar(p, pt_):
        return jn.mlp_forward(p, feats(pt_[None]), w0=w0, compute_dtype=compute_dtype,
                              activation=activation)[0]

    def loss(p):
        f, fg = jax.vmap(jax.value_and_grad(lambda x: scalar(p, x)))(pts)
        return (jnp.mean((f - d) ** 2)
                + grad_weight * jnp.mean(jnp.sum((fg[..., -3:] - dg) ** 2, axis=-1)))

    return jax.jit(jax.value_and_grad(loss))(params)


@pytest.mark.parametrize("activation", ["sine", "relu"])
def test_loss_and_parameter_gradients_match_jax(activation):
    """The config-space loss (input ``(q, x)``, gradient supervised on the
    point only) and its parameter gradients, same weights and minibatch,
    within 1e-5 relative."""
    rng = np.random.default_rng(6)
    M, K = 2, 12
    B = (1.5 * rng.normal(size=(3, K))).astype(np.float32)
    lo, hi = np.array([-1.0, -2.0], np.float32), np.array([1.0, 1.5], np.float32)
    qx = np.concatenate([rng.uniform(-1, 1, (64, M)), rng.uniform(-0.5, 0.5, (64, 3))],
                        -1).astype(np.float32)
    d = rng.normal(size=64).astype(np.float32) * 0.1
    dg = rng.normal(size=(64, 3)).astype(np.float32)
    params = jn.mlp_init(jax.random.PRNGKey(7), M + 2 * K, 24, 3, activation=activation)
    cs_j = jn.ConfigSpaceNeuralSDF(params, jnp.asarray(B), lo, hi, np.zeros((3, 2)),
                                   activation=activation)
    loss_j, grads_j = _jax_loss(params, lambda b: cs_j._features(b[..., :M], b[..., M:]),
                                jnp.asarray(qx), jnp.asarray(d), jnp.asarray(dg), 0.1, 30.0,
                                jnp.float32, activation)
    mp = state.mlp_params_from_numpy(_np_params(params), device="cpu")
    cs_t = pt.ConfigSpaceNeuralSDF(mp, B, lo, hi, np.zeros((3, 2)), activation=activation)
    loss_t = tn._loss(mp, lambda b: cs_t._features(b[..., :M], b[..., M:]), torch.as_tensor(qx),
                      torch.as_tensor(d), torch.as_tensor(dg), 0.1, 30.0, torch.float32,
                      activation)
    grads_t = torch.autograd.grad(loss_t, [p for pair in mp for p in pair])
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for gt_, gj in zip(grads_t, [x for pair in grads_j for x in pair]):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt_.numpy(), gj, rtol=0,
                                   atol=1e-5 * float(np.abs(gj).max()))


def test_optimizer_steps_match_optax():
    """``chain(clip_by_global_norm(1), adam(cosine_decay_schedule(lr, 4,
    0.05)))`` for three updates (t = 0, 1 and mid-schedule t = 2), one
    gradient above the clip norm and two below: the parameters within
    1e-6 relative, and the schedule at every t."""
    import optax

    rng = np.random.default_rng(8)
    shapes = [(5, 4), (4,), (4, 1), (1,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]
             for scale in (3.0, 0.05, 0.2)]
    lr, steps = 1e-2, 4
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.05)))
    pj = [jnp.asarray(p) for p in p0]
    s = opt.init(pj)
    pt_ = [torch.tensor(p) for p in p0]
    adam = tn._Adam(pt_)
    update = jax.jit(opt.update)
    for t, g in enumerate(grads):
        u, s = update([jnp.asarray(x) for x in g], s, pj)
        pj = optax.apply_updates(pj, u)
        adam.step(tn._clip_by_global_norm([torch.tensor(x) for x in g]),
                  tn._cosine_lr(lr, steps, t))
        for a, b in zip(pt_, pj):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max())
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.05)
    for t in range(steps + 2):
        np.testing.assert_allclose(tn._cosine_lr(lr, steps, t), float(sched(t)), rtol=1e-6)


def test_near_surface_projection_on_jax_draws():
    """``_sample_dataset`` fed the draws JAX's makes from its key gives
    JAX's dataset (points, values, gradients) on the sphere."""
    key = jax.random.PRNGKey(11)
    bounds = np.array([[-0.7, 0.7]] * 3, np.float32)
    n_u, n_n, sigma = 300, 200, 0.02
    x_j, v_j, g_j = jn._sample_dataset(pv.SphereSDF(0.5), key, bounds, n_u, n_n, sigma)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    lo, hi = jnp.asarray(bounds[:, 0]), jnp.asarray(bounds[:, 1])
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    draws = tn._Draws(t(jax.random.uniform(k1, (n_u, 3), minval=lo, maxval=hi)),
                      t(jax.random.uniform(k4, (n_n, 3), minval=lo, maxval=hi)),
                      t(jax.random.normal(k2, (n_n, 1))),
                      t(jax.random.permutation(k3, n_u + n_n)))
    x_t, v_t, g_t = tn._sample_dataset(pt.SphereSDF(0.5, device="cpu"), draws, bounds, sigma)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-6)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-6)


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """The 2-joint arm (exact mesh links) in both packages, from one set of
    files."""
    d = str(tmp_path_factory.mktemp("arm2"))
    urdf, end = make_serial_arm(d, num_joints=2, segments=6, rings=2)
    text = open(urdf).read()
    robot_j = pv.RobotSDF(pv.build_serial_chain_from_urdf(text, end), path_prefix=d)
    robot_t = pt.RobotSDF(pt.build_serial_chain_from_urdf(text, end, device="cpu"),
                          path_prefix=d)
    return robot_j, robot_t


def _assert_gradients_close(g, g_ref, atol=1e-4, max_ties=0.02):
    """Gradients within ``atol``, except at points where the two sweeps
    settle a tie between equidistant mesh features differently (a ridge or
    a corner of the coarse test mesh, the transformed point differing in
    its last bits): at most ``max_ties`` of the points, each a unit vector
    in both."""
    g, g_ref = np.asarray(g).reshape(-1, 3), np.asarray(g_ref).reshape(-1, 3)
    off = np.abs(g - g_ref).max(axis=-1) > atol
    assert off.mean() <= max_ties, off.mean()
    for x in (g[off], g_ref[off]):
        np.testing.assert_allclose(np.linalg.norm(x, axis=-1), 1.0, atol=1e-3)


def test_config_space_oracle_on_jax_draws(arms):
    """The config-space near-surface projection and ``_per_config_query``
    (row ``a`` under ``qs[a]`` alone), fed JAX's draws: values and points
    within 1e-5 of JAX's, gradients within 1e-4 but at ties."""
    robot_j, robot_t = arms
    key = jax.random.PRNGKey(12)
    kq, kx, kx2, kp = jax.random.split(key, 4)
    lims = robot_j.chain.get_joint_limits()
    A, n, sigma = 4, 32, 0.02
    qs = jax.random.uniform(kq, (A, 2), minval=lims[:, 0], maxval=lims[:, 1])
    lo, hi = jnp.full((3,), -0.5), jnp.full((3,), 0.6)
    xu = jax.random.uniform(kx, (n, 3), minval=lo, maxval=hi)
    seeds = jax.random.uniform(kx2, (n, 3), minval=lo, maxval=hi)
    noise = jax.random.normal(kp, (A, n, 1))

    # JAX: fit_config_space_sdf's sweep (neural_sdf.py:594-607), spelled out
    robot_j.set_joint_configuration(qs)
    vu_j, gu_j = robot_j(xu)
    vs_j, gs_j = robot_j(seeds)
    xn_j = jnp.clip(seeds[None] - vs_j[..., None] * gs_j + sigma * noise * gs_j, lo, hi)
    vn_j, gn_j = jax.jit(lambda q, p: jn._per_config_query(robot_j, q, p))(qs, xn_j)

    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    vu, gu, xn, vn, gn = tn._config_space_samples(robot_t, t(qs), t(xu), t(seeds), t(noise),
                                                  t(lo), t(hi), sigma)
    for a, b in ((vu, vu_j), (xn, xn_j), (vn, vn_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    _assert_gradients_close(gu, gu_j)
    _assert_gradients_close(gn, gn_j)
    # the diagonal alone, on JAX's own near points
    vd, gd = tn._per_config_query(robot_t, t(qs), t(xn_j))
    np.testing.assert_allclose(vd.numpy(), np.asarray(vn_j), atol=1e-5)
    _assert_gradients_close(gd, gn_j)
    # ... which is the diagonal of the full configurations x points product
    full_v, _ = robot_t.query(t(qs), t(xn_j).reshape(-1, 3))
    diag = full_v.reshape(A, A, n)[torch.arange(A), torch.arange(A)]
    np.testing.assert_array_equal(vd.numpy(), diag.numpy())


def test_port_fits_the_sphere():
    """The port's own ``fit_neural_sdf`` at width 32, 200 steps: the loss
    gate, and values near the sphere's."""
    sphere = pt.SphereSDF(0.5, device="cpu")
    model, losses = pt.fit_neural_sdf(sphere, key=0, padding=0.2, width=32, depth=3,
                                      fourier=16, n_samples=2000, steps=200, batch=512,
                                      lr=1e-3, device="cpu")
    assert losses.shape == (200,) and _loss_converged(losses)
    pts = torch.as_tensor(np.random.default_rng(0).uniform(-0.6, 0.6, (500, 3)),
                          dtype=torch.float32)
    v, _ = model(pts)
    v_gt, _ = sphere(pts)
    assert float(torch.sqrt(torch.mean((v - v_gt) ** 2))) < 0.05
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.fit_neural_sdf(sphere, key=0, steps=1)


def test_port_distills_the_arm_and_restores_it(arms, monkeypatch):
    """``RobotSDF.distill`` on the 2-joint arm at width 32, 200 steps: the
    loss gate; the robot's configuration survives the distillation, also
    when the oracle sweep raises; the oracle's device must be the fit's."""
    _, robot = arms
    q0 = torch.tensor([0.25, -0.5])
    robot.set_joint_configuration(q0)
    pts = torch.as_tensor(np.random.default_rng(1).uniform(-0.3, 0.3, (16, 3)),
                          dtype=torch.float32)
    v_before, _ = robot(pts)
    model, losses = robot.distill(key=1, width=32, depth=3, fourier=16, n_configs=8,
                                  pts_per_config=128, steps=200, batch=512, lr=1e-3)
    assert isinstance(model, pt.ConfigSpaceNeuralSDF) and model.device.type == "cpu"
    assert losses.shape == (200,) and _loss_converged(losses)
    v_after, _ = robot(pts)
    np.testing.assert_array_equal(v_before.numpy(), v_after.numpy())

    def broken(*args, **kwargs):
        raise MemoryError("oracle sweep")

    monkeypatch.setattr(robot, "query", broken)
    with pytest.raises(MemoryError):
        robot.distill(key=2, width=8, depth=2, fourier=4, n_configs=2, pts_per_config=8,
                      steps=1, batch=4)
    monkeypatch.undo()
    np.testing.assert_array_equal(robot(pts)[0].numpy(), v_before.numpy())
    assert torch.equal(robot.q, q0)
    with pytest.raises(ValueError, match="oracle lives on cpu"):
        pt.fit_config_space_sdf(robot, 0, device="meta", steps=1)
