"""Neural (MLP) signed-distance models distilled from exact SDFs.

Continuous, smooth SDFs held in a small MLP and trained by direct (value,
gradient) supervision against an exact :class:`~pytorch_volumetric_tpu_torch.sdf.ObjectFrameSDF`
(mesh, cached or composed SDFs are the oracle, so training data is free
and exact).

- :class:`NeuralSDF`: ``f(x) -> d`` for one rigid object.
- :class:`ConfigSpaceNeuralSDF`: ``f(q, x) -> d`` for an articulated robot,
  conditioned on the joint configuration, behind
  :class:`~pytorch_volumetric_tpu_torch.model_to_sdf.RobotSDF`'s query API
  (``set_joint_configuration`` + ``__call__``).  A query costs a few
  ``[N, width] x [width, width]`` products whatever the robot's link,
  triangle or voxel counts.

The weights keep the JAX package's layout (layer ``i``: ``W [din, dout]``,
``b [dout]``), so an npz written by either package loads into the other.
Every float32 product is true float32 (TF32 stays off); the bfloat16 option
multiplies bfloat16-rounded operands and accumulates in float32.  Gradients
of the learned field come from autograd, so values and gradients agree
analytically.  Training is a plain loop of Adam steps with the JAX
package's arithmetic (optax's global-norm clip and cosine schedule).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from pytorch_volumetric_tpu_torch.sdf import ObjectFrameSDF, compose_query, pad_aabb
from pytorch_volumetric_tpu_torch.utils.batching import as_float_tensor, resolve_device

__all__ = [
    "NeuralSDF", "ConfigSpaceNeuralSDF", "fit_neural_sdf", "fit_config_space_sdf",
    "mlp_init", "mlp_forward", "fourier_features", "MLP",
]

Key = Union[int, torch.Generator]


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """The weights of :func:`mlp_forward`: layer ``i`` is ``(W[i] [din,
    dout], b[i] [dout])``.  Iterating yields the ``(W, b)`` pairs."""

    def __init__(self, params: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.W = nn.ParameterList([nn.Parameter(torch.as_tensor(W)) for W, _ in params])
        self.b = nn.ParameterList([nn.Parameter(torch.as_tensor(b)) for _, b in params])

    def __len__(self) -> int:
        return len(self.W)

    def __iter__(self):
        return iter(zip(self.W, self.b))

    @property
    def device(self) -> torch.device:
        return self.W[0].device

    def forward(self, x, w0: float = 30.0, compute_dtype=torch.float32,
                activation: str = "sine"):
        return mlp_forward(self, x, w0=w0, compute_dtype=compute_dtype, activation=activation)


def _params_to_arrays(params) -> dict:
    out = {}
    for i, (W, b) in enumerate(params):
        out[f"W{i}"] = W.detach().cpu().numpy()
        out[f"b{i}"] = b.detach().cpu().numpy()
    out["n_layers"] = np.asarray(len(params))
    return out


def _params_from_arrays(d, device=None) -> MLP:
    dev = resolve_device(device)
    n = int(d["n_layers"])
    return MLP([(torch.as_tensor(np.asarray(d[f"W{i}"]), device=dev),
                 torch.as_tensor(np.asarray(d[f"b{i}"]), device=dev)) for i in range(n)])


def _check_kind(d, expected: str, path: str) -> None:
    kind = str(d["kind"]) if "kind" in d else "<missing>"
    if kind != expected:
        raise ValueError(
            f"{path} holds a '{kind}' model, not a '{expected}' "
            f"(use the matching class's .load)")


def _generator(key: Key, device: torch.device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def _check_oracle_device(oracle_device: torch.device, device: torch.device) -> None:
    same = (oracle_device.type == device.type
            and (oracle_device.index is None or device.index is None
                 or oracle_device.index == device.index))
    if not same:
        raise ValueError(f"the oracle lives on {oracle_device}, the fit was asked to run on "
                         f"{device}: build the oracle there or pass device={str(oracle_device)!r}")


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------

_ACTIVATIONS = ("sine", "relu")


def _check_activation(activation: str) -> None:
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation must be one of {_ACTIVATIONS}, "
                         f"got {activation!r}")


def fourier_features(x: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Random Fourier features ``[.., d] -> [.., 2K]``: ``(sin, cos)(2π
    x·B)`` (Tancik et al.).  The projection is a true float32 product: the
    sine amplifies phase noise by the frequency."""
    proj = (2.0 * math.pi) * torch.matmul(x, B)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _bf16_product_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of the bfloat16-rounded operands, in float32: exact
    products (8-bit mantissas) summed in float32.  Its derivatives round
    each cotangent to bfloat16 at the casts, as the JAX package's do."""
    return torch.matmul(_round_bf16(a), _round_bf16(b))


class _Bf16Product(torch.autograd.Function):
    """:func:`_bf16_product_plain` as one tensor-core product on the card
    (``torch.mm`` with ``out_dtype=float32``); its derivatives are the
    plain version's, written out with differentiable ops so that a
    gradient of a gradient (training) goes through them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (_round_bf16(torch.matmul(g, _round_bf16(b).t())),
                _round_bf16(torch.matmul(_round_bf16(a).t(), g)))


def _bf16_product(h: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``h [.., din] @ W [din, dout]`` in bfloat16 with float32 accumulation
    and output: the tensor cores on a CUDA tensor, the plain version on the
    CPU."""
    if not h.is_cuda:
        return _bf16_product_plain(h, W)
    flat = h.reshape(-1, h.shape[-1])
    return _Bf16Product.apply(flat, W).reshape(h.shape[:-1] + (W.shape[-1],))


def mlp_init(key: Key, in_dim: int, width: int, depth: int, out_dim: int = 1,
             w0: float = 30.0, activation: str = "sine", device=None) -> MLP:
    """``activation="sine"``: SIREN init (Sitzmann et al.): first layer
    ``U(-1/in, 1/in)`` (scaled by ``w0`` at apply time), hidden layers
    ``U(-sqrt(6/n)/w0, sqrt(6/n)/w0)``.  ``activation="relu"``: He-normal
    hidden layers and a small uniform output layer (a He-scaled head makes
    the first losses enormous and the clipped optimizer then collapses the
    fit to a near-constant).  Drawn from ``key`` (a ``torch.Generator`` or a
    seed) on its device, then moved to ``device`` (CUDA unless given)."""
    _check_activation(activation)
    dev = resolve_device(device)
    gen = _generator(key, dev)
    dims = [in_dim] + [width] * (depth - 1) + [out_dim]
    params = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        W = torch.empty((din, dout), dtype=torch.float32, device=gen.device)
        if activation == "relu" and i < depth - 1:
            W.normal_(generator=gen).mul_(math.sqrt(2.0 / din))
        else:
            bound = 1.0 / din if activation == "sine" and i == 0 else math.sqrt(6.0 / din) / w0
            W.uniform_(-bound, bound, generator=gen)
        params.append((W.to(dev), torch.zeros((dout,), dtype=torch.float32, device=dev)))
    return MLP(params)


def mlp_forward(params, x: torch.Tensor, w0: float = 30.0, compute_dtype=torch.float32,
                activation: str = "sine") -> torch.Tensor:
    """MLP ``[.., in_dim] -> [..]`` over ``(W, b)`` pairs (an :class:`MLP`).
    ``compute_dtype=torch.bfloat16`` multiplies in bfloat16 and accumulates
    in float32 before the bias and the activation; the last layer stays
    float32 (distances need the mantissa).  ``activation``: ``"sine"``
    (SIREN, ``sin(w0 z)`` on the first layer, ``sin(z)`` after) or
    ``"relu"``.  Each output row depends on its own input row alone, so a
    gradient of the summed output is the per-point gradient."""
    _check_activation(activation)
    layers = list(params)
    bf16 = compute_dtype == torch.bfloat16
    relu = activation == "relu"
    h = x
    for i, (W, b) in enumerate(layers[:-1]):
        z = (_bf16_product(h, W) if bf16 else torch.matmul(h, W)) + b
        h = torch.relu(z) if relu else torch.sin((w0 if i == 0 else 1.0) * z)
    W, b = layers[-1]
    if bf16:
        h = _round_bf16(h)
    return (torch.matmul(h, W) + b)[..., 0]


def _value_and_grad(fn: Callable[[torch.Tensor], torch.Tensor], pts: torch.Tensor,
                    *inputs: torch.Tensor):
    """``(fn(pts), ∂fn(pts)/∂pts)`` per point (each output depends on its
    own point alone).  When grad mode is on and ``pts`` or one of
    ``inputs`` needs grad, both outputs stay differentiable; otherwise they
    are detached and the graph is freed."""
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in (pts,) + inputs)
    with torch.enable_grad():
        p = pts if keep and pts.requires_grad else pts.detach().requires_grad_(True)
        val = fn(p)
        (grad,) = torch.autograd.grad(val.sum(), p, create_graph=keep)
    return (val, grad) if keep else (val.detach(), grad)


# ---------------------------------------------------------------------------
# dataset: distillation samples from an exact SDF
# ---------------------------------------------------------------------------

class _Draws(NamedTuple):
    """The random inputs of :func:`_sample_dataset`."""
    uniform: torch.Tensor   # [n_uniform, 3] points in the box
    seeds: torch.Tensor     # [n_near, 3] points in the box, projected to the surface
    noise: torch.Tensor     # [n_near, 1] standard normal offsets along the gradient
    perm: torch.Tensor      # [n_uniform + n_near] shuffle


def _uniform(gen: torch.Generator, shape, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return u.to(lo.device) * (hi - lo) + lo


def _dataset_draws(gen: torch.Generator, bounds: np.ndarray, n_uniform: int,
                   n_near: int, device: torch.device) -> _Draws:
    lo = torch.as_tensor(bounds[:, 0], dtype=torch.float32, device=device)
    hi = torch.as_tensor(bounds[:, 1], dtype=torch.float32, device=device)
    uniform = _uniform(gen, (n_uniform, 3), lo, hi)
    seeds = _uniform(gen, (n_near, 3), lo, hi)
    noise = torch.randn((n_near, 1), generator=gen, device=gen.device).to(device)
    perm = torch.randperm(n_uniform + n_near, generator=gen, device=gen.device).to(device)
    return _Draws(uniform, seeds, noise, perm)


@torch.no_grad()
def _sample_dataset(gt_sdf, draws: _Draws, bounds: np.ndarray, near_sigma: float):
    """(points, values, gradients) from ``gt_sdf``: the uniform points in
    the padded box, and near-surface points made by projecting the seed
    points onto the surface along the exact gradient and moving them
    ``near_sigma * noise`` along it (the thin shell where accuracy matters
    most), shuffled by ``draws.perm``."""
    dev = draws.uniform.device
    lo = torch.as_tensor(bounds[:, 0], dtype=torch.float32, device=dev)
    hi = torch.as_tensor(bounds[:, 1], dtype=torch.float32, device=dev)
    vu, gu = gt_sdf.raw_query(draws.uniform)
    if draws.seeds.shape[0]:
        vs, gs = gt_sdf.raw_query(draws.seeds)
        surf = draws.seeds - vs[:, None] * gs
        xn = torch.clamp(surf + (near_sigma * draws.noise) * gs, lo, hi)
        vn, gn = gt_sdf.raw_query(xn)
        x = torch.cat([draws.uniform, xn])
        v = torch.cat([vu, vn])
        g = torch.cat([gu, gn])
    else:
        x, v, g = draws.uniform, vu, gu
    return x[draws.perm], v[draws.perm], g[draws.perm]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _loss(params, feats_fn, pts, d, dg, grad_weight: float, w0: float, compute_dtype,
          activation: str) -> torch.Tensor:
    """``mean |f - d|² + grad_weight · mean |∂f/∂x[-3:] - ∇d|²``; only the
    last 3 input components (the point) are supervised."""
    pts = pts.detach().requires_grad_(True)
    f = mlp_forward(params, feats_fn(pts), w0=w0, compute_dtype=compute_dtype,
                    activation=activation)
    (fg,) = torch.autograd.grad(f.sum(), pts, create_graph=True)
    return (torch.mean((f - d) ** 2)
            + grad_weight * torch.mean(torch.sum((fg[..., -3:] - dg) ** 2, dim=-1)))


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float = 1.0):
    """optax's ``clip_by_global_norm``: unchanged below the norm, else
    ``g / norm * max_norm`` (no epsilon)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def _cosine_lr(lr: float, steps: int, t: int, alpha: float = 0.05) -> float:
    """optax's ``cosine_decay_schedule(lr, steps, alpha)`` at update ``t``
    (0 at the first update)."""
    t = min(t, steps)
    return lr * ((1.0 - alpha) * (0.5 * (1.0 + math.cos(math.pi * t / steps))) + alpha)


class _Adam:
    """optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
    root), applied in place to ``params``."""

    def __init__(self, params: List[torch.Tensor], b1=0.9, b2=0.999, eps=1e-8):
        self.params = params
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        b1, b2 = self.b1, self.b2
        self.mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                     torch._foreach_mul(self.mu, b1))
        self.nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                                     torch._foreach_mul(self.nu, b2))
        self.count += 1
        # bias corrections in float32, as optax takes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(self.nu, bc2)), self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_add_(self.params, torch._foreach_mul(upd, -lr))


def _fit(params: MLP, feats_fn, key: Key, x, v, g, steps: int, batch: int, lr: float,
         grad_weight: float, w0: float, compute_dtype, activation: str = "sine"):
    """Adam on :func:`_loss` over random minibatches of ``(x, v, g)``, with
    optax's ``chain(clip_by_global_norm(1.0), adam(cosine_decay_schedule(lr,
    steps, alpha=0.05)))``.  ``x [N, D]`` may carry extra leading input
    components (the joint values of the config-space model).  Updates
    ``params`` in place and returns ``(params, losses [steps])``; the
    losses stay on the device until the caller reads them.  The minibatch
    indices come from ``key`` on its device."""
    gen = _generator(key, x.device)
    tensors = list(params.parameters())
    opt = _Adam(tensors)
    N = x.shape[0]
    losses = []
    for t in range(steps):
        idx = torch.randint(0, N, (batch,), generator=gen, device=gen.device).to(x.device)
        loss = _loss(params, feats_fn, x[idx], v[idx], g[idx], grad_weight, w0,
                     compute_dtype, activation)
        grads = torch.autograd.grad(loss, tensors)
        opt.step(_clip_by_global_norm(list(grads)), _cosine_lr(lr, steps, t))
        losses.append(loss.detach())
    return params, torch.stack(losses) if losses else torch.zeros(0, device=x.device)


# ---------------------------------------------------------------------------
# single-object model
# ---------------------------------------------------------------------------

def _as_mlp(params, device) -> MLP:
    return params if isinstance(params, MLP) or params is None else MLP(
        [(as_float_tensor(W, device), as_float_tensor(b, device)) for W, b in params])


class NeuralSDF(ObjectFrameSDF):
    """MLP SDF ``f(x) -> d`` (build with :func:`fit_neural_sdf`), on the
    device of its weights.  ``raw_query`` returns the autograd gradient of
    the learned field."""

    # learned fields are not eikonal between training samples: a debug
    # check of gradient norms reads this instead of the unit bound
    max_grad_norm_hint = 10.0

    def __init__(self, params, fourier_B, bounds, w0: float = 30.0,
                 compute_dtype=torch.float32, activation: str = "sine"):
        self.params = _as_mlp(params, None)
        self.device = self.params.device
        self.fourier_B = as_float_tensor(fourier_B, self.device)
        self.bounds = np.asarray(bounds)
        self.w0 = w0
        self.activation = activation
        self.compute_dtype = compute_dtype

    def _features(self, pts):
        return fourier_features(pts, self.fourier_B)

    def value(self, pts: torch.Tensor) -> torch.Tensor:
        """Values only: one forward pass."""
        return mlp_forward(self.params, self._features(pts), w0=self.w0,
                           compute_dtype=self.compute_dtype, activation=self.activation)

    def raw_query(self, points):
        return _value_and_grad(self.value, points)

    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0):
        return torch.as_tensor(pad_aabb(self.bounds, padding, padding_ratio),
                               dtype=torch.float32, device=self.device)

    def save(self, path: str) -> None:
        """Weights and metadata to ``.npz`` (the JAX package's format)."""
        np.savez_compressed(path, kind="neural_sdf", w0=self.w0, activation=self.activation,
                            fourier_B=self.fourier_B.cpu().numpy(), bounds=self.bounds,
                            bf16=self.compute_dtype == torch.bfloat16,
                            **_params_to_arrays(self.params))

    @classmethod
    def load(cls, path: str, device=None) -> "NeuralSDF":
        """A model from :meth:`save`'s npz (either package's) on ``device``
        (CUDA unless given)."""
        with np.load(path, allow_pickle=False) as d:
            _check_kind(d, "neural_sdf", path)
            return cls(_params_from_arrays(d, device), d["fourier_B"], np.asarray(d["bounds"]),
                       w0=float(d["w0"]), compute_dtype=_dtype(d),
                       activation=str(d["activation"]) if "activation" in d else "sine")


def _dtype(d) -> torch.dtype:
    return torch.bfloat16 if bool(d["bf16"]) else torch.float32


def fit_neural_sdf(gt_sdf: ObjectFrameSDF, key: Key, padding: float = 0.1,
                   width: int = 128, depth: int = 4, fourier: int = 64,
                   fourier_scale: float = 1.5, w0: float = 30.0,
                   n_samples: int = 200_000, near_fraction: float = 0.5,
                   near_sigma: float = 0.02, steps: int = 2000,
                   batch: int = 8192, lr: float = 2e-4,
                   grad_weight: float = 0.1, compute_dtype=torch.float32,
                   activation: str = "sine", device=None) -> Tuple[NeuralSDF, torch.Tensor]:
    """Distill ``gt_sdf`` into a :class:`NeuralSDF`; returns ``(model,
    per-step losses)``.

    The oracle is queried once for an ``n_samples``-point dataset
    (``near_fraction`` of it in a ``near_sigma``-thick shell around the
    surface), then training is MLP work alone.  Runs on ``device`` (CUDA
    unless given), where the oracle must live; every random draw comes from
    ``key`` (a seed or a ``torch.Generator``)."""
    dev = resolve_device(device)
    _check_oracle_device(gt_sdf.device, dev)
    gen = _generator(key, dev)
    bounds = gt_sdf.surface_bounding_box(padding=padding).detach().cpu().numpy()
    extent = float(np.max(bounds[:, 1] - bounds[:, 0]))
    B = fourier_scale / extent * torch.randn((3, fourier), generator=gen,
                                             device=gen.device).to(dev)
    n_near = int(n_samples * near_fraction)
    draws = _dataset_draws(gen, bounds, n_samples - n_near, n_near, dev)
    x, v, g = _sample_dataset(gt_sdf, draws, bounds, near_sigma)
    params = mlp_init(gen, 2 * fourier, width, depth, w0=w0, activation=activation, device=dev)
    params, losses = _fit(params, lambda pts: fourier_features(pts, B), gen, x, v, g, steps,
                          batch, lr, grad_weight, w0, compute_dtype, activation)
    return NeuralSDF(params, B, bounds, w0=w0, compute_dtype=compute_dtype,
                     activation=activation), losses


# ---------------------------------------------------------------------------
# configuration-space robot model
# ---------------------------------------------------------------------------

class ConfigSpaceNeuralSDF:
    """Joint-conditioned robot SDF ``f(q, x) -> d``, distilled from an
    exact :class:`~pytorch_volumetric_tpu_torch.model_to_sdf.RobotSDF`
    oracle (build with :func:`fit_config_space_sdf`).

    The query API mirrors ``RobotSDF``: ``set_joint_configuration([A×]M)``
    then ``__call__(pts [B×]N×3) -> (val [A×][B×]N, grad …×3)``.  A query
    runs no FK, no per-link union and no gather, and is differentiable in
    ``q`` through autograd.  Lives on the device of its weights (or
    ``device`` while it has none)."""

    def __init__(self, params, fourier_B, q_lo, q_hi, bounds, w0: float = 30.0,
                 compute_dtype=torch.float32, activation: str = "sine", device=None):
        self.params = _as_mlp(params, device)
        self.device = self.params.device if self.params is not None else resolve_device(device)
        self.fourier_B = as_float_tensor(fourier_B, self.device)
        self.q_lo = as_float_tensor(q_lo, self.device)
        self.q_hi = as_float_tensor(q_hi, self.device)
        self.bounds = np.asarray(bounds)
        self.w0 = w0
        self.activation = activation
        self.compute_dtype = compute_dtype
        self._q = None

    # -- core field ---------------------------------------------------------
    def _features(self, q, pts):
        # joints normalized to [-1, 1] (a locked joint's zero span is
        # clamped: it then gives a constant feature, not NaN), the point
        # Fourier-lifted; q and the points broadcast against each other
        span = torch.clamp(self.q_hi - self.q_lo, min=1e-6)
        qn = 2.0 * (q - self.q_lo) / span - 1.0
        ff = fourier_features(pts, self.fourier_B)
        batch = torch.broadcast_shapes(qn.shape[:-1], pts.shape[:-1])
        return torch.cat([qn.expand(batch + qn.shape[-1:]), ff.expand(batch + ff.shape[-1:])],
                         dim=-1)

    def value(self, q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        """``f(q [.., M], pts [.., 3]) -> [..]`` (leading dims broadcast),
        values only: one forward pass."""
        return mlp_forward(self.params, self._features(q, pts), w0=self.w0,
                           compute_dtype=self.compute_dtype, activation=self.activation)

    def query(self, q: torch.Tensor, pts: torch.Tensor):
        """``(q [A, M], pts [N, 3]) -> (val [A, N], grad [A, N, 3])`` with
        each configuration's own spatial gradient (every configuration takes
        its own copy of the points).  Differentiable w.r.t. ``q`` and the
        points when they need grad."""
        q = as_float_tensor(q, self.device)
        pts = as_float_tensor(pts, self.device)
        rows = pts.unsqueeze(0).expand(q.shape[0], pts.shape[0], pts.shape[-1])
        return _value_and_grad(lambda p: self.value(q[:, None, :], p), rows, q)

    # -- RobotSDF-compatible surface ---------------------------------------
    def set_joint_configuration(self, joint_config):
        """Accepts ``[A×]M`` like ``RobotSDF.set_joint_configuration``."""
        self._q = as_float_tensor(joint_config, self.device)
        return self

    def __call__(self, points_in_object_frame):
        """``RobotSDF.__call__``'s shape contract: a 1-D configuration gives
        ``[B×]N`` outputs, an ``[A×]M`` one ``[A×][B×]N``."""
        if self._q is None:
            raise RuntimeError("call set_joint_configuration first")
        pts = as_float_tensor(points_in_object_frame, self.device)
        pts_batch = pts.shape[:-1]
        A = self._q.shape[:-1]
        val, grad = self.query(self._q.reshape(-1, self._q.shape[-1]), pts.reshape(-1, 3))
        return val.reshape(A + pts_batch), grad.reshape(A + pts_batch + (3,))

    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0):
        return torch.as_tensor(pad_aabb(self.bounds, padding, padding_ratio),
                               dtype=torch.float32, device=self.device)

    def at_config(self, joint_config) -> "_ConfigBoundSDF":
        """The field at one configuration ``[M]`` as an
        :class:`~pytorch_volumetric_tpu_torch.sdf.ObjectFrameSDF` (slices,
        voxel views, filtered points, chamfer metrics work on it)."""
        q = as_float_tensor(joint_config, self.device)
        if q.ndim != 1:
            raise ValueError(f"at_config takes a single [M] configuration, "
                             f"got shape {tuple(q.shape)}")
        return _ConfigBoundSDF(self, q)

    def save(self, path: str) -> None:
        """Weights and metadata to ``.npz`` (the JAX package's format)."""
        np.savez_compressed(path, kind="config_space_neural_sdf", w0=self.w0,
                            activation=self.activation,
                            fourier_B=self.fourier_B.cpu().numpy(),
                            q_lo=self.q_lo.cpu().numpy(), q_hi=self.q_hi.cpu().numpy(),
                            bounds=self.bounds, bf16=self.compute_dtype == torch.bfloat16,
                            **_params_to_arrays(self.params))

    @classmethod
    def load(cls, path: str, device=None) -> "ConfigSpaceNeuralSDF":
        """A model from :meth:`save`'s npz (either package's) on ``device``
        (CUDA unless given)."""
        with np.load(path, allow_pickle=False) as d:
            _check_kind(d, "config_space_neural_sdf", path)
            return cls(_params_from_arrays(d, device), d["fourier_B"], d["q_lo"], d["q_hi"],
                       np.asarray(d["bounds"]), w0=float(d["w0"]), compute_dtype=_dtype(d),
                       activation=str(d["activation"]) if "activation" in d else "sine")


class _ConfigBoundSDF(ObjectFrameSDF):
    """``ConfigSpaceNeuralSDF`` pinned to one joint configuration (see
    :meth:`ConfigSpaceNeuralSDF.at_config`)."""

    max_grad_norm_hint = NeuralSDF.max_grad_norm_hint

    def __init__(self, model: ConfigSpaceNeuralSDF, q: torch.Tensor):
        self.model = model
        self.q = q
        self.device = model.device

    def raw_query(self, points):
        return _value_and_grad(lambda p: self.model.value(self.q, p), points, self.q)

    def surface_bounding_box(self, padding=0.0, padding_ratio=0.0):
        return self.model.surface_bounding_box(padding=padding, padding_ratio=padding_ratio)


@torch.no_grad()
def _config_space_samples(robot_sdf, qs, uniform, seeds, noise, lo, hi, near_sigma: float):
    """The oracle sweep of :func:`fit_config_space_sdf` on given draws:
    ``uniform [n_uni, 3]`` points shared by every configuration, and per
    configuration ``qs[a]`` the ``seeds [n_near, 3]`` projected onto its
    surface along the exact gradient and moved ``near_sigma * noise[a]``
    along it, clamped to ``[lo, hi]``.  Returns ``(vu [A, n_uni], gu,
    xn [A, n_near, 3], vn, gn)``."""
    vu, gu = robot_sdf.query(qs, uniform)
    vs, gs = robot_sdf.query(qs, seeds)
    surf = seeds[None] - vs[..., None] * gs
    xn = torch.clamp(surf + (near_sigma * noise) * gs, lo, hi)
    vn, gn = _per_config_query(robot_sdf, qs, xn)
    return vu, gu, xn, vn, gn


def fit_config_space_sdf(robot_sdf, key: Key, joint_limits=None, workspace_bounds=None,
                         padding: float = 0.2, width: int = 256, depth: int = 5,
                         fourier: int = 96, fourier_scale: float = 1.5, w0: float = 30.0,
                         n_configs: int = 256, pts_per_config: int = 2048,
                         near_fraction: float = 0.5, near_sigma: float = 0.02,
                         steps: int = 4000, batch: int = 8192, lr: float = 2e-4,
                         grad_weight: float = 0.1, compute_dtype=torch.float32,
                         activation: str = "sine", device=None
                         ) -> Tuple[ConfigSpaceNeuralSDF, torch.Tensor]:
    """Distill a ``RobotSDF`` into a :class:`ConfigSpaceNeuralSDF`; returns
    ``(model, per-step losses)``.

    ``joint_limits [M, 2]`` default to the chain's limits (±π where
    absent); ``workspace_bounds [3, 2]`` to the union box over the sampled
    configurations, padded.  The oracle is queried once, batched over the
    configurations, then training is MLP work alone.  The robot's joint
    configuration is restored afterwards, also when the sweep raises.
    Runs on ``device`` (CUDA unless given), where the robot must live;
    every random draw comes from ``key`` (a seed or a ``torch.Generator``)."""
    dev = resolve_device(device)
    _check_oracle_device(robot_sdf.device, dev)
    gen = _generator(key, dev)
    if joint_limits is None:
        joint_limits = robot_sdf.chain.get_joint_limits()
    joint_limits = np.asarray(joint_limits, dtype=np.float32)
    q_lo, q_hi = joint_limits[:, 0], joint_limits[:, 1]
    M = q_lo.shape[0]
    qs = _uniform(gen, (n_configs, M), torch.as_tensor(q_lo, device=dev),
                  torch.as_tensor(q_hi, device=dev))

    q_prev = getattr(robot_sdf, "q", None)
    robot_sdf.set_joint_configuration(qs)
    try:
        if workspace_bounds is None:
            bb = robot_sdf.surface_bounding_box().detach().cpu().numpy()  # [A, 3, 2]
            workspace_bounds = np.stack([bb[..., 0].min(axis=0) - padding,
                                         bb[..., 1].max(axis=0) + padding], -1)
        workspace_bounds = np.asarray(workspace_bounds, dtype=np.float32)
        lo = torch.as_tensor(workspace_bounds[:, 0], device=dev)
        hi = torch.as_tensor(workspace_bounds[:, 1], device=dev)
        n_near = int(pts_per_config * near_fraction)
        n_uni = pts_per_config - n_near
        uniform = _uniform(gen, (n_uni, 3), lo, hi)
        seeds = _uniform(gen, (n_near, 3), lo, hi)
        noise = torch.randn((n_configs, n_near, 1), generator=gen, device=gen.device).to(dev)
        vu, gu, xn, vn, gn = _config_space_samples(robot_sdf, qs, uniform, seeds, noise,
                                                   lo, hi, near_sigma)
    finally:
        robot_sdf.set_joint_configuration(q_prev)

    x = torch.cat([uniform.expand(n_configs, n_uni, 3), xn], dim=1).reshape(-1, 3)
    v = torch.cat([vu, vn], dim=1).reshape(-1)
    g = torch.cat([gu, gn], dim=1).reshape(-1, 3)
    qflat = qs[:, None].expand(n_configs, pts_per_config, M).reshape(-1, M)

    extent = float(np.max(workspace_bounds[:, 1] - workspace_bounds[:, 0]))
    B = fourier_scale / extent * torch.randn((3, fourier), generator=gen,
                                             device=gen.device).to(dev)
    model = ConfigSpaceNeuralSDF(None, B, q_lo, q_hi, workspace_bounds, w0=w0,
                                 compute_dtype=compute_dtype, activation=activation, device=dev)
    params = mlp_init(gen, M + 2 * fourier, width, depth, w0=w0, activation=activation,
                      device=dev)
    # the joint values ride in front of the point: one generic fit over (q, x)
    qx = torch.cat([qflat, x], dim=-1)
    params, losses = _fit(params, lambda b: model._features(b[..., :M], b[..., M:]), gen,
                          qx, v, g, steps, batch, lr, grad_weight, w0, compute_dtype,
                          activation)
    model.params = params
    return model, losses


def _per_config_query(robot_sdf, qs: torch.Tensor, pts: torch.Tensor):
    """Row ``a`` of ``pts [A, P, 3]`` under configuration ``qs[a]`` alone
    (the diagonal of the configurations × points product): one min-union
    over the per-configuration rows, O(A·P), not the O(A²·P) of
    ``RobotSDF.query``.  Returns ``(val [A, P], grad [A, P, 3])``."""
    queries = tuple(partial(s.raw_query_with, s.raw_query_aux()) for s in robot_sdf.sdf.sdfs)
    m, m_inv = robot_sdf._link_transforms(qs)
    return compose_query(queries, m, m_inv, qs.shape[0], pts)
