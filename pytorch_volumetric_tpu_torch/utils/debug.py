"""Runtime self-checks of SDF queries that stay on the device.

``CachedSDF(debug_check_sdf=True)`` checks a lookup against its ground
truth on the host after each call.  This module adds guards that run as
tensor ops beside the query: finite points, finite values, finite
gradients and gradient norms within a bound.  They build an error code on
the device, so a hot loop pays no host sync until it asks for the result.

>>> checked = checked_query(sdf)            # raises QueryCheckError
>>> val, grad = checked(points)

With ``throw=False`` the error comes back as a value (no host sync):

>>> err, (val, grad) = checked_query(sdf, throw=False)(points)
>>> err.throw()   # or inspect err.get()

The first failing guard, in the order above, is the one reported, with
the JAX package's message text.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# SDF gradients are unit directions (analytic paths) or interpolations of
# unit directions (trilinear caches), so anything much above 1 is a bug.
# Learned fields (models.NeuralSDF) are not eikonal between training
# samples; they advertise a looser bound in their ``max_grad_norm_hint``
# class attribute, which checked_query honours when not given a bound.
DEFAULT_MAX_GRAD_NORM = 1.0 + 1e-3

# the guards in the order they are checked (code i + 1); the gradient
# norm's message is formatted with the largest norm
_MESSAGES = ("non-finite query points", "non-finite SDF values", "non-finite SDF gradients",
             "SDF gradient norm {m} exceeds the unit-direction bound")


class QueryCheckError(ValueError):
    """A guard of :func:`guarded_raw_query` failed."""


class QueryCheck:
    """The outcome of the guards, as device tensors: ``code`` (0 when every
    guard passed, else the first failing guard's number) and the largest
    gradient norm.  Reading it (:meth:`get`, :meth:`throw`) syncs once."""

    def __init__(self, code: torch.Tensor, max_norm: torch.Tensor):
        self.code = code
        self.max_norm = max_norm

    def get(self) -> Optional[str]:
        """The first failing guard's message, or None (the norm printed as
        the JAX package prints its float32 value)."""
        code, m = torch.stack([self.code.to(self.max_norm.dtype), self.max_norm]).tolist()
        if code == 0:
            return None
        return _MESSAGES[int(code) - 1].format(m=m)

    def throw(self) -> None:
        """Raise :class:`QueryCheckError` if a guard failed."""
        msg = self.get()
        if msg is not None:
            raise QueryCheckError(msg)


def guarded_raw_query(raw_query: Callable,
                      max_grad_norm: float = DEFAULT_MAX_GRAD_NORM) -> Callable:
    """Wrap ``raw_query(pts) -> (val, grad)`` with the guards: returns
    ``fn(pts) -> (QueryCheck, (val, grad))``, with no host sync."""

    def checked(pts):
        val, grad = raw_query(pts)
        gn = torch.linalg.vector_norm(grad, dim=-1)
        failed = torch.stack([~torch.isfinite(pts).all(), ~torch.isfinite(val).all(),
                              ~torch.isfinite(grad).all(), ~(gn <= max_grad_norm).all()])
        # the first failing guard's number (argmax takes the first True),
        # 0 when none failed
        code = torch.where(failed.any(), failed.to(torch.int32).argmax() + 1, 0)
        max_norm = gn.detach().amax() if gn.numel() else gn.new_zeros(())
        return QueryCheck(code, max_norm), (val, grad)

    return checked


def checked_query(sdf, max_grad_norm: Optional[float] = None,
                  throw: bool = True) -> Callable:
    """Self-checking ``sdf.raw_query`` (any ``ObjectFrameSDF``, or a bare
    ``raw_query(pts) -> (val, grad)`` callable).

    With ``throw=True`` returns ``fn(pts) -> (val, grad)`` that raises
    :class:`QueryCheckError` when a guard fails (one host sync per call).
    With ``throw=False`` returns ``fn(pts) -> (err, (val, grad))``, ``err``
    a :class:`QueryCheck` on the device: no host sync until it is read.

    ``max_grad_norm`` defaults to the SDF's ``max_grad_norm_hint`` (learned
    fields set a loose bound), else the unit-direction bound exact fields
    satisfy.  An SDF with big tables (``raw_query_aux``) is queried through
    ``raw_query_with`` with its tables as arguments."""
    if max_grad_norm is None:
        max_grad_norm = getattr(sdf, "max_grad_norm_hint", DEFAULT_MAX_GRAD_NORM)
    aux = sdf.raw_query_aux() if hasattr(sdf, "raw_query_aux") else None
    if aux is not None:
        def raw(pts):
            return sdf.raw_query_with(aux, pts)
    else:
        raw = sdf.raw_query if hasattr(sdf, "raw_query") else sdf
    fn = guarded_raw_query(raw, max_grad_norm)
    if not throw:
        return fn

    def run(pts):
        err, out = fn(pts)
        err.throw()
        return out

    return run
