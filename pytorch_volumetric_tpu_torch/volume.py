"""AABB membership test."""

from __future__ import annotations

import torch

from pytorch_volumetric_tpu_torch.utils.batching import resolve_device


def is_inside(points, range_per_dim, device=None) -> torch.Tensor:
    """Whether each of ``points [N, d]`` lies inside ``range_per_dim [d, 2]``
    (min, max per row), as ``[N]`` bool.

    The comparison runs in the caller's dtypes: float64 points stay float64
    (a float32 cast would flip strict containment within float32's epsilon
    of a bound), and integer points against a float range promote rather
    than truncate the bounds.  A tensor stays on its device; anything else
    goes to ``device`` (CUDA unless given)."""
    if not isinstance(points, torch.Tensor):
        points = torch.as_tensor(points, device=resolve_device(device))
    rng = torch.as_tensor(range_per_dim, device=points.device)
    return ((rng[:, 0] <= points) & (points <= rng[:, 1])).all(dim=-1)
