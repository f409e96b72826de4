"""Shape, padding and device helpers shared by the whole package."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Asking for CUDA on a machine without a GPU raises instead of
    quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pytorch_volumetric_tpu_torch runs on CUDA by default and no "
            "CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def as_float_tensor(x, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Coerce lists / numpy arrays / tensors to a float tensor on ``device``
    (``None`` keeps a tensor where it is and puts anything else on CUDA).
    Tensors keep their autograd history."""
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else device, dtype=dtype)
    arr = np.asarray(x, dtype=np.float32 if dtype == torch.float32 else None)
    return torch.as_tensor(arr, dtype=dtype, device=resolve_device(device))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def pad_to(x: torch.Tensor, size: int, axis: int = 0,
           value: float = 0.0) -> torch.Tensor:
    """Pad ``x`` along ``axis`` up to ``size`` with ``value``."""
    cur = x.shape[axis]
    if cur == size:
        return x
    pad_shape = list(x.shape)
    pad_shape[axis] = size - cur
    pad = torch.full(pad_shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=axis)
