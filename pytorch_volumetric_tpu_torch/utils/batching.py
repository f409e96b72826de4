"""Shape, padding and device helpers shared by the whole package."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

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


# XLA's float -> int32 conversion saturates at these bounds (2^31 is
# exact in float32; int32's largest value is not)
_INT32_LO, _INT32_HI = -2.0 ** 31, 2.0 ** 31


def float_keys(x: torch.Tensor, n: Union[torch.Tensor, None] = None) -> torch.Tensor:
    """Integer keys (int64) of a float tensor that is already rounded or
    floored, converted as the JAX package's keys are: XLA's float -> int
    ``convert`` maps NaN to 0 and saturates.  With ``n`` (the grid's
    extent, broadcast against ``x``) the keys are clamped to ``[-1, n]``,
    which keeps every in-grid / out-of-grid decision ``0 <= k < n``;
    without it to int32's range, exactly XLA's conversion to int32.  The
    same on every device (a raw ``.to(torch.int64)`` of NaN gives INT64_MIN
    on x86 and 0 on CUDA)."""
    x = torch.nan_to_num(x, nan=0.0)
    if n is not None:
        return torch.minimum(x.clamp(min=-1.0), n.to(x.dtype)).to(torch.int64)
    return x.clamp(_INT32_LO, _INT32_HI).to(torch.int64).clamp(max=2 ** 31 - 1)


def flatten_batch(x: torch.Tensor, event_ndim: int = 1
                  ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """Flatten all leading dims of ``x`` except the last ``event_ndim``.

    Returns the flattened tensor and an ``unflatten(y)`` that restores the
    leading batch shape on an output whose own event dims may differ.
    """
    batch_shape = tuple(x.shape[: x.ndim - event_ndim])
    event_shape = tuple(x.shape[x.ndim - event_ndim:])
    flat = x.reshape((-1,) + event_shape) if batch_shape else x.reshape((1,) + event_shape)

    def unflatten(y: torch.Tensor, batch_shape=batch_shape) -> torch.Tensor:
        out_event = tuple(y.shape[1:])
        if batch_shape:
            return y.reshape(batch_shape + out_event)
        return y.reshape(out_event)

    return flat, unflatten


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


def np_pad_to(x: np.ndarray, size: int, axis: int = 0, value=0.0) -> np.ndarray:
    """Pad a numpy array along ``axis`` up to ``size`` with ``value``."""
    cur = x.shape[axis]
    if cur == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, size - cur)
    return np.pad(x, pad, constant_values=value)


def flatten_tensors(tree) -> Tuple[List[torch.Tensor], Any]:
    """The tensors of a nest of tuples / named tuples (``None`` and other
    values allowed) in a fixed order, and the spec that
    :func:`unflatten_tensors` rebuilds the nest from."""
    leaves, spec = pytree.tree_flatten(tree)
    where = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    rest = [None if isinstance(x, torch.Tensor) else x for x in leaves]
    return [leaves[i] for i in where], (spec, where, rest)


def unflatten_tensors(spec, tensors):
    """The nest :func:`flatten_tensors` took apart, with ``tensors`` in
    its tensors' places."""
    tree_spec, where, rest = spec
    if len(tensors) != len(where):
        raise ValueError(f"{len(tensors)} tensors for a nest of {len(where)}")
    leaves = list(rest)
    for i, t in zip(where, tensors):
        leaves[i] = t
    return pytree.tree_unflatten(leaves, tree_spec)
