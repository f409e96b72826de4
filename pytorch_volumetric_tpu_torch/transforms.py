"""Rigid-transform and rotation utilities (batched, differentiable tensors).

Column-vector convention, arbitrary leading batch dimensions::

    p_world = R @ p_local + t        # matrix = [[R, t], [0, 1]]

All math is true float32: point transforms and rotations are written out
elementwise, and the 4x4 products go through ``torch.matmul`` in float32,
which stays full precision as long as TF32 is never enabled
(``torch.backends.cuda.matmul.allow_tf32`` is False by default).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pytorch_volumetric_tpu_torch.utils.batching import (
    as_float_tensor, resolve_device)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product for transform chains (float32, broadcasting)."""
    return torch.matmul(a, b)


def precise_einsum(spec: str, *args: torch.Tensor) -> torch.Tensor:
    """Einsum for transform contractions, in true float32 (TF32 off)."""
    return torch.einsum(spec, *args)


# ---------------------------------------------------------------------------
# Rotation conversions
# ---------------------------------------------------------------------------

def quaternion_to_matrix(quat_wxyz: torch.Tensor) -> torch.Tensor:
    """Unit quaternions ``[..., 4]`` (w, x, y, z) -> rotations ``[..., 3, 3]``."""
    q = quat_wxyz
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quaternion_xyzw_to_matrix(quat_xyzw: torch.Tensor) -> torch.Tensor:
    """Quaternions in (x, y, z, w) order -> rotations ``[..., 3, 3]``."""
    q = quat_xyzw
    return quaternion_to_matrix(torch.stack(
        [q[..., 3], q[..., 0], q[..., 1], q[..., 2]], dim=-1))


def _axis_rotation(angle: torch.Tensor, axis: str) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == "X":
        rows = [one, zero, zero, zero, c, -s, zero, s, c]
    elif axis == "Y":
        rows = [c, zero, s, zero, one, zero, -s, zero, c]
    else:
        rows = [c, -s, zero, s, c, zero, zero, zero, one]
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(angles: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Product of per-axis rotations ``R0 @ R1 @ R2`` for a convention such
    as "XYZ", angles ``[..., 3]`` (``pytorch_kinematics`` semantics)."""
    ms = [_axis_rotation(angles[..., i], convention[i]) for i in range(3)]
    return mm(mm(ms[0], ms[1]), ms[2])


def rpy_to_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """URDF roll-pitch-yaw (fixed-axis XYZ): R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    a = rpy
    return mm(mm(_axis_rotation(a[..., 2], "Z"), _axis_rotation(a[..., 1], "Y")),
              _axis_rotation(a[..., 0], "X"))


def axis_angle_to_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula; ``axis [..., 3]`` (need not be normalized),
    ``angle [...]`` -> ``[..., 3, 3]``."""
    u = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
                           min=1e-12)
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    zero = torch.zeros_like(ux)
    K = torch.stack([zero, -uz, uy, uz, zero, -ux, -uy, ux, zero],
                    dim=-1).reshape(u.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=u.dtype, device=u.device).expand(K.shape)
    outer = u[..., :, None] * u[..., None, :]
    return c * eye + s * K + (1.0 - c) * outer


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """First two rows of rotation matrices ``[..., 3, 3]`` flattened to
    ``[..., 6]`` (the continuous rotation representation)."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


# ---------------------------------------------------------------------------
# Homogeneous 4x4 transform operations
# ---------------------------------------------------------------------------

def make_tf(pos: Optional[torch.Tensor] = None,
            rot: Optional[torch.Tensor] = None,
            dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Build ``[..., 4, 4]`` from a translation ``[..., 3]`` and/or a rotation
    given as a matrix ``[..., 3, 3]`` or quaternion ``[..., 4]`` (w,x,y,z)."""
    ref = rot if rot is not None else pos
    if device is None:
        device = ref.device if isinstance(ref, torch.Tensor) else None
    if rot is None:
        R = torch.eye(3, dtype=dtype, device=device)
    else:
        rot = as_float_tensor(rot, device, dtype)
        R = (rot if rot.ndim >= 2 and rot.shape[-2:] == (3, 3)
             else quaternion_to_matrix(rot))
    if pos is None:
        t = torch.zeros(3, dtype=dtype, device=R.device)
    else:
        t = as_float_tensor(pos, R.device, dtype)
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    m = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=m.dtype, device=m.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([m, bottom], dim=-2)


def invert_tf(matrix: torch.Tensor) -> torch.Tensor:
    """Invert rigid transforms through the [R, t] block structure
    (R^T, -R^T t)."""
    m = matrix
    R = m[..., :3, :3]
    t = m[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -(Rt[..., :, 0] * t[..., None, 0] + Rt[..., :, 1] * t[..., None, 1]
              + Rt[..., :, 2] * t[..., None, 2])
    out = torch.cat([Rt, t_inv[..., :, None]], dim=-1)
    bottom = torch.zeros(m.shape[:-2] + (1, 4), dtype=m.dtype, device=m.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([out, bottom], dim=-2)


def compose_tf(*matrices: torch.Tensor) -> torch.Tensor:
    """compose(A, B) maps p -> A @ (B @ p): the plain product A @ B."""
    out = matrices[0]
    for m in matrices[1:]:
        out = mm(out, m)
    return out


def transform_points(matrix: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply ``[..., 4, 4]`` to points ``[..., N, 3]`` (batch dims
    broadcast): ``p' = R p + t``, written out elementwise."""
    m = matrix
    p = points.to(m.dtype)
    R = m[..., None, :3, :3]       # [..., 1, 3, 3]
    t = m[..., None, :3, 3]        # [..., 1, 3]
    out = torch.stack([
        R[..., 0, 0] * p[..., 0] + R[..., 0, 1] * p[..., 1]
        + R[..., 0, 2] * p[..., 2],
        R[..., 1, 0] * p[..., 0] + R[..., 1, 1] * p[..., 1]
        + R[..., 1, 2] * p[..., 2],
        R[..., 2, 0] * p[..., 0] + R[..., 2, 1] * p[..., 1]
        + R[..., 2, 2] * p[..., 2],
    ], dim=-1)
    return out + t


def rotate_vectors(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3] x [..., N, 3] -> [..., N, 3]`` rotation, elementwise."""
    R = R[..., None, :, :]
    return torch.stack([
        R[..., 0, 0] * v[..., 0] + R[..., 0, 1] * v[..., 1]
        + R[..., 0, 2] * v[..., 2],
        R[..., 1, 0] * v[..., 0] + R[..., 1, 1] * v[..., 1]
        + R[..., 1, 2] * v[..., 2],
        R[..., 2, 0] * v[..., 0] + R[..., 2, 1] * v[..., 1]
        + R[..., 2, 2] * v[..., 2],
    ], dim=-1)


# ---------------------------------------------------------------------------
# Object wrapper mirroring the pytorch_kinematics API surface
# ---------------------------------------------------------------------------

class Transform3d:
    """Batched rigid transform over a ``[B, 4, 4]`` (or ``[4, 4]``) matrix."""

    def __init__(self, matrix: Optional[torch.Tensor] = None,
                 pos: Optional[torch.Tensor] = None,
                 rot: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        if matrix is not None:
            self.matrix = as_float_tensor(matrix, device, dtype)
        else:
            self.matrix = make_tf(pos=pos, rot=rot, dtype=dtype, device=device)

    def get_matrix(self) -> torch.Tensor:
        m = self.matrix
        return m[None] if m.ndim == 2 else m

    def __len__(self) -> int:
        return self.get_matrix().shape[0]

    def inverse(self) -> "Transform3d":
        return Transform3d(matrix=invert_tf(self.matrix))

    def stack(self, *others: "Transform3d") -> "Transform3d":
        ms = [self.get_matrix()] + [o.get_matrix() for o in others]
        return Transform3d(matrix=torch.cat(ms, dim=0))


def Translate(x: float, y: float, z: float, dtype=torch.float32,
              device=None) -> Transform3d:
    """Pure translation, mirroring ``pytorch_kinematics.Translate``."""
    pos = torch.tensor(np.array([x, y, z], dtype=np.float32), dtype=dtype,
                       device=resolve_device(device))
    return Transform3d(pos=pos, dtype=dtype)
