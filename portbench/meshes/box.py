"""A closed box (``pytorch_volumetric_tpu_torch/mesh.py``'s ``box_mesh``,
frozen): corners indexed x, y, z by bits 2, 1, 0, faces wound outward."""

import numpy as np


def make(extents, center=(0.0, 0.0, 0.0)):
    e = np.asarray(extents, dtype=np.float64) / 2.0
    c = np.asarray(center, dtype=np.float64)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                       dtype=np.float64) * e + c
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                     dtype=np.int32)
    return corners, faces
