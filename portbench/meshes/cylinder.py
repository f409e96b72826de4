"""A closed cylinder along z (``pytorch_volumetric_tpu_torch/mesh.py``'s
``cylinder_mesh``, frozen)."""

import numpy as np


def make(radius: float, height: float, segments: int, center=(0.0, 0.0, 0.0)):
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    circ = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    bot = np.concatenate([circ, np.full((segments, 1), -height / 2)], axis=1)
    top = np.concatenate([circ, np.full((segments, 1), height / 2)], axis=1)
    v = np.concatenate([bot, top, [[0, 0, -height / 2]], [[0, 0, height / 2]]], axis=0)
    bc, tc = 2 * segments, 2 * segments + 1
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        faces += [[i, j, segments + i], [j, segments + j, segments + i]]
        faces += [[bc, j, i], [tc, segments + i, segments + j]]
    return (v + np.asarray(center, dtype=np.float64)).astype(np.float64), \
        np.array(faces, dtype=np.int32)
