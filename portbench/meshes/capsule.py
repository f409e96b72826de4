"""A closed capsule along z (``pytorch_volumetric_tpu_torch/mesh.py``'s
``capsule_mesh``, frozen): a lat-long sphere split at the equator, the poles
closed by fans."""

import numpy as np


def make(radius: float, height: float, segments: int, rings: int):
    half = height / 2.0
    vs = []
    for r in range(1, rings + 1):
        phi = -np.pi / 2 + (np.pi / 2) * r / rings
        z, rr = -half + radius * np.sin(phi), radius * np.cos(phi)
        vs.extend((rr * np.cos(a), rr * np.sin(a), z)
                  for a in np.linspace(0, 2 * np.pi, segments, endpoint=False))
    for r in range(rings):
        phi = (np.pi / 2) * r / rings
        z, rr = half + radius * np.sin(phi), radius * np.cos(phi)
        vs.extend((rr * np.cos(a), rr * np.sin(a), z)
                  for a in np.linspace(0, 2 * np.pi, segments, endpoint=False))
    n_rings = 2 * rings
    faces = []
    for r in range(n_rings - 1):
        for i in range(segments):
            j = (i + 1) % segments
            a, b = r * segments + i, r * segments + j
            c, d = (r + 1) * segments + i, (r + 1) * segments + j
            faces += [[a, b, d], [a, d, c]]
    v = np.concatenate([np.array(vs, dtype=np.float64),
                        [[0, 0, -half - radius], [0, 0, half + radius]]], axis=0)
    bp, tp = len(v) - 2, len(v) - 1
    top_row = (n_rings - 1) * segments
    for i in range(segments):
        j = (i + 1) % segments
        faces.append([bp, j, i])
        faces.append([tp, top_row + i, top_row + j])
    return v, np.array(faces, dtype=np.int32)
