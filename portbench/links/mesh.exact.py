"""Exact mesh links (``links.sdf == "mesh"``, ``interpolation == "exact"``):
every query sweeps the link's triangles for the closest point and takes the
sign from the winding number.

The program builds them as upstream's users do: ``RobotSDF(chain,
path_prefix=...)`` takes ``link_sdf_cls=MeshSDF`` unless told otherwise
(upstream ``src/pytorch_volumetric/model_to_sdf.py``).  The reference
(:class:`Table`) works each query out again from the mesh with
``reference.exact_sdf``, in float64: the closest point over every triangle,
the sign from the generalised winding number, the gradient ``sign * (x -
closest) / d``, or the closest face's normal within 1e-3 of the surface.

Where the program and this reference depart from upstream's ``MeshSDF``
(Open3D's ``RaycastingScene`` on the host):

- the sign: upstream counts the crossings of a ray towards a randomly
  jittered point outside the mesh's box (odd: inside); here the point is
  inside where the generalised winding number's magnitude exceeds 0.5.  For
  a closed mesh both give the same sign off the surface; within rounding of
  the surface the ray's answer is random.  Where |w| lies within
  ``reference.SIGN_TIE`` of 0.5 the reference admits both signs;
- the closest point: upstream walks a bounding volume hierarchy; here every
  triangle is evaluated (the program culls clusters of them).  The distance
  is the same; faces within ``reference.FACE_TIE`` of the nearest tie, and a
  gradient that differs between tied faces is not compared;
- the gradient's switch to the face normal at 1e-3: a distance within
  ``reference.FACE_TIE`` of it leaves the gradient open;
- precision: upstream computes in float32 on the host; the program in
  float32 on the card, the reference in float64.

A link reads no cache, so ``size`` is 0 and ``cells_read`` reads nothing.
The roofline of the lookup layer asks ``cells_read`` about every link's
points under every configuration, and each call is noted for the exact
links' own floor (``exact_work.ASKS``).

A program whose sweep counts its launches by the wrapper function
(``LAUNCHES[wrapper]`` in ``ops/closest_point.py``) would raise inside the
labelled traced window, where ``trace.port_annotations`` has put a labelled
copy in the wrapper's place: :func:`program_link_cls` lets such a copy count
under its original's key.  The kernels, their launches and what they count
are unchanged.
"""

import importlib

import numpy as np
import torch

from portbench import exact_work
from portbench.reference import PAIRS_PER_BLOCK, exact_sdf


class _ByWrapped(dict):
    """A table keyed by functions that finds a labelled copy (one with
    ``__wrapped__``) under the function it wraps."""

    def __missing__(self, f):
        inner = getattr(f, "__wrapped__", None)
        if inner is None:
            raise KeyError(f)
        return self[inner]


def count_labelled_sweeps(pt) -> None:
    """Let the sweep's launch table, where the program keys it by wrapper
    function, find the labelled copies of the traced window."""
    mod = importlib.import_module(pt.__name__ + ".ops.closest_point")
    launches = getattr(mod, "LAUNCHES", None)
    if type(launches) is dict:
        mod.LAUNCHES = _ByWrapped(launches)


def program_link_cls(pt, links: dict, cache_path: str):
    """The program's link SDF class, as its users build it: RobotSDF's
    default."""
    count_labelled_sweeps(pt)
    return pt.MeshSDF


class Table:
    """The exact SDF of one mesh, worked out at the points asked for."""

    size = 0

    def __init__(self, vertices: np.ndarray, faces: np.ndarray, links: dict, device):
        tri = vertices[faces]
        self.tri = torch.as_tensor(tri, dtype=torch.float64, device=device)
        nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-30)
        self.normals = torch.as_tensor(nrm, dtype=torch.float64, device=device)
        self.faces = len(faces)
        # a new reference: the floor's notes start again
        exact_work.ASKS.clear()

    def _exact(self, x: torch.Tensor, dtype):
        """``reference.exact_sdf`` at link points ``x [N, 3]`` in ``dtype``,
        in blocks of points."""
        tri, nrm = self.tri.to(dtype), self.normals.to(dtype)
        block = max(1, PAIRS_PER_BLOCK // self.faces)
        out = [exact_sdf(x[s:s + block].to(dtype), tri, nrm)
               for s in range(0, max(len(x), 1), block)]
        return [torch.cat(parts) for parts in zip(*out)]

    # -- what the reference asks of a link --------------------------------------
    def candidates(self, x: torch.Tensor) -> dict:
        """The admissible answers at link points ``x [N, 3]`` (float64): the
        value interval ``lo, hi [N]`` (both signs where the sign is open),
        ``uniq`` (always: no cell to choose), the gradient ``g_c [1, N, 3]``,
        and whether it is open (``gamb``)."""
        v_lo, v_hi, g, amb = self._exact(x, torch.float64)
        return {"lo": v_lo, "hi": v_hi, "uniq": torch.ones_like(amb), "g_c": g[None],
                "gamb": amb}

    def lookup(self, x: torch.Tensor, mode: str):
        """One answer at link points ``x [N, 3]``: ``(v [N], g [N, 3])``, in
        float64 (``"f64"``) or in the program's float32; where the sign is
        open, the value outside."""
        _, v_hi, g, _ = self._exact(x, torch.float64 if mode == "f64" else torch.float32)
        return v_hi, g

    def cells_read(self, x: torch.Tensor) -> torch.Tensor:
        """No cells: notes the link points ``x [N, 3]`` for the exact floor."""
        exact_work.ASKS.append((id(self), self.faces, x.shape[0]))
        return torch.zeros(0, dtype=torch.long, device=x.device)
