"""Cached links, read by trilinear interpolation of the 8 cache cells around
the point, with the distance to the mesh's box outside the grid
(``links.sdf == "cached"``, ``interpolation == "trilinear"``,
``out_of_bounds == "bounding_box"``).

The program builds them with ``cache_link_sdf_factory(...,
interpolation="trilinear")``.  The reference's :class:`Table` is the
nearest kind's (``links/cached.nearest.py``): the same grid, worked out
again from the mesh, and the same exact signed distance and gradient at the
cells a query needs, computed lazily in float64.  What differs is the read:

- a point is in the grid where its NEAREST key ``round((p - lo) / res)``
  is, the nearest contract; outside, the answer is the box distance;
- in the grid, the cell coordinate ``f = (p - lo) / res`` is clamped into
  ``[0, n - 1]``, its lower corner ``floor(f)`` into ``[0, n - 2]``, and
  the answer is the lerp of the value and of the gradient at the cell's 8
  corners, weighted by ``w = f - floor(f)`` in each dimension (corner ``c``
  takes offset ``(c >> d) & 1`` in dimension ``d``, the weight the product
  over x, y, z of ``w`` or ``1 - w``): the program's ``gather_trilinear``.

The lerp is continuous in the point, so float32 rounding of ``f`` moves the
answer by rounding only.  The in-grid test is not: within ``KEY_TIE`` cells
of the validity boundary (``f = -0.5`` or ``n - 0.5`` in a dimension) both
the lerp and the box fallback are admitted.  The value interval is the lerp
of the corners' ``v_lo`` and ``v_hi``; the gradient is open wherever a
corner of nonzero weight has an open gradient.

``cells_read`` gives the 8 corners of every in-grid point, the cells the
lookup layer's roofline counts.
"""

import os

import torch

from portbench import plugins

_nearest = plugins.load("links", "cached.nearest",
                        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEY_TIE = _nearest.KEY_TIE
# corner c of a cell: offset (c >> d) & 1 in dimension d, gather_trilinear's order
CORNERS = [[(c >> d) & 1 for d in range(3)] for c in range(8)]


def program_link_cls(pt, links: dict, cache_path: str):
    """The program's link SDF class, as its users build it."""
    _nearest.check(links)
    return pt.cache_link_sdf_factory(resolution=links["resolution"], padding=links["padding"],
                                     cache_path=cache_path, interpolation="trilinear")


class Table(_nearest.Table):
    """The nearest kind's grid and exact corners, read by trilinear
    interpolation."""

    def _cell(self, x: torch.Tensor, mode: str):
        """The read of link points ``x [N, 3]`` in float64 (``"f64"``) or in
        the program's float32 arithmetic: ``(f [N, 3], valid [N], corners
        [8, N], weights [8, N])``, the corners as flat cells."""
        if mode == "f64":
            f = (x.to(torch.float64) - self.lo) * self.inv_res
            keys = torch.floor(f + 0.5)
        else:
            f = (x.to(torch.float32) - self.lo32) * self.inv_res32
            keys = torch.round(f)
        valid = ((keys >= 0) & (keys < self.n)).all(-1)
        fc = torch.minimum(f.clamp(min=0.0), (self.n - 1).to(f.dtype))
        i0 = torch.minimum(torch.floor(fc).long(), self.n - 2)
        w = fc - i0.to(f.dtype)
        offs = torch.as_tensor(CORNERS, device=x.device)                     # [8, 3]
        corners = ((i0[None] + offs[:, None]) * self.strides).sum(-1)        # [8, N]
        wd = torch.where(offs[:, None].bool(), w[None], 1.0 - w[None])       # [8, N, 3]
        return f, valid, corners, wd[..., 0] * wd[..., 1] * wd[..., 2]

    def _lerp(self, table: torch.Tensor, corners: torch.Tensor, weights: torch.Tensor):
        """``sum_c weights[c] * table[corners[c]]`` over the 8 corners."""
        vals = table[corners]
        wt = weights.to(vals.dtype)
        return (wt.reshape(wt.shape + (1,) * (vals.dim() - 2)) * vals).sum(0)

    # -- what the reference asks of a link --------------------------------------
    def candidates(self, x: torch.Tensor) -> dict:
        """The admissible answers at link points ``x [N, 3]`` (float64): the
        value interval ``lo, hi [N]``, whether the answer's kind (lerp or
        box) is unique (``uniq``), the gradient of the nominal answer and of
        the other kind ``g_c [2, N, 3]`` (the same twice where unique), and
        whether the nominal gradient is open (``gamb``)."""
        f, valid, corners, weights = self._cell(x, "f64")
        n = self.n.to(f.dtype)
        near = ((f + 0.5).abs() < KEY_TIE) | ((f - (n - 0.5)).abs() < KEY_TIE)
        inside = (f >= -0.5) & (f < n - 0.5)
        either = (inside | near).all(-1) & (~inside | near).any(-1)
        need = valid | either
        self.ensure(corners[:, need])
        v_lo = self._lerp(self.v_lo, corners, weights)
        v_hi = self._lerp(self.v_hi, corners, weights)
        g = self._lerp(self.grad, corners, weights)
        oob_v, oob_g = self.oob(x)
        nominal_g = torch.where(valid[:, None], g, oob_g)
        other_g = torch.where((either & valid)[:, None], oob_g,
                              torch.where(either[:, None], g, nominal_g))
        lo = torch.where(valid, v_lo, oob_v)
        hi = torch.where(valid, v_hi, oob_v)
        amb = ((weights > 0) & self.amb[corners]).any(0)
        return {"lo": torch.where(either, torch.minimum(v_lo, oob_v), lo),
                "hi": torch.where(either, torch.maximum(v_hi, oob_v), hi),
                "uniq": ~either,
                "g_c": torch.stack([nominal_g, other_g]),
                "gamb": valid & amb}

    def lookup(self, x: torch.Tensor, mode: str):
        """One answer at link points ``x [N, 3]``: ``(v [N], g [N, 3])``
        (float64), the cell and weights in float64 (``"f64"``) or in the
        program's float32 arithmetic."""
        _, valid, corners, weights = self._cell(x, mode)
        self.ensure(corners[:, valid])
        oob_v, oob_g = self.oob(x.to(torch.float64))
        return (torch.where(valid, self._lerp(self.v_lo, corners, weights), oob_v),
                torch.where(valid[:, None], self._lerp(self.grad, corners, weights), oob_g))

    def cells_read(self, x: torch.Tensor) -> torch.Tensor:
        """The flat cells that in-grid lookups of link points ``x [N, 3]``
        read: the 8 corners of each (the roofline's count)."""
        _, valid, corners, _ = self._cell(x, "f64")
        return corners[:, valid].reshape(-1)
