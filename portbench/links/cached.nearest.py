"""Cached links, read at the nearest cell, with the distance to the mesh's
box outside the grid (``links.sdf == "cached"``, ``interpolation ==
"nearest"``, ``out_of_bounds == "bounding_box"``).

The program builds them with ``cache_link_sdf_factory``.  The reference
works each grid out again from the mesh (:class:`Table`): the mesh's box
plus the padding, snapped to a whole number of cells (float32 ``np.arange``
coordinates), and the exact signed distance and gradient
(``reference.exact_sdf``) at the cells a query needs.  The key is
``round((p - lo) / res)``; where float32 rounding can change it, a point
within ``KEY_TIE`` cells of a cell boundary admits the cells on both sides.
"""

import numpy as np
import torch

from portbench.reference import PAIRS_PER_BLOCK, exact_sdf

KEY_TIE = 5e-4          # cells: a key this close to a cell boundary admits both cells


def check(links: dict) -> None:
    if links.get("out_of_bounds") != "bounding_box":
        raise ValueError("cached nearest links know the box fallback only")


def program_link_cls(pt, links: dict, cache_path: str):
    """The program's link SDF class, as its users build it."""
    check(links)
    return pt.cache_link_sdf_factory(resolution=links["resolution"], padding=links["padding"],
                                     cache_path=cache_path,
                                     interpolation=links["interpolation"])


class Table:
    """The exact SDF of one mesh at the points of its cache grid, worked out
    for the cells asked for and kept."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray, links: dict, device):
        check(links)
        self.device = device
        res, pad = float(links["resolution"]), float(links["padding"])
        aabb = np.stack([vertices.min(0), vertices.max(0)], axis=1)   # [3, 2]
        rng = aabb + np.array([-pad, pad])
        lo = rng[:, 0]
        hi = lo + np.round((rng[:, 1] - rng[:, 0]) / res) * res
        self.coords = [np.arange(l, h + 0.9 * res, res, dtype=np.float32)
                       for l, h in zip(lo, hi)]
        self.n = torch.as_tensor([len(c) for c in self.coords], device=device)
        cell = np.array([(h - l) / (len(c) - 1) for l, h, c in zip(lo, hi, self.coords)])
        # the keys' arithmetic: (p - lo) * (1 / res), both rounded to float32
        self.lo = torch.as_tensor(lo.astype(np.float32).astype(np.float64), device=device)
        self.inv_res = torch.as_tensor(
            (np.float32(1.0) / cell.astype(np.float32)).astype(np.float64), device=device)
        self.lo32 = self.lo.to(torch.float32)
        self.inv_res32 = self.inv_res.to(torch.float32)
        self.bb = torch.as_tensor(aabb.astype(np.float32).astype(np.float64), device=device)
        self.strides = torch.as_tensor([int(self.n[1] * self.n[2]), int(self.n[2]), 1],
                                       device=device)
        tri = vertices[faces]
        self.tri = torch.as_tensor(tri, dtype=torch.float64, device=device)
        nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-30)
        self.normals = torch.as_tensor(nrm, dtype=torch.float64, device=device)
        G = int(torch.prod(self.n))
        self.size = G
        self.done = torch.zeros(G, dtype=torch.bool, device=device)
        self.v_lo = torch.zeros(G, dtype=torch.float64, device=device)
        self.v_hi = torch.zeros(G, dtype=torch.float64, device=device)
        self.grad = torch.zeros((G, 3), dtype=torch.float64, device=device)
        self.amb = torch.zeros(G, dtype=torch.bool, device=device)
        self._coords_t = [torch.as_tensor(c, dtype=torch.float64, device=device)
                          for c in self.coords]

    # -- the grid -------------------------------------------------------------
    def point_of(self, flat: torch.Tensor) -> torch.Tensor:
        k = [(flat // self.strides[d]) % self.n[d] for d in range(3)]
        return torch.stack([self._coords_t[d][k[d]] for d in range(3)], dim=-1)

    def ensure(self, flat: torch.Tensor) -> None:
        need = torch.unique(flat.reshape(-1))
        need = need[~self.done[need]]
        if need.numel() == 0:
            return
        block = max(1, PAIRS_PER_BLOCK // self.tri.shape[0])
        for s in range(0, need.numel(), block):
            idx = need[s:s + block]
            v_lo, v_hi, g, amb = exact_sdf(self.point_of(idx), self.tri, self.normals)
            self.v_lo[idx], self.v_hi[idx], self.grad[idx], self.amb[idx] = v_lo, v_hi, g, amb
        self.done[need] = True

    def oob(self, p: torch.Tensor):
        """The distance to the mesh's box and its direction."""
        dt = p - torch.minimum(torch.maximum(p, self.bb[:, 0].to(p.dtype)), self.bb[:, 1].to(p.dtype))
        dist = dt.norm(dim=-1)
        return dist, dt / dist.clamp(min=1e-12)[..., None]

    def flat(self, keys: torch.Tensor) -> torch.Tensor:
        return (keys.clamp(min=0) * self.strides).sum(-1).clamp(max=self.size - 1)

    def valid(self, keys: torch.Tensor) -> torch.Tensor:
        return ((keys >= 0) & (keys < self.n)).all(-1)

    # -- what the reference asks of a link --------------------------------------
    def candidates(self, x: torch.Tensor) -> dict:
        """The admissible answers at link points ``x [N, 3]`` (float64): the
        value interval ``lo, hi [N]``, whether the cell is unique (``uniq``),
        each candidate's gradient ``g_c [8, N, 3]`` (cell or box fallback;
        candidate 0 is the nearest cell), and whether the nearest cell's
        gradient is open (``gamb``)."""
        bits = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)],
                            device=x.device)
        u = (x - self.lo) * self.inv_res
        f = torch.floor(u)
        amb = ((u - f) - 0.5).abs() < KEY_TIE
        near = torch.floor(u + 0.5)
        # candidate 0 is the nearest cell: bit 0 picks the side it lies on
        side = (near > f).long()
        keys = torch.where(amb[None], f[None] + (side[None] ^ bits[:, None, :]),
                           near[None]).long()                     # [8, N, 3]
        valid = self.valid(keys)
        flat = self.flat(keys)
        self.ensure(flat[valid])
        oob_v, oob_g = self.oob(x)
        return {"lo": torch.where(valid, self.v_lo[flat], oob_v[None]).amin(0),
                "hi": torch.where(valid, self.v_hi[flat], oob_v[None]).amax(0),
                "uniq": ~amb.any(-1),
                "g_c": torch.where(valid[..., None], self.grad[flat], oob_g[None]),
                "gamb": valid[0] & self.amb[flat[0]]}

    def lookup(self, x: torch.Tensor, mode: str):
        """One answer at link points ``x [N, 3]``: ``(v [N], g [N, 3])``
        (float64), the key in float64 (``"f64"``) or in the program's
        float32 arithmetic."""
        if mode == "f64":
            keys = torch.floor((x - self.lo) * self.inv_res + 0.5).long()
        else:
            keys = torch.round((x.to(torch.float32) - self.lo32) * self.inv_res32).long()
        valid = self.valid(keys)
        flat = self.flat(keys)
        self.ensure(flat[valid])
        oob_v, oob_g = self.oob(x.to(torch.float64))
        return (torch.where(valid, self.v_lo[flat], oob_v),
                torch.where(valid[:, None], self.grad[flat], oob_g))

    def cells_read(self, x: torch.Tensor) -> torch.Tensor:
        """The flat cells that in-grid lookups of link points ``x [N, 3]``
        read (the roofline's count)."""
        keys = torch.floor((x - self.lo) * self.inv_res + 0.5).long()
        return self.flat(keys)[self.valid(keys)]
