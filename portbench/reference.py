"""The plain reference: a robot's SDF over joint configurations, worked out
from the meshes and the configuration with nothing of the program.

It imports neither JAX nor anything of ``pytorch_volumetric_tpu_torch``.  It
reads the URDF and the OBJ files the benchmark wrote (the same files the
program reads), and works out again what the program derives in its set-up:

- FK of the serial chain (URDF origins, revolute and prismatic joints);
- each link's SDF, by its kind (``links/<sdf>.<interpolation>.py``): for
  a cached link its grid and the exact signed distance and gradient at the
  grid points it needs (:func:`exact_sdf`: the closest point over every
  triangle, the sign from the winding number (|w| > 0.5), the gradient
  ``sign * (x - closest) / d``, or the face normal within 1e-3 of the
  surface);
- the link's lookup (for a cached link the nearest cell, the distance to
  the box outside the grid), and the min-union over links, whose gradient
  is the winner's rotated into the world frame;
- d/dq of ``v.sum() + g.sum()`` over every point of a configuration, with
  the program's documented derivative: the value's derivative w.r.t. the
  link-frame point is the looked-up gradient (straight-through), and the
  gradient output moves only with its rotation.

It runs in float64.  Where float32 rounding can change an answer, it admits
every answer the rounding could give (the link kind says which: a
cached nearest link admits both cells at a cell boundary), and a gradient that ties between faces,
sits at the 1e-3 switch or at the sign switch, or belongs to a union winner
that is not separated from the next link, is not compared.

``mode="tf32"`` is the control: the same reference in the precision below
the configuration's (float32 with TF32 off): float32 throughout, and the
FK's matrix products with TF32 operands (10 mantissa bits), the products the
program runs through ``torch.matmul``.  It gives one answer per query, as
the program does.
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from portbench import plugins

FACE_TIE = 1e-6         # m: faces this close to the nearest one tie
GRAD_SPREAD = 1e-3      # tied faces whose gradients differ by more make it ambiguous
SURFACE_EPS = 1e-3      # the normal replaces the direction within this distance
SIGN_TIE = 0.05         # |w| this close to 0.5 leaves the sign open
WINNER_SEP = 1e-5       # m: a union winner must lead the next link by this much
PAIRS_PER_BLOCK = 1 << 21


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """``(vertices float64 [V, 3], faces int64 [F, 3])``; polygons fanned,
    faces with a repeated vertex dropped."""
    vs, fs = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                vs.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) for t in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(vs) + i for i in idx]
                fs += [(idx[0], idx[j], idx[j + 1]) for j in range(1, len(idx) - 1)]
    v, fa = np.asarray(vs, dtype=np.float64), np.asarray(fs, dtype=np.int64)
    ok = (fa[:, 0] != fa[:, 1]) & (fa[:, 1] != fa[:, 2]) & (fa[:, 0] != fa[:, 2])
    return v, fa[ok]


def rpy_matrix(rpy) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = math.cos(r), math.sin(r), math.cos(p), math.sin(p), \
        math.cos(y), math.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def origin_matrix(elem) -> np.ndarray:
    m = np.eye(4)
    if elem is not None:
        m[:3, 3] = [float(x) for x in elem.get("xyz", "0 0 0").split()]
        m[:3, :3] = rpy_matrix([float(x) for x in elem.get("rpy", "0 0 0").split()])
    return m


@dataclass
class Joint:
    name: str
    kind: str            # revolute, continuous, prismatic, fixed
    origin: np.ndarray   # [4, 4]
    axis: np.ndarray     # [3]


@dataclass
class Link:
    name: str
    joints: List[Joint]  # root -> this link
    offset: np.ndarray   # visual origin: mesh frame -> link frame
    mesh_file: str
    scale: np.ndarray


def read_serial_urdf(path: str, end_link: str) -> Tuple[List[Link], List[str]]:
    """The links with a mesh visual on the root -> ``end_link`` path, in
    path order, and the movable joints' names in path order."""
    root = ET.parse(path).getroot()
    joints = {}
    for j in root.findall("joint"):
        axis = j.find("axis")
        joints[j.find("child").get("link")] = (j.find("parent").get("link"), Joint(
            j.get("name"), j.get("type"), origin_matrix(j.find("origin")),
            np.array([float(x) for x in (axis.get("xyz") if axis is not None
                                         else "1 0 0").split()])))
    path_links = [end_link]
    while path_links[-1] in joints:
        path_links.append(joints[path_links[-1]][0])
    path_links.reverse()
    elems = {e.get("name"): e for e in root.findall("link")}
    links, chain = [], []
    for name in path_links:
        if name in joints:
            chain = chain + [joints[name][1]]
        for vis in elems[name].findall("visual"):
            mesh = vis.find("geometry/mesh")
            if mesh is None:
                continue
            scale = np.array([float(x) for x in mesh.get("scale", "1 1 1").split()])
            links.append(Link(name, chain, origin_matrix(vis.find("origin")),
                              mesh.get("filename"), scale))
    movable = [j.name for j in chain if j.kind != "fixed"]
    return links, movable


# ---------------------------------------------------------------------------
# arithmetic in the two precisions
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, round to nearest), with the
    derivative passed straight through."""
    x32 = x.to(torch.float32).contiguous()
    bits = x32.detach().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x32 + (r - x32).detach()


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tf32":
        return torch.matmul(tf32(a).double(), tf32(b).double()).to(torch.float32)
    return torch.matmul(a, b)


def dtype_of(mode: str):
    return torch.float64 if mode == "f64" else torch.float32


def rigid_inverse(m: torch.Tensor) -> torch.Tensor:
    R, t = m[..., :3, :3], m[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t)], dim=-1)
    bottom = torch.zeros_like(m[..., 3:, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def joint_motion(j: Joint, qi: torch.Tensor) -> torch.Tensor:
    """``[C, 4, 4]`` motion of joint ``j`` at ``qi [C]``."""
    C = qi.shape[0]
    m = torch.eye(4, dtype=qi.dtype, device=qi.device).repeat(C, 1, 1)
    k = torch.as_tensor(j.axis / np.linalg.norm(j.axis), dtype=qi.dtype, device=qi.device)
    if j.kind == "prismatic":
        m[:, :3, 3] = qi[:, None] * k
        return m
    c, s = torch.cos(qi)[:, None, None], torch.sin(qi)[:, None, None]
    K = torch.zeros((3, 3), dtype=qi.dtype, device=qi.device)
    K[0, 1], K[0, 2], K[1, 2] = -k[2], k[1], -k[0]
    K = K - K.T
    eye = torch.eye(3, dtype=qi.dtype, device=qi.device)
    m[:, :3, :3] = c * eye + s * K + (1 - c) * torch.outer(k, k)
    return m


# ---------------------------------------------------------------------------
# the exact signed distance at grid points
# ---------------------------------------------------------------------------

def _dot(u, v):
    return (u * v).sum(-1)


def closest_on_triangles(p, a, b, c):
    """Closest point on each triangle (Ericson, Real-Time Collision
    Detection 5.1.5).  ``p [B, 1, 3]``, ``a, b, c [1, F, 3]`` -> ``[B, F, 3]``."""
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    tiny = torch.finfo(p.dtype).tiny

    def div(n, d):
        return n / torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)

    denom = va + vb + vc
    out = a + ab * div(vb, denom)[..., None] + ac * div(vc, denom)[..., None]
    e = (d4 - d3) + (d5 - d6)
    regions = [  # lowest priority first: each later region overrides
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), b + (c - b) * div(d4 - d3, e)[..., None]),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + ac * div(d2, d2 - d6)[..., None]),
        ((d6 >= 0) & (d5 <= d6), c.expand_as(out)),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + ab * div(d1, d1 - d3)[..., None]),
        ((d3 >= 0) & (d4 <= d3), b.expand_as(out)),
        ((d1 <= 0) & (d2 <= 0), a.expand_as(out)),
    ]
    for mask, pt in regions:
        out = torch.where(mask[..., None], pt, out)
    return out


def solid_angles(p, a, b, c):
    """Solid angle of each triangle seen from each point (van Oosterom and
    Strackee); ``[B, F]``."""
    x, y, z = a - p, b - p, c - p
    lx, ly, lz = x.norm(dim=-1), y.norm(dim=-1), z.norm(dim=-1)
    num = _dot(x, torch.cross(y, z, dim=-1))
    den = lx * ly * lz + _dot(x, y) * lz + _dot(y, z) * lx + _dot(z, x) * ly
    return 2.0 * torch.atan2(num, den)


def exact_sdf(x: torch.Tensor, tri: torch.Tensor, normals: torch.Tensor):
    """At points ``x [B, 3]`` against triangles ``tri [F, 3, 3]``:
    ``(v_lo, v_hi, grad [B, 3], grad_ambiguous [B])``; the value is one
    number unless the sign is open."""
    a, b, c = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
    p = x[:, None, :]
    cl = closest_on_triangles(p, a, b, c)
    d = (cl - p).norm(dim=-1)                          # [B, F]
    dmin, best = d.min(dim=1)
    c_best = cl[torch.arange(len(x), device=x.device), best]
    n_best = normals[best]
    tied = d <= (dmin + FACE_TIE)[:, None]
    spread_c = torch.where(tied, (cl - c_best[:, None]).norm(dim=-1), 0.0).amax(dim=1)
    spread_n = torch.where(tied, (normals[None] - n_best[:, None]).norm(dim=-1), 0.0).amax(dim=1)
    w = solid_angles(p, a, b, c).sum(dim=1) / (4 * math.pi)
    inside = w.abs() > 0.5
    sign = torch.where(inside, -1.0, 1.0).to(x.dtype)
    sign_open = ((w.abs() - 0.5).abs() < SIGN_TIE)
    on_surface = dmin < SURFACE_EPS
    grad = torch.where(on_surface[:, None], n_best,
                       sign[:, None] * (x - c_best) / dmin.clamp(min=1e-300)[:, None])
    amb = (sign_open | ((dmin - SURFACE_EPS).abs() < FACE_TIE)
           | torch.where(on_surface, spread_n > GRAD_SPREAD,
                         spread_c / dmin.clamp(min=1e-300) > GRAD_SPREAD))
    v = sign * dmin
    v_lo = torch.where(sign_open, -dmin, v)
    v_hi = torch.where(sign_open, dmin, v)
    return v_lo, v_hi, grad, amb


# ---------------------------------------------------------------------------
# the robot
# ---------------------------------------------------------------------------

def link_kind(links: dict) -> str:
    """The name of the link SDF kind, ``<sdf>.<interpolation>``, whose file
    ``links/<name>.py`` the program's set-up and the reference read."""
    return f"{links['sdf']}.{links['interpolation']}"


class Reference:
    """The configuration's robot, from the files in ``assets``."""

    def __init__(self, cfg: dict, assets, device, base: str = plugins.BENCH_DIR):
        self.device = device
        self.links, self.joint_names = read_serial_urdf(assets.urdf_path, assets.end_link)
        kind = plugins.load("links", link_kind(cfg["links"]), base)
        tables = {}
        self.tables = []
        for link in self.links:
            key = link.mesh_file
            if key not in tables:
                v, f = read_obj(os.path.join(assets.directory, link.mesh_file))
                tables[key] = kind.Table(v * link.scale, f, cfg["links"], device)
            self.tables.append(tables[key])
        self.offset_inv = [torch.as_tensor(np.linalg.inv(l.offset), device=device)
                           for l in self.links]

    # -- poses ---------------------------------------------------------------
    def link_poses(self, q: torch.Tensor, mode: str = "f64"):
        """``(obj_to_link, link_to_obj)``, each ``[L, C, 4, 4]``: world ->
        mesh frame of every link and back, under ``q [C, dof]``."""
        dt = dtype_of(mode)
        q = q.to(dt)
        C = q.shape[0]
        col = {n: i for i, n in enumerate(self.joint_names)}
        m = torch.eye(4, dtype=dt, device=q.device).repeat(C, 1, 1)
        cum = [m]  # the chain's frames, root first: every link's path is a prefix
        for j in max((l.joints for l in self.links), key=len):
            m = mm(m, torch.as_tensor(j.origin, dtype=dt, device=q.device).expand(C, 4, 4), mode)
            if j.kind != "fixed":
                m = mm(m, joint_motion(j, q[:, col[j.name]]), mode)
            cum.append(m)
        o2l, l2o = [], []
        for li, link in enumerate(self.links):
            off_inv = self.offset_inv[li].to(dt).expand(C, 4, 4)
            to_link = mm(off_inv, rigid_inverse(cum[len(link.joints)]), mode)
            o2l.append(to_link)
            l2o.append(rigid_inverse(to_link))
        return torch.stack(o2l), torch.stack(l2o)

    @staticmethod
    def apply(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """``m [..., 4, 4]`` on ``p [..., N, 3]``, elementwise."""
        R, t = m[..., None, :3, :3], m[..., None, :3, 3]
        return (R * p[..., :, None, :]).sum(-1) + t

    # -- the admissible cells of every link -----------------------------------
    def _candidates(self, pl: torch.Tensor) -> dict:
        """Every link's admissible answers at link points ``pl [L, N, 3]``
        (float64, no derivative), as its kind gives them (``Table.candidates``),
        stacked over links: ``lo, hi [L, N]``, ``uniq``, ``g_c [L, K, N, 3]``
        (candidate 0 the nominal answer's gradient), ``gamb``."""
        out = [t.candidates(pl[l]) for l, t in enumerate(self.tables)]
        return {k: torch.stack([o[k] for o in out]) for k in out[0]}

    @staticmethod
    def _settled(c: dict, w: torch.Tensor) -> torch.Tensor:
        """Points whose answer rounding cannot change: winner ``w`` in a
        unique cell, its gradient closed, every other link separated."""
        ar = torch.arange(w.shape[0], device=w.device)
        others = c["lo"].clone()
        others[w, ar] = float("inf")
        return (c["uniq"][w, ar] & ~c["gamb"][w, ar]
                & (others.amin(0) > c["hi"][w, ar] + WINNER_SEP))

    # -- sampled answers, the reference's admissible set ---------------------
    def expected(self, q: torch.Tensor, p: torch.Tensor) -> dict:
        """For answers ``i`` (configuration ``q[i]``, world point ``p[i]``):
        the admissible value interval ``[lo, hi]``, and the gradient ``g``
        where ``g_ok``."""
        with torch.no_grad():
            o2l, l2o = self.link_poses(q)
            pl = self.apply(o2l, p[:, None, :])[:, :, 0, :]             # [L, S, 3]
            c = self._candidates(pl)
            w = c["lo"].argmin(0)
            ar = torch.arange(p.shape[0], device=p.device)
            g = (l2o[w, ar, :3, :3] @ c["g_c"][w, 0, ar][..., None])[..., 0]
            return {"lo": c["lo"].amin(0), "hi": c["hi"].amin(0), "g": g,
                    "g_ok": self._settled(c, w)}

    # -- one answer per query, as a program gives -----------------------------
    def answers(self, q: torch.Tensor, p: torch.Tensor, mode: str = "tf32"):
        """``(v [S], g [S, 3])`` for answers ``(q[i], p[i])``, computed in
        ``mode`` with the program's key arithmetic (the control)."""
        dt = dtype_of(mode)
        with torch.no_grad():
            o2l, l2o = self.link_poses(q, mode)
            pl = self.apply(o2l, p.to(dt)[:, None, :])[:, :, 0, :]
            v, g = self._lookup(pl, mode)
            w = v.argmin(0)
            ar = torch.arange(p.shape[0], device=p.device)
            R = l2o[w, ar, :3, :3]
            return v[w, ar], (R @ g[w, ar][..., None])[..., 0]

    def _lookup(self, pl: torch.Tensor, mode: str):
        """Lookups of link points ``pl [L, N, 3]``: ``(v [L, N],
        g [L, N, 3])``, constants."""
        out = [t.lookup(pl[l].detach(), mode) for l, t in enumerate(self.tables)]
        return (torch.stack([v for v, _ in out]).to(pl.dtype),
                torch.stack([g for _, g in out]).to(pl.dtype))

    # -- d/dq ----------------------------------------------------------------
    def _terms(self, q: torch.Tensor, pts: torch.Tensor, g: torch.Tensor, mode: str):
        """Per point, each link's term of ``v + g.sum()`` as it moves with
        ``q`` (``[1, dof]`` for every point, or ``[N, dof]``, one a point),
        for looked-up link gradients ``g [L, N, 3]``: ``g . p_link`` (the
        straight-through value) plus the world gradient's sum.  ``[L, N]``."""
        o2l, l2o = self.link_poses(q, mode)                          # [L, C, 4, 4]
        if q.shape[0] == 1:
            o2l, l2o = o2l[:, 0], l2o[:, 0, None]
            pl = self.apply(o2l, pts.to(o2l.dtype))                     # [L, N, 3]
        else:
            pl = self.apply(o2l, pts.to(o2l.dtype)[:, None, :])[:, :, 0, :]
        world = (l2o[..., :3, :3] @ g.to(o2l.dtype)[..., None])[..., 0]
        return (g * pl).sum(-1) + world.sum(-1)

    def dq(self, q1: torch.Tensor, pts: torch.Tensor, mode: str = "f64",
           block: int = 1 << 17):
        """d/dq of ``v.sum() + g.sum()`` over the points ``pts [M, 3]`` under
        one configuration ``q1 [dof]``: ``(dq [dof], slack [dof])``.  With
        ``mode="f64"``, ``slack`` bounds how far rounding can move it: the
        sum over points whose answer is not settled (:meth:`_settled`) of
        the largest change in the point's term between its nominal answer
        and any admissible one.  The control (``"tf32"``) gives no slack."""
        dt = dtype_of(mode)
        dof = q1.shape[-1]
        total = torch.zeros(dof, dtype=torch.float64, device=pts.device)
        slack = torch.zeros_like(total)
        for s in range(0, pts.shape[0], block):
            p = pts[s:s + block]
            n = p.shape[0]
            with torch.no_grad():
                o2l, _ = self.link_poses(q1[None], mode)
                pl = self.apply(o2l[:, 0], p.to(dt))                    # [L, n, 3]
                v, g = self._lookup(pl, mode)
            w = v.argmin(0)
            ar = torch.arange(n, device=p.device)
            qq = q1.detach().to(dt)[None].clone().requires_grad_(True)
            g_w = torch.zeros_like(g)
            g_w[w, ar] = g[w, ar]                     # only the winner's term moves
            (d,) = torch.autograd.grad(self._terms(qq, p, g_w, mode).sum(), qq)
            total = total + d[0].to(torch.float64)
            if mode != "f64":
                continue
            with torch.no_grad():
                c = self._candidates(pl)
                open_ = ~self._settled(c, w)
            if not open_.any():
                continue
            idx = open_.nonzero()[:, 0]
            pa, wa = p[idx], w[idx]
            A = idx.numel()
            # the term is linear in the looked-up gradient: one Jacobian per
            # unit gradient and link, [L, A, dof, 3]
            jac = []
            for k in range(3):
                gk = torch.zeros((len(self.tables), A, 3), dtype=dt, device=p.device)
                gk[..., k] = 1.0
                qa = q1.detach().to(dt)[None].expand(A, dof).clone().requires_grad_(True)
                terms = self._terms(qa, pa, gk, mode)                 # [L, A]
                jac.append(torch.stack([torch.autograd.grad(terms[l].sum(), qa,
                                                            retain_graph=True)[0]
                                        for l in range(terms.shape[0])]))
            jac = torch.stack(jac, dim=-1)                               # [L, A, dof, 3]
            arA = torch.arange(A, device=p.device)
            nominal = (jac[wa, arA] @ g[wa, idx][..., None])[..., 0]     # [A, dof]
            hi_w = c["hi"][wa, idx]
            worst = torch.zeros_like(nominal)
            for l in range(len(self.tables)):
                could = c["lo"][l, idx] <= hi_w + WINNER_SEP
                for cand in range(c["g_c"].shape[1]):
                    alt = (jac[l] @ c["g_c"][l, cand, idx][..., None])[..., 0]
                    worst = torch.maximum(worst, torch.where(
                        could[:, None], (alt - nominal).abs(), 0.0))
            slack = slack + worst.sum(0).to(torch.float64)
        return total, slack
