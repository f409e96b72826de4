"""URDF parsing and batched differentiable forward kinematics.

The URDF is parsed on the host into a static frame tree; FK is a loop over
the topologically ordered joints on tensors with leading batch dimensions,
differentiable w.r.t. the joint values by autograd.
"""

from __future__ import annotations

import logging
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_volumetric_tpu_torch import transforms as tfm
from pytorch_volumetric_tpu_torch.utils.batching import (
    as_float_tensor, resolve_device)

logger = logging.getLogger(__name__)

ACTUATED_TYPES = ("revolute", "continuous", "prismatic")


def _origin_matrix(elem) -> np.ndarray:
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    if elem is not None:
        if elem.get("xyz"):
            xyz = np.array(elem.get("xyz").split(), dtype=np.float64)
        if elem.get("rpy"):
            rpy = np.array(elem.get("rpy").split(), dtype=np.float64)
    m = np.eye(4)
    # rotation evaluated in float32, as the JAX package does
    m[:3, :3] = tfm.rpy_to_matrix(torch.as_tensor(rpy, dtype=torch.float32)).numpy()
    m[:3, 3] = xyz
    return m


@dataclass
class Visual:
    """A link's visual geometry.  For meshes ``geom_param`` is
    ``(filename, scale)``."""
    geom_type: Optional[str]
    geom_param: tuple
    offset: np.ndarray  # [4, 4] visual origin in the link frame


@dataclass
class Link:
    name: str
    visuals: List[Visual] = field(default_factory=list)


@dataclass
class Joint:
    name: str
    joint_type: str          # revolute | continuous | prismatic | fixed
    origin: np.ndarray       # [4, 4] static transform parent->child frame (q=0)
    axis: np.ndarray         # [3]
    parent_link: str
    child_link: str
    limits: Tuple[float, float] = (-np.inf, np.inf)
    # joint placed at an offset inside the child frame: the motion is
    # conjugated, child(q) = origin @ offset @ motion(q) @ offset^-1
    joint_offset: Optional[np.ndarray] = None  # [4, 4]
    # URDF <mimic>: value = multiplier * q[master] + offset, not its own DOF
    mimic: Optional[Tuple[str, float, float]] = None


@dataclass
class Frame:
    """A node of the kinematic tree: the joint that attaches it to its parent
    plus the link living at this frame."""
    name: str
    link: Link
    joint: Optional[Joint]   # None at the root
    children: List["Frame"] = field(default_factory=list)


class Chain:
    """Kinematic tree with batched FK on ``device``.

    ``forward_kinematics(q [.., M], end_only=False)`` returns a dict
    ``frame name -> Transform3d`` with matrices ``[.., 4, 4]``.
    """

    def __init__(self, root: Frame, device=None):
        self.root = root
        self.dtype = torch.float32
        self.device = resolve_device(device)
        # topological order (DFS, document order of children)
        self._ordered: List[Frame] = []

        def visit(f: Frame):
            self._ordered.append(f)
            for c in f.children:
                visit(c)

        visit(root)
        self._frames_by_name = {f.name: f for f in self._ordered}
        self._joint_names = [f.joint.name for f in self._ordered
                             if f.joint is not None
                             and f.joint.joint_type in ACTUATED_TYPES
                             and f.joint.mimic is None]
        # mimic resolution: driven joint -> (master name, multiplier, offset)
        self._mimic = {}
        by_name = {f.joint.name: f.joint for f in self._ordered
                   if f.joint is not None}
        for f in self._ordered:
            j = f.joint
            if j is None or j.mimic is None:
                continue
            master, mult, off = j.mimic
            if master not in by_name:
                raise ValueError(f"mimic joint {j.name} references unknown "
                                 f"joint {master}")
            if by_name[master].mimic is not None:
                raise ValueError(f"chained mimic ({j.name} -> {master}) is "
                                 "not supported")
            if by_name[master].joint_type not in ACTUATED_TYPES:
                raise ValueError(
                    f"mimic joint {j.name} references "
                    f"{by_name[master].joint_type!r} joint {master}; the "
                    "mimic master must be an actuated non-mimic joint")
            self._mimic[j.name] = (master, float(mult), float(off))
        self._static = self._static_tensors(self.device)

    def _static_tensors(self, device: torch.device):
        """Per-frame origins, unit axes and joint offsets as float32 tensors.
        Axes are normalized here (float64) so every joint type sees a unit
        axis."""
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

        origins, axes, offsets = {}, {}, {}
        for f in self._ordered:
            j = f.joint
            origins[f.name] = t(j.origin if j is not None else np.eye(4))
            a = np.asarray(j.axis if j is not None else [0.0, 0, 1], dtype=np.float64)
            axes[f.name] = t(a / max(np.linalg.norm(a), 1e-30))
            if j is not None and j.joint_offset is not None \
                    and not np.allclose(j.joint_offset, np.eye(4)):
                off = np.asarray(j.joint_offset, dtype=np.float64)
                offsets[f.name] = (t(off), t(np.linalg.inv(off)))
        return origins, axes, offsets

    # -- introspection (pytorch_kinematics API surface) ----------------------
    def get_joint_parameter_names(self, exclude_fixed=True) -> List[str]:
        return list(self._joint_names)

    def get_joint_limits(self, fallback: float = np.pi) -> np.ndarray:
        """``[M, 2]`` (lower, upper) per actuated joint; joints without
        finite limits fall back to ``+-fallback``."""
        joints = {f.joint.name: f.joint for f in self._ordered
                  if f.joint is not None}
        lims = []
        for n in self._joint_names:
            lo, hi = joints[n].limits
            lims.append((lo if np.isfinite(lo) else -fallback,
                         hi if np.isfinite(hi) else fallback))
        return np.asarray(lims, dtype=np.float32)

    def get_frame_names(self, exclude_fixed=False) -> List[str]:
        if exclude_fixed:
            return [f.name for f in self._ordered
                    if f.joint is None or f.joint.joint_type in ACTUATED_TYPES]
        return [f.name for f in self._ordered]

    def find_frame(self, name: str) -> Optional[Frame]:
        return self._frames_by_name.get(name)

    def find_link(self, name: str) -> Optional[Link]:
        f = self._frames_by_name.get(name)
        return f.link if f is not None else None

    @property
    def n_joints(self) -> int:
        return len(self._joint_names)

    def to(self, dtype=None, device=None) -> "Chain":
        if device is not None:
            self.device = resolve_device(device)
            self._static = self._static_tensors(self.device)
        return self

    # -- FK -------------------------------------------------------------------
    def _joint_motion(self, frame: Frame, q: torch.Tensor) -> torch.Tensor:
        """[.., 4, 4] motion of one joint given its scalar value ``q [..]``."""
        axis = self._static[1][frame.name]
        jt = frame.joint.joint_type
        if jt in ("revolute", "continuous"):
            return tfm.make_tf(rot=tfm.axis_angle_to_matrix(axis, q))
        if jt == "prismatic":
            return tfm.make_tf(pos=axis * q[..., None])
        return torch.eye(4, dtype=q.dtype, device=q.device).expand(q.shape + (4, 4))

    def fk_matrices(self, q) -> Dict[str, torch.Tensor]:
        """Differentiable FK: ``q [.., M]`` -> dict of world matrices
        ``[.., 4, 4]`` for every frame."""
        q = as_float_tensor(q, self.device)
        if q.shape[-1] != len(self._joint_names):
            raise ValueError(
                f"expected {len(self._joint_names)} joint values "
                f"({self._joint_names}), got shape {tuple(q.shape)}")
        batch = q.shape[:-1]
        jidx = {n: i for i, n in enumerate(self._joint_names)}
        origins, _, offsets = self._static
        world: Dict[str, torch.Tensor] = {}
        eye = torch.eye(4, dtype=q.dtype, device=q.device).expand(batch + (4, 4))

        def visit(f: Frame, parent_m):
            m = parent_m
            if f.joint is not None:
                m = tfm.mm(m, origins[f.name])
                if f.joint.joint_type in ACTUATED_TYPES:
                    mim = self._mimic.get(f.joint.name)
                    if mim is not None:
                        master, mult, off = mim
                        qi = mult * q[..., jidx[master]] + off
                    else:
                        qi = q[..., jidx[f.joint.name]]
                    motion = self._joint_motion(f, qi)
                    joff = offsets.get(f.name)
                    if joff is not None:
                        motion = tfm.mm(tfm.mm(joff[0], motion), joff[1])
                    m = tfm.mm(m, motion)
            world[f.name] = m
            for c in f.children:
                visit(c, m)

        visit(self.root, eye)
        return world

    def forward_kinematics(self, th, end_only: bool = False):
        """Batched FK returning a ``Transform3d`` per frame."""
        th = as_float_tensor(th, self.device)
        if th.ndim == 0:
            th = th.reshape(1)
        out = {name: tfm.Transform3d(matrix=m)
               for name, m in self.fk_matrices(th).items()}
        if end_only:
            return out[self._ordered[-1].name]
        return out


class SerialChain(Chain):
    """A root -> end path of the tree (``build_serial_chain_from_urdf``)."""

    def __init__(self, root: Frame, end_frame_name: str, device=None):
        path: List[Frame] = []

        def find(f: Frame, trail):
            trail.append(f)
            if f.name == end_frame_name:
                path.extend(trail)
                return True
            for c in f.children:
                if find(c, trail):
                    return True
            trail.pop()
            return False

        if not find(root, []):
            raise ValueError(f"end frame {end_frame_name!r} not found")
        # rebuild a pruned single-branch tree; a kept joint whose mimic master
        # was pruned becomes an independent DOF
        kept_joints = {f.joint.name for f in path if f.joint is not None}
        pruned = None
        prev = None
        for f in path:
            joint = f.joint
            if joint is not None and joint.mimic is not None \
                    and joint.mimic[0] not in kept_joints:
                logger.warning(
                    "serial chain pruned the branch holding %s's mimic "
                    "master %s; treating %s as an independent joint",
                    joint.name, joint.mimic[0], joint.name)
                joint = replace(joint, mimic=None)
            node = Frame(f.name, f.link, joint, [])
            if prev is not None:
                prev.children.append(node)
            else:
                pruned = node
            prev = node
        super().__init__(pruned, device=device)
        self.end_frame_name = end_frame_name

    def forward_kinematics(self, th, end_only: bool = False):
        out = super().forward_kinematics(th, end_only=False)
        if end_only:
            return out[self.end_frame_name]
        return out


# ---------------------------------------------------------------------------
# URDF parsing
# ---------------------------------------------------------------------------

def _uniform_scale(s: np.ndarray, context: str) -> float:
    """Collapse a 1-3 component mesh ``scale`` to one float, warning on
    non-uniform components (mesh scale is applied uniformly)."""
    if s.size == 0:
        return 1.0
    if s.size > 1 and not np.allclose(s, s[0]):
        logger.warning("non-uniform mesh scale %s in %s is not supported; "
                       "using the x component %g uniformly", s, context, s[0])
    return float(s[0])


def _parse_limits(lower, upper, present: bool) -> Tuple[float, float]:
    """Joint limits from optional lower/upper strings: an omitted bound
    defaults to 0 when the other is given; a <limit> with neither stays
    unbounded."""
    lower = lower.strip() if isinstance(lower, str) else lower
    upper = upper.strip() if isinstance(upper, str) else upper
    if not present or (not lower and not upper):
        return (-np.inf, np.inf)
    return (float(lower) if lower else 0.0, float(upper) if upper else 0.0)


def _assemble_tree(links: Dict[str, Link], joints: List[Joint], fmt: str) -> Frame:
    children = {j.child_link for j in joints}
    roots = [name for name in links if name not in children]
    if len(roots) != 1:
        raise ValueError(f"{fmt} must have exactly one root link, got {roots}")
    by_parent: Dict[str, List[Joint]] = {}
    for j in joints:
        by_parent.setdefault(j.parent_link, []).append(j)

    def build(link_name: str, joint: Optional[Joint]) -> Frame:
        f = Frame(link_name, links[link_name], joint, [])
        for j in by_parent.get(link_name, []):
            f.children.append(build(j.child_link, j))
        return f

    return build(roots[0], None)


def _floats(text: str) -> np.ndarray:
    return np.array(text.split(), dtype=np.float64)


def _parse_geometry(geom_elem) -> Tuple[Optional[str], tuple]:
    if geom_elem is None:
        return None, ()
    mesh = geom_elem.find("mesh")
    if mesh is not None:
        scale = mesh.get("scale")
        if scale is not None:
            scale = _uniform_scale(_floats(scale), f"URDF mesh {mesh.get('filename')}")
        return "mesh", (mesh.get("filename"), scale)
    box = geom_elem.find("box")
    if box is not None:
        return "box", (_floats(box.get("size")),)
    sphere = geom_elem.find("sphere")
    if sphere is not None:
        return "sphere", (float(sphere.get("radius")),)
    cyl = geom_elem.find("cylinder")
    if cyl is not None:
        return "cylinder", (float(cyl.get("radius")), float(cyl.get("length")))
    return None, ()


def build_chain_from_urdf(data: str, device=None) -> Chain:
    """Parse a URDF string into a kinematic tree on ``device``."""
    robot = ET.fromstring(data)
    links: Dict[str, Link] = {}
    for link_elem in robot.findall("link"):
        link = Link(link_elem.get("name"))
        for vis_elem in link_elem.findall("visual"):
            gt, gp = _parse_geometry(vis_elem.find("geometry"))
            link.visuals.append(Visual(gt, gp, _origin_matrix(vis_elem.find("origin"))))
        links[link.name] = link

    joints: List[Joint] = []
    for j in robot.findall("joint"):
        jtype = j.get("type", "fixed")
        if jtype not in ACTUATED_TYPES + ("fixed",):
            logger.warning("Unsupported joint type %s for %s; treating as fixed",
                           jtype, j.get("name"))
            jtype = "fixed"
        axis_elem = j.find("axis")
        axis = (_floats(axis_elem.get("xyz")) if axis_elem is not None
                else np.array([1.0, 0, 0]))
        limit_elem = j.find("limit")
        limits = _parse_limits(
            limit_elem.get("lower") if limit_elem is not None else None,
            limit_elem.get("upper") if limit_elem is not None else None,
            present=limit_elem is not None)
        mimic_elem = j.find("mimic")
        mimic = None
        if mimic_elem is not None and jtype in ACTUATED_TYPES:
            mimic = (mimic_elem.get("joint"),
                     float(mimic_elem.get("multiplier", 1.0)),
                     float(mimic_elem.get("offset", 0.0)))
        joints.append(Joint(
            name=j.get("name"), joint_type=jtype,
            origin=_origin_matrix(j.find("origin")), axis=axis,
            parent_link=j.find("parent").get("link"),
            child_link=j.find("child").get("link"), limits=limits,
            mimic=mimic))

    return Chain(_assemble_tree(links, joints, "URDF"), device=device)


def build_serial_chain_from_urdf(data: str, end_link_name: str,
                                 root_link_name: Optional[str] = None,
                                 device=None) -> SerialChain:
    """The root -> ``end_link_name`` path of a URDF as a serial chain."""
    chain = build_chain_from_urdf(data, device=device)
    root = chain.root
    if root_link_name is not None:
        root = chain.find_frame(root_link_name)
        if root is None:
            raise ValueError(f"root link {root_link_name!r} not found")
    return SerialChain(root, end_link_name, device=device)
