"""Robot description parsing (URDF, SDF, MJCF) and batched differentiable
forward kinematics.

A description is parsed on the host into a static frame tree; FK is a loop
over the topologically ordered joints on tensors with leading batch
dimensions, differentiable w.r.t. the joint values by autograd.
"""

from __future__ import annotations

import logging
import os
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


def _serial(chain: Chain, end_link_name: str, root_link_name: Optional[str],
            device) -> SerialChain:
    root = chain.root
    if root_link_name is not None:
        root = chain.find_frame(root_link_name)
        if root is None:
            raise ValueError(f"root link {root_link_name!r} not found")
    return SerialChain(root, end_link_name, device=device)


def build_serial_chain_from_urdf(data: str, end_link_name: str,
                                 root_link_name: Optional[str] = None,
                                 device=None) -> SerialChain:
    """The root -> ``end_link_name`` path of a URDF as a serial chain."""
    return _serial(build_chain_from_urdf(data, device=device), end_link_name,
                   root_link_name, device)


# ---------------------------------------------------------------------------
# SDF (Gazebo) parsing
# ---------------------------------------------------------------------------
#
# These parsers produce the same frame tree as the URDF path.  Differences
# handled here: SDF link <pose> elements are in the model frame (not
# relative to the parent) and the joint <pose> is relative to the child
# link, so the static origin becomes X_parent^-1 @ X_child and the motion is
# conjugated by the joint-in-child offset (Joint.joint_offset).

def _pose_matrix(elem) -> np.ndarray:
    """SDF ``<pose>x y z roll pitch yaw</pose>`` -> [4, 4]."""
    m = np.eye(4)
    if elem is not None and elem.text:
        v = _floats(elem.text)
        m[:3, 3] = v[:3]
        if v.size >= 6:
            # rotation evaluated in float32, as the JAX package does
            m[:3, :3] = tfm.rpy_to_matrix(
                torch.as_tensor(v[3:6], dtype=torch.float32)).numpy()
    return m


_SDF_JOINT_TYPES = {"revolute": "revolute", "prismatic": "prismatic",
                    "continuous": "continuous", "fixed": "fixed"}


def _parse_sdf_geometry(geom_elem) -> Tuple[Optional[str], tuple]:
    if geom_elem is None:
        return None, ()
    mesh = geom_elem.find("mesh")
    if mesh is not None:
        uri = mesh.findtext("uri")
        scale_txt = mesh.findtext("scale")
        scale = None
        if scale_txt:
            scale = _uniform_scale(_floats(scale_txt), f"SDF mesh {uri}")
        return "mesh", (uri, scale)
    box = geom_elem.find("box")
    if box is not None:
        return "box", (_floats(box.findtext("size", "")),)
    sphere = geom_elem.find("sphere")
    if sphere is not None:
        return "sphere", (float(sphere.findtext("radius")),)
    cyl = geom_elem.find("cylinder")
    if cyl is not None:
        return "cylinder", (float(cyl.findtext("radius")),
                            float(cyl.findtext("length")))
    return None, ()


def build_chain_from_sdf(data: str, model_name: Optional[str] = None,
                         device=None) -> Chain:
    """Parse a Gazebo ``.sdf`` model (the first, or the one named
    ``model_name``) into a kinematic tree on ``device``."""
    root_elem = ET.fromstring(data)
    model = None
    for m in root_elem.iter("model"):
        if model_name is None or m.get("name") == model_name:
            model = m
            break
    if model is None:
        raise ValueError(f"no <model> named {model_name!r} found")

    links: Dict[str, Link] = {}
    link_pose: Dict[str, np.ndarray] = {}  # model-frame pose of each link
    for link_elem in model.findall("link"):
        name = link_elem.get("name")
        link = Link(name)
        link_pose[name] = _pose_matrix(link_elem.find("pose"))
        for vis_elem in link_elem.findall("visual"):
            gt, gp = _parse_sdf_geometry(vis_elem.find("geometry"))
            link.visuals.append(Visual(gt, gp, _pose_matrix(vis_elem.find("pose"))))
        links[name] = link

    joints: List[Joint] = []
    for j in model.findall("joint"):
        jtype = _SDF_JOINT_TYPES.get(j.get("type", "fixed"))
        if jtype is None:
            logger.warning("Unsupported SDF joint type %s for %s; treating as "
                           "fixed", j.get("type"), j.get("name"))
            jtype = "fixed"
        parent = j.findtext("parent")
        child = j.findtext("child")
        if parent not in links:
            # a joint anchored to the implicit 'world' (or any undeclared)
            # link: an empty root link at the model origin, so the child
            # keeps its model-frame pose
            logger.info("SDF joint %s parent %r is not a declared link; "
                        "adding it as an empty root", j.get("name"), parent)
            links[parent] = Link(parent)
            link_pose[parent] = np.eye(4)
        X_p = link_pose.get(parent, np.eye(4))
        X_c = link_pose.get(child, np.eye(4))
        origin = np.linalg.solve(X_p, X_c)           # parent -> child at q = 0
        joint_offset = _pose_matrix(j.find("pose"))  # child -> joint frame
        axis_elem = j.find("axis")
        axis = np.array([0.0, 0, 1])
        limits = (-np.inf, np.inf)
        if axis_elem is not None:
            xyz = axis_elem.findtext("xyz")
            if xyz:
                axis = _floats(xyz)
            # SDF <= 1.6: <use_parent_model_frame>true</> expresses the axis
            # in the model frame; rotate it into the joint frame (child pose
            # composed with the joint's own <pose>)
            upmf = (axis_elem.findtext("use_parent_model_frame") or "").strip()
            if upmf.lower() in ("1", "true"):
                axis = (X_c @ joint_offset)[:3, :3].T @ axis
            limit_elem = axis_elem.find("limit")
            if limit_elem is not None:
                # SDFormat (unlike URDF) leaves an omitted bound unbounded
                lo_txt = (limit_elem.findtext("lower") or "").strip()
                hi_txt = (limit_elem.findtext("upper") or "").strip()
                limits = (float(lo_txt) if lo_txt else -np.inf,
                          float(hi_txt) if hi_txt else np.inf)
        joints.append(Joint(name=j.get("name"), joint_type=jtype, origin=origin,
                            axis=axis, parent_link=parent, child_link=child,
                            limits=limits, joint_offset=joint_offset))

    return Chain(_assemble_tree(links, joints, "SDF model"), device=device)


def build_serial_chain_from_sdf(data: str, end_link_name: str,
                                root_link_name: Optional[str] = None,
                                device=None) -> SerialChain:
    """The root -> ``end_link_name`` path of an SDF model as a serial chain."""
    return _serial(build_chain_from_sdf(data, device=device), end_link_name,
                   root_link_name, device)


# ---------------------------------------------------------------------------
# MJCF (MuJoCo) parsing
# ---------------------------------------------------------------------------

_MJCF_JOINT_TYPES = {"hinge": "revolute", "slide": "prismatic"}


def _skew(u: np.ndarray) -> np.ndarray:
    return np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])


def _rotation_z_to(d: np.ndarray) -> np.ndarray:
    """Shortest-arc rotation taking +z to the unit vector ``d`` (MuJoCo's
    zaxis / fromto convention)."""
    z = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(z, d))
    if c < -1.0 + 1e-9:  # antiparallel: rotate pi about x
        return np.diag([1.0, -1.0, -1.0])
    K = _skew(np.cross(z, d))
    return np.eye(3) + K + K @ K / (1.0 + c)


def _mjcf_body_matrix(elem, degrees: bool) -> np.ndarray:
    """Body / geom frame from MJCF ``pos`` and an orientation attribute
    (quat | euler | axisangle | xyaxes | zaxis)."""
    m = np.eye(4)
    if elem.get("pos"):
        m[:3, 3] = _floats(elem.get("pos"))
    if elem.get("quat"):
        q = _floats(elem.get("quat"))  # w x y z
        m[:3, :3] = tfm.quaternion_to_matrix(
            torch.as_tensor(q, dtype=torch.float32)).numpy()
    elif elem.get("euler"):
        e = _floats(elem.get("euler"))
        if degrees:
            e = np.deg2rad(e)
        m[:3, :3] = tfm.euler_angles_to_matrix(
            torch.as_tensor(e, dtype=torch.float32), "XYZ").numpy()
    elif elem.get("axisangle"):
        v = _floats(elem.get("axisangle"))
        axis = v[:3] / max(np.linalg.norm(v[:3]), 1e-30)
        ang = float(np.deg2rad(v[3]) if degrees else v[3])
        K = _skew(axis)  # Rodrigues in float64
        m[:3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
    elif elem.get("xyaxes"):
        v = _floats(elem.get("xyaxes"))
        x = v[:3] / max(np.linalg.norm(v[:3]), 1e-30)
        y = v[3:6] - np.dot(x, v[3:6]) * x
        y /= max(np.linalg.norm(y), 1e-30)
        m[:3, :3] = np.stack([x, y, np.cross(x, y)], axis=1)
    elif elem.get("zaxis"):
        v = _floats(elem.get("zaxis"))
        m[:3, :3] = _rotation_z_to(v / max(np.linalg.norm(v), 1e-30))
    return m


def _parse_mjcf_geom(geom, meshes: Dict[str, tuple], degrees: bool,
                     defaults=None, cls: str = "") -> Optional[Visual]:
    """MJCF <geom> -> Visual, translating MuJoCo's half sizes to the full
    sizes the rest of the package uses.  Handles the ``fromto`` segment form
    of capsules and cylinders (frame from the segment, ``size`` is the
    radius) and <default> class resolution of type / size / fromto / mesh."""
    defaults = defaults or {}
    gtype = _mjcf_attr(geom, "type", defaults, cls, "geom", "sphere")
    size = _floats(_mjcf_attr(geom, "size", defaults, cls, "geom", "0"))
    fromto = _mjcf_attr(geom, "fromto", defaults, cls, "geom")
    if fromto and gtype in ("capsule", "cylinder"):
        ft = _floats(fromto)
        p1, p2 = ft[:3], ft[3:6]
        seg = p2 - p1
        length = float(np.linalg.norm(seg))
        offset = np.eye(4)
        offset[:3, 3] = 0.5 * (p1 + p2)
        if length > 1e-12:
            offset[:3, :3] = _rotation_z_to(seg / length)
        return Visual(gtype, (float(size[0]), length), offset)
    offset = _mjcf_body_matrix(geom, degrees)
    if gtype == "mesh":
        name = _mjcf_attr(geom, "mesh", defaults, cls, "geom")
        if name not in meshes:
            logger.warning("MJCF geom references unknown mesh %r", name)
            return None
        return Visual("mesh", meshes[name], offset)
    if gtype == "box":
        return Visual("box", (size * 2.0,), offset)  # half extents -> full
    if gtype == "sphere":
        return Visual("sphere", (float(size[0]),), offset)
    if gtype in ("cylinder", "capsule"):
        return Visual(gtype, (float(size[0]), 2.0 * float(size[1])), offset)
    logger.warning("Unsupported MJCF geom type %r skipped", gtype)
    return None


def _collect_mjcf_defaults(root_elem) -> Dict[str, Dict[str, Dict[str, str]]]:
    """MJCF ``<default>`` classes: class name -> {"joint" | "geom" -> merged
    attributes}.  A nested ``<default class=...>`` inherits its parent's
    attributes; the anonymous top-level default is stored as ``"main"``."""
    table: Dict[str, Dict[str, Dict[str, str]]] = {}

    def walk(delem, inherited):
        merged = {tag: dict(inherited.get(tag, {})) for tag in ("joint", "geom")}
        for tag in ("joint", "geom"):
            e = delem.find(tag)
            if e is not None:
                merged[tag].update(e.attrib)
        table[delem.get("class") or "main"] = merged
        for child in delem.findall("default"):
            walk(child, merged)

    for d in root_elem.findall("default"):
        walk(d, table.get("main", {}))
    return table


def _mjcf_attr(elem, key: str, defaults, cls: str, tag: str, fallback=None):
    """An attribute with MJCF defaults resolution: explicit attribute >
    ``class=`` / inherited ``childclass`` defaults > the anonymous main
    defaults > ``fallback``."""
    v = elem.get(key)
    if v is not None:
        return v
    for c in (elem.get("class") or cls, "main"):
        if c:
            v = defaults.get(c, {}).get(tag, {}).get(key)
            if v is not None:
                return v
    return fallback


def build_chain_from_mjcf(data: str, body: Optional[str] = None,
                          device=None) -> Chain:
    """Parse a MuJoCo MJCF document (from ``<worldbody>``, or from the body
    named ``body``) into a kinematic tree on ``device``.  Hinge and slide
    joints (free and ball joints are treated as fixed, with a warning),
    nested bodies, mesh / box / sphere / cylinder / capsule geoms, angles in
    degrees or radians (``<compiler angle=...>``), and ``<default>`` class
    resolution for joint and geom attributes (``class=`` on the element,
    ``childclass=`` inherited down the body tree)."""
    root_elem = ET.fromstring(data)
    compiler = root_elem.find("compiler")
    degrees = compiler is None or compiler.get("angle", "degree") == "degree"
    defaults = _collect_mjcf_defaults(root_elem)
    meshes: Dict[str, tuple] = {}
    asset = root_elem.find("asset")
    if asset is not None:
        for m in asset.findall("mesh"):
            scale_attr = m.get("scale")
            scale = None
            if scale_attr:
                scale = _uniform_scale(_floats(scale_attr), f"MJCF mesh {m.get('file')}")
            meshes[m.get("name") or os.path.splitext(
                os.path.basename(m.get("file")))[0]] = (m.get("file"), scale)

    worldbody = root_elem.find("worldbody")
    if worldbody is None:
        raise ValueError("MJCF document has no <worldbody>")
    start = worldbody
    if body is not None:
        start = next((b for b in worldbody.iter("body") if b.get("name") == body), None)
        if start is None:
            raise ValueError(f"body {body!r} not found")

    unnamed = [0]

    def body_name(b):
        n = b.get("name")
        if n is None:
            unnamed[0] += 1
            n = f"body{unnamed[0]}"
        return n

    def build(body_elem, parent_name: Optional[str], cls: str = "") -> Frame:
        name = body_name(body_elem) if body_elem.tag == "body" else (body or "world")
        cls = body_elem.get("childclass") or cls  # inherited down the tree
        link = Link(name)
        for geom in body_elem.findall("geom"):
            v = _parse_mjcf_geom(geom, meshes, degrees, defaults, cls)
            if v is not None:
                link.visuals.append(v)
        joint = None
        if body_elem.tag == "body" and parent_name is not None:
            origin = _mjcf_body_matrix(body_elem, degrees)
            joint_elems = body_elem.findall("joint")
            if len(joint_elems) > 1:
                logger.warning("body %s has %d joints; only the first is "
                               "actuated", name, len(joint_elems))
            je = joint_elems[0] if joint_elems else None

            def jattr(key, fallback=None):
                return _mjcf_attr(je, key, defaults, cls, "joint", fallback)

            if je is not None and jattr("type", "hinge") in _MJCF_JOINT_TYPES:
                jtype = _MJCF_JOINT_TYPES[jattr("type", "hinge")]
                axis_attr = jattr("axis")
                axis = _floats(axis_attr) if axis_attr else np.array([0.0, 0, 1])
                joint_offset = np.eye(4)
                if jattr("pos"):
                    joint_offset[:3, 3] = _floats(jattr("pos"))
                limits = (-np.inf, np.inf)
                if jattr("range"):
                    r = _floats(jattr("range"))
                    if degrees and jtype == "revolute":
                        r = np.deg2rad(r)
                    limits = (float(r[0]), float(r[1]))
                joint = Joint(name=je.get("name") or f"{name}_joint",
                              joint_type=jtype, origin=origin, axis=axis,
                              parent_link=parent_name, child_link=name,
                              limits=limits, joint_offset=joint_offset)
            else:
                if je is not None:
                    logger.warning("Unsupported MJCF joint type %r on body %s; "
                                   "treating as fixed", jattr("type"), name)
                joint = Joint(name=f"{name}_fixed", joint_type="fixed",
                              origin=origin, axis=np.array([0.0, 0, 1]),
                              parent_link=parent_name, child_link=name)
        f = Frame(name, link, joint, [])
        for child in body_elem.findall("body"):
            f.children.append(build(child, name, cls))
        return f

    return Chain(build(start, None), device=device)


def build_serial_chain_from_mjcf(data: str, end_link_name: str,
                                 root_link_name: Optional[str] = None,
                                 device=None) -> SerialChain:
    """The root -> ``end_link_name`` path of an MJCF body tree as a serial
    chain."""
    return _serial(build_chain_from_mjcf(data, device=device), end_link_name,
                   root_link_name, device)
