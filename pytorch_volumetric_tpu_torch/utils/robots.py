"""Procedural robot descriptions (test and benchmark assets): closed link
meshes plus URDF text, byte-for-byte the files the JAX package writes."""

from __future__ import annotations

import os
import shutil
from typing import List, Tuple

import numpy as np

from pytorch_volumetric_tpu_torch import mesh as mesh_mod


def make_serial_arm(directory: str, num_joints: int = 7,
                    link_length: float = 0.18, link_radius: float = 0.045,
                    segments: int = 14, rings: int = 5) -> Tuple[str, str]:
    """Write a ``num_joints``-DOF serial arm (base cylinder + ``num_joints``
    capsule links sharing one mesh file) into ``directory``.

    Returns ``(urdf_path, end_link_name)``.  Joint axes alternate z/y and
    each visual has a small origin offset.
    """
    os.makedirs(directory, exist_ok=True)
    base = mesh_mod.cylinder_mesh(radius=2.2 * link_radius, height=0.1, segments=20)
    mesh_mod.save_obj(base, os.path.join(directory, "link0.obj"))
    # one shared capsule file: one parse and one CachedSDF entry for all links
    cap = mesh_mod.capsule_mesh(radius=link_radius, height=link_length,
                                segments=segments, rings=rings)
    mesh_mod.save_obj(cap, os.path.join(directory, "link_cap.obj"))

    lines: List[str] = ['<robot name="procedural_arm">']
    lines.append('  <link name="link0">')
    lines.append('    <visual><origin xyz="0 0 0.05" rpy="0 0 0"/>'
                 '<geometry><mesh filename="link0.obj"/></geometry></visual>')
    lines.append('  </link>')
    for i in range(1, num_joints + 1):
        lines.append(f'  <link name="link{i}">')
        lines.append(f'    <visual><origin xyz="0 0 {link_length / 2:.6g}" rpy="0 0 0"/>'
                     '<geometry><mesh filename="link_cap.obj"/></geometry></visual>')
        lines.append('  </link>')
    z_step = 0.1  # base height
    for i in range(1, num_joints + 1):
        axis = "0 0 1" if i % 2 == 1 else "0 1 0"
        origin_z = z_step if i == 1 else link_length
        lines.append(f'  <joint name="joint{i}" type="revolute">')
        lines.append(f'    <origin xyz="0 0 {origin_z:.6g}" rpy="0 0 0"/>')
        lines.append(f'    <parent link="link{i - 1}"/>')
        lines.append(f'    <child link="link{i}"/>')
        lines.append(f'    <axis xyz="{axis}"/>')
        lines.append('    <limit effort="100" lower="-2.9" upper="2.9" velocity="10"/>')
        lines.append('  </joint>')
    lines.append('</robot>')

    urdf_path = os.path.join(directory, "arm.urdf")
    with open(urdf_path, "w") as f:
        f.write("\n".join(lines))
    return urdf_path, f"link{num_joints}"


def make_mesh_arm(directory: str, mesh_files: List[str],
                  num_joints: int = 7, link_length: float = 0.18,
                  base_height: float = 0.1) -> Tuple[str, str]:
    """Write a ``num_joints``-DOF serial arm whose links are real mesh files,
    cycled across the base and moving links.  Each visual is scaled so the
    mesh's longest AABB axis spans ``link_length``, rotated onto the link's
    +z and offset to run z in [0, link_length].  Returns
    ``(urdf_path, end_link_name)``."""
    os.makedirs(directory, exist_ok=True)
    placements = []  # (local filename, scale, rpy, z_offset)
    for src in mesh_files:
        local = os.path.basename(src)
        dst = os.path.join(directory, local)
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.copyfile(src, dst)
        m = mesh_mod.read_triangle_mesh(dst)
        lo, hi = m.vertices.min(0), m.vertices.max(0)
        ext = hi - lo
        axis = int(np.argmax(ext))
        scale = link_length / float(ext[axis])
        # R_y(-pi/2) maps +x->+z, R_x(pi/2) maps +y->+z
        rpy = {0: "0 -1.5707963 0", 1: "1.5707963 0 0", 2: "0 0 0"}[axis]
        z_off = -float(lo[axis]) * scale
        placements.append((local, scale, rpy, z_off))

    lines: List[str] = ['<robot name="mesh_arm">']
    for i in range(num_joints + 1):
        local, scale, rpy, z_off = placements[i % len(placements)]
        lines.append(f'  <link name="link{i}">')
        lines.append(f'    <visual><origin xyz="0 0 {z_off:.6g}" rpy="{rpy}"/>'
                     f'<geometry><mesh filename="{local}" '
                     f'scale="{scale:.6g} {scale:.6g} {scale:.6g}"/>'
                     '</geometry></visual>')
        lines.append('  </link>')
    for i in range(1, num_joints + 1):
        axis = "0 0 1" if i % 2 == 1 else "0 1 0"
        origin_z = base_height if i == 1 else link_length
        lines.append(f'  <joint name="joint{i}" type="revolute">')
        lines.append(f'    <origin xyz="0 0 {origin_z:.6g}" rpy="0 0 0"/>')
        lines.append(f'    <parent link="link{i - 1}"/>')
        lines.append(f'    <child link="link{i}"/>')
        lines.append(f'    <axis xyz="{axis}"/>')
        lines.append('    <limit effort="100" lower="-2.9" upper="2.9" velocity="10"/>')
        lines.append('  </joint>')
    lines.append('</robot>')

    urdf_path = os.path.join(directory, "mesh_arm.urdf")
    with open(urdf_path, "w") as f:
        f.write("\n".join(lines))
    return urdf_path, f"link{num_joints}"


def make_free_object_urdf(directory: str, mesh_filename: str,
                          object_name: str = "free_object") -> Tuple[str, str]:
    """Write a URDF giving one mesh link a free 6-DOF pose through 3
    prismatic + 3 revolute virtual joints."""
    os.makedirs(directory, exist_ok=True)
    lines = [f'<robot name="{object_name}">']
    virtual = ["link_x_trans", "link_y_trans", "link_z_trans",
               "link_x_rot", "link_y_rot", "link_z_rot"]
    for name in virtual:
        lines.append(f'  <link name="{name}"/>')
    lines.append(f'  <link name="{object_name}">')
    lines.append(f'    <visual><geometry><mesh filename="{mesh_filename}"/>'
                 '</geometry></visual>')
    lines.append('  </link>')
    chain = virtual + [object_name]
    specs = [("x_trans", "prismatic", "1 0 0"), ("y_trans", "prismatic", "0 1 0"),
             ("z_trans", "prismatic", "0 0 1"), ("x_rot", "revolute", "1 0 0"),
             ("y_rot", "revolute", "0 1 0"), ("z_rot", "revolute", "0 0 1")]
    for i, (jname, jtype, axis) in enumerate(specs):
        lines.append(f'  <joint name="{jname}" type="{jtype}">')
        lines.append('    <origin xyz="0 0 0" rpy="0 0 0"/>')
        lines.append(f'    <parent link="{chain[i]}"/>')
        lines.append(f'    <child link="{chain[i + 1]}"/>')
        lines.append(f'    <axis xyz="{axis}"/>')
        lines.append('    <limit effort="100" lower="-10" upper="10" velocity="100"/>')
        lines.append('  </joint>')
    lines.append('</robot>')
    urdf_path = os.path.join(directory, f"{object_name}.urdf")
    with open(urdf_path, "w") as f:
        f.write("\n".join(lines))
    return urdf_path, object_name
