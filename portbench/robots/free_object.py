"""One mesh with a free 6-DOF pose: three prismatic then three revolute
virtual joints (``pytorch_volumetric_tpu_torch/utils/robots.py``'s
``make_free_object_urdf``, frozen; the reference's ``offset_wrench.urdf``
pattern).  The mesh is ``robot.mesh``, a specification for
``workload.make_mesh``."""

import os

from portbench import workload


def write(cfg: dict, directory: str, bench_dir: str) -> workload.Assets:
    r = cfg["robot"]
    name = r["object_name"]
    workload.save_obj(*workload.make_mesh(r["mesh"], bench_dir),
                      os.path.join(directory, f"{name}.obj"))
    virtual = ["link_x_trans", "link_y_trans", "link_z_trans",
               "link_x_rot", "link_y_rot", "link_z_rot"]
    lines = [f'<robot name="{name}">'] + [f'  <link name="{v}"/>' for v in virtual]
    lines += [f'  <link name="{name}">',
              f'    <visual><geometry><mesh filename="{name}.obj"/></geometry></visual>',
              '  </link>']
    chain = virtual + [name]
    specs = [("x_trans", "prismatic", "1 0 0"), ("y_trans", "prismatic", "0 1 0"),
             ("z_trans", "prismatic", "0 0 1"), ("x_rot", "revolute", "1 0 0"),
             ("y_rot", "revolute", "0 1 0"), ("z_rot", "revolute", "0 0 1")]
    for i, (jname, jtype, axis) in enumerate(specs):
        lines += [f'  <joint name="{jname}" type="{jtype}">',
                  '    <origin xyz="0 0 0" rpy="0 0 0"/>',
                  f'    <parent link="{chain[i]}"/>', f'    <child link="{chain[i + 1]}"/>',
                  f'    <axis xyz="{axis}"/>',
                  '    <limit effort="100" lower="-10" upper="10" velocity="100"/>',
                  '  </joint>']
    lines.append('</robot>')
    urdf = os.path.join(directory, f"{name}.urdf")
    with open(urdf, "w") as f:
        f.write("\n".join(lines))
    return workload.Assets(directory, urdf, name)
