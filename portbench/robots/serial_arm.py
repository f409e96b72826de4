"""A serial arm (``pytorch_volumetric_tpu_torch/utils/robots.py``'s
``make_serial_arm``, frozen): a base cylinder, then ``num_joints`` capsule
links joined by revolute joints alternating about z and y."""

import os

from portbench import workload


def write(cfg: dict, directory: str, bench_dir: str) -> workload.Assets:
    r = cfg["robot"]
    n, length, radius = r["num_joints"], r["link_length"], r["link_radius"]
    base = r["base"]
    workload.save_obj(*workload.make_mesh({"kind": "cylinder",
                                           "radius": base["radius_factor"] * radius,
                                           "height": base["height"],
                                           "segments": base["segments"]}, bench_dir),
                      os.path.join(directory, "link0.obj"))
    workload.save_obj(*workload.make_mesh({"kind": "capsule", "radius": radius,
                                           "height": length, "segments": r["segments"],
                                           "rings": r["rings"]}, bench_dir),
                      os.path.join(directory, "link_cap.obj"))
    lines = ['<robot name="procedural_arm">', '  <link name="link0">',
             f'    <visual><origin xyz="0 0 {base["height"] / 2:.6g}" rpy="0 0 0"/>'
             '<geometry><mesh filename="link0.obj"/></geometry></visual>', '  </link>']
    for i in range(1, n + 1):
        lines += [f'  <link name="link{i}">',
                  f'    <visual><origin xyz="0 0 {length / 2:.6g}" rpy="0 0 0"/>'
                  '<geometry><mesh filename="link_cap.obj"/></geometry></visual>', '  </link>']
    for i in range(1, n + 1):
        axis = "0 0 1" if i % 2 == 1 else "0 1 0"
        origin_z = base["height"] if i == 1 else length
        lines += [f'  <joint name="joint{i}" type="revolute">',
                  f'    <origin xyz="0 0 {origin_z:.6g}" rpy="0 0 0"/>',
                  f'    <parent link="link{i - 1}"/>', f'    <child link="link{i}"/>',
                  f'    <axis xyz="{axis}"/>',
                  '    <limit effort="100" lower="-2.9" upper="2.9" velocity="10"/>',
                  '  </joint>']
    lines.append('</robot>')
    urdf = os.path.join(directory, "arm.urdf")
    with open(urdf, "w") as f:
        f.write("\n".join(lines))
    return workload.Assets(directory, urdf, f"link{n}")
