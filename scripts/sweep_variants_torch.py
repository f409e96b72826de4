#!/usr/bin/env python3
"""The sweep kernel's levers and design variants, timed side by side on
one GPU.

    python3 scripts/sweep_variants_torch.py [--reps N]

Builds copies of ``pytorch_volumetric_tpu_torch/csrc/closest_point.cu``
with one compile-time choice changed (cluster culling off, clusters of 4 or
16 faces, a minimum of 8 resident blocks per SM, which caps registers at
64), each as its own library under ``_build/``.  Each row of ``ROWS`` is
one of them, called with or without the scene's exterior box; the first
three switch the levers on one by one (select-then-divide and padding
skipped are always on).  Each row is timed on the capsule's cache-build
grid and on the probe's torus, with the pairs it evaluates there, and the
rows that take the box on the exact-link robot's forward query (200
configurations x 15,251 points) too.  Every row's distances, closest
points and face ids must equal the shipped kernel's (``same``).  Prints one
JSON line; exits non-zero without a CUDA device or when a row differs.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

LAUNCH = "__global__ void __launch_bounds__(kThreads)"
CLUSTER = "constexpr int kCluster = 8;"
CULL = "constexpr bool kCull = true;"

# row -> (source variant, whether the call passes the scene's exterior box)
ROWS = {
    "levers 1+2: select-then-divide, padding skipped": ("no culling", False),
    "+3: exterior winding": ("no culling", True),
    "+4: cluster culling (shipped)": ("shipped", True),
    "clusters of 4": ("clusters of 4", True),
    "clusters of 16": ("clusters of 16", True),
    "at most 64 registers": ("min 8 blocks/SM", True),
}


def variants(src: str) -> dict:
    """name -> source text of each variant (``shipped`` is the source)."""
    out = {"shipped": src,
           "no culling": src.replace(CULL, CULL.replace("true", "false")),
           "clusters of 4": src.replace(CLUSTER, CLUSTER.replace("8", "4")),
           "clusters of 16": src.replace(CLUSTER, CLUSTER.replace("8", "16")),
           "min 8 blocks/SM": src.replace(LAUNCH, LAUNCH[:-1] + ", 8)")}
    for name, text in out.items():
        if name != "shipped" and text == src:
            raise RuntimeError(f"variant {name!r} no longer applies to the source")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_variants: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr
    from pytorch_volumetric_tpu_torch.ops import closest_point as cp
    from pytorch_volumetric_tpu_torch.ops import cuda_build
    from pytorch_volumetric_tpu_torch.utils.profiling import device_time
    from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm

    dev = torch.device("cuda", 0)
    with open(os.path.join(cuda_build.CSRC_DIR, "closest_point.cu")) as f:
        src = f.read()
    vdir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(vdir, exist_ok=True)
    libs = {}
    for i, (name, text) in enumerate(variants(src).items()):
        path = os.path.join(vdir, f"closest_point_v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        libs[name] = f"closest_point_v{i}"
        cuda_build.SOURCES[libs[name]] = (path, cuda_build.SOURCES["closest_point"][1])
    cuda_build.build(list(libs.values()) + ["closest_point"])

    grid, cap = sr.capsule_cache_grid(dev)
    pts, torus = sr.torus_inputs(dev)
    tmp = tempfile.mkdtemp()
    make_serial_arm(tmp, num_joints=7)
    q, qpts = cs.headline_inputs(dev)
    with open(os.path.join(tmp, "arm.urdf")) as f:
        robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(f.read(), "link7", device=dev),
                            path_prefix=tmp)
    cells = {"capsule_grid": (grid, cap), "torus": (pts, torus)}
    refs = {c: cp.mesh_closest_query_cuda(p, s.tri, exterior_box=s.exterior_box)
            for c, (p, s) in cells.items()}
    with torch.no_grad():
        ref_robot = robot.query(q, qpts)

    def fwd():
        with torch.no_grad():
            return robot.query(q, qpts)

    out, ok = {}, True
    saved = cp.KERNEL
    try:
        for name, (variant, use_box) in ROWS.items():
            cp.KERNEL = libs[variant]
            row = {"variant": variant, "exterior_box": use_box}
            for cell, (p, s) in cells.items():
                def sweep(a, t, box=s.exterior_box if use_box else None):
                    return cp.mesh_closest_query_cuda(a, t, exterior_box=box)
                res = sweep(p, s.tri)
                P, F = p.shape[0], s.num_faces
                ev = sr.evaluated_pairs(cp.mesh_closest_query_cuda, p, s.tri,
                                        exterior_box=s.exterior_box if use_box else None)
                reps = args.reps if cell == "capsule_grid" else max(1, args.reps // 3)
                row[cell] = dict(ev, closest_share=ev["closest_pairs"] / (P * F),
                                 winding_share=ev["winding_pairs"] / (P * F),
                                 ms=device_time(sweep, p, s.tri, reps=reps, warmup=0) * 1e3,
                                 same=all(torch.equal(a, b)
                                          for a, b in zip(res[:3], refs[cell][:3])),
                                 winding_err=(res[3] - refs[cell][3]).abs().max().item())
            if use_box:  # MeshSDF always passes the box
                v, g = fwd()
                same = torch.equal(v, ref_robot[0]) and torch.equal(g, ref_robot[1])
                row["exact_forward"] = {"ms": cs.time_ms(fwd, dev, reps=5), "same": same}
            ok = ok and all(r["same"] for r in row.values() if isinstance(r, dict))
            out[name] = row
    finally:
        cp.KERNEL = saved
    print(json.dumps({"metric": "sweep_variants", "ok": ok, "card": sr.card_name(),
                      "rows": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
