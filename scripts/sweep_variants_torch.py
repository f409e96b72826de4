#!/usr/bin/env python3
"""The sweep kernels' levers and design variants, timed side by side on
one GPU.

    python3 scripts/sweep_variants_torch.py [--reps N] [--only K1|mxu]

Builds copies of ``pytorch_volumetric_tpu_torch/csrc/closest_point.cu``
(K1) and ``csrc/closest_point_mma.cu`` (the tensor-core sweep, "mxu") with
one compile-time choice changed, each as its own library under ``_build/``:
for K1 cluster culling off, clusters of 4 or 16 faces, and a minimum of 8
resident blocks per SM (which caps registers at 64); for mxu culling off,
the products as the warpgroup's ``wgmma`` or on the FP32 lanes in place of
each warp's ``mma.sync`` (``kProducts``), and minimums of 4, 5 or 6
resident blocks per SM (at most 128, 102 or 85 registers).  The JSON line
gives each library's registers and spills as ``ptxas -v`` reports them.
Each row of ``ROWS`` is one of them, called with or without the
scene's exterior box; the first rows of each kernel switch its levers on
one by one (select-then-divide and padding skipped are always on, and in
mxu the folded constants and the frames too).  Each row is timed on the
capsule's cache-build grid and on the probe's torus, with the pairs it
evaluates there (the shipped rows also with the sweep kernel's own
device time from ``torch.profiler``), and the K1 rows that take the box on
the exact-link robot's forward query (200 configurations x 15,251 points)
too.  A K1
row's distances, closest points and face ids must equal the shipped
kernel's (``same``); an mxu row must meet the probe's gates against its
plain version on a strided subset of 4,096 points (``ok``), and ``same``
says whether it equals the shipped mxu kernel bit for bit.  Prints one
JSON line; exits non-zero without a CUDA device or when a row fails.
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
PRODUCTS = "constexpr Products kProducts = kMmaSync;"

# row -> (kernel, source variant, whether the call passes the scene's
# exterior box)
ROWS = {
    "levers 1+2: select-then-divide, padding skipped": ("K1", "no culling", False),
    "+3: exterior winding": ("K1", "no culling", True),
    "+4: cluster culling (shipped)": ("K1", "shipped", True),
    "clusters of 4": ("K1", "clusters of 4", True),
    "clusters of 16": ("K1", "clusters of 16", True),
    "at most 64 registers": ("K1", "min 8 blocks/SM", True),
    "mxu A+C+D: padding compacted, select-then-divide, folded constants": (
        "mxu", "no culling", False),
    "mxu +A: exterior winding": ("mxu", "no culling", True),
    "mxu +A: cluster culling (shipped, mma.sync)": ("mxu", "shipped", True),
    "mxu, at most 128 registers": ("mxu", "min 4 blocks/SM", True),
    "mxu, at most 102 registers": ("mxu", "min 5 blocks/SM", True),
    "mxu, at most 85 registers": ("mxu", "min 6 blocks/SM", True),
    "mxu, products as wgmma": ("mxu", "wgmma", True),
    "mxu, wgmma, no culling": ("mxu", "wgmma, no culling", True),
    "mxu, wgmma, at most 102 registers": ("mxu", "wgmma, min 5 blocks/SM", True),
    "mxu, products on the FP32 lanes": ("mxu", "FP32 lanes", True),
    "mxu, FP32 lanes, no culling": ("mxu", "FP32 lanes, no culling", True),
}
SOURCES = {"K1": "closest_point.cu", "mxu": "closest_point_mma.cu"}


def _changed(src: str, changes: dict) -> dict:
    """name -> source text of each variant (``shipped`` is the source); each
    change must apply."""
    out = {"shipped": src}
    for name, pairs in changes.items():
        text = src
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"variant {name!r} no longer applies to the source")
            text = text.replace(old, new)
        out[name] = text
    return out


def _min_blocks(n: int):
    return (LAUNCH, LAUNCH[:-1] + f", {n})")


def variants(src: str) -> dict:
    """K1's variants of ``closest_point.cu``."""
    return _changed(src, {
        "no culling": [(CULL, CULL.replace("true", "false"))],
        "clusters of 4": [(CLUSTER, CLUSTER.replace("8", "4"))],
        "clusters of 16": [(CLUSTER, CLUSTER.replace("8", "16"))],
        "min 8 blocks/SM": [_min_blocks(8)]})


def mma_variants(src: str) -> dict:
    """The tensor-core sweep's variants of ``closest_point_mma.cu``."""
    wgmma = (PRODUCTS, PRODUCTS.replace("kMmaSync;", "kWgmma;"))
    fp32 = (PRODUCTS, PRODUCTS.replace("kMmaSync;", "kFp32;"))
    no_cull = (CULL, CULL.replace("true", "false"))
    return _changed(src, {"no culling": [no_cull],
                          **{f"min {n} blocks/SM": [_min_blocks(n)] for n in (4, 5, 6)},
                          "wgmma": [wgmma], "wgmma, no culling": [wgmma, no_cull],
                          "wgmma, min 5 blocks/SM": [wgmma, _min_blocks(5)],
                          "FP32 lanes": [fp32], "FP32 lanes, no culling": [fp32, no_cull]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", choices=list(SOURCES), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_variants: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.bench import sweep_roofline as sr
    from pytorch_volumetric_tpu_torch.ops import closest_point as cp
    from pytorch_volumetric_tpu_torch.ops import cuda_build
    from pytorch_volumetric_tpu_torch.utils.profiling import device_time, kernel_time
    from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm

    rows = {k: v for k, v in ROWS.items() if args.only in (None, v[0])}
    dev = torch.device("cuda", 0)
    vdir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(vdir, exist_ok=True)
    libs = {}
    for kernel, make in (("K1", variants), ("mxu", mma_variants)):
        with open(os.path.join(cuda_build.CSRC_DIR, SOURCES[kernel])) as f:
            texts = make(f.read())
        base = "closest_point" if kernel == "K1" else "closest_point_mma"
        for i, (name, text) in enumerate(texts.items()):
            path = os.path.join(vdir, f"{base}_v{i}.cu")
            with open(path, "w") as f:
                f.write(text)
            libs[kernel, name] = f"{base}_v{i}"
            cuda_build.SOURCES[libs[kernel, name]] = (path, cuda_build.SOURCES[base][1])
    built = cuda_build.build(sorted({libs[k, v] for k, v, _ in rows.values()}))
    # each library's registers, shared memory and spills (ptxas -v)
    ptxas = {lib: [line.replace("ptxas info    :", "").strip() for line in log.splitlines()
                   if "Used" in line or "spill" in line]
             for lib, (_, log) in built.items()}

    grid, cap = sr.capsule_cache_grid(dev)
    pts, torus = sr.torus_inputs(dev)
    cells = {"capsule_grid": (grid, cap), "torus": (pts, torus)}
    wrappers = {"K1": cp.mesh_closest_query_cuda, "mxu": cp.mesh_closest_query_mma_cuda}
    plain = {"K1": sr.SWEEPS["base"][1], "mxu": sr.SWEEPS["mxu"][1]}
    subs = {c: p[::max(1, p.shape[0] // 4096)].contiguous() for c, (p, _) in cells.items()}
    plain_out = {(kernel, c): plain[kernel](subs[c], s.tri)
                 for kernel in {v[0] for v in rows.values()} for c, (_, s) in cells.items()}
    robot = None
    if any(k == "K1" for k, _, _ in rows.values()):
        tmp = tempfile.mkdtemp()
        make_serial_arm(tmp, num_joints=7)
        q, qpts = cs.headline_inputs(dev)
        with open(os.path.join(tmp, "arm.urdf")) as f:
            robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(f.read(), "link7", device=dev),
                                path_prefix=tmp)
        with torch.no_grad():
            ref_robot = robot.query(q, qpts)

    def fwd():
        with torch.no_grad():
            return robot.query(q, qpts)

    def use(kernel, variant):
        if kernel == "K1":
            cp.KERNEL = libs[kernel, variant]
        else:
            cp.MMA_KERNEL = libs[kernel, variant]

    out, ok, refs = {}, True, {}
    saved = cp.KERNEL, cp.MMA_KERNEL
    try:
        for kernel in {v[0] for v in rows.values()}:  # the shipped kernels, with the box
            use(kernel, "shipped")
            for cell, (p, s) in cells.items():
                refs[kernel, cell] = wrappers[kernel](p, s.tri, exterior_box=s.exterior_box)
        for name, (kernel, variant, use_box) in rows.items():
            use(kernel, variant)
            wrapper = wrappers[kernel]
            row = {"kernel": kernel, "variant": variant, "exterior_box": use_box}
            for cell, (p, s) in cells.items():
                box = s.exterior_box if use_box else None

                def sweep(a, t, box=box):
                    return wrapper(a, t, exterior_box=box)
                res = sweep(p, s.tri)
                ref = refs[kernel, cell]
                P, F = p.shape[0], s.num_faces
                ev = sr.evaluated_pairs(wrapper, p, s.tri, exterior_box=box)
                reps = args.reps if cell == "capsule_grid" else max(1, args.reps // 3)
                stride = max(1, P // 4096)
                errors = sr.sweep_errors([x[::stride] for x in res], plain_out[kernel, cell],
                                         subs[cell], s.tri)
                row[cell] = dict(ev, closest_share=ev["closest_pairs"] / (P * F),
                                 winding_share=ev["winding_pairs"] / (P * F),
                                 ms=device_time(sweep, p, s.tri, reps=reps, warmup=0) * 1e3,
                                 same=all(torch.equal(a, b) for a, b in zip(res[:3], ref[:3])),
                                 winding_err=(res[3] - ref[3]).abs().max().item(),
                                 errors=errors,
                                 ok=sr.check_sweep("base" if kernel == "K1" else "mxu", errors))
                if kernel == "K1":
                    row[cell]["ok"] = row[cell]["ok"] and row[cell]["same"]
                if variant == "shipped" and use_box:  # the sweep kernel's own device time
                    _, _, names = kernel_time(sweep, p, s.tri, reps=reps, by_name=True)
                    row[cell]["profiler_kernel_ms"] = sum(
                        v for k, v in names.items() if "closest_point_sweep" in k) * 1e3
            if kernel == "K1" and use_box:  # MeshSDF always passes the box
                v, g = fwd()
                same = torch.equal(v, ref_robot[0]) and torch.equal(g, ref_robot[1])
                row["exact_forward"] = {"ms": cs.time_ms(fwd, dev, reps=5), "same": same,
                                        "ok": same}
            ok = ok and all(r["ok"] for r in row.values() if isinstance(r, dict))
            out[name] = row
    finally:
        cp.KERNEL, cp.MMA_KERNEL = saved
    print(json.dumps({"metric": "sweep_variants", "ok": ok, "card": sr.card_name(),
                      "libraries": {f"{k}: {v}": ptxas.get(lib) for (k, v), lib in libs.items()},
                      "rows": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
