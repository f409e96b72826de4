#!/usr/bin/env python3
"""The narrow-band kernel's design choices, timed side by side on one GPU.

    python3 scripts/narrow_band_variants_torch.py [--reps N] [--quick]

Builds copies of ``pytorch_volumetric_tpu_torch/csrc/narrow_band.cu`` with
one compile-time choice changed, each as its own library under ``_build/``:

- ``shipped``: the source as it stands (a block's in-band points shared
  among its warps, each point's rows split across a warp's 32 lanes, the
  loop stopped after the first round that meets the cell's padding);
- ``no padding stop``: every round up to ``K`` runs (the padding rows
  too), which isolates the stop at the first padding round;
- ``256 threads a block`` and ``512``: more points to share, and
  occupancy.

Each variant is held to the plain version (``ops.narrow_band._query_impl``)
bit for bit on every case of ``bench.bigmesh.kernel_cases``, at the bigmesh
shape (``max_k`` 256 and 1024) and on the launches of the headline arm with
``narrow_band_link_sdf_factory()`` links (200 configurations x 15,251
points), then timed on each: ``ms`` from CUDA events around back-to-back
calls (``utils.profiling.device_time``), ``kernel_ms`` and the device
kernels per call from a ``torch.profiler`` trace
(``utils.profiling.kernel_time``), and each device kernel's share
(``split_ms``).  ``work`` gives each shape's in-band points, real pairs and
the warp rounds the kernel issues.  Prints one JSON line; exits non-zero
without a CUDA device or when a variant differs from the plain version.
``--quick`` checks the kernel cases only.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

THREADS = "constexpr int kThreads = 128;"
STOP = "const bool last = __any_sync(kFull, pad);"


def variants(src: str) -> dict:
    """name -> source text of each variant; the first is the source."""
    out = {"shipped": src,
           "no padding stop": src.replace(STOP, "const bool last = false;"),
           "256 threads a block": src.replace(THREADS, THREADS.replace("128", "256")),
           "512 threads a block": src.replace(THREADS, THREADS.replace("128", "512"))}
    for name, text in out.items():
        if name != "shipped" and text == src:
            raise RuntimeError(f"variant {name!r} no longer applies to the source")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--quick", action="store_true", help="the kernel cases only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("narrow_band_variants: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import pytorch_volumetric_tpu_torch as pt
    from pytorch_volumetric_tpu_torch.bench import bigmesh as bm
    from pytorch_volumetric_tpu_torch.bench.sweep_roofline import card_name
    from pytorch_volumetric_tpu_torch.ops import cuda_build
    from pytorch_volumetric_tpu_torch.ops import narrow_band as nb
    from pytorch_volumetric_tpu_torch.ops import narrow_band_cuda as nbc
    from pytorch_volumetric_tpu_torch.utils.profiling import device_time, kernel_time
    from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    dev = torch.device("cuda", 0)
    with open(os.path.join(cuda_build.CSRC_DIR, "narrow_band.cu")) as f:
        src = f.read()
    vdir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(vdir, exist_ok=True)
    libs = {}
    texts = variants(src)
    for i, (name, text) in enumerate(texts.items()):
        path = os.path.join(vdir, f"narrow_band_v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        libs[name] = f"narrow_band_v{i}"
        cuda_build.SOURCES[libs[name]] = (path, cuda_build.SOURCES["narrow_band"][1])
    built = cuda_build.build(list(libs.values()))
    for name, lib in libs.items():
        for line in built.get(lib, (0, ""))[1].splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name}: {line.strip()}")

    cases = bm.kernel_cases(dev)
    shapes = {}
    if not args.quick:
        m = pt.mesh.icosphere_mesh(radius=bm.RADIUS, subdivisions=bm.SUBDIV)
        pts = torch.as_tensor(bm.bigmesh_points(), device=dev)
        for max_k in bm.MAX_KS:
            t = nb.build_narrow_band_tables(m, bm.CELL_RES, bm.BAND, bm.PADDING, max_k,
                                            device=dev)
            shapes[f"bigmesh, max_k {max_k}"] = [(t.smalls, t.big, pts)]
        q, qpts = cs.headline_inputs(dev)
        tmp = tempfile.mkdtemp()
        make_serial_arm(tmp, num_joints=7)
        with open(os.path.join(tmp, "arm.urdf")) as f:
            robot = pt.RobotSDF(pt.build_serial_chain_from_urdf(f.read(), "link7", device=dev),
                                path_prefix=tmp, link_sdf_cls=pt.narrow_band_link_sdf_factory(
                                    cache_path=os.path.join(tmp, "narrow_band.npz")))
        shapes["arm launch"] = bm.link_launches(robot, q, qpts)

    def same(smalls, big, p):
        return bm.compare(smalls, big, p)["ok"]

    out, ok = {}, True
    saved = nbc.KERNEL
    try:
        for name, lib in libs.items():
            nbc.KERNEL = lib
            row = {"cases_equal": all(same(s, b, p) for _, s, b, p in cases)}
            for shape, calls in shapes.items():
                n = len(calls)

                def run_all(_, calls=calls):
                    for smalls, big, p in calls:
                        nbc.narrow_band_query_cuda(smalls, big, p)

                probe = calls[0][2]
                k_s, k_n, by_name = kernel_time(run_all, probe, reps=args.reps, by_name=True)
                row[shape] = {"equal": all(same(*c) for c in calls), "launches": n,
                              "ms": device_time(run_all, probe, reps=args.reps) * 1e3 / n,
                              "kernel_ms": k_s * 1e3 / n, "kernels_per_call": k_n / n,
                              "split_ms": {k[:60]: v * 1e3 / n for k, v in by_name.items()}}
            ok = ok and row["cases_equal"] and all(
                r["equal"] for r in row.values() if isinstance(r, dict))
            out[name] = row
            log(f"{name}: {json.dumps(row)}")
    finally:
        nbc.KERNEL = saved
    bounds, work = {}, {}
    for shape, calls in shapes.items():
        total = 0.0
        work[shape] = {}
        for smalls, big, p in calls:
            _, _, slot = nb._query_impl(smalls, big, p, 1e-3)
            w = bm.work(smalls, big, p, slot)
            total += bm.bound_ms(w)[0]
            for key in ("points", "in_band", "pairs", "warp_rounds", "bytes"):
                work[shape][key] = work[shape].get(key, 0) + w[key] / len(calls)
        bounds[shape] = total / len(calls)
    print(json.dumps({"metric": "narrow_band_variants", "ok": ok,
                      "card": card_name(), "bound_ms": bounds, "work": work, "rows": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
