#!/usr/bin/env python3
"""Where the time goes in the port's robot queries on one GPU.

    python3 scripts/profile_torch_query.py [--out DIR]

Builds the headline robot (7-DOF ``make_serial_arm``) three times, with
cached links (``cache_link_sdf_factory(0.02, 1.0)``), with exact
``MeshSDF`` links and with narrow-band links
(``narrow_band_link_sdf_factory()``), and traces one forward and one
forward+backward (``d(v.sum() + g.sum())/dq``) of ``RobotSDF.query`` over
200 configurations x 15,251 points with ``torch.profiler``, and of the
cached robot's
``RobotSDF.query_grid`` (the coherent brick path) over the same grid.
The cached and narrow-band robots are then served: exported with
``utils.serving.export_robot_query`` and loaded back, and the loaded
program's forward and forward+backward are traced the same way.
Then the neural model of the same arm (``ConfigSpaceNeuralSDF`` at
``benchmarks/neural.py``'s shapes: width 128, depth 4, 96 Fourier
features; random weights from ``mlp_init``, since a step's work does not
depend on their values): its value-only forward and its value + gradient
query over the same 200 x 15,251, and 20 training steps of ``_fit`` at
batch 8,192.
Then the north-star workload (``bench/northstar.py``, 200 configurations x
10^6 points in (3, 3, 3) tiles): one configuration chunk (25 x 1,061,208
padded points) of the arm's forward, forward + backward and values only,
and one forward of the trilinear arm and of the free torus link (nearest
and trilinear), each robot from a fresh cache; ``--only northstar`` traces
these alone, ``--only headline`` the rest.
Prints, per run, the wall time, the summed device-kernel time and the
number of kernel launches, the device's idle share of the window, the
share of ``torch.cat``'s kernels, and the kernels with the most device
time; for the north-star chunks also which calls launch the ``torch.cat``
kernels (one more traced call with the port's functions labelled: each
launching operator, its callers in the port and the kernels' device ms).  With ``--out DIR``,
writes Chrome traces there.
"""

import argparse
import collections
import contextlib
import functools
import importlib
import inspect
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the headline inputs and objective)
import pytorch_volumetric_tpu_torch as pt  # noqa: E402
from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm  # noqa: E402


CAT_KERNEL = "CatArray"  # the kernels of torch.cat / torch.stack


def trace(name, fn, out_dir, top=12, cat_owners=False):
    """One traced call of ``fn`` after a warm-up; with ``cat_owners``, also
    :func:`kernel_owners` of the ``torch.cat`` kernels."""
    fn()  # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the operator events repeat their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    cat_ms = sum(e.self_device_time_total for e in events if CAT_KERNEL in e.key) / 1e3
    print(f"== {name}: wall {wall_ms:.3f} ms, device kernels {kernel_ms:.3f} ms in {launches} "
          f"launches, device idle {max(0.0, 1 - kernel_ms / wall_ms) * 100:.1f}% of the window; "
          f"torch.cat kernels {cat_ms:.3f} ms ({cat_ms / max(kernel_ms, 1e-9) * 100:.1f}%)")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:top]:
        print(f"   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    if cat_owners:
        kernel_owners(fn, CAT_KERNEL)
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))


# the port's modules on the north-star path, for :func:`kernel_owners`
PORT_MODULES = ("pytorch_volumetric_tpu_torch.sdf", "pytorch_volumetric_tpu_torch.transforms",
                "pytorch_volumetric_tpu_torch.kinematics",
                "pytorch_volumetric_tpu_torch.model_to_sdf",
                "pytorch_volumetric_tpu_torch.bench.northstar")


@contextlib.contextmanager
def port_annotations():
    """Every top-level function of :data:`PORT_MODULES` wrapped in a
    ``record_function`` of its name while the block runs.  Calls that
    resolve the name at call time (``tfm.transform_points``, a module's
    own helpers) go through the wrapper.  These labels name a kernel's
    caller where the profiler records no Python stacks (``with_stack=True``
    gave none with torch 2.11 on an H100)."""
    def annotate(f, label):
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            with record_function(label):
                return f(*args, **kwargs)
        return wrapped

    saved, labels = [], set()
    for name in PORT_MODULES:
        mod = importlib.import_module(name)
        for attr, f in list(vars(mod).items()):
            if inspect.isfunction(f) and f.__module__ == name:
                label = f"{name.rsplit('.', 1)[-1]}.{attr}"
                saved.append((mod, attr, f))
                labels.add(label)
                setattr(mod, attr, annotate(f, label))
    try:
        yield labels
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)


def kernel_owners(fn, pattern, top=6):
    """Which calls launch the kernels whose name holds ``pattern``: one
    more traced call of ``fn`` under :func:`port_annotations` (kept apart
    from the timed trace, whose host times the labels would slow).  Prints
    each launching operator (inside its parent operators) with its two
    innermost callers in the port, its launches and the kernels' device
    ms."""
    with port_annotations() as labels, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    owners = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        kernels = [k for k in e.kernels if pattern in k.name]
        if not kernels:
            continue
        ops, callers, p = [], [], e
        while p is not None and len(callers) < 2:
            if p.name in labels:
                callers.insert(0, p.name)
            elif not callers and p.name.startswith("aten::"):
                ops.insert(0, p.name)
            p = p.cpu_parent
        owner = owners[(" > ".join(ops), " > ".join(callers) or "no function of the port")]
        owner[0] += len(kernels)
        owner[1] += sum(k.duration for k in kernels) / 1e3
    for (ops, caller), (n, ms) in sorted(owners.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"   {pattern} from {ops} in {caller}: {n} launches, {ms:.3f} ms")


def northstar(device, out_dir, chunk=25):
    """One chunk of each north-star row (``bench/northstar.py``)."""
    from pytorch_volumetric_tpu_torch import sdf as tsdf
    from pytorch_volumetric_tpu_torch.bench import northstar as ns
    rows = (("arm", "nearest", ns.VARIANTS), ("arm", "trilinear", ("forward",)),
            ("free_link", "nearest", ("forward",)), ("free_link", "trilinear", ("forward",)))
    with tempfile.TemporaryDirectory() as tmp:
        for kind, interp, variants in rows:
            robot, n_dof = ns.build_robot(kind, interp, tmp, device,
                                          os.path.join(tmp, f"{kind}_{interp}.npz"))
            children = tuple(robot.sdf.sdfs)
            pts, _, seg = ns.northstar_points(100, tsdf.coherent_min_cache_resolution(children),
                                              device)
            ft = tsdf.coherent_fast_tables(children)
            qc = ns.joint_configs(200, n_dof, device)[:chunk]
            for variant in variants:
                trace(f"{ns.metric_name(kind, interp)}_chunk{chunk}_{variant}",
                      lambda v=variant: ns.chunk_terms(v, robot, ft, qc, pts, seg), out_dir,
                      cat_owners=True)
            del robot, ft
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for Chrome traces")
    ap.add_argument("--only", choices=["headline", "northstar"], default=None,
                    help="trace only the 200 x 15,251 rows or only the north-star chunks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda")
    if args.only != "headline":
        northstar(device, args.out)
    if args.only == "northstar":
        return
    q, pts = chip_smoke.headline_inputs(device)
    with tempfile.TemporaryDirectory() as tmp:
        arm = os.path.join(tmp, "arm")
        urdf, end = make_serial_arm(arm, num_joints=7)
        text = open(urdf).read()
        robots = {
            "cached": pt.RobotSDF(
                pt.build_serial_chain_from_urdf(text, end, device=device), path_prefix=arm,
                link_sdf_cls=pt.cache_link_sdf_factory(
                    resolution=0.02, padding=1.0,
                    cache_path=os.path.join(tmp, "sdf_cache.npz"))),
            "exact": pt.RobotSDF(
                pt.build_serial_chain_from_urdf(text, end, device=device), path_prefix=arm),
            "narrow_band": pt.RobotSDF(
                pt.build_serial_chain_from_urdf(text, end, device=device), path_prefix=arm,
                link_sdf_cls=pt.narrow_band_link_sdf_factory(
                    cache_path=os.path.join(tmp, "narrow_band.npz"))),
        }
        for name, robot in robots.items():
            def fwd(robot=robot):
                with torch.no_grad():
                    robot.query(q, pts)

            def fwd_bwd(robot=robot):
                chip_smoke.query_objective_grad(robot, q, pts)

            trace(f"{name}_forward", fwd, args.out)
            trace(f"{name}_forward_backward", fwd_bwd, args.out)

        cached = robots["cached"]

        def grid_fwd():
            with torch.no_grad():
                cached.query_grid(q, chip_smoke.QUERY_RANGE, chip_smoke.QUERY_RES)

        def grid_fwd_bwd():
            qq = q.detach().clone().requires_grad_(True)
            v, g = cached.query_grid(qq, chip_smoke.QUERY_RANGE, chip_smoke.QUERY_RES)
            torch.autograd.grad(v.sum() + g.sum(), qq)

        trace("coherent_forward", grid_fwd, args.out)
        trace("coherent_forward_backward", grid_fwd_bwd, args.out)

        from pytorch_volumetric_tpu_torch.utils import serving
        for name in ("cached", "narrow_band"):
            path = os.path.join(tmp, f"{name}.pt2")
            serving.export_robot_query(robots[name], q.shape[0], pts.shape[0], path)
            query = serving.load_robot_query(path, device=device)

            def served_fwd(query=query):
                with torch.no_grad():
                    query(q, pts)

            trace(f"served_{name}_forward", served_fwd, args.out)
            trace(f"served_{name}_forward_backward",
                  lambda query=query: chip_smoke.objective_grad(query, q, pts), args.out)
            del query

    from pytorch_volumetric_tpu_torch.models import neural_sdf as tn
    fit = chip_smoke.NEURAL_FIT
    M, K = q.shape[1], fit["fourier"]
    gen = torch.Generator(device=device).manual_seed(0)
    model = pt.ConfigSpaceNeuralSDF(
        tn.mlp_init(gen, M + 2 * K, fit["width"], fit["depth"], device=device),
        torch.randn((3, K), generator=gen, device=device), -torch.pi * torch.ones(M),
        torch.pi * torch.ones(M), [[-1.0, 1.0]] * 3, device=device)

    def neural_fwd():
        with torch.no_grad():
            model.value(q[:, None], pts)

    def neural_fwd_bwd():
        model.query(q, pts)

    n_rows = fit["n_configs"] * fit["pts_per_config"]
    qx = torch.rand((n_rows, M + 3), generator=gen, device=device) * 2 - 1
    v = torch.rand((n_rows,), generator=gen, device=device) - 0.5
    g = torch.nn.functional.normalize(torch.randn((n_rows, 3), generator=gen, device=device),
                                      dim=-1)

    def train_steps():
        tn._fit(model.params, lambda b: model._features(b[..., :M], b[..., M:]), gen, qx, v, g,
                20, fit["batch"], fit["lr"], 0.1, 30.0, torch.float32, "sine")

    trace("neural_forward", neural_fwd, args.out)
    trace("neural_forward_backward", neural_fwd_bwd, args.out)
    trace("neural_train_20_steps", train_steps, args.out)


if __name__ == "__main__":
    main()
