#!/usr/bin/env python3
"""The benchmark's cells split by the port's own layers, from its spans and counters.

    python3 scripts/trace_layers_torch.py [--cells A,B] [--seeds S1,S2] [--seconds 10]
        [--out FILE.jsonl] [--span-cost] [--tiny DIR]

Runs each cell of ``BENCHMARK.json`` through the benchmark's own run
(``portbench.harness.run_cell`` with ``--trace 1``, on the card) and reads its
plain traced window a second time with
``portbench.program_trace.program_layers``: each layer's host self time,
device time, device idle time and, where the cell runs a backward, the
backward's device time by the forward layer it derives from; and the deltas
of ``utils.profiling.COUNTERS`` over that window (the kernel launches and the
paths each call took).  Per run it prints, and appends to ``--out`` when
given, one JSON line: the result line's metrics and ``correct``, the plain window's step ms,
all of that per call, the labelled window's device ms by layer (``trace.summarise``) beside
it, and the sums that check it (the layers' forward device
time against the window's, the backward's against the window's device time
less the forward's, the idle times against the window's idle time).  The
program's own spans also show in the card's trace as device annotations:
the line counts them and how many the profiler marks as annotations, which
the benchmark's readers leave out.

``--span-cost`` first times ``utils.profiling.span`` with no profiler running,
and an unguarded ``record_function`` beside it.  ``--tiny DIR`` runs on the
CPU at the benchmark tests' sizes (``portbench/tests/tiny.py``), to rehearse.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def span_cost(n: int = 200_000) -> dict:
    """Microseconds of one ``with span(...)`` and of one unguarded
    ``record_function`` with no profiler running, less an empty loop's."""
    import torch
    from pytorch_volumetric_tpu_torch.utils import profiling

    def per_call(body, reps):
        t0 = time.perf_counter()
        body(reps)
        return (time.perf_counter() - t0) / reps * 1e6

    def empty(k):
        for _ in range(k):
            pass

    def guarded(k):
        for _ in range(k):
            with profiling.span("pvt.fk"):
                pass

    def unguarded(k):
        for _ in range(k):
            with torch.profiler.record_function("pvt.fk"):
                pass

    def counted(k):
        for _ in range(k):
            profiling.count("path.span_cost")

    base = min(per_call(empty, n) for _ in range(3))
    out = {"span_us": min(per_call(guarded, n) for _ in range(3)) - base,
           "record_function_us": min(per_call(unguarded, n // 10) for _ in range(3)) - base,
           "count_us": min(per_call(counted, n) for _ in range(3)) - base}
    del profiling.COUNTERS["path.span_cost"]
    return out


def hooked_run(cell: str, seed: int, seconds: float, device: str, base: str) -> dict:
    """One traced run of ``cell``; returns the result line (``_run`` kept)
    with ``program`` (the plain window's layers), ``counters`` (their
    deltas over the plain window) and ``annotations`` added."""
    import torch
    from portbench import harness, program_trace
    from portbench import trace as trace_mod
    from pytorch_volumetric_tpu_torch.utils import profiling

    seen = {}
    traced, summarise = harness.traced, trace_mod.summarise

    def plain_summarise(prof, labels=None):
        seen["program"] = program_trace.program_layers(prof)
        marks = [getattr(e, "is_user_annotation", None) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name.startswith(program_trace.PREFIX)]
        seen["annotations"] = {"device_events": len(marks), "marked": sum(bool(m) for m in marks)}
        return summarise(prof, labels)

    def hooked(loop, steps, annotate):
        if annotate:
            return traced(loop, steps, annotate)
        before = profiling.COUNTERS.copy()
        trace_mod.summarise = plain_summarise
        try:
            return traced(loop, steps, annotate)
        finally:
            trace_mod.summarise = summarise
            seen["counters"] = dict(profiling.COUNTERS - before)

    harness.traced = hooked
    try:
        line = harness.run_cell(cell, seed, seconds, True, device=device, base=base)
    finally:
        harness.traced = traced
    line.update(seen)
    return line


def report(cell: str, seed: int, line: dict) -> dict:
    from portbench import program_trace
    run = line["_run"]
    plain, prog = run["plain"], line["program"]
    calls = max(plain["calls"], 1)
    per = {k: {layer: s / calls * 1e3 for layer, s in v.items()}
           for k, v in prog.items() if isinstance(v, dict)}
    fwd = sum(prog["device_s"].values())
    layers_fwd = sum(v for k, v in prog["device_s"].items() if k != program_trace.OUTSIDE)
    bwd = sum(prog["backward_device_s"].values())
    window_bwd = prog["device_total_s"] - fwd
    idle = sum(prog["idle_s"].values())
    plain_idle = plain["window_s"] - plain["busy_s"]
    counters = {k: v / calls for k, v in sorted(line["counters"].items())}
    grid_calls = counters.get("path.grid_fallback", 0) + counters.get("path.grid_coherent", 0)
    return {
        "cell": cell, "seed": seed, "device": line["device"], "correct": line["correct"],
        "metrics": {k: m["value"] for k, m in line["metrics"].items()},
        "plain_step_ms": plain["window_s"] / plain["steps"] * 1e3,
        "plain_calls": plain["calls"], "plain_idle_ms_per_call": plain_idle / calls * 1e3,
        "per_call_ms": per, "counters_per_call": counters,
        "grid_fallback_share": (100.0 * counters.get("path.grid_fallback", 0) / grid_calls
                                if grid_calls else None),
        "sums": {"layers_forward_ms": layers_fwd / calls * 1e3,
                 "forward_ms": fwd / calls * 1e3,
                 "device_total_ms": prog["device_total_s"] / calls * 1e3,
                 "backward_ms": bwd / calls * 1e3, "window_backward_ms": window_bwd / calls * 1e3,
                 "idle_ms": idle / calls * 1e3},
        "annotations": line["annotations"],
        # the labelled window's layers (trace.summarise), to set beside the plain one's
        "labelled_layer_ms": {k: s / max(run["annotated"]["calls"], 1) * 1e3
                              for k, s in run["annotated"]["layer_s"].items()},
        "idle_gaps": line.get("breakdown", {}).get("idle_gaps")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=None, help="comma-separated; default every cell")
    ap.add_argument("--seeds", default="2147496000")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None, help="a JSON-lines file to append each line to")
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--tiny", default=None, help="a scratch folder: run on the CPU, tiny sizes")
    args = ap.parse_args(argv)

    from portbench import harness
    from portbench import run as run_mod
    run_mod.fixed_caches()
    import torch
    torch.set_num_threads(2)
    base, device = harness.BENCH_DIR, "cuda"
    if args.tiny:
        from portbench.tests.tiny import tiny_base
        base, device = tiny_base(args.tiny), "cpu"
    elif not torch.cuda.is_available():
        print("needs a CUDA device (or --tiny DIR)", file=sys.stderr)
        return 2

    def emit(rec):
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    if args.span_cost:
        emit({"span_cost": span_cost()})
    bench = harness.load_benchmark(REPO)
    cells = args.cells.split(",") if args.cells else [c["name"] for c in bench["workloads"]]
    ok = True
    for cell in cells:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            rec = report(cell, seed, hooked_run(cell, seed, args.seconds, device, base))
            rec["run_s"] = time.perf_counter() - t0
            ok &= rec["correct"]
            emit(rec)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
