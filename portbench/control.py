"""The control of a cell's comparison: the reference put in the program's
place, computed in the precision below the configuration's.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--device cuda|cpu]

For each seed it draws the cell's inputs and sample positions as a run does,
answers every sampled query and d/dq with ``Reference(..., mode="tf32")``
(float32, the FK's matrix products with TF32 operands), and judges those
answers exactly as a run judges the program's, against the cell's limits.
It prints one JSON line a seed with each number and ``correct``, which has
to come out false.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from portbench import harness, judge, workload
from portbench.reference import Reference


def control_records(ref: Reference, mix: dict, inputs: workload.Inputs, dof: int):
    """One record a (batch, chunk), as a call of the window keeps it."""
    records = []
    for b in range(mix["pool"]):
        for k, (c0, c1) in enumerate(workload.chunk_bounds(mix)):
            q = inputs.q[b, c0 + inputs.sample_cfg[b, k]]
            p = workload.world_points(inputs, inputs.sample_pt[b, k])
            v, g = ref.answers(q, p, "tf32")
            dq = None
            if inputs.dq_cfg is not None:
                dq = torch.full((c1 - c0, dof), float("nan"), dtype=torch.float64,
                                device=p.device)
                pts = workload.all_world_points(inputs, p.device)
                for i in inputs.dq_cfg[b].tolist():
                    if c0 <= i < c1:
                        dq[i - c0] = ref.dq(inputs.q[b, i], pts, mode="tf32")[0]
            records.append({"b": b, "k": k, "v": v,
                            "g": None if mix.get("values_only") else g, "dq": dq})
    return records


def run_control(cell: str, seed: int, device: str, bench=None, base: str = harness.BENCH_DIR):
    bench = harness.load_benchmark() if bench is None else bench
    entry = harness.find_cell(bench, cell)
    cfg, mix = harness.load_config(entry["config"], base), harness.load_mix(entry["traffic"], base)
    limits = harness.load_limits(cell, base)
    dev = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        assets = workload.write_robot(cfg, os.path.join(tmp, "robot"), base)
        inputs = workload.make_inputs(cfg, mix, seed, dev)
        ref = Reference(cfg, assets, dev, base)
        expected, dq_expected = harness.reference_answers(ref, mix, inputs, dev)
        records = control_records(ref, mix, inputs, len(cfg["home_q"]))
    correct, failed, checks = judge.judge(records, expected, dq_expected, mix["chunk"], limits)
    return {"cell": cell, "seed": seed, "correct": correct, "failed": failed,
            "records": len(records), "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(run_control(args.workload, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
