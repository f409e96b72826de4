#!/usr/bin/env python3
"""Reproduce an inexact first parallel ``torch.sqrt`` on the CPU.

    python3 scripts/cpu_sqrt_first_call_torch.py [--runs N]

With some CPU builds of torch (seen with 2.13.0+cpu on an 8-core AVX-512
host), the first large ``torch.sqrt`` of a process now and then returns
~12-bit results (relative error ~3e-4) on one or two threads' contiguous
shares of the elements; later calls are exact.  The plain sweep's solid
angles take square roots, so its winding number can move by ~1e-3.

Each run is a fresh interpreter that takes ``torch.sqrt`` of 2^20 floats
(seeded) and compares the result with the float64 square root rounded to
float32, either as its first ``torch.sqrt`` or after one warm-up call.
The fault is rare and its rate varies with the host's load (3 of 80 to 7
of 40 runs of the first setting on the host above, none after a warm-up),
so the runs are serial and many (~8 minutes).  Prints one JSON line: per setting, the runs whose result
was off by more than 1e-6 relative, and for each such run the threads'
shares (element ranges) that were off.
"""

import argparse
import json
import subprocess
import sys

CHILD = r"""
import json, sys, torch
seed, setting = int(sys.argv[1]), sys.argv[2]
torch.manual_seed(seed)
x = torch.rand(1 << 20) * 4 + 1e-3
if setting == "warm-up":
    torch.sqrt(torch.rand(1 << 20))
y = torch.sqrt(x)
threads = torch.get_num_threads()
ref = x.double().sqrt().float()
bad = ((y - ref).abs() / ref > 1e-6).nonzero().flatten()
share = -(-x.numel() // threads)
chunks = sorted({int(i) // share for i in bad})
print(json.dumps({"off": int(bad.numel()), "threads": threads,
                  "ranges": [[c * share, min((c + 1) * share, x.numel()) - 1] for c in chunks]}))
"""


SETTINGS = ("first call", "warm-up")


def run(seed: int, setting: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(seed), setting],
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=80)
    args = ap.parse_args()
    import torch
    settings = {}
    for setting in SETTINGS:
        results = [run(seed, setting) for seed in range(args.runs)]
        faulty = [r for r in results if r["off"]]
        settings[setting] = {"runs": args.runs, "threads": results[0]["threads"],
                             "faulty_runs": len(faulty),
                             "faulty_ranges": [r["ranges"] for r in faulty]}
    print(json.dumps({"metric": "cpu_sqrt_first_call", "torch": torch.__version__,
                      "capability": torch.backends.cpu.get_cpu_capability(),
                      "settings": settings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
