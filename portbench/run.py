"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port
(``pytorch_volumetric_tpu_torch``).  It needs a CUDA device (exit code 2
without one, and no result).  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number of the
correctness comparison beside its limit, which also end standard error.
The run refuses to print a result if ``sys.modules`` holds JAX, ``jaxlib``,
``flax`` or the JAX package once the window has closed and every metric's
reader has run (exit code 3).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".portbench_cache")


def fixed_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's own kernels build into ``pytorch_volumetric_tpu_torch/_build/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("PYTORCH_KERNEL_CACHE_PATH", "kernels")):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def main(argv=None, device: str = "cuda", base: str = None) -> int:
    """One run; ``device`` and ``base`` (the benchmark's folder) are for the
    CPU tests, which skip the look for a card."""
    ap = argparse.ArgumentParser(description="one run of one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches()

    import torch
    from portbench import harness

    bench = harness.load_benchmark(REPO)
    chips = harness.find_cell(bench, args.workload)["chips"]
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(2)
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            device=device, t_start=T_START, bench=bench,
                            base=base or harness.BENCH_DIR, log=log)
    line.pop("_run")
    # the window has closed and every reader has run: what the process holds now
    found = harness.forbidden_modules()
    if found:
        log(f"refusing to report: these modules were imported: {found}")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
