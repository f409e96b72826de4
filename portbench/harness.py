"""Run one cell of ``BENCHMARK.json`` once and make its result line.

Driven by data.  A cell names a configuration and a traffic mix; the harness
reads ``configs/<config>.json``, ``mixes/<traffic>.json`` and
``limits/<cell>.json``, and reports each metric that ``BENCHMARK.json``
gives the cell through its reader ``metrics/<metric>.py`` (``read(run)``,
None when the run holds nothing to read).  The code of a kind is found by
name too (``plugins``): the mix's entry ``entries/<entry>.py``, the robot's
writer ``robots/<kind>.py``, its meshes ``meshes/<kind>.py``, and the link
SDF ``links/<sdf>.<interpolation>.py``, which the program's set-up and the
reference both read.  A later change adds a configuration, a mix, a cell, a
metric or a kind as new files.

A run: set-up (the program imported, the robot built from the
configuration's meshes with fresh link caches, so K1 runs, the inputs drawn
from the seed on the device, every shape of the window run once), then a
closed loop with one caller for ``seconds``: step ``s`` runs batch ``s %
pool`` in chunks of ``chunk`` configurations, one call each, and ends in a
synchronise.  Each call's sampled answers are kept as it returns.  With ``trace`` two
short traced windows follow (one plain, one with the program's functions
labelled).  Then the program is freed, and the reference judges every kept
answer (``judge``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import judge as judge_mod
from portbench import plugins, roofline, workload
from portbench import trace as trace_mod
from portbench.reference import Reference, link_kind

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_volumetric_tpu")


# ---------------------------------------------------------------------------
# discovery by name
# ---------------------------------------------------------------------------

def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_benchmark(repo: str = REPO_DIR) -> dict:
    return load_json(os.path.join(repo, "BENCHMARK.json"))


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[c['name'] for c in bench['workloads']]}")


def load_config(name: str, base: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(base, "configs", f"{name}.json"))


def load_mix(name: str, base: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(base, "mixes", f"{name}.json"))


def load_limits(cell: str, base: str = BENCH_DIR) -> Dict[str, float]:
    return load_json(os.path.join(base, "limits", f"{cell}.json"))["limits"]


def load_reader(metric: str, base: str = BENCH_DIR) -> Callable:
    return plugins.load("metrics", metric, base).read


def forbidden_modules() -> List[str]:
    """The top-level names of ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    import sys
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics the cell reports: with ``trace`` its per-layer metrics,
    else its end-to-end ones (a metric with a ``workloads`` list only in
    those cells; a per-layer one without it in every cell that reports its
    ``moves``)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------

class Program:
    """The port's robot SDF, built as its users build it."""

    def __init__(self, cfg: dict, assets: workload.Assets, device, cache_path: str,
                 base: str = BENCH_DIR):
        import pytorch_volumetric_tpu_torch as pt
        kind = plugins.load("links", link_kind(cfg["links"]), base)
        with open(assets.urdf_path) as f:
            chain = pt.build_serial_chain_from_urdf(f.read(), assets.end_link, device=device)
        self.robot = pt.RobotSDF(chain, path_prefix=assets.directory, device=device,
                                 link_sdf_cls=kind.program_link_cls(pt, cfg["links"], cache_path))
        self.base = base

    def call(self, mix: dict, q: torch.Tensor, inputs: workload.Inputs):
        """One call of the mix's entry (``entries/<entry>.py``) on
        configurations ``q [C, dof]``: ``(v [C, M], g [C, M, 3] or None,
        dq [C, dof] or None)``."""
        backward = mix.get("backward", False)
        values_only = mix.get("values_only", False)
        entry = plugins.load("entries", mix["entry"], self.base)
        qc = q.detach().clone().requires_grad_(True) if backward else q
        with contextlib.nullcontext() if backward else torch.no_grad():
            out = entry.call(self.robot, mix, qc, inputs)
        v, g = (out, None) if values_only else out
        dq = None
        if backward:
            with torch.profiler.record_function(trace_mod.BACKWARD):
                (dq,) = torch.autograd.grad(v.sum() + g.sum(), qc)
        C = q.shape[0]
        return (v.detach().reshape(C, -1),
                None if g is None else g.detach().reshape(C, -1, 3), dq)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The closed loop over the mix's steps."""

    def __init__(self, prog: Program, mix: dict, inputs: workload.Inputs, device):
        self.prog, self.mix, self.inputs, self.device = prog, mix, inputs, device
        self.chunks = workload.chunk_bounds(mix)
        self.host_call_s: List[float] = []
        self.records: List[dict] = []

    def _keep(self, b: int, k: int, out) -> None:
        v, g, dq = out
        ci, pj = self.inputs.sample_cfg[b, k], self.inputs.sample_pt[b, k]
        self.records.append({"b": b, "k": k, "v": v[ci, pj],
                             "g": None if g is None else g[ci, pj], "dq": dq})

    def step(self, b: int, keep: bool = True, spans: bool = False) -> None:
        """Batch ``b``: one call per chunk, each call's sampled answers kept
        as it returns, then a synchronise."""
        for k, (c0, c1) in enumerate(self.chunks):
            ctx = torch.profiler.record_function(trace_mod.CALL) if spans else contextlib.nullcontext()
            t0 = time.perf_counter()
            with ctx:
                out = self.prog.call(self.mix, self.inputs.q[b, c0:c1], self.inputs)
            self.host_call_s.append(time.perf_counter() - t0)
            if keep:
                self._keep(b, k, out)
            del out
        _sync(self.device)


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def host_clocks() -> Optional[List[float]]:
    """Seconds the main thread ran and waited on a run queue
    (``/proc/self/schedstat``), and the machine's stolen seconds over all
    CPUs (``/proc/stat``): what a host-bound window loses to other load."""
    try:
        with open("/proc/self/schedstat") as f:
            ran, waited = (int(x) * 1e-9 for x in f.read().split()[:2])
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
        return [ran, waited, steal]
    except (OSError, ValueError, IndexError):
        return None


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(device.index or 0)], capture_output=True, text=True,
                             timeout=20).stdout.strip()
        info["power_limit"] = out
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def traced(loop: Loop, steps: int, annotate: bool) -> dict:
    """A short traced window of ``steps`` steps (no answers kept)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if loop.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(loop.device)
    labels: set = set()
    ctx = trace_mod.port_annotations() if annotate else contextlib.nullcontext(labels)
    with ctx as labels, profile(activities=acts) as prof:
        with torch.profiler.record_function(trace_mod.WINDOW):
            for s in range(steps):
                loop.step(s % loop.mix["pool"], keep=False, spans=True)
    out = trace_mod.summarise(prof, labels)
    out["steps"] = steps
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, bench: Optional[dict] = None,
             base: str = BENCH_DIR, log: Callable[[str], None] = lambda s: None) -> dict:
    """One run of ``cell``; returns the result line's object (``checks``
    last) and, under ``"_run"``, what the readers read.  The caller looks
    for JAX in ``sys.modules`` (:func:`forbidden_modules`) once every
    reader has run."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark() if bench is None else bench
    entry = find_cell(bench, cell)
    cfg, mix = load_config(entry["config"], base), load_mix(entry["traffic"], base)
    limits = load_limits(cell, base)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        assets = workload.write_robot(cfg, os.path.join(tmp, "robot"), base)
        prog = Program(cfg, assets, dev, os.path.join(tmp, "link_caches.npz"), base)
        inputs = workload.make_inputs(cfg, mix, seed, dev)
        loop = Loop(prog, mix, inputs, dev)
        for b in range(mix["pool"]):          # every batch of the window, once
            loop.step(b)
        loop.records.clear()
        loop.host_call_s.clear()
        _sync(dev)
        # set-up's objects out of the collector's way: the window's collections
        # scan only what the window makes
        gc.collect()
        gc.freeze()
        gc_before = sum(s["collections"] for s in gc.get_stats())
        host_before = host_clocks()
        setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        step_s: List[float] = []
        while True:
            s0 = time.perf_counter()
            loop.step(len(step_s) % mix["pool"])
            s1 = time.perf_counter()
            step_s.append(s1 - s0)
            if s1 - t0 >= seconds:
                break
        window_s = s1 - t0
        gc_window = sum(s["collections"] for s in gc.get_stats()) - gc_before
        host_after = host_clocks()
        window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        calls = len(step_s) * len(loop.chunks)
        q = np.percentile(np.asarray(step_s) * 1e3, [5, 50, 95])
        fifths = [float(np.median(x)) * 1e3 for x in np.array_split(np.asarray(step_s), 5)
                  if len(x)]
        log(f"set-up {setup_s:.3f} s; window: {len(step_s)} steps, {calls} calls in "
            f"{window_s:.3f} s; step ms p5 {q[0]:.3f} p50 {q[1]:.3f} p95 {q[2]:.3f}; "
            f"median by fifth of the window {' '.join(f'{x:.3f}' for x in fifths)}; "
            f"{gc_window} garbage collections")
        if host_before and host_after:
            ran, waited, steal = (a - b for a, b in zip(host_after, host_before))
            log(f"window on the host: the main thread ran {ran:.3f} s and waited {waited:.3f} s "
                f"to run; the machine's CPUs had {steal:.3f} s stolen")
        run = {"setup_s": setup_s, "window_s": window_s, "steps": len(step_s), "calls": calls,
               "queries": len(step_s) * mix["configs"] * inputs.n_points,
               "step_s": step_s, "chunks_per_step": len(loop.chunks),
               "host_call_s": list(loop.host_call_s), "window_peak_bytes": window_peak,
               "plain": None, "annotated": None, "roofline": None}
        if trace:
            run["plain"] = traced(loop, mix["trace_steps"], annotate=False)
            run["annotated"] = traced(loop, mix["trace_steps"], annotate=True)
        records = loop.records
        del loop, prog
        gc.unfreeze()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        ref = Reference(cfg, assets, dev, base)
        expected, dq_expected = reference_answers(ref, mix, inputs, dev)
        correct, failed, checks = judge_mod.judge(records, expected, dq_expected, mix["chunk"],
                                                  limits)
        if len(records) != calls:
            correct = False
        if trace and dev.type == "cuda":
            run["roofline"] = traced_roofline(ref, mix, inputs, dev, run["annotated"]["steps"])
        log(f"reference and judgement: {time.perf_counter() - t_ref:.1f} s")
    info = device_info(dev)
    info["memory_peak_bytes"] = int(max(setup_peak, window_peak))
    line = {"correct": correct, "attempted": calls, "failed": failed + (calls - len(records)),
            "metrics": {}, "device": info}
    for m in cell_metrics(bench, cell, trace):
        value = load_reader(m["name"], base)(run)
        if value is not None:
            line["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    if trace and run["plain"] is not None:
        info["busy_s"] = run["plain"]["busy_s"]
        info["window_s"] = run["plain"]["window_s"]
        line["breakdown"] = {"device_ops": run["plain"]["device_ops"],
                             "idle_gaps": run["plain"]["idle_gaps"]}
    line["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    line["_run"] = run
    return line


def _num(x: float):
    return x if np.isfinite(x) else str(x)


def reference_answers(ref: Reference, mix: dict, inputs: workload.Inputs, dev):
    """The reference's admissible answers at every sample position, by
    ``(batch, chunk)``, and its ``(dq, slack)`` by batch and configuration."""
    expected, dq_expected = {}, {}
    for b in range(mix["pool"]):
        for k, (c0, _) in enumerate(workload.chunk_bounds(mix)):
            q = inputs.q[b, c0 + inputs.sample_cfg[b, k]]
            p = workload.world_points(inputs, inputs.sample_pt[b, k])
            expected[(b, k)] = ref.expected(q, p)
    if inputs.dq_cfg is not None:
        pts = workload.all_world_points(inputs, dev)
        for b in range(mix["pool"]):
            dq_expected[b] = {int(i): ref.dq(inputs.q[b, int(i)], pts)
                              for i in inputs.dq_cfg[b].tolist()}
    return expected, dq_expected


def traced_roofline(ref: Reference, mix: dict, inputs: workload.Inputs, dev, steps: int):
    """The lookup layer's least time a call, averaged over the calls of the
    labelled traced window (its steps ran batches ``0 .. steps - 1``)."""
    world = workload.all_world_points(inputs, dev)
    kind = torch.cuda.get_device_name(dev)
    gradients = not mix.get("values_only", False)
    per_batch = {}
    total, n = 0.0, 0
    for s in range(steps):
        b = s % mix["pool"]
        if b not in per_batch:
            per_batch[b] = []
            for c0, c1 in workload.chunk_bounds(mix):
                work = roofline.lookup_work(ref, inputs.q[b, c0:c1], world, gradients)
                per_batch[b].append(roofline.least_seconds(work, kind))
        for least in per_batch[b]:
            if least is None:
                return None
            total += least["seconds"]
            n += 1
    first = per_batch[0][0]
    return {"least_s_per_call": total / n, "bound": first["bound"]}
