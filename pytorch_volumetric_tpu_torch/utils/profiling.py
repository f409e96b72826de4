"""Tracing and timing utilities.

- :func:`device_time`: seconds per call, timed with CUDA events around
  ``reps`` calls after a warm-up (``time.perf_counter`` for CPU tensors).
- :func:`kernel_time`: the card's kernel time per call (no launch gaps)
  and the device kernels per call, from a ``torch.profiler`` trace.
- :func:`span`: a named span that shows in profiler traces and costs one
  check when no profiler runs; with a ``sink``, also its wall-clock seconds.
- :data:`COUNTERS`, :func:`count`: the process's counts of kernel launches
  (``kernel.<op>``) and of the branches the query paths took (``path.*``).
- :func:`trace`: a ``torch.profiler`` trace of the CPU and the card.
- :func:`annotated_profile`, :func:`device_kernels`, :func:`kernel_owners`:
  a trace with the port's functions labelled (:func:`port_annotations`),
  its kernels, and which of the port's functions launched each.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import inspect
import logging
import time
from typing import Callable, Dict, List, Optional

import torch

logger = logging.getLogger(__name__)


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def device_time(fn: Callable, *args, reps: int = 10, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls, then ``reps``
    calls timed together.  On CUDA tensors (the first tensor argument
    decides) the time is taken with CUDA events on the current stream, so it
    is the card's time for the calls, launch gaps included; on CPU tensors
    with ``time.perf_counter``."""
    device = _device_of(args)
    for _ in range(warmup):
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        dt = (time.perf_counter() - t0) / reps
    logger.debug("device_time: %.3f ms/call on %s", dt * 1e3, device)
    return dt


def kernel_time(fn: Callable, *args, reps: int = 10, warmup: int = 1, by_name: bool = False):
    """``(seconds, kernels)`` per call of ``fn(*args)`` on the card: the
    device time of every kernel and memset the calls ran (the gaps between
    them left out) and their number, from a ``torch.profiler`` trace of
    ``reps`` calls after ``warmup``; with ``by_name`` a third item, the
    seconds per call of each kernel by name.  A trace that saw no device
    time is taken once more before this raises.  Needs a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if events:
            break
    else:
        raise RuntimeError("the profiler saw no device time")
    us = sum(e.self_device_time_total for e in events)
    out = (us / 1e6 / reps, sum(e.count for e in events) / reps)
    if by_name:
        out += ({e.key: e.self_device_time_total / 1e6 / reps for e in events},)
    return out


_OFF = contextlib.nullcontext()

# launches of each hand-written kernel (``kernel.<op>``) and the branch each
# query took (``path.*``), counted in the process since it started
COUNTERS: collections.Counter = collections.Counter()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTERS[name]``."""
    COUNTERS[name] += n


def span(name: str, sink: Optional[Dict[str, float]] = None):
    """A context manager naming a span of work in profiler traces.

    While a profiler runs it is ``torch.profiler.record_function(name)``, so
    the span shares the profiler's clock with the device timeline; otherwise
    a shared no-op, at the cost of one check.  With ``sink`` it also adds its
    wall-clock seconds to ``sink[name]`` (it does not synchronise the card:
    wrap work that ends in a synchronise to time the device)."""
    if sink is not None:
        return _timed(name, sink)
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def _timed(name: str, sink: Dict[str, float]):
    t0 = time.perf_counter()
    with span(name):
        yield
    sink[name] = sink.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and (when present) the
    card, written to ``log_dir`` for TensorBoard or Perfetto::

        with profiling.trace("traces/query"):
            robot.query(q, pts)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
    logger.info("profiler trace written to %s", log_dir)


# the port's modules on the robot and north-star paths, for :func:`port_annotations`
PORT_MODULES = ("pytorch_volumetric_tpu_torch.sdf", "pytorch_volumetric_tpu_torch.transforms",
                "pytorch_volumetric_tpu_torch.kinematics",
                "pytorch_volumetric_tpu_torch.model_to_sdf",
                "pytorch_volumetric_tpu_torch.bench.northstar")


@contextlib.contextmanager
def port_annotations(modules=PORT_MODULES):
    """Every top-level function of ``modules`` wrapped in a
    ``record_function`` labelled ``module.function`` while the block runs;
    yields the set of labels.  Calls that resolve the name at call time
    (``tfm.transform_points``, a module's own helpers) go through the
    wrapper.  These labels name a kernel's caller where the profiler
    records no Python stacks (``with_stack=True`` gave none with torch 2.11
    on an H100)."""
    def annotate(f, label):
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                return f(*args, **kwargs)
        return wrapped

    saved, labels = [], set()
    for name in modules:
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


def annotated_profile(fn: Callable, modules=PORT_MODULES):
    """``(prof, labels)``: a ``torch.profiler`` trace of one call of
    ``fn()`` on the card under :func:`port_annotations` (keep it apart from
    a timed call: the labels cost host time).  Needs a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    with port_annotations(modules) as labels, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof, labels


def device_kernels(prof, labels=()) -> Dict[str, list]:
    """``{name: [launches, device ms]}`` of every kernel, memset and copy
    of a trace, each counted once (``key_averages``' device events).  The
    spans that ``record_function`` labels (``labels``, and any other user
    annotation) leave on the device's timeline are not kernels and are
    left out."""
    return {e.key: [e.count, e.self_device_time_total / 1e3] for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in labels and not getattr(e, "is_user_annotation", False)}


def kernel_owners(prof, labels, pattern: str = "") -> List[dict]:
    """Which calls launched the device kernels whose name holds ``pattern``
    (every kernel for ``""``) in a trace of :func:`annotated_profile`.  One
    record per kernel name, launching operators (inside their parent
    operators) and two innermost labelled callers: ``{"kernel", "ops",
    "caller", "launches", "ms"}`` with the kernels' device ms, the largest
    first.  In a trace of a backward some kernels are listed under more
    than one operator (on an H100 with torch 2.11, 1,296 listed against
    the 1,141 that :func:`device_kernels` counts), so take totals from
    :func:`device_kernels` and the callers from here."""
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
        caller = " > ".join(callers) or "no function of the port"
        for k in kernels:
            owner = owners[(k.name, " > ".join(ops), caller)]
            owner[0] += 1
            owner[1] += k.duration / 1e3
    return [{"kernel": k, "ops": ops, "caller": caller, "launches": n, "ms": ms}
            for (k, ops, caller), (n, ms) in sorted(owners.items(), key=lambda kv: -kv[1][1])]
