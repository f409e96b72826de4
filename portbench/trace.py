"""Reading a ``torch.profiler`` trace of the benchmark's own calls.

- :func:`port_annotations`: a frozen copy of
  ``pytorch_volumetric_tpu_torch/utils/profiling.port_annotations``,
  extended to the methods of the classes the modules define (FK and
  ``RobotSDF._link_transforms`` are methods) and to the functions a module
  imports from another module of the program.  While it is on, each such
  call is a ``record_function`` span named ``module.qualname``; the card's
  profiler records no Python stacks, so these spans name a kernel's caller.
- :func:`summarise`: the device timeline of a traced window (busy seconds,
  idle gaps named by what the host was doing, the kernels that took most
  time, launches), and the forward's kernels by layer from the spans around
  the operation that launched each.

The benchmark's own spans (``portbench.*``) mark the window, the calls and
the backward.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import importlib
import inspect
from typing import Dict, Iterable, List, Optional, Tuple

import torch

PACKAGE = "pytorch_volumetric_tpu_torch"
# the modules on the robot query's path, whose functions and methods get spans
MODULES = ("kinematics", "model_to_sdf", "sdf", "transforms", "voxel",
           "ops.coherent_union", "ops.straight_through", "ops.closest_point",
           "utils.batching")
# a kernel launched under one of these spans belongs to FK (first match wins) ...
FK_SPANS = ("kinematics.", "model_to_sdf.RobotSDF._link_transforms")
# ... else to the lookup layer; the rest of a forward call is the entry's own
LOOKUP_SPANS = ("sdf.", "transforms.", "voxel.", "ops.", "utils.")

WINDOW, CALL, BACKWARD = "portbench.window", "portbench.call", "portbench.backward"


def _short(module_name: str) -> str:
    return module_name[len(PACKAGE) + 1:] if module_name.startswith(PACKAGE + ".") else module_name


def _annotate(f, label):
    @functools.wraps(f)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return f(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def port_annotations(modules: Iterable[str] = MODULES):
    """Every function of the program reachable as an attribute of
    ``modules`` (defined there or imported from another module of the
    program), and every plain method of the classes they define, wrapped in
    a ``record_function`` named ``module.qualname`` while the block runs.
    Yields the set of span names."""
    saved, labels = [], set()
    for name in modules:
        mod = importlib.import_module(f"{PACKAGE}.{name}")
        for attr, obj in list(vars(mod).items()):
            if inspect.isfunction(obj) and obj.__module__.startswith(PACKAGE):
                label = f"{_short(obj.__module__)}.{obj.__qualname__}"
                saved.append((mod, attr, obj))
                labels.add(label)
                setattr(mod, attr, _annotate(obj, label))
            elif inspect.isclass(obj) and obj.__module__ == mod.__name__:
                for m, f in list(vars(obj).items()):
                    if inspect.isfunction(f) and not (m.startswith("__") and m != "__call__"):
                        label = f"{_short(obj.__module__)}.{f.__qualname__}"
                        saved.append((obj, m, f))
                        labels.add(label)
                        setattr(obj, m, _annotate(f, label))
    try:
        yield labels
    finally:
        for owner, attr, f in reversed(saved):
            setattr(owner, attr, f)


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("portbench.")
            and e.time_range.end > e.time_range.start)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _innermost(ops, starts, t: float):
    """The latest-started of ``ops`` (start-sorted, ``starts`` their
    starts) still running at ``t``: the host's innermost operation."""
    i = bisect.bisect_right(starts, t)
    for o in reversed(ops[max(0, i - 256):i]):
        if o.time_range.end >= t:
            return o
    return None


def _span_chain(op, names) -> List[str]:
    chain, p = [], op
    while p is not None:
        if p.name in names or p.name.startswith("portbench."):
            chain.append(p.name)
        p = p.cpu_parent
    return chain


def summarise(prof, labels: Optional[set] = None) -> dict:
    """The traced window's device timeline and each kernel's layer.

    Returns ``window_s`` (the ``portbench.window`` span), ``busy_s`` (the
    union of device operations inside it), ``launches`` (kernels, memsets
    and copies), ``calls`` (``portbench.call`` spans), ``device_ops`` (the
    ten that took most time, ``[name, s]``), ``idle_gaps`` (the ten names
    under which the device waited longest, ``[name, s]``: the host's
    innermost operation at the gap's middle, inside the benchmark's span),
    and ``layer_s`` (device seconds by layer: ``fk``, ``lookup``, ``entry``
    in a forward, and ``backward``: the rest of the device time where the
    window ran a backward)."""
    labels = labels or set()
    events = prof.events()
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    windows = [e for e in cpu if e.name == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    win = windows[0]
    w0, w1 = win.time_range.start, win.time_range.end
    host = sorted((e for e in cpu if not e.name.startswith("portbench.")
                   and e.time_range.end > w0 and e.time_range.start < w1),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    spans = {n: [(e.time_range.start, e.time_range.end) for e in cpu if e.name == n]
             for n in (CALL, BACKWARD)}
    dev = [e for e in events if _is_device(e) and e.name not in labels
           and e.time_range.end > w0 and e.time_range.start < w1]
    busy = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev])
    busy_us = sum(e - s for s, e in busy)

    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6

    def inside(t, name):
        return any(s <= t <= e for s, e in spans[name])

    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        op = _innermost(host, starts, mid)
        outer = ("backward" if inside(mid, BACKWARD) else "call" if inside(mid, CALL)
                 else "between calls")
        gaps[f"{outer} > {op.name if op is not None else 'python'}"] += (e - s) / 1e6

    # a forward kernel's layer from the spans around the operation that
    # launched it (``kernels`` of the launching operation); the backward's
    # kernels are the rest of the device time, since the autograd engine
    # lists some kernels under more than one operation
    layer_s: Dict[str, float] = collections.defaultdict(float)
    for e in cpu:
        t = e.time_range.start
        if not e.kernels or not w0 <= t <= w1 or inside(t, BACKWARD):
            continue
        chain = _span_chain(e, labels)
        layer = ("fk" if any(c.startswith(FK_SPANS) for c in chain)
                 else "lookup" if any(c.startswith(LOOKUP_SPANS) for c in chain)
                 else "entry")
        layer_s[layer] += sum(k.duration for k in e.kernels) / 1e6
    if spans[BACKWARD]:
        total = sum(by_name.values())
        layer_s["backward"] = max(0.0, total - sum(layer_s.values()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "launches": len(dev), "calls": len(spans[CALL]),
            "device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in top_gaps],
            "layer_s": dict(layer_s)}
