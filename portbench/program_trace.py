"""The program's own layers in a ``torch.profiler`` trace of the benchmark's
calls, read from the spans the program opens at its layer boundaries
(``pvt.*``, ``utils/profiling.span`` in the port) and from nothing else.

:func:`program_layers` reads a plain traced window (no function of the program
wrapped) and gives each layer its host self seconds, the device seconds of
the kernels it launched, the device's idle seconds while it was the
innermost span open on the host, and the backward's device seconds by the
layer of the forward operation each backward step derives from.  Time under
no span of the program is ``outside``.  A ``pvt.*`` span of another name
than :data:`LAYERS` knows keeps its own name as its layer, so a renamed span
shows as a new layer and never adds to a known one.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional

import torch

from portbench.trace import CALL, WINDOW, _is_device, _union

# the program's spans and the layer each one opens
LAYERS = {"pvt.query": "entry", "pvt.query_grid": "entry", "pvt.fk": "fk",
          "pvt.lookup": "lookup"}
PREFIX = "pvt."
OUTSIDE = "outside"
# the autograd engine's span around one backward step; its ``sequence_nr``
# and ``fwd_thread`` name the forward operation the step derives from
BACKWARD_STEP = "autograd::engine::evaluate_function: "


def _layer(span_name: str) -> str:
    return LAYERS.get(span_name, span_name)


def _nearest(e, test):
    """``e`` or its nearest enclosing host event that passes ``test``."""
    while e is not None and not test(e):
        e = e.cpu_parent
    return e


def _is_span(e) -> bool:
    return e.name.startswith(PREFIX)


def _is_backward_step(e) -> bool:
    return e.name.startswith(BACKWARD_STEP)


def linked_forward(step, forward: Dict[tuple, object]):
    """The operation of ``forward`` (:func:`forward_ops`) that the backward
    step ``step`` derives from: the one with its ``(fwd_thread,
    sequence_nr)``, or None."""
    return forward.get((step.fwd_thread, step.sequence_nr))


def op_layer(e, forward: Dict[tuple, object]) -> tuple:
    """``("forward" | "backward", layer)`` of host event ``e``: inside a
    backward step, the layer of the forward operation the step derives from
    (:func:`linked_forward`; ``outside`` if none), else the layer of its
    innermost program span."""
    step = _nearest(e, _is_backward_step)
    if step is not None:
        fwd = linked_forward(step, forward)
        return "backward", (OUTSIDE if fwd is None else op_layer(fwd, {})[1])
    span = _nearest(e, _is_span)
    return "forward", (OUTSIDE if span is None else _layer(span.name))


def forward_ops(host) -> Dict[tuple, object]:
    """The forward operations of ``host`` events that created an autograd
    node, by ``(thread, sequence_nr)``."""
    return {(e.thread, e.sequence_nr): e for e in host
            if e.sequence_nr >= 0 and _nearest(e, _is_backward_step) is None}


def program_layers(prof) -> dict:
    """The plain traced window's time by the program's layers.

    Returns ``calls`` (the benchmark's call spans), ``window_s``,
    ``device_total_s`` (every kernel, memset and copy of the window), and
    dicts of seconds by layer (``entry``, ``fk``, ``lookup``, ``outside``):
    ``host_self_s`` (a span's time less the program spans nested in it; with
    ``outside`` it sums to ``window_s``), ``device_s`` (the forward's
    kernels, memsets and copies by the innermost span around the operation
    that launched them), ``backward_device_s`` (the backward's, by the
    layer of the forward operation each backward step derives from) and
    ``idle_s`` (each gap between device operations by the innermost span
    open on the host at its middle; sums to the window's idle time)."""
    events = prof.events()
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    windows = [e for e in cpu if e.name == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    host = [e for e in cpu if w0 <= e.time_range.start <= w1]
    spans = sorted((e for e in host if _is_span(e)), key=lambda e: e.time_range.start)

    host_self: Dict[str, float] = collections.defaultdict(float)
    host_self[OUTSIDE] = (w1 - w0) / 1e6
    for s in spans:
        us = s.time_range.end - s.time_range.start
        host_self[_layer(s.name)] += us / 1e6
        parent = _nearest(s.cpu_parent, _is_span)
        host_self[OUTSIDE if parent is None else _layer(parent.name)] -= us / 1e6

    forward = forward_ops(host)
    device: Dict[str, Dict[str, float]] = {"forward": collections.defaultdict(float),
                                           "backward": collections.defaultdict(float)}
    seen = set()
    for e in host:
        # an operation's kernels are listed under every host event of its
        # correlation id: count them once
        if not e.kernels or e.id in seen:
            continue
        seen.add(e.id)
        phase, layer = op_layer(e, forward)
        device[phase][layer] += sum(k.duration for k in e.kernels) / 1e6

    dev = [e for e in events if _is_device(e) and not _is_span(e)
           and e.time_range.end > w0 and e.time_range.start < w1]
    busy = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev])
    starts = [s.time_range.start for s in spans]
    idle: Dict[str, float] = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            span = _open_span(spans, starts, (a + b) / 2)
            idle[OUTSIDE if span is None else _layer(span.name)] += (b - a) / 1e6

    return {"calls": sum(1 for e in host if e.name == CALL), "window_s": (w1 - w0) / 1e6,
            "device_total_s": sum(e.time_range.end - e.time_range.start for e in dev) / 1e6,
            "host_self_s": dict(host_self), "device_s": dict(device["forward"]),
            "backward_device_s": dict(device["backward"]), "idle_s": dict(idle)}


def _open_span(spans: List, starts: List[float], t: float) -> Optional[object]:
    """The innermost of ``spans`` (start-sorted; they nest) open at ``t``."""
    for s in reversed(spans[:bisect.bisect_right(starts, t)]):
        if s.time_range.end >= t:
            return s
    return None

