"""Tracing and timing utilities.

- :func:`device_time`: seconds per call, timed with CUDA events around
  ``reps`` calls after a warm-up (``time.perf_counter`` for CPU tensors).
- :func:`kernel_time`: the card's kernel time per call (no launch gaps)
  and the device kernels per call, from a ``torch.profiler`` trace.
- :func:`span`: a named wall-clock span that also shows in profiler traces.
- :func:`trace`: a ``torch.profiler`` trace of the CPU and the card.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Dict, Optional

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


@contextlib.contextmanager
def span(name: str, sink: Optional[Dict[str, float]] = None):
    """Named wall-clock span, also a ``torch.profiler.record_function`` so
    it shows inside profiler traces.  Adds the seconds to ``sink[name]``.
    The span does not synchronise the card: wrap work that ends in a
    synchronise to time the device."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    logger.info("%s: %.3f ms", name, dt * 1e3)


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
