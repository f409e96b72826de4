"""Device milliseconds a call of K1's sweep kernels (``csrc/closest_point.cu``,
found by name) in the plain traced window: the exact links' sweeps."""

from portbench import exact_work


def read(run):
    s = exact_work.k1_seconds_per_call(run)
    return None if s is None else s * 1e3
