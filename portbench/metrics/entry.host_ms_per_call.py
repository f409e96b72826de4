"""Median host milliseconds from a call's issue to its return, before the
synchronise, over the calls of the measured window."""

import numpy as np


def read(run):
    if not run["host_call_s"]:
        return None
    return float(np.median(run["host_call_s"]) * 1e3)
