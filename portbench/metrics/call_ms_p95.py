"""95th percentile of the calls' times in the window, each from its issue to
the synchronise that ends it; only where a step is one call."""

import numpy as np


def read(run):
    if run["chunks_per_step"] != 1:
        return None
    return float(np.percentile(np.asarray(run["step_s"]) * 1e3, 95))
