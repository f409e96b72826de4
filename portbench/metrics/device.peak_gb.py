"""``torch.cuda.max_memory_allocated`` over the measured window (reset at
its start), in GB."""


def read(run):
    if not run["window_peak_bytes"]:
        return None
    return run["window_peak_bytes"] / 1e9
