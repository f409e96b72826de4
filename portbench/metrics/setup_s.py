"""Set-up seconds: from the process's start to the first timed call (import,
CUDA context, the robot and its link caches built by K1, the inputs, the
window's shapes run once)."""


def read(run):
    return run["setup_s"]
