"""Device milliseconds a call of the kernels launched inside the benchmark's
span around ``torch.autograd.grad``, in the labelled traced window."""


def read(run):
    t = run["annotated"]
    if not t or not t["calls"] or not t["layer_s"].get("backward"):
        return None
    return t["layer_s"]["backward"] / t["calls"] * 1e3
