"""Device milliseconds a call of the forward's kernels launched under the
lookup layer's spans (``transforms``, ``sdf``, ``ops``, ``voxel``,
``utils``; FK's excluded) in the labelled traced window."""


def read(run):
    t = run["annotated"]
    if not t or not t["calls"] or not t["layer_s"].get("lookup"):
        return None
    return t["layer_s"]["lookup"] / t["calls"] * 1e3
