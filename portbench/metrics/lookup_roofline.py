"""The lookup layer's least time (``roofline.py``: counted from the workload,
the larger of its bytes and operations bounds) over its device time, in %."""


def read(run):
    t, r = run["annotated"], run["roofline"]
    if not t or not r or not t["calls"] or not t["layer_s"].get("lookup"):
        return None
    return 100.0 * r["least_s_per_call"] / (t["layer_s"]["lookup"] / t["calls"])
