"""Device kernels, memsets and copies per call in the plain traced window."""


def read(run):
    t = run["plain"]
    if not t or not t["launches"] or not t["calls"]:
        return None
    return t["launches"] / t["calls"]
