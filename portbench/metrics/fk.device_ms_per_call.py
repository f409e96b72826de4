"""Device milliseconds a call of the kernels launched under FK's spans
(``kinematics``, ``RobotSDF._link_transforms``) in the labelled traced
window."""


def read(run):
    t = run["annotated"]
    if not t or not t["calls"] or not t["layer_s"].get("fk"):
        return None
    return t["layer_s"]["fk"] / t["calls"] * 1e3
