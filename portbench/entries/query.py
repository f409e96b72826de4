"""``RobotSDF.query``: the configurations over the mix's points (values and
gradients)."""


def call(robot, mix, q, inputs):
    if mix.get("values_only"):
        raise ValueError("RobotSDF.query returns values and gradients")
    return robot.query(q, inputs.points)
