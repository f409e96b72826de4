"""``RobotSDF.query_grid``: the configurations over the mix's grid
(``grid.range``, ``grid.resolution``); values and gradients, or values only
where the mix sets ``values_only``."""


def call(robot, mix, q, inputs):
    return robot.query_grid(q, mix["grid"]["range"], mix["grid"]["resolution"],
                            values_only=mix.get("values_only", False))
