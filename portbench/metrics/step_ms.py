"""Milliseconds a step, over every step and all the time of the window
(window seconds over steps): the wait for one step of the mix."""


def read(run):
    return run["window_s"] / run["steps"] * 1e3
