"""Configuration-point queries completed in the window over the window's
seconds (a query with a backward includes its d/dq)."""


def read(run):
    return run["queries"] / run["window_s"]
