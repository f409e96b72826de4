"""The exact links' least time a call (``exact_work.py``: counted from the
reference's geometry, the larger of its bytes and operations bounds) over
K1's device time a call, in %."""

from portbench import exact_work


def read(run):
    return exact_work.roofline_share(run)
