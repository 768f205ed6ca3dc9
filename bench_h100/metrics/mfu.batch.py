"""A request's compute bound (work.py) times the window's requests, over its
wall time, in %."""

import readings


def read(rec):
    return readings.window_mfu(rec)
