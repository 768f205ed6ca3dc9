"""The train step's compute bound (work.py) times the window's steps, over its
wall time, in %."""

import readings


def read(rec):
    return readings.window_mfu(rec)
