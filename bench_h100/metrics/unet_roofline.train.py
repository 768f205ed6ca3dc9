"""The step's least time (work.py: compute or bytes) times the traced steps,
over the traced device busy time, in %."""

import readings


def read(rec):
    return readings.roofline(rec)
