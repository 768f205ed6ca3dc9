"""A request's least time (work.py) times the traced requests, over the traced
device busy time, in %."""

import readings


def read(rec):
    return readings.roofline(rec)
