"""Images of the window's completed optimizer steps per second of its wall
time, which ends in a synchronize."""

import readings


def read(rec):
    return readings.window_rate(rec, "images")
