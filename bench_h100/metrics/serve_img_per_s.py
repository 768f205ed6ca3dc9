"""Images whose class maps reached the host per second of the window's wall
time."""

import readings


def read(rec):
    return readings.window_rate(rec, "images")
