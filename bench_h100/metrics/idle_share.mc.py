"""The share of the traced window in which no device activity ran, in %."""

import readings


def read(rec):
    return readings.idle_share(rec)
