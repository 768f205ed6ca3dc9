"""The median latency of all the window's requests, from when each was due
until its masks were on the host, in ms."""

import readings


def read(rec):
    return readings.latency_ms(rec, 50)
