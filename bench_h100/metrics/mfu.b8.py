"""A request's compute bound (work.py) over the window's median latency, in
%."""

import readings


def read(rec):
    return readings.request_mfu(rec)
