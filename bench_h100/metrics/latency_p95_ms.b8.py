"""The 95th percentile latency of all the timed window's requests, from
when each was due until its masks were on the host, in ms. At B = 8 it is
set by the host's dispatch, whose speed drifts with the machine (between
runs and within one), so it stands beside ``serve_p50_ms`` per layer and
is held to no bound."""

import readings


def read(rec):
    return readings.latency_ms(rec, 95)
