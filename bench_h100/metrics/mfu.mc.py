"""The compute bound of the window's MC requests over its wall time, in %:
each request's tiles at the encoder once and the decoder S times
(work_mc.py, 1,508.5 GFLOP a 1024² tile at n_kernels 32 and S = 8), never
S whole forwards."""

import readings


def read(rec):
    return readings.window_mfu(rec)
