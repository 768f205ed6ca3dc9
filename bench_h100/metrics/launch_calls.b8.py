"""The CUDA runtime and driver calls that enqueue work (``cudaLaunch*``,
``cuLaunch*``, ``cudaMemcpy*``, ``cudaMemset*``, ``cudaGraphLaunch``)
starting inside a ``serve:request`` span, a request's mean (device trace:
the profiler's host events)."""

import readings


def read(rec):
    return readings.launch_calls(rec)
