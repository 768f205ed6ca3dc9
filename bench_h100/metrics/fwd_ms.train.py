"""Device ms a step of the kernels launched under the program's forward ranges
(seg:fwd:*)."""

import readings


def read(rec):
    return readings.phase_ms(rec, "fwd")
