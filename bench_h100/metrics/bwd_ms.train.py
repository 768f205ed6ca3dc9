"""Device ms a step of the kernels launched by autograd's backward (its nodes
and the seg:bwd:* ranges)."""

import readings


def read(rec):
    return readings.phase_ms(rec, "bwd")
