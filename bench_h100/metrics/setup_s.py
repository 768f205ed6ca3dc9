"""Seconds from the process's start to the first timed request or step:
imports, weights, preparation, calibration, the kernels' build where there
is none yet, and the warm-up."""


def read(rec):
    return rec["setup_s"]
