"""The moments kernel against its roofline, in %: the least time of
reading the S·B probabilities and writing the B tiles' mean, variance and
map (work_mc.moments_least_s, bytes) over the device ms a request
launched under ``fwd:mc_moments``."""

import readings
import work_mc


def read(rec):
    ms = readings.site_ms(rec, ["fwd:mc_moments"])
    if not ms:
        return None
    return work_mc.moments_least_s(rec["cfg"], rec["batch"]) / ms * 1e5
