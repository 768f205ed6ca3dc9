"""The fan-out kernel against its roofline, in %: the least time of
reading the bottleneck's B activations and writing S·B dropped copies
(work_mc.fanout_least_s, bytes) over the device ms a request launched
under ``fwd:mc_fanout``."""

import readings
import work_mc


def read(rec):
    ms = readings.site_ms(rec, ["fwd:mc_fanout"])
    if not ms:
        return None
    return work_mc.fanout_least_s(rec["cfg"], rec["batch"]) / ms * 1e5
