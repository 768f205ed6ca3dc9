"""H1's MC head (conv9_2, the decoder-end dropout, the two-class head and
its sigmoids) against its roofline, in %: conv9_2's and the head's least
time at S·B images (work_mc.head_least_s: their operations, or their
input, weights and f32 probabilities) over the device ms a request
launched under ``fwd:conv9_2+mc_head``."""

import readings
import work_mc


def read(rec):
    ms = readings.site_ms(rec, ["fwd:conv9_2+mc_head"])
    if not ms:
        return None
    images = work_mc.samples(rec["cfg"]) * rec["batch"]
    return work_mc.head_least_s(rec["cfg"], images) / ms * 1e5
