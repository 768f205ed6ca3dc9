"""The MC decoder against its roofline, in %: the decoder sites' least
time at S·B images (work_mc.decoder_least_s: each site's published
function, the MC head's conv9_2 and head with its f32 probabilities) over
the device ms a request launched under their spans (``mc_decoder_ms.mc``),
whatever runs there."""

import readings
import work_mc


def read(rec):
    ms = readings.site_ms(rec, [f"fwd:{s}" for s in
                                work_mc.decoder_sites(rec["cfg"])])
    if not ms:
        return None
    return work_mc.decoder_least_s(rec["cfg"], rec["batch"]) / ms * 1e5
