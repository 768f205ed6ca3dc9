"""Device ms a request launched under the MC decoder's site spans, which
run at S·B images: ``fwd:upconv1`` … ``fwd:conv9_1`` and
``fwd:conv9_2+mc_head`` (work_mc.decoder_sites)."""

import readings
import work_mc


def read(rec):
    return readings.site_ms(rec, [f"fwd:{s}" for s in
                                  work_mc.decoder_sites(rec["cfg"])])
