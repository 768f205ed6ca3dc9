"""Device ms a request launched under the standard levels' sites: the ten
3x3 convs conv3_1 ... conv7_2, the two transposed convs upconv1-2 and the
max pools (``fwd:std_pool``)."""

import readings

SITES = ["conv3_1", "conv3_2", "conv4_1", "conv4_2", "conv5_1", "conv5_2",
         "conv6_1", "conv6_2", "conv7_1", "conv7_2", "upconv1", "upconv2",
         "std_pool"]


def read(rec):
    return readings.site_ms(rec, [f"fwd:{s}" for s in SITES])
