"""Device ms a train step launched under the backward parts of the
standard levels' ten 3x3 convs, conv3_1 ... conv7_2:
``bwd:<site>/mask_bias`` (the ReLU mask and the bias grad), ``/dgrad``
and ``/wgrad``, which the program opens in the backward of those convs'
autograd Functions. A program whose std convs run their backward under
autograd's own nodes opens none of these spans; the metric then reads
None."""

import readings

SITES = ["conv3_1", "conv3_2", "conv4_1", "conv4_2", "conv5_1", "conv5_2",
         "conv6_1", "conv6_2", "conv7_1", "conv7_2"]
PARTS = ["mask_bias", "dgrad", "wgrad"]


def read(rec):
    return readings.site_ms(rec, [f"bwd:{s}/{p}" for s in SITES
                                  for p in PARTS])
