"""H8 (``std_conv3x3``, bf16 and s8 modes) against its roofline over the
ten standard 3x3 conv sites, conv3_1 ... conv7_2 (the duals conv6_1 and
conv7_1 with their skip read in place), in %. Each site's conv, bias and
ReLU are H8's alone, so every one counts; upconv1-2 (cuDNN and ATen) and
the pools are no H8 site. Where one of the ten is missing or another
computing group launches there, the metric reads None
(``readings.kernel_roofline``)."""

import readings

SITES = ["conv3_1", "conv3_2", "conv4_1", "conv4_2", "conv5_1", "conv5_2",
         "conv6_1", "conv6_2", "conv7_1", "conv7_2"]


def read(rec):
    return readings.kernel_roofline(rec, ["H8"], [f"fwd:{s}" for s in SITES])
