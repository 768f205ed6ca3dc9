"""The packed kernels H1-H4 and H6 against their roofline over a train
step's packed sites, in %: the forwards of conv1_1 (H3), conv1_2 and
conv2_2 (H1 with the pool and its index), conv2_1 (H3), upconv3-4 (H4),
conv8_1 and conv9_1 (H2), conv8_2 and conv9_2 (H1), and the input
gradients that H6 computes (``bwd:<site>/dgrad`` of conv1_2, conv2_2,
conv8_1, conv8_2, conv9_1, conv9_2). Left out, being no hand kernel's:
the head (``fwd:head``, ATen), conv2_1's dgrad (cuDNN), upconv3-4's
dgrads (cuBLAS) and every wgrad (cuBLAS). Where one of the listed sites
is missing or another computing group launches there, the metric reads
None (``readings.kernel_roofline``)."""

import readings

FWD = ["conv1_1", "conv1_2", "conv2_1", "conv2_2", "upconv3", "conv8_1",
       "conv8_2", "upconv4", "conv9_1", "conv9_2"]
DGRAD = ["conv1_2", "conv2_2", "conv8_1", "conv8_2", "conv9_1", "conv9_2"]


def read(rec):
    return readings.kernel_roofline(
        rec, ["H1", "H2", "H3", "H4", "H6"],
        [f"fwd:{s}" for s in FWD] + [f"bwd:{s}/dgrad" for s in DGRAD])
