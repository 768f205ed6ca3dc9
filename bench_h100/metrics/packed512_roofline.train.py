"""The packed kernels' 4O = 512 modes (n_kernels 64's level 2: two column
tiles of 256 a pixel tile) against their roofline over a train step's
level-2 sites, in %: the forwards of conv2_1 (H3, boxed), conv2_2 (H1 with
the pool and its index), upconv3 (H4, identity), conv8_1 (H2, the crop
folded into its skip boxes) and conv8_2 (H1), and the input gradients that
H6 computes at 4C = 512 (``bwd:<site>/dgrad`` of conv2_2, conv8_1 and
conv8_2). Left out, being no hand kernel's: conv2_1's dgrad (cuDNN),
upconv3's dgrad (cuBLAS) and every wgrad (cuBLAS). Where one of the listed
sites is missing or another computing group launches there, the metric
reads None (``readings.kernel_roofline``), as on a program without the
4O = 512 modes, whose wrappers refuse n_kernels 64 before any launch."""

import readings

FWD = ["conv2_1", "conv2_2", "upconv3", "conv8_1", "conv8_2"]
DGRAD = ["conv2_2", "conv8_1", "conv8_2"]


def read(rec):
    return readings.kernel_roofline(
        rec, ["H1", "H2", "H3", "H4", "H6"],
        [f"fwd:{s}" for s in FWD] + [f"bwd:{s}/dgrad" for s in DGRAD])
