"""The packed kernels H1-H5 against their roofline over the packed sites of
a served request, in %: levels 1-2 (bf16: conv1_1 on H3, conv1_2 on H1;
int8: both on H5, ``conv1_1+conv1_2``), conv2_1 (H3), conv2_2 (H1),
upconv3-4 (H4), conv8_1 and conv9_1 (H2), conv8_2 (H1) and conv9_2 with
the head folded in (H1, ``conv9_2+head``). Left out: none of the packed
sites; the standard levels are H8's (``h8_roofline.batch``). Where one of
these sites is missing or another computing group launches there, the
metric reads None (``readings.kernel_roofline``)."""

import readings

LEVEL1 = {"bf16": ["conv1_1", "conv1_2"], "int8": ["conv1_1+conv1_2"]}
SITES = ["conv2_1", "conv2_2", "upconv3", "conv8_1", "conv8_2", "upconv4",
         "conv9_1", "conv9_2+head"]


def read(rec):
    sites = LEVEL1[rec["cfg"]["route"]["kind"]] + SITES
    return readings.kernel_roofline(rec, ["H1", "H2", "H3", "H4", "H5"],
                                    [f"fwd:{s}" for s in sites])
