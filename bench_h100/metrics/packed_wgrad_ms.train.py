"""Device ms a train step launched under the weight gradients of the six
packed 2x2 sites, conv1_2, conv2_2, conv8_1, conv8_2, conv9_1 and conv9_2:
``bwd:<site>/wgrad``, which the program opens in the backward of those
sites' autograd Functions, whatever computes the gradient there: library
products, their copies or a hand kernel."""

import readings

SITES = ["conv1_2", "conv2_2", "conv8_1", "conv8_2", "conv9_1", "conv9_2"]


def read(rec):
    return readings.site_ms(rec, [f"bwd:{s}/wgrad" for s in SITES])
