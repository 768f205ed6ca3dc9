"""The device's idle ms from the end of the last activity launched before
each step's ``train:sync`` (the loss read back to the host) ends, to the
end of the last activity launched inside the next step's ``fwd:loss``: a
step's mean, read on the device's clock alone."""

import readings


def read(rec):
    return readings.sync_idle_ms(rec)
