"""The device's idle time while it runs a request, in %: between the first
and the last activity that the calls inside each ``serve:request`` span
launched, over those envelopes' summed length. The device waits there for
the host's next launch; read on the device's clock alone (devtrace's
``span_readings``).

It follows the host's pace in the traced window, which the profiler slows:
about 1 - (device ms) / (dispatch ms) a request. The host's pace swings
from window to window and from process to process, so the share swings
about 2x between runs (17-39 % read on an H100), and a longer traced
window does not narrow it. It ranks only large changes, such as fewer
launches or a request that no longer waits on the host; the steady
count beside it is ``launch_calls.b8``."""

import readings


def read(rec):
    return readings.dispatch_idle_share(rec)
