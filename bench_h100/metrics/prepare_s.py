"""The own seconds of the program's set-up spans (``setup:prepare``,
``setup:calibrate``, ``setup:plan``), summed, without ``setup:kernels``
(the nvcc build or the library's load), while the run builds a served
cell's server a second time after its windows: the weights' packing, the
int8 calibration and its plan, warm (the imports, the kernels' library
and the libraries' handles are already there). It is the warm rebuild's
own time, not the cold set-up that ``setup_s`` holds: what only a first
build pays (first calls into cuDNN, lazy imports, the allocator's first
blocks) does not show in it. The trainer opens no set-up span, so the
train cell has none to read."""

import readings


def read(rec):
    return readings.prepare_s(rec)
