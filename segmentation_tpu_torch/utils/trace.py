"""The port's spans: named ranges of the program, off by default.

    from segmentation_tpu_torch.utils import trace

    with trace.span("serve:request"):        # the range seg:serve:request
        ...
    with trace.span("fwd", site):            # seg:fwd:<site>
        ...
    with trace.span("bwd", site, "/dgrad"):  # seg:bwd:<site>/dgrad
        ...

A span is on while a ``torch.profiler`` session records on the calling
thread, and then opens the range ``seg:<name>``: an event of the same
profiler session as the kernels it launches, so that the program's spans
and the device trace share one clock. Otherwise ``span`` returns one
shared no-op object: it formats no string and builds nothing, which is
why a call site passes the site name apart from the span's kind and
suffix.

The range is PyTorch's C++ ``RecordFunction`` at function scope
(``_RecordFunctionFast``, as ``torch._inductor`` opens its kernels'
ranges): under a profiler it costs the host about a tenth of
``torch.profiler.record_function``, which goes through the dispatcher,
and, being at function scope, it is what the profiler links a kernel to
when no ATen op encloses its launch (the hand kernels' ctypes launches).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name: str, site: Optional[str] = None, suffix: str = ""):
    """A context manager: the span ``<name>`` or ``<name>:<site><suffix>``,
    e.g. ``span("fwd", "conv3_1")`` is ``fwd:conv3_1``."""
    if not _profiling():
        return _OFF
    return _range("seg:" + (name if site is None
                            else f"{name}:{site}{suffix}"))
