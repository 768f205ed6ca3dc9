"""What the metric readers (``metrics/<name>.py``) share: the arithmetic
over a run's record. A reader returns None where the record holds nothing
for it (no trace, no requests), and the harness then leaves its metric
out of the line.

The record (run.py): ``mode``, ``batch``, ``setup_s``; ``window`` (the
timed window of drive.py: ``steps`` or ``requests``, ``images``,
``window_s``, the per-request ``latency_s`` and ``dispatch_s``); ``trace`` (the traced window: ``units`` it completed,
``window_s``, devtrace.reduce's ``busy_s`` and ``phase_s``) or None;
``least_s`` and ``compute_s``, the bound of one request or step
(work.py).
"""

from __future__ import annotations

import math
import statistics
from typing import Optional


def percentile(values, q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (0 < q <= 100)."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def latency_ms(rec: dict, q: float) -> Optional[float]:
    v = percentile(rec["window"].get("latency_s", []), q)
    return None if v is None else v * 1e3


def window_rate(rec: dict, key: str) -> Optional[float]:
    w = rec["window"]
    if not w.get(key):
        return None
    return w[key] / w["window_s"]


def window_mfu(rec: dict) -> Optional[float]:
    """The compute bound of the window's work over its time, in %."""
    w = rec["window"]
    units = w.get("steps", w.get("requests"))
    if not units:
        return None
    return rec["compute_s"] * units / w["window_s"] * 100


def request_mfu(rec: dict) -> Optional[float]:
    """A request's compute bound over the window's median latency, in %."""
    lat = latency_ms(rec, 50)
    return None if lat is None else rec["compute_s"] / lat * 1e5


def roofline(rec: dict) -> Optional[float]:
    """The traced window's least time over its device busy time, in %."""
    t = rec.get("trace")
    if not t or not t["units"] or t["busy_s"] <= 0:
        return None
    return rec["least_s"] * t["units"] / t["busy_s"] * 100


def idle_share(rec: dict) -> Optional[float]:
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return (1 - t["busy_s"] / t["window_s"]) * 100


def phase_ms(rec: dict, phase: str) -> Optional[float]:
    """Device ms a step launched from ``phase`` (fwd, bwd)."""
    t = rec.get("trace")
    if not t or not t["units"] or phase not in t["phase_s"]:
        return None
    return t["phase_s"][phase] / t["units"] * 1e3


def dispatch_ms(rec: dict) -> Optional[float]:
    d = rec["window"].get("dispatch_s")
    return statistics.fmean(d) * 1e3 if d else None
