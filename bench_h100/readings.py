"""What the metric readers (``metrics/<name>.py``) share: the arithmetic
over a run's record. A reader returns None where the record holds nothing
for it (no trace, no requests), and the harness then leaves its metric
out of the line.

The record (run.py): ``cfg``, ``batch``, ``setup_s``; ``window`` (the
timed window of drive.py: ``steps`` or ``requests``, ``images``,
``window_s``, the per-request ``latency_s`` and ``dispatch_s``); ``trace``
(the traced window: ``units`` it completed, ``window_s``, every key of
devtrace.reduce, and a served cell's ``setup_s_by_span``,
devtrace.setup_spans of the server built again) or None; ``least_s`` and
``compute_s``, the bound of one unit of the cell's work, a request or a
step, as its mode counts it (``modes/<mode>.py`` over work.py).
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, Optional

import work

# device groups (devtrace.group_of) that compute none of a layer's
# published arithmetic
NO_ARITHMETIC = ("copies", "glue crop_margin_zero")


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


def _trace(rec: dict, key: str):
    """The traced window's ``key``, or None where there is no trace, no
    unit completed in it or the key reads empty (a program without the
    spans)."""
    t = rec.get("trace")
    if not t or not t["units"] or not t.get(key):
        return None
    return t[key]


def launch_calls(rec: dict) -> Optional[float]:
    """The mean work-enqueuing calls of a ``serve:request`` span."""
    reqs = _trace(rec, "requests")
    return None if reqs is None else statistics.fmean(r[0] for r in reqs)


def dispatch_idle_share(rec: dict) -> Optional[float]:
    """The device's idle time between the first and the last activity of
    each ``serve:request`` span's launches, over those envelopes' summed
    length, in %."""
    reqs = _trace(rec, "requests")
    if reqs is None or sum(r[2] for r in reqs) <= 0:
        return None
    return sum(r[1] for r in reqs) / sum(r[2] for r in reqs) * 100


def sync_idle_ms(rec: dict) -> Optional[float]:
    """The device's mean idle ms from a step's loss sync to the end of the
    next ``fwd:loss``'s work."""
    idle = _trace(rec, "sync_idle_s")
    return None if idle is None else statistics.fmean(idle) * 1e3


def span_units(rec: dict) -> int:
    """The requests or steps whose device time a traced window's spans
    hold: every ``serve:request`` span (the window's first call, made
    before it counts requests, too), else the steps it completed."""
    t = rec["trace"]
    return len(t.get("requests") or ()) or t["units"]


def site_ms(rec: dict, spans: Iterable[str]) -> Optional[float]:
    """Device ms a request or step launched under the site spans
    ``spans``."""
    site = _trace(rec, "site_s")
    if site is None:
        return None
    found = [site[s] for s in spans if s in site]
    return sum(found) / span_units(rec) * 1e3 if found else None


def prepare_s(rec: dict) -> Optional[float]:
    """The set-up spans' own seconds, summed (without the kernels'
    build or load)."""
    spans = _trace(rec, "setup_s_by_span")
    return None if spans is None else sum(spans.values())


def span_part(span: str):
    """(site, part) of a site span: ``fwd:<site>`` the forward,
    ``bwd:<site>/<part>`` a backward part."""
    kind, _, rest = span.partition(":")
    if kind == "fwd":
        return rest, "fwd"
    site, _, part = rest.rpartition("/")
    return site, part


def kernel_roofline(rec: dict, groups: Iterable[str],
                    spans: Iterable[str]) -> Optional[float]:
    """The kernel groups ``groups`` (devtrace.HAND's labels by their first
    word: ``H1`` … ``H8``) against their roofline over the site spans
    ``spans``, in %: the least time of each span's part of its layers
    (work.site_least_s) at the cell's batch, times the traced units
    (``span_units``), over the groups' device seconds under those spans.

    The set of sites is fixed by the caller: a metric file lists the sites
    where its groups do the whole of the published arithmetic, and names
    in its docstring those it leaves out. Where a listed span is missing
    from the trace, has none of the groups' launches, or holds a launch of
    another group that computes (a library conv or GEMM, an ATen pass,
    another hand kernel), the set no longer holds and the metric reads
    None, never a share over fewer sites; copies and the margin zeroing
    (``NO_ARITHMETIC``) do not split a site."""
    sg = _trace(rec, "site_group_s")
    if sg is None:
        return None
    groups = set(groups)
    least = busy = 0.0
    for span in spans:
        got = sg.get(span, {})
        mine = {g: v for g, v in got.items() if g.split()[0] in groups}
        if not mine or any(g not in mine and g not in NO_ARITHMETIC
                           for g in got):
            return None
        site, part = span_part(span)
        least += work.site_least_s(rec["cfg"], site, part, rec["batch"])
        busy += sum(mine.values())
    if busy <= 0:
        return None
    return least * span_units(rec) / busy * 100
