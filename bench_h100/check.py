"""The numbers that decide ``correct``, each against the plain reference.

Serving: for every pixel of a sampled answer, the reference's best logit
less its logit of the class the system served, divided by the root mean
square of the reference's margin (best less second best) over that
request. A served class that the reference also ranks first reads 0; a
wrong class reads how far below the reference's choice it lies, so
near-ties that rounding may turn cost little and a wrong answer costs the
margin it overturned. ``mask_gap`` is the widest over a request,
``mean_gap`` the mean; ``gap_ratio`` is the request's ``mean_gap`` over
that of the plain reference computed at the configuration's stated
precision (``cfg["precision"]``, each conv's input and weight rounded to
it) on the same images. The mean gap of rounding varies several-fold
with the random weights of each seed, in the program and in that plain
computation alike; their ratio does not. With two classes the plain
computation takes the head as one weight difference rounded once, as a
served class map needs it: rounded per class, the head adds a constant
offset to the logit difference whose size is the luck of each seed's
rounding, and the ratio of two such offsets swung 0.2-3 from seed to
seed. Each number is compared as the largest over the sample, where the
cell's limits file names it.

Training (the first three steps, through the window's own call): the worst
step's ``loss_gap``, |program − reference| / |reference|; ``grad1_gap``,
over leaves, the gap between the norms of the first gradient (the
program's read back from Adam's first moment) over the larger of the
reference's norm of that leaf and of the median leaf; ``delta_gap``, the
same for each leaf's change over the three steps, leaving out the leaves
whose reference gradient is under a thousandth of the median leaf's (they
move under Adam by round-off alone). Both are taken by the worst leaf,
which is a different, often small, leaf on each seed; ``grad1_mid`` and
``delta_mid`` are the same gaps of the median leaf, steady from seed to
seed. The cell's limits file names the ones compared.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

import reference

SMALL_GRAD = 1e-3


def request_stats(ref_logits: torch.Tensor, served: torch.Tensor) -> dict:
    """Of one request (ref_logits [N, h, w, C] f32, served [N, h, w] class
    indices): the widest and the mean gap over the RMS margin."""
    top2 = ref_logits.topk(2, dim=-1).values
    margin_rms = float(((top2[..., 0] - top2[..., 1]) ** 2).mean().sqrt())
    got = ref_logits.gather(-1, served.long().unsqueeze(-1))[..., 0]
    gap = (top2[..., 0] - got) / max(margin_rms, 1e-30)
    return {"mask_gap": float(gap.amax()), "mean_gap": float(gap.mean())}


def stated_formats(cfg: dict) -> Dict[str, str]:
    """The reference's rounding for each layer's stated precision."""
    names = {"bf16": "bf16", "s8": "int8"}
    return {k: names[v] for k, v in cfg["precision"].items()}


def sample_stats(cfg: dict, params, pool,
                 sample: List[Tuple[int, torch.Tensor]],
                 ratio: bool = False) -> List[dict]:
    """``request_stats`` of each of ``sample``'s (pool index, served map)
    pairs against the f32 reference; with ``ratio``, also ``gap_ratio``."""
    out, cache = [], {}
    for j, served in sample:
        if j not in cache:
            ref = reference.logits(cfg, params, pool[j])
            base = None
            if ratio:
                plain = reference.logits(cfg, params, pool[j],
                                         stated_formats(cfg),
                                         diff_head=cfg["n_classes"] == 2)
                base = request_stats(ref, plain.argmax(-1))["mean_gap"]
            cache[j] = ref, base
        ref, base = cache[j]
        st = request_stats(ref, served.to(ref.device))
        if ratio:
            m = st["mean_gap"]
            st["gap_ratio"] = (m / base if base > 0
                               else (math.inf if m > 0 else 0.0))
        out.append(st)
    return out


def worst(stats: List[dict]) -> Dict[str, float]:
    """The largest of each statistic over a sample's requests."""
    return {k: max(s[k] for s in stats) for k in stats[0]}


def failed_requests(stats: List[dict], limits: Dict[str, float]) -> int:
    """The sampled requests with a compared number over its limit."""
    return sum(any(not s[k] <= lim for k, lim in limits.items())
               for s in stats)


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in leaves.items()}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              skip=()) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(want.values())
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in want if k not in skip}


def small_leaves(want: dict) -> set:
    """The leaves whose reference gradient is under ``SMALL_GRAD`` of the
    median leaf's."""
    med = statistics.median(want["grad1"].values())
    return {k for k, v in want["grad1"].items() if v < SMALL_GRAD * med}


def train_numbers(got: dict, want: dict) -> Dict[str, float]:
    """``got`` and ``want``: {"losses": [...], "grad1": {leaf: norm},
    "delta": {leaf: norm}}; the numbers the limits may name."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(got["losses"], want["losses"]))
    if not all(map(math.isfinite, got["losses"])):
        loss = math.inf
    grad1 = list(leaf_gaps(got["grad1"], want["grad1"]).values())
    delta = list(leaf_gaps(got["delta"], want["delta"],
                           small_leaves(want)).values())
    return {"loss_gap": loss,
            "grad1_gap": max(grad1), "delta_gap": max(delta),
            "grad1_mid": statistics.median(grad1),
            "delta_mid": statistics.median(delta)}


def reference_train(cfg, params, batches, formats=None, grad_format=None,
                    block: int = 16) -> dict:
    """The reference's (or a control's) readings as norms."""
    r = reference.train_readings(cfg, params, batches, formats, grad_format,
                                 block)
    return {"losses": r["losses"], "grad1": norms(r["grad1"]),
            "delta": norms(r["delta"])}


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number within its
    limit and finite."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
