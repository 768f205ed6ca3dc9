"""Where the flagship train step's device time goes, by call site
(torch.profiler, one GPU).

    python -m segmentation_tpu_torch.profile_train [--batch 128] [--data] \
        [--out FILE]

Builds the flagship SegmentationTrainer(UNetS2D) from seed 0, as
chip_smoke.py phase 6 does, and on one device-resident synthetic batch
runs two warm-up steps, times STEPS (3) by CUDA events and traces STEPS
more. Each device activity (kernel, copy, set) is attributed to the call
site that launched it: the innermost ``seg:`` profiler range around its
launch (the model's
hooks ``seg:fwd:<site>``, the Functions' backward parts
``seg:bwd:<site>/<part>``, the trainer's ``seg:fwd:input``,
``seg:fwd:loss`` and ``seg:optimizer``), prefixed in the backward with the
autograd node that ran it (``_Conv2x2Backward``, ``_StdConv3x3Backward``,
upconv1-2's ``ReluBackward0``, ...).
A launch outside every range keeps the name of its outermost op. The
ranges are the program's spans (utils/trace.py), on while the profiler
records. The step's ``seg:train:sync`` gives the device's idle time from
the end of each step's closing ``float(loss)`` sync to the end of the next
step's ``fwd:loss`` (profile_serving.span_readings), and the longest idle
gaps are named by the innermost span and op at each (``train:step |
Optimizer.zero_grad``; profile_serving.gap_names).

Prints, per step: the device ms (the union of the activities' intervals)
and the CUDA-event ms of the untraced steps, the groups of
profile_serving.group_of, the share of device time the attribution
reached, and each call site's ms and launches with its groups; ``--out``
writes every (site, activity) row. ``--data`` also times the data path's
device tail on 600² u8 staging tiles (chip_smoke.py phase 7's): H7
(``fused_augment_at``: the bf16 image and the u8 mask) by CUDA events, and
the step fed through it against the same step on the device-resident
batch, in turns (data, resident, resident, data; 5 steps each).
"""

from __future__ import annotations

import argparse
import collections
from typing import Dict, Tuple

_NODE = "autograd::engine::evaluate_function: "
STEPS = 3  # traced (and, before them, timed) steps
# the packed sites and the standard levels of the flagship (4 levels)
_PACKED = {"conv1_2", "conv2_1", "conv2_2", "conv8_1", "conv8_2", "conv9_1",
           "conv9_2", "upconv3", "upconv4"}
# autograd's own nodes at the standard levels: upconv1-2 and the pools
_STD_NODES = {"ConvolutionBackward0", "ReluBackward0", "AddBackward0",
              "MaxPool2DWithIndicesBackward0", "PermuteBackward0",
              "CloneBackward0", "CatBackward0"}
_FUNCTIONS = ("_Conv2x2Backward", "_Conv2x2PoolBackward",
              "_Conv2x2DualBackward", "_Conv4x4s2Backward",
              "_MatmulRowsBackward", "_DeconvPackedBackward")
# the std levels' 3×3 convs (H8 forward, nn/kernels/train.py)
_STD_FUNCTIONS = ("_StdConv3x3Backward", "_StdConv3x3DualBackward")


def site_of(event) -> str:
    """The call site of a CPU op that launched device work: its innermost
    ``seg:`` range, behind the autograd node that ran it, if any."""
    seg, node, top = None, None, event.name
    p = event
    while p is not None:
        if seg is None and p.name.startswith("seg:"):
            seg = p.name[4:]
        if node is None and p.name.startswith(_NODE):
            node = p.name[len(_NODE):]
        top = p.name
        p = p.cpu_parent
    if seg is None:
        return node or top
    return f"{node} {seg}" if node else seg


def category(site: str, group: str) -> str:
    """The call-site category of a (site, kernel group) pair: the packed
    sites' forwards and backward parts, the pool, the crop, the entry, the
    standard levels, the head / loss / optimizer."""
    node, _, seg = site.partition(" ") if " " in site else ("", "", site)
    if site.startswith("fwd:"):
        name = site[4:]
        if name in ("pool1", "pool2"):
            return "pool4_select forward"
        if name == "conv1_1":
            return "conv1_1 entry (forward)"
        if name in _PACKED:
            return ("packed forwards: crop copies" if group == "copies"
                    else "packed forwards: H1-H4")
        if name in ("head", "loss", "input", "pack_weights"):
            return "head, loss, input, weight packing"
        if name.startswith("conv"):
            return "std levels forward: 3x3 convs (H8)"
        return "std levels forward: upconv1-2, pools (cuDNN, ATen)"
    if site == "optimizer":
        return "optimizer"
    if not node and site in _FUNCTIONS + _STD_FUNCTIONS:
        node, seg = site, ""
    if node in _STD_FUNCTIONS:
        if group.startswith("glue") or seg.endswith("/mask_bias"):
            return "std levels backward: mask + bias grad"
        if seg.endswith("/wgrad"):
            return "std levels backward: wgrads (+ the dual's crop copy)"
        if seg.endswith("/dgrad"):
            return "std levels backward: dgrads (+ the dual's un-crop)"
        return "std levels backward: other"
    if node in _FUNCTIONS:
        if group.startswith("glue") or seg.endswith(("/mask", "/bias",
                                                     "/mask_bias")):
            return "packed backward: mask + bias grad (+ pool, un-crop)"
        if seg.endswith("/wgrad"):
            return ("packed backward: wgrad copies / pads"
                    if group == "copies" else "packed backward: wgrads")
        if group.startswith("H6") or seg.endswith("/dgrad"):
            return "packed backward: dgrads"
        return "packed backward: other"
    if site == "_Pool4SelectBackward":
        return "pool4_select backward"
    if site == "SliceBackward0":
        return "crop backward (SliceBackward0: packed and std crops)"
    if site in _STD_NODES:
        return "std levels backward: upconv1-2, pools (cuDNN, ATen)"
    return "head, loss, input, weight packing"


def attribute(events, n: int) -> Tuple[float, Dict, Dict, float, Dict]:
    """(device ms per step, {site: (ms, launches) per step}, {(site,
    group): ms per step}, the share of device time attributed, {activity:
    ms per step} of the activities no CPU op claimed) from a trace's
    FunctionEvents over ``n`` steps."""
    from torch.autograd import DeviceType

    from segmentation_tpu_torch.profile_serving import (
        device_activities,
        group_of,
        union_us,
    )

    dev = device_activities(events)
    total_us = sum(e.time_range.elapsed_us() for e in dev)
    union = union_us((e.time_range.start, e.time_range.end) for e in dev)
    sites: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    by_group: Dict[tuple, float] = collections.defaultdict(float)
    seen_us = 0.0
    claimed = collections.Counter()
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        site = site_of(e)
        for k in e.kernels:
            if k.name.startswith("seg:"):
                continue
            sites[site][0] += k.duration / n / 1e3
            sites[site][1] += 1
            by_group[(site, group_of(k.name))] += k.duration / n / 1e3
            seen_us += k.duration
            claimed[k.name] += k.duration
    rest: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        us = e.time_range.elapsed_us()
        if claimed[e.name] >= us:
            claimed[e.name] -= us
        else:
            rest[e.name] += us / n / 1e3
    rows = {s: (v[0], v[1] / n) for s, v in sites.items()}
    share = seen_us / total_us if total_us else 0.0
    return union / n / 1e3, rows, dict(by_group), share, dict(rest)


def trace_steps(step, steps: int):
    """Two warm-up calls of ``step``, ``steps`` timed by CUDA events
    untraced, then the same traced: (CUDA-event ms per step, events)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step()
    stop.record()
    stop.synchronize()
    wall = start.elapsed_time(stop) / steps
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    return wall, prof.events()


def report(tag: str, wall: float, events, steps: int):
    """The summary lines and the per-(site, activity) table."""
    from segmentation_tpu_torch.profile_serving import (
        breakdown,
        gap_names,
        span_readings,
    )

    dev_ms, groups, acts = breakdown(events, steps)
    _, sites, by_group, share, rest = attribute(events, steps)
    sync = span_readings(events)["sync_idle_us"]
    lines = [f"[profile_train] {tag}: CUDA-event ms per step {wall:.3f}; "
             f"device ms per step {dev_ms:.3f}; busy share "
             f"{dev_ms / wall:.3f}; attributed to call sites "
             f"{share:.4f} of device time; device idle from a step's "
             f"loss sync to the next fwd:loss's end "
             + (", ".join(f"{us / 1e3:.3f}" for us in sync) or "none")
             + " ms",
             f"[profile_train] {tag}   longest idle gaps: " + "; ".join(
                 f"{name} {sec * 1e3:.3f} ms"
                 for name, sec in gap_names(events, 3))]
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        lines.append(f"[profile_train] {tag}   group {g}: {ms:.3f} ms")
    for s, (ms, k) in sorted(sites.items(), key=lambda kv: -kv[1][0]):
        parts = ", ".join(
            f"{g.split(' (')[0]} {v:.3f}"
            for (s2, g), v in sorted(by_group.items(), key=lambda kv: -kv[1])
            if s2 == s)
        lines.append(f"[profile_train] {tag}   {ms:8.3f} ms {k:6.1f}x "
                     f"{s}: {parts}")
    cats: Dict[str, float] = collections.defaultdict(float)
    for (site, g), v in by_group.items():
        cats[category(site, g)] += v
    for c, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        lines.append(f"[profile_train] {tag}   category {ms:8.3f} ms {c}")
    fn_ms = sum(v for c, v in cats.items()
                if c.startswith(("packed", "conv1_1")))
    lines.append(f"[profile_train] {tag}   the packed sites' Functions "
                 f"(forward and backward, the entry's forward): {fn_ms:.3f} "
                 f"ms a step")
    for name, ms in sorted(rest.items(), key=lambda kv: -kv[1])[:10]:
        lines.append(f"[profile_train] {tag}   unattributed {ms:8.3f} ms "
                     f"{name[:110]}")
    table = [f"==== {tag}: device activities, ms per step, launches per "
             "step"]
    table += [f"{ms:9.4f} {k:6.2f}  {name[:160]}" for ms, k, name in acts]
    return lines, table


# The flagship's ten trainable packed sites at 512² (the Functions of
# nn/kernels/train.py): (site, kind, input [H, W, C] a sample, output
# [h, w, 4O] a sample); the duals' skip is read through its crop window,
# the size of up; the level sites also write their pool and its int8 index
FLAGSHIP_SITES = (
    ("conv1_1", "entry", (512, 512, 3), (255, 255, 128)),
    ("conv1_2", "pool", (255, 255, 128), (254, 254, 128)),
    ("conv2_1", "conv", (254, 254, 32), (126, 126, 256)),
    ("conv2_2", "pool", (126, 126, 256), (125, 125, 256)),
    ("upconv3", "conv", (84, 84, 128), (84, 84, 256)),
    ("conv8_1", "dual", (84, 84, 256), (83, 83, 256)),
    ("conv8_2", "conv", (83, 83, 256), (82, 82, 256)),
    ("upconv4", "conv", (82, 82, 256), (164, 164, 128)),
    ("conv9_1", "dual", (164, 164, 128), (163, 163, 128)),
    ("conv9_2", "conv", (163, 163, 128), (162, 162, 128)),
)


def function_bytes(n: int) -> int:
    """The bytes the Functions of a flagship train step at batch n must
    move, each tensor read or written once, bf16 (the index int8): the
    forward reads its input(s) and writes y (and the level's pool and
    index); the backward reads the cotangent(s), y, the input(s) for the
    weight gradient, writes the input gradient(s) (the entry's image needs
    none). Weights and biases are a few MB and left out."""
    total = 0
    for _, kind, (hi, wi, ci), (ho, wo, co) in FLAGSHIP_SITES:
        x, y = hi * wi * ci * 2, ho * wo * co * 2
        ins = 2 * x if kind == "dual" else x
        extra = ho * wo * co // 4 * 3 if kind == "pool" else 0  # pool, idx
        fwd = ins + y + extra
        bwd = y + y + extra + ins + (0 if kind == "entry" else ins)
        total += n * (fwd + bwd)
    return total


def _events_ms(fn, iters):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def data_tail(trainer, batch, tile=600, crop=512, seed=3):
    """(H7 ms, data-path step ms, resident step ms): see ``--data``."""
    import numpy as np
    import torch

    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation
    from segmentation_tpu_torch.nn.kernels import augment as aug

    n = batch["image"].shape[0]
    b = SyntheticSegmentation(16, (tile, tile), seed=seed).get_batch()
    idx = np.random.default_rng(seed).integers(0, 16, n)
    imgs = torch.from_numpy(np.rint(b["image"][idx] * 255).astype(np.uint8))
    masks = torch.from_numpy(b["mask"][idx])
    imgs, masks = imgs.cuda(), masks.cuda()
    ys, xs, flips = aug.random_offsets(generator(seed, "cuda"), imgs.shape,
                                       crop, x_step=8)

    def h7():
        return aug.fused_augment_at(imgs, masks, ys, xs, flips, crop,
                                    torch.bfloat16)

    def data_step():
        img, mask = h7()
        trainer.train_step({"image": img, "mask": mask})

    def resident():
        trainer.train_step(batch)

    h7()
    h7_ms = (_events_ms(h7, 10) + _events_ms(h7, 10)) / 2
    data_step()
    d1, r1, r2, d2 = (_events_ms(f, 5) for f in (data_step, resident,
                                                 resident, data_step))
    return h7_ms, (d1 + d2) / 2, (r1 + r2) / 2


def main(argv=None) -> None:
    import subprocess
    import tempfile

    import torch

    from segmentation_tpu_torch.core.config import TrainConfig
    from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.serving import flagship_config
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--data", action="store_true",
                    help="also time H7 and the step through the data path")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_config()
    tag = f"kernels B={args.batch}"
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(save_dir=tmp)
        trainer = SegmentationTrainer(UNetS2D(cfg, seed=tcfg.seed),
                                      device="cuda", train_cfg=tcfg)
        batch = trainer._place(SyntheticSegmentation(
            args.batch, cfg.hw, seed=2).get_batch())
        torch.cuda.reset_peak_memory_stats()
        wall, events = trace_steps(lambda: trainer.train_step(batch),
                                   STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**20
        tail = data_tail(trainer, batch) if args.data else None
    lines, table = report(tag, wall, events, STEPS)
    lines.insert(0, smi)
    lines.append(f"[profile_train] {tag}: peak memory {peak:.1f} MiB")
    fb = function_bytes(args.batch)
    lines.append(f"[profile_train] {tag}: the Functions must move "
                 f"{fb / 1e9:.2f} GB a step: bound {fb / 3.35e12 * 1e3:.3f} "
                 f"ms at 3.35 TB/s")
    if tail is not None:
        h7_ms, d_ms, r_ms = tail
        lines.append(f"[profile_train] {tag}: H7 (bf16 image + u8 mask, "
                     f"600² → 512²) {h7_ms:.4f} ms; step through the data "
                     f"path {d_ms:.3f} ms, on the device-resident batch "
                     f"{r_ms:.3f} ms: the data path adds {d_ms - r_ms:.3f} "
                     f"ms")
    print("\n".join(lines))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines + table) + "\n")


if __name__ == "__main__":
    main()
