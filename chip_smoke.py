#!/usr/bin/env python3
"""Drive the PyTorch port's U-Net 512² serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device  — require CUDA, print the card's name and power limit, turn
               TF32 off for the f32 references;
  2. build   — compile the four kernels from segmentation_tpu_torch/csrc;
  3. kernels — each kernel against its plain PyTorch version at the 512²
               sites' shapes (N = 2 and B = 8, bf16), every mode on the
               path, then each site's time at B = 8 against the plain
               version's (CUDA events; the first launches warm up);
  4. slice   — 4 requests of B = 8 through serving.entry (apply_argmax)
               and one apply; every kernel must have launched, the masks
               must agree with the same forward on the plain versions and
               the logits with the f32 plain U-Net;
  5. the kernels' JSON line, then {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

B_PARITY, B_SERVE, HW = 2, 8, 512
# bf16 outputs: the kernel and the plain version round the same f32 sum
# (in another order, and the plain one sometimes twice) to 8 mantissa bits
REL_TOL = 2e-2       # max |kernel - plain| <= REL_TOL * max |plain|
# masks: a pixel may flip only where its head margin lies within that same
# bf16 tolerance (REL_TOL * max |margin|); the random operands of the
# standalone head site put many margins there, so its share bound is
# looser than the served forward's
SITE_MASK_AGREE = 0.99
MASK_AGREE = 0.999
# bf16 serving vs the f32 plain U-Net: ~18 conv layers each round the
# activations to bf16 (2^-9 relative), which compounds to a few percent of
# the largest logit; random weights leave many margins near zero, hence
# the looser mask bound
LOGIT_TOL = 5e-2     # max |bf16 - f32| <= LOGIT_TOL * max |f32 logits|
REF_MASK_AGREE = 0.98

SOURCES = {k: f"segmentation_tpu_torch/csrc/{k}.cu" for k in (
    "packed_conv2x2", "packed_conv2x2_dual", "strided_conv4x4s2",
    "rows_matmul")}
REPLACES = {
    "packed_conv2x2": "segmentation_tpu/nn/pallas/conv_flat.py:275, "
                      "segmentation_tpu/nn/pallas/conv_flat.py:1162",
    "packed_conv2x2_dual": "segmentation_tpu/nn/pallas/conv_flat.py:503, "
                           "segmentation_tpu/nn/pallas/conv_flat.py:1379",
    "strided_conv4x4s2": "segmentation_tpu/nn/pallas/conv_flat.py:667, "
                         "segmentation_tpu/nn/pallas/conv_flat.py:1738",
    "rows_matmul": "segmentation_tpu/nn/pallas/conv_flat.py:785, "
                   "segmentation_tpu/nn/pallas/conv_flat.py:896",
}


def _time_ms(fn, iters=10):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _sites(n, gen):
    """The ten packed sites of one 512² forward (n_kernels = 32):
    (kernel, label, args, kwargs) with random operands of the path's
    shapes and dtypes."""
    import torch

    from segmentation_tpu_torch.models.unet_fast import head_diff

    dev = gen.device

    def act(*shape):  # post-ReLU-like activations
        return torch.rand(shape, generator=gen, device=dev).to(torch.bfloat16)

    def wgt(*shape):
        k = 1
        for s in shape[:-1]:
            k *= s
        w = torch.randn(shape, generator=gen, device=dev) / k**0.5
        return w.to(torch.bfloat16)

    def bias(o4):
        return torch.randn((o4,), generator=gen, device=dev) * 0.1

    # the path's head: the per-slot difference of a random 1×1 nc=2 head
    wd, bd = head_diff(torch.randn((1, 1, 32, 2), generator=gen, device=dev)
                       / 32**0.5, torch.randn((2,), generator=gen, device=dev))
    head = (wd.to(torch.bfloat16), bd)
    return [
        ("strided_conv4x4s2", "conv1_1 C=3", (act(n, 512, 512, 3),
                                              wgt(4, 4, 3, 128), bias(128)),
         {}),
        ("packed_conv2x2", "conv1_2 +pool", (act(n, 255, 255, 128),
                                             wgt(2, 2, 128, 128), bias(128)),
         {"pool": True}),
        ("strided_conv4x4s2", "conv2_1 C=32", (act(n, 254, 254, 32),
                                               wgt(4, 4, 32, 256), bias(256)),
         {}),
        ("packed_conv2x2", "conv2_2 +pool", (act(n, 126, 126, 256),
                                             wgt(2, 2, 256, 256), bias(256)),
         {"pool": True}),
        ("rows_matmul", "upconv3 identity", (act(n, 84, 84, 128),
                                             wgt(128, 256), bias(256)),
         {"scatter": False}),
        ("packed_conv2x2_dual", "conv8_1 odd phase (41,41)",
         (act(n, 125, 125, 256), act(n, 84, 84, 256),
          wgt(2, 2, 256, 256), wgt(2, 2, 256, 256), bias(256)),
         {"offset": (41, 41)}),
        ("packed_conv2x2", "conv8_2", (act(n, 83, 83, 256),
                                       wgt(2, 2, 256, 256), bias(256)), {}),
        ("rows_matmul", "upconv4 scatter", (act(n, 82, 82, 256),
                                            wgt(64, 128), bias(128)),
         {"scatter": True}),
        ("packed_conv2x2_dual", "conv9_1 even (90,90)",
         (act(n, 254, 254, 128), act(n, 164, 164, 128),
          wgt(2, 2, 128, 128), wgt(2, 2, 128, 128), bias(128)),
         {"offset": (90, 90)}),
        ("packed_conv2x2", "conv9_2 head_only", (act(n, 163, 163, 128),
                                                 wgt(2, 2, 128, 128),
                                                 bias(128)),
         {"head": head, "head_only": True}),
    ]


def _outs(v):
    return v if isinstance(v, tuple) else (v,)


def _parity(label, got, want, margin=None) -> float:
    """Check one kernel output against the plain version's; return the
    max abs error of a float output (0.0 for a mask, which is held by
    ``margin``, the plain version's head value before the sign)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    if got.dtype == torch.uint8:
        diff = got != want
        agree = 1.0 - diff.float().mean().item()
        bound = REL_TOL * margin.abs().max().item()
        worst = margin.abs()[diff].max().item() if diff.any() else 0.0
        print(f"[kernels] {label}: mask agreement {agree:.6f} "
              f"(>= {SITE_MASK_AGREE}); largest flipped margin {worst:.3e} "
              f"(<= {bound:.3e} = {REL_TOL} x max margin)")
        if agree < SITE_MASK_AGREE or worst > bound:
            raise AssertionError(f"{label}: masks agree {agree}, flipped "
                                 f"margin {worst}")
        return 0.0
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    print(f"[kernels] {label}: max abs err {err:.3e} "
          f"(tol {REL_TOL * scale:.3e} = {REL_TOL} x {scale:.3e})")
    if not err <= REL_TOL * scale:
        raise AssertionError(f"{label}: err {err} > tol")
    return err


def _kernel_phase():
    """Each kernel against its plain version at every site of the path,
    N = 2 and B = 8; each site's time at B = 8. Returns per kernel the
    max abs error and the summed kernel and plain times (ms)."""
    import torch

    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.nn.kernels import conv_flat as cf

    wrappers = dict(zip(cf.NAMES, cf.KERNEL_OPS))
    plains = dict(zip(cf.NAMES, cf.PLAIN_OPS))
    worst = dict.fromkeys(cf.NAMES, 0.0)
    ms = dict.fromkeys(cf.NAMES, 0.0)
    plain_ms = dict.fromkeys(cf.NAMES, 0.0)
    for n in (B_PARITY, B_SERVE):
        for name, label, args, kw in _sites(n, generator(7 + n, "cuda")):
            got = _outs(wrappers[name](*args, **kw))
            want = _outs(plains[name](*args, **kw))
            margin = None
            if "head" in kw:
                wd, bd = kw["head"]
                margin = plains[name](*args).float() @ wd.float() + bd
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                worst[name] = max(worst[name], _parity(
                    f"N={n} {name} {label}", g, w, margin))
            if n != B_SERVE:
                continue
            k_fn = lambda: wrappers[name](*args, **kw)  # noqa: E731
            p_fn = lambda: plains[name](*args, **kw)  # noqa: E731
            t_p1, t_k1, t_k2, t_p2 = (_time_ms(f) for f in
                                      (p_fn, k_fn, k_fn, p_fn))
            t_k, t_p = (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2
            ms[name] += t_k
            plain_ms[name] += t_p
            print(f"[kernels] time B={n} {name} {label}: {t_k:.4f} ms, "
                  f"plain {t_p:.4f} ms")
    return worst, ms, plain_ms


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.models.unet import UNet
    from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
    from segmentation_tpu_torch.nn.kernels import _build
    from segmentation_tpu_torch.nn.kernels import conv_flat as cf
    from segmentation_tpu_torch.serving import Server, entry

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    regs = [int(v) for v in re.findall(r"Used (\d+) registers",
                                       _build.build_log)]
    spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                            _build.build_log))
    print(f"[build] {lib_path.name} in {build_s:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s); registers per thread "
          f"{min(regs, default=0)}-{max(regs, default=0)}, spill stores "
          f"{spills} B")

    # ---- 3. kernel parity (N = 2 and B = 8) and timing (B = 8) ----------
    worst, ms, plain_ms = _kernel_phase()

    # ---- 4. slice: 4 requests of B = 8 ---------------------------------
    torch.cuda.empty_cache()
    server, (x0,) = entry("cuda", batch=B_SERVE, seed=0)
    gen = generator(1234, "cuda")
    reqs = [torch.rand((B_SERVE, HW, HW, 3), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(4)]
    server(x0)  # warm-up request (cuDNN algorithm choice), not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cf.reset_launches()
    lat, masks = [], []
    for x in reqs:
        t0 = time.perf_counter()
        masks.append(server(x))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    logits = server.logits(reqs[0])
    torch.cuda.synchronize()
    counts = dict(cf.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"[slice] launches {counts}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    oh, ow = server.model.output_hw((HW, HW))
    for m in masks:
        if tuple(m.shape) != (B_SERVE, oh, ow) or m.dtype != torch.uint8:
            raise AssertionError(f"mask {tuple(m.shape)} {m.dtype}")
        if int(m.max()) > 1:
            raise AssertionError("mask values beyond {0, 1}")
    if tuple(logits.shape) != (B_SERVE, oh, ow, 2):
        raise AssertionError(f"logits {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")

    plain = Server(UNetS2DInference(server.model.cfg, ops=cf.PLAIN_OPS),
                   server.params, server.prepared)
    agree = min((plain(x) == m).float().mean().item()
                for x, m in zip(reqs, masks))
    print(f"[slice] masks vs plain-version forward (bf16): min agreement "
          f"{agree:.6f} (>= {MASK_AGREE})")
    if agree < MASK_AGREE:
        raise AssertionError(f"masks vs plain versions: {agree}")

    ref = UNet(server.model.cfg, params=server.params).cuda()
    with torch.no_grad():
        want = ref(reqs[0].float())
    err = (logits.float() - want).abs().max().item()
    scale = want.abs().max().item()
    ref_agree = (masks[0] == want.argmax(-1)).float().mean().item()
    print(f"[slice] logits vs f32 plain U-Net: max abs err {err:.4e} "
          f"(tol {LOGIT_TOL * scale:.4e} = {LOGIT_TOL} x {scale:.4e}); "
          f"mask agreement {ref_agree:.6f} (>= {REF_MASK_AGREE})")
    if not err <= LOGIT_TOL * scale:
        raise AssertionError(f"logits err {err} > tol")
    if ref_agree < REF_MASK_AGREE:
        raise AssertionError(f"mask agreement vs f32 {ref_agree}")
    lat_ms = [t * 1e3 for t in lat]
    print(f"[slice] B={B_SERVE} latency ms per request {lat_ms} "
          f"(mean {sum(lat_ms) / len(lat_ms):.3f}, min {min(lat_ms):.3f}); "
          f"{len(reqs) * B_SERVE / sum(lat):.1f} img/s; "
          f"peak memory {peak / 2**20:.1f} MiB")

    # ---- 5. results -----------------------------------------------------
    kernels = [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": counts[k],
         "max_abs_err": worst[k], "ms": ms[k], "plain_ms": plain_ms[k]}
        for k in cf.NAMES
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
