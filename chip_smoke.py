#!/usr/bin/env python3
"""Drive the PyTorch port's U-Net 512² serving paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device  — require CUDA, print the card's name and power limit, turn
               TF32 off for the f32 references;
  2. build   — compile the kernels from segmentation_tpu_torch/csrc;
  3. kernels — each bf16 kernel against its plain PyTorch version at the
               512² sites' shapes (N = 2 and B = 8), every mode on the
               path, then each site's time at B = 8 against the plain
               version's (CUDA events; the first launches warm up);
  3b.        — the same for the int8 path: H5 and the int8 modes of H1–H4
               at every int8 site;
  4. slice   — 4 requests of B = 8 through serving.entry (apply_argmax),
               whose launches alone are counted, then one apply (logits);
               every kernel must have launched in the requests, the masks
               must agree with the same forward on the plain versions and
               the logits with the f32 plain U-Net;
  4b.        — the int8 slice: serving.entry(int8=True) calibrated on one
               seeded B = 8 batch, then the same 4 requests; H5 and every
               int8 mode must have launched and no bf16 kernel, the masks
               must agree with the int8 forward on the plain versions and
               with the f32 plain U-Net;
  5. the B = 8 latency of both slices, the kernels' JSON line, then
     {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import gc
import json
import re
import statistics
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
# int8 kernels: the s8 × s8 products are exact on both sides and the
# epilogues round in the same order, so s8 codes may differ by one (H5's
# bf16 conv1_1 sums in another order), on at most this share of codes
CODE_DIFF_SHARE = 1e-3
# int8 slice: against the same int8 forward on the plain versions, the JAX
# package's bar between two int8 chains (tests/test_unet_padflat.py);
# against the f32 plain U-Net, its post-training-quantization bar
# (tests/test_unet_int8.py)
INT8_MASK_AGREE = 0.99
INT8_REF_MASK_AGREE = 0.97
INT8_REF_CORR = 0.98

SOURCES = {k: f"segmentation_tpu_torch/csrc/{k}.cu" for k in (
    "packed_conv2x2", "packed_conv2x2_dual", "strided_conv4x4s2",
    "rows_matmul")}
SOURCES.update({f"{k}_s8": v for k, v in SOURCES.items()})  # int8 modes
SOURCES["entry_chain"] = "segmentation_tpu_torch/csrc/entry_chain.cu"
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
REPLACES.update({f"{k}_s8": v for k, v in REPLACES.items()})  # int8 modes
REPLACES["entry_chain"] = "segmentation_tpu/nn/pallas/conv_flat.py:1644"


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


def _sites8(n, gen):
    """The int8 path's kernel sites of one 512² forward: resident s8
    activations (post-ReLU codes), s8 weights, and epilogue vectors that
    spread the requantized outputs over the code range."""
    import torch

    from segmentation_tpu_torch.models.unet_fast import head_diff

    dev = gen.device

    def codes(*shape):
        return torch.randint(0, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def wq(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def vecs(o4, k, scale=1.0):  # acc std ~ 127²/3 · √k
        mul = (torch.rand((o4,), generator=gen, device=dev) + 0.5) \
            * (60.0 / (5376.0 * k**0.5) * scale)
        return mul, torch.randn((o4,), generator=gen, device=dev) * 10 * scale

    def dual(c4, o4):
        (cs_a, _), (cs_b, add) = vecs(o4, 8 * c4), vecs(o4, 8 * c4)
        return (wq(2, 2, c4, o4), wq(2, 2, c4, o4), cs_a, cs_b,
                torch.ones((o4,), device=dev), add)

    x = torch.rand((n, 512, 512, 3), generator=gen, device=dev)
    w4 = torch.randn((4, 4, 3, 128), generator=gen, device=dev) / 48**0.5
    mul1 = torch.full((128,), 100.0, device=dev)  # conv1_1 acc std ~ 0.6
    add1 = torch.randn((128,), generator=gen, device=dev) * 10
    wd, bd = head_diff(torch.randn((1, 1, 32, 2), generator=gen, device=dev)
                       / 32**0.5, torch.randn((2,), generator=gen, device=dev))
    head = (wd.to(torch.bfloat16), bd)
    return [
        ("entry_chain", "level 1 conv1_1+conv1_2+pool",
         (x.to(torch.bfloat16), w4.to(torch.bfloat16), mul1, add1,
          wq(2, 2, 128, 128), *vecs(128, 512)), {}),
        ("strided_conv4x4s2_s8", "conv2_1 C=32",
         (codes(n, 254, 254, 32), wq(4, 4, 32, 256), *vecs(256, 512)), {}),
        ("packed_conv2x2_s8", "conv2_2 +pool",
         (codes(n, 126, 126, 256), wq(2, 2, 256, 256), *vecs(256, 1024)),
         {"pool": True}),
        ("rows_matmul_s8", "upconv3 identity",
         (codes(n, 84, 84, 128), wq(128, 256), *vecs(256, 128)),
         {"scatter": False}),
        ("packed_conv2x2_dual_s8", "conv8_1 odd phase (41,41)",
         (codes(n, 125, 125, 256), codes(n, 84, 84, 256), *dual(256, 256)),
         {"offset": (41, 41)}),
        ("packed_conv2x2_s8", "conv8_2",
         (codes(n, 83, 83, 256), wq(2, 2, 256, 256), *vecs(256, 1024)), {}),
        ("rows_matmul_s8", "upconv4 scatter",
         (codes(n, 82, 82, 256), wq(64, 128), *vecs(128, 64)),
         {"scatter": True}),
        ("packed_conv2x2_dual_s8", "conv9_1 even (90,90)",
         (codes(n, 254, 254, 128), codes(n, 164, 164, 128),
          *dual(128, 128)), {"offset": (90, 90)}),
        ("packed_conv2x2_s8", "conv9_2 head_only (bf16 value)",
         (codes(n, 163, 163, 128), wq(2, 2, 128, 128),
          *vecs(128, 512, 1 / 20)),
         {"requant": False, "head": head, "head_only": True}),
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
    if got.dtype == torch.int8:
        d = (got.int() - want.int()).abs()
        worst, share = int(d.max().item()), (d > 0).float().mean().item()
        print(f"[kernels] {label}: max |code diff| {worst} (<= 1), share "
              f"of codes differing {share:.2e} (<= {CODE_DIFF_SHARE})")
        if worst > 1 or share > CODE_DIFF_SHARE:
            raise AssertionError(f"{label}: codes differ by {worst} on "
                                 f"{share} of the elements")
        return float(worst)
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


def _kernel_phase(mod, sites):
    """Each kernel of ``mod`` against its plain version at every site of
    the path, N = 2 and B = 8; each site's time at B = 8. Returns per
    kernel the max abs error and the summed kernel and plain times (ms)."""
    import torch

    from segmentation_tpu_torch.core.rng import generator

    wrappers = {k: getattr(mod, k) for k in mod.NAMES}
    plains = {k: getattr(mod, f"{k}_plain") for k in mod.NAMES}
    worst = dict.fromkeys(mod.NAMES, 0.0)
    ms = dict.fromkeys(mod.NAMES, 0.0)
    plain_ms = dict.fromkeys(mod.NAMES, 0.0)
    for n in (B_PARITY, B_SERVE):
        for name, label, args, kw in sites(n, generator(7 + n, "cuda")):
            got = _outs(wrappers[name](*args, **kw))
            want = _outs(plains[name](*args, **kw))
            margin = None
            if "head" in kw:
                wd, bd = kw["head"]
                y_kw = {k: v for k, v in kw.items()
                        if k not in ("head", "head_only")}
                margin = plains[name](*args, **y_kw).float() @ wd.float() + bd
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


def _serve(server, reqs, reset):
    """After one warm-up request (cuDNN and cuBLASLt algorithm choice),
    ``reset`` the launch counts, then time the requests (host clock, each
    ending in a sync); return the masks, the latencies (s) and the peak
    device memory (bytes)."""
    import torch

    server(reqs[0])
    torch.cuda.synchronize()
    gc.collect()  # no collector pause inside the timed requests
    reset()
    torch.cuda.reset_peak_memory_stats()
    lat, masks = [], []
    for x in reqs:
        t0 = time.perf_counter()
        masks.append(server(x))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return masks, lat, torch.cuda.max_memory_allocated()


def _check_masks(masks, shape):
    import torch

    for m in masks:
        if tuple(m.shape) != shape or m.dtype != torch.uint8:
            raise AssertionError(f"mask {tuple(m.shape)} {m.dtype}")
        if int(m.max()) > 1:
            raise AssertionError("mask values beyond {0, 1}")


def _latency_line(tag, lat, peak):
    lat_ms = [t * 1e3 for t in lat]
    mean = sum(lat_ms) / len(lat_ms)
    print(f"[slice] {tag} B={B_SERVE} latency ms per request {lat_ms} "
          f"(mean {mean:.3f}, median {statistics.median(lat_ms):.3f}, "
          f"min {min(lat_ms):.3f}); "
          f"{len(lat) * B_SERVE / sum(lat):.1f} img/s; "
          f"peak memory {peak / 2**20:.1f} MiB")
    return mean, len(lat) * B_SERVE / sum(lat), peak / 2**20


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.models.unet import UNet
    from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
    from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8
    from segmentation_tpu_torch.nn.kernels import _build
    from segmentation_tpu_torch.nn.kernels import conv_flat as cf
    from segmentation_tpu_torch.nn.kernels import conv_int8 as ci
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
    worst, ms, plain_ms = _kernel_phase(cf, _sites)
    for k, v in zip(_kernel_phase(ci, _sites8), (worst, ms, plain_ms)):
        v.update(k)

    # ---- 4. slice: 4 requests of B = 8 ---------------------------------
    torch.cuda.empty_cache()
    server, (x0,) = entry("cuda", batch=B_SERVE, seed=0)
    gen = generator(1234, "cuda")
    reqs = [torch.rand((B_SERVE, HW, HW, 3), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(4)]
    assert tuple(x0.shape) == tuple(reqs[0].shape)
    masks, lat, peak = _serve(server, reqs, cf.reset_launches)
    counts = dict(cf.launches)  # the served requests' launches alone
    print(f"[slice] launches {counts}")
    logits = server.logits(reqs[0])
    torch.cuda.synchronize()
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    oh, ow = server.model.output_hw((HW, HW))
    _check_masks(masks, (B_SERVE, oh, ow))
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
    bf16_e2e = _latency_line("bf16", lat, peak)
    del server, plain
    torch.cuda.empty_cache()

    # ---- 4b. int8 slice: calibrate on one batch, serve 4 requests -------
    calib = torch.rand((B_SERVE, HW, HW, 3), generator=generator(4321, "cuda"),
                       device="cuda")
    t0 = time.perf_counter()
    server8, _ = entry("cuda", batch=B_SERVE, seed=0, int8=True,
                       calib=[calib])
    torch.cuda.synchronize()
    print(f"[int8] prepared and calibrated in "
          f"{time.perf_counter() - t0:.1f} s")

    def reset_all():
        cf.reset_launches()
        ci.reset_launches()

    masks8, lat8, peak8 = _serve(server8, reqs, reset_all)
    counts8, bf16_in_int8 = dict(ci.launches), dict(cf.launches)
    print(f"[int8] launches {counts8}; bf16 kernels {bf16_in_int8}")
    missing = [k for k, v in counts8.items() if v == 0]
    if missing:
        raise AssertionError(f"int8 kernels never launched: {missing}")
    if any(bf16_in_int8.values()):
        raise AssertionError("the int8 path launched a bf16 kernel")
    logits8 = server8.logits(reqs[0])
    torch.cuda.synchronize()
    _check_masks(masks8, (B_SERVE, oh, ow))
    if tuple(logits8.shape) != (B_SERVE, oh, ow, 2):
        raise AssertionError(f"int8 logits {tuple(logits8.shape)}")
    if not torch.isfinite(logits8).all():
        raise AssertionError("non-finite int8 logits")

    plain8 = Server(UNetS2DInt8(server8.model.cfg, ops=cf.PLAIN_OPS,
                                ops8=ci.PLAIN_OPS),
                    server8.params, server8.prepared)
    with torch.no_grad():
        agree8 = min((plain8(x) == m).float().mean().item()
                     for x, m in zip(reqs, masks8))
    print(f"[int8] masks vs the int8 forward on the plain versions: min "
          f"agreement {agree8:.6f} (>= {INT8_MASK_AGREE})")
    if agree8 < INT8_MASK_AGREE:
        raise AssertionError(f"int8 masks vs plain versions: {agree8}")
    ref_agree8 = (masks8[0] == want.argmax(-1)).float().mean().item()
    corr8 = torch.corrcoef(torch.stack(
        [logits8.float().flatten(), want.flatten()]))[0, 1].item()
    print(f"[int8] vs f32 plain U-Net: mask agreement {ref_agree8:.6f} "
          f"(>= {INT8_REF_MASK_AGREE}), logit correlation {corr8:.6f} "
          f"(>= {INT8_REF_CORR})")
    if ref_agree8 < INT8_REF_MASK_AGREE or corr8 < INT8_REF_CORR:
        raise AssertionError(f"int8 vs f32: agreement {ref_agree8}, "
                             f"correlation {corr8}")
    int8_e2e = _latency_line("int8", lat8, peak8)

    # ---- 5. results -----------------------------------------------------
    for tag, (mean, ips, mib) in (("bf16", bf16_e2e), ("int8", int8_e2e)):
        print(f"[summary] {smi}: {tag} B={B_SERVE} latency {mean:.3f} ms, "
              f"{ips:.1f} img/s, peak {mib:.1f} MiB")
    counts.update(counts8)
    kernels = [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": counts[k],
         "max_abs_err": worst[k], "ms": ms[k], "plain_ms": plain_ms[k]}
        for k in cf.NAMES + ci.NAMES
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
