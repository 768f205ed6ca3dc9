#!/usr/bin/env python3
"""Drive the PyTorch port's U-Net 512² serving, training and data paths once
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device  — require CUDA, print the card's name and power limit, turn
               TF32 off for the f32 references;
  2. build   — compile the kernels from segmentation_tpu_torch/csrc;
  3. kernels — each bf16 kernel against its plain PyTorch version at the
               512² sites' shapes (N = 2 and B = 8), every mode on the
               path, then each site's time at B = 8 against the plain
               version's and against the one PyTorch call that computes
               the site's function on the unpacked tensors (F.conv2d,
               F.conv_transpose2d; CUDA events, in turns, each after one
               untimed call: cuDNN's first call of a shape costs more
               than a tenth of a millisecond), beside its
               bound (the larger of its bytes over the HBM rate and its
               operations of the site's function, not of its packed form,
               over the tensor cores' peak); the lines of H1 and H2 (on
               the Hopper mainloop) add the tile (th × tw) the wrapper's
               plan picked, the share of the bound and the share of the
               packed form's tensor peak (its GEMM's operations over 989
               TFLOP/s), and each mode's sums follow;
  3b.        — the same for the int8 path: H5 and the int8 modes of H1–H4
               at every int8 site of the three int8 configurations (s8
               codes, the inline-quantize modes on bf16 operands, H1's
               pool at conv1_2 of the 4-D route), the image entry's
               requant-only and s8-input modes (whose requant-only codes
               through H1's pool must equal H5's outputs), and H8's dual
               on two s8 sides (a mode no route runs); the lines of the
               int8 modes on the Hopper mainloop (s8 wgmma) add the tile,
               the share of the bound and the share of the packed form's
               s8 tensor peak (1979 TOP/s), and each mode's sums follow;
               H4 int8's and H8's library column is torch._int_mm of the
               same product (s32 out);
  3b'.       — H8's bf16 mode (the std levels' 3×3 convs of the bf16
               forward, single and dual, bias and ReLU fused) at the ten
               std sites of a 512² request, B = 2, 8 and 64: each against
               its plain version (one bf16 rounding), then at B = 8 and 64
               timed in turns against the plain version and two library
               columns, each a warm F.conv2d on the same NHWC tensors: with
               the bias and ReLU passes of nn/layers.conv2d's _finish (the
               dual: the crop, both convs, their sum, bias and ReLU: the
               path the mode replaced), and the conv alone; beside the
               bound, the tile and the share of the bf16 tensor peak; then
               each mode's and the ten sites' sums at each B;
  3c.        — the same for H6 (the packed-conv input grad), single and
               dual, at its six training sites as the step calls it (g the
               window of its zero-margined buffer, the duals' dxa stored
               into the skip's crop window), each line with the tile
               (th × tw) the wrapper's plan picked, the share of the bound
               and the share of the packed form's tensor peak (its GEMM's
               operations over 989 TFLOP/s), then each mode's sums; and
               the train step's glue kernels (train_glue.cu) at the ten
               packed train sites and the ten std sites (unpadded):
               relu_bias_grad (the level sites' pool
               mode, the 2×2 sites' zero-margined buffers) bit for bit its
               plain version's but db, within its bound of the exact sum
               (the depth of the kernel's f32 sums), which a db of zeros or
               of half the pixels exceeds, and crop_margin_zero on the
               duals' skip gradients, bit for bit; H1's train pool-index mode
               (phase 3's sites) holds its pool and index bit for bit
               against pool_select of its own y;
  3d.        — n_kernels 64 (the paper's widths): level 2's 4O = 512
               modes (H1 plain, pool and pool index, H2 with the skip's
               per-slot boxes, H3 boxed, H4's identity, H6 single and dual
               at 4C = 512) and the glue at 512 channels and at the std
               sites' doubled widths, at their 512²
               sites, checked and timed as in 3 and 3c (N = 2 and B = 8),
               each mode's sums on their own lines; then B = 16 train steps
               and B = 8 requests of the n64 model, the launch counts reset
               before the counted ones: every mode of each path must launch,
               the train path must run no plain code, a mask may differ from
               the plain versions' only within the bf16 margin; then H8's
               bf16 mode at the std sites' n64 widths (C and O 128 to
               1024) as in 3b'; the modes'
               JSON line
               ("kernels_n64") follows the kernels' line;
  3e.        — H9 (the packed 2×2 sites' weight gradient, single and
               dual) at the six train sites of both widths (n_kernels 32
               and 64), the duals' skip read in place through its crop:
               at N = 2 against the plain version in f64 (within 2^-8 of
               the result plus 2^-16 of Σ|x·g|), then at the train cells'
               B = 128 against the four library products it replaced
               (conv_bwd.conv2x2_wgrad / conv2x2_wgrad_crop, cuBLAS:
               within two bf16 roundings plus 2^-16 of Σ|x·g|) and timed
               in turns with them (the ``library_ms`` of its JSON rows),
               beside its roofline, the published 3×3 wgrad's least time
               (bench_h100/work.py's ``site_least_s``), and its packed
               bound (x, the cotangent and dw once over 3.35 TB/s, or the
               packed operations, 2 · pixels · 4 taps · 4C · 4O a side,
               16/9 of the published, over 989 TFLOP/s), the share of
               each and the K splits and blocks of its plan; the sites'
               geometry comes from the train cells' configurations
               (unet_fast.packed_wgrad_sites);
  4. slice   — 4 requests of B = 8 through serving.entry (apply_argmax),
               whose launches alone are counted, then one apply (logits);
               every kernel must have launched in the requests (H8 bf16:
               8 singles and 2 duals a request), the masks
               must agree with the same forward on the plain versions and
               the logits with the f32 plain U-Net;
  4b.        — the int8 slice: serving.entry(int8=True) calibrated on one
               seeded B = 8 batch, then the same 4 requests; H5 and every
               int8 mode must have launched and no bf16 kernel, the masks
               must agree with the int8 forward on the plain versions and
               with the f32 plain U-Net; H8 (the standard levels' s8 3×3
               conv, single and dual) recorded at each of its launches in
               one request, each equal to its plain version code for code
               and timed in turns against it and against the GEMM alone
               (torch._int_mm on its im2col matrix), beside its bound;
  4c.        — the other two int8 configurations, UNetS2DInt8(padflat=
               False) and UNetS2DInt8(quant_deconvs=False), calibrated on
               4b's batch, the same 4 requests each: exactly the expected
               launches of every kernel mode, every H8 launch of one
               request equal to its plain version, masks against the same
               configuration on the plain versions and against the f32
               plain U-Net, latency and peak memory;
  5. the B = 8 latency of every slice;
  6. train   — the flagship SegmentationTrainer(UNetS2D) from seed 0:
               (a) one B = 2 step's loss and param grads on the kernels
               against the same trainer on the plain versions and against
               the f32 plain U-Net under autograd; (b) ten Adam steps on
               one B = 16 synthetic batch, whose loss must fall; (c) the
               B = 128 step (the JAX bench's batch) on device-resident
               batches: 2 warm-up steps, then 5 timed by CUDA events, whose
               launches alone are counted (every training kernel and glue
               kernel must have launched, and the kernel path must call no
               pool4_select, plain glue, F.pad or crop copy but the duals'
               wgrad operand, one a dual launch), on both
               paths, then the device busy share of the kernel path's step;
  7. data    — (a) H7 (crop_normalize) against its plain version at the
               data path's shape, B = 128 staging tiles of 600²×3 and
               600²×1, crop 512, mixed flips, bf16, f32 and u8 out, the
               image alone and with its mask in one launch, x offsets on
               and off the 8-pixel grid: exact; the path's one launch (bf16
               image + u8 mask) timed beside its bound; (b) the data path
               into the flagship trainer: GeneratorDataSet over seeded 600² u8
               tiles → DevicePrefetcher (pinned, side stream) →
               fused_augment (H7) → train_step at B = 128, 2 warm-up then
               5 timed steps whose launches alone are counted (H1–H4, H6,
               the glue and H7, once a step, must launch), the busy share,
               the pinned H2D rate;
               (c) 48 PNG pairs of 600² on disk → the native u8 loader
               alone at 1, 2 and 4 threads, then → prefetcher → H7 →
               trainer at B = 16; skipped with g++'s error on one line
               where the native loader cannot build;
  3f.        — the Bayesian U-Net's MC request at the MC cell's sizes
               (1024², B = 2 tiles, S = 8 samples): the fan-out (bit for
               bit), H1's MC head and the moments against their plain
               versions, each timed beside its bound (bytes, or the
               published conv9_2 and head's operations); H2 (conv8_1,
               conv9_1) and H8 bf16 (conv6_1, conv7_1) duals with the skip
               batch B under the up batch S·B, bit for bit the same kernel
               on the skip repeated S times and timed against that repeat
               and kernel; three requests through serving.entry(
               mc_samples=8): latency, peak memory, each MC kernel once a
               request, the answers against the plain versions'; its JSON
               line ("mc") follows H9's. ``python3 chip_smoke.py mc`` runs
               phases 1, 2 and 3f alone;
  then the kernels' JSON line and {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

B_PARITY, B_SERVE, HW = 2, 8, 512
B_N64 = 16  # phase 3d's n_kernels 64 train steps
ACT_SCALE = 1 / 16.0  # the inline-quantize sites' act_scale (inverse 16)
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
# training, kernels vs the plain versions (both bf16): the loss and each
# param's grad differ only by bf16 rounding in other orders, through ~20
# layers forward and back; vs the f32 plain U-Net the bf16 activations
# move the grads further (cosine bound only)
TRAIN_LOSS_REL = 1e-2
GRAD_COS, GRAD_REL_L2 = 0.999, 5e-2
REF_GRAD_COS = 0.98
B_TRAIN_PARITY, B_TRAIN_FIT, B_TRAIN = 2, 16, 128
# the data path: 600² staging tiles (the JAX bench's files, bench.py:865),
# the disk phase at the JAX bench's pipeline batch (bench.py:907)
TILE, B_DISK, N_DISK_FILES, DATA_SEED = 600, 16, 48, 3
# the card's published peaks (NVIDIA's data sheet, H100 SXM, dense, 700 W)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "s8": 1979e12, "f32": 67e12}

SOURCES = {k: f"segmentation_tpu_torch/csrc/{k}.cu" for k in (
    "packed_conv2x2", "packed_conv2x2_dual", "strided_conv4x4s2",
    "rows_matmul")}
SOURCES["entry_chain"] = "segmentation_tpu_torch/csrc/entry_chain.cu"
SOURCES["packed_conv2x2_dgrad"] = SOURCES["packed_conv2x2_dgrad_dual"] = \
    "segmentation_tpu_torch/csrc/packed_conv2x2_dgrad.cu"
SOURCES["crop_normalize"] = "segmentation_tpu_torch/csrc/crop_normalize.cu"
# H8: the std levels' int8 conv, which the JAX package leaves to XLA
STD8 = ("std_conv3x3_s8", "std_conv3x3_dual_s8", "std_conv3x3_dual_s8_inline")
_UI8 = "segmentation_tpu/models/unet_int8.py"
for k in STD8:
    SOURCES[k] = "segmentation_tpu_torch/csrc/std_conv3x3_s8.cu"
_CF, _CONV = ("segmentation_tpu/nn/pallas/conv_flat.py",
              "segmentation_tpu/nn/pallas/conv.py")
# the padded-flat kernels each kernel replaces, then the 4-D kernels of the
# training route and of the int8 4-D route that it closes too
_BF16 = {
    "packed_conv2x2": ((f"{_CF}:275", f"{_CF}:1162"),
                       (f"{_CONV}:372", f"{_CONV}:467")),
    "packed_conv2x2_dual": ((f"{_CF}:503", f"{_CF}:1379"), (f"{_CONV}:677",)),
    "strided_conv4x4s2": ((f"{_CF}:667", f"{_CF}:1738"), (f"{_CONV}:844",)),
    "rows_matmul": ((f"{_CF}:785", f"{_CF}:896"),
                    (f"{_CONV}:974", f"{_CONV}:1078")),
}
REPLACES = {k: ", ".join(flat + conv) for k, (flat, conv) in _BF16.items()}
# the int8 modes (conv_int8.NAMES): the same kernels' int8 modes
_S8 = {"packed_conv2x2_s8": ("packed_conv2x2", (f"{_CF}:275", f"{_CF}:1162",
                                                f"{_CONV}:372")),
       "packed_conv2x2_s8_pool": ("packed_conv2x2",
                                  (f"{_CF}:275", f"{_CF}:1162",
                                   f"{_CONV}:467")),
       "packed_conv2x2_dual_s8": ("packed_conv2x2_dual",
                                  (f"{_CF}:503", f"{_CF}:1379",
                                   f"{_CONV}:677")),
       "strided_conv4x4s2_s8": ("strided_conv4x4s2",
                                (f"{_CF}:667", f"{_CONV}:844")),
       "rows_matmul_s8": ("rows_matmul", (f"{_CF}:785", f"{_CF}:896",
                                          f"{_CONV}:974", f"{_CONV}:1078"))}
_S8["packed_conv2x2_s8_inline"] = (
    "packed_conv2x2", _S8["packed_conv2x2_s8"][1] + (f"{_CONV}:467",))
for k in ("packed_conv2x2_dual_s8", "strided_conv4x4s2_s8", "rows_matmul_s8"):
    _S8[f"{k}_inline"] = _S8[k]
_S8["conv3entry_requant"] = _S8["conv3entry_s8"] = ("strided_conv4x4s2",
                                                    (f"{_CF}:1738",))
for k, (src, lines) in _S8.items():
    SOURCES[k], REPLACES[k] = SOURCES[src], ", ".join(lines)
REPLACES["entry_chain"] = f"{_CF}:1644"
REPLACES["packed_conv2x2_dgrad"] = \
    "segmentation_tpu/nn/pallas/conv_flat_bwd.py:119"
REPLACES["packed_conv2x2_dgrad_dual"] = \
    "segmentation_tpu/nn/pallas/conv_flat_bwd.py:217"
REPLACES["crop_normalize"] = "segmentation_tpu/nn/pallas/augment.py:65"
# the train route's glue and H1's train pool mode (train_glue.cu; the JAX
# package leaves the glue to XLA around its custom-VJP wrappers)
_TR, _UF = ("segmentation_tpu/nn/pallas/train.py",
            "segmentation_tpu/models/unet_fast.py")
SOURCES["packed_conv2x2_pool_index"] = SOURCES["packed_conv2x2"]
REPLACES["packed_conv2x2_pool_index"] = (
    f"{_CONV}:372 conv2x2_flat + {_UF}:526 pool4_select (its forward)")
for k in ("relu_bias_grad", "relu_bias_grad_pool", "crop_margin_zero"):
    SOURCES[k] = "segmentation_tpu_torch/csrc/train_glue.cu"
REPLACES["relu_bias_grad"] = (
    f"{_TR}:116 _mask + :122 _db (in the wrappers :155,191,226,259,300)")
REPLACES["relu_bias_grad_pool"] = (
    f"{_TR}:116 _mask + :122 _db + {_UF}:559 _pool4_bwd (XLA)")
REPLACES["crop_margin_zero"] = (
    f"{_UF}:618 packed_center_crop_flat's VJP (:665; XLA)")
# kernels that write in place (the parity runs each on its own copy)
IN_PLACE = ("crop_margin_zero",)
REPLACES["std_conv3x3_s8"] = f"{_UI8}:72 int8_conv (XLA)"
# H8's bf16 mode: the std levels' convs of the bf16 forward (XLA in JAX)
for k in ("std_conv3x3", "std_conv3x3_dual"):
    SOURCES[k] = "segmentation_tpu_torch/csrc/std_conv3x3_bf16.cu"
REPLACES["std_conv3x3"] = f"{_UF}:1045 _std_conv (XLA)"
REPLACES["std_conv3x3_dual"] = f"{_UF}:1050 _std_dual_conv (XLA)"
# the MC-dropout forward's kernels (the JAX package runs them as XLA ops)
SOURCES["mc_fanout"] = SOURCES["mc_moments"] = \
    "segmentation_tpu_torch/csrc/mc_dropout.cu"
SOURCES["packed_conv2x2_mc_head"] = SOURCES["packed_conv2x2"]
REPLACES["mc_fanout"] = f"{_UF}:803 _mc_drop at :1568 (XLA), batch-tiled"
REPLACES["packed_conv2x2_mc_head"] = (
    f"{_CONV}:372 conv2x2_flat + {_UF}:1624 _mc_drop + the head (XLA)")
REPLACES["mc_moments"] = (
    "segmentation_tpu/models/base.py:788 mean, var, argmax (XLA)")
# phase 3f: the Bayesian U-Net's MC request (bench_h100's
# unet1024_mc8_bf16.serve_mc8_b2): B tiles of MC_HW², S samples
MC_HW, MC_B, MC_S, MC_SEED = 1024, 2, 8, 2**33 + 2**31 + 12345
B_BATCH = 64  # the batch cell's request (bench_h100 serve_b64)
# the std levels' ten 3×3 sites of a 512² forward at n_kernels = 32:
# (label, input H = W (the dual's up), C, O, the dual's skip H or None)
STD_SITES = (("conv3_1", 125, 64, 128, None), ("conv3_2", 123, 128, 128, None),
             ("conv4_1", 60, 128, 256, None), ("conv4_2", 58, 256, 256, None),
             ("conv5_1", 28, 256, 512, None), ("conv5_2", 26, 512, 512, None),
             ("conv6_2", 46, 256, 256, None), ("conv7_2", 86, 128, 128, None),
             ("conv6_1", 48, 256, 256, 56), ("conv7_1", 88, 128, 128, 121))
REPLACES["std_conv3x3_dual_s8"] = REPLACES["std_conv3x3_dual_s8_inline"] = \
    f"{_UI8}:104 int8_std_dual_conv (XLA)"
# each int8 configuration's launches per request (models/unet_int8.py),
# bf16 and int8 kernel modes alike: the flagship padded-flat route, the
# 4-D route and the padded-flat route with bf16 deconvs
# H8 in every int8 configuration: the eight single std convs (conv3_x to
# conv7_2) and the two duals, whose up side is a bf16 deconv's output
_H8_LAUNCHES = {"std_conv3x3_s8": 8, "std_conv3x3_dual_s8_inline": 2}
ROUTE_LAUNCHES = {
    "serve_int8": {"entry_chain": 1, "strided_conv4x4s2_s8": 1,
                   "packed_conv2x2_s8_pool": 1, "rows_matmul_s8": 2,
                   "packed_conv2x2_dual_s8": 2, "packed_conv2x2_s8": 2,
                   **_H8_LAUNCHES},
    "serve_int8_4d": {"strided_conv4x4s2": 1, "rows_matmul": 2,
                      "packed_conv2x2_s8_pool": 2, "strided_conv4x4s2_s8": 1,
                      "packed_conv2x2_dual_s8_inline": 2,
                      "packed_conv2x2_s8": 2, **_H8_LAUNCHES},
    "serve_int8_fdeconv": {"entry_chain": 1, "rows_matmul": 2,
                           "packed_conv2x2_s8_pool": 1,
                           "strided_conv4x4s2_s8": 1,
                           "packed_conv2x2_dual_s8_inline": 2,
                           "packed_conv2x2_s8": 2, **_H8_LAUNCHES},
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


def _wgt(gen, *shape):
    """bf16 weights of unit gain: normal / sqrt(fan-in)."""
    import torch

    k = 1
    for s in shape[:-1]:
        k *= s
    w = torch.randn(shape, generator=gen, device=gen.device) / k**0.5
    return w.to(torch.bfloat16)


def _sites(n, gen):
    """The ten packed sites of one 512² forward (n_kernels = 32), and H1's
    train pool mode at conv1_2 and conv2_2: (kernel, label, args, kwargs)
    with random operands of the path's shapes and dtypes."""
    import torch

    from segmentation_tpu_torch.models.unet_fast import head_diff

    dev = gen.device

    def act(*shape):  # post-ReLU-like activations
        return torch.rand(shape, generator=gen, device=dev).to(torch.bfloat16)

    def wgt(*shape):
        return _wgt(gen, *shape)

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
        ("packed_conv2x2_pool_index", "conv1_2 train pool index",
         (act(n, 255, 255, 128), wgt(2, 2, 128, 128), bias(128)),
         {"pool_index": True}),
        ("packed_conv2x2_pool_index", "conv2_2 train pool index",
         (act(n, 126, 126, 256), wgt(2, 2, 256, 256), bias(256)),
         {"pool_index": True}),
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


def _dgrad_sites(n, gen, o4=256):
    """H6's six sites in one 512² train step (n_kernels = 32; level 2's 4C
    and 4O are ``o4``), as the step
    calls it: a ReLU-masked bf16 cotangent g [n, hg, wg, 4O] (zero on about
    half the elements), the window of its zero-margined buffer [n, hg+1,
    wg+1, 4O] (train_glue.relu_bias_grad's), and the sites' bf16 packed
    weights; the duals store dxa into the crop window of the skip's
    gradient (conv8_1 at (41, 41), conv9_1 at (90, 90))."""
    import torch

    dev = gen.device

    def cot(*shape):
        n_, hg, wg, o4 = shape
        buf = torch.zeros((n_, hg + 1, wg + 1, o4), device=dev,
                          dtype=torch.bfloat16)
        g = torch.randn(shape, generator=gen, device=dev)
        keep = torch.rand(shape, generator=gen, device=dev) > 0.5
        buf[:, :hg, :wg] = (g * keep).to(torch.bfloat16)
        return buf[:, :hg, :wg]

    def w(c4, o4):
        return _wgt(gen, 2, 2, c4, o4)

    single, dual = "packed_conv2x2_dgrad", "packed_conv2x2_dgrad_dual"
    return [
        (single, "conv1_2", (cot(n, 254, 254, 128), w(128, 128)), {}),
        (single, "conv2_2", (cot(n, 125, 125, o4), w(o4, o4)), {}),
        (dual, "conv8_1 into the skip's crop (41,41)",
         (cot(n, 83, 83, o4), w(o4, o4), w(o4, o4)),
         {"skip_shape": (n, 125, 125, o4), "offset": (41, 41)}),
        (single, "conv8_2", (cot(n, 82, 82, o4), w(o4, o4)), {}),
        (dual, "conv9_1 into the skip's crop (90,90)",
         (cot(n, 163, 163, 128), w(128, 128), w(128, 128)),
         {"skip_shape": (n, 254, 254, 128), "offset": (90, 90)}),
        (single, "conv9_2", (cot(n, 162, 162, 128), w(128, 128)), {}),
    ]


def _glue_sites(n, gen, o4=256):
    """The glue kernels at the ten packed sites of one 512² train step
    (n_kernels = 32; level 2's 4O is ``o4``): relu_bias_grad on a cotangent g and a post-ReLU
    output y (zero on about half the elements) of each site's shape, in
    the site's mode (the level sites with the pool's gradient and index,
    the 2×2 sites into the zero-margined buffer); crop_margin_zero on the
    duals' skip gradients; then relu_bias_grad unpadded at the ten std
    sites' outputs [n, h, w, O] (std_conv3x3_t's backward), their widths
    scaled as level 2's (``o4`` / 256)."""
    import torch

    dev = gen.device

    def bf(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def gy(*shape):
        return bf(*shape), torch.relu(bf(*shape))

    def pool(n_, h, w, o4):
        idx = torch.randint(0, 4, (n_, h, w, o4 // 4), generator=gen,
                            device=dev, dtype=torch.int8)
        return bf(n_, h, w, o4 // 4), idx

    rbg, rbgp = "relu_bias_grad", "relu_bias_grad_pool"
    pad = {"pad": True}
    return [
        (rbg, "conv1_1", gy(n, 255, 255, 128), {}),
        (rbgp, "conv1_2", gy(n, 254, 254, 128),
         {"pool": pool(n, 254, 254, 128), **pad}),
        (rbg, "conv2_1", gy(n, 126, 126, o4), {}),
        (rbgp, "conv2_2", gy(n, 125, 125, o4),
         {"pool": pool(n, 125, 125, o4), **pad}),
        (rbg, "upconv3", gy(n, 84, 84, o4), {}),
        (rbg, "conv8_1", gy(n, 83, 83, o4), pad),
        (rbg, "conv8_2", gy(n, 82, 82, o4), pad),
        (rbg, "upconv4", gy(n, 164, 164, 128), {}),
        (rbg, "conv9_1", gy(n, 163, 163, 128), pad),
        (rbg, "conv9_2", gy(n, 162, 162, 128), pad),
        ("crop_margin_zero", "conv8_1's skip (41,41)",
         (bf(n, 125, 125, o4), 84, 84, (41, 41)), {}),
        ("crop_margin_zero", "conv9_1's skip (90,90)",
         (bf(n, 254, 254, 128), 164, 164, (90, 90)), {}),
    ] + [(rbg, label, gy(n, h - 2, h - 2, o * o4 // 256), {})
         for label, h, _, o, _ in STD_SITES]


def _sites_n64(n, gen):
    """Level 2's 4O = 512 sites of one 512² forward at n_kernels = 64 (the
    paper's widths; two column tiles of 256 a pixel tile): H3 boxed
    (conv2_1), H1 with the pool and the train pool index (conv2_2) and
    plain (conv8_2), H4's identity (upconv3), H2 with the skip's per-slot
    boxes at the odd phase (conv8_1)."""
    import torch

    dev = gen.device

    def act(*shape):
        return torch.rand(shape, generator=gen, device=dev).to(torch.bfloat16)

    def bias(o4):
        return torch.randn((o4,), generator=gen, device=dev) * 0.1

    return [
        ("strided_conv4x4s2", "conv2_1 C=64", (act(n, 254, 254, 64),
                                               _wgt(gen, 4, 4, 64, 512),
                                               bias(512)), {}),
        ("packed_conv2x2", "conv2_2 +pool", (act(n, 126, 126, 512),
                                             _wgt(gen, 2, 2, 512, 512),
                                             bias(512)), {"pool": True}),
        ("packed_conv2x2_pool_index", "conv2_2 train pool index",
         (act(n, 126, 126, 512), _wgt(gen, 2, 2, 512, 512), bias(512)),
         {"pool_index": True}),
        ("rows_matmul", "upconv3 identity", (act(n, 84, 84, 256),
                                             _wgt(gen, 256, 512), bias(512)),
         {"scatter": False}),
        ("packed_conv2x2_dual", "conv8_1 odd phase (41,41)",
         (act(n, 125, 125, 512), act(n, 84, 84, 512),
          _wgt(gen, 2, 2, 512, 512), _wgt(gen, 2, 2, 512, 512), bias(512)),
         {"offset": (41, 41)}),
        ("packed_conv2x2", "conv8_2", (act(n, 83, 83, 512),
                                       _wgt(gen, 2, 2, 512, 512), bias(512)),
         {}),
    ]


def _dgrad_sites_n64(n, gen):
    """H6's three 4C = 512 sites of a 512² train step at n_kernels = 64, as
    _dgrad_sites makes them (conv8_1 into the skip's crop (41, 41))."""
    sites = _dgrad_sites(n, gen, o4=512)
    return [sites[i] for i in (1, 2, 3)]  # conv2_2, conv8_1, conv8_2


def _glue_sites_n64(n, gen):
    """The glue at level 2's six sites of a 512² train step at n_kernels =
    64 (512 channels) and at the ten std sites (O 256 to 1024), as
    _glue_sites makes them."""
    sites = _glue_sites(n, gen, o4=512)
    return [sites[i] for i in (2, 3, 4, 5, 6, 10)] + sites[12:]


def _sites8(n, gen):
    """The int8 paths' kernel sites of one 512² forward, every mode:
    resident s8 activations (post-ReLU codes) or, for the inline-quantize
    modes, bf16 activations whose codes at ACT_SCALE reach past 127; s8
    weights (with the K-major copies that s8 wgmma reads, made once as the
    model's plan makes them: H1's, H2's, H4's, H5's and H8's ``k_major``,
    H3's ``strided_k_major``), and epilogue vectors that spread the
    requantized outputs over the code range. H8's path modes are timed on
    a request's own operands (_std_conv_phase); its dual on two s8 sides,
    which no route runs, at conv7_1's shape here."""
    import torch

    from segmentation_tpu_torch.models.unet_fast import head_diff
    from segmentation_tpu_torch.nn.kernels.conv_int8 import (
        k_major,
        strided_k_major,
    )

    dev = gen.device

    def codes(*shape):
        return torch.randint(0, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def acts(*shape):  # bf16, codes 0..150 at ACT_SCALE
        return (torch.rand(shape, generator=gen, device=dev)
                * (150 * ACT_SCALE)).to(torch.bfloat16)

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

    def h1(args, kw):  # H1's int8 site: the K-major copy beside wq
        return args, {**kw, "wk": k_major(args[1])}

    def h2(args, kw):  # H2's: the copies of wqa, wqb
        return args, {**kw, "wka": k_major(args[2]),
                      "wkb": k_major(args[3])}

    def h3(args, kw):  # H3's int8 modes: the copy of wq4
        return args, {**kw, "wk4": strided_k_major(args[1])}

    def h5(args, kw):  # H5: conv1_2's copy
        return args, {**kw, "wk": k_major(args[4])}

    def h4(args, kw):  # H4's int8 modes: the copy of wqm
        return args, {**kw, "wkm": k_major(args[1])}

    def h8(args, kw):  # H8's dual: the copies of wqa, wqb
        return args, {**kw, "wka": k_major(args[2]),
                      "wkb": k_major(args[3])}

    x = torch.rand((n, 512, 512, 3), generator=gen, device=dev)
    w4 = torch.randn((4, 4, 3, 128), generator=gen, device=dev) / 48**0.5
    mul1 = torch.full((128,), 100.0, device=dev)  # conv1_1 acc std ~ 0.6
    add1 = torch.randn((128,), generator=gen, device=dev) * 10
    wd, bd = head_diff(torch.randn((1, 1, 32, 2), generator=gen, device=dev)
                       / 32**0.5, torch.randn((2,), generator=gen, device=dev))
    head = (wd.to(torch.bfloat16), bd)
    inline = {"act_scale": ACT_SCALE}
    sites = [
        ("entry_chain", "level 1 conv1_1+conv1_2+pool",
         (x.to(torch.bfloat16), w4.to(torch.bfloat16), mul1, add1,
          wq(2, 2, 128, 128), *vecs(128, 512)), {}),
        ("conv3entry_requant", "conv1_1 bf16 -> s8 (requant-only)",
         (x.to(torch.bfloat16), w4.to(torch.bfloat16), mul1, add1), {}),
        ("conv3entry_s8", "conv1_1 s8 image codes (s8-input)",
         (codes(n, 512, 512, 3), wq(4, 4, 3, 128), *vecs(128, 27)), {}),
        ("packed_conv2x2_s8_pool", "conv1_2 +pool (4-D route)",
         (codes(n, 255, 255, 128), wq(2, 2, 128, 128), *vecs(128, 512)),
         {"pool": True}),
        ("strided_conv4x4s2_s8", "conv2_1 C=32",
         (codes(n, 254, 254, 32), wq(4, 4, 32, 256), *vecs(256, 512)), {}),
        ("strided_conv4x4s2_s8_inline", "conv2_1 C=32 bf16 in",
         (acts(n, 254, 254, 32), wq(4, 4, 32, 256), *vecs(256, 512)),
         inline),
        ("packed_conv2x2_s8_pool", "conv2_2 +pool",
         (codes(n, 126, 126, 256), wq(2, 2, 256, 256), *vecs(256, 1024)),
         {"pool": True}),
        ("packed_conv2x2_s8_inline", "conv2_2 bf16 in",
         (acts(n, 126, 126, 256), wq(2, 2, 256, 256), *vecs(256, 1024)),
         inline),
        ("packed_conv2x2_s8_inline", "conv2_2 bf16 in +pool",
         (acts(n, 126, 126, 256), wq(2, 2, 256, 256), *vecs(256, 1024)),
         {"pool": True, **inline}),
        ("rows_matmul_s8", "upconv3 identity",
         (codes(n, 84, 84, 128), wq(128, 256), *vecs(256, 128)),
         {"scatter": False}),
        ("rows_matmul_s8_inline", "upconv3 identity bf16 in",
         (acts(n, 84, 84, 128), wq(128, 256), *vecs(256, 128)),
         {"scatter": False, **inline}),
        ("packed_conv2x2_dual_s8", "conv8_1 odd phase (41,41)",
         (codes(n, 125, 125, 256), codes(n, 84, 84, 256), *dual(256, 256)),
         {"offset": (41, 41)}),
        ("packed_conv2x2_dual_s8_inline", "conv8_1 odd phase (41,41) bf16 up",
         (codes(n, 125, 125, 256), acts(n, 84, 84, 256), *dual(256, 256)),
         {"offset": (41, 41), "act_scale_b": ACT_SCALE}),
        ("packed_conv2x2_s8", "conv8_2",
         (codes(n, 83, 83, 256), wq(2, 2, 256, 256), *vecs(256, 1024)), {}),
        ("rows_matmul_s8", "upconv4 scatter",
         (codes(n, 82, 82, 256), wq(64, 128), *vecs(128, 64)),
         {"scatter": True}),
        ("rows_matmul_s8_inline", "upconv4 scatter bf16 in",
         (acts(n, 82, 82, 256), wq(64, 128), *vecs(128, 64)),
         {"scatter": True, **inline}),
        ("packed_conv2x2_dual_s8", "conv9_1 even (90,90)",
         (codes(n, 254, 254, 128), codes(n, 164, 164, 128),
          *dual(128, 128)), {"offset": (90, 90)}),
        ("packed_conv2x2_dual_s8_inline", "conv9_1 even (90,90) bf16 up",
         (codes(n, 254, 254, 128), acts(n, 164, 164, 128),
          *dual(128, 128)), {"offset": (90, 90), "act_scale_b": ACT_SCALE}),
        ("packed_conv2x2_s8", "conv9_2 head_only (bf16 value)",
         (codes(n, 163, 163, 128), wq(2, 2, 128, 128),
          *vecs(128, 512, 1 / 20)),
         {"requant": False, "head": head, "head_only": True}),
        ("std_conv3x3_dual_s8", "conv7_1 (16,16) s8 up",
         (codes(n, 121, 121, 128), codes(n, 88, 88, 128),
          wq(3, 3, 128, 128), wq(3, 3, 128, 128), vecs(128, 2304)[0],
          *vecs(128, 2304)), {"offset": (16, 16), "out_scale": 1.0}),
    ]

    def copies(name):
        if name.startswith("packed_conv2x2_dual"):
            return h2
        if name.startswith("packed_conv2x2"):
            return h1
        if name.startswith("strided") or name == "conv3entry_s8":
            return h3
        if name.startswith("rows_matmul_s8"):
            return h4
        if name.startswith("std_conv3x3_dual"):
            return h8
        return h5 if name == "entry_chain" else lambda a, k: (a, k)

    return [(name, label, *copies(name)(args, kw))
            for name, label, args, kw in sites]


def _entry_modes_agree(n, gen):
    """H5 against its two-kernel form on the card: H1's pool mode on the
    requant-only entry's codes (the same requant point). Returns whether
    both outputs are equal code for code; fails beyond one code."""
    import torch

    from segmentation_tpu_torch.nn.kernels import conv_int8 as ci

    site = _sites8(n, gen)[0]
    x, w4, mul1, add1, wq2, mul2, add2 = site[2]
    codes = ci.conv3entry_requant(x, w4, mul1, add1)
    two = ci.packed_conv2x2_s8(codes, wq2, mul2, add2, pool=True, **site[3])
    one = ci.entry_chain(x, w4, mul1, add1, wq2, mul2, add2, **site[3])
    torch.cuda.synchronize()
    for g, w, what in zip(two, one, ("y", "pooled")):
        _parity(f"N={n} entry_chain vs conv3entry_requant + H1 pool "
                f"({what})", g, w)
    return all(torch.equal(g, w) for g, w in zip(two, one))


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


def _bytes(*ts) -> int:
    import torch

    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _bound_ms(nbytes, ops):
    """(the least time the card could take, ms; the resource that binds):
    the larger of the bytes over the HBM rate and the operations of each
    type over that type's peak."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = sum(v / PEAK_OPS_S[k] for k, v in ops.items()) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _site_work(name, args, kw, outs):
    """(bytes, {type: operations}) of one launch at a site: each input read
    once (the dual's skip: only the window it reads, of up's shape), each
    output written once, and the operations of the function itself, not
    of its packed form (whose 2×2 taps over 4C hold the 3×3 conv's zero
    taps too): 2·9·C·O per unpacked output pixel of a 3×3 conv C → O (the
    dual: 2C inputs; the dgrads: per output pixel of the forward conv, for
    each weight), 2·C·4O per input pixel of the 2×2/2 deconv, 2·O per
    pixel of the nc=2 head (the two logits' difference); H5 its two
    convs, conv1_1 in bf16 and conv1_2 in s8."""
    if name.startswith(("relu_bias_grad", "crop_margin_zero")):
        return _glue_work(name, args, kw, outs)
    base = re.sub(r"(_s8)?(_pool_index|_pool|_inline)?$", "", name)
    if name.startswith("conv3entry"):
        base = "strided_conv4x4s2"
    kind = "s8" if "_s8" in name or name == "conv3entry_s8" else "bf16"
    nbytes = _bytes(*args, *kw.get("head", ()), *outs)

    def conv3x3(pixels, c, o):
        return 2 * pixels * 9 * c * o

    if base in ("packed_conv2x2_dual", "std_conv3x3_dual"):
        skip, up = args[:2]
        nbytes -= (skip.numel() - up.numel()) * skip.element_size()
    if name == "entry_chain":
        x, w4, wq2 = args[0], args[1], args[4]
        n, h, w, c = x.shape
        ho, wo = (h - 2) // 2, (w - 2) // 2
        return nbytes, {
            "bf16": conv3x3(4 * n * ho * wo, c, w4.shape[-1] // 4),
            "s8": conv3x3(4 * n * (ho - 1) * (wo - 1), wq2.shape[2] // 4,
                          wq2.shape[3] // 4)}
    if base == "packed_conv2x2":
        x, w2 = args[:2]
        n, hp, wp, c4 = x.shape
        px, o = 4 * n * (hp - 1) * (wp - 1), w2.shape[-1] // 4
        ops = conv3x3(px, c4 // 4, o) + (2 * px * o if "head" in kw else 0)
    elif base == "packed_conv2x2_dual":
        up, wa = args[1], args[2]
        n, hp, wp, c4 = up.shape
        ops = conv3x3(4 * n * (hp - 1) * (wp - 1), 2 * (c4 // 4),
                      wa.shape[-1] // 4)
    elif base == "strided_conv4x4s2":
        x, w4 = args[:2]
        n, h, w, c = x.shape
        ops = conv3x3(4 * n * ((h - 2) // 2) * ((w - 2) // 2), c,
                      w4.shape[-1] // 4)
    elif base == "rows_matmul":
        x, wm = args[:2]
        ops = 2 * (x.numel() // wm.shape[0]) * wm.shape[0] * wm.shape[1]
    elif base.startswith("std_conv3x3"):  # H8: the single, or both sides
        x, w = (args[1], args[2]) if base.endswith("dual") else args[:2]
        n, h, wd, c = x.shape
        ops = conv3x3(n * (h - 2) * (wd - 2), c, w.shape[-1]) * (
            2 if base.endswith("dual") else 1)
    else:  # the dgrads: g [n, hg, wg, 4O] against one or two weights
        g, *ws = args
        n, hg, wg, o4 = g.shape
        if kw.get("skip_shape"):  # the kernel writes the crop window only
            nbytes -= (outs[0].numel() - n * (hg + 1) * (wg + 1)
                       * ws[0].shape[2]) * outs[0].element_size()
        ops = conv3x3(4 * n * hg * wg, ws[0].shape[2] // 4, o4 // 4) * len(ws)
    return nbytes, {kind: ops}


def _glue_work(name, args, kw, outs):
    """(bytes, {type: operations}) of a glue launch: relu_bias_grad reads g,
    y (and the pool's gradient and index) once and writes its buffer,
    margin included, about one f32 add an element (two with the pool);
    crop_margin_zero writes the margin alone."""
    if name == "crop_margin_zero":
        buf, hp, wp, _ = args
        n, _, _, c4 = buf.shape
        return (buf.numel() - n * hp * wp * c4) * buf.element_size(), {}
    g, y = args
    ins = (g, y, *kw.get("pool", ()))
    return _bytes(*ins, *outs), {
        "f32": y.numel() * (2 if "pool" in kw else 1)}


def _library_call(name, args, kw):
    """The one PyTorch call that computes a bf16 site's function on the
    unpacked tensors, NCHW channels_last: F.conv2d 3×3 for H1–H3 (the
    dual's cropped skip and up concatenated along channels),
    F.conv_transpose2d 2×2/2 for H4 and the 3×3 conv's input grad for H6,
    with random weights of the unpacked shapes (values do not change a
    conv's time); H4 int8's and H8's integer product by torch._int_mm
    (_int_mm_call). None where PyTorch has none (the other int8 modes,
    H5)."""
    import torch
    import torch.nn.functional as F

    from segmentation_tpu_torch.nn.packing import crop_packed, unpack2

    if name.startswith(("rows_matmul_s8", "std_conv3x3")):
        return _int_mm_call(name, args, kw)
    if name not in _BF16 and not name.startswith("packed_conv2x2_dgrad"):
        return None  # the other int8 modes, H5
    cl, dev = torch.channels_last, args[0].device

    def nchw(x):
        return x.permute(0, 3, 1, 2).contiguous(memory_format=cl)

    def unpacked(xp):
        n, hp, wp, c4 = xp.shape
        return nchw(unpack2(xp.reshape(n, hp, wp, 4, c4 // 4)))

    def weight(*shape):
        w = torch.randn(shape, device=dev) / (shape[1] * 9) ** 0.5
        return w.to(torch.bfloat16).contiguous(memory_format=cl)

    def bias(o):
        return torch.zeros((o,), device=dev, dtype=torch.bfloat16)

    if name == "packed_conv2x2":
        x, w2 = args[:2]
        xu, w, b = unpacked(x), weight(w2.shape[-1] // 4, x.shape[-1] // 4,
                                       3, 3), bias(w2.shape[-1] // 4)
        return lambda: F.conv2d(xu, w, b)
    if name == "packed_conv2x2_dual":
        skip, up, wa = args[:3]
        sk = crop_packed(skip, up.shape, kw["offset"]).contiguous()
        xu = torch.cat([unpacked(sk), unpacked(up)], 1).contiguous(
            memory_format=cl)
        w, b = weight(wa.shape[-1] // 4, xu.shape[1], 3, 3), bias(
            wa.shape[-1] // 4)
        return lambda: F.conv2d(xu, w, b)
    if name == "strided_conv4x4s2":
        x, w4 = args[:2]
        xu, w, b = nchw(x), weight(w4.shape[-1] // 4, x.shape[-1], 3, 3), \
            bias(w4.shape[-1] // 4)
        return lambda: F.conv2d(xu, w, b)
    if name == "rows_matmul":
        x, wm = args[:2]
        xu = unpacked(x) if kw.get("scatter") else nchw(x)
        w, b = weight(wm.shape[0], wm.shape[1] // 4, 2, 2), bias(
            wm.shape[1] // 4)
        return lambda: F.conv_transpose2d(xu, w, b, stride=2)
    g, *ws = args  # the dgrads: dx of the 3×3 conv C → O, both halves
    gu = unpacked(g)
    w = weight(g.shape[-1] // 4, ws[0].shape[2] // 4 * len(ws), 3, 3)
    return lambda: F.conv_transpose2d(gu, w)


def _int_mm_call(name, args, kw):
    """The library column of H4's and H8's int8 modes: torch._int_mm (s32
    out) of the same integer product on the same codes, H8's on the
    im2col matrix of its input (the dual: both sides' GEMMs); a bf16
    operand quantized first, outside the call."""
    import torch

    from segmentation_tpu_torch.nn.kernels import conv_int8 as ci

    def codes(x, act, div):
        if act is None:
            return x
        return ci.quant_act(x, act) if div else ci.quant_inline(x, act)

    def im2col(x):
        n, h, w, c = x.shape
        cols = x.unfold(1, 3, 1).unfold(2, 3, 1)  # [N, H-2, W-2, C, 3, 3]
        return cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, 9 * c).contiguous()

    if name.startswith("rows_matmul_s8"):
        x, wqm = args[:2]
        a = codes(x, kw.get("act_scale"), False).reshape(-1, wqm.shape[0])
        return lambda: torch._int_mm(a, wqm)
    if name == "std_conv3x3_s8":
        x, wq = args[:2]
        a, b = im2col(x), wq.reshape(-1, wq.shape[-1])
        return lambda: torch._int_mm(a, b)
    sk, up, wqa, wqb = args[:4]
    oh, ow = kw.get("offset", (0, 0))
    crop = sk[:, oh:oh + up.shape[1], ow:ow + up.shape[2]]
    aa = im2col(codes(crop, kw.get("act_scale_a"), True))
    ab = im2col(codes(up, kw.get("act_scale_b"), True))
    ba, bb = wqa.reshape(-1, wqa.shape[-1]), wqb.reshape(-1, wqb.shape[-1])
    return lambda: (torch._int_mm(aa, ba), torch._int_mm(ab, bb))


def _packed_gemm_ops(name, args):
    """The packed GEMM of a kernel on the Hopper mainloop at a site, by
    tensor type ({"bf16" or "s8": operations}): 2 · output pixels · K ·
    columns, 16/9 of the function's operations. H1 (every mode): K = 4
    taps × 4C, 4O columns; H2: the same for each side; H3 (every mode): K =
    16C (four taps × two row parities × 2C, or one im2col row), 4O
    columns; H4: K = C, 4O columns per output pixel (no zero taps); H5:
    conv1_1 in bf16 (K = 48, 128 columns) over every halo row its tiles
    compute, recompute included, and conv1_2 in s8 (K = 4 · 128); H6: K = 4
    taps × 4O, 4C columns (8C for the dual) per dx pixel."""
    from segmentation_tpu_torch.nn.kernels.tiles import entry_tile_plan

    kind = _peak_kind(name)
    if name.startswith("packed_conv2x2_dgrad"):
        g, *ws = args
        n, hg, wg, o4 = g.shape
        return {kind: 2 * n * (hg + 1) * (wg + 1) * 4 * o4 * ws[0].shape[2]
                * len(ws)}
    if name == "entry_chain":
        n, h, w, _ = args[0].shape
        plan = entry_tile_plan(n, (h - 2) // 2 - 1, (w - 2) // 2 - 1)
        rows = plan.count * (plan.th + 1) * (plan.tw + 1)
        return {"bf16": 2 * rows * 48 * 128,
                "s8": 2 * n * plan.hx * plan.wx * 4 * 128 * 128}
    if name.startswith(("strided_conv4x4s2", "conv3entry")):
        x, w4 = args[:2]
        n, h, w, c = x.shape
        return {kind: 2 * n * ((h - 2) // 2) * ((w - 2) // 2) * 16 * c
                * w4.shape[-1]}
    if name.startswith("rows_matmul"):
        x, wm = args[:2]
        return {kind: 2 * (x.numel() // wm.shape[0]) * wm.shape[0]
                * wm.shape[1]}
    if name.startswith("std_conv3x3"):  # H8 has no packed form
        return {kind: _site_work(name, args, {}, ())[1][kind]}
    dual = name.startswith("packed_conv2x2_dual")
    x, w = args[1 if dual else 0], args[3 if dual else 1]
    n, hp, wp, c4 = x.shape
    return {kind: 2 * n * (hp - 1) * (wp - 1) * 4 * c4 * w.shape[-1]
            * (1 + dual)}


def _peak_ms(ops):
    """The time of packed GEMM operations {type: ops} at the tensor peaks,
    ms."""
    return sum(v / PEAK_OPS_S[k] for k, v in ops.items()) * 1e3


def _tile_plan_of(name, args, kw):
    """The tile plan the wrapper of a Hopper-mainloop kernel picks."""
    from segmentation_tpu_torch.nn.kernels import conv_bwd as cb
    from segmentation_tpu_torch.nn.kernels import conv_flat as cf
    from segmentation_tpu_torch.nn.kernels import conv_int8 as ci
    from segmentation_tpu_torch.nn.kernels.tiles import (
        entry_tile_plan,
        std_plan,
        tile_plan,
    )

    if name.startswith("packed_conv2x2_dgrad"):
        g, *ws = args
        n, hg, wg, _ = g.shape
        return tile_plan(n, hg + 1, wg + 1,
                         cb.tile_rows(ws[0].shape[2], len(ws) == 2))
    if name == "strided_conv4x4s2":
        return cf.strided_plan(args[0], args[1].shape[-1])
    if name.startswith(("strided_conv4x4s2_s8", "conv3entry")):
        return ci.strided_s8_plan(args[0])
    if name == "entry_chain":
        n, h, w, _ = args[0].shape
        return entry_tile_plan(n, (h - 2) // 2 - 1, (w - 2) // 2 - 1)
    if name == "rows_matmul":
        return cf.rows_plan(args[0], args[1].shape[-1], kw.get("scatter"))
    if name.startswith("rows_matmul_s8"):
        n, h, w, _ = args[0].shape
        s = 2 if kw.get("scatter") else 1
        return ci.rows_s8_plan(n, s * h, s * w)
    if name.startswith("std_conv3x3"):
        dual = "dual" in name
        x, w = (args[1], args[2]) if dual else args[:2]
        n, h, wd, _ = x.shape
        # one accumulator, but the s8 dual's one a side
        acc = 2 if dual and name not in STD_BF16 else 1
        return std_plan(n, h - 2, wd - 2, w.shape[-1], acc)
    if name.startswith("packed_conv2x2_dual_s8"):
        up, wqa = args[1], args[2]
        n, hp, wp, _ = up.shape
        return tile_plan(n, hp - 1, wp - 1,
                         ci.dual_tile_rows(wqa.shape[-1]))
    x = args[1] if name.startswith("packed_conv2x2_dual") else args[0]
    n, hp, wp, _ = x.shape
    return tile_plan(n, hp - 1, wp - 1, cf.FWD_TILE_ROWS)


# the kernels on csrc/sm90_igemm.cuh (TMA or gathered A, wgmma): every
# mode of H1–H6 and H8
SM90_S8 = ("packed_conv2x2_s8", "packed_conv2x2_s8_pool",
           "packed_conv2x2_s8_inline", "packed_conv2x2_dual_s8",
           "packed_conv2x2_dual_s8_inline", "strided_conv4x4s2_s8",
           "strided_conv4x4s2_s8_inline", "conv3entry_s8", "rows_matmul_s8",
           "rows_matmul_s8_inline") + STD8
STD_BF16 = ("std_conv3x3", "std_conv3x3_dual")
SM90 = ("packed_conv2x2", "packed_conv2x2_pool_index",
        "packed_conv2x2_dual", "strided_conv4x4s2",
        "rows_matmul", "packed_conv2x2_dgrad", "packed_conv2x2_dgrad_dual",
        "conv3entry_requant", "entry_chain") + SM90_S8 + STD_BF16


def _peak_kind(name):
    """The tensor peak a Hopper-mainloop kernel's packed GEMM runs at (H5:
    both, see _packed_gemm_ops)."""
    return "s8" if name in SM90_S8 else "bf16"


def _peak_words(ops, ms):
    """'S of the packed <types> tensor peak(s)' for packed ops at ms."""
    kinds = " + ".join(sorted(ops))
    return (f"{_peak_ms(ops) / ms:.3f} of the packed {kinds} tensor "
            f"peak{'s' if len(ops) > 1 else ''}")


def _tile_note(name, args, kw, ms, bound):
    """A Hopper-mainloop kernel's extra words on a site's time line: the
    tile the wrapper's plan picked, the share of the bound, the share of
    the packed tensor peak (s8's for the int8 modes; H5: conv1_1's
    operations at the bf16 peak plus conv1_2's at the s8 peak, and the
    recompute share of its halos)."""
    from segmentation_tpu_torch.nn.kernels.tiles import entry_recompute

    plan = _tile_plan_of(name, args, kw)
    note = (f"; tile {plan.th}x{plan.tw}, {bound / ms:.3f} of the bound, "
            f"{_peak_words(_packed_gemm_ops(name, args), ms)}")
    if name == "entry_chain":
        note += f", conv1_1 recompute share {entry_recompute(plan):.4f}"
    return note


def _exact(label, name, kw, got, want):
    """The outputs held bit for bit: the glue kernels' gm buffers (and the
    margin the in-place kernel writes), H1's train pool and index against
    pool_select of its own y; relu_bias_grad's f32 db against the exact
    (f64) sum of gm within its bound (train_glue.db_error_bound: the depth
    of the kernel's three sequential sums · 2^-24 · Σ|gm| per channel), a
    bound that a db of zeros, or of half the pixels, must exceed."""
    import torch

    from segmentation_tpu_torch.nn.kernels.train_glue import db_error_bound

    if name.startswith(("relu_bias_grad", "crop_margin_zero")):
        pairs = [(g, w) for g, w in zip(got, want) if g.dtype != torch.float32]
    elif kw.get("pool_index"):
        pairs = list(zip(got[1:], want[1:]))
    else:
        return
    for g, w in pairs:
        if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
            raise AssertionError(f"{label}: not bit for bit the plain "
                                 f"version's ({tuple(g.shape)} {g.dtype})")
    if name.startswith("relu_bias_grad"):
        exact = want[0].double().sum((0, 1, 2))
        bound = db_error_bound(want[0])
        err = (got[1].double() - exact).abs()
        rows = want[0].double().flatten(0, 2)
        half = rows[: rows.shape[0] // 2].sum(0)
        print(f"[kernels] {label}: gm bit for bit; db max abs err "
              f"{err.max().item():.3e} (its bound: max "
              f"{bound.max().item():.3e}; |db| max "
              f"{exact.abs().max().item():.3e})")
        if (err > bound).any():
            raise AssertionError(f"{label}: db beyond its bound")
        if not ((exact.abs() > bound).any()
                and ((exact - half).abs() > bound).any()):
            raise AssertionError(f"{label}: db's bound would pass a db of "
                                 f"zeros or of half the pixels")
    else:
        print(f"[kernels] {label}: bit for bit the plain version's")


def _kernel_phase(mod, sites):
    """Each kernel of ``mod`` against its plain version at every site of
    the path, N = 2 and B = 8; each site's time at B = 8 beside the plain
    version's, the library call's and its bound. Returns per kernel the
    max abs error and the times summed over the sites (ms): kernel, plain,
    bound, the resource that binds most of the bound, library (None
    without one), and the packed GEMM operations of the kernels on the
    Hopper mainloop (SM90; 0 for the others)."""
    import torch

    from segmentation_tpu_torch.core.rng import generator

    # the wrapper that launches each kernel mode, and its plain version
    fn = {k: getattr(mod, "wrapper_of", lambda m: m)(k) for k in mod.NAMES}
    wrappers = {k: getattr(mod, fn[k]) for k in mod.NAMES}
    plains = {k: getattr(mod, f"{fn[k]}_plain") for k in mod.NAMES}
    worst = dict.fromkeys(mod.NAMES, 0.0)
    ms = dict.fromkeys(mod.NAMES, 0.0)
    plain_ms = dict.fromkeys(mod.NAMES, 0.0)
    bound = dict.fromkeys(mod.NAMES, 0.0)
    bound_parts = {k: {"bytes": 0.0, "operations": 0.0} for k in mod.NAMES}
    library_ms = dict.fromkeys(mod.NAMES)
    packed = {k: {} for k in mod.NAMES}
    from segmentation_tpu_torch.nn.kernels.conv_flat import pool_select

    for n in (B_PARITY, B_SERVE):
        for name, label, args, kw in sites(n, generator(7 + n, "cuda")):
            own = args
            if name in IN_PLACE:  # each on its own copy of the buffer
                own = (args[0].clone(),) + tuple(args[1:])
            got = _outs(wrappers[name](*own, **kw))
            if name in IN_PLACE:
                own = (args[0].clone(),) + tuple(args[1:])
            want = _outs(plains[name](*own, **kw))
            if kw.get("pool_index"):  # the pool and index of the kernel's y
                want = (want[0], *pool_select(got[0]))
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
            _exact(f"N={n} {name} {label}", name, kw, got, want)
            if n != B_SERVE:
                continue
            fns = {"plain": lambda: plains[name](*args, **kw),
                   "kernel": lambda: wrappers[name](*args, **kw)}
            lib = _library_call(name, args, kw)
            if lib is not None:
                fns["library"] = lib
            for f in fns.values():  # warm: cuDNN's first call of a shape
                f()
            t = dict.fromkeys(fns, 0.0)
            for k in list(fns) + list(fns)[::-1]:  # in turns
                t[k] += _time_ms(fns[k]) / 2
            b, by = _bound_ms(*_site_work(name, args, kw, got))
            ms[name] += t["kernel"]
            plain_ms[name] += t["plain"]
            bound[name] += b
            bound_parts[name][by] += b
            lib_txt = "none"
            if lib is not None:
                library_ms[name] = (library_ms[name] or 0.0) + t["library"]
                lib_txt = f"{t['library']:.4f} ms"
            note = ""
            if name in SM90:
                for kind, ops in _packed_gemm_ops(name, args).items():
                    packed[name][kind] = packed[name].get(kind, 0) + ops
                note = _tile_note(name, args, kw, t["kernel"], b)
            print(f"[kernels] time B={n} {name} {label}: "
                  f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
                  f"library {lib_txt}, bound {b:.4f} ms ({by}){note}")
            del fns, lib
    bound_by = {k: max(v, key=v.get) for k, v in bound_parts.items()}
    return worst, ms, plain_ms, bound, bound_by, library_ms, packed


def _std_bf16_sites(n, gen, width=1):
    """H8 bf16's ten sites in one 512² request (STD_SITES; n_kernels = 32,
    C and O times ``width``): (mode, label, args, kwargs), the duals'
    weights the halves of one concat weight, as the forward passes them."""
    import torch

    dev = gen.device

    def act(*shape):
        return torch.rand(shape, generator=gen, device=dev).to(torch.bfloat16)

    def bias(o):
        return torch.randn((o,), generator=gen, device=dev) * 0.1

    sites = []
    for label, h, c, o, hs in STD_SITES:
        c, o = c * width, o * width
        if hs is None:
            sites.append(("std_conv3x3", label, (act(n, h, h, c),
                                                 _wgt(gen, 3, 3, c, o),
                                                 bias(o)), {}))
            continue
        w = _wgt(gen, 3, 3, 2 * c, o)
        off = ((hs - h) // 2, (hs - h) // 2)
        sites.append(("std_conv3x3_dual", f"{label} crop {off}",
                      (act(n, hs, hs, c), act(n, h, h, c), w[:, :, :c],
                       w[:, :, c:], bias(o)), {"offset": off}))
    return sites


def _std_bf16_library(name, args, kw):
    """H8 bf16's two library columns on the site's own NHWC tensors: the
    path the mode replaced (nn/layers.conv2d: cuDNN, then _finish's bias
    and ReLU, the bias in bf16; the dual: both convs on the cropped skip
    and on up, their sum, the bias, ReLU) and the conv alone (the dual's
    two convs)."""
    import torch
    import torch.nn.functional as F

    from segmentation_tpu_torch.nn.layers import conv2d

    def nchw(x):
        return x.permute(0, 3, 1, 2)

    def oihw(w):
        return w.permute(3, 2, 0, 1)

    b16 = args[-1].to(torch.bfloat16)
    if name == "std_conv3x3":
        x, w = args[:2]
        return (lambda: conv2d(x, w, b16),
                lambda: F.conv2d(nchw(x), oihw(w)))
    skip, up, wa, wb = args[:4]
    oh, ow = kw["offset"]
    sk = skip[:, oh:oh + up.shape[1], ow:ow + up.shape[2]]

    def unfused():
        y = conv2d(sk, wa, activation=None) + conv2d(up, wb, activation=None)
        return torch.relu(y + b16)

    return unfused, lambda: (F.conv2d(nchw(sk), oihw(wa)),
                             F.conv2d(nchw(up), oihw(wb)))


def _std_bf16_parity(label, got, want, tag="std-bf16"):
    """One bf16 rounding apart (tests/test_torch_std_bf16.py): |kernel -
    plain| <= 2^-7 |plain| + 1e-3 max |plain| elementwise."""
    err = (got.float() - want.float()).abs()
    tol = 2.0**-7 * want.float().abs() + 1e-3 * want.float().abs().max()
    worst = err.max().item()
    print(f"[{tag}] {label}: max abs err {worst:.3e}, within one bf16 "
          f"rounding everywhere: {bool((err <= tol).all())}")
    if got.dtype != want.dtype or not (err <= tol).all():
        raise AssertionError(f"{label}: beyond one bf16 rounding")
    return worst


def _std_bf16_phase(cf, width=1):
    """Phase 3b': H8's bf16 mode at its ten sites (C and O times
    ``width``: 2 is n_kernels 64's, phase 3d), parity at B = 2, 8 and 64,
    time at 8 and 64. Returns {B: {mode: {"calls", "worst", "ms",
    "plain_ms", "library_ms" (with bias and ReLU), "conv_ms" (the conv
    alone), "bound_ms", "parts", "ops"}}}."""
    import torch

    from segmentation_tpu_torch.core.rng import generator

    wrappers = {k: getattr(cf, k) for k in STD_BF16}
    plains = {k: getattr(cf, f"{k}_plain") for k in STD_BF16}
    out, tag = {}, "std-bf16" if width == 1 else f"std-bf16 n{32 * width}"
    for n in (B_PARITY, B_SERVE, B_BATCH):
        sums = out.setdefault(n, {})
        for name, label, args, kw in _std_bf16_sites(
                n, generator(31 + n, "cuda"), width):
            got = wrappers[name](*args, **kw)
            want = plains[name](*args, **kw)
            torch.cuda.synchronize()
            s = sums.setdefault(name, {
                "calls": 0, "worst": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "conv_ms": 0.0, "bound_ms": 0.0,
                "parts": {"bytes": 0.0, "operations": 0.0}, "ops": 0.0})
            s["calls"] += 1
            s["worst"] = max(s["worst"], _std_bf16_parity(
                f"N={n} {name} {label}", got, want, tag))
            del want
            if n == B_PARITY:
                continue
            lib, conv = _std_bf16_library(name, args, kw)
            fns = {"plain": lambda: plains[name](*args, **kw),
                   "kernel": lambda: wrappers[name](*args, **kw),
                   "library": lib, "conv": conv}
            for f in fns.values():  # warm: cuDNN's first call of a shape
                f()
            t = dict.fromkeys(fns, 0.0)
            for k in list(fns) + list(fns)[::-1]:  # in turns
                t[k] += _time_ms(fns[k]) / 2
            nbytes, ops = _site_work(name, args, kw, (got,))
            b, by = _bound_ms(nbytes, ops)
            for k in fns:
                s["ms" if k == "kernel" else f"{k}_ms"] += t[k]
            s["bound_ms"] += b
            s["parts"][by] += b
            s["ops"] += ops["bf16"]
            print(f"[{tag}] time B={n} {name} {label}: {t['kernel']:.4f}"
                  f" ms, plain {t['plain']:.4f} ms, library conv + bias + "
                  f"ReLU {t['library']:.4f} ms, conv alone {t['conv']:.4f} "
                  f"ms, bound {b:.4f} ms ({by})"
                  f"{_tile_note(name, args, kw, t['kernel'], b)}")
            del fns, lib, conv, got
        if n == B_PARITY:
            continue
        for name, s in sums.items():
            print(f"[{tag}] B={n} {name} over its {s['calls']} sites: "
                  f"{s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, library "
                  f"conv + bias + ReLU {s['library_ms']:.4f} ms, conv alone "
                  f"{s['conv_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
                  f"({s['bound_ms'] / s['ms']:.3f} of it reached)")
        tot = {k: sum(s[k] for s in sums.values())
               for k in ("ms", "library_ms", "conv_ms", "bound_ms", "ops")}
        peak = tot["ops"] / PEAK_OPS_S["bf16"] * 1e3
        print(f"[{tag}] B={n} the ten sites: {tot['ms']:.4f} ms "
              f"({peak / tot['ms']:.3f} of the bf16 tensor peak, "
              f"{tot['ops'] / 1e12:.4f} TFLOP), library conv + bias + ReLU "
              f"{tot['library_ms']:.4f} ms ({peak / tot['library_ms']:.3f}),"
              f" conv alone {tot['conv_ms']:.4f} ms "
              f"({peak / tot['conv_ms']:.3f}); the kernels "
              f"{'beat' if tot['ms'] <= tot['conv_ms'] else 'lose to'} the "
              f"convs alone by {abs(tot['conv_ms'] - tot['ms']):.4f} ms")
    return out


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


def _grad_agreement(got, want):
    """Per param: (cosine, relative L2 error) of got's grad against want's."""
    import torch

    out = {}
    for name, g in got.items():
        g, w = g.double().flatten(), want[name].double().flatten()
        cos = torch.nn.functional.cosine_similarity(g, w, dim=0).item()
        out[name] = (cos, ((g - w).norm() / w.norm()).item())
    return out


def _train_parity(kern, plain, cfg):
    """Phase 6a: one B = 2 batch's loss and grads, kernels vs plain
    versions and vs the f32 plain U-Net under autograd."""
    import torch

    from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation
    from segmentation_tpu_torch.models.unet import UNet
    from segmentation_tpu_torch.nn.shapes import center_crop_or_pad
    from segmentation_tpu_torch.training.losses import segmentation_xentropy

    batch = SyntheticSegmentation(B_TRAIN_PARITY, cfg.hw, seed=0).get_batch()
    loss_k, grads = kern.loss_and_grads(batch)
    grads = {n: g.clone() for n, g in grads.items()}
    loss_p, grads_p = plain.loss_and_grads(batch)
    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    agree = _grad_agreement(grads, grads_p)
    cos_min = min(agree.items(), key=lambda kv: kv[1][0])
    rel_max = max(agree.items(), key=lambda kv: kv[1][1])
    print(f"[train] B={B_TRAIN_PARITY} loss kernels {loss_k.item():.6f}, "
          f"plain {loss_p.item():.6f}, rel diff {rel:.3e} (<= "
          f"{TRAIN_LOSS_REL}); grads vs plain: min cosine {cos_min[1][0]:.6f} "
          f"({cos_min[0]}, >= {GRAD_COS}), max rel L2 {rel_max[1][1]:.3e} "
          f"({rel_max[0]}, <= {GRAD_REL_L2})")
    ref = UNet(cfg, params={n: v.clone()
                            for n, v in kern.model.param_dict().items()})
    ref = ref.cuda()
    for p in ref.params.values():
        p.requires_grad_(True)
    x = torch.as_tensor(batch["image"], device="cuda")
    logits = ref(x)
    mask = center_crop_or_pad(torch.as_tensor(batch["mask"], device="cuda"),
                              logits.shape[1], logits.shape[2])
    loss_ref = segmentation_xentropy(logits, mask, cfg.n_classes)
    loss_ref.backward()
    ref_agree = _grad_agreement(grads, {n: p.grad for n, p in
                                        ref.params.items()})
    worst = min(ref_agree.items(), key=lambda kv: kv[1][0])
    print(f"[train] vs f32 plain U-Net: loss {loss_ref.item():.6f}; min grad "
          f"cosine {worst[1][0]:.6f} ({worst[0]}, >= {REF_GRAD_COS})")
    for tag, table in (("plain", agree), ("f32", ref_agree)):
        low = sorted(table.items(), key=lambda kv: kv[1][0])[:6]
        print(f"[train] lowest grad cosines vs {tag}: " + ", ".join(
            f"{n} {c:.6f}/{r:.3e}" for n, (c, r) in low))
    if rel > TRAIN_LOSS_REL:
        raise AssertionError(f"train loss kernels vs plain: {rel}")
    bad = {n: v for n, v in agree.items()
           if v[0] < GRAD_COS or v[1] > GRAD_REL_L2}
    if bad:
        raise AssertionError(f"grads kernels vs plain: {bad}")
    if worst[1][0] < REF_GRAD_COS:
        raise AssertionError(f"grads vs f32 U-Net: {worst}")


def _train_throughput(trainer, batch, tag, reset, counts):
    """Phase 6c: 2 warm-up steps, reset the launch counts, 5 steps timed
    by CUDA events; (ms per step, peak MiB, the timed steps' launches)."""
    import torch

    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    gc.collect()
    reset()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        metrics = trainer.train_step(batch)
    stop.record()
    stop.synchronize()
    launches = counts()  # the timed steps' launches alone
    ms = start.elapsed_time(stop) / 5
    peak = torch.cuda.max_memory_allocated() / 2**20
    if not math.isfinite(metrics["seg_loss"]):
        raise AssertionError(f"{tag}: non-finite loss {metrics}")
    print(f"[train] {tag} B={B_TRAIN} step {ms:.3f} ms, "
          f"{B_TRAIN * 1e3 / ms:.1f} img/s, peak memory {peak:.1f} MiB; "
          f"launches {launches}")
    return ms, peak, launches


class _CallCensus:
    """Counts the calls of module functions while it is entered (from the
    last ``reset``): the plain versions and the glue that the kernel path
    must not run. Each target is the name its callers resolve when they
    call it (a module global looked up at call time)."""

    def __init__(self, targets):
        self.targets, self.counts, self._saved = targets, {}, []

    def reset(self):
        self.counts = dict.fromkeys(self.targets, 0)

    def __enter__(self):
        self.reset()
        for label, (mod, attr) in self.targets.items():
            f = getattr(mod, attr)

            def counted(*a, _f=f, _label=label, **k):
                self.counts[_label] += 1
                return _f(*a, **k)

            self._saved.append((mod, attr, f))
            setattr(mod, attr, counted)
        return self

    def __exit__(self, *exc):
        for mod, attr, f in reversed(self._saved):
            setattr(mod, attr, f)
        self._saved = []


# H9's two widths: the train cells' configurations (their packed sites'
# geometry and the published wgrad's least time, bench_h100/work.py)
WGRAD_CONFIGS = (("n32", "unet512_bf16"), ("n64", "unet512_n64_bf16"))


def _wgrad_config(name):
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench_h100", "configs", f"{name}.json")) as f:
        return json.load(f)


def _wgrad_operands(gen, n, hw, c4, skip_hw):
    """x (or the dual's skip and up) and the masked cotangent in its
    zero-margined buffer, bf16, as the step hands them to H9."""
    import torch

    hp, wp = hw
    gp = torch.zeros((n, hp, wp, c4), device="cuda", dtype=torch.bfloat16)
    g = torch.randn((n, hp - 1, wp - 1, c4), generator=gen, device="cuda")
    keep = torch.rand(g.shape, generator=gen, device="cuda") > 0.5
    gp[:, :-1, :-1] = (g * keep).to(torch.bfloat16)
    del g, keep
    xs = [torch.rand((n, *s, c4), generator=gen, device="cuda")
          .to(torch.bfloat16) for s in ([skip_hw] if skip_hw else []) + [hw]]
    return xs, gp


def _wgrad_phase(cb):
    """Phase 3e: H9 at its six sites and both widths, N = 2 against the
    plain version in f64, B = 128 against the four products and timed in
    turns with them; returns the JSON rows."""
    import torch

    from bench_h100 import work
    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.models.unet_fast import packed_wgrad_sites

    def calls(xs, gp, offset):
        if len(xs) == 2:
            return (lambda: cb.packed_conv2x2_wgrad_dual(*xs, gp,
                                                         offset=offset),
                    lambda: cb.conv2x2_wgrad_dual_plain(*xs, gp,
                                                        offset=offset))
        return (lambda: (cb.packed_conv2x2_wgrad(xs[0], gp),),
                lambda: (cb.conv2x2_wgrad(xs[0], gp),))

    def err_over_bound(got, ref, mag, roundings):
        """max |got − ref| over ``roundings`` bf16 roundings of |ref|
        (2^-8 each) plus 2^-16 of Σ|x·g| (``mag``), the f32 sums'
        difference in order."""
        return max(((g.double() - r.double()).abs()
                    / (roundings * 2.0**-8 * r.double().abs()
                       + 2.0**-16 * m.double())).max().item()
                   for g, r, m in zip(got, ref, mag))

    rows = []
    for tag, cfg_name in WGRAD_CONFIGS:
        cfg = _wgrad_config(cfg_name)
        sites = packed_wgrad_sites(tuple(cfg["input_dims"]), cfg["levels"],
                                   cfg["n_kernels"])
        for site, (hw, c4, skip_hw, offset) in sites.items():
            label = f"{tag} {site}" + (f" crop {offset}" if offset else "")
            gen = generator(11, "cuda")
            xs, gp = _wgrad_operands(gen, B_TRAIN_PARITY, hw, c4, skip_hw)
            got = calls(xs, gp, offset)[0]()
            dx = [x.double() for x in xs]
            ref = calls(dx, gp.double(), offset)[1]()
            mag = calls([x.abs() for x in dx], gp.double().abs(), offset)[1]()
            worst = err_over_bound(got, ref, mag, 1)
            print(f"[wgrad] N={B_TRAIN_PARITY} {label}: max |err| / bound "
                  f"{worst:.3f} (<= 1)")
            if not worst <= 1.0:
                raise AssertionError(f"H9 {label}: beyond its bound")
            del xs, gp, got, dx, ref, mag
            torch.cuda.empty_cache()
            # B = 128: the kernel against the four products (cuBLAS, each
            # summed in f32 and rounded once to bf16), a rounding each
            xs, gp = _wgrad_operands(gen, B_TRAIN, hw, c4, skip_hw)
            kernel, plain = calls(xs, gp, offset)
            got, ref = kernel(), plain()  # and warm
            mag = calls([x.abs() for x in xs], gp.abs(), offset)[1]()
            worst128 = err_over_bound(got, ref, mag, 2)
            del got, ref, mag
            print(f"[wgrad] N={B_TRAIN} {label}: max |err| / bound against "
                  f"the four products {worst128:.3f} (<= 1)")
            if not worst128 <= 1.0:
                raise AssertionError(f"H9 {label} at N = {B_TRAIN}: beyond "
                                     f"its bound")
            t = {"kernel": 0.0, "library": 0.0}
            for k, f in (("kernel", kernel), ("library", plain),
                         ("library", plain), ("kernel", kernel)):
                t[k] += _time_ms(f, 5) / 2
            n, hp, wp, o4 = gp.shape
            sides = len(xs)
            # x (the skip: its crop window, up's size), g and dw once
            nbytes = sides * _bytes(xs[-1]) + _bytes(gp) + sides * 4 * c4 \
                * o4 * 2
            ops = sides * 2 * n * (hp - 1) * (wp - 1) * 4 * c4 * o4
            b, by = _bound_ms(nbytes, {"bf16": ops})
            # the published 3×3 wgrad's least time (its function's work,
            # 9/16 of the packed taps' operations): H9's roofline
            least = work.site_least_s(cfg, site, "wgrad", B_TRAIN) * 1e3
            crops = (offset is not None, False) if sides == 2 else (False,)
            plan = cb.tap_grad_plan(n, hp, wp, c4, o4, crops,
                                    torch.cuda.get_device_properties(0)
                                    .multi_processor_count)
            tensor = _peak_ms({"bf16": ops}) / t["kernel"]
            print(f"[wgrad] B={B_TRAIN} {label}: {t['kernel']:.4f} ms, four "
                  f"products {t['library']:.4f} ms; roofline (the published "
                  f"wgrad) {least:.4f} ms, {least / t['kernel']:.3f} of it "
                  f"reached; packed bound {b:.4f} ms ({by}), "
                  f"{b / t['kernel']:.3f} of it, {tensor:.3f} of the packed "
                  f"bf16 tensor peak; splits "
                  f"{plan.splits}, blocks {plan.blocks}")
            rows.append({"name": cb.WGRAD, "width": tag, "site": site,
                         "max_err_over_bound": worst,
                         "max_err_over_bound_b128": worst128,
                         "ms": t["kernel"], "library_ms": t["library"],
                         "least_ms": least, "roofline": least / t["kernel"],
                         "bound_ms": b, "bound_by": by,
                         "splits": plan.splits, "blocks": plan.blocks})
            del xs, gp, kernel, plain
            torch.cuda.empty_cache()
    for tag, _ in WGRAD_CONFIGS:
        mine = [r for r in rows if r["width"] == tag]
        ms, lib, least, bnd = (sum(r[k] for r in mine) for k in
                               ("ms", "library_ms", "least_ms", "bound_ms"))
        print(f"[wgrad] {cb.WGRAD} B={B_TRAIN} {tag} over its six sites: "
              f"{ms:.4f} ms, four products {lib:.4f} ms; roofline "
              f"{least:.4f} ms ({least / ms:.3f} of it reached); packed "
              f"bound {bnd:.4f} ms ({bnd / ms:.3f})")
    return rows


WGRAD_CROP = "crop_packed (conv_bwd: the duals' wgrad operand)"


def _glue_census():
    """The plain code a train step's kernel path may reach: pool4_select
    (through unet_fast's pool_select and pool_scatter), the plain pool and
    glue (conv_flat.pool_select, train_glue's relu_bias_grad_plain and
    pool_scatter), the plain dual's crop copy and its dgrad's un-crop, and
    F.pad (of a cotangent): none of them; nor the crop copy that the
    duals' wgrad made of the skip before H9 read it in place (WGRAD_CROP,
    conv_bwd.crop_packed, which only the plain dual wgrad calls now)."""
    import torch.nn.functional as F

    from segmentation_tpu_torch.models import unet_fast
    from segmentation_tpu_torch.nn.kernels import conv_bwd, conv_flat
    from segmentation_tpu_torch.nn.kernels import train_glue

    return _CallCensus({
        "pool4_select (unet_fast.pool_select)": (unet_fast, "pool_select"),
        "pool4_select backward (unet_fast.pool_scatter)":
            (unet_fast, "pool_scatter"),
        "pool_select (the plain H1 pool)": (conv_flat, "pool_select"),
        "relu_bias_grad_plain": (train_glue, "relu_bias_grad_plain"),
        "pool_scatter (the plain glue)": (train_glue, "pool_scatter"),
        "crop_packed (the plain dual)": (conv_flat, "crop_packed"),
        "uncrop_packed (the plain dual dgrad)": (conv_bwd, "uncrop_packed"),
        WGRAD_CROP: (conv_bwd, "crop_packed"),
        "F.pad": (F, "pad"),
    })


def _train_phase(cf, cb, tg):
    """Phase 6; returns the kernel path's timed-step launches and the
    summary numbers."""
    import torch

    from segmentation_tpu_torch.core.config import TrainConfig
    from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.profile_serving import profile
    from segmentation_tpu_torch.serving import flagship_config
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer

    cfg = flagship_config()
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(save_dir=tmp)

        def trainer(ops, params=None):
            model = UNetS2D(cfg, params=params, seed=tcfg.seed, ops=ops)
            return SegmentationTrainer(model, device="cuda", train_cfg=tcfg)

        kern = trainer(cf.KERNEL_OPS)
        plain = trainer(cf.PLAIN_OPS, params=kern.model.param_dict())

        # ---- 6a. one step's loss and grads ------------------------------
        _train_parity(kern, plain, cfg)

        # ---- 6b. ten Adam steps on one batch ----------------------------
        fit = kern._place(SyntheticSegmentation(B_TRAIN_FIT, cfg.hw,
                                                seed=1).get_batch())
        losses = [kern.train_step(fit)["seg_loss"] for _ in range(10)]
        print(f"[train] 10 steps on one B={B_TRAIN_FIT} batch: loss "
              f"{[round(v, 6) for v in losses]}")
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"training did not lower the loss: {losses}")

        # ---- 6c. B = 128 throughput on device-resident batches ----------
        del fit
        big = kern._place(SyntheticSegmentation(B_TRAIN, cfg.hw,
                                                seed=2).get_batch())

        census = _glue_census()

        def reset():
            cf.reset_launches()
            cb.reset_launches()
            tg.reset_launches()
            census.reset()

        def counts():
            return {**cf.launches, **cb.launches, **tg.launches}

        torch.cuda.empty_cache()
        with census:
            k_ms, k_peak, launches = _train_throughput(kern, big, "kernels",
                                                       reset, counts)
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"train kernels never launched: {missing}")
        print(f"[train] kernels B={B_TRAIN}: calls of the plain versions and "
              f"glue in the timed steps {census.counts} (the old _mask is "
              f"gone)")
        if any(census.counts.values()):
            raise AssertionError(f"the kernel path ran {census.counts}")
        if launches[cb.WGRAD] != 6 * 5:  # one a packed site, 5 steps
            raise AssertionError(f"H9 launched {launches[cb.WGRAD]} times "
                                 f"in 5 steps, not 6 a step")
        torch.cuda.empty_cache()
        p_ms, p_peak, p_launches = _train_throughput(plain, big, "plain",
                                                     reset, counts)
        if any(p_launches.values()):
            raise AssertionError(f"the plain path launched {p_launches}")
        del plain
        torch.cuda.empty_cache()

        # device busy share of the kernel path's step (profile_serving's
        # method: the trace's device activities over the CUDA-event time)
        wall, dev_ms, groups, rows = profile(kern.train_step, [big] * 3)
        print(f"[train] kernels B={B_TRAIN} profile: CUDA-event ms per step "
              f"{wall:.3f}; device ms per step {dev_ms:.3f}; busy share "
              f"{dev_ms / wall:.3f}")
        for g, v in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"[train]   {g}: {v:.3f} ms ({v / dev_ms:.3f} of device "
                  f"time)")
        for v, k, name in rows[:15]:  # the costliest device activities
            print(f"[train]     {v:8.3f} ms {k:5.1f}x {name[:110]}")
    return launches, (k_ms, k_peak, p_ms, p_peak, dev_ms / wall)


def _n64_path_phase(cf, cb, tg):
    """Phase 3d's launches on the main path at n_kernels = 64: B_N64 train
    steps (one untimed, then the launch counts reset, then two, with the
    glue census of phase 6) and B_SERVE requests (one untimed, then the
    counts reset, then two, masks against the plain versions'); every
    kernel mode of each path must launch and the kernel path run no plain
    code. Returns {path: launches}."""
    import dataclasses

    import torch

    from segmentation_tpu_torch.core.config import TrainConfig
    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation
    from segmentation_tpu_torch.models.unet_fast import (
        UNetS2D,
        UNetS2DInference,
    )
    from segmentation_tpu_torch.serving import Server, flagship_config
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer

    cfg = dataclasses.replace(flagship_config(), n_kernels=64)
    census = _glue_census()

    def reset():
        cf.reset_launches()
        cb.reset_launches()
        tg.reset_launches()
        census.reset()

    with tempfile.TemporaryDirectory() as tmp:
        trainer = SegmentationTrainer(
            UNetS2D(cfg, seed=0, ops=cf.KERNEL_OPS), device="cuda",
            train_cfg=TrainConfig(save_dir=tmp))
        batch = trainer._place(SyntheticSegmentation(B_N64, cfg.hw,
                                                     seed=2).get_batch())
        trainer.train_step(batch)
        torch.cuda.synchronize()
        with census:
            reset()
            losses = [trainer.train_step(batch)["seg_loss"]
                      for _ in range(2)]
        train = {**cf.launches, **cb.launches, **tg.launches}
        params = trainer.model.param_dict()
        del trainer, batch
    missing = [k for k, v in train.items() if v == 0]
    print(f"[n64] train B={B_N64}: 2 steps, loss {losses}, launches {train}; "
          f"plain code {census.counts}")
    if missing or not all(map(math.isfinite, losses)):
        raise AssertionError(f"n64 train kernels never launched: "
                             f"{missing}; {losses}")
    if any(census.counts.values()) or train[cb.WGRAD] != 6 * 2:
        raise AssertionError(f"the n64 kernel path ran {census.counts}, "
                             f"H9 {train[cb.WGRAD]} times in 2 steps")
    torch.cuda.empty_cache()

    model = UNetS2DInference(cfg)
    server = Server(model, params, model.prepare(params, dtype=torch.bfloat16,
                                                 device="cuda"))
    gen = generator(64, "cuda")
    reqs = [torch.rand((B_SERVE, HW, HW, 3), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(3)]
    server(reqs[0])
    torch.cuda.synchronize()
    reset()
    masks = [server(x) for x in reqs[1:]]
    serve = dict(cf.launches)
    # the masks against the plain versions': a pixel may flip only where
    # the plain logits' margin lies within the bf16 tolerance (REL_TOL *
    # max |logits|); three steps from the init leave the loss at ln 2, the
    # two logits near a tie, so the share bound is the head site's
    plain = Server(UNetS2DInference(cfg, ops=cf.PLAIN_OPS), server.params,
                   server.prepared)
    agree, wide = 1.0, 0
    for x, m in zip(reqs[1:], masks):
        logits = plain.logits(x).float()
        margin = (logits[..., 1] - logits[..., 0]).abs()
        diff = plain(x) != m
        agree = min(agree, 1.0 - diff.float().mean().item())
        wide += int((margin[diff] > REL_TOL * logits.abs().max()).sum())
    print(f"[n64] serve B={B_SERVE}: 2 requests, launches {serve}; masks vs "
          f"plain-version forward min agreement {agree:.6f} "
          f"(>= {SITE_MASK_AGREE}), flips beyond the bf16 margin {wide}")
    missing = [k for k, v in serve.items()
               if v == 0 and k not in cf.TRAIN_ONLY + cf.MC_ONLY]
    if missing or agree < SITE_MASK_AGREE or wide:
        raise AssertionError(f"n64 serving: never launched {missing}, "
                             f"agreement {agree}, {wide} wide flips")
    return {"train_n64": train, "serve_n64": serve}


# ------------------------------------------------------------- 7. data path
def _data_tiles(n):
    """n seeded TILE² staging tiles, SyntheticSegmentation's discs as bytes:
    images u8 [n, TILE, TILE, 3], masks u8 [n, TILE, TILE, 1] in {0, 1}."""
    import numpy as np

    from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation

    b = SyntheticSegmentation(n, (TILE, TILE), seed=DATA_SEED).get_batch()
    return np.rint(b["image"] * 255).astype(np.uint8), b["mask"]


def _h7_phase(tiles):
    """Phase 7a: H7 against its plain version at the data path's shape (B =
    128 staging tiles, crop 512, fused_augment's offsets, mixed flips):
    exact in every mode, the image alone (u8, f32, bf16) and the image
    with its mask in one launch (each image dtype), then with x offsets
    off the 8-pixel grid. Returns (kernel ms, plain ms, bound ms, the
    resource that binds) of the path's one launch, the bf16 image and the
    u8 mask, and the largest max abs err of the modes."""
    import numpy as np
    import torch

    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.nn.kernels import augment as aug

    imgs, masks = tiles
    idx = np.random.default_rng(DATA_SEED).integers(0, len(imgs), B_TRAIN)
    imgs = torch.from_numpy(imgs[idx]).cuda()
    masks = torch.from_numpy(masks[idx]).cuda()
    n = B_TRAIN
    ys, xs, flips = aug.random_offsets(generator(DATA_SEED, "cuda"),
                                       imgs.shape, HW, x_step=8)
    xs_any = (xs + torch.arange(n, device="cuda", dtype=torch.int32) % 8
              ).clamp(max=TILE - HW)
    print(f"[data] H7 offsets: {int(flips.sum())} of {n} flipped, x in "
          f"[{int(xs.min())}, {int(xs.max())}] (multiples of 8; then "
          f"{int((xs_any % 8 != 0).sum())} off the grid)")
    worst = 0.0
    cases = [(f"image {t}", False, dt, xs) for t, dt in (
        ("u8", torch.uint8), ("f32", torch.float32),
        ("bf16", torch.bfloat16))]
    cases += [(f"image {t} + mask{x_txt}", True, dt, x_) for t, dt in (
        ("u8", torch.uint8), ("f32", torch.float32),
        ("bf16", torch.bfloat16))
        for x_txt, x_ in (("", xs), (" (x off the grid)", xs_any))]
    for label, pair, dt, x_ in cases:
        if pair:
            got = aug.crop_normalize_pair(imgs, masks, ys, x_, flips, HW, dt)
            want = (aug.crop_normalize_plain(imgs, ys, x_, flips, HW, dt),
                    aug.crop_normalize_plain(masks, ys, x_, flips, HW,
                                             torch.uint8))
        else:
            got = (aug.crop_normalize(imgs, ys, x_, flips, HW, dt),)
            want = (aug.crop_normalize_plain(imgs, ys, x_, flips, HW, dt),)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = (g.float() - w.float()).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(g, w):
                raise AssertionError(f"H7 {label}: differs from the plain "
                                     f"version (max abs err {err})")
        print(f"[data] H7 {label} B={n} {TILE}²→{HW}²: equal to the plain "
              f"version byte for byte")
        del got, want

    def k_fn():  # the path's launch: the bf16 image and the u8 mask
        return aug.crop_normalize_pair(imgs, masks, ys, xs, flips, HW,
                                       torch.bfloat16)

    def p_fn():
        return (aug.crop_normalize_plain(imgs, ys, xs, flips, HW,
                                         torch.bfloat16),
                aug.crop_normalize_plain(masks, ys, xs, flips, HW,
                                         torch.uint8))

    k_fn(), p_fn()
    t_p1, t_k1, t_k2, t_p2 = (_time_ms(f) for f in (p_fn, k_fn, k_fn, p_fn))
    t_k, t_p = (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2
    # the windows read, the outputs written, the offsets; a multiply per
    # float output
    nbytes = (n * HW * HW * (imgs.shape[-1] + masks.shape[-1])
              + _bytes(*k_fn(), ys, xs, flips))
    b, by = _bound_ms(nbytes, {"f32": n * HW * HW * imgs.shape[-1]})
    print(f"[data] H7 image bf16 + mask u8, one launch, B={n} "
          f"{TILE}²→{HW}²: {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
          f"{b:.4f} ms ({by}), {nbytes / t_k / 1e6:.1f} GB/s, "
          f"{b / t_k:.3f} of the bound")
    return t_k, t_p, b, by, worst


def _write_png(path, a):
    """8-bit gray ([H, W]) or RGB ([H, W, 3]) PNG, zlib level 1: no image
    library needed."""
    h, w = a.shape[:2]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = a.reshape(h, -1)
    raw = b"".join(b"\x00" + rows[r].tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             0 if a.ndim == 2 else 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def _disk_phase(trainer, tiles, gen):
    """Phase 7c: N_DISK_FILES PNG pairs of TILE² → the native loader (u8
    staging, its crop the identity); the loader alone at 1, 2 and 4
    threads, then loader → prefetcher → H7 → train step at B = 16, beside
    the same step on a device-resident batch. Returns (disk→step img/s,
    step-alone img/s), or None when g++ cannot build the native loader
    (the phase is then skipped with its error)."""
    import numpy as np
    import torch

    from segmentation_tpu_torch.data import native
    from segmentation_tpu_torch.data.pipeline import DevicePrefetcher
    from segmentation_tpu_torch.nn.kernels import augment as aug

    if not native.available():
        err = " | ".join(native.build_error().strip().splitlines())
        print(f"[data] disk phase skipped: {err}")
        return None
    imgs, masks = tiles
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [os.path.join(tmp, d) for d in ("features", "labels")]
        for d in dirs:
            os.makedirs(d)
        t0 = time.perf_counter()
        for i in range(N_DISK_FILES):  # each tile three times, shifted
            k, shift = i % len(imgs), 37 * (i // len(imgs))
            _write_png(os.path.join(dirs[0], f"{i:03d}.png"),
                       np.roll(imgs[k], shift, axis=1))
            _write_png(os.path.join(dirs[1], f"{i:03d}.png"),
                       np.roll(masks[k, ..., 0], shift, axis=1) * 255)
        print(f"[data] wrote {N_DISK_FILES} PNG pairs of {TILE}² in "
              f"{time.perf_counter() - t0:.1f} s")

        def make(threads):
            return native.NativeImageMaskDataSet(
                *dirs, batch_size=B_DISK, crop_size=TILE, image_ext="png",
                seed=DATA_SEED, threads=threads, uint8_images=True)

        rates = {}
        for threads in (1, 2, 4):
            ds = make(threads)
            for _ in range(2):  # decode warm-up, drain the prefill
                ds.get_batch()
            t0 = time.perf_counter()
            for _ in range(6):
                ds.get_batch()
            rates[threads] = 6 * B_DISK / (time.perf_counter() - t0)
            ds.close()
        print(f"[data] native loader alone, B={B_DISK} {TILE}² PNG pairs, "
              f"img/s by threads: " + ", ".join(
                  f"{t}: {r:.1f}" for t, r in rates.items()))
        best = max(rates, key=rates.get)
        ds = make(best)
        pf = DevicePrefetcher(ds, depth=2)
        last = {}

        def step():
            b = next(pf)
            img, mask = aug.fused_augment(gen, b["image"], b["mask"], HW,
                                          out_dtype=torch.bfloat16)
            last.update(image=img, mask=mask)
            return trainer.train_step(last)

        for _ in range(2):
            step()
        disk_ms = _time_ms(step, 5)  # each step ends in a sync
        pf.stop()
        ds.close()
        alone_ms = _time_ms(lambda: trainer.train_step(last), 5)
    disk_ips, alone_ips = B_DISK * 1e3 / disk_ms, B_DISK * 1e3 / alone_ms
    print(f"[data] disk→step B={B_DISK} (native u8 loader, {best} threads): "
          f"{disk_ms:.3f} ms a step, {disk_ips:.1f} img/s; the same step on "
          f"a device-resident batch {alone_ms:.3f} ms, {alone_ips:.1f} img/s")
    return disk_ips, alone_ips


def _data_phase(cf, cb, tg, tiles):
    """Phase 7b (and 7c): the data path into the flagship trainer at B =
    128, its launches, step time, busy share and the pinned H2D rate."""
    import numpy as np
    import torch

    from segmentation_tpu_torch.core.config import TrainConfig
    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.data.pipeline import (
        DevicePrefetcher,
        GeneratorDataSet,
    )
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.nn.kernels import augment as aug
    from segmentation_tpu_torch.profile_serving import profile
    from segmentation_tpu_torch.serving import flagship_config
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer

    imgs, masks = tiles
    rng = np.random.default_rng(DATA_SEED + 1)
    host = []
    for _ in range(2):  # two staging batches, made once (set-up)
        idx = rng.integers(0, len(imgs), B_TRAIN)
        host.append({"image": imgs[idx], "mask": masks[idx]})

    pinned = [torch.from_numpy(v).pin_memory() for v in host[0].values()]
    nbytes = _bytes(*pinned)
    h2d_ms = _time_ms(lambda: [t.to("cuda", non_blocking=True)
                               for t in pinned], iters=5)
    h2d = nbytes / h2d_ms / 1e6
    print(f"[data] pinned H2D of one B={B_TRAIN} staging batch "
          f"({nbytes / 1e6:.1f} MB): {h2d_ms:.3f} ms, {h2d:.2f} GB/s")
    del pinned

    with tempfile.TemporaryDirectory() as tmp:
        # no device argument: the trainer's default is the card
        trainer = SegmentationTrainer(
            UNetS2D(flagship_config(), seed=0, ops=cf.KERNEL_OPS),
            train_cfg=TrainConfig(save_dir=tmp))
        ds = GeneratorDataSet(lambda worker: iter(host), B_TRAIN,
                              capacity=2, has_masks=True)
        pf = DevicePrefetcher(ds, depth=2)
        gen = generator(DATA_SEED, "cuda")

        last, metrics = {}, {}

        def step(_=None):
            b = next(pf)
            img, mask = aug.fused_augment(gen, b["image"], b["mask"], HW,
                                          out_dtype=torch.bfloat16)
            last.update(image=img, mask=mask)
            metrics.update(trainer.train_step(last))

        def resident():  # the same step on the last batch, on the card
            trainer.train_step(last)

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        gc.collect()
        for mod in (cf, cb, tg, aug):  # counted: the first 5 timed steps
            mod.reset_launches()
        ms = _time_ms(step, 5)
        launches = {**cf.launches, **cb.launches, **tg.launches,
                    **aug.launches}
        print(f"[data] B={B_TRAIN} prefetcher → H7 → train step: {ms:.3f} "
              f"ms a step, {B_TRAIN * 1e3 / ms:.1f} img/s, loss "
              f"{metrics['seg_loss']:.6f}; launches {launches}")
        if not math.isfinite(metrics["seg_loss"]):
            raise AssertionError(f"data path: non-finite loss {metrics}")
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"data path: never launched: {missing}")
        if launches["crop_normalize"] != 5:
            raise AssertionError("H7 did not launch once a step (image and "
                                 "mask together)")
        # what the data path costs the step: the same trainer in turns
        # (data, resident, resident, data), 5 steps each
        r1, r2, d2 = (_time_ms(f, 5) for f in (resident, resident, step))
        data_ms, resident_ms = (ms + d2) / 2, (r1 + r2) / 2
        print(f"[data] B={B_TRAIN} in turns: data path {ms:.3f}, {d2:.3f} ms; "
              f"device-resident batch {r1:.3f}, {r2:.3f} ms; the data path "
              f"adds {data_ms - resident_ms:.3f} ms a step")
        wall, dev_ms, groups, rows = profile(step, [None] * 3)
        print(f"[data] B={B_TRAIN} data path profile: CUDA-event ms per step "
              f"{wall:.3f}; device ms per step {dev_ms:.3f}; busy share "
              f"{dev_ms / wall:.3f}")
        for g, v in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"[data]   {g}: {v:.3f} ms ({v / dev_ms:.3f} of device "
                  "time)")
        for v, k, name in rows:  # the host→device copies and H7
            if "HtoD" in name or "crop_normalize" in name:
                print(f"[data]     {v:8.3f} ms {k:5.1f}x {name[:110]}")
        pf.stop()
        ds.request_stop()
        del host
        disk = _disk_phase(trainer, tiles, gen)
    return launches, (data_ms, resident_ms, dev_ms / wall, h2d, disk)


def _check_route(tag, counts, requests):
    """Every kernel mode of an int8 configuration launched exactly as the
    route says (ROUTE_LAUNCHES), and no other mode."""
    want = {k: v * requests for k, v in ROUTE_LAUNCHES[tag].items()}
    got = {k: v for k, v in counts.items() if v}
    print(f"[int8] {tag} launches {got}")
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")


def _std_conv_phase(tag, server, x, timed=True):
    """H8, the standard levels' s8 3×3 conv (ops8.std_conv3x3 and
    std_conv3x3_dual, which the JAX package leaves to XLA): each of its
    launches in one B = 8 request of ``server``, recorded with its
    operands, is held against its plain version code for code (bf16 values
    bit for bit); with ``timed`` each is timed in turns against the plain
    version and against the GEMM alone (torch._int_mm on its im2col
    matrix, s32 out: the library column; PyTorch has no s8 conv on CUDA),
    beside its bound (the fused function: each operand read once, y
    written once, no s32 store; 2·9·C·O operations per output pixel and
    side). Returns {mode: {"calls", "worst", "ms", "plain_ms",
    "library_ms", "bound_ms", "parts"}} over the request's launches."""
    import torch

    from segmentation_tpu_torch.nn.kernels import conv_int8 as ci

    calls, ops8 = [], server.model.ops8

    def single(*a, **k):
        calls.append(("std_conv3x3_s8", a, k))
        return ci.std_conv3x3_s8(*a, **k)

    def dual(*a, **k):
        inline = k.get("act_scale_a") is not None or \
            k.get("act_scale_b") is not None
        calls.append(("std_conv3x3_dual_s8" + ("_inline" if inline else ""),
                      a, k))
        return ci.std_conv3x3_dual_s8(*a, **k)

    server.model.ops8 = ops8._replace(std_conv3x3=single,
                                      std_conv3x3_dual=dual)
    try:
        server(x)
    finally:
        server.model.ops8 = ops8
    out = {}
    for mode, a, k in calls:
        wrapper, plain = ((ci.std_conv3x3_s8, ci.std_conv3x3_s8_plain)
                          if mode == "std_conv3x3_s8" else
                          (ci.std_conv3x3_dual_s8,
                           ci.std_conv3x3_dual_s8_plain))
        got, want = wrapper(*a, **k), plain(*a, **k)
        torch.cuda.synchronize()
        shape = tuple((a[1] if "dual" in mode else a[0]).shape)
        label = f"{tag} {mode} {shape} -> {a[2].shape[-1]} {got.dtype}"
        if got.dtype != want.dtype or not torch.equal(got, want):
            _parity(label, got, want)  # prints the difference
            raise AssertionError(f"{label}: not equal to its plain version")
        s = out.setdefault(mode, {"calls": 0, "worst": 0.0, "ms": 0.0,
                                  "plain_ms": 0.0, "library_ms": 0.0,
                                  "bound_ms": 0.0,
                                  "parts": {"bytes": 0.0,
                                            "operations": 0.0}})
        s["calls"] += 1
        if not timed:
            print(f"[int8] {label}: equal to its plain version")
            continue
        fns = {"plain": lambda: plain(*a, **k),
               "kernel": lambda: wrapper(*a, **k),
               "library": _int_mm_call(mode, a, k)}
        for f in fns.values():
            f()
        tm = dict.fromkeys(fns, 0.0)
        for key in list(fns) + list(fns)[::-1]:  # in turns
            tm[key] += _time_ms(fns[key], iters=5) / 2
        b, by = _bound_ms(*_site_work(mode, a, k, (got,)))
        for key in fns:
            s["ms" if key == "kernel" else f"{key}_ms"] += tm[key]
        s["bound_ms"] += b
        s["parts"][by] += b
        print(f"[int8] {label}: equal to its plain version; "
              f"{tm['kernel']:.4f} ms, plain {tm['plain']:.4f} ms, GEMM "
              f"alone {tm['library']:.4f} ms, bound {b:.4f} ms ({by})"
              f"{_tile_note(mode, a, k, tm['kernel'], b)}")
        del fns
    for mode, s in out.items():
        line = f"[int8] {tag} {mode}: {s['calls']} launches a request"
        if timed:
            line += (f", {s['ms']:.4f} ms (GEMM alone {s['library_ms']:.4f}"
                     f" ms, plain {s['plain_ms']:.4f} ms), bound "
                     f"{s['bound_ms']:.4f} ms ({s['bound_ms'] / s['ms']:.3f}"
                     f" of it reached)")
        print(line)
    return out


def _int8_config_phase(tag, kw, reqs, calib, want, out_hw, reset):
    """Phase 4c for one int8 configuration: serve the 4 requests, check its
    launches, its masks against the same configuration on the plain
    versions and against the f32 plain U-Net (``want``, the logits of
    reqs[0]); return (launch counts, (mean ms, img/s, peak MiB))."""
    import torch

    from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8
    from segmentation_tpu_torch.nn.kernels import conv_flat as cf
    from segmentation_tpu_torch.nn.kernels import conv_int8 as ci
    from segmentation_tpu_torch.nn.kernels import train_glue as tg
    from segmentation_tpu_torch.serving import Server, entry

    t0 = time.perf_counter()
    server, _ = entry("cuda", batch=B_SERVE, seed=0, int8=True,
                      calib=[calib], **kw)
    torch.cuda.synchronize()
    print(f"[int8] {tag} ({kw}) prepared and calibrated in "
          f"{time.perf_counter() - t0:.1f} s")
    masks, lat, peak = _serve(server, reqs, reset)
    counts = {**cf.launches, **ci.launches}
    _check_route(tag, counts, len(reqs))
    _std_conv_phase(tag, server, reqs[0], timed=False)
    logits = server.logits(reqs[0])
    torch.cuda.synchronize()
    _check_masks(masks, (B_SERVE, *out_hw))
    if tuple(logits.shape) != (B_SERVE, *out_hw, 2):
        raise AssertionError(f"{tag} logits {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{tag}: non-finite logits")
    plain = Server(UNetS2DInt8(server.model.cfg, ops=cf.PLAIN_OPS,
                               ops8=ci.PLAIN_OPS, **kw),
                   server.params, server.prepared)
    with torch.no_grad():
        agree = min((plain(x) == m).float().mean().item()
                    for x, m in zip(reqs, masks))
    ref_agree = (masks[0] == want.argmax(-1)).float().mean().item()
    corr = torch.corrcoef(torch.stack(
        [logits.float().flatten(), want.flatten()]))[0, 1].item()
    print(f"[int8] {tag}: masks vs the same configuration on the plain "
          f"versions: min agreement {agree:.6f} (>= {INT8_MASK_AGREE}); vs "
          f"f32 plain U-Net: mask agreement {ref_agree:.6f} (>= "
          f"{INT8_REF_MASK_AGREE}), logit correlation {corr:.6f} (>= "
          f"{INT8_REF_CORR})")
    if agree < INT8_MASK_AGREE:
        raise AssertionError(f"{tag} masks vs plain versions: {agree}")
    if ref_agree < INT8_REF_MASK_AGREE or corr < INT8_REF_CORR:
        raise AssertionError(f"{tag} vs f32: agreement {ref_agree}, "
                             f"correlation {corr}")
    return counts, _latency_line(tag, lat, peak)


def _mc_phase(cf):
    """Phase 3f: the MC-dropout request's kernels at the MC cell's sizes
    (1024², B = 2 tiles, S = 8 samples, n_kernels 32), each against its
    plain version and timed beside its bound; the duals' broadcast skip
    (skip batch B under an up batch of S·B) against the same kernel on the
    skip repeated S times (bit for bit) and timed against that kernel plus
    the repeat the broadcast saves; then whole requests through
    serving.entry(mc_samples=8): their latency, launches and answers
    against the same server on the plain versions. Returns the JSON
    rows."""
    import torch

    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
    from segmentation_tpu_torch.serving import MCServer, entry

    gen = generator(31, "cuda")
    n, f32 = MC_B * MC_S, torch.float32

    def act(*shape):
        return torch.rand(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def wgt(*shape):  # fan-in scaled: activations stay O(1) through a conv
        fan = math.prod(shape[:-1])
        return (torch.randn(shape, generator=gen, device="cuda")
                / fan ** 0.5).to(torch.bfloat16)

    def bias(o):
        return torch.randn((o,), generator=gen, device="cuda") * 0.1

    def conv_ops(pixels, cin, o, taps=9):
        return {"bf16": 2.0 * pixels * taps * cin * o}

    rows = []

    def timed(name, label, kernel, other, bound, other_name):
        kernel(), other()  # warm
        t = {"kernel": 0.0, "other": 0.0}
        for k, f in (("kernel", kernel), ("other", other), ("other", other),
                     ("kernel", kernel)):
            t[k] += _time_ms(f) / 2
        b, by = bound
        print(f"[mc] {name} {label}: {t['kernel']:.4f} ms, {other_name} "
              f"{t['other']:.4f} ms, bound {b:.4f} ms ({by}), "
              f"{b / t['kernel']:.3f} of it reached")
        rows.append({"name": name, "site": label, "ms": t["kernel"],
                     "other": other_name, "other_ms": t["other"],
                     "bound_ms": b, "bound_by": by,
                     "share": b / t["kernel"]})

    seed, rate = MC_SEED, 0.5
    # the fan-out: conv5_2's output [B, 56, 56, 512]
    x = act(MC_B, 56, 56, 512)
    got = cf.mc_fanout(x, seed=seed, samples=MC_S, rate=rate)
    want = cf.mc_fanout_plain(x, seed=seed, samples=MC_S, rate=rate)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("mc_fanout differs from its plain version")
    print("[mc] mc_fanout conv5_2 [2, 56, 56, 512] -> 16: equal to its "
          "plain version")
    timed("mc_fanout", "conv5_2", lambda: cf.mc_fanout(
        x, seed=seed, samples=MC_S, rate=rate), lambda: cf.mc_fanout_plain(
        x, seed=seed, samples=MC_S, rate=rate),
        _bound_ms(_bytes(x, got), {}), "plain")
    # the MC head: conv9_1's output [S·B, 419, 419, 128] → conv9_2 + head
    h4 = act(n, 419, 419, 128)
    w2, b4 = wgt(2, 2, 128, 128), bias(128)
    wh, bh = wgt(32, 2), bias(2)
    kw = {"seed": seed, "tiles": MC_B, "rate": rate}
    got = cf.packed_conv2x2_mc_head(h4, w2, b4, wh, bh, **kw)
    want = cf.packed_conv2x2_mc_head_plain(h4, w2, b4, wh, bh, **kw)
    torch.cuda.synchronize()
    _parity("N=16 packed_conv2x2_mc_head conv9_2+mc_head", got, want)
    pixels = n * 836 * 836
    ops = conv_ops(pixels, 32, 32)
    ops["bf16"] += conv_ops(pixels, 32, 2, taps=1)["bf16"]
    timed("packed_conv2x2_mc_head", "conv9_2+mc_head",
          lambda: cf.packed_conv2x2_mc_head(h4, w2, b4, wh, bh, **kw),
          lambda: cf.packed_conv2x2(h4, w2, b4),
          _bound_ms(_bytes(h4, got) + 9 * 32 * 32 * 2 + 32 * 2 * 2, ops),
          "H1, y stored")
    del h4, got, want
    # the moments: [S·B, 418, 418, 8] f32 → B tiles of 836²
    probs = torch.rand((n, 418, 418, 8), generator=gen, device="cuda")
    got = cf.mc_moments(probs, tiles=MC_B)
    want = cf.mc_moments_plain(probs, tiles=MC_B)
    torch.cuda.synchronize()
    for g, w, what in zip(got[:2], want[:2], ("mean", "var")):
        _parity(f"N=16 mc_moments {what}", g, w)
    margin = (want[0][..., 1] - want[0][..., 0]).abs()
    flips = got[2] != want[2]
    if flips.any() and margin[flips].max() > 1e-6:
        raise AssertionError("mc_moments: the map flips beyond f32 noise")
    timed("mc_moments", "moments", lambda: cf.mc_moments(probs, tiles=MC_B),
          lambda: cf.mc_moments_plain(probs, tiles=MC_B),
          _bound_ms(_bytes(probs, *got), {}), "plain")
    del probs, got, want
    # the duals' broadcast skip: H2 at conv8_1, conv9_1; H8 at conv6_1,
    # conv7_1 (skip [B, ...], up [S·B, ...], the cell's shapes and offsets)
    duals = (("packed_conv2x2_dual", "conv8_1", (253, 212, 256, 256, 41)),
             ("packed_conv2x2_dual", "conv9_1", (510, 420, 128, 128, 90)),
             ("std_conv3x3_dual", "conv6_1", (120, 112, 256, 256, 4)),
             ("std_conv3x3_dual", "conv7_1", (249, 216, 128, 128, 16)))
    for name, label, (hs, hu, c, o, off) in duals:
        skip, up = act(MC_B, hs, hs, c), act(n, hu, hu, c)
        if name == "std_conv3x3_dual":
            w = wgt(3, 3, 2 * c, o)
            wa, wb, b = w[:, :, :c], w[:, :, c:], bias(o)
            ho, cin, taps, wbytes = hu - 2, 2 * c, 9, _bytes(w)
        else:
            wa, wb, b = wgt(2, 2, c, o), wgt(2, 2, c, o), bias(o)
            ho, cin, taps = 2 * (hu - 1), c // 2, 9
            wbytes = 9 * cin * (o // 4) * 2
        fn = getattr(cf, name)
        kw = {"offset": (off, off)}
        got = fn(skip, up, wa, wb, b, **kw)
        rep = fn(skip.repeat(MC_S, 1, 1, 1), up, wa, wb, b, **kw)
        want = getattr(cf, f"{name}_plain")(skip, up, wa, wb, b, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, rep):
            raise AssertionError(f"{name} {label}: the broadcast skip "
                                 f"differs from the repeated one")
        _parity(f"N=16 {name} {label} skip batch {MC_B}", got, want)
        o_pub = o if name == "std_conv3x3_dual" else o // 4
        ops = conv_ops(n * ho * ho, cin, o_pub, taps)
        # the skip's crop that the outputs read, once an image of B
        crop = MC_B * (ho + 2) ** 2 * c * 2 // (
            1 if name == "std_conv3x3_dual" else 4)
        timed(name, f"{label} broadcast", lambda: fn(skip, up, wa, wb, b,
                                                     **kw),
              lambda: fn(skip.repeat(MC_S, 1, 1, 1), up, wa, wb, b, **kw),
              _bound_ms(crop + _bytes(up, got) + wbytes, ops),
              "repeat + kernel")
        del skip, up, got, rep, want
    # whole requests: serving.entry(mc_samples=8), 3 requests of B = 2
    torch.cuda.empty_cache()
    server, (x0,) = entry("cuda", batch=MC_B, mc_samples=MC_S)
    plain = MCServer(UNetS2DInference(server.model.cfg, ops=cf.PLAIN_OPS),
                     server.params, server.prepared, MC_S)
    reqs = [torch.rand(tuple(x0.shape), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3)]
    server(1, reqs[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cf.reset_launches()
    lat = []
    for i, x in enumerate(reqs):
        t0 = time.perf_counter()
        out = server(seed + i, x)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v for k, v in cf.launches.items() if v}
    peak = torch.cuda.max_memory_allocated()
    want = plain(seed + len(reqs) - 1, reqs[-1])
    torch.cuda.synchronize()
    mean_err = (out[0] - want[0]).abs().max().item()
    var_err = (out[1] - want[1]).abs().max().item()
    agree = 1.0 - (out[2] != want[2]).float().mean().item()
    print(f"[mc] serve B={MC_B} S={MC_S} {MC_HW}²: latency "
          f"{', '.join(f'{v:.2f}' for v in lat)} ms, peak {peak} B; "
          f"launches of {len(reqs)} requests {counts}; against the plain "
          f"versions: mean {mean_err:.2e}, var {var_err:.2e}, map agreement "
          f"{agree:.5f}")
    for k in cf.MC_ONLY:
        if counts.get(k) != len(reqs):
            raise AssertionError(f"{k} launched {counts.get(k)} times in "
                                 f"{len(reqs)} MC requests")
    if mean_err > REL_TOL or var_err > REL_TOL or agree < 0.99:
        raise AssertionError("the MC request differs from its plain "
                             "versions beyond bf16 rounding")
    rows.append({"name": "mc_request", "latency_ms": lat,
                 "memory_peak_bytes": peak, "launches": counts})
    return rows


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
    from segmentation_tpu_torch.nn.kernels import augment as aug
    from segmentation_tpu_torch.nn.kernels import conv_bwd as cb
    from segmentation_tpu_torch.nn.kernels import conv_flat as cf
    from segmentation_tpu_torch.nn.kernels import conv_int8 as ci
    from segmentation_tpu_torch.nn.kernels import train_glue as tg
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

    # ---- 3f. the MC-dropout request's kernels at the MC cell's sizes ---
    if sys.argv[1:] == ["mc"]:
        print(json.dumps({"mc": _mc_phase(cf)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    # ---- 3. kernel parity (N = 2 and B = 8) and timing (B = 8) ----------
    tables = _kernel_phase(cf, _sites)
    for mod, sites in ((ci, _sites8), (cb, _dgrad_sites), (tg, _glue_sites)):
        for table, part in zip(tables, _kernel_phase(mod, sites)):
            table.update(part)
    worst, ms, plain_ms, bound, bound_by, library_ms, packed = tables
    for k in SM90:
        if not ms[k]:  # H8's path modes: timed on a request (phase 4b)
            continue
        lib = "none" if library_ms[k] is None else f"{library_ms[k]:.4f} ms"
        gemm = " + ".join(f"{v / 1e9:.1f} G{'OP' if t == 's8' else 'FLOP'}"
                          for t, v in sorted(packed[k].items()))
        print(f"[kernels] {k} B={B_SERVE} over its sites: {ms[k]:.4f} ms, "
              f"plain {plain_ms[k]:.4f} ms, library {lib}, "
              f"bound {bound[k]:.4f} ms ({bound[k] / ms[k]:.3f} of it "
              f"reached), packed GEMM {gemm} "
              f"({_peak_words(packed[k], ms[k])})")
    # ---- 3d. n_kernels 64: level 2's 4O = 512 modes, H8 at O ≤ 1024 ----
    torch.cuda.empty_cache()
    tables64 = _kernel_phase(cf, _sites_n64)
    for mod, sites in ((cb, _dgrad_sites_n64), (tg, _glue_sites_n64)):
        for table, part in zip(tables64, _kernel_phase(mod, sites)):
            table.update(part)
    for k in SM90:
        if tables64[1].get(k):
            _, ms64, plain64, bound64, _, lib64, packed64 = tables64
            lib = "none" if lib64[k] is None else f"{lib64[k]:.4f} ms"
            print(f"[kernels] n64 {k} B={B_SERVE} over its 4O = 512 sites: "
                  f"{ms64[k]:.4f} ms, plain {plain64[k]:.4f} ms, library "
                  f"{lib}, bound {bound64[k]:.4f} ms ({bound64[k] / ms64[k]:.3f}"
                  f" of it reached), "
                  f"{_peak_words(packed64[k], ms64[k])}")
    by_path64 = _n64_path_phase(cf, cb, tg)
    torch.cuda.empty_cache()
    # ---- 3e. H9 at its six sites, both widths, B = 128 ------------------
    wgrad_rows = _wgrad_phase(cb)
    std_bf16_64 = _std_bf16_phase(cf, width=2)
    torch.cuda.empty_cache()
    std_bf16 = _std_bf16_phase(cf)
    torch.cuda.empty_cache()
    mc_rows = _mc_phase(cf)
    torch.cuda.empty_cache()
    exact = _entry_modes_agree(B_SERVE, generator(99, "cuda"))
    print(f"[kernels] B={B_SERVE} H5 against conv3entry_requant + H1 pool: "
          f"{'equal code for code' if exact else 'within one code'}")

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
    missing = [k for k, v in counts.items()
               if v == 0 and k not in cf.TRAIN_ONLY + cf.MC_ONLY]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    h8 = {k: counts[k] for k in STD_BF16}
    if h8 != {"std_conv3x3": 8 * len(reqs), "std_conv3x3_dual": 2 * len(reqs)}:
        raise AssertionError(f"H8 bf16 launches {h8} for {len(reqs)} "
                             f"requests")
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
    counts8 = {**cf.launches, **ci.launches}
    _check_route("serve_int8", counts8, len(reqs))
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
    e2e = {"bf16": bf16_e2e, "int8": _latency_line("int8", lat8, peak8)}
    std8 = _std_conv_phase("serve_int8", server8, reqs[0])
    del server8, plain8
    torch.cuda.empty_cache()

    # ---- 4c. the other int8 configurations ------------------------------
    by_path = {"serve_bf16": counts, "serve_int8": counts8}
    for tag, kw in (("serve_int8_4d", {"padflat": False}),
                    ("serve_int8_fdeconv", {"quant_deconvs": False})):
        by_path[tag], e2e[tag] = _int8_config_phase(
            tag, kw, reqs, calib, want, (oh, ow), reset_all)
        torch.cuda.empty_cache()

    # ---- 5. serving results ----------------------------------------------
    for tag, (mean, ips, mib) in e2e.items():
        print(f"[summary] {smi}: {tag} B={B_SERVE} latency {mean:.3f} ms, "
              f"{ips:.1f} img/s, peak {mib:.1f} MiB")
    h8 = {k: sum(s[k] for s in std8.values())
          for k in ("calls", "ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"[summary] {smi}: H8 std-level s8 conv {h8['calls']} launches a "
          f"request, {h8['ms']:.4f} ms (GEMM alone {h8['library_ms']:.4f} "
          f"ms, plain {h8['plain_ms']:.4f} ms), bound {h8['bound_ms']:.4f} "
          f"ms ({h8['bound_ms'] / h8['ms']:.3f} of it reached)")

    # ---- 6. the training slice -------------------------------------------
    train_counts, (k_ms, k_peak, p_ms, p_peak, busy) = _train_phase(cf, cb,
                                                                      tg)
    print(f"[summary] {smi}: train B={B_TRAIN} step kernels {k_ms:.3f} ms "
          f"({B_TRAIN * 1e3 / k_ms:.1f} img/s, peak {k_peak:.1f} MiB), plain "
          f"{p_ms:.3f} ms ({B_TRAIN * 1e3 / p_ms:.1f} img/s, peak "
          f"{p_peak:.1f} MiB); device busy share {busy:.3f}")

    # ---- 7. the data path ---------------------------------------------------
    torch.cuda.empty_cache()
    tiles = _data_tiles(16)
    h7_ms, h7_plain_ms, h7_bound_ms, h7_by, h7_err = _h7_phase(tiles)
    torch.cuda.empty_cache()
    data_counts, (d_ms, r_ms, d_busy, h2d, disk) = _data_phase(cf, cb, tg,
                                                                tiles)
    disk_txt = "disk phase skipped (no native loader)" if disk is None else (
        f"disk→step B={B_DISK} {disk[0]:.1f} img/s, the step alone "
        f"{disk[1]:.1f} img/s")
    print(f"[summary] {smi}: data B={B_TRAIN} step {d_ms:.3f} ms "
          f"({B_TRAIN * 1e3 / d_ms:.1f} img/s) vs {r_ms:.3f} ms on a "
          f"device-resident batch; busy share {d_busy:.3f}; pinned H2D "
          f"{h2d:.2f} GB/s; H7 {h7_ms:.4f} ms a step (bound "
          f"{h7_bound_ms:.4f} ms, plain {h7_plain_ms:.4f} ms); {disk_txt}")

    # launches: each path's counted run (the 4 bf16 requests, the 4
    # requests of each int8 configuration, the 5 timed B = 128 train steps
    # on device-resident batches and through the data path) per kernel
    # mode; ``launches`` is the data path's count where the kernel runs
    # there, else the training path's, else the sum over the serving
    # paths (the int8 modes: over the three int8 configurations)
    by_path.update(train=train_counts, data=data_counts)
    worst["crop_normalize"] = h7_err
    ms["crop_normalize"], plain_ms["crop_normalize"] = h7_ms, h7_plain_ms
    bound["crop_normalize"], bound_by["crop_normalize"] = h7_bound_ms, h7_by
    library_ms["crop_normalize"] = None  # no one PyTorch call computes it
    for k, s in std8.items():  # H8's path modes: a request's own launches
        worst[k], ms[k], plain_ms[k] = s["worst"], s["ms"], s["plain_ms"]
        bound[k], library_ms[k] = s["bound_ms"], s["library_ms"]
        bound_by[k] = max(s["parts"], key=s["parts"].get)
    for k, s in std_bf16[B_SERVE].items():  # H8 bf16: its ten sites, B = 8
        worst[k] = max(std_bf16[n][k]["worst"] for n in std_bf16)
        ms[k], plain_ms[k] = s["ms"], s["plain_ms"]
        bound[k], library_ms[k] = s["bound_ms"], s["library_ms"]
        bound_by[k] = max(s["parts"], key=s["parts"].get)
    kernels = []
    for k in cf.NAMES + ci.NAMES + cb.NAMES + tg.NAMES + aug.NAMES:
        paths = {tag: c[k] for tag, c in by_path.items() if k in c}
        launches = paths.get("data", paths.get("train", sum(paths.values())))
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": launches,
            "max_abs_err": worst[k], "ms": ms[k], "plain_ms": plain_ms[k],
            "bound_ms": bound[k], "bound_by": bound_by[k],
            "library_ms": library_ms[k], "launches_by_path": paths})
    print(json.dumps({"kernels": kernels}))
    # n_kernels 64's 4O = 512 modes and H8 bf16 at its widths: the sites of
    # phase 3d, the launches of its own train steps and requests
    worst64, ms64, plain64, bound64, by64, lib64, _ = tables64
    for k, s in std_bf16_64[B_SERVE].items():  # H8 bf16: its ten sites, B = 8
        worst64[k] = max(std_bf16_64[n][k]["worst"] for n in std_bf16_64)
        ms64[k], plain64[k] = s["ms"], s["plain_ms"]
        bound64[k], lib64[k] = s["bound_ms"], s["library_ms"]
        by64[k] = max(s["parts"], key=s["parts"].get)
    print(json.dumps({"kernels_n64": [
        {"name": k, "launches_by_path": {tag: c[k] for tag, c in
                                         by_path64.items() if k in c},
         "max_abs_err": worst64[k], "ms": ms64[k], "plain_ms": plain64[k],
         "bound_ms": bound64[k], "bound_by": by64[k],
         "library_ms": lib64[k]}
        for k in cf.NAMES + cb.NAMES + tg.NAMES if ms64[k]]}))
    print(json.dumps({"wgrad": wgrad_rows}))
    print(json.dumps({"mc": mc_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
