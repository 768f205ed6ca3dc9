"""Time source variants of the kernels on the Hopper mainloop (the bf16
forward of H1–H4, H6, the int8 modes of H1–H5 and H8) in turns on one
GPU.

    python -m segmentation_tpu_torch.profile_variants \
        [--variants base,no_store,...] [--rounds 2] [--parent DIR] \
        [--out FILE]

Each variant is a copy of this package with named source patches
(``VARIANTS``), made under ``csrc/build/variants/<name>/`` and built
there by its own process (all at once). The copies then time the ten
packed sites of the 512² forward (B = 8, chip_smoke.py's phase-3 shapes),
H6's six training sites, the int8 sites of H1–H5 (phase 3b's shapes) and
H8's ten sites of an int8 request (its launches' shapes in phase 4b; a
package without H8 skips them) — the K-major weight copies made here,
outside the timing, and passed only to a package whose wrappers take
them — each the least of 3
runs of 20 launches by CUDA events, in turns: the variants in order, then
in reverse, --rounds times. Before timing, each variant but the cut-outs
(``CUTS``, which compute garbage) is held against the plain versions at
the sites (int8 codes within one, on at most 1e-3 of them).
``--parent DIR`` adds the variant ``parent``: the package of another
checkout (DIR/segmentation_tpu_torch, unpatched, e.g. the parent commit
unpacked by ``git archive``), timed by this file's sites and loop.

The variants: ``base`` (the sources as they are); the cut-outs
``no_store`` (the forward kernels' epilogue stores nothing: H1–H4) and
``no_store_no_load`` (nor does the producer load: wgmma on whatever the
stages hold; H1–H4 and H6, whose stores stay); the epilogue designs of
the forward that were measured against the one kept: ``no_tma_store``
(4O = 128 stores y and the pool from registers, sm90::store_acc),
``no_pingpong`` (4O = 128 tiles of 256 rows split between the consumers,
stores from registers), ``pingpong_all`` (4O = 256 ping-pong too, tiles
of 64 rows); and the ring's depth: ``a_stages_3`` (three A slots, which
leaves 4O = 256 three B stages) and ``b_stages_8`` (up to eight B
stages, but shared memory leaves four at both widths, so it builds
base's kernels again: the spread between two builds of the same code);
and H3's gather: ``gather_regs_40`` (its producer warpgroup at the TMA
producer's 40 registers a thread instead of 96, two tasks of 8 loads a
pass), ``gather_tasks_2`` (two tasks a pass instead of four),
``no_l2_prefetch`` (no L2 prefetch of the next tile's input rows) and the
cut-out ``gather_no_load`` (the gather computes its addresses and stores
them, loading nothing); the int8 gather of H1 and H2 (the inline-quantize
modes, the skip at an odd offset): ``s8_gather_chunks_8`` (eight chunks a
thread in flight instead of four, its warpgroup at 96 registers) and the
cut-out ``s8_gather_no_quant`` (the loads and stores without the
quantize); H5's cut-outs ``entry_no_gather`` (its producer warps gather
nothing: conv1_1 runs on whatever the slots hold) and ``entry_no_conv1_1``
(no conv1_1 and no requant into the slot: conv1_2 reads the gathered bf16
rows as codes); H5's tiles ``entry_tile_wide`` (tile_plan's fewest
tiles of 127 rows, 1 × 126 at 512², for entry_tile_plan's 8 × 15); and
H8's gather of a bf16 side: the cut-outs ``std_quant_mul`` (the Pallas
multiply by f32(1/scale) in place of the division) and ``std_no_quant``
(the loads and stores without the quantize), ``std_chunks_8`` (eight
chunks a thread in flight, its warpgroup at 96 registers) and
``std_cols_128`` (column tiles of 128 at every O: tiles of 256 rows for
the single, 128 for the dual, where 256 columns take 128 and 64; the s8
and bf16 modes share the planner, so the variant's bf16 mode, which no
variant times, would refuse its tiles at O % 256 == 0).
"""

from __future__ import annotations

import argparse
import inspect
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

PKG = Path(__file__).resolve().parent
FWD = "csrc/packed_conv2x2_fwd.cuh"
SM90 = "csrc/sm90_igemm.cuh"
STRIDED = "csrc/strided_conv4x4s2.cu"
ENTRY = "csrc/entry_chain.cu"
IM2COL = "csrc/im2col.cuh"
STD = "csrc/std_conv3x3_s8.cu"
TILES = "nn/kernels/tiles.py"
FLAT = "nn/kernels/conv_flat.py"

# (file in the package, text, replacement, occurrences)
Patch = Tuple[str, str, str, int]
_PP = "  static constexpr bool PINGPONG = O4 == 128 && SIDES == 1;"
_BM = ("  static constexpr int BM = SPLIT_N ? 64 : 128;  // tiles: conv_flat, "
       "conv_int8")
_ROWS = "tile_plan(n, ho, wo, FWD_TILE_ROWS, halo, step)"
_NO_STORE: List[Patch] = [
    (FWD, "    if constexpr (TMA_STORE) {\n      // the staging is free",
     "    if (bias != nullptr || mul != nullptr) return;\n"
     "    if constexpr (TMA_STORE) {\n      // the staging is free", 1)]
_NO_LOAD: List[Patch] = [
    (SM90, "      mbar_expect_tx(r.a_full(a.stage), p.a_tx(kb));\n"
           "      p.load_a(t, kb, r.a(a.stage), r.a_full(a.stage));",
     "      mbar_expect_tx(r.a_full(a.stage), 0u);", 1),
    (SM90, "        mbar_expect_tx(r.b_full(b.stage), Ring<P>::B_BYTES);\n"
           "        p.load_b(t, kb, tap, r.b(b.stage), r.b_full(b.stage));",
     "        mbar_expect_tx(r.b_full(b.stage), 0u);", 1)]
CUTS = ("no_store", "no_store_no_load", "gather_no_load",
        "s8_gather_no_quant", "entry_no_gather", "entry_no_conv1_1",
        "std_quant_mul", "std_no_quant")
PARENT = "parent"  # another checkout's package (--parent), unpatched
VARIANTS: Dict[str, List[Patch]] = {
    "base": [],
    "no_store": _NO_STORE,
    "no_store_no_load": _NO_STORE + _NO_LOAD,
    "no_tma_store": [
        (FWD, "  static constexpr bool TMA_STORE = PINGPONG;",
         "  static constexpr bool TMA_STORE = false;", 1)],
    "no_pingpong": [
        (FWD, _PP, _PP.replace("O4 == 128", "false"), 1),
        (FWD, _BM, "  static constexpr int BM = SPLIT_N ? 64 : 128 * MI;",
         1),
        (FLAT, _ROWS, _ROWS.replace("FWD_TILE_ROWS",
                                    "{128: 256, 256: 128}[o4]"), 1)],
    "pingpong_all": [
        (FWD, _PP, _PP.replace("O4 == 128", "true"), 1),
        (FWD, _BM, "  static constexpr int BM = SIDES == 2 ? (SPLIT_N ? 64 "
                   ": 128) : 64 * MI;", 1),
        (FLAT, _ROWS, _ROWS.replace("FWD_TILE_ROWS",
                                    "{128: 128, 256: 64}[o4]"), 1)],
    "b_stages_8": [
        (FWD, "        NB * 128, 4);", "        NB * 128, 8);", 1)],
    "a_stages_3": [
        (FWD, "  static constexpr int A_STAGES = 2;",
         "  static constexpr int A_STAGES = 3;", 1)],
    "gather_regs_40": [
        (STRIDED, "PRODUCER_REGS = BOX ? sm90::kProducerRegs : 96;",
         "PRODUCER_REGS = BOX ? sm90::kProducerRegs : 40;", 1),
        (STRIDED, "GATHER_TASKS = MODE == kHalves ? 2 : 4;",
         "GATHER_TASKS = 2;", 1)],
    "gather_tasks_2": [
        (STRIDED, "GATHER_TASKS = MODE == kHalves ? 2 : 4;",
         "GATHER_TASKS = 2;", 1)],
    "gather_no_load": [
        (IM2COL, "return __ldg(reinterpret_cast<const unsigned int*>(p));",
         "return (uint32_t)(uintptr_t)p;", 1)],
    "no_l2_prefetch": [
        (STRIDED, "      if (kb == 0) prefetch_rows(t + gridDim.x, tid, "
                  "nthreads);\n", "", 1)],
    "s8_gather_chunks_8": [
        (FWD, "  static constexpr int GATHER_CHUNKS = 4;",
         "  static constexpr int GATHER_CHUNKS = 8;", 1),
        (FWD, "PRODUCER_REGS = GATHER ? 80 : sm90::kProducerRegs;",
         "PRODUCER_REGS = GATHER ? 96 : sm90::kProducerRegs;", 1)],
    "s8_gather_no_quant": [
        (FWD, "{ return quant16(lo, hi, inv); }",
         "{ return make_uint4(lo.x ^ hi.x, 0, 0, 0); }", 1)],
    "entry_no_gather": [
        (ENTRY, "    p.img.template gather<P::GATHER_TASKS>(s.a(a.stage), 0, "
                "n, i0, j0, eh,\n", "    if (eh < 0)\n"
                "    p.img.template gather<P::GATHER_TASKS>(s.a(a.stage), 0, "
                "n, i0, j0, eh,\n", 1)],
    "entry_no_conv1_1": [
        (ENTRY, "    entry_conv1_1(p, slot, d_w4);\n", "", 1)],
    "entry_tile_wide": [
        (TILES, "    return TilePlan(n, ho, wo, -(-ho // nh), -(-wo // nw))\n",
         "    return tile_plan(n, ho, wo, ENTRY_TILE_ROWS - 1)\n", 1)],
    "std_quant_mul": [
        (STD, "quant16<true>(lo, hi, scale);",
         "quant16<false>(lo, hi, 1.0f / scale);", 1)],
    "std_no_quant": [
        (STD, "quant16<true>(lo, hi, scale);",
         "make_uint4(lo.x ^ hi.x, 0, 0, 0);", 1)],
    "std_cols_128": [
        (STD, "  return a.o % 256 == 0 ? run_std<256, DUAL, BF16_OUT, "
              "HALF>(a)\n                        : run_std<128, DUAL, "
              "BF16_OUT, HALF>(a);",
         "  return run_std<128, DUAL, BF16_OUT, HALF>(a);", 1),
        (TILES, "    nb = 256 if o % 256 == 0 else 128", "    nb = 128", 1)],
    "std_chunks_8": [
        (STD, "  static constexpr int GATHER_CHUNKS = 4;",
         "  static constexpr int GATHER_CHUNKS = 8;", 1),
        (STD, "PRODUCER_REGS = GATHER ? 80 : sm90::kProducerRegs;",
         "PRODUCER_REGS = GATHER ? 96 : sm90::kProducerRegs;", 1)],
}


def patched(name: str) -> Dict[str, str]:
    """The patched text of each file a variant changes; raises if a patch
    does not find its text exactly as often as it expects."""
    out: Dict[str, str] = {}
    for rel, old, new, count in VARIANTS[name]:
        text = out.get(rel, (PKG / rel).read_text())
        if text.count(old) != count:
            raise ValueError(f"variant {name}: {rel} holds {old!r} "
                             f"{text.count(old)} times, not {count}")
        out[rel] = text.replace(old, new)
    return out


def make(name: str, work: Path, source: Path = PKG) -> Path:
    """Copy the package at ``source`` to work/<name>/ with the variant's
    patches (none for ``parent``); return the directory to put first on
    sys.path."""
    root = work / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(source, root / PKG.name,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    if name != PARENT:
        for rel, text in patched(name).items():
            (root / PKG.name / rel).write_text(text)
    return root


def _sites(gen):
    """(op, label, args, kwargs) at the 512² sites, B = 8: H1–H4 as
    chip_smoke.py's phase 3, H6 as its phase 3c."""
    import torch

    dev = gen.device

    def act(*s):
        return torch.rand(s, generator=gen, device=dev).to(torch.bfloat16)

    def wgt(*s):
        k = 1
        for v in s[:-1]:
            k *= v
        return (torch.randn(s, generator=gen, device=dev) / k**0.5).to(
            torch.bfloat16)

    def bias(o4):
        return torch.randn((o4,), generator=gen, device=dev) * 0.1

    def cot(*s):
        g = torch.randn(s, generator=gen, device=dev)
        return (g * (torch.rand(s, generator=gen, device=dev) > 0.5)).to(
            torch.bfloat16)

    head = (wgt(128, 4), torch.randn((4,), generator=gen, device=dev))
    n = 8
    return [
        ("strided_conv4x4s2", "conv1_1 C=3",
         (act(n, 512, 512, 3), wgt(4, 4, 3, 128), bias(128)), {}),
        ("strided_conv4x4s2", "conv2_1 C=32",
         (act(n, 254, 254, 32), wgt(4, 4, 32, 256), bias(256)), {}),
        ("rows_matmul", "upconv3 identity",
         (act(n, 84, 84, 128), wgt(128, 256), bias(256)),
         {"scatter": False}),
        ("rows_matmul", "upconv4 scatter",
         (act(n, 82, 82, 256), wgt(64, 128), bias(128)), {"scatter": True}),
        ("packed_conv2x2", "conv1_2 +pool",
         (act(n, 255, 255, 128), wgt(2, 2, 128, 128), bias(128)),
         {"pool": True}),
        ("packed_conv2x2", "conv2_2 +pool",
         (act(n, 126, 126, 256), wgt(2, 2, 256, 256), bias(256)),
         {"pool": True}),
        ("packed_conv2x2_dual", "conv8_1 odd phase (41,41)",
         (act(n, 125, 125, 256), act(n, 84, 84, 256), wgt(2, 2, 256, 256),
          wgt(2, 2, 256, 256), bias(256)), {"offset": (41, 41)}),
        ("packed_conv2x2", "conv8_2",
         (act(n, 83, 83, 256), wgt(2, 2, 256, 256), bias(256)), {}),
        ("packed_conv2x2_dual", "conv9_1 even (90,90)",
         (act(n, 254, 254, 128), act(n, 164, 164, 128),
          wgt(2, 2, 128, 128), wgt(2, 2, 128, 128), bias(128)),
         {"offset": (90, 90)}),
        ("packed_conv2x2", "conv9_2 head_only",
         (act(n, 163, 163, 128), wgt(2, 2, 128, 128), bias(128)),
         {"head": head, "head_only": True}),
        ("packed_conv2x2_dgrad", "conv1_2",
         (cot(n, 254, 254, 128), wgt(2, 2, 128, 128)), {}),
        ("packed_conv2x2_dgrad", "conv2_2",
         (cot(n, 125, 125, 256), wgt(2, 2, 256, 256)), {}),
        ("packed_conv2x2_dgrad_dual", "conv8_1",
         (cot(n, 83, 83, 256), wgt(2, 2, 256, 256), wgt(2, 2, 256, 256)),
         {}),
        ("packed_conv2x2_dgrad", "conv8_2",
         (cot(n, 82, 82, 256), wgt(2, 2, 256, 256)), {}),
        ("packed_conv2x2_dgrad_dual", "conv9_1",
         (cot(n, 163, 163, 128), wgt(2, 2, 128, 128), wgt(2, 2, 128, 128)),
         {}),
        ("packed_conv2x2_dgrad", "conv9_2",
         (cot(n, 162, 162, 128), wgt(2, 2, 128, 128)), {}),
    ] + _sites8(gen, n)


def _sites8(gen, n):
    """The int8 sites of H5, H3, H1 and H2 (chip_smoke.py's phase 3b): s8
    codes, bf16 operands at act_scale 1/16 for the inline modes, s8 weights
    with their K-major copies (``wk``, ``wka``, ``wkb``, ``wk4``), epilogue
    vectors that spread the codes over their range. The op is the kernel
    mode (conv_int8.NAMES)."""
    import torch

    dev = gen.device

    def codes(*s):
        return torch.randint(0, 128, s, generator=gen, device=dev,
                             dtype=torch.int8)

    def acts(*s):
        return (torch.rand(s, generator=gen, device=dev) * (150 / 16)).to(
            torch.bfloat16)

    def wq(*s):
        return torch.randint(-127, 128, s, generator=gen, device=dev,
                             dtype=torch.int8)

    def kmaj(w):
        return w.reshape(-1, w.shape[-1]).t().contiguous()

    from segmentation_tpu_torch.nn.kernels import conv_int8 as ci

    def h3(op, label, x, c, o4, kw):
        w = wq(4, 4, c, o4)
        if hasattr(ci, "strided_k_major"):  # a package that reads wk4
            kw = {**kw, "wk4": ci.strided_k_major(w)}
        return (op, label, (x, w, *vecs(o4, 16 * c)), kw)

    def vecs(o4, k, scale=1.0):
        mul = (torch.rand((o4,), generator=gen, device=dev) + 0.5) \
            * (60.0 / (5376.0 * k**0.5) * scale)
        return mul, torch.randn((o4,), generator=gen, device=dev) * 10 * scale

    def h1(op, label, x, o4, kw, scale=1.0):
        w = wq(2, 2, x.shape[-1], o4)
        return (op, label, (x, w, *vecs(o4, 4 * x.shape[-1], scale)),
                {**kw, "wk": kmaj(w)})

    def h4(op, label, x, c, o4, kw):
        w = wq(c, o4)
        return (op, label, (x, w, *vecs(o4, c)), {**kw, "wkm": kmaj(w)})

    def h8(label, x, o, out_bf16=False):
        w = wq(3, 3, x.shape[-1], o)
        mul, add = vecs(o, 9 * x.shape[-1], 1 / 20 if out_bf16 else 1.0)
        return ("std_conv3x3_s8", label, (x, w, mul, add),
                {"requant": not out_bf16, "wk": kmaj(w)})

    def h8_dual(label, skip, up, offset):
        # the bf16 up side as a deconv's ReLU leaves it: half of it zeros
        up = up * (torch.rand(up.shape, generator=gen, device=dev) > 0.5)
        c, o = up.shape[-1], up.shape[-1]
        wa, wb = wq(3, 3, c, o), wq(3, 3, c, o)
        (cs_a, _), (cs_b, b) = vecs(o, 18 * c), vecs(o, 18 * c)
        return ("std_conv3x3_dual_s8_inline", label,
                (skip, up, wa, wb, cs_a, cs_b, b),
                {"offset": offset, "out_scale": 1.0, "act_scale_b": 1 / 16,
                 "wka": kmaj(wa), "wkb": kmaj(wb)})

    def h2(op, label, skip, up, o4, offset, act_b=None):
        c4 = up.shape[-1]
        wa, wb = wq(2, 2, c4, o4), wq(2, 2, c4, o4)
        (cs_a, _), (cs_b, add) = vecs(o4, 8 * c4), vecs(o4, 8 * c4)
        kw = {"offset": offset, "wka": kmaj(wa), "wkb": kmaj(wb)}
        if act_b is not None:
            kw["act_scale_b"] = act_b
        return (op, label, (skip, up, wa, wb, cs_a, cs_b,
                            torch.ones((o4,), device=dev), add), kw)

    head = ((torch.randn((128, 4), generator=gen, device=dev) / 128**0.5)
            .to(torch.bfloat16), torch.randn((4,), generator=gen, device=dev))
    img = torch.rand((n, 512, 512, 3), generator=gen, device=dev).to(
        torch.bfloat16)
    w4 = (torch.randn((4, 4, 3, 128), generator=gen, device=dev)
          / 48**0.5).to(torch.bfloat16)
    mul1 = torch.full((128,), 100.0, device=dev)
    add1 = torch.randn((128,), generator=gen, device=dev) * 10
    wq2 = wq(2, 2, 128, 128)
    return [
        ("entry_chain", "level 1", (img, w4, mul1, add1, wq2,
                                    *vecs(128, 512)), {"wk": kmaj(wq2)}),
        ("conv3entry_requant", "conv1_1 bf16 -> s8",
         (img, w4, mul1, add1), {}),
        h3("conv3entry_s8", "conv1_1 s8 image codes", codes(n, 512, 512, 3),
           3, 128, {}),
        h3("strided_conv4x4s2_s8", "conv2_1 C=32", codes(n, 254, 254, 32),
           32, 256, {}),
        h3("strided_conv4x4s2_s8_inline", "conv2_1 C=32 bf16 in",
           acts(n, 254, 254, 32), 32, 256, {"act_scale": 1 / 16}),
        h1("packed_conv2x2_s8_pool", "conv1_2 +pool (4-D route)",
           codes(n, 255, 255, 128), 128, {"pool": True}),
        h1("packed_conv2x2_s8_pool", "conv2_2 +pool",
           codes(n, 126, 126, 256), 256, {"pool": True}),
        h1("packed_conv2x2_s8_inline", "conv2_2 bf16 in +pool",
           acts(n, 126, 126, 256), 256, {"pool": True, "act_scale": 1 / 16}),
        h1("packed_conv2x2_s8", "conv8_2", codes(n, 83, 83, 256), 256, {}),
        h1("packed_conv2x2_s8", "conv9_2 head_only (bf16 value)",
           codes(n, 163, 163, 128), 128,
           {"requant": False, "head": head, "head_only": True}, 1 / 20),
        h2("packed_conv2x2_dual_s8", "conv8_1 odd phase (41,41)",
           codes(n, 125, 125, 256), codes(n, 84, 84, 256), 256, (41, 41)),
        h2("packed_conv2x2_dual_s8_inline",
           "conv8_1 odd phase (41,41) bf16 up", codes(n, 125, 125, 256),
           acts(n, 84, 84, 256), 256, (41, 41), 1 / 16),
        h2("packed_conv2x2_dual_s8", "conv9_1 even (90,90)",
           codes(n, 254, 254, 128), codes(n, 164, 164, 128), 128, (90, 90)),
        h2("packed_conv2x2_dual_s8_inline", "conv9_1 even (90,90) bf16 up",
           codes(n, 254, 254, 128), acts(n, 164, 164, 128), 128, (90, 90),
           1 / 16),
        h4("rows_matmul_s8", "upconv3 identity", codes(n, 84, 84, 128), 128,
           256, {"scatter": False}),
        h4("rows_matmul_s8_inline", "upconv3 identity bf16 in",
           acts(n, 84, 84, 128), 128, 256,
           {"scatter": False, "act_scale": 1 / 16}),
        h4("rows_matmul_s8", "upconv4 scatter", codes(n, 82, 82, 256), 64,
           128, {"scatter": True}),
        h4("rows_matmul_s8_inline", "upconv4 scatter bf16 in",
           acts(n, 82, 82, 256), 64, 128,
           {"scatter": True, "act_scale": 1 / 16}),
        h8("conv3_1", codes(n, 125, 125, 64), 128),
        h8("conv3_2", codes(n, 123, 123, 128), 128),
        h8("conv4_1", codes(n, 60, 60, 128), 256),
        h8("conv4_2", codes(n, 58, 58, 256), 256),
        h8("conv5_1", codes(n, 28, 28, 256), 512),
        h8("conv5_2 bf16 out", codes(n, 26, 26, 512), 512, True),
        h8_dual("conv6_1 (4,4) bf16 up", codes(n, 56, 56, 256),
                acts(n, 48, 48, 256), (4, 4)),
        h8("conv6_2 bf16 out", codes(n, 46, 46, 256), 256, True),
        h8_dual("conv7_1 (16,16) bf16 up", codes(n, 121, 121, 128),
                acts(n, 88, 88, 128), (16, 16)),
        h8("conv7_2", codes(n, 86, 86, 128), 128),
    ]


def run_variant(name: str, mode: str) -> None:
    """In a variant's own process (its copy first on sys.path): "build",
    "check" (the sites against the plain versions) or "time"."""
    import torch

    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.nn.kernels import _build
    from segmentation_tpu_torch.nn.kernels import conv_bwd as cb
    from segmentation_tpu_torch.nn.kernels import conv_flat as cf
    from segmentation_tpu_torch.nn.kernels import conv_int8 as ci

    if f"variants/{name}/" not in Path(_build.__file__).as_posix():
        raise RuntimeError(f"{name}: imported {_build.__file__}")
    _build.library()
    if mode == "build":
        print(f"[{name}] built in {_build.build_seconds:.1f} s")
        return
    sums: Dict[str, float] = {}
    for op, label, args, kw0 in _sites(generator(15, "cuda")):
        if op.startswith("std_conv3x3") and op not in ci.NAMES:
            continue  # a package without H8 (a parent's)
        mod = cb if "dgrad" in op else ci if op in ci.NAMES else cf
        fn = getattr(mod, ci.wrapper_of(op) if mod is ci else op)
        # a package whose wrappers take no K-major copy gets none
        params = inspect.signature(fn).parameters
        kw = {k: v for k, v in kw0.items() if k in params}
        got = fn(*args, **kw)
        if mode == "check":
            want = getattr(mod, fn.__name__ + "_plain")(*args, **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want, strict=True):
                if g.dtype == torch.int8:
                    d = (g.int() - w.int()).abs()
                    bad = d.max().item()
                    ok = bad <= 1 and (d > 0).float().mean().item() <= 1e-3
                elif g.dtype == torch.uint8:
                    bad = (g != w).float().mean().item()
                    ok = bad < 0.01
                else:
                    bad = (g.float() - w.float()).abs().max().item()
                    ok = bad <= 2e-2 * w.float().abs().max().item()
                if not ok:
                    raise AssertionError(f"{name} {op} {label}: {bad}")
            continue
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(3):
            start.record()
            for _ in range(20):
                fn(*args, **kw)
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 20)
        sums[op] = sums.get(op, 0.0) + best
        print(f"[{name}] {op} {label}: {best:.4f} ms")
    if mode == "check":
        print(f"[{name}] agrees with the plain versions")
    else:
        print(f"[{name}] sums: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in sums.items()))


def _spawn(root: Path, name: str, mode: str, timeout: float):
    """run_variant of this file (not the copy's: a parent checkout has its
    own) in a process that imports the package from the copy at root."""
    cmd = [sys.executable, "-c",
           "import sys, importlib.util as u; sys.path.insert(0, sys.argv[1]); "
           "s = u.spec_from_file_location('profile_variants_run', "
           "sys.argv[4]); m = u.module_from_spec(s); s.loader.exec_module(m); "
           "m.run_variant(sys.argv[2], sys.argv[3])", str(root), name, mode,
           str(Path(__file__).resolve())]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), timeout


def _finish(proc, timeout: float) -> Tuple[int, str]:
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        return -1, out + "\n[timed out]"
    return proc.returncode, out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--parent", default=None,
                    help="a checkout whose package is timed as 'parent'")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if PARENT in names and not args.parent:
        raise SystemExit("profile_variants: the variant parent needs --parent")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_variants: needs an NVIDIA GPU")
    work = PKG / "csrc" / "build" / "variants"
    source = {PARENT: Path(args.parent or ".") / PKG.name}
    roots = {n: make(n, work, source.get(n, PKG)) for n in names}
    lines: List[str] = [subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()]

    def say(text):
        print(text, flush=True)
        lines.append(text)

    say(lines[0])
    builds = {n: _spawn(roots[n], n, "build", 900) for n in names}
    ok = []
    for n, (proc, timeout) in builds.items():
        rc, out = _finish(proc, timeout)
        say(out.strip().splitlines()[-1] if out.strip() else f"[{n}] rc {rc}")
        if rc == 0:
            ok.append(n)
    good = []
    for n in ok:  # a variant that hangs or disagrees is not timed
        if n in CUTS:
            good.append(n)
            continue
        rc, out = _finish(*_spawn(roots[n], n, "check", 120))
        say(out.strip().splitlines()[-1] if out.strip() else f"[{n}] rc {rc}")
        if rc == 0:
            good.append(n)
    for _ in range(args.rounds):
        for n in good + good[::-1]:
            rc, out = _finish(*_spawn(roots[n], n, "time", 180))
            for line in out.strip().splitlines():
                say(line)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
