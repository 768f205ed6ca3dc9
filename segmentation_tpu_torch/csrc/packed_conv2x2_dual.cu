// H2 packed_conv2x2_dual: the concat-free first decoder conv of a packed
// level, conv2x2(crop(skip), wa) + conv2x2(up, wb), on the Hopper mainloop
// (packed_conv2x2_fwd.cuh: K = [skip taps | up taps], TMA halo boxes of
// either side, the skip's crop folded into each box's origin and channel,
// wgmma, warp-specialised, persistent):
//   bf16: one f32 accumulator over both sides, + f32 bias, ReLU, bf16;
//   s8:   s8 wgmma on the K-major copies of wa and wb into one s32
//         accumulator per side (the sides are quantized at different
//         scales; the consumers switch accumulators at the side boundary),
//         mixed in f32 as acc_a * cs_a + acc_b * cs_b, then the int8
//         epilogue relu(mix * mul + add) requantized to s8. Each side is s8
//         codes (a TMA box of 128 channels; the skip at an odd offset
//         gathered, 16 channels at a time) or bf16 gathered and quantized
//         as it is stored (inv_a, inv_b: the inline-quantize modes; the b
//         side is the bf16 deconv output when the deconvs run in bf16).
// skip [N, hpa, wpa, 4C] is read through a center crop at UNPACKED offset
// (oh, ow): output slot (d, e) of packed pixel (i, j) reads the skip at
// unpacked (oh + 2i + d, ow + 2j + e), i.e. packed pixel
// ((oh + d) // 2 + i, (ow + e) // 2 + j), slot ((oh + d) % 2, (ow + e) % 2).
// Even offsets are a plain packed slice; odd offsets are the slot phase.
// One address rule covers both, so the cropped skip and the concat are
// never materialised; an inline-quantized skip is quantized after this
// gather, which commutes with it (the quantize is elementwise).
//
// Replaces the TPU kernels segmentation_tpu/nn/pallas/conv_flat.py
// conv2x2_dual_padflat (:503; even offset or a_slot_phase) and
// conv2x2_dual_pf2 (:1379; slot-even offsets in the paired layout), and of
// the 4-D route nn/pallas/conv.py conv2x2_dual_flat (:677; same shape, or
// the crop folded in as an even offset or a slot phase): float,
// int8-resident and inline-quantize (act_scale_a, act_scale_b) modes.
//
// Bound on the H100: bytes, as H1's (K = 2 * 4 * 4C against 4O columns,
// the output the size of one input). bf16 at 4O = 512 (n_kernels 64's
// conv8_1, C % 64 == 0 or an even crop): two column tiles a pixel tile
// (packed_conv2x2_fwd.cuh). The s8 mode keeps both accumulators
// in registers: m64n128 a side, the tile's rows split between the
// consumers at 4O = 128, its columns at 4O = 256 (64-row tiles). An inline
// side reads 2 bytes an element where a resident side reads 1.
#include "packed_conv2x2_fwd.cuh"

namespace segk {

// The int8 problem's operands, as the C entry takes them.
struct DualS8 {
  const void *skip, *up, *wka, *wkb, *cs_a, *cs_b, *mul, *add;
  void* y;
  int n, hpa, wpa, hp, wp, c4, oh, ow, th, tw;
  float inv_a, inv_b;
  cudaStream_t stream;
};

// GATHER: a side's K blocks are gathered (ga: the skip at an odd offset,
// or in bf16; gb: up in bf16), the others boxed.
template <int O4, bool GATHER>
int dual_s8(const DualS8& a, bool ga, bool gb) {
  FwdTiles<O4, true, kInt8 | kRequant | kTwoAcc, GATHER> p{};
  int e = fwd_maps_s8(&p.xmap, &p.wmap, gb ? nullptr : a.up, a.wkb, a.n,
                      a.hp, a.wp, a.c4, O4, a.th, a.tw);
  if (e == 0)
    e = fwd_maps_s8(&p.smap, &p.wsmap, ga ? nullptr : a.skip, a.wka, a.n,
                    a.hpa, a.wpa, a.c4, O4, a.th, a.tw);
  if (e != 0) return e;
  p.cs_a = (const float*)a.cs_a;
  p.cs_b = (const float*)a.cs_b;
  p.mul = (const float*)a.mul;
  p.add = (const float*)a.add;
  p.y = (s8*)a.y;
  p.skip = (const uint8_t*)a.skip;
  p.xs = (const uint8_t*)a.up;
  p.ga = ga;
  p.gb = gb;
  p.inv_a = a.inv_a;
  p.inv_b = a.inv_b;
  p.hx = a.hp;
  p.wx = a.wp;
  p.hpa = a.hpa;
  p.wpa = a.wpa;
  p.oh = a.oh;
  p.ow = a.ow;
  return fwd_launch(p, a.n, a.hp - 1, a.wp - 1, a.c4, a.th, a.tw, a.stream);
}

template <int O4>
int dual_s8_sides(const DualS8& a) {
  const bool ga = a.inv_a > 0.0f || ((a.oh | a.ow) & 1) != 0;
  const bool gb = a.inv_b > 0.0f;
  return ga || gb ? dual_s8<O4, true>(a, ga, gb)
                  : dual_s8<O4, false>(a, false, false);
}

}  // namespace segk

// skip [n, hpa, wpa, c4], up [n, hp, wp, c4] bf16 (c4 % 32 == 0); wa, wb
// [4*c4, o4] bf16; bias [o4] f32; y [n, hp-1, wp-1, o4] bf16; (oh, ow) the
// unpacked crop offset, which the skip covers; (th, tw) the output tile
// from tiles.tile_plan; o4 = 128 or 256, or 512 where the skip is boxed (C
// % 64 == 0 or an even offset). Every pointer 16-byte aligned.
extern "C" int seg_packed_conv2x2_dual(const void* skip, const void* up,
                                       const void* wa, const void* wb,
                                       const void* bias, void* y, int n,
                                       int hpa, int wpa, int hp, int wp,
                                       int c4, int o4, int oh, int ow,
                                       int th, int tw, void* stream) {
  using namespace segk;
  if (c4 < 32 || c4 % 32 || n < 1 || hp < 2 || wp < 2 || oh < 0 || ow < 0 ||
      oh + 2 * hp > 2 * hpa || ow + 2 * wp > 2 * wpa || th < 1 || tw < 1 ||
      th > 255 || tw > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool slot = (c4 / 4) % 64 == 0, odd = (oh | ow) & 1;
  auto run = [&](auto& p) {
    int e = fwd_maps(&p.xmap, &p.wmap, up, wb, n, hp, wp, c4, o4, th, tw);
    if (e == 0)
      e = fwd_maps(&p.smap, &p.wsmap, skip, wa, n, hpa, wpa, c4, o4, th, tw);
    if (e != 0) return e;
    p.bias = (const float*)bias;
    p.y = (bf16*)y;
    p.skip = (const uint8_t*)skip;
    p.ga = 1;  // the gathered problem gathers the skip, boxes up
    p.hpa = hpa;
    p.wpa = wpa;
    p.oh = oh;
    p.ow = ow;
    p.slot = slot;
    return fwd_launch(p, n, hp - 1, wp - 1, c4, th, tw, s);
  };
  if (o4 == 128) {
    if (odd && !slot) {
      FwdTiles<128, true, 0, true> p{};
      return run(p);
    }
    FwdTiles<128, true> p{};
    return run(p);
  }
  if (o4 == 256) {
    if (odd && !slot) {
      FwdTiles<256, true, 0, true> p{};
      return run(p);
    }
    FwdTiles<256, true> p{};
    return run(p);
  }
  if (o4 == 512 && !(odd && !slot)) {
    FwdTiles<512, true> p{};
    return run(p);
  }
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: skip, up s8 codes (c4 % 64 == 0: a 16-byte chunk of the
// skip stays in one slot), or a side in bf16 quantized as it is gathered
// where its inverse scale inv_a / inv_b = f32(1 / act_scale_a / _b) is not
// 0; wka, wkb [o4, 4*c4] s8, the K-major copies of the weights [2, 2, c4,
// o4] (conv_int8.k_major); cs_a, cs_b, mul, add [o4] f32; y s8; (th, tw)
// the output tile from tiles.tile_plan over 128 GEMM rows at o4 = 128, 64
// at o4 = 256 (conv_int8.dual_tile_rows). Every pointer 16-byte aligned.
extern "C" int seg_packed_conv2x2_dual_s8(
    const void* skip, const void* up, const void* wka, const void* wkb,
    const void* cs_a, const void* cs_b, const void* mul, const void* add,
    void* y, int n, int hpa, int wpa, int hp, int wp, int c4, int o4, int oh,
    int ow, float inv_a, float inv_b, int th, int tw, void* stream) {
  using namespace segk;
  if (c4 < 64 || c4 % 64 || n < 1 || hp < 2 || wp < 2 || oh < 0 || ow < 0 ||
      oh + 2 * hp > 2 * hpa || ow + 2 * wp > 2 * wpa || th < 1 || tw < 1 ||
      th > 255 || tw > 255)
    return (int)cudaErrorInvalidValue;
  const DualS8 a{skip, up, wka, wkb, cs_a,  cs_b,  mul, add,
                 y,    n,  hpa, wpa, hp,    wp,    c4,  oh,
                 ow,   th, tw,  inv_a, inv_b, (cudaStream_t)stream};
  if (o4 == 128) return dual_s8_sides<128>(a);
  if (o4 == 256) return dual_s8_sides<256>(a);
  return (int)cudaErrorInvalidValue;
}
