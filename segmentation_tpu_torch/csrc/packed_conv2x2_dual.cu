// H2 packed_conv2x2_dual: the concat-free first decoder conv of a packed
// level, conv2x2(crop(skip), wa) + conv2x2(up, wb).
//   bf16: one f32 accumulator over both sides, + f32 bias, ReLU, bf16, on
//         the Hopper mainloop (packed_conv2x2_fwd.cuh: K = [skip taps | up
//         taps], TMA halo boxes of either side, the skip's crop folded into
//         each box's origin and channel, wgmma, warp-specialised,
//         persistent);
//   s8:   one s32 accumulator per side (the sides are quantized at
//         different scales), mixed in f32 as acc_a * cs_a + acc_b * cs_b,
//         then the int8 epilogue relu(mix * mul + add) requantized to s8.
//         Each side is s8 codes or bf16 quantized as it loads (inv_a,
//         inv_b: the inline-quantize modes; the b side is the bf16 deconv
//         output when the deconvs run in bf16). On the WMMA core.
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
// the output the size of one input). The s8 mode stages the skip side's
// scaled partial in a second shared-memory tile instead of a second
// register accumulator. An inline side reads 2 bytes an element where a
// resident side reads 1.
#include "igemm.cuh"
#include "packed_conv2x2_fwd.cuh"

namespace segk {

// Per output pixel: (n, i) and j of the output packed grid.
struct PixRow {
  long long n;
  int i, j;
  bool ok;
};

// The skip side, k in [0, 4 * c4): tap (u, v) = (k / c4 >> 1, & 1), then
// the crop rule above for the output slot of channel k % c4.
template <class T>
struct SkipSide {
  const T* skip;
  int hpa, wpa;  // skip packed grid
  int c4, cs;    // 4C and C
  int oh, ow;    // crop offset, unpacked units
  using Row = PixRow;
  __device__ __forceinline__ uint4 load(const Row& r, int k) const {
    const int tap = k / c4;
    const int cc = k - tap * c4;
    const int s = cc / cs;  // output slot (d, e) = (s >> 1, s & 1)
    const int ch = cc - s * cs;
    const int yy = oh + 2 * (r.i + (tap >> 1)) + (s >> 1);
    const int xx = ow + 2 * (r.j + (tap & 1)) + (s & 1);
    const T* p =
        skip + ((r.n * hpa + (yy >> 1)) * (long long)wpa + (xx >> 1)) * c4 +
        (2 * (yy & 1) + (xx & 1)) * cs + ch;
    return *reinterpret_cast<const uint4*>(p);
  }
};

// The up side, k in [0, 4 * c4): the 2x2 taps of the packed conv.
template <class T>
struct UpSide {
  const T* up;
  int hp, wp, c4;  // up packed grid
  using Row = PixRow;
  __device__ __forceinline__ uint4 load(const Row& r, int k) const {
    const int tap = k / c4;
    const int c = k - tap * c4;
    const T* p = up +
                 ((r.n * hp + r.i + (tap >> 1)) * (long long)wp + r.j +
                  (tap & 1)) * c4 + c;
    return *reinterpret_cast<const uint4*>(p);
  }
};

// A = [skip taps | up taps] over K = 2 * ka: a side loader each (SkipSide,
// UpSide, or QuantLoader over one of them for a bf16 side of an s8 core).
template <class SA, class SB>
struct DualLoader {
  SA a;
  SB b;
  int ka;      // 4 * 4C, one side's K
  int ho, wo;  // output packed grid
  using Row = PixRow;
  __device__ __forceinline__ Row row(long long m, bool ok) const {
    Row r{0, 0, 0, ok};
    if (ok) {
      const Pix q = decode(m, ho, wo);
      r.n = q.n;
      r.i = q.i;
      r.j = q.j;
    }
    return r;
  }
  __device__ __forceinline__ uint4 load(const Row& r, int k) const {
    return k < ka ? a.load(r, k) : b.load(r, k - ka);
  }
};

// Shared memory: the core's buffers, then the f32 skip-side partial P.
template <int BN, class Loader>
__global__ void __launch_bounds__(kThreads)
    packed_conv2x2_dual_s8_kernel(Loader ld,
                                  const s8* __restrict__ wa,
                                  const s8* __restrict__ wb,
                                  const float* __restrict__ cs_a,
                                  const float* __restrict__ cs_b,
                                  const float* __restrict__ mul,
                                  const float* __restrict__ add,
                                  s8* __restrict__ y, long long M) {
  using C = TileCfg<BN, s8>;
  extern __shared__ __align__(128) unsigned char seg_smem[];
  float* P = reinterpret_cast<float*>(seg_smem + C::SMEM);
  const long long m0 = (long long)blockIdx.x * C::BM;
  const int ka = ld.ka;
  AccFrag<BN, s8> acc[C::FM][C::FN];
  zero_acc<BN, s8>(acc);
  igemm_accumulate<BN, s8>(ld, wa, 0, ka, m0, M, seg_smem, acc);
  int* Cs = stage_acc<BN, s8>(acc, seg_smem);
  for (int idx = threadIdx.x; idx < C::BM * BN; idx += kThreads) {
    const int off = (idx / BN) * C::LDC + idx % BN;
    P[off] = __fmul_rn((float)Cs[off], cs_a[idx % BN]);
  }
  zero_acc<BN, s8>(acc);
  igemm_accumulate<BN, s8>(ld, wb, ka, 2 * ka, m0, M, seg_smem, acc);
  Cs = stage_acc<BN, s8>(acc, seg_smem);  // its barriers order P too
  float* Cf = reinterpret_cast<float*>(Cs);
  for (int idx = threadIdx.x; idx < C::BM * BN; idx += kThreads) {
    const int off = (idx / BN) * C::LDC + idx % BN;
    Cf[off] = __fadd_rn(P[off], __fmul_rn((float)Cs[off], cs_b[idx % BN]));
  }
  __syncthreads();
  epilogue_affine<BN, s8>(Cf, mul, add, y, false, Linear{m0, M});
}

template <int BN, class SA, class SB>
int run_dual_s8(const SA& a, const SB& b, int ka, int ho, int wo,
                const void* wa, const void* wb, const void* cs_a,
                const void* cs_b, const void* mul, const void* add, void* y,
                long long M, cudaStream_t s) {
  using L = DualLoader<SA, SB>;
  const L ld{a, b, ka, ho, wo};
  return launch<BN, s8>(packed_conv2x2_dual_s8_kernel<BN, L>, M, s,
                        TileCfg<BN, s8>::C_BYTES, ld, (const s8*)wa,
                        (const s8*)wb, (const float*)cs_a,
                        (const float*)cs_b, (const float*)mul,
                        (const float*)add, (s8*)y, M);
}

// The b side (up) as s8 codes or quantized on load, for a given a side.
template <int BN, class SA>
int dual_s8_up(const SA& a, const void* up, float inv_b, int hp, int wp,
               int c4, const void* wa, const void* wb, const void* cs_a,
               const void* cs_b, const void* mul, const void* add, void* y,
               long long M, cudaStream_t s) {
  const int ka = 4 * c4, ho = hp - 1, wo = wp - 1;
  if (inv_b > 0.0f)
    return run_dual_s8<BN>(
        a, QuantLoader<UpSide<bf16>>{{(const bf16*)up, hp, wp, c4}, inv_b},
        ka, ho, wo, wa, wb, cs_a, cs_b, mul, add, y, M, s);
  return run_dual_s8<BN>(a, UpSide<s8>{(const s8*)up, hp, wp, c4}, ka, ho,
                         wo, wa, wb, cs_a, cs_b, mul, add, y, M, s);
}

template <int BN>
int dual_s8_sides(const void* skip, const void* up, float inv_a,
                  float inv_b, int hpa, int wpa, int hp, int wp, int c4,
                  int oh, int ow, const void* wa, const void* wb,
                  const void* cs_a, const void* cs_b, const void* mul,
                  const void* add, void* y, long long M, cudaStream_t s) {
  if (inv_a > 0.0f)
    return dual_s8_up<BN>(
        QuantLoader<SkipSide<bf16>>{
            {(const bf16*)skip, hpa, wpa, c4, c4 / 4, oh, ow}, inv_a},
        up, inv_b, hp, wp, c4, wa, wb, cs_a, cs_b, mul, add, y, M, s);
  return dual_s8_up<BN>(
      SkipSide<s8>{(const s8*)skip, hpa, wpa, c4, c4 / 4, oh, ow}, up, inv_b,
      hp, wp, c4, wa, wb, cs_a, cs_b, mul, add, y, M, s);
}

}  // namespace segk

// skip [n, hpa, wpa, c4], up [n, hp, wp, c4] bf16 (c4 % 32 == 0); wa, wb
// [4*c4, o4] bf16; bias [o4] f32; y [n, hp-1, wp-1, o4] bf16; (oh, ow) the
// unpacked crop offset, which the skip covers; (th, tw) the output tile
// from tiles.tile_plan. Every pointer 16-byte aligned.
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
    p.skip = (const bf16*)skip;
    p.hpa = hpa;
    p.wpa = wpa;
    p.oh = oh;
    p.ow = ow;
    p.slot = slot;
    return fwd_launch(p, n, hp - 1, wp - 1, c4, th, tw, s);
  };
  if (o4 == 128) {
    if (odd && !slot) {
      FwdTiles<128, 2> p{};
      return run(p);
    }
    FwdTiles<128, 1> p{};
    return run(p);
  }
  if (o4 == 256) {
    if (odd && !slot) {
      FwdTiles<256, 2> p{};
      return run(p);
    }
    FwdTiles<256, 1> p{};
    return run(p);
  }
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: skip, up s8 codes (c4 % 64 == 0: a 16-byte vector stays
// in one slot), or a side in bf16 quantized on load where its inverse
// scale inv_a / inv_b = f32(1 / act_scale_a / _b) is not 0; wa, wb [4*c4,
// o4] s8; cs_a, cs_b, mul, add [o4] f32; y s8.
extern "C" int seg_packed_conv2x2_dual_s8(
    const void* skip, const void* up, const void* wa, const void* wb,
    const void* cs_a, const void* cs_b, const void* mul, const void* add,
    void* y, int n, int hpa, int wpa, int hp, int wp, int c4, int o4, int oh,
    int ow, float inv_a, float inv_b, void* stream) {
  using namespace segk;
  const long long M = (long long)n * (hp - 1) * (wp - 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (c4 % 64) return (int)cudaErrorInvalidValue;
  if (o4 == 128)
    return dual_s8_sides<128>(skip, up, inv_a, inv_b, hpa, wpa, hp, wp, c4,
                              oh, ow, wa, wb, cs_a, cs_b, mul, add, y, M, s);
  if (o4 == 256)
    return dual_s8_sides<256>(skip, up, inv_a, inv_b, hpa, wpa, hp, wp, c4,
                              oh, ow, wa, wb, cs_a, cs_b, mul, add, y, M, s);
  return (int)cudaErrorInvalidValue;
}
