// H2 packed_conv2x2_dual: the concat-free first decoder conv of a packed
// level, conv2x2(crop(skip), wa) + conv2x2(up, wb).
//   bf16: one f32 accumulator over both sides, + f32 bias, ReLU, bf16;
//   s8:   one s32 accumulator per side (the sides are quantized at
//         different scales), mixed in f32 as acc_a * cs_a + acc_b * cs_b,
//         then the int8 epilogue relu(mix * mul + add) requantized to s8.
// skip [N, hpa, wpa, 4C] is read through a center crop at UNPACKED offset
// (oh, ow): output slot (d, e) of packed pixel (i, j) reads the skip at
// unpacked (oh + 2i + d, ow + 2j + e), i.e. packed pixel
// ((oh + d) // 2 + i, (ow + e) // 2 + j), slot ((oh + d) % 2, (ow + e) % 2).
// Even offsets are a plain packed slice; odd offsets are the slot phase.
// One address rule covers both, so the cropped skip and the concat are
// never materialised.
//
// Replaces the TPU kernels segmentation_tpu/nn/pallas/conv_flat.py
// conv2x2_dual_padflat (:503; even offset or a_slot_phase) and
// conv2x2_dual_pf2 (:1379; slot-even offsets in the paired layout), float
// and int8-resident modes.
//
// Bound on the H100: K = 2 * 4 * 4C = 2048 at the level-2 decoder, so the
// product dominates and is tensor-core bound; the crop gather costs a few
// integer ops per 16-byte load (C a multiple of 16 bytes keeps a vector in
// one slot). The s8 mode stages the skip side's scaled partial in a second
// shared-memory tile instead of a second register accumulator.
#include "igemm.cuh"

namespace segk {

template <class T>
struct DualLoader {
  const T* skip;
  const T* up;
  int hpa, wpa;  // skip packed grid
  int hp, wp;    // up packed grid
  int c4, cs;    // 4C and C
  int oh, ow;    // crop offset, unpacked units
  int ho, wo;    // output packed grid
  struct Row {
    long long n;
    int i, j;
    bool ok;
  };
  __device__ __forceinline__ Row row(long long m, bool ok) const {
    Row r;
    r.ok = ok;
    r.n = 0;
    r.i = r.j = 0;
    if (ok) {
      const Pix q = decode(m, ho, wo);
      r.n = q.n;
      r.i = q.i;
      r.j = q.j;
    }
    return r;
  }
  __device__ __forceinline__ uint4 load(const Row& r, int k) const {
    const int ka = 4 * c4;
    if (k < ka) {
      const int tap = k / c4;
      const int cc = k - tap * c4;
      const int s = cc / cs;  // output slot (d, e) = (s >> 1, s & 1)
      const int ch = cc - s * cs;
      const int yy = oh + 2 * (r.i + (tap >> 1)) + (s >> 1);
      const int xx = ow + 2 * (r.j + (tap & 1)) + (s & 1);
      const T* p =
          skip +
          ((r.n * hpa + (yy >> 1)) * (long long)wpa + (xx >> 1)) * c4 +
          (2 * (yy & 1) + (xx & 1)) * cs + ch;
      return *reinterpret_cast<const uint4*>(p);
    }
    const int kb = k - ka;
    const int tap = kb / c4;
    const int c = kb - tap * c4;
    const T* p = up +
                 ((r.n * hp + r.i + (tap >> 1)) * (long long)wp + r.j +
                  (tap & 1)) * c4 + c;
    return *reinterpret_cast<const uint4*>(p);
  }
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
    packed_conv2x2_dual_kernel(DualLoader<bf16> ld,
                               const bf16* __restrict__ wa,
                               const bf16* __restrict__ wb,
                               const float* __restrict__ bias,
                               bf16* __restrict__ y, long long M) {
  using C = TileCfg<BN>;
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * C::BM;
  const int ka = 4 * ld.c4;
  AccFrag<BN, bf16> acc[C::FM][C::FN];
  zero_acc<BN, bf16>(acc);
  igemm_accumulate<BN, bf16>(ld, wa, 0, ka, m0, M, seg_smem, acc);
  igemm_accumulate<BN, bf16>(ld, wb, ka, 2 * ka, m0, M, seg_smem, acc);
  float* Cs = stage_acc<BN, bf16>(acc, seg_smem);
  epilogue_store<BN>(Cs, bias, y, false, m0, M);
}

// Shared memory: the core's buffers, then the f32 skip-side partial P.
template <int BN>
__global__ void __launch_bounds__(kThreads)
    packed_conv2x2_dual_s8_kernel(DualLoader<s8> ld,
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
  const int ka = 4 * ld.c4;
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

}  // namespace segk

// skip [n, hpa, wpa, c4], up [n, hp, wp, c4] bf16; wa, wb [4*c4, o4] bf16;
// bias [o4] f32; y [n, hp-1, wp-1, o4] bf16; (oh, ow) unpacked crop offset.
extern "C" int seg_packed_conv2x2_dual(const void* skip, const void* up,
                                       const void* wa, const void* wb,
                                       const void* bias, void* y, int n,
                                       int hpa, int wpa, int hp, int wp,
                                       int c4, int o4, int oh, int ow,
                                       void* stream) {
  using namespace segk;
  const DualLoader<bf16> ld{(const bf16*)skip, (const bf16*)up, hpa, wpa,
                            hp, wp, c4, c4 / 4, oh, ow, hp - 1, wp - 1};
  const long long M = (long long)n * (hp - 1) * (wp - 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (o4 == 128)
    return launch<128>(packed_conv2x2_dual_kernel<128>, M, s, 0, ld,
                       (const bf16*)wa, (const bf16*)wb, (const float*)bias,
                       (bf16*)y, M);
  if (o4 == 256)
    return launch<256>(packed_conv2x2_dual_kernel<256>, M, s, 0, ld,
                       (const bf16*)wa, (const bf16*)wb, (const float*)bias,
                       (bf16*)y, M);
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: skip, up s8 (c4 % 64 == 0: a 16-byte vector stays in one
// slot); wa, wb [4*c4, o4] s8; cs_a, cs_b, mul, add [o4] f32; y s8.
extern "C" int seg_packed_conv2x2_dual_s8(
    const void* skip, const void* up, const void* wa, const void* wb,
    const void* cs_a, const void* cs_b, const void* mul, const void* add,
    void* y, int n, int hpa, int wpa, int hp, int wp, int c4, int o4, int oh,
    int ow, void* stream) {
  using namespace segk;
  const DualLoader<s8> ld{(const s8*)skip, (const s8*)up, hpa, wpa, hp, wp,
                          c4, c4 / 4, oh, ow, hp - 1, wp - 1};
  const long long M = (long long)n * (hp - 1) * (wp - 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (c4 % 64) return (int)cudaErrorInvalidValue;
  if (o4 == 128)
    return launch<128, s8>(packed_conv2x2_dual_s8_kernel<128>, M, s,
                           TileCfg<128, s8>::C_BYTES, ld, (const s8*)wa,
                           (const s8*)wb, (const float*)cs_a,
                           (const float*)cs_b, (const float*)mul,
                           (const float*)add, (s8*)y, M);
  if (o4 == 256)
    return launch<256, s8>(packed_conv2x2_dual_s8_kernel<256>, M, s,
                           TileCfg<256, s8>::C_BYTES, ld, (const s8*)wa,
                           (const s8*)wb, (const float*)cs_a,
                           (const float*)cs_b, (const float*)mul,
                           (const float*)add, (s8*)y, M);
  return (int)cudaErrorInvalidValue;
}
