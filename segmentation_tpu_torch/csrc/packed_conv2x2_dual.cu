// H2 packed_conv2x2_dual: the concat-free first decoder conv of a packed
// level, conv2x2(crop(skip), wa) + conv2x2(up, wb) + b, ReLU, bf16 store.
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
// conv2x2_dual_pf2 (:1379; slot-even offsets in the paired layout).
//
// Bound on the H100: K = 2 * 4 * 4C = 2048 at the level-2 decoder, so the
// product dominates and is tensor-core bound; the crop gather costs a few
// integer ops per 16-byte load (C % 8 == 0 keeps 8 channels in one slot).
#include "igemm.cuh"

namespace segk {

struct DualLoader {
  const bf16* skip;
  const bf16* up;
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
      const bf16* p =
          skip +
          ((r.n * hpa + (yy >> 1)) * (long long)wpa + (xx >> 1)) * c4 +
          (2 * (yy & 1) + (xx & 1)) * cs + ch;
      return *reinterpret_cast<const uint4*>(p);
    }
    const int kb = k - ka;
    const int tap = kb / c4;
    const int c = kb - tap * c4;
    const bf16* p = up +
                    ((r.n * hp + r.i + (tap >> 1)) * (long long)wp + r.j +
                     (tap & 1)) * c4 + c;
    return *reinterpret_cast<const uint4*>(p);
  }
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
    packed_conv2x2_dual_kernel(DualLoader ld, const bf16* __restrict__ wa,
                               const bf16* __restrict__ wb,
                               const float* __restrict__ bias,
                               bf16* __restrict__ y, long long M) {
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * TileCfg<BN>::BM;
  const int ka = 4 * ld.c4;
  float* Cs = igemm_tile<BN>(ld, wa, wb, ka, 2 * ka, m0, M, seg_smem);
  epilogue_store<BN>(Cs, bias, y, false, m0, M);
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
  const DualLoader ld{(const bf16*)skip, (const bf16*)up, hpa, wpa, hp, wp,
                      c4, c4 / 4, oh, ow, hp - 1, wp - 1};
  const long long M = (long long)n * (hp - 1) * (wp - 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (o4 == 128)
    return launch<128>(packed_conv2x2_dual_kernel<128>, M, s, ld,
                       (const bf16*)wa, (const bf16*)wb, (const float*)bias,
                       (bf16*)y, M);
  if (o4 == 256)
    return launch<256>(packed_conv2x2_dual_kernel<256>, M, s, ld,
                       (const bf16*)wa, (const bf16*)wb, (const float*)bias,
                       (bf16*)y, M);
  return (int)cudaErrorInvalidValue;
}
