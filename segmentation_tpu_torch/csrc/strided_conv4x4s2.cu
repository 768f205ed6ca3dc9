// H3 strided_conv4x4s2: a 3x3 VALID conv whose output lands packed, as a
// 4x4 stride-2 VALID conv from an unpacked [N, H, W, C] input to packed
// [N, (H-2)/2, (W-2)/2, 4O] with the s2d-folded weights w4 [4, 4, C, 4O]
// (models/unet_fast.py pack_conv3_weight_s2), + f32 bias, ReLU, bf16 store.
//
// Replaces the TPU kernels segmentation_tpu/nn/pallas/conv_flat.py
// conv4x4s2_padflat (:667, conv2_1, C = 32 from the paired pooled input)
// and conv3entry_pf2 (:1738, the fused C = 3 entry conv). The pairing and
// the pair-major entry transform are TPU layout devices; here the kernel
// gathers the 4x4 window straight from NHWC.
//
// Bound on the H100: the C = 3 entry has K = 48 and reads 6 bytes per
// pixel per tap, so it is bound by the gather and the output store (128
// bf16 channels per packed pixel), not by the product; its loader reads
// scalars (a pixel's 3 channels are not 16-byte aligned). C = 32 has
// K = 512 and runs the 16-byte vector loader.
#include "igemm.cuh"

namespace segk {

template <bool VEC>
struct Strided4x4Loader {
  const bf16* x;
  int h, w, c, ho, wo;
  struct Row {
    const bf16* p;
    bool ok;
  };
  __device__ __forceinline__ Row row(long long m, bool ok) const {
    Row r;
    r.ok = ok;
    r.p = x;
    if (ok) {
      const Pix q = decode(m, ho, wo);
      r.p = x + ((q.n * h + 2 * q.i) * (long long)w + 2 * q.j) * c;
    }
    return r;
  }
  __device__ __forceinline__ uint4 load(const Row& r, int k) const {
    if (VEC) {
      const int tap = k / c;  // (u, v) = (tap >> 2, tap & 3)
      const int cc = k - tap * c;
      return *reinterpret_cast<const uint4*>(
          r.p + ((long long)(tap >> 2) * w + (tap & 3)) * c + cc);
    }
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(r.p);
    unsigned s[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int kk = k + t;  // K = 16c is a multiple of 8: kk < K
      const int tap = kk / c;
      const int cc = kk - tap * c;
      s[t] = xs[((long long)(tap >> 2) * w + (tap & 3)) * c + cc];
    }
    return make_uint4(s[0] | (s[1] << 16), s[2] | (s[3] << 16),
                      s[4] | (s[5] << 16), s[6] | (s[7] << 16));
  }
};

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
    strided_conv4x4s2_kernel(Strided4x4Loader<VEC> ld,
                             const bf16* __restrict__ w,
                             const float* __restrict__ bias,
                             bf16* __restrict__ y, long long M) {
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * TileCfg<BN>::BM;
  const int K = 16 * ld.c;
  float* Cs = igemm_tile<BN>(ld, w, w, K, K, m0, M, seg_smem);
  epilogue_store<BN>(Cs, bias, y, false, m0, M);
}

template <int BN, bool VEC>
int run_strided(const bf16* x, const void* w, const void* bias, void* y,
                int n, int h, int wdt, int c, cudaStream_t s) {
  const int ho = (h - 2) / 2;
  const int wo = (wdt - 2) / 2;
  const Strided4x4Loader<VEC> ld{x, h, wdt, c, ho, wo};
  const long long M = (long long)n * ho * wo;
  return launch<BN>(strided_conv4x4s2_kernel<BN, VEC>, M, s, ld,
                    (const bf16*)w, (const float*)bias, (bf16*)y, M);
}

}  // namespace segk

// x [n, h, w, c] bf16; w [16*c, o4] bf16 (HWIO [4, 4, c, o4]); bias [o4]
// f32; y [n, (h-2)/2, (w-2)/2, o4] bf16.
extern "C" int seg_strided_conv4x4s2(const void* x, const void* w,
                                     const void* bias, void* y, int n,
                                     int h, int wdt, int c, int o4,
                                     void* stream) {
  using namespace segk;
  const bf16* xp = (const bf16*)x;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = c % 8 == 0;
  if (o4 == 128)
    return vec ? run_strided<128, true>(xp, w, bias, y, n, h, wdt, c, s)
               : run_strided<128, false>(xp, w, bias, y, n, h, wdt, c, s);
  if (o4 == 256)
    return vec ? run_strided<256, true>(xp, w, bias, y, n, h, wdt, c, s)
               : run_strided<256, false>(xp, w, bias, y, n, h, wdt, c, s);
  return (int)cudaErrorInvalidValue;
}
