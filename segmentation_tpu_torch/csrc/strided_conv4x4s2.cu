// H3 strided_conv4x4s2: a 3x3 VALID conv whose output lands packed, as a
// 4x4 stride-2 VALID conv from an unpacked [N, H, W, C] input to packed
// [N, (H-2)/2, (W-2)/2, 4O] with the s2d-folded weights w4 [4, 4, C, 4O]
// (models/unet_fast.py pack_conv3_weight_s2).
//   bf16:    x, w4 bf16, + f32 bias, ReLU, bf16 store;
//   s8:      x, w4 s8 (s32 accumulation), the int8 epilogue
//            relu(acc * mul + add) requantized to s8 (igemm.cuh); x is s8
//            codes, or bf16 quantized as it loads (act_inv: the inline-
//            quantize mode). C = 3 s8 codes (the image entry's s8-input
//            mode) take the gather loader;
//   requant: x, w4 bf16 (f32 accumulation, the bf16 product) with the
//            int8 epilogue, s8 out: the image entry's requant-only mode,
//            the same product and epilogue as H5's conv1_1, so the same
//            codes.
//
// Replaces the TPU kernels segmentation_tpu/nn/pallas/conv_flat.py
// conv4x4s2_padflat (:667, conv2_1, C = 32 from the paired pooled input:
// bf16, int8-resident and inline-quantize modes), conv3entry_pf2 (:1738,
// the fused C = 3 entry: its bf16, requant-only and s8-input modes) and
// nn/pallas/conv.py conv4x4s2_flat (:844). The pairing and the pair-major
// entry transform are TPU layout devices; here the kernel gathers the 4x4
// window straight from NHWC.
//
// Bound on the H100: the C = 3 entry has K = 48 and reads 6 bytes per
// pixel per tap, so it is bound by the gather and the output store (128
// channels per packed pixel), not by the product; its loader reads scalars
// (a pixel's 3 channels are not 16-byte aligned). C = 32 has K = 512 and
// runs the 16-byte vector loader.
#include "loaders.cuh"

namespace segk {

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
    strided_conv4x4s2_kernel(Strided4x4Loader<bf16, VEC> ld,
                             const bf16* __restrict__ w,
                             const float* __restrict__ bias,
                             bf16* __restrict__ y, long long M) {
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * TileCfg<BN>::BM;
  const int K = 16 * ld.c;
  float* Cs = igemm_tile<BN, bf16>(ld, w, K, m0, M, seg_smem);
  epilogue_store<BN>(Cs, bias, y, m0, M);
}

template <int BN, bool VEC>
int run_strided(const bf16* x, const void* w, const void* bias, void* y,
                int n, int h, int wdt, int c, cudaStream_t s) {
  const int ho = (h - 2) / 2;
  const int wo = (wdt - 2) / 2;
  const Strided4x4Loader<bf16, VEC> ld{x, h, wdt, c, ho, wo};
  const long long M = (long long)n * ho * wo;
  return launch<BN>(strided_conv4x4s2_kernel<BN, VEC>, M, s, 0, ld,
                    (const bf16*)w, (const float*)bias, (bf16*)y, M);
}

// The requant-only entry: the bf16 product, the int8 epilogue.
template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
    strided_conv4x4s2_requant_kernel(Strided4x4Loader<bf16, VEC> ld,
                                     const bf16* __restrict__ w,
                                     const float* __restrict__ mul,
                                     const float* __restrict__ add,
                                     s8* __restrict__ y, long long M) {
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * TileCfg<BN>::BM;
  float* Cs = igemm_tile<BN, bf16>(ld, w, 16 * ld.c, m0, M, seg_smem);
  epilogue_affine<BN, s8>(Cs, mul, add, y, false, Linear{m0, M});
}

template <int BN, bool VEC>
int run_requant(const bf16* x, const void* w, const void* mul,
                const void* add, void* y, int n, int h, int wdt, int c,
                cudaStream_t s) {
  const int ho = (h - 2) / 2;
  const int wo = (wdt - 2) / 2;
  const Strided4x4Loader<bf16, VEC> ld{x, h, wdt, c, ho, wo};
  const long long M = (long long)n * ho * wo;
  return launch<BN>(strided_conv4x4s2_requant_kernel<BN, VEC>, M, s, 0, ld,
                    (const bf16*)w, (const float*)mul, (const float*)add,
                    (s8*)y, M);
}

// Loader: Strided4x4Loader<s8, VEC>, or QuantLoader over the bf16 one.
template <int BN, class Loader>
__global__ void __launch_bounds__(kThreads)
    strided_conv4x4s2_s8_kernel(Loader ld, int K, const s8* __restrict__ w,
                                const float* __restrict__ mul,
                                const float* __restrict__ add,
                                s8* __restrict__ y, long long M) {
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * TileCfg<BN>::BM;
  int* Cs = igemm_tile<BN, s8>(ld, w, K, m0, M, seg_smem);
  epilogue_affine<BN, s8>(Cs, mul, add, y, false, Linear{m0, M});
}

template <class Loader>
int run_strided_s8(const Loader& ld, int K, int o4, const void* w,
                   const void* mul, const void* add, void* y, long long M,
                   cudaStream_t s) {
  if (o4 == 128)
    return launch<128, s8>(strided_conv4x4s2_s8_kernel<128, Loader>, M, s, 0,
                           ld, K, (const s8*)w, (const float*)mul,
                           (const float*)add, (s8*)y, M);
  if (o4 == 256)
    return launch<256, s8>(strided_conv4x4s2_s8_kernel<256, Loader>, M, s, 0,
                           ld, K, (const s8*)w, (const float*)mul,
                           (const float*)add, (s8*)y, M);
  return (int)cudaErrorInvalidValue;
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

// The requant-only mode: x [n, h, w, c] bf16; w [16*c, o4] bf16; mul, add
// [o4] f32; y [n, (h-2)/2, (w-2)/2, o4] s8.
extern "C" int seg_strided_conv4x4s2_requant(const void* x, const void* w,
                                             const void* mul,
                                             const void* add, void* y, int n,
                                             int h, int wdt, int c, int o4,
                                             void* stream) {
  using namespace segk;
  const bf16* xp = (const bf16*)x;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = c % 8 == 0;
  if (o4 == 128)
    return vec ? run_requant<128, true>(xp, w, mul, add, y, n, h, wdt, c, s)
               : run_requant<128, false>(xp, w, mul, add, y, n, h, wdt, c, s);
  if (o4 == 256)
    return vec ? run_requant<256, true>(xp, w, mul, add, y, n, h, wdt, c, s)
               : run_requant<256, false>(xp, w, mul, add, y, n, h, wdt, c, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: x [n, h, w, c]: s8 codes when act_inv is 0 (c % 16 == 0,
// or any c through the gather: the C = 3 s8-input entry), else bf16
// quantized on load at act_inv = f32(1 / act_scale) (c % 16 == 0); w
// [16*c, o4] s8; mul, add [o4] f32; y [n, (h-2)/2, (w-2)/2, o4] s8.
extern "C" int seg_strided_conv4x4s2_s8(const void* x, const void* w,
                                        const void* mul, const void* add,
                                        void* y, int n, int h, int wdt,
                                        int c, int o4, float act_inv,
                                        void* stream) {
  using namespace segk;
  const int ho = (h - 2) / 2;
  const int wo = (wdt - 2) / 2;
  const long long M = (long long)n * ho * wo;
  const int K = 16 * c;
  cudaStream_t s = (cudaStream_t)stream;
  if (act_inv > 0.0f) {
    if (c % 16) return (int)cudaErrorInvalidValue;
    const QuantLoader<Strided4x4Loader<bf16, true>> ld{
        {(const bf16*)x, h, wdt, c, ho, wo}, act_inv};
    return run_strided_s8(ld, K, o4, w, mul, add, y, M, s);
  }
  if (c % 16 == 0)
    return run_strided_s8(Strided4x4Loader<s8, true>{(const s8*)x, h, wdt, c,
                                                     ho, wo},
                          K, o4, w, mul, add, y, M, s);
  return run_strided_s8(Strided4x4Loader<s8, false>{(const s8*)x, h, wdt, c,
                                                    ho, wo},
                        K, o4, w, mul, add, y, M, s);
}
