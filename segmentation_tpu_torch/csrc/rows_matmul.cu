// H4 rows_matmul: the 2x2/2 transposed conv as a per-pixel product
// [C] -> [4O] (wm [C, 4O], models/unet_fast.py prepare) with a store map:
//   identity: x [N, H, W, C] unpacked -> y [N, H, W, 4O] packed (upconv3);
//   scatter:  x [N, i, j, 4C] packed -> y [N, 2i, 2j, 4O] packed: input
//             slot (a, b) of packed pixel (i, j) lands at output packed
//             pixel (2i + a, 2j + b), all four slots (upconv4).
//   bf16: + f32 bias, ReLU, bf16 store;
//   s8:   s8 x and wm (s32 accumulation), the int8 epilogue
//         relu(acc * mul + add) requantized to s8 (igemm.cuh); x is s8
//         codes, or bf16 quantized as it loads (act_inv: the inline-
//         quantize mode).
// The scatter is done on the read side: output pixel (y, x) gathers input
// packed pixel (y/2, x/2), slot (y%2, x%2), so every output row is written
// once, contiguously.
//
// Replaces the TPU kernels segmentation_tpu/nn/pallas/conv_flat.py
// matmul_rows_padflat (:785, identity) and deconv_packed_padflat (:896,
// slot scatter; pf2_out emits the paired layout, a TPU layout device), and
// of the 4-D route nn/pallas/conv.py matmul_rows_flat (:974) and
// deconv_packed_flat (:1078): float, int8-resident and inline-quantize
// modes.
//
// Bound on the H100: K = C = 64..128 against 4O = 128..256 outputs per
// pixel, so the output store dominates (4O elements per pixel against C
// read): memory-bound; the design writes each output row once with
// 16-byte stores and keeps the scatter out of any extra pass.
#include "igemm.cuh"

namespace segk {

template <class T>
struct RowsLoader {
  const T* x;
  int c, scatter, ho, wo;  // (ho, wo): output grid
  struct Row {
    const T* p;
    bool ok;
  };
  __device__ __forceinline__ Row row(long long m, bool ok) const {
    Row r;
    r.ok = ok;
    r.p = x;
    if (ok) {
      if (!scatter) {
        r.p = x + m * c;
      } else {
        const Pix q = decode(m, ho, wo);
        r.p = x + ((q.n * (ho / 2) + (q.i >> 1)) * (long long)(wo / 2) +
                   (q.j >> 1)) * (4LL * c) +
              (2 * (q.i & 1) + (q.j & 1)) * c;
      }
    }
    return r;
  }
  __device__ __forceinline__ uint4 load(const Row& r, int k) const {
    return *reinterpret_cast<const uint4*>(r.p + k);
  }
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
    rows_matmul_kernel(RowsLoader<bf16> ld, const bf16* __restrict__ w,
                       const float* __restrict__ bias,
                       bf16* __restrict__ y, long long M) {
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * TileCfg<BN>::BM;
  float* Cs = igemm_tile<BN, bf16>(ld, w, ld.c, m0, M, seg_smem);
  epilogue_store<BN>(Cs, bias, y, m0, M);
}

// Loader: RowsLoader<s8>, or QuantLoader over RowsLoader<bf16>.
template <int BN, class Loader>
__global__ void __launch_bounds__(kThreads)
    rows_matmul_s8_kernel(Loader ld, int K, const s8* __restrict__ w,
                          const float* __restrict__ mul,
                          const float* __restrict__ add, s8* __restrict__ y,
                          long long M) {
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * TileCfg<BN>::BM;
  int* Cs = igemm_tile<BN, s8>(ld, w, K, m0, M, seg_smem);
  epilogue_affine<BN, s8>(Cs, mul, add, y, false, Linear{m0, M});
}

template <class Loader>
int run_rows_s8(const Loader& ld, int K, int o4, const void* w,
                const void* mul, const void* add, void* y, long long M,
                cudaStream_t s) {
  if (o4 == 128)
    return launch<128, s8>(rows_matmul_s8_kernel<128, Loader>, M, s, 0, ld,
                           K, (const s8*)w, (const float*)mul,
                           (const float*)add, (s8*)y, M);
  if (o4 == 256)
    return launch<256, s8>(rows_matmul_s8_kernel<256, Loader>, M, s, 0, ld,
                           K, (const s8*)w, (const float*)mul,
                           (const float*)add, (s8*)y, M);
  return (int)cudaErrorInvalidValue;
}

}  // namespace segk

// x [n, ho, wo, c] (identity) or [n, ho/2, wo/2, 4c] (scatter) bf16;
// w [c, o4] bf16; bias [o4] f32; y [n, ho, wo, o4] bf16.
extern "C" int seg_rows_matmul(const void* x, const void* w,
                               const void* bias, void* y, int n, int ho,
                               int wo, int c, int o4, int scatter,
                               void* stream) {
  using namespace segk;
  const RowsLoader<bf16> ld{(const bf16*)x, c, scatter, ho, wo};
  const long long M = (long long)n * ho * wo;
  cudaStream_t s = (cudaStream_t)stream;
  if (o4 == 128)
    return launch<128>(rows_matmul_kernel<128>, M, s, 0, ld, (const bf16*)w,
                       (const float*)bias, (bf16*)y, M);
  if (o4 == 256)
    return launch<256>(rows_matmul_kernel<256>, M, s, 0, ld, (const bf16*)w,
                       (const float*)bias, (bf16*)y, M);
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: x as above (c % 16 == 0), s8 codes when act_inv is 0,
// else bf16 quantized on load at act_inv = f32(1 / act_scale); w [c, o4]
// s8; mul, add [o4] f32; y [n, ho, wo, o4] s8.
extern "C" int seg_rows_matmul_s8(const void* x, const void* w,
                                  const void* mul, const void* add, void* y,
                                  int n, int ho, int wo, int c, int o4,
                                  int scatter, float act_inv, void* stream) {
  using namespace segk;
  const long long M = (long long)n * ho * wo;
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 16) return (int)cudaErrorInvalidValue;
  if (act_inv > 0.0f) {
    const QuantLoader<RowsLoader<bf16>> ld{
        {(const bf16*)x, c, scatter, ho, wo}, act_inv};
    return run_rows_s8(ld, c, o4, w, mul, add, y, M, s);
  }
  const RowsLoader<s8> ld{(const s8*)x, c, scatter, ho, wo};
  return run_rows_s8(ld, c, o4, w, mul, add, y, M, s);
}
