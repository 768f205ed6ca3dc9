// H6 packed_conv2x2_dgrad: the input gradient of H1's 2x2 VALID conv over a
// packed tensor, and of both halves of H2's dual conv in one launch (g is
// read once per 256-column tile: once at conv9_1, twice at conv8_1).
//
//   dx[n, i, j, c] = sum over u, v in {0, 1} and o of
//                    g[n, i-u, j-v, o] * w[u, v, c, o]
//
// g [N, hg, wg, 4O] bf16 is the (ReLU-masked) output cotangent, zero outside
// its extent, and dx [N, hg+1, wg+1, 4C] bf16, accumulated in f32. As an
// implicit GEMM: M = N (hg+1)(wg+1) pixels, K = 4 taps x 4O, columns 4C. The
// weight matrix Wt[(tap, o), col] = w[u, v, col, o] is built by torch (a
// transpose of the 0.5 MB packed weight); the dual mode lays [wa^T | wb^T]
// side by side (8C columns) and stores the first 4C columns of a pixel to
// dxa and the rest to dxb. A block computes BM pixels x BN columns; with
// 8C = 512 (conv8_1) blockIdx.y picks one of two column tiles, whose
// weights the wrapper stores tile-major ([tiles][K][BN]).
//
// Replaces the TPU kernels segmentation_tpu/nn/pallas/conv_flat_bwd.py
// conv2x2_dgrad_padflat (:119) and conv2x2_dgrad_dual_padflat (:217).
// Their zero-junk cotangent contract, row rolls and first-row patch exist
// for the padded-flat layout; this kernel reads plain NHWC and checks each
// tap's source pixel against g's extent instead (the first and last rows
// and columns of dx see fewer taps).
//
// Bound on the H100: the same MACs per byte as H1 (K = 512..1024 against
// 128..256 columns), so compute-bound once tiles are reused; this first
// version runs on the WMMA core of igemm.cuh with a store-only epilogue.
#include "igemm.cuh"

namespace segk {

struct DgradLoader {
  const bf16* g;
  int hg, wg, o4, ho, wo;
  struct Row {
    long long n;
    int i, j;
    bool ok;
  };
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
    const int tap = k / o4;  // (u, v) = (tap >> 1, tap & 1)
    const int o = k - tap * o4;
    const int si = r.i - (tap >> 1);
    const int sj = r.j - (tap & 1);
    if (si < 0 || si >= hg || sj < 0 || sj >= wg) return zero4();
    return *reinterpret_cast<const uint4*>(
        g + ((r.n * hg + si) * (long long)wg + sj) * o4 + o);
  }
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
    packed_conv2x2_dgrad_kernel(DgradLoader ld, const bf16* __restrict__ w,
                                bf16* __restrict__ dxa,
                                bf16* __restrict__ dxb, int c4,
                                long long M) {
  using C = TileCfg<BN>;
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * C::BM;
  const int K = 4 * ld.o4;
  const int col0 = blockIdx.y * BN;
  const float* Cs = igemm_tile<BN, bf16>(ld, w + (long long)blockIdx.y * K * BN,
                                         K, m0, M, seg_smem);
  for (int idx = threadIdx.x; idx < C::BM * (BN / 8); idx += kThreads) {
    const int r = idx / (BN / 8);
    const int c = (idx % (BN / 8)) * 8;
    const long long m = m0 + r;
    if (m >= M) continue;
    const int gc = col0 + c;  // 8 columns never straddle the two sides
    bf16* out = gc < c4 ? dxa + m * c4 + gc : dxb + m * c4 + (gc - c4);
    store8(out, Cs + r * C::LDC + c);
  }
}

}  // namespace segk

// g [n, hg, wg, o4] bf16; w [ncols / bn][4*o4][bn] bf16 with ncols = c4
// (dxb null) or 2*c4 (dual), bn = min(ncols, 256); dxa (and dxb) [n, hg+1,
// wg+1, c4] bf16.
extern "C" int seg_packed_conv2x2_dgrad(const void* g, const void* w,
                                        void* dxa, void* dxb, int n, int hg,
                                        int wg, int o4, int c4,
                                        void* stream) {
  using namespace segk;
  const int ncols = dxb != nullptr ? 2 * c4 : c4;
  const int bn = ncols < 256 ? ncols : 256;
  if (o4 % 8 || (c4 != 128 && c4 != 256) || hg < 1 || wg < 1)
    return (int)cudaErrorInvalidValue;
  const DgradLoader ld{(const bf16*)g, hg, wg, o4, hg + 1, wg + 1};
  const long long M = (long long)n * (hg + 1) * (wg + 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (bn == 128) {
    const dim3 grid((unsigned)((M + TileCfg<128>::BM - 1) / TileCfg<128>::BM),
                    ncols / 128);
    return launch_grid(packed_conv2x2_dgrad_kernel<128>, grid,
                       TileCfg<128>::SMEM, s, ld, (const bf16*)w, (bf16*)dxa,
                       (bf16*)dxb, c4, M);
  }
  const dim3 grid((unsigned)((M + TileCfg<256>::BM - 1) / TileCfg<256>::BM),
                  ncols / 256);
  return launch_grid(packed_conv2x2_dgrad_kernel<256>, grid,
                     TileCfg<256>::SMEM, s, ld, (const bf16*)w, (bf16*)dxa,
                     (bf16*)dxb, c4, M);
}
