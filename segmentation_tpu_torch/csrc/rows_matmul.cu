// H4 rows_matmul: the 2x2/2 transposed conv as a per-pixel product
// [C] -> [4O] (wm [C, 4O], models/unet_fast.py prepare) with a store map:
//   identity: x [N, H, W, C] unpacked -> y [N, H, W, 4O] packed (upconv3);
//   scatter:  x [N, i, j, 4C] packed -> y [N, 2i, 2j, 4O] packed: input
//             slot (a, b) of packed pixel (i, j) lands at output packed
//             pixel (2i + a, 2j + b), all four slots (upconv4).
//   bf16: + f32 bias, ReLU, bf16 store, on the Hopper mainloop
//         (sm90_igemm.cuh: TMA, wgmma, warp-specialised, persistent; the
//         output side of packed_conv2x2_fwd.cuh);
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
// The bf16 design: one tap (HALO 0), tiles of th x tw output pixels
// (tiles.tile_plan, th tw <= 128 GEMM rows), K = C in 64-channel blocks.
//  - identity: A is the 4-D TMA box [1, th, tw, 64] of x at (n, i0, j0, k0).
//  - scatter: x viewed as the 5-D [N I, J, 2 (a), 2 (b), C]; output row
//    2i + a of the tile, columns j0 .. j0 + tw - 1 (j0 and tw even), is the
//    box [1, tw / 2, 1, 2, 64] at (n I + i, j0 / 2, a, 0, k0), which lands
//    in (j, b) order: the output's column order. One box per output row of
//    the tile, each on a 1024-byte boundary of the A slot (tw % 8 == 0
//    where th > 1), where the 128-byte swizzle starts its pattern.
//  - B is wm read MN-major, one [64, 64] box per 64 columns; rows past C
//    are TMA's zeros against A's zero channels.
//  - Output: FwdOut's. 4O = 128 (upconv4): ping-pong consumers, TMA stores
//    from a staging tile; 4O = 256 (upconv3): tiles split between the
//    consumers, register stores.
//
// Bound on the H100: K = C = 64..128 against 4O = 128..256 outputs per
// pixel, so the output store dominates (4O elements per pixel against C
// read): memory-bound; each output row is written once, in whole tiles,
// and the scatter costs no extra pass.
#include "igemm.cuh"
#include "packed_conv2x2_fwd.cuh"

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

// The bf16 problem on the Hopper mainloop (see the top of this file).
template <int O4, bool SCATTER>
struct RowsTiles : FwdOut<O4, 0, 0> {
  using Out = FwdOut<O4, 0, 0>;
  using Out::BM;
  using Out::NB;
  using Out::origin;
  using Out::th;
  using Out::tw;
  static constexpr int TAPS = 1;
  static constexpr int A_ROWS = BM;
  static constexpr int B_STAGES = Out::b_stages(A_ROWS);
  static constexpr bool B_MN = true, GATHER = false;

  CUtensorMap xmap, wmap;  // x (4-D, or the 5-D scatter view); wm
  int kb;                  // K blocks: ceil(C / 64)
  int hi;                  // scatter: the input's packed rows I

  __device__ int k_blocks() const { return kb; }
  __device__ uint32_t a_tx(int) const {
    return (uint32_t)(th * tw) * 128u;
  }
  __device__ int a_row(int) const { return 0; }
  __device__ void prefetch() const {
    sm90::prefetch_map(&xmap);
    sm90::prefetch_map(&wmap);
  }
  __device__ void load_a(int t, int k, uint8_t* a, uint64_t* bar) const {
    int n, i0, j0;
    origin(t, n, i0, j0);
    if constexpr (SCATTER) {
      for (int r = 0; r < th; ++r) {
        const int oi = i0 + r;  // output row 2i + a
        sm90::tma_load_5d(a + r * tw * 128, &xmap, bar, 64 * k, 0, oi & 1,
                          j0 >> 1, n * hi + (oi >> 1));
      }
    } else {
      sm90::tma_load_4d(a, &xmap, bar, 64 * k, j0, i0, n);
    }
  }
  __device__ void load_b(int k, int, uint8_t* b, uint64_t* bar) const {
#pragma unroll
    for (int j = 0; j < NB / 64; ++j)
      sm90::tma_load_2d(b + j * sm90::kMnBox, &wmap, bar, 64 * j, 64 * k);
  }
};

template <int O4, bool SCATTER>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    rows_matmul_fwd_kernel(const __grid_constant__ RowsTiles<O4, SCATTER> p) {
  sm90::run(p);
}

template <int O4, bool SCATTER>
int run_rows(const void* x, const void* w, const void* bias, void* y, int n,
             int ho, int wo, int c, int th, int tw, cudaStream_t s) {
  RowsTiles<O4, SCATTER> p{};
  p.kb = (c + 63) / 64;
  p.hi = ho / 2;
  p.bias = (const float*)bias;
  p.y = (bf16*)y;
  int e;
  if (SCATTER) {
    const cuuint64_t dims[5] = {(cuuint64_t)c, 2, 2, (cuuint64_t)(wo / 2),
                                (cuuint64_t)n * (ho / 2)};
    const cuuint64_t strides[4] = {(cuuint64_t)(2LL * c),
                                   (cuuint64_t)(4LL * c),
                                   (cuuint64_t)(8LL * c),
                                   (cuuint64_t)(8LL * c * (wo / 2))};
    const cuuint32_t box[5] = {64, 2, 1, (cuuint32_t)tw / 2, 1};
    e = sm90::make_map_strided(&p.xmap, x, 5, dims, strides, box);
  } else {
    const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)wo, (cuuint64_t)ho,
                                (cuuint64_t)n};
    const cuuint32_t box[4] = {64, (cuuint32_t)tw, (cuuint32_t)th, 1};
    e = sm90::make_map(&p.xmap, x, 4, dims, box);
  }
  const cuuint64_t wdims[2] = {(cuuint64_t)O4, (cuuint64_t)c};
  const cuuint32_t wbox[2] = {64, 64};
  if (e == 0) e = sm90::make_map(&p.wmap, w, 2, wdims, wbox);
  if (e == 0) e = p.plan(n, ho, wo, th, tw);
  if (e != 0) return e;
  return sm90::launch(rows_matmul_fwd_kernel<O4, SCATTER>, p, s);
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
  const int* Cs = igemm_tile<BN>(ld, w, K, m0, M, seg_smem);
  epilogue_affine<BN>(Cs, mul, add, y, Linear{m0, M});
}

template <class Loader>
int run_rows_s8(const Loader& ld, int K, int o4, const void* w,
                const void* mul, const void* add, void* y, long long M,
                cudaStream_t s) {
  if (o4 == 128)
    return launch<128>(rows_matmul_s8_kernel<128, Loader>, M, s, ld, K,
                       (const s8*)w, (const float*)mul, (const float*)add,
                       (s8*)y, M);
  if (o4 == 256)
    return launch<256>(rows_matmul_s8_kernel<256, Loader>, M, s, ld, K,
                       (const s8*)w, (const float*)mul, (const float*)add,
                       (s8*)y, M);
  return (int)cudaErrorInvalidValue;
}

}  // namespace segk

// x [n, ho, wo, c] (identity) or [n, ho/2, wo/2, 4c] (scatter) bf16,
// c % 8 == 0; w [c, o4] bf16; bias [o4] f32; y [n, ho, wo, o4] bf16; (th,
// tw) the output tile from tiles.tile_plan (th tw <= 128 GEMM rows; the
// scatter: tw even, a multiple of 8 where th > 1). Every pointer 16-byte
// aligned.
extern "C" int seg_rows_matmul(const void* x, const void* w,
                               const void* bias, void* y, int n, int ho,
                               int wo, int c, int o4, int scatter, int th,
                               int tw, void* stream) {
  using namespace segk;
  if (n < 1 || ho < 1 || wo < 1 || c < 8 || c % 8 || th > 255 || tw > 255 ||
      (scatter && (ho % 2 || wo % 2 || tw % 2 || (th > 1 && tw % 8))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (o4 == 128)
    return scatter
               ? run_rows<128, true>(x, w, bias, y, n, ho, wo, c, th, tw, s)
               : run_rows<128, false>(x, w, bias, y, n, ho, wo, c, th, tw, s);
  if (o4 == 256)
    return scatter
               ? run_rows<256, true>(x, w, bias, y, n, ho, wo, c, th, tw, s)
               : run_rows<256, false>(x, w, bias, y, n, ho, wo, c, th, tw, s);
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
