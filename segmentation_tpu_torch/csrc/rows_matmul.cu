// H4 rows_matmul: the 2x2/2 transposed conv as a per-pixel product
// [C] -> [4O] (wm [C, 4O], models/unet_fast.py prepare) with a store map:
//   identity: x [N, H, W, C] unpacked -> y [N, H, W, 4O] packed (upconv3);
//   scatter:  x [N, i, j, 4C] packed -> y [N, 2i, 2j, 4O] packed: input
//             slot (a, b) of packed pixel (i, j) lands at output packed
//             pixel (2i + a, 2j + b), all four slots (upconv4).
//   bf16: + f32 bias, ReLU, bf16 store;
//   s8:   s8 x and the K-major copy wkm [4O, C] of the s8 wm (s8 wgmma, s32
//         accumulation), the int8 epilogue relu(acc * mul + add)
//         requantized to s8; x is s8 codes, or bf16 quantized as it is
//         gathered (act_inv: the inline-quantize mode, the Pallas multiply
//         rule, int8_epilogue.cuh quant16).
// Every mode runs on the Hopper mainloop (sm90_igemm.cuh: TMA, wgmma,
// warp-specialised, persistent) with the output side of
// packed_conv2x2_fwd.cuh (FwdOut). The scatter is done on the read side:
// output pixel (y, x) reads input packed pixel (y/2, x/2), slot (y%2,
// x%2), so every output row is written once, contiguously.
//
// Replaces the TPU kernels segmentation_tpu/nn/pallas/conv_flat.py
// matmul_rows_padflat (:785, identity) and deconv_packed_padflat (:896,
// slot scatter; pf2_out emits the paired layout, a TPU layout device), and
// of the 4-D route nn/pallas/conv.py matmul_rows_flat (:974) and
// deconv_packed_flat (:1078): float, int8-resident and inline-quantize
// modes.
//
// The design: one tap (HALO 0), tiles of th x tw output pixels
// (tiles.tile_plan, th tw <= 128 GEMM rows), K = C in blocks of 128 bytes
// (64 bf16 or 128 s8 channels).
//  - bf16 identity: A is the 4-D TMA box [1, th, tw, 64] of x at (n, i0,
//    j0, k0).
//  - bf16 scatter: x viewed as the 5-D [N I, J, 2 (a), 2 (b), C]; output
//    row 2i + a of the tile, columns j0 .. j0 + tw - 1 (j0 and tw even), is
//    the box [1, tw / 2, 1, 2, 64] at (n I + i, j0 / 2, a, 0, k0), which
//    lands in (j, b) order: the output's column order. One box per output
//    row of the tile, each on a 1024-byte boundary of the A slot (tw % 8 ==
//    0 where th > 1), where the 128-byte swizzle starts its pattern.
//  - s8 identity (codes): the 4-D box [1, th, tw, 128] of x: 128 s8
//    channels are one 128-byte row (upconv3, C = 128: one box a tile).
//  - s8 scatter, and the inline modes: the producer warpgroup's three idle
//    warps gather each GEMM row's 16-byte chunks of its source pixel (the
//    scatter's slot holds C = 64 s8 channels, 64 bytes: a TMA box with a
//    64-byte inner dim does not land one 128-byte row under the 128-byte
//    swizzle) and store them where TMA's swizzle would; the inline modes
//    quantize each chunk of 16 bf16 values as they store it. Chunks past C
//    are zeros.
//  - B: bf16, wm read MN-major, one [64, 64] box per 64 columns; s8, the
//    K-major wkm [4O, C] (s8 wgmma has no transposed B; made once in
//    models/unet_int8.py plan), one [4O, 128] box per K block. Rows past C
//    are TMA's zeros against A's zero channels.
//  - Output: FwdOut's. 4O = 128 (upconv4): ping-pong consumers, TMA stores
//    from a staging tile; 4O = 256 (upconv3): tiles split between the
//    consumers, register stores; 4O = 512 (upconv3 at n_kernels 64,
//    identity only): two column tiles of 256 a pixel tile, each a channel
//    block of the four slots (FwdOut::col).
//
// Bound on the H100: K = C = 64..128 against 4O = 128..256 outputs per
// pixel, so the output store dominates (4O elements per pixel against C
// read): memory-bound; each output row is written once, in whole tiles,
// and the scatter costs no extra pass.
#include "packed_conv2x2_fwd.cuh"

namespace segk {

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
  __device__ void load_b(int t, int k, int, uint8_t* b,
                         uint64_t* bar) const {
#pragma unroll
    for (int j = 0; j < NB / 64; ++j)
      sm90::tma_load_2d(b + j * sm90::kMnBox, &wmap, bar,
                        Out::col(Out::ctile(t), 64 * j), 64 * k);
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

// How the int8 problem reads x: kRowsBox, s8 codes of the identity by
// TMA boxes; kRowsCodes, s8 codes gathered (the scatter); kRowsQuant, bf16
// gathered and quantized (either map).
constexpr int kRowsBox = 0, kRowsCodes = 1, kRowsQuant = 2;

// The int8 problem on the Hopper mainloop (see the top of this file).
template <int O4, int MODE>
struct RowsS8Tiles : FwdOut<O4, kInt8 | kRequant, 0> {
  using Out = FwdOut<O4, kInt8 | kRequant, 0>;
  using Out::BM;
  using Out::ho;
  using Out::origin;
  using Out::th;
  using Out::tw;
  using Out::wo;
  static constexpr int TAPS = 1;
  static constexpr int A_ROWS = BM;
  static constexpr int B_STAGES = Out::b_stages(A_ROWS);
  static constexpr bool B_MN = false, GATHER = MODE != kRowsBox;
  // the gather keeps GATHER_CHUNKS chunks of each thread in flight (two
  // 16-byte loads each where it quantizes)
  static constexpr int GATHER_CHUNKS = 4;
  static constexpr int PRODUCER_REGS = GATHER ? 80 : sm90::kProducerRegs;

  CUtensorMap xmap, wmap;  // x (kRowsBox); wkm
  const uint8_t* xs;       // the gathered x
  float inv;               // kRowsQuant: f32(1 / act_scale)
  int c;                   // x's channels (C; the scatter's slot width)
  int kb;                  // K blocks: ceil(C / 128)
  int scatter;

  __device__ int k_blocks() const { return kb; }
  __device__ uint32_t a_tx(int) const {
    return GATHER ? 0u : (uint32_t)(th * tw) * 128u;
  }
  __device__ int a_row(int) const { return 0; }
  __device__ void prefetch() const {
    if (!GATHER) sm90::prefetch_map(&xmap);
    sm90::prefetch_map(&wmap);
  }
  __device__ void load_a(int t, int k, uint8_t* a, uint64_t* bar) const {
    if constexpr (!GATHER) {
      int n, i0, j0;
      origin(t, n, i0, j0);
      sm90::tma_load_4d(a, &xmap, bar, 128 * k, j0, i0, n);
    }
  }
  // A gathered K block (sm90::gather_rows): thread tid's chunk holds
  // channels 128 kb + 16 (tid % 8) ..; row m = a tw + b is output pixel (i0
  // + a, j0 + b), whose source is x's pixel (identity) or slot (i % 2, j %
  // 2) of packed pixel (i / 2, j / 2) (scatter). Zero outside the output
  // and past C; bf16 quantized by the multiply (kRowsQuant).
  __device__ void gather_a(int t, int k, uint8_t* a, int tid,
                           int nthreads) const {
    if constexpr (GATHER) {
      int n, i0, j0;
      origin(t, n, i0, j0);
      constexpr int es = MODE == kRowsQuant ? 2 : 1;  // the source's bytes
      const int ch = 128 * k + 16 * (tid & 7);
      const bool live = ch < c;
      sm90::gather_rows<GATHER_CHUNKS>(
          a, tid, nthreads, th * tw, tw, es == 2,
          [&](int bi, int bj) {
            const int i = i0 + bi, j = j0 + bj;
            const long long pix =
                scatter ? (((long long)n * (ho / 2) + (i >> 1)) * (wo / 2) +
                           (j >> 1)) * 4 * c + (2 * (i & 1) + (j & 1)) * c
                        : (((long long)n * ho + i) * wo + j) * c;
            return reinterpret_cast<const uint4*>(xs + (pix + ch) * es);
          },
          [&](int bi, int bj) {
            return live && i0 + bi < ho && j0 + bj < wo;
          },
          [&](uint4 lo, uint4 hi) { return quant16(lo, hi, inv); });
    }
  }
  // the 128 K bytes 128 k .. of every column of wkm [4O, C]
  __device__ void load_b(int, int k, int, uint8_t* b, uint64_t* bar) const {
    sm90::tma_load_2d(b, &wmap, bar, 128 * k, 0);
  }
};

template <int O4, int MODE>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    rows_matmul_s8_kernel(const __grid_constant__ RowsS8Tiles<O4, MODE> p) {
  sm90::run(p);
}

template <int O4, int MODE>
int run_rows_s8(const void* x, const void* wk, const void* mul,
                const void* add, void* y, int n, int ho, int wo, int c,
                int scatter, float act_inv, int th, int tw, cudaStream_t s) {
  RowsS8Tiles<O4, MODE> p{};
  p.xs = (const uint8_t*)x;
  p.inv = act_inv;
  p.c = c;
  p.kb = (c + 127) / 128;
  p.scatter = scatter;
  p.mul = (const float*)mul;
  p.add = (const float*)add;
  p.y = (s8*)y;
  int e = 0;
  if (MODE == kRowsBox) {
    const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)wo, (cuuint64_t)ho,
                                (cuuint64_t)n};
    const cuuint32_t box[4] = {128, (cuuint32_t)tw, (cuuint32_t)th, 1};
    e = sm90::make_map(&p.xmap, x, 4, dims, box, true, sm90::kMapS8);
  }
  const cuuint64_t wdims[2] = {(cuuint64_t)c, (cuuint64_t)O4};
  const cuuint32_t wbox[2] = {128, (cuuint32_t)O4};
  if (e == 0)
    e = sm90::make_map(&p.wmap, wk, 2, wdims, wbox, true, sm90::kMapS8);
  if (e == 0) e = p.plan(n, ho, wo, th, tw);
  if (e != 0) return e;
  return sm90::launch(rows_matmul_s8_kernel<O4, MODE>, p, s);
}

template <int O4>
int rows_s8_modes(const void* x, const void* wk, const void* mul,
                  const void* add, void* y, int n, int ho, int wo, int c,
                  int scatter, float act_inv, int th, int tw,
                  cudaStream_t s) {
  if (act_inv > 0.0f)
    return run_rows_s8<O4, kRowsQuant>(x, wk, mul, add, y, n, ho, wo, c,
                                       scatter, act_inv, th, tw, s);
  if (scatter)
    return run_rows_s8<O4, kRowsCodes>(x, wk, mul, add, y, n, ho, wo, c,
                                       scatter, act_inv, th, tw, s);
  return run_rows_s8<O4, kRowsBox>(x, wk, mul, add, y, n, ho, wo, c, scatter,
                                   act_inv, th, tw, s);
}

}  // namespace segk

// x [n, ho, wo, c] (identity) or [n, ho/2, wo/2, 4c] (scatter) bf16,
// c % 8 == 0; w [c, o4] bf16; bias [o4] f32; y [n, ho, wo, o4] bf16; (th,
// tw) the output tile from tiles.tile_plan (th tw <= 128 GEMM rows; the
// scatter: tw even, a multiple of 8 where th > 1); o4 = 128 or 256, 512
// for the identity. Every pointer 16-byte aligned.
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
  if (o4 == 512 && !scatter)
    return run_rows<512, false>(x, w, bias, y, n, ho, wo, c, th, tw, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: x as above (c % 16 == 0), s8 codes when act_inv is 0,
// else bf16 quantized as it is gathered, at act_inv = f32(1 / act_scale);
// wk [o4, c] s8, the K-major copy of wm [c, o4] (conv_int8.rows_k_major);
// mul, add [o4] f32; y [n, ho, wo, o4] s8; (th, tw) the output tile from
// tiles.tile_plan (th tw <= 128 GEMM rows). Every pointer 16-byte aligned.
extern "C" int seg_rows_matmul_s8(const void* x, const void* wk,
                                  const void* mul, const void* add, void* y,
                                  int n, int ho, int wo, int c, int o4,
                                  int scatter, float act_inv, int th, int tw,
                                  void* stream) {
  using namespace segk;
  if (n < 1 || ho < 1 || wo < 1 || c < 16 || c % 16 || th < 1 || tw < 1 ||
      th > 255 || tw > 255 || (scatter && (ho % 2 || wo % 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (o4 == 128)
    return rows_s8_modes<128>(x, wk, mul, add, y, n, ho, wo, c, scatter,
                              act_inv, th, tw, s);
  if (o4 == 256)
    return rows_s8_modes<256>(x, wk, mul, add, y, n, ho, wo, c, scatter,
                              act_inv, th, tw, s);
  return (int)cudaErrorInvalidValue;
}
