// H8 std_conv3x3, bf16 mode: the standard levels' bf16 3x3 VALID conv of
// the serving forward, single and dual (the decoder's concat-free first
// conv), bias and ReLU fused, on the Hopper mainloop (sm90_igemm.cuh: TMA
// halo boxes, bf16 wgmma k16 into f32, warp-specialised, persistent), with
// H8's tile design (std_conv3x3_s8.cu StdTiles):
//
//   single: y = bf16(relu(f32(sum x * w) + b))
//   dual:   y = bf16(relu(f32(sum crop(skip) * wa + sum up * wb) + b))
//
// one f32 accumulator over every tap and K block (both sides of the
// dual), the f32 bias added once, rounded once to bf16 (nearest even).
//
// Replaces models/unet_fast.py UNetS2DInference._std_conv and
// _std_dual_conv as they were: nn/layers.conv2d (cuDNN) and its _finish
// (a bias add and a ReLU, each an ATen pass over the output), the dual's
// two convs, their add and the skip crop's copy. The JAX package leaves
// these convs to XLA (segmentation_tpu/models/unet_fast.py _std_conv
// :1045, _std_dual_conv :1050); there is no Pallas kernel.
//
// Bound on the H100: the operations. A B = 64 request of the 512^2 U-Net
// (n_kernels 32) runs ~1.94 TFLOP in these ten convs (1.96 ms at 989
// TFLOP/s) against ~1.5 GB in and out once (0.45 ms at 3.35 TB/s). The
// fused epilogue keeps every output to one store: the unfused path wrote
// and read each output two to four times more (bias, ReLU, the dual's
// add, the crop copy).
//
// Design:
//  - Output tiles of th x tw pixels of one image (tiles.std_plan),
//    laid out as GEMM rows m = a (tw + 2) + b: two junk columns a row, so
//    each of the nine taps (u, v) reads one halo box shifted by whole rows,
//    u (tw + 2) + v. Junk rows store nothing.
//  - A, per K block of 64 bf16 channels (128 bytes): the 4-D TMA box [1,
//    th + 2, tw + 2, 64] of the side's tensor at (n, i0, j0, k0), zeros
//    past C and past the image (which only junk rows read). The dual's
//    skip: the box at the crop origin (oh + i0, ow + j0); no copy of the
//    crop. The up side: the box of up itself.
//  - B: the HWIO weight [3, 3, C, O] as it lies (the dual's halves are
//    views of the concat weight [3, 3, 2C, O], strides ldu, ldv), read
//    MN-major (bf16 wgmma transposes B): per K block and tap the 4-D box
//    [1, 1, 64 K rows, 64 columns] at (u, v, k0, col) for each 64 columns
//    of the column tile; zeros past C.
//  - Columns: tiles of NB = 256 where that divides O (O = 512, conv5_x:
//    two column tiles a pixel tile, taken by neighbouring blocks), else
//    128. Rows: NB = 128, tiles of 256 GEMM rows, 128 a consumer
//    warpgroup (two m64n128); NB = 256, 128 rows, 64 a consumer (m64n256).
//    One accumulator, so the dual tiles as the single.
//  - Epilogue in registers: acc + b (f32), ReLU, then sm90::store_acc
//    rounds to bf16 and stores 4 rows x 128 contiguous bytes a warp store.
#include "sm90_igemm.cuh"

namespace segk {

template <int NB_, bool DUAL>
struct StdBf16Tiles {
  using Acc = float;
  using bf16 = sm90::bf16;
  static constexpr int NB = NB_;
  static constexpr int SIDES = 1;  // one f32 accumulator, the dual's too
  static constexpr int TAPS = 9;
  static constexpr bool SPLIT_N = false;
  static constexpr int NI = NB;
  static constexpr int MI = NB == 128 ? 2 : 1;
  static constexpr bool PINGPONG = false;
  // GEMM rows of a tile and the widest row stride tw + 2 (tiles.std_tile,
  // one accumulator: the s8 single's tiles)
  static constexpr int BM = 128 * MI;
  static constexpr int W_MAX = 128;
  // an A slot: the largest tap shift (2 (tw + 2) + 2) and BM rows after it
  static constexpr int A_ROWS = (BM + 2 * W_MAX + 2 + 7) / 8 * 8;
  static constexpr int A_STAGES = 2;
  static constexpr int STAGE_BYTES = 0;
  static constexpr int B_STAGES = sm90::stages_that_fit(
      1024 + 8 * sm90::kScratch + 128 + A_STAGES * A_ROWS * 128, NB * 128,
      4);
  static constexpr bool B_MN = true, GATHER = false;
  static constexpr int PRODUCER_REGS = sm90::kProducerRegs;

  CUtensorMap xmap, wmap;   // single: x and w; dual: up and wb
  CUtensorMap smap, wsmap;  // dual: skip and wa
  const float* bias;        // [O]
  bf16* y;
  int o;                    // output channels (y's row)
  int kps;                  // a side's K blocks: ceil(C / 64)
  int oh, ow;               // dual: the crop origin in the skip
  int ho, wo;               // output grid
  int th, tw, tiles_w, tiles_hw, col_tiles, n_tiles;

  __device__ int tiles() const { return n_tiles; }
  // tile t -> image n and first output pixel (i0, j0): tiles.tile_plan's
  // map over [N, tiles_h, tiles_w], each pixel tile col_tiles times in a
  // row
  __device__ void origin(int t, int& n, int& i0, int& j0) const {
    const int pt = t / col_tiles;
    n = pt / tiles_hw;
    const int r = pt - n * tiles_hw;
    const int ti = r / tiles_w;
    i0 = ti * th;
    j0 = (r - ti * tiles_w) * tw;
  }
  __device__ int col0(int t) const { return (t % col_tiles) * NB; }
  __device__ int k_blocks() const { return DUAL ? 2 * kps : kps; }
  __device__ bool skip_side(int kb) const { return DUAL && kb < kps; }
  __device__ uint32_t a_tx(int) const {
    return (uint32_t)((th + 2) * (tw + 2)) * 128u;
  }
  __device__ int a_row(int tap) const {  // (u, v) = (tap / 3, tap % 3)
    return tap / 3 * (tw + 2) + tap % 3;
  }
  __device__ void prefetch() const {
    sm90::prefetch_map(&xmap);
    sm90::prefetch_map(&wmap);
    if (DUAL) {
      sm90::prefetch_map(&smap);
      sm90::prefetch_map(&wsmap);
    }
  }
  __device__ void load_a(int t, int kb, uint8_t* a, uint64_t* bar) const {
    int n, i0, j0;
    origin(t, n, i0, j0);
    if (skip_side(kb))
      sm90::tma_load_4d(a, &smap, bar, 64 * kb, ow + j0, oh + i0, n);
    else
      sm90::tma_load_4d(a, &xmap, bar, 64 * (DUAL ? kb - kps : kb), j0, i0,
                        n);
  }
  // the B rows of (K block, tap): 64 K rows of the side's weight at tap
  // (u, v), one [64, 64] box per 64 columns of the column tile
  __device__ void load_b(int t, int kb, int tap, uint8_t* b,
                         uint64_t* bar) const {
    const bool sk = skip_side(kb);
    const int k0 = 64 * (DUAL && !sk ? kb - kps : kb);
#pragma unroll
    for (int j = 0; j < NB / 64; ++j)
      sm90::tma_load_4d(b + j * sm90::kMnBox, sk ? &wsmap : &wmap, bar,
                        col0(t) + 64 * j, k0, tap % 3, tap / 3);
  }

  // the flat output pixel of GEMM row m of the tile at (n, i0, j0), or -1
  // for a junk row or a row past the output
  __device__ long long pixel(int n, int i0, int j0, int m) const {
    const int w = tw + 2;
    const int a = m / w, b = m - a * w;
    const int i = i0 + a, j = j0 + b;
    if (a >= th || b >= tw || i >= ho || j >= wo) return -1;
    return ((long long)n * ho + i) * wo + j;
  }

  // relu(acc + b) in place, then one consumer's rows stored as bf16.
  // Fragment: acc[mi][4 jn + 2 h + e] is row m0 + 64 mi + lane / 4 + 8 h,
  // column col0 + 8 jn + 2 q + e (q = lane % 4).
  __device__ void store(int t, int cg, float (&acc)[MI][NI / 2],
                        uint8_t* scratch, uint8_t*) const {
    const int q = threadIdx.x & 3, c0 = col0(t);
    const float2* b2p = reinterpret_cast<const float2*>(bias + c0);
#pragma unroll
    for (int jn = 0; jn < NI / 8; ++jn) {
      const float2 b2 = __ldg(b2p + 4 * jn + q);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& d = acc[mi][4 * jn + e];
          d = fmaxf(__fadd_rn(d, e & 1 ? b2.y : b2.x), 0.0f);
        }
    }
    int n, i0, j0;
    origin(t, n, i0, j0);
    const int m0 = cg * 64 * MI + 16 * ((threadIdx.x >> 5) & 3);
    sm90::store_acc<NI, MI>(acc, scratch, [&](int mi, int row, int col) {
      const long long pix = pixel(n, i0, j0, m0 + 64 * mi + row);
      return pix < 0 ? (bf16*)nullptr : y + pix * o + c0 + col;
    });
  }
};

template <int NB, bool DUAL>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    std_conv3x3_bf16_kernel(const __grid_constant__ StdBf16Tiles<NB, DUAL> p) {
  sm90::run(p);
}

// the dual under its own name: profiles group kernels by name
template <int NB, bool DUAL>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    std_conv3x3_dual_bf16_kernel(
        const __grid_constant__ StdBf16Tiles<NB, DUAL> p) {
  sm90::run(p);
}

// The operands, as the C entries take them (a single has no skip).
struct StdBf16Args {
  const void *skip, *x, *wa, *w, *bias;
  void* y;
  int n, hs, ws, hx, wx, c, o, oh, ow, ldv, ldu, th, tw;
  cudaStream_t stream;
};

// The map of a side [n, h, w, c] read as [1, th + 2, tw + 2, 64] halo
// boxes, and of its weight [3, 3, c, o] (row strides ldv, ldu elements
// between taps) read as [1, 1, 64, 64] boxes.
inline int std_bf16_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                         const void* w, const StdBf16Args& a, int h, int wd) {
  const cuuint64_t xdims[4] = {(cuuint64_t)a.c, (cuuint64_t)wd,
                               (cuuint64_t)h, (cuuint64_t)a.n};
  const cuuint32_t xbox[4] = {64, (cuuint32_t)a.tw + 2, (cuuint32_t)a.th + 2,
                              1};
  const cuuint64_t wdims[4] = {(cuuint64_t)a.o, (cuuint64_t)a.c, 3, 3};
  const cuuint64_t wstrides[3] = {(cuuint64_t)a.o * 2, (cuuint64_t)a.ldv * 2,
                                  (cuuint64_t)a.ldu * 2};
  const cuuint32_t wbox[4] = {64, 64, 1, 1};
  int e = sm90::make_map(xmap, x, 4, xdims, xbox);
  if (e == 0) e = sm90::make_map_strided(wmap, w, 4, wdims, wstrides, wbox);
  return e;
}

template <int NB, bool DUAL>
int run_std_bf16(const StdBf16Args& a) {
  using P = StdBf16Tiles<NB, DUAL>;
  if (a.th * (a.tw + 2) > P::BM || a.tw + 2 > P::W_MAX || a.th + 2 > 256)
    return (int)cudaErrorInvalidValue;
  P p{};
  int e = std_bf16_maps(&p.xmap, &p.wmap, a.x, a.w, a, a.hx, a.wx);
  if (e == 0 && DUAL)
    e = std_bf16_maps(&p.smap, &p.wsmap, a.skip, a.wa, a, a.hs, a.ws);
  if (e != 0) return e;
  p.bias = (const float*)a.bias;
  p.y = (sm90::bf16*)a.y;
  p.o = a.o;
  p.kps = (a.c + 63) / 64;
  p.oh = a.oh;
  p.ow = a.ow;
  p.ho = a.hx - 2;
  p.wo = a.wx - 2;
  p.th = a.th;
  p.tw = a.tw;
  p.tiles_w = (p.wo + a.tw - 1) / a.tw;
  p.tiles_hw = p.tiles_w * ((p.ho + a.th - 1) / a.th);
  p.col_tiles = a.o / NB;
  p.n_tiles = a.n * p.tiles_hw * p.col_tiles;
  if constexpr (DUAL)
    return sm90::launch(std_conv3x3_dual_bf16_kernel<NB, DUAL>, p, a.stream);
  else
    return sm90::launch(std_conv3x3_bf16_kernel<NB, DUAL>, p, a.stream);
}

// The column tile: 256 where it divides O, else 128 (tiles.std_tile).
template <bool DUAL>
int std_bf16_cols(const StdBf16Args& a) {
  return a.o % 256 == 0 ? run_std_bf16<256, DUAL>(a)
                        : run_std_bf16<128, DUAL>(a);
}

// Shapes both entries take: c % 8 == 0 (TMA's 16-byte strides), o % 128
// == 0, a weight row of o contiguous values and taps ldv, ldu = 3 ldv
// elements apart (each a multiple of 8).
inline bool std_bf16_ok(int n, int hx, int wx, int c, int o, int ldv,
                        int ldu, int th, int tw) {
  return n >= 1 && hx >= 3 && wx >= 3 && c >= 8 && c % 8 == 0 && o >= 128 &&
         o % 128 == 0 && ldv >= c * o && ldv % 8 == 0 && ldu == 3 * ldv &&
         th >= 1 && tw >= 1;
}

}  // namespace segk

// The single: x [n, hx, wx, c] bf16; w [3, 3, c, o] bf16 (strides ldu, ldv,
// o, 1); b [o] f32; y [n, hx-2, wx-2, o] bf16; (th, tw) the output tile
// from tiles.std_plan. Every pointer 16-byte aligned.
extern "C" int seg_std_conv3x3(const void* x, const void* w, const void* b,
                               void* y, int n, int hx, int wx, int c, int o,
                               int ldv, int ldu, int th, int tw,
                               void* stream) {
  using namespace segk;
  if (!std_bf16_ok(n, hx, wx, c, o, ldv, ldu, th, tw))
    return (int)cudaErrorInvalidValue;
  StdBf16Args a{};
  a.x = x;
  a.w = w;
  a.bias = b;
  a.y = y;
  a.n = n;
  a.hx = hx;
  a.wx = wx;
  a.c = c;
  a.o = o;
  a.ldv = ldv;
  a.ldu = ldu;
  a.th = th;
  a.tw = tw;
  a.stream = (cudaStream_t)stream;
  return std_bf16_cols<false>(a);
}

// The dual: skip [n, hs, ws, c] center-cropped at (oh, ow) to up's [n, hx,
// wx, c], both bf16; wa, wb [3, 3, c, o] bf16, the skip's and up's halves
// of the concat weight (each with strides ldu, ldv, o, 1); b [o] f32; y
// [n, hx-2, wx-2, o] bf16; (th, tw) from tiles.std_plan. Every
// pointer 16-byte aligned.
extern "C" int seg_std_conv3x3_dual(const void* skip, const void* up,
                                    const void* wa, const void* wb,
                                    const void* b, void* y, int n, int hs,
                                    int ws, int hx, int wx, int c, int o,
                                    int oh, int ow, int ldv, int ldu, int th,
                                    int tw, void* stream) {
  using namespace segk;
  if (!std_bf16_ok(n, hx, wx, c, o, ldv, ldu, th, tw) || oh < 0 || ow < 0 ||
      oh + hx > hs || ow + wx > ws)
    return (int)cudaErrorInvalidValue;
  StdBf16Args a{};
  a.skip = skip;
  a.x = up;
  a.wa = wa;
  a.w = wb;
  a.bias = b;
  a.y = y;
  a.n = n;
  a.hs = hs;
  a.ws = ws;
  a.hx = hx;
  a.wx = wx;
  a.c = c;
  a.o = o;
  a.oh = oh;
  a.ow = ow;
  a.ldv = ldv;
  a.ldu = ldu;
  a.th = th;
  a.tw = tw;
  a.stream = (cudaStream_t)stream;
  return std_bf16_cols<true>(a);
}
