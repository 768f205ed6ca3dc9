// H6 packed_conv2x2_dgrad: the input gradient of H1's 2x2 VALID conv over a
// packed tensor, and of both halves of H2's dual conv in one launch.
//
//   dx[n, i, j, c] = sum over u, v in {0, 1} and o of
//                    g[n, i-u, j-v, o] * w[u, v, c, o]
//
// g [N, hg, wg, 4O] bf16 is the (ReLU-masked) output cotangent, zero outside
// its extent, read in place from a buffer of g_rows x g_cols pixels an
// image (the zero-margined cotangent train_glue.cu writes); dx [N, hg+1,
// wg+1, 4C] bf16, accumulated in f32. The dual mode computes dxa from wa and
// dxb from wb out of the same g. In training, the dual site's skip enters
// H2 uncropped: its dxa is stored straight into the crop window of the
// skip's gradient [N, hpa, wpa, 4C] at the unpacked offset (oh, ow), by the
// address rule H2 reads the skip with (output slot (d, e) of pixel (i, j)
// to packed pixel ((oh + d) / 2 + i, (ow + e) / 2 + j), slot ((oh + d) % 2,
// (ow + e) % 2)), so the gradient of the crop is never made and un-cropped
// (train_glue.cu zeros the rest of that buffer).
//
// Replaces the TPU kernels segmentation_tpu/nn/pallas/conv_flat_bwd.py
// conv2x2_dgrad_padflat (:119) and conv2x2_dgrad_dual_padflat (:217).
//
// Bound on the H100: the tensor operations of the packed form, an implicit
// GEMM of K = 4 taps x 4O against 4C columns (8C for the dual). 7 of its 16
// slot blocks per tap are zero, so it does 16/9 of the function's
// operations; at 4O, 4C >= 128 that is far above the card's ~295
// operations per byte of HBM.
//
// Design (sm90_igemm.cuh runs it): output tiles are th x tw pixel
// rectangles of one image, laid out as GEMM rows m = a W + b with the row
// stride W = tw + 1 (one junk column per image row; th W <= BM; the
// wrapper's tiles.tile_plan picks th and tw), walked by one persistent
// block per SM.
//  - A is a halo box. For K block k0 (64 channels) one 4-D TMA load reads
//    the box [1, th + 1, W, 64] of g at (n, i0 - 1, j0 - 1, k0) into a
//    128-byte-swizzled K-major A slot. Pixel (a, b) of tap (u, v) reads g
//    at slot row (a + 1 - u) W + (b + 1 - v) = m + (1 - u) W + (1 - v), so
//    each tap's A operand is the slot shifted by a constant number of rows:
//    g is read from L2 once per K block, not once per tap. TMA fills every
//    element outside g with zero, negative coordinates and channels past
//    4O included: that is the dgrad's boundary rule, with no per-element
//    index arithmetic or check in the kernel.
//  - B is w itself: for tap t, w viewed as [4 * 4C, 4O] has the K-major
//    rows t 4C + c, one 2-D TMA box [4C, 64] per K block and tap (the
//    dual: wa's and wb's boxes side by side, NB = 8C); no transposed copy.
//  - Tiles (BM GEMM rows x NB columns): 4C = 128: BM = 256 (each consumer
//    128 rows, two m64n128); 4C = 256: BM = 128 (each consumer 64 rows,
//    m64n256); dual 4C = 128: BM = 128 over NB = 256 columns [wa | wb];
//    dual 4C = 256: BM = 64, one consumer per half (m64n256 each) from the
//    same A slots, so g is read once for both. 4C = 512 (n_kernels 64's
//    level 2): more than one wgmma's 256 columns a side, so each pixel tile
//    is CT = 2 column tiles of CW = 256 channels of dx (dxa and dxb alike),
//    each taken as the 4C = 256 tiles are (single: BM = 128; dual: BM =
//    64, a consumer a side); B is a [256, 64] box of the weight's rows a
//    side. The epilogue stores plain values, so a column tile is a plain
//    run of channels; a pixel tile's column tiles are consecutive tiles of
//    the walk, so its halo box of g is read from L2 the second time.
//  - The epilogue rounds to bf16 (__float2bfloat16, nearest even), moves
//    each warp's fragment through stmatrix and stores 4 rows x 128
//    contiguous bytes per instruction, skipping junk rows and rows outside
//    dx. No atomics: two launches give
//    the same bits.
//  - Where the time goes (B = 8, the six sites, on the H100): the wgmma
//    loop alone runs at ~74 % of the tensor peak; the loads add ~10 % and
//    the epilogue ~30 % (~50 % with 16-row x 32-byte stores): both
//    consumers store at once and the tensor cores wait (PERF.md).
#include "sm90_igemm.cuh"

namespace segk {

using sm90::bf16;

template <int C4, bool DUAL>
struct DgradTiles {
  // column tiles of a pixel tile, and a side's channels CW in each
  static constexpr int CT = C4 > 256 ? C4 / 256 : 1;
  static constexpr int CW = C4 / CT;
  static constexpr int NB = DUAL ? 2 * CW : CW;
  static constexpr bool SPLIT_N = NB == 512;
  static constexpr int NI = SPLIT_N ? 256 : NB;
  static constexpr int MI = NI == 128 ? 2 : 1;
  static constexpr int BM = SPLIT_N ? 64 : 128 * MI;
  // an A slot holds the largest tap shift (W + 1 <= BM + 1, W <= 256) and
  // BM rows after it
  static constexpr int A_ROWS = (BM + (BM < 256 ? BM : 256) + 1 + 7) / 8 * 8;
  static constexpr int A_STAGES = 2;
  static constexpr int B_STAGES = sm90::stages_that_fit(
      1024 + 8 * sm90::kScratch + 128 + A_STAGES * A_ROWS * 128, NB * 128, 4);
  static constexpr int TAPS = 4, SIDES = 1;
  using Acc = float;
  static constexpr int PRODUCER_REGS = sm90::kProducerRegs;
  static constexpr bool B_MN = false, GATHER = false, PINGPONG = false;
  static constexpr int STAGE_BYTES = 0;

  CUtensorMap gmap, wamap, wbmap;
  bf16* dxa;
  bf16* dxb;
  int hx, wx, th, tw, tiles_w, tiles_hw, n_tiles, kb;
  int hpa, wpa, oh, ow;  // dxa's buffer and the crop window's offset

  __device__ int tiles() const { return n_tiles; }
  __device__ int k_blocks() const { return kb; }
  __device__ uint32_t a_tx(int) const {
    return (uint32_t)((th + 1) * (tw + 1)) * 128u;
  }
  __device__ int a_row(int tap) const {  // (u, v) = (tap >> 1, tap & 1)
    return (1 - (tap >> 1)) * (tw + 1) + 1 - (tap & 1);
  }
  __device__ void prefetch() const {
    sm90::prefetch_map(&gmap);
    sm90::prefetch_map(&wamap);
    if (DUAL) sm90::prefetch_map(&wbmap);
  }
  // tile t -> image n and its first pixel (i0, j0): tiles.tile_plan's
  // map, row-major over [N, tiles_h, tiles_w], each pixel tile's CT column
  // tiles in a row
  __device__ void origin(int t, int& n, int& i0, int& j0) const {
    if constexpr (CT > 1) t /= CT;
    n = t / tiles_hw;
    const int r = t - n * tiles_hw;
    const int ti = r / tiles_w;
    i0 = ti * th;
    j0 = (r - ti * tiles_w) * tw;
  }
  __device__ void load_a(int t, int k, uint8_t* a, uint64_t* bar) const {
    int n, i0, j0;
    origin(t, n, i0, j0);
    sm90::tma_load_4d(a, &gmap, bar, 64 * k, j0 - 1, i0 - 1, n);
  }
  // tile t's first channel of dx (of each side)
  __device__ int c0(int t) const { return CT > 1 ? CW * (t % CT) : 0; }
  // the B rows [wa | wb] of (K block, tap), one box per weight
  __device__ void load_b(int t, int k, int tap, uint8_t* b,
                         uint64_t* bar) const {
    const int row = tap * C4 + c0(t);
    sm90::tma_load_2d(b, &wamap, bar, 64 * k, row);
    if (DUAL) sm90::tma_load_2d(b + CW * 128, &wbmap, bar, 64 * k, row);
  }
  __device__ void store(int t, int cg, float (&acc)[MI][NI / 2],
                        uint8_t* scratch, uint8_t*) const {
    int n, i0, j0;
    origin(t, n, i0, j0);
    const int w = tw + 1;
    const int m0 = (SPLIT_N ? 0 : cg * 64 * MI) + 16 * ((threadIdx.x >> 5) & 3);
    bf16* const out = SPLIT_N && cg ? dxb : dxa;
    const int ch0 = c0(t);
    // row `row` of the warp's 16 in m64 group mi is GEMM row m = a w + b
    sm90::store_acc<NI, MI>(acc, scratch,
                            [&](int mi, int row, int lc) -> bf16* {
      const int m = m0 + 64 * mi + row;
      const int a = m / w, b = m - a * w;
      const int i = i0 + a, j = j0 + b;
      if (a >= th || b >= tw || i >= hx || j >= wx) return nullptr;
      const long long pix = ((long long)n * hx + i) * wx + j;
      if (DUAL && !SPLIT_N && lc >= CW) return dxb + pix * C4 + ch0 + lc - CW;
      const int col = ch0 + lc;  // the channel of dx
      if (DUAL && out == dxa) {  // through the crop: 8 channels of one slot
        constexpr int CS = C4 / 4;
        const int s = col / CS, yy = oh + (s >> 1), xx = ow + (s & 1);
        const long long pa =
            ((long long)n * hpa + (yy >> 1) + i) * wpa + (xx >> 1) + j;
        return dxa + pa * C4 + (2 * (yy & 1) + (xx & 1)) * CS + col - s * CS;
      }
      return out + pix * C4 + col;
    });
  }
};

template <int C4, bool DUAL>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    packed_conv2x2_dgrad_kernel(const __grid_constant__ DgradTiles<C4, DUAL> p) {
  sm90::run(p);
}

// The operands as the C entry takes them.
struct DgradArgs {
  const void *g, *wa, *wb;
  void *dxa, *dxb;
  int n, hg, wg, o4, th, tw, g_rows, g_cols, hpa, wpa, oh, ow;
};

template <int C4, bool DUAL>
int dgrad(const DgradArgs& a, cudaStream_t stream) {
  using P = DgradTiles<C4, DUAL>;
  if (a.th * (a.tw + 1) > P::BM) return (int)cudaErrorInvalidValue;
  P p{};
  const int n = a.n, hg = a.hg, wg = a.wg, o4 = a.o4, th = a.th, tw = a.tw;
  const cuuint64_t gdims[4] = {(cuuint64_t)o4, (cuuint64_t)wg,
                               (cuuint64_t)hg, (cuuint64_t)n};
  const cuuint64_t gstrides[3] = {
      (cuuint64_t)o4 * 2, (cuuint64_t)o4 * 2 * a.g_cols,
      (cuuint64_t)o4 * 2 * a.g_cols * a.g_rows};
  const cuuint32_t gbox[4] = {64, (cuuint32_t)tw + 1, (cuuint32_t)th + 1, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)o4, (cuuint64_t)(4 * C4)};
  const cuuint32_t wbox[2] = {64, (cuuint32_t)P::CW};
  const void *g = a.g, *wa = a.wa, *wb = a.wb;
  int e = sm90::make_map_strided(&p.gmap, g, 4, gdims, gstrides, gbox);
  if (e == 0) e = sm90::make_map(&p.wamap, wa, 2, wdims, wbox);
  if (e == 0 && DUAL) e = sm90::make_map(&p.wbmap, wb, 2, wdims, wbox);
  if (e != 0) return e;
  p.dxa = (bf16*)a.dxa;
  p.dxb = (bf16*)a.dxb;
  p.hpa = a.hpa;
  p.wpa = a.wpa;
  p.oh = a.oh;
  p.ow = a.ow;
  p.hx = hg + 1;
  p.wx = wg + 1;
  p.th = th;
  p.tw = tw;
  p.tiles_w = (p.wx + tw - 1) / tw;
  p.tiles_hw = p.tiles_w * ((p.hx + th - 1) / th);
  p.n_tiles = n * p.tiles_hw * P::CT;
  p.kb = (o4 + 63) / 64;
  return sm90::launch(packed_conv2x2_dgrad_kernel<C4, DUAL>, p, stream);
}

}  // namespace segk

// g [n, hg, wg, o4] bf16 in a buffer of g_rows >= hg rows of g_cols >= wg
// pixels an image; wa (and wb for the dual, else null) [2, 2, c4, o4] bf16;
// dxa (and dxb) [n, hg+1, wg+1, c4] bf16, the dual's dxa in a buffer [n,
// hpa, wpa, c4] at the unpacked crop offset (oh, ow) (hpa = hg + 1, wpa =
// wg + 1 and (0, 0) where it is not cropped; the single mode takes only
// that); c4 = 128, 256 or 512; (th, tw) the output tile from
// tiles.tile_plan (th (tw + 1) GEMM rows). Every pointer 16-byte aligned.
extern "C" int seg_packed_conv2x2_dgrad(const void* g, const void* wa,
                                        const void* wb, void* dxa, void* dxb,
                                        int n, int hg, int wg, int o4, int c4,
                                        int th, int tw, int g_rows,
                                        int g_cols, int hpa, int wpa, int oh,
                                        int ow, void* stream) {
  using namespace segk;
  const bool dual = wb != nullptr;
  const bool crop = hpa != hg + 1 || wpa != wg + 1 || oh != 0 || ow != 0;
  if (o4 < 8 || o4 % 8 || (c4 != 128 && c4 != 256 && c4 != 512) || n < 1 ||
      hg < 1 || wg < 1 || th < 1 || tw < 1 || th > 255 || tw > 255 ||
      dual != (dxb != nullptr) || g_rows < hg || g_cols < wg ||
      (crop && !dual) || oh < 0 || ow < 0 || oh + 2 * (hg + 1) > 2 * hpa ||
      ow + 2 * (wg + 1) > 2 * wpa)
    return (int)cudaErrorInvalidValue;
  const DgradArgs a{g,  wa, wb, dxa,    dxb,    n,   hg,  wg, o4,
                    th, tw, g_rows, g_cols, hpa, wpa, oh, ow};
  cudaStream_t s = (cudaStream_t)stream;
  if (c4 == 128)
    return dual ? dgrad<128, true>(a, s) : dgrad<128, false>(a, s);
  if (c4 == 256)
    return dual ? dgrad<256, true>(a, s) : dgrad<256, false>(a, s);
  return dual ? dgrad<512, true>(a, s) : dgrad<512, false>(a, s);
}
