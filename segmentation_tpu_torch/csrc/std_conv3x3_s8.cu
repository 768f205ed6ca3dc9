// H8 std_conv3x3_s8: the standard levels' int8 3x3 VALID conv of the int8
// U-Net, single and dual (the decoder's concat-free first conv), with its
// epilogue fused, on the Hopper mainloop (sm90_igemm.cuh: TMA halo boxes or
// operands gathered by the producer warpgroup, s8 wgmma into s32,
// warp-specialised, persistent):
//
//   single: y = relu(f32(conv(x, w)) * mul + add), requantized to s8
//           (round half to even, clip +-127) or rounded to bf16;
//   dual:   ya = bf16(f32(conv(crop(skip), wa)) * cs_a),
//           y  = (f32(ya) + f32(conv(up, wb)) * cs_b) + b, then s8 as
//           clip(rint(max(y / out_scale, 0))) (a true division) or bf16 as
//           relu(y).
//
// Every step rounds as segmentation_tpu/models/unet_int8.py int8_conv
// (:72) and int8_std_dual_conv (:104) do, one IEEE operation at a time
// (__fmul_rn, __fadd_rn, __fdiv_rn); mul, add, cs_a and cs_b are the f32
// vectors models/unet_int8.py plan computes on the host by the same f32
// operations. The JAX package leaves this conv to XLA (no Pallas kernel);
// PyTorch has no s8 conv on CUDA, so this kernel is how the function
// reaches the card.
//
// Design:
//  - Output tiles of th x tw pixels of one image, laid out as GEMM rows m =
//    a (tw + 2) + b: two junk columns a row, so that each of the nine taps
//    (u, v) reads one halo box shifted by whole rows, u (tw + 2) + v.
//  - A, per K block of 128 s8 channels: the 4-D TMA box [1, th + 2, tw + 2,
//    128] of the side's tensor at (n, i0, j0, k0), zeros past C and past
//    the image (which only junk rows read). The dual's skip: the box at the
//    crop origin (oh + i0, ow + j0), no copy of the crop. A side in bf16
//    (the dual's up side: the std deconvs stay bf16) is gathered by the
//    producer warpgroup's three idle warps, 16 channels at a time, and
//    quantized as they store it by the XLA-side rule, clip(rint(f32(x) /
//    scale)) (int8_epilogue.cuh quant_byte_div: a division, as JAX's
//    _quant_act; the Pallas kernels' multiply by f32(1 / scale) is another
//    function).
//  - B: the K-major copy wk [O, 9C] of the weight [3, 3, C, O] (s8 wgmma
//    has no transposed B; conv_int8.k_major, made once in
//    UNetS2DInt8.plan), one box [NB columns, 128 K bytes] per K block and
//    tap at K = tap C + 128 kb. Where C < 128 the box runs into the next
//    tap's weights, which meet A's zero channels; C <= 64 (conv3_1) runs
//    two of the four k32 steps of a K block (KSTEPS 2).
//  - Columns: tiles of NB = 128 or 256 columns; O = 512 (conv5_x) walks
//    two column tiles per pixel tile (wgmma N is at most 256).
//  - Rows: single NB = 128, tiles of 256 GEMM rows, 128 a consumer
//    warpgroup (two m64n128); single NB = 256, 128 rows, 64 a consumer
//    (m64n256); dual, one s32 accumulator a side (the sides' scales
//    differ): NB = 128 tiles of 128 rows, 64 a consumer; NB = 256 tiles of
//    64 rows, each consumer half the columns (m64n128 a side).
//  - Epilogue in registers (finished values as f32 bits in the s32
//    accumulators), stored 4 rows x 128 contiguous bytes a warp store
//    (sm90::store_acc_s8 / store_acc); junk rows store nothing.
//
// Bound on the H100: the operations. At B = 8, 512^2 the twelve products
// of a request are ~242 G s8 operations (0.122 ms at 1,979 TOP/s) against
// ~166 MB in and out (0.050 ms at 3.35 TB/s); the fused epilogue keeps the
// s32 accumulators, the im2col matrix and the epilogue's passes out of
// device memory.
#include <type_traits>

#include "int8_epilogue.cuh"
#include "sm90_igemm.cuh"

namespace segk {

template <int NB_, bool DUAL, bool BF16_OUT, bool HALF>
struct StdTiles {
  using Acc = int;
  using OutT = std::conditional_t<BF16_OUT, bf16, s8>;
  static constexpr int NB = NB_;
  static constexpr int SIDES = DUAL ? 2 : 1;
  static constexpr int TAPS = 9;
  static constexpr bool SPLIT_N = DUAL && NB == 256;
  static constexpr int NI = SPLIT_N ? 128 : NB;
  static constexpr int MI = NB == 128 && !DUAL ? 2 : 1;
  static constexpr bool PINGPONG = false;
  // GEMM rows of a tile and the widest row stride tw + 2 (tiles.std_tile,
  // whose rows the dual's two accumulators halve)
  static constexpr int BM = SPLIT_N ? 64 : 128 * MI;
  static constexpr int W_MAX = BM >= 128 ? 128 : 64;
  // an A slot: the largest tap shift (2 (tw + 2) + 2) and BM rows after it
  static constexpr int A_ROWS = (BM + 2 * W_MAX + 2 + 7) / 8 * 8;
  static constexpr int A_STAGES = 2;
  static constexpr int STAGE_BYTES = 0;
  static constexpr int B_STAGES = sm90::stages_that_fit(
      1024 + 8 * sm90::kScratch + 128 + A_STAGES * A_ROWS * 128, NB * 128,
      4);
  static constexpr bool B_MN = false, GATHER = DUAL;
  static constexpr int KSTEPS = HALF ? 2 : 4;
  // the gather keeps GATHER_CHUNKS chunks of each thread in flight (two
  // 16-byte loads each)
  static constexpr int GATHER_CHUNKS = 4;
  static constexpr int PRODUCER_REGS = GATHER ? 80 : sm90::kProducerRegs;

  CUtensorMap xmap, wmap;   // single: x and wk; dual: up and wkb
  CUtensorMap smap, wsmap;  // dual: skip and wka
  const uint8_t* skip;      // dual: the sides, where gathered (bf16)
  const uint8_t* xs;
  const float* mul;         // single: the epilogue's vectors [O]
  const float* add;
  const float* cs_a;        // dual: the sides' dequant scales, bias [O]
  const float* cs_b;
  const float* bias;
  float out_scale;          // dual, s8 out: f32(out_scale)
  float scale_a, scale_b;   // dual: a bf16 side's f32(act_scale), else 0
  OutT* y;
  int o;                    // output channels (y's row)
  int c, kps;               // a side's channels and its K blocks
  int hx, wx;               // x's (up's) grid
  int hs, ws, oh, ow;       // dual: the skip's grid and the crop origin
  int ho, wo;               // output grid
  int th, tw, tiles_w, tiles_hw, col_tiles, n_tiles;

  __device__ int tiles() const { return n_tiles; }
  // tile t -> column tile cb, image n and first output pixel (i0, j0):
  // tiles.tile_plan's map over [N, tiles_h, tiles_w], each pixel tile
  // col_tiles times in a row
  __device__ void origin(int t, int& n, int& i0, int& j0) const {
    const int pt = t / col_tiles;
    n = pt / tiles_hw;
    const int r = pt - n * tiles_hw;
    const int ti = r / tiles_w;
    i0 = ti * th;
    j0 = (r - ti * tiles_w) * tw;
  }
  // the first column of consumer cg's accumulators in y's row
  __device__ int col0(int t, int cg) const {
    return (t % col_tiles) * NB + (SPLIT_N ? cg * NI : 0);
  }
  __device__ int k_blocks() const { return SIDES * kps; }
  __device__ bool skip_side(int kb) const { return DUAL && kb < kps; }
  __device__ bool gathered(int kb) const {
    return GATHER && (skip_side(kb) ? scale_a : scale_b) > 0.0f;
  }
  __device__ uint32_t a_tx(int kb) const {
    return gathered(kb) ? 0u : (uint32_t)((th + 2) * (tw + 2)) * 128u;
  }
  __device__ int a_row(int tap) const {  // (u, v) = (tap / 3, tap % 3)
    return tap / 3 * (tw + 2) + tap % 3;
  }
  __device__ void prefetch() const {
    if (!gathered(k_blocks() - 1)) sm90::prefetch_map(&xmap);
    sm90::prefetch_map(&wmap);
    if (DUAL) {
      if (!gathered(0)) sm90::prefetch_map(&smap);
      sm90::prefetch_map(&wsmap);
    }
  }
  __device__ void load_a(int t, int kb, uint8_t* a, uint64_t* bar) const {
    if (gathered(kb)) return;
    int n, i0, j0;
    origin(t, n, i0, j0);
    if (skip_side(kb))
      sm90::tma_load_4d(a, &smap, bar, 128 * kb, ow + j0, oh + i0, n);
    else
      sm90::tma_load_4d(a, &xmap, bar, 128 * (DUAL ? kb - kps : kb), j0, i0,
                        n);
  }
  // A gathered K block of a bf16 side, quantized by the division
  // (sm90::gather_rows): thread tid's chunk holds channels k = 128 kb + 16
  // (tid % 8) ..; box row (bi, bj) is the side's pixel (r0 + bi, c0 + bj),
  // (r0, c0) the tile's origin, under the crop for the skip. Zero outside
  // the side and past C.
  __device__ void gather_a(int t, int kb, uint8_t* a, int tid,
                           int nthreads) const {
    if (!gathered(kb)) return;
    int n, i0, j0;
    origin(t, n, i0, j0);
    const bool sk = skip_side(kb);
    const float scale = sk ? scale_a : scale_b;
    const int hh = sk ? hs : hx, ww = sk ? ws : wx;
    const int r0 = (sk ? oh : 0) + i0, c0 = (sk ? ow : 0) + j0;
    const int k = 128 * (sk ? kb : kb - (DUAL ? kps : 0)) + 16 * (tid & 7);
    const bool live = k < c;
    const uint8_t* img =
        (sk ? skip : xs) + ((long long)n * hh * ww * c + k) * 2;
    sm90::gather_rows<GATHER_CHUNKS>(
        a, tid, nthreads, (th + 2) * (tw + 2), tw + 2, true,
        [&](int bi, int bj) {
          return reinterpret_cast<const uint4*>(
              img + ((long long)(r0 + bi) * ww + c0 + bj) * c * 2);
        },
        [&](int bi, int bj) { return live && r0 + bi < hh && c0 + bj < ww; },
        [&](uint4 lo, uint4 hi) { return quant16<true>(lo, hi, scale); });
  }
  // the B rows of (K block, tap) for the tile's column tile: the 128 K
  // bytes tap C + 128 kb .. of NB columns of the side's wk [O, 9C]
  __device__ void load_b(int t, int kb, int tap, uint8_t* b,
                         uint64_t* bar) const {
    const bool sk = skip_side(kb);
    sm90::tma_load_2d(b, sk ? &wsmap : &wmap, bar,
                      tap * c + 128 * (DUAL && !sk ? kb - kps : kb),
                      (t % col_tiles) * NB);
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

  // fragment: acc[mi][4 jn + 2 h + e] is row m0 + 64 mi + lane / 4 + 8 h,
  // column col0 + 8 jn + 2 q + e (q = lane % 4)

  // single: relu(f32(acc) * mul + add), finished, in place
  __device__ void store(int t, int cg, int (&acc)[MI][NI / 2],
                        uint8_t* scratch, uint8_t*) const {
    const int q = threadIdx.x & 3, c0 = col0(t, cg);
    const float2* m2p = reinterpret_cast<const float2*>(mul + c0);
    const float2* a2p = reinterpret_cast<const float2*>(add + c0);
#pragma unroll
    for (int jn = 0; jn < NI / 8; ++jn) {
      const float2 m2 = __ldg(m2p + 4 * jn + q);
      const float2 a2 = __ldg(a2p + 4 * jn + q);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int& d = acc[mi][4 * jn + e];
          sm90::put_f32(d, finish(affine_relu(__int2float_rn(d),
                                              e & 1 ? m2.y : m2.x,
                                              e & 1 ? a2.y : a2.x),
                                  (OutT*)nullptr));
        }
    }
    emit(t, cg, acc, scratch);
  }

  // dual: the skip's partial rounded to bf16, the up side's added, then
  // the bias; requantized by the division, or relu to bf16; in place in
  // acc_a
  __device__ void store(int t, int cg, int (&acc_a)[MI][NI / 2],
                        int (&acc_b)[MI][NI / 2], uint8_t* scratch,
                        uint8_t*) const {
    const int q = threadIdx.x & 3, c0 = col0(t, cg);
    const float2* ca2 = reinterpret_cast<const float2*>(cs_a + c0);
    const float2* cb2 = reinterpret_cast<const float2*>(cs_b + c0);
    const float2* b2p = reinterpret_cast<const float2*>(bias + c0);
#pragma unroll
    for (int jn = 0; jn < NI / 8; ++jn) {
      const float2 ca = __ldg(ca2 + 4 * jn + q);
      const float2 cb = __ldg(cb2 + 4 * jn + q);
      const float2 bb = __ldg(b2p + 4 * jn + q);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e;
          const float ya = bf_round(
              __fmul_rn(__int2float_rn(acc_a[mi][i]), e & 1 ? ca.y : ca.x));
          const float v = __fadd_rn(
              __fadd_rn(ya, __fmul_rn(__int2float_rn(acc_b[mi][i]),
                                      e & 1 ? cb.y : cb.x)),
              e & 1 ? bb.y : bb.x);
          float r;
          if constexpr (BF16_OUT)
            r = bf_round(fmaxf(v, 0.0f));
          else
            r = finish(fmaxf(__fdiv_rn(v, out_scale), 0.0f), (s8*)nullptr);
          sm90::put_f32(acc_a[mi][i], r);
        }
    }
    emit(t, cg, acc_a, scratch);
  }

  // store one consumer's finished values (f32 bits in the accumulators)
  __device__ void emit(int t, int cg, int (&acc)[MI][NI / 2],
                       uint8_t* scratch) const {
    int n, i0, j0;
    origin(t, n, i0, j0);
    const int warp = (threadIdx.x >> 5) & 3;
    const int m0 = (SPLIT_N ? 0 : cg * 64 * MI) + 16 * warp;
    const int c0 = col0(t, cg);
    auto dst = [&](int mi, int row, int col) -> OutT* {
      const long long pix = pixel(n, i0, j0, m0 + 64 * mi + row);
      return pix < 0 ? nullptr : y + pix * o + c0 + col;
    };
    if constexpr (BF16_OUT)
      sm90::store_acc<NI, MI>(acc, scratch, dst);
    else
      sm90::store_acc_s8<NI, MI>(acc, scratch, dst);
  }
};

template <int NB, bool DUAL, bool BF16_OUT, bool HALF>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    std_conv3x3_s8_kernel(
        const __grid_constant__ StdTiles<NB, DUAL, BF16_OUT, HALF> p) {
  sm90::run(p);
}

// H8's dual under its own name: profiles group kernels by name
template <int NB, bool DUAL, bool BF16_OUT, bool HALF>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    std_conv3x3_dual_s8_kernel(
        const __grid_constant__ StdTiles<NB, DUAL, BF16_OUT, HALF> p) {
  sm90::run(p);
}

// The operands, as the C entries take them (a single has no skip).
struct StdArgs {
  const void *skip, *x, *wka, *wk;
  const void *mul, *add, *cs_a, *cs_b, *bias;
  void* y;
  int n, hs, ws, hx, wx, c, o, oh, ow, th, tw;
  float scale_a, scale_b, out_scale;
  cudaStream_t stream;
};

// The s8 map of a side [n, h, w, c] read as [1, th + 2, tw + 2, 128] halo
// boxes, and of a K-major weight [o, 9c] read as [nb, 128] boxes.
inline int std_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                    const void* wk, int n, int h, int w, int c, int o,
                    int nb, int th, int tw) {
  const cuuint64_t xdims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                               (cuuint64_t)n};
  const cuuint32_t xbox[4] = {128, (cuuint32_t)tw + 2, (cuuint32_t)th + 2, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)(9 * c), (cuuint64_t)o};
  const cuuint32_t wbox[2] = {128, (cuuint32_t)nb};
  int e = x != nullptr
              ? sm90::make_map(xmap, x, 4, xdims, xbox, true, sm90::kMapS8)
              : 0;
  if (e == 0) e = sm90::make_map(wmap, wk, 2, wdims, wbox, true, sm90::kMapS8);
  return e;
}

template <int NB, bool DUAL, bool BF16_OUT, bool HALF>
int run_std(const StdArgs& a) {
  using P = StdTiles<NB, DUAL, BF16_OUT, HALF>;
  if (a.th * (a.tw + 2) > P::BM || a.tw + 2 > P::W_MAX || a.th + 2 > 256)
    return (int)cudaErrorInvalidValue;
  P p{};
  int e = std_maps(&p.xmap, &p.wmap, a.scale_b > 0.0f ? nullptr : a.x, a.wk,
                   a.n, a.hx, a.wx, a.c, a.o, NB, a.th, a.tw);
  if (e == 0 && DUAL)
    e = std_maps(&p.smap, &p.wsmap, a.scale_a > 0.0f ? nullptr : a.skip,
                 a.wka, a.n, a.hs, a.ws, a.c, a.o, NB, a.th, a.tw);
  if (e != 0) return e;
  p.skip = (const uint8_t*)a.skip;
  p.xs = (const uint8_t*)a.x;
  p.mul = (const float*)a.mul;
  p.add = (const float*)a.add;
  p.cs_a = (const float*)a.cs_a;
  p.cs_b = (const float*)a.cs_b;
  p.bias = (const float*)a.bias;
  p.out_scale = a.out_scale;
  p.scale_a = a.scale_a;
  p.scale_b = a.scale_b;
  p.y = (typename P::OutT*)a.y;
  p.o = a.o;
  p.c = a.c;
  p.kps = (a.c + 127) / 128;
  p.hx = a.hx;
  p.wx = a.wx;
  p.hs = a.hs;
  p.ws = a.ws;
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
    return sm90::launch(std_conv3x3_dual_s8_kernel<NB, DUAL, BF16_OUT, HALF>,
                        p, a.stream);
  else
    return sm90::launch(std_conv3x3_s8_kernel<NB, DUAL, BF16_OUT, HALF>, p,
                        a.stream);
}

// The column tile: 256 where it divides O, else 128 (tiles.std_tile).
template <bool DUAL, bool BF16_OUT, bool HALF>
int std_cols(const StdArgs& a) {
  return a.o % 256 == 0 ? run_std<256, DUAL, BF16_OUT, HALF>(a)
                        : run_std<128, DUAL, BF16_OUT, HALF>(a);
}

}  // namespace segk

// The single: x [n, hx, wx, c] s8 (c % 16 == 0); wk [o, 9c] s8, the
// K-major copy of the weight [3, 3, c, o] (conv_int8.k_major; o % 128 ==
// 0); mul, add [o] f32; y [n, hx-2, wx-2, o] s8 (requant != 0) or bf16;
// (th, tw) the output tile from tiles.std_plan. Every pointer 16-byte
// aligned.
extern "C" int seg_std_conv3x3_s8(const void* x, const void* wk,
                                  const void* mul, const void* add, void* y,
                                  int n, int hx, int wx, int c, int o,
                                  int requant, int th, int tw,
                                  void* stream) {
  using namespace segk;
  if (n < 1 || hx < 3 || wx < 3 || c < 16 || c % 16 || o < 128 || o % 128 ||
      th < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  StdArgs a{};
  a.x = x;
  a.wk = wk;
  a.mul = mul;
  a.add = add;
  a.y = y;
  a.n = n;
  a.hx = hx;
  a.wx = wx;
  a.c = c;
  a.o = o;
  a.th = th;
  a.tw = tw;
  a.stream = (cudaStream_t)stream;
  const bool half = c <= 64;
  if (requant)
    return half ? std_cols<false, false, true>(a)
                : std_cols<false, false, false>(a);
  return half ? std_cols<false, true, true>(a)
              : std_cols<false, true, false>(a);
}

// The dual: skip [n, hs, ws, c] and up [n, hx, wx, c], each s8 codes or
// bf16 quantized as it is gathered at scale_a / scale_b = f32(act_scale)
// where that is not 0 (c % 16 == 0); the skip center-cropped at (oh, ow)
// to up's grid; wka, wkb [o, 9c] s8 the K-major copies (o % 128 == 0);
// cs_a, cs_b, bias [o] f32; y [n, hx-2, wx-2, o] s8 requantized at
// out_scale (> 0) or bf16 (out_scale 0); (th, tw) the output tile from
// tiles.std_plan. Every pointer 16-byte aligned.
extern "C" int seg_std_conv3x3_dual_s8(
    const void* skip, const void* up, const void* wka, const void* wkb,
    const void* cs_a, const void* cs_b, const void* bias, void* y, int n,
    int hs, int ws, int hx, int wx, int c, int o, int oh, int ow,
    float scale_a, float scale_b, float out_scale, int th, int tw,
    void* stream) {
  using namespace segk;
  if (n < 1 || hx < 3 || wx < 3 || c < 16 || c % 16 || o < 128 || o % 128 ||
      oh < 0 || ow < 0 || oh + hx > hs || ow + wx > ws || th < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  StdArgs a{};
  a.skip = skip;
  a.x = up;
  a.wka = wka;
  a.wk = wkb;
  a.cs_a = cs_a;
  a.cs_b = cs_b;
  a.bias = bias;
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
  a.th = th;
  a.tw = tw;
  a.scale_a = scale_a;
  a.scale_b = scale_b;
  a.out_scale = out_scale;
  a.stream = (cudaStream_t)stream;
  return out_scale > 0.0f ? std_cols<true, false, false>(a)
                          : std_cols<true, true, false>(a);
}
