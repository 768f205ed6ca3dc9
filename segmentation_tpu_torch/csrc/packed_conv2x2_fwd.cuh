// The forward of the packed 2x2 convs (H1 packed_conv2x2, H2
// packed_conv2x2_dual), bf16 and int8, as a problem of the Hopper mainloop
// sm90_igemm.cuh, and the output side (FwdOut: the tile walk and the
// epilogue) that it shares with the problems of H3 (strided_conv4x4s2.cu,
// every mode), H4's bf16 (rows_matmul.cu) and H5 (entry_chain.cu).
//
//   y[n, i, j, :] = relu(bias + sum over taps (u, v) and sides of
//                        x_side[n, i + u, j + v, :] w_side[u, v])
//
// H1 has one side, x. H2 has two: the center crop of the skip at the
// unpacked offset (oh, ow) against wa, then up against wb; one f32
// accumulator holds both. The int8 modes (kInt8) multiply s8 codes in s32
// and end in the int8 epilogue relu(acc * mul + add) (int8_epilogue.cuh
// affine_relu; kRequant: requantized to s8, else bf16); H2's sides are
// quantized at different scales, so each has its own s32 accumulator
// (kTwoAcc), mixed in f32 as acc_a * cs_a + acc_b * cs_b before the
// epilogue.
//
// Design:
//  - Output tiles are th x tw pixel rectangles of one image (the wrapper's
//    tiles.tile_plan over the output grid), laid out as GEMM rows m = a W
//    + b with the row stride W = tw + HALO. HALO = 1 (the four taps): one
//    junk column per image row, so that every tap's A operand is one halo
//    box shifted by whole rows; HALO = 0 where one tap reads the tile
//    itself (H4, H3's gathered entry).
//  - A, per K block of 128 bytes (64 bf16 or 128 s8 channels): the 4-D TMA
//    box [1, th + 1, W, 128 bytes] of the side's tensor at (n, i0, j0, k0).
//    Pixel (a, b) of tap (u, v) reads box row (a + u) W + (b + v) = m + u W
//    + v. TMA fills zeros outside the tensor: channels past 4C (a partial K
//    block) and the junk rows' reads past the image. The skip: output slot
//    (d, e) of pixel (i, j) reads the skip at unpacked (oh + 2 i + d, ow +
//    2 j + e), i.e. packed pixel ((oh + d) / 2 + i, (ow + e) / 2 + j), slot
//    ((oh + d) % 2, (ow + e) % 2) (the floor division; the crop gathers
//    nothing when oh, ow are even), of skip image n % ns (the skip's batch
//    ns divides up's: the MC decoder's S B images over the encoder's B). Even offsets: the box at (n, oh / 2 +
//    i0, ow / 2 + j0, k0). bf16 with C a multiple of 64: each K block lies
//    in one output slot, so it is one box at that slot's origin and source
//    channel. Other odd offsets (one K block holds slots of different
//    origins: bf16 C = 32, s8 C = 32 and 64): the three idle warps of the
//    producer warpgroup gather the block with 16-byte loads (sm90_igemm.cuh
//    gather), zero outside the skip.
//  - The inline-quantize modes (int8, a side in bf16 with its inverse
//    scale): the same warps gather the side's K blocks, 16 channels at a
//    time (two 16-byte loads), quantize them by the Pallas multiply rule
//    (int8_epilogue.cuh quant16) once per K block, not once per tap, and
//    store the s8 codes in the swizzle TMA would have written.
//  - B, bf16: the packed weight itself, MN-major: w [2, 2, 4C, 4O] viewed as
//    [4 * 4C, 4O] has the rows t 4C + c of tap t, 4O columns each; one 2-D
//    box [64 rows, 64 columns] per 64 columns of a K block and tap (wgmma
//    tnsp-b). s8 (wgmma has no transpose for s8): the K-major copy wk [4O,
//    4 * 4C] made once with the int8 weights (conv_int8.k_major), one box
//    [4O rows, 128 K bytes] per K block and tap. Rows past 4C in a partial
//    K block belong to the next tap (or lie past the weight: zeros) and
//    meet A's zero channels.
//  - Tiles of BM = 128 GEMM rows x NB = 4O columns. 4O = 128: ping-pong,
//    each consumer warpgroup takes every other tile whole (two m64n128),
//    so that one's epilogue overlaps the other's wgmma. 4O = 256: both
//    consumers split each tile, 64 rows each (m64n256); 64-row ping-pong
//    tiles would read the weights from L2 twice as often, which costs the
//    long-K dual more than the overlap gains (profile_variants.py,
//    pingpong_all). H2's two s32 accumulators do not fit beside either
//    (one m64n256 is 128 registers): at 4O = 128 the consumers split each
//    tile's rows (m64n128 a side), at 4O = 256 each takes all 64 rows of a
//    tile and half its columns (SPLIT_N, m64n128 a side).
//  - 4O = 512 (bf16 only; n_kernels 64's level 2): more than one wgmma's
//    256 columns, so each pixel tile is CT = 2 column tiles of NB = 256,
//    taken as the 4O = 256 tiles are. Column tile ct holds channels 64 ct
//    .. 64 ct + 63 of all four slots: four 64-column blocks of the output,
//    O = 4O / 4 apart (B: one [64, 64] weight box each). So a thread still
//    holds a channel's four slots, and the pool and its index mean what
//    they mean at 4O = 256. A pixel tile's column tiles are consecutive
//    tiles of the walk, so its halo box is read from L2 the second time.
//  - Epilogue: bf16: f32 bias, ReLU, round to bf16 (nearest even). int8:
//    the affine in f32 in the reference's order, ReLU, then round half to
//    even and clip to +-127 (s8) or round to bf16. Then the mask head (a
//    per-row dot of the rounded y with wd [4O, 4], summed over the 4 lanes
//    of a quad, u8 > 0), the 2x2 pool (the max over the slot columns c, c
//    + O, c + 2 O, c + 3 O, which one thread holds, O being a multiple of
//    8) and y, each where the call asks for it. Ping-pong (4O = 128): y and
//    the pool go by stmatrix (bf16) or 16-bit st.shared (s8) into a
//    staging tile of the consumer, then by TMA stores of [th, tw] boxes
//    (which clip the ragged edge), so the consumer goes on to its next
//    tile while they drain; else (no room for staging beside the B ring):
//    sm90::store_acc / store_acc_s8, 4 rows x 128 contiguous bytes a
//    store. Junk rows store nothing.
//  - Where the time goes (B = 8, the six sites, PERF.md): the wgmma loop
//    alone at ~0.6-0.8 of the packed tensor peak, then the stores, then the
//    loads; the 4O = 256 sites read the weights from L2 once per 128-row
//    tile (4 KiB per output pixel at conv2_2).
#pragma once

#include <type_traits>

#include "int8_epilogue.cuh"
#include "mc_mask.cuh"
#include "sm90_igemm.cuh"

namespace segk {

using bf16 = __nv_bfloat16;

// EPI, the epilogue's options: kPool and kHead (compiled in only where
// asked: the head's sums beside 128 accumulators would spill); kMcHead
// (bf16, the MC-dropout forward's last conv, no y): the decoder-end
// dropout of the rounded value (mc_mask.cuh, site 2), then both logits of
// the two-class 1x1 head and their sigmoids, f32 [N, ho, wo, 4 slots, 2
// classes]; kPoolIdx
// (with kPool, training): also the pool's int8 index, the first slot that
// attains the max (strict >, pool4_select's tie rule); the int8
// modes: kInt8 (s8 operands, s32 accumulation, the int8 epilogue),
// kRequant (s8 out; without kInt8: the int8 epilogue on the f32
// accumulators of a bf16 product, H3's requant-only entry), kTwoAcc (one
// accumulator per side, H2).
constexpr int kPool = 1, kHead = 2, kInt8 = 4, kRequant = 8, kTwoAcc = 16,
              kPoolIdx = 32, kMcHead = 64;

// The output side of a forward problem: 4O = O4 columns, tiles of th x tw
// output pixels as GEMM rows m = a (tw + HALO) + b, the walk over them,
// the epilogue (EPI) and the ring's shape around it. A problem derives
// from it and adds TAPS, A_ROWS, B_STAGES, B_MN, GATHER, its maps and the
// loads.
template <int O4, int EPI, int HALO>
struct FwdOut {
  static constexpr bool INT8 = (EPI & kInt8) != 0;
  static constexpr int SIDES = (EPI & kTwoAcc) != 0 ? 2 : 1;
  using Acc = std::conditional_t<INT8, int, float>;
  using OutT = std::conditional_t<(EPI & kRequant) != 0, s8, bf16>;
  static_assert(INT8 || (EPI & kTwoAcc) == 0, "int8 options");
  static_assert((EPI & kHead) == 0 || std::is_same_v<OutT, bf16>,
                "the head reads the bf16 value");
  static_assert((EPI & kPoolIdx) == 0 || (EPI & kPool) != 0, "pool index");
  static_assert((EPI & kMcHead) == 0 ||
                    (!INT8 && (EPI & (kPool | kHead)) == 0 && O4 <= 256),
                "the MC head: bf16, one column tile, no pool or mask head");
  // column tiles of a pixel tile, and the columns NB of each (see the top)
  static constexpr int CT = O4 > 256 ? O4 / 256 : 1;
  static constexpr int NB = O4 / CT;
  static_assert(CT == 1 || (!INT8 && (EPI & kHead) == 0),
                "column tiles: the bf16 modes without the head");
  static constexpr bool SPLIT_N = SIDES == 2 && O4 == 256;
  static constexpr int NI = SPLIT_N ? 128 : NB;
  static constexpr int MI = NI == 128 && SIDES == 1 ? 2 : 1;
  static constexpr bool PINGPONG = O4 == 128 && SIDES == 1;
  static constexpr int BM = SPLIT_N ? 64 : 128;  // tiles: conv_flat, conv_int8
  static_assert(!SPLIT_N || (EPI & (kPool | kHead)) == 0, "split columns");
  // ping-pong tiles store y (and the pool) by TMA from a staging tile of
  // BM x NB outputs per consumer (the pool's stages in its scratch)
  static constexpr bool TMA_STORE = PINGPONG;
  static constexpr int OUT_BYTES = (int)sizeof(OutT);
  static constexpr int STAGE_BYTES = TMA_STORE ? 2 * BM * NB * OUT_BYTES : 0;
  static_assert(!TMA_STORE || BM * NB / 4 * OUT_BYTES <= 4 * sm90::kScratch,
                "the pool's staging is a consumer's scratch");
  static constexpr int A_STAGES = 2;
  static constexpr int PRODUCER_REGS = sm90::kProducerRegs;
  // the B stages that fit beside A_STAGES slots of a_rows rows
  static constexpr int b_stages(int a_rows) {
    return sm90::stages_that_fit(
        1024 + 8 * sm90::kScratch + 128 + A_STAGES * a_rows * 128 +
            STAGE_BYTES,
        NB * 128, 4);
  }

  CUtensorMap ymap, pmap;   // TMA_STORE: y and the pool
  const float* bias;        // bf16
  const float* mul;         // int8: the epilogue's vectors [4O]
  const float* add;
  const float* cs_a;        // kTwoAcc: the sides' dequant scales [4O]
  const float* cs_b;
  OutT* y;
  OutT* pool;
  int8_t* pool_idx;         // kPoolIdx: [N, ho, wo, O4 / 4]
  const bf16* wd;
  const float* bd;
  uint8_t* mask;
  // kMcHead: the head's weight [O4 / 4, 2] bf16 and bias [2] f32, the
  // probabilities out, the mask seed's words, the tiles B of the decoder's
  // batch (image s B + n), the dropout threshold and keep scale
  const bf16* wh;
  const float* bh;
  float* probs;
  uint32_t seed_lo, seed_hi;
  int mc_b, mc_thr;
  float mc_scale;
  int ho, wo;          // output grid
  int th, tw, tiles_w, tiles_hw, n_tiles;

  __device__ int tiles() const { return n_tiles; }
  // tile t -> image n and its first output pixel (i0, j0): tiles.tile_plan's
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

  // tile t's column tile
  __device__ static int ctile(int t) { return CT > 1 ? t % CT : 0; }
  // the output column of column c of column tile ct (c's 64-column block
  // is slot c / 64)
  __device__ static int col(int ct, int c) {
    if constexpr (CT == 1) return c;
    return (c >> 6) * (O4 / 4) + 64 * ct + (c & 63);
  }

  // the flat output pixel of GEMM row m of tile (n, i0, j0), or -1 for a
  // junk row or a row past the output
  __device__ long long pixel(int n, int i0, int j0, int m) const {
    const int w = tw + HALO;
    const int a = m / w, b = m - a * w;
    const int i = i0 + a, j = j0 + b;
    if (a >= th || b >= tw || i >= ho || j >= wo) return -1;
    return ((long long)n * ho + i) * wo + j;
  }

  // the staging row of GEMM row m (a th x tw box, dense), or -1
  __device__ int stage_row(int m) const {
    const int w = tw + HALO;
    const int a = m / w, b = m - a * w;
    return a < th && b < tw ? a * tw + b : -1;
  }

  // y's fragment into the staging tile: NB * OUT_BYTES / 128 boxes of BM
  // rows x 128 bytes in TMA's 128-byte swizzle; junk rows go to row BM -
  // 1, which no box reaches (there are junk rows only where th tw < BM).
  // bf16: stmatrix; s8: each thread's column pairs as 16-bit stores.
  template <class A>
  __device__ void stage_y(A (&acc)[MI][NI / 2], uint8_t* stage,
                          int m0) const {
    const int lane = threadIdx.x & 31;
    const uint32_t base = sm90::smem_u32(stage);
    if constexpr (std::is_same_v<OutT, s8>) {
      static_assert(NB == 128, "one 128-byte box a row");
      const int q = lane & 3;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int r = stage_row(m0 + 64 * mi + (lane >> 2) + 8 * h);
          r = r < 0 ? BM - 1 : r;
#pragma unroll
          for (int jn = 0; jn < NI / 8; ++jn) {
            const A* d = &acc[mi][4 * jn + 2 * h];
            asm volatile("st.shared.u16 [%0], %1;" ::"r"(
                             base + r * 128 + (((jn >> 1) ^ (r & 7)) << 4) +
                             (jn & 1) * 8 + 2 * q),
                         "h"((unsigned short)sm90::pack_s8x2(
                             sm90::as_f32(d[0]), sm90::as_f32(d[1])))
                         : "memory");
          }
        }
      return;
    }
    // stmatrix.x4: lanes 8q..8q+7 give the rows of matrix q (rows 8 (q & 1)
    // and columns 8 (q >> 1) on of a 16 x 16 block)
    const int st_row = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      int r = stage_row(m0 + 64 * mi + st_row);
      r = r < 0 ? BM - 1 : r;
#pragma unroll
      for (int jb = 0; jb < NI / 16; ++jb) {
        const A* d = &acc[mi][8 * jb];
        const int chunk = (2 * jb + (lane >> 4)) & 7;
        using sm90::as_f32;
        asm volatile(
            "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
            ::"r"(base + (jb >> 2) * BM * 128 + r * 128 +
                  ((chunk ^ (r & 7)) << 4)),
            "r"(sm90::pack_bf16(as_f32(d[0]), as_f32(d[1]))),
            "r"(sm90::pack_bf16(as_f32(d[2]), as_f32(d[3]))),
            "r"(sm90::pack_bf16(as_f32(d[4]), as_f32(d[5]))),
            "r"(sm90::pack_bf16(as_f32(d[6]), as_f32(d[7])))
            : "memory");
      }
    }
  }

  // bf16: relu(acc + bias) rounded to bf16, in place; kRequant: the int8
  // epilogue relu(acc * mul + add) requantized, in place
  __device__ void store(int t, int cg, float (&acc)[MI][NI / 2],
                        uint8_t* scratch, uint8_t* stage) const {
    const int q = threadIdx.x & 3;
    if constexpr ((EPI & kRequant) != 0) {
#pragma unroll
      for (int jn = 0; jn < NI / 8; ++jn) {
        const float2 m2 = __ldg(reinterpret_cast<const float2*>(mul) +
                                4 * jn + q);
        const float2 a2 = __ldg(reinterpret_cast<const float2*>(add) +
                                4 * jn + q);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& d = acc[mi][4 * jn + e];
            d = finish(affine_relu(d, e & 1 ? m2.y : m2.x,
                                   e & 1 ? a2.y : a2.x),
                       (OutT*)nullptr);
          }
      }
      emit(t, cg, acc, scratch, stage);
      return;
    }
    // fragment: acc[mi][4 jn + 2 h + e] is row m0 + 64 mi + lane / 4 + 8 h,
    // column 8 jn + 2 q + e
    const int ct = ctile(t);
#pragma unroll
    for (int jn = 0; jn < NI / 8; ++jn) {
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias) +
                              col(ct, 8 * jn) / 2 + q);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = fmaxf(acc[mi][4 * jn + e] + (e & 1 ? b2.y : b2.x),
                                0.0f);
          acc[mi][4 * jn + e] = __bfloat162float(__float2bfloat16(v));
        }
    }
    emit(t, cg, acc, scratch, stage);
  }

  // int8, one accumulator: relu(f32(acc) * mul + add), finished, in place
  // (the f32 bits in acc)
  __device__ void store(int t, int cg, int (&acc)[MI][NI / 2],
                        uint8_t* scratch, uint8_t* stage) const {
    const int q = threadIdx.x & 3;
#pragma unroll
    for (int jn = 0; jn < NI / 8; ++jn) {
      const float2 m2 = __ldg(reinterpret_cast<const float2*>(mul) +
                              4 * jn + q);
      const float2 a2 = __ldg(reinterpret_cast<const float2*>(add) +
                              4 * jn + q);
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
    emit(t, cg, acc, scratch, stage);
  }

  // int8, two accumulators (H2): the sides mixed in f32 as acc_a cs_a +
  // acc_b cs_b, then relu(mix * mul + add), finished, in place in acc_a
  __device__ void store(int t, int cg, int (&acc_a)[MI][NI / 2],
                        int (&acc_b)[MI][NI / 2], uint8_t* scratch,
                        uint8_t* stage) const {
    const int c2 = (SPLIT_N ? cg * NI : 0) / 2 + (threadIdx.x & 3);
#pragma unroll
    for (int jn = 0; jn < NI / 8; ++jn) {
      const float2 ca = __ldg(reinterpret_cast<const float2*>(cs_a) +
                              4 * jn + c2);
      const float2 cb = __ldg(reinterpret_cast<const float2*>(cs_b) +
                              4 * jn + c2);
      const float2 m2 = __ldg(reinterpret_cast<const float2*>(mul) +
                              4 * jn + c2);
      const float2 a2 = __ldg(reinterpret_cast<const float2*>(add) +
                              4 * jn + c2);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e;
          const float mix = __fadd_rn(
              __fmul_rn(__int2float_rn(acc_a[mi][i]), e & 1 ? ca.y : ca.x),
              __fmul_rn(__int2float_rn(acc_b[mi][i]), e & 1 ? cb.y : cb.x));
          sm90::put_f32(acc_a[mi][i],
                        finish(affine_relu(mix, e & 1 ? m2.y : m2.x,
                                           e & 1 ? a2.y : a2.x),
                               (OutT*)nullptr));
        }
    }
    emit(t, cg, acc_a, scratch, stage);
  }

  // The finished values (rounded to OutT; f32, or its bits in an s32
  // accumulator) of one consumer's rows: the head, the pool, y.
  template <class A>
  __device__ void emit(int t, int cg, A (&acc)[MI][NI / 2],
                       uint8_t* scratch, uint8_t* stage) const {
    using sm90::as_f32;
    int n, i0, j0;
    origin(t, n, i0, j0);
    const int lane = threadIdx.x & 31, q = lane & 3;
    const int warp = (threadIdx.x >> 5) & 3;
    const int m0 = (PINGPONG || SPLIT_N ? 0 : cg * 64 * MI) + 16 * warp;
    const int c0 = SPLIT_N ? cg * NI : 0;  // the consumer's first column
    const int ct = ctile(t);
    const bool issuer = (threadIdx.x & 127) == 0;  // a consumer's thread 0
    // the pool's staging: the consumer's four scratch blocks
    uint8_t* const pstage = scratch - warp * sm90::kScratch;
    if constexpr (TMA_STORE) {
      // the staging is free once the consumer's last stores have read it
      if (issuer) sm90::bulk_wait_read();
      sm90::named_sync(1 + cg, 128);
    }
    if constexpr ((EPI & kHead) != 0) {
      // hd[mi][h][s]: this thread's part of row (mi, h)'s dot with wd[:, s]
      float hd[MI][2][4] = {};
#pragma unroll
      for (int jn = 0; jn < NI / 8; ++jn) {
        // wd rows c, c + 1 (4 values each) of column c = 8 jn + 2 q
        const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wd) + 4 * jn + q);
        const uint32_t wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t w0 = wr[s >> 1], w1 = wr[2 + (s >> 1)];
          const float f0 = __uint_as_float((s & 1 ? w0 >> 16 : w0) << 16);
          const float f1 = __uint_as_float((s & 1 ? w1 >> 16 : w1) << 16);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              hd[mi][h][s] += as_f32(acc[mi][4 * jn + 2 * h]) * f0 +
                              as_f32(acc[mi][4 * jn + 2 * h + 1]) * f1;
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t bits = 0;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            float v = hd[mi][h][s];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            bits |= (uint32_t)(v + __ldg(bd + s) > 0.0f) << (8 * s);
          }
          const long long pix =
              pixel(n, i0, j0, m0 + 64 * mi + (lane >> 2) + 8 * h);
          if (q == 0 && pix >= 0)
            *reinterpret_cast<uint32_t*>(mask + pix * 4) = bits;
        }
    }
    if constexpr ((EPI & kMcHead) != 0) mc_head(n, i0, j0, m0, acc);
    if constexpr ((EPI & kPool) != 0) {
      constexpr int O = NB / 4, JO = O / 8;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 64 * mi + (lane >> 2) + 8 * h;
          const long long pix = pixel(n, i0, j0, m);
          const int r = TMA_STORE ? stage_row(m) : 0;
          if (TMA_STORE ? r < 0 : pix < 0) continue;
#pragma unroll
          for (int jn = 0; jn < JO; ++jn) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = fmaxf(
                  fmaxf(as_f32(acc[mi][4 * jn + 2 * h + e]),
                        as_f32(acc[mi][4 * (jn + JO) + 2 * h + e])),
                  fmaxf(as_f32(acc[mi][4 * (jn + 2 * JO) + 2 * h + e]),
                        as_f32(acc[mi][4 * (jn + 3 * JO) + 2 * h + e])));
            OutT* const dst = TMA_STORE
                ? reinterpret_cast<OutT*>(pstage) + r * O
                : pool + pix * (O4 / 4) + O * ct;
            if constexpr (std::is_same_v<OutT, s8>)
              *reinterpret_cast<uint16_t*>(dst + 8 * jn + 2 * q) =
                  (uint16_t)sm90::pack_s8x2(v[0], v[1]);
            else
              *reinterpret_cast<uint32_t*>(dst + 8 * jn + 2 * q) =
                  sm90::pack_bf16(v[0], v[1]);
            if constexpr ((EPI & kPoolIdx) != 0) {
              // the first slot above every earlier one, as pool4_select
              // scans them (the values are the rounded outputs)
              uint32_t id2 = 0;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float best = as_f32(acc[mi][4 * jn + 2 * h + e]);
                uint32_t id = 0;
#pragma unroll
                for (int sl = 1; sl < 4; ++sl) {
                  const float a = as_f32(acc[mi][4 * (jn + sl * JO) + 2 * h + e]);
                  if (a > best) {
                    best = a;
                    id = sl;
                  }
                }
                id2 |= id << (8 * e);
              }
              if (pix >= 0)
                *reinterpret_cast<uint16_t*>(pool_idx + pix * (O4 / 4) +
                                             O * ct + 8 * jn + 2 * q) =
                    (uint16_t)id2;
            }
          }
        }
    }
    if constexpr (TMA_STORE) {
      if (y != nullptr) stage_y(acc, stage, m0);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      sm90::named_sync(1 + cg, 128);
      if (issuer) {
        if (y != nullptr)
#pragma unroll
          for (int c = 0; c < NB * OUT_BYTES / 128; ++c)
            sm90::tma_store_4d(&ymap, stage + c * BM * 128,
                               128 / OUT_BYTES * c, j0, i0, n);
        if constexpr ((EPI & kPool) != 0)
          sm90::tma_store_4d(&pmap, pstage, 0, j0, i0, n);
        sm90::bulk_commit();
      }
    } else if (y != nullptr) {
      auto dst = [&](int mi, int row, int col) -> OutT* {
        const long long pix = pixel(n, i0, j0, m0 + 64 * mi + row);
        return pix < 0 ? nullptr : y + pix * O4 + this->col(ct, c0 + col);
      };
      if constexpr (std::is_same_v<OutT, s8>)
        sm90::store_acc_s8<NI, MI>(acc, scratch, dst);
      else
        sm90::store_acc<NI, MI>(acc, scratch, dst);
    }
  }

  // kMcHead: each row's slots, dropped (the stream of image n's sample n /
  // mc_b and tile n % mc_b, the unpacked pixel (2 i + d, 2 j + e) of slot
  // (d, e), channel c), then each slot's two logits (f32 sums of the bf16
  // operands, the quad's four lanes summed by shuffles) and their sigmoids;
  // lane q stores slot q's pair. The column 8 jn + 2 q + e of the
  // fragment is slot (8 jn) / O's channel, a channel pair within one group
  // of four of the stream.
  template <class A>
  __device__ void mc_head(int n, int i0, int j0, int m0,
                          A (&acc)[MI][NI / 2]) const {
    using sm90::as_f32;
    constexpr int O = NB / 4, JS = O / 8;  // fragment columns a slot
    const int lane = threadIdx.x & 31, q = lane & 3;
    const uint32_t key =
        mc_key(seed_lo, seed_hi, kMcSiteHead, n / mc_b, n % mc_b);
    const uint32_t wu = 2u * (uint32_t)wo;  // the unpacked width
    const float2 b2 = __ldg(reinterpret_cast<const float2*>(bh));
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * mi + (lane >> 2) + 8 * h;
        const int a = m / (tw + 1), b = m - a * (tw + 1);
        const uint32_t i = (uint32_t)(i0 + a), j = (uint32_t)(j0 + b);
        const long long pix = pixel(n, i0, j0, m);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t yu = 2 * i + (s >> 1), xu = 2 * j + (s & 1);
          float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
          for (int jj = 0; jj < JS; ++jj) {
            const int jn = s * JS + jj, c = 8 * jj + 2 * q;
            const uint32_t bytes =
                mc_bytes(key, ((yu * wu + xu) * (uint32_t)O + c) >> 2);
            const float v0 = as_f32(acc[mi][4 * jn + 2 * h]) *
                             mc_keep(bytes, c, mc_thr, mc_scale);
            const float v1 = as_f32(acc[mi][4 * jn + 2 * h + 1]) *
                             mc_keep(bytes, c + 1, mc_thr, mc_scale);
            // wh rows c and c + 1: (class 0, class 1) each
            const uint2 w2 = __ldg(reinterpret_cast<const uint2*>(wh) + c / 2);
            l0 += v0 * __uint_as_float(w2.x << 16) +
                  v1 * __uint_as_float(w2.y << 16);
            l1 += v0 * __uint_as_float(w2.x & 0xffff0000u) +
                  v1 * __uint_as_float(w2.y & 0xffff0000u);
          }
          l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
          l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
          l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
          l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
          if (q == s && pix >= 0)
            reinterpret_cast<float2*>(probs)[pix * 4 + s] =
                make_float2(1.0f / (1.0f + expf(-(l0 + b2.x))),
                            1.0f / (1.0f + expf(-(l1 + b2.y))));
        }
      }
  }

  // Host: the walk over the output grid [n, ho, wo] in tiles of th x tw
  // (th (tw + HALO) <= BM GEMM rows), and the maps of the TMA stores.
  int plan(int n, int ho_, int wo_, int th_, int tw_) {
    if (th_ < 1 || tw_ < 1 || th_ * (tw_ + HALO) > BM)
      return (int)cudaErrorInvalidValue;
    ho = ho_;
    wo = wo_;
    th = th_;
    tw = tw_;
    tiles_w = (wo + tw - 1) / tw;
    tiles_hw = tiles_w * ((ho + th - 1) / th);
    n_tiles = n * tiles_hw * CT;
    if constexpr (TMA_STORE) {  // y and the pool as [th, tw] boxes
      constexpr CUtensorMapDataType type =
          OUT_BYTES == 1 ? sm90::kMapS8 : sm90::kMapBf16;
      const cuuint64_t ydims[4] = {(cuuint64_t)O4, (cuuint64_t)wo,
                                   (cuuint64_t)ho, (cuuint64_t)n};
      const cuuint32_t ybox[4] = {128 / OUT_BYTES, (cuuint32_t)tw,
                                  (cuuint32_t)th, 1};
      int e = y ? sm90::make_map(&ymap, y, 4, ydims, ybox, true, type) : 0;
      if (e == 0 && (EPI & kPool) != 0) {
        const cuuint64_t pdims[4] = {(cuuint64_t)O4 / 4, (cuuint64_t)wo,
                                     (cuuint64_t)ho, (cuuint64_t)n};
        const cuuint32_t pbox[4] = {(cuuint32_t)O4 / 4, (cuuint32_t)tw,
                                    (cuuint32_t)th, 1};
        e = sm90::make_map(&pmap, pool, 4, pdims, pbox, false, type);
      }
      return e;
    }
    return 0;
  }
};

// H1 (DUAL false: x) or H2 (DUAL true: the skip's K blocks, then up's).
// GATHER: the kernel may gather K blocks (gathered(kb): the bf16 skip at
// an odd offset with C % 64 != 0; int8: the skip at an odd offset, or a
// side in bf16, quantized inline).
template <int O4, bool DUAL, int EPI = 0, bool GATHER_ = false>
struct FwdTiles : FwdOut<O4, EPI, 1> {
  using Out = FwdOut<O4, EPI, 1>;
  using Out::BM;
  using Out::INT8;
  using Out::NB;
  using Out::origin;
  using Out::th;
  using Out::tw;
  static constexpr int TAPS = 4;
  // an A slot holds the largest tap shift (W + 1 <= BM + 1) and BM rows
  // after it
  static constexpr int A_ROWS = (2 * BM + 1 + 7) / 8 * 8;
  static constexpr int B_STAGES = Out::b_stages(A_ROWS);
  static constexpr bool B_MN = !INT8, GATHER = GATHER_;
  // the channels of a K block (128 bytes)
  static constexpr int KC = INT8 ? 128 : 64;
  // the gather keeps GATHER_CHUNKS chunks of each thread in flight (two
  // 16-byte loads each where it quantizes)
  static constexpr int GATHER_CHUNKS = 4;
  static constexpr int PRODUCER_REGS = GATHER ? 80 : sm90::kProducerRegs;

  CUtensorMap xmap, wmap;  // H1's x and w; H2's up side: up and wb
  CUtensorMap smap, wsmap;  // H2's skip side: skip and wa
  const uint8_t* skip;     // the gathered skip
  const uint8_t* xs;       // int8: the gathered x (H1) or up (H2)
  float inv_a, inv_b;      // int8: a side's inverse scale, or 0 (s8 codes)
  int ga, gb;              // the skip's / x's (up's) K blocks are gathered
  int kps;                 // K blocks a side: ceil(4C / KC)
  int c4, cs;              // 4C and C
  int hx, wx;              // x's (up's) grid
  int hpa, wpa;            // the skip's grid
  int oh, ow;              // the crop offset, unpacked
  int ns;  // H2: the skip's images (0: as many as up's); up image n reads
           // skip image n % ns (the MC decoder's B S over the encoder's B)
  int slot;  // bf16: the skip's K blocks are per-slot boxes (C % 64 == 0)

  __device__ int k_blocks() const { return DUAL ? 2 * kps : kps; }
  __device__ int skip_image(int n) const { return ns > 0 ? n % ns : n; }
  __device__ bool gathered(int kb) const {
    return GATHER && (DUAL && kb < kps ? ga : gb) != 0;
  }
  __device__ uint32_t a_tx(int kb) const {
    return gathered(kb) ? 0u : (uint32_t)((th + 1) * (tw + 1)) * 128u;
  }
  __device__ int a_row(int tap) const {  // (u, v) = (tap >> 1, tap & 1)
    return (tap >> 1) * (tw + 1) + (tap & 1);
  }
  __device__ void prefetch() const {
    if (!GATHER || !gb) sm90::prefetch_map(&xmap);
    sm90::prefetch_map(&wmap);
    if (DUAL) {
      if (!GATHER || !ga) sm90::prefetch_map(&smap);
      sm90::prefetch_map(&wsmap);
    }
  }
  __device__ void load_a(int t, int kb, uint8_t* a, uint64_t* bar) const {
    if (gathered(kb)) return;
    int n, i0, j0;
    origin(t, n, i0, j0);
    if (DUAL && kb < kps) {
      const int k0 = KC * kb, ni = skip_image(n);
      if (slot) {  // the block's output slot (d, e) = (s >> 1, s & 1)
        const int s = k0 / cs;
        const int yy = oh + (s >> 1), xx = ow + (s & 1);
        sm90::tma_load_4d(a, &smap, bar,
                          (2 * (yy & 1) + (xx & 1)) * cs + k0 - s * cs,
                          (xx >> 1) + j0, (yy >> 1) + i0, ni);
      } else {
        sm90::tma_load_4d(a, &smap, bar, k0, ow / 2 + j0, oh / 2 + i0, ni);
      }
      return;
    }
    sm90::tma_load_4d(a, &xmap, bar, KC * (DUAL ? kb - kps : kb), j0, i0, n);
  }
  // A gathered K block (sm90::gather_rows): thread tid's chunk tid % 8
  // holds channels k .. (8 bf16, or 16 s8 channels) of one slot of the skip
  // (C % 8 == 0 for bf16, C % 16 == 0 for s8), so box row (bi, bj) reads
  // the source pixel (r0 + bi, c0 + bj) at one channel offset: the skip's
  // packed pixel under the crop, or x's. Zero outside the source and past
  // 4C. int8: s8 codes, or bf16 (two loads) quantized at the side's inverse
  // scale (the multiply rule, int8_epilogue.cuh quant16).
  __device__ void gather_a(int t, int kb, uint8_t* a, int tid,
                           int nthreads) const {
    if (!gathered(kb)) return;
    int n, i0, j0;
    origin(t, n, i0, j0);
    const bool sk = DUAL && kb < kps;
    const float inv = INT8 ? (sk ? inv_a : inv_b) : 0.0f;
    const int es = INT8 && inv == 0.0f ? 1 : 2;  // the source's bytes
    const int k = KC * (DUAL && !sk ? kb - kps : kb) + KC / 8 * (tid & 7);
    int hh = hx, ww = wx, r0 = i0, c0 = j0, ch = k;
    if (sk) {
      const int s = k / cs;  // the output slot (d, e) = (s >> 1, s & 1)
      const int yy = oh + (s >> 1), xx = ow + (s & 1);
      hh = hpa;
      ww = wpa;
      r0 = (yy >> 1) + i0;
      c0 = (xx >> 1) + j0;
      ch = (2 * (yy & 1) + (xx & 1)) * cs + k - s * cs;
    }
    const long long pix = (long long)c4 * es;
    const uint8_t* img = (sk ? skip : xs) +
                         (long long)(sk ? skip_image(n) : n) * hh * ww * pix +
                         (long long)ch * es;
    const bool live = k < c4;
    sm90::gather_rows<GATHER_CHUNKS>(
        a, tid, nthreads, (th + 1) * (tw + 1), tw + 1, INT8 && es == 2,
        [&](int bi, int bj) {
          return reinterpret_cast<const uint4*>(
              img + ((long long)(r0 + bi) * ww + c0 + bj) * pix);
        },
        [&](int bi, int bj) { return live && r0 + bi < hh && c0 + bj < ww; },
        [&](uint4 lo, uint4 hi) { return quant16(lo, hi, inv); });
  }
  // the B rows of (K block, tap): bf16, 64 rows of w viewed as [4 * 4C,
  // 4O], one box per 64 columns of the column tile; s8, the 128 K bytes of
  // every column of the K-major wk [4O, 4 * 4C]
  __device__ void load_b(int t, int kb, int tap, uint8_t* b,
                         uint64_t* bar) const {
    const bool skip_side = DUAL && kb < kps;
    const CUtensorMap* m = skip_side ? &wsmap : &wmap;
    const int row = tap * c4 + KC * (DUAL && !skip_side ? kb - kps : kb);
    if constexpr (INT8) {
      sm90::tma_load_2d(b, m, bar, row, 0);
    } else {
#pragma unroll
      for (int j = 0; j < NB / 64; ++j)
        sm90::tma_load_2d(b + j * sm90::kMnBox, m, bar,
                          Out::col(Out::ctile(t), 64 * j), row);
    }
  }
};

template <int O4, bool DUAL, int EPI, bool GATHER>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    packed_conv2x2_fwd_kernel(
        const __grid_constant__ FwdTiles<O4, DUAL, EPI, GATHER> p) {
  sm90::run(p);
}

// H2's kernel, under its own name: profiles group kernels by name
template <int O4, bool DUAL, int EPI, bool GATHER>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    packed_conv2x2_dual_fwd_kernel(
        const __grid_constant__ FwdTiles<O4, DUAL, EPI, GATHER> p) {
  sm90::run(p);
}

// A map of x [n, hx, wx, c4] read as [1, th + 1, tw + 1, 64] halo boxes, and
// one of a weight [2, 2, c4, o4] read as [64, 64] boxes of [4 c4, o4].
inline int fwd_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                    const void* w, int n, int hx, int wx, int c4, int o4,
                    int th, int tw) {
  const cuuint64_t xdims[4] = {(cuuint64_t)c4, (cuuint64_t)wx, (cuuint64_t)hx,
                               (cuuint64_t)n};
  const cuuint32_t xbox[4] = {64, (cuuint32_t)tw + 1, (cuuint32_t)th + 1, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)o4, (cuuint64_t)(4 * c4)};
  const cuuint32_t wbox[2] = {64, 64};
  int e = sm90::make_map(xmap, x, 4, xdims, xbox);
  if (e == 0) e = sm90::make_map(wmap, w, 2, wdims, wbox);
  return e;
}

// The int8 maps: s8 x [n, hx, wx, c4] as [1, th + 1, tw + 1, 128] halo
// boxes (none where x is gathered: null), and the K-major s8 weight wk
// [o4, 4 c4] as [o4, 128] boxes.
inline int fwd_maps_s8(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                       const void* wk, int n, int hx, int wx, int c4, int o4,
                       int th, int tw) {
  const cuuint64_t xdims[4] = {(cuuint64_t)c4, (cuuint64_t)wx, (cuuint64_t)hx,
                               (cuuint64_t)n};
  const cuuint32_t xbox[4] = {128, (cuuint32_t)tw + 1, (cuuint32_t)th + 1, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)(4 * c4), (cuuint64_t)o4};
  const cuuint32_t wbox[2] = {128, (cuuint32_t)o4};
  int e = x != nullptr
              ? sm90::make_map(xmap, x, 4, xdims, xbox, true, sm90::kMapS8)
              : 0;
  if (e == 0) e = sm90::make_map(wmap, wk, 2, wdims, wbox, true, sm90::kMapS8);
  return e;
}

// The walk and launch of a filled problem: the tiles of the output grid
// [n, ho, wo] and the K blocks of 4C.
template <int O4, bool DUAL, int EPI, bool GATHER>
int fwd_launch(FwdTiles<O4, DUAL, EPI, GATHER>& p, int n, int ho, int wo,
               int c4, int th, int tw, cudaStream_t stream) {
  using P = FwdTiles<O4, DUAL, EPI, GATHER>;
  p.c4 = c4;
  p.cs = c4 / 4;
  p.kps = (c4 + P::KC - 1) / P::KC;
  const int e = p.plan(n, ho, wo, th, tw);
  if (e != 0) return e;
  if constexpr (DUAL)
    return sm90::launch(packed_conv2x2_dual_fwd_kernel<O4, DUAL, EPI, GATHER>,
                        p, stream);
  else
    return sm90::launch(packed_conv2x2_fwd_kernel<O4, DUAL, EPI, GATHER>, p,
                        stream);
}

}  // namespace segk
