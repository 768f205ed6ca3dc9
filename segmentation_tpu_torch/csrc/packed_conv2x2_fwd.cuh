// The bf16 forward of the packed 2x2 convs (H1 packed_conv2x2, H2
// packed_conv2x2_dual) as a problem of the Hopper mainloop sm90_igemm.cuh,
// and the output side (FwdOut: the tile walk and the epilogue) that it
// shares with the bf16 problems of H3 (strided_conv4x4s2.cu) and H4
// (rows_matmul.cu).
//
//   y[n, i, j, :] = relu(bias + sum over taps (u, v) and sides of
//                        x_side[n, i + u, j + v, :] w_side[u, v])
//
// H1 has one side, x. H2 has two: the center crop of the skip at the
// unpacked offset (oh, ow) against wa, then up against wb; one f32
// accumulator holds both.
//
// Design:
//  - Output tiles are th x tw pixel rectangles of one image (the wrapper's
//    tiles.tile_plan over the output grid), laid out as GEMM rows m = a W
//    + b with the row stride W = tw + HALO. HALO = 1 (the four taps): one
//    junk column per image row, so that every tap's A operand is one halo
//    box shifted by whole rows; HALO = 0 where one tap reads the tile
//    itself (H4, H3's gathered entry).
//  - A, per 64-channel K block: the 4-D TMA box [1, th + 1, W, 64] of the
//    side's tensor at (n, i0, j0, k0). Pixel (a, b) of tap (u, v) reads box
//    row (a + u) W + (b + v) = m + u W + v. TMA fills zeros outside the
//    tensor: channels past 4C (a partial K block) and the junk rows' reads
//    past the image. The skip: output slot (d, e) of pixel (i, j) reads the
//    skip at unpacked (oh + 2 i + d, ow + 2 j + e), i.e. packed pixel
//    ((oh + d) / 2 + i, (ow + e) / 2 + j), slot ((oh + d) % 2, (ow + e) % 2)
//    (the floor division; the crop gathers nothing when oh, ow are even).
//    Even offsets: the box at (n, oh / 2 + i0, ow / 2 + j0, k0). C a
//    multiple of 64: each K block lies in one output slot, so it is one box
//    at that slot's origin and source channel. Odd offsets with C % 64 != 0
//    (C = 32: one K block holds two slots of different origins): the three
//    idle warps of the producer warpgroup gather the block with 16-byte
//    loads (sm90_igemm.cuh gather), zero outside the skip.
//  - B is the packed weight itself, MN-major: w [2, 2, 4C, 4O] viewed as
//    [4 * 4C, 4O] has the rows t 4C + c of tap t, 4O columns each; one 2-D
//    box [64 rows, 64 columns] per 64 columns of a K block and tap (wgmma
//    tnsp-b). Rows past 4C in a partial K block belong to the next tap (or
//    lie past the weight: zeros) and meet A's zero channels.
//  - Tiles of BM = 128 GEMM rows x NB = 4O columns. 4O = 128: ping-pong,
//    each consumer warpgroup takes every other tile whole (two m64n128),
//    so that one's epilogue overlaps the other's wgmma. 4O = 256: both
//    consumers split each tile, 64 rows each (m64n256); 64-row ping-pong
//    tiles would read the weights from L2 twice as often, which costs the
//    long-K dual more than the overlap gains (profile_variants.py,
//    pingpong_all).
//  - Epilogue: f32 bias, ReLU, round to bf16 (nearest even); then the
//    mask head (a per-row dot of the rounded y with wd [4O, 4], summed over
//    the 4 lanes of a quad, u8 > 0), the 2x2 pool (the max over the slot
//    columns c, c + O, c + 2 O, c + 3 O, which one thread holds, O being a
//    multiple of 8) and y, each where the call asks for it. 4O = 128: y
//    and the pool go by stmatrix / st.shared into a staging tile of the
//    consumer, then by TMA stores of [th, tw] boxes (which clip the ragged
//    edge), so the consumer goes on to its next tile while they drain; 4O
//    = 256 (no room for staging beside the B ring): sm90::store_acc, 4
//    rows x 128 contiguous bytes a store. Junk rows store nothing.
//  - Where the time goes (B = 8, the six sites, PERF.md): the wgmma loop
//    alone at ~0.6-0.8 of the packed tensor peak, then the stores, then the
//    loads; the 4O = 256 sites read the weights from L2 once per 128-row
//    tile (4 KiB per output pixel at conv2_2).
#pragma once

#include "sm90_igemm.cuh"

namespace segk {

using bf16 = __nv_bfloat16;

// SKIP: 0 H1 (one side); 1 H2 with the skip read by TMA boxes; 2 H2 with
// the skip gathered (odd offset, C % 64 != 0). EPI: the epilogue's
// options, kPool and kHead (compiled in only where asked: the head's sums
// beside 128 accumulators would spill).
constexpr int kPool = 1, kHead = 2;

// The output side of a bf16 forward problem: 4O = O4 columns, tiles of th
// x tw output pixels as GEMM rows m = a (tw + HALO) + b, the walk over
// them, the epilogue (EPI: kPool, kHead) and the ring's shape around it. A
// problem derives from it and adds TAPS, A_ROWS, B_STAGES, B_MN, GATHER,
// its maps and the loads.
template <int O4, int EPI, int HALO>
struct FwdOut {
  static constexpr int NB = O4;
  static constexpr bool SPLIT_N = false;
  static constexpr int NI = NB;
  static constexpr int MI = NI == 128 ? 2 : 1;
  static constexpr bool PINGPONG = O4 == 128;
  static constexpr int BM = 128;  // FWD_TILE_ROWS of conv_flat.py
  // ping-pong tiles store y (and the pool) by TMA from a staging tile of
  // BM x NB bf16 per consumer (the pool's stages in its scratch)
  static constexpr bool TMA_STORE = PINGPONG;
  static constexpr int STAGE_BYTES = TMA_STORE ? 2 * BM * NB * 2 : 0;
  static_assert(!TMA_STORE || BM * NB / 4 * 2 <= 4 * sm90::kScratch,
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
  const float* bias;
  bf16* y;
  bf16* pool;
  const bf16* wd;
  const float* bd;
  uint8_t* mask;
  int ho, wo;          // output grid
  int th, tw, tiles_w, tiles_hw, n_tiles;

  __device__ int tiles() const { return n_tiles; }
  // tile t -> image n and its first output pixel (i0, j0): tiles.tile_plan's
  // map, row-major over [N, tiles_h, tiles_w]
  __device__ void origin(int t, int& n, int& i0, int& j0) const {
    n = t / tiles_hw;
    const int r = t - n * tiles_hw;
    const int ti = r / tiles_w;
    i0 = ti * th;
    j0 = (r - ti * tiles_w) * tw;
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

  // y's fragment into the staging tile: NB / 64 boxes of BM rows x 128
  // bytes in TMA's 128-byte swizzle; junk rows go to row BM - 1, which no
  // box reaches (there are junk rows only where th tw < BM)
  __device__ void stage_y(float (&acc)[MI][NI / 2], uint8_t* stage,
                          int m0) const {
    const int lane = threadIdx.x & 31;
    const uint32_t base = sm90::smem_u32(stage);
    // stmatrix.x4: lanes 8q..8q+7 give the rows of matrix q (rows 8 (q & 1)
    // and columns 8 (q >> 1) on of a 16 x 16 block)
    const int st_row = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      int r = stage_row(m0 + 64 * mi + st_row);
      r = r < 0 ? BM - 1 : r;
#pragma unroll
      for (int jb = 0; jb < NI / 16; ++jb) {
        const float* d = &acc[mi][8 * jb];
        const int chunk = (2 * jb + (lane >> 4)) & 7;
        asm volatile(
            "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
            ::"r"(base + (jb >> 2) * BM * 128 + r * 128 +
                  ((chunk ^ (r & 7)) << 4)),
            "r"(sm90::pack_bf16(d[0], d[1])), "r"(sm90::pack_bf16(d[2], d[3])),
            "r"(sm90::pack_bf16(d[4], d[5])), "r"(sm90::pack_bf16(d[6], d[7]))
            : "memory");
      }
    }
  }

  __device__ void store(int t, int cg, float (&acc)[MI][NI / 2],
                        uint8_t* scratch, uint8_t* stage) const {
    int n, i0, j0;
    origin(t, n, i0, j0);
    const int lane = threadIdx.x & 31, q = lane & 3;
    const int warp = (threadIdx.x >> 5) & 3;
    const int m0 = (PINGPONG ? 0 : cg * 64 * MI) + 16 * warp;
    const bool issuer = (threadIdx.x & 127) == 0;  // a consumer's thread 0
    // the pool's staging: the consumer's four scratch blocks
    uint8_t* const pstage = scratch - warp * sm90::kScratch;
    // fragment: acc[mi][4 jn + 2 h + e] is row m0 + 64 mi + lane / 4 + 8 h,
    // column 8 jn + 2 q + e
#pragma unroll
    for (int jn = 0; jn < NI / 8; ++jn) {
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias) +
                              4 * jn + q);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = fmaxf(acc[mi][4 * jn + e] + (e & 1 ? b2.y : b2.x),
                                0.0f);
          acc[mi][4 * jn + e] = __bfloat162float(__float2bfloat16(v));
        }
    }
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
              hd[mi][h][s] += acc[mi][4 * jn + 2 * h] * f0 +
                              acc[mi][4 * jn + 2 * h + 1] * f1;
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
                  fmaxf(acc[mi][4 * jn + 2 * h + e],
                        acc[mi][4 * (jn + JO) + 2 * h + e]),
                  fmaxf(acc[mi][4 * (jn + 2 * JO) + 2 * h + e],
                        acc[mi][4 * (jn + 3 * JO) + 2 * h + e]));
            bf16* const dst = TMA_STORE
                ? reinterpret_cast<bf16*>(pstage) + r * O
                : pool + pix * O;
            *reinterpret_cast<uint32_t*>(dst + 8 * jn + 2 * q) =
                sm90::pack_bf16(v[0], v[1]);
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
          for (int c = 0; c < NB / 64; ++c)
            sm90::tma_store_4d(&ymap, stage + c * BM * 128, 64 * c, j0, i0,
                               n);
        if constexpr ((EPI & kPool) != 0)
          sm90::tma_store_4d(&pmap, pstage, 0, j0, i0, n);
        sm90::bulk_commit();
      }
    } else if (y != nullptr) {
      sm90::store_acc<NI, MI>(acc, scratch,
                              [&](int mi, int row, int col) -> bf16* {
        const long long pix = pixel(n, i0, j0, m0 + 64 * mi + row);
        return pix < 0 ? nullptr : y + pix * NB + col;
      });
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
    n_tiles = n * tiles_hw;
    if constexpr (TMA_STORE) {  // y and the pool as [th, tw] boxes
      const cuuint64_t ydims[4] = {(cuuint64_t)O4, (cuuint64_t)wo,
                                   (cuuint64_t)ho, (cuuint64_t)n};
      const cuuint32_t ybox[4] = {64, (cuuint32_t)tw, (cuuint32_t)th, 1};
      int e = y ? sm90::make_map(&ymap, y, 4, ydims, ybox) : 0;
      if (e == 0 && (EPI & kPool) != 0) {
        const cuuint64_t pdims[4] = {(cuuint64_t)O4 / 4, (cuuint64_t)wo,
                                     (cuuint64_t)ho, (cuuint64_t)n};
        const cuuint32_t pbox[4] = {(cuuint32_t)O4 / 4, (cuuint32_t)tw,
                                    (cuuint32_t)th, 1};
        e = sm90::make_map(&pmap, pool, 4, pdims, pbox, false);
      }
      return e;
    }
    return 0;
  }
};

template <int O4, int SKIP, int EPI = 0>
struct FwdTiles : FwdOut<O4, EPI, 1> {
  using Out = FwdOut<O4, EPI, 1>;
  using Out::BM;
  using Out::NB;
  using Out::origin;
  using Out::th;
  using Out::tw;
  static constexpr int TAPS = 4;
  // an A slot holds the largest tap shift (W + 1 <= BM + 1) and BM rows
  // after it
  static constexpr int A_ROWS = (2 * BM + 1 + 7) / 8 * 8;
  static constexpr int B_STAGES = Out::b_stages(A_ROWS);
  static constexpr bool B_MN = true, GATHER = SKIP == 2;

  CUtensorMap xmap, wmap;  // H1's x and w; H2's up side: up and wb
  CUtensorMap smap, wsmap;  // H2's skip side: skip and wa
  const bf16* skip;    // the gathered skip
  int kps;             // K blocks a side: ceil(4C / 64)
  int c4, cs;          // 4C and C
  int hpa, wpa;        // the skip's grid
  int oh, ow;          // the crop offset, unpacked
  int slot;            // the skip's K blocks are per-slot boxes (C % 64 == 0)

  __device__ int k_blocks() const { return SKIP ? 2 * kps : kps; }
  __device__ bool gathered(int kb) const { return GATHER && kb < kps; }
  __device__ uint32_t a_tx(int kb) const {
    return gathered(kb) ? 0u : (uint32_t)((th + 1) * (tw + 1)) * 128u;
  }
  __device__ int a_row(int tap) const {  // (u, v) = (tap >> 1, tap & 1)
    return (tap >> 1) * (tw + 1) + (tap & 1);
  }
  __device__ void prefetch() const {
    sm90::prefetch_map(&xmap);
    sm90::prefetch_map(&wmap);
    if (SKIP) {
      if (!GATHER) sm90::prefetch_map(&smap);
      sm90::prefetch_map(&wsmap);
    }
  }
  __device__ void load_a(int t, int kb, uint8_t* a, uint64_t* bar) const {
    int n, i0, j0;
    origin(t, n, i0, j0);
    if (SKIP && kb < kps) {
      if (GATHER) return;
      const int k0 = 64 * kb;
      if (slot) {  // the block's output slot (d, e) = (s >> 1, s & 1)
        const int s = k0 / cs;
        const int yy = oh + (s >> 1), xx = ow + (s & 1);
        sm90::tma_load_4d(a, &smap, bar,
                          (2 * (yy & 1) + (xx & 1)) * cs + k0 - s * cs,
                          (xx >> 1) + j0, (yy >> 1) + i0, n);
      } else {
        sm90::tma_load_4d(a, &smap, bar, k0, ow / 2 + j0, oh / 2 + i0, n);
      }
      return;
    }
    sm90::tma_load_4d(a, &xmap, bar, 64 * (SKIP ? kb - kps : kb), j0, i0, n);
  }
  // The skip's K block kb, gathered: 16-byte chunk `chunk` of box row `row`
  // holds channels k .. k + 7 (one slot: C % 8 == 0), zero outside the skip
  // and past 4C, stored where TMA's 128-byte swizzle would put it.
  __device__ void gather_a(int t, int kb, uint8_t* a, int tid,
                           int nthreads) const {
    if (!gathered(kb)) return;
    int n, i0, j0;
    origin(t, n, i0, j0);
    const int w = tw + 1;
    const uint32_t base = sm90::smem_u32(a);
    for (int idx = tid; idx < (th + 1) * w * 8; idx += nthreads) {
      const int row = idx >> 3, chunk = idx & 7;
      const int k = 64 * kb + 8 * chunk;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < c4) {
        const int s = k / cs;
        const int bi = row / w;
        const int yy = oh + 2 * (i0 + bi) + (s >> 1);
        const int xx = ow + 2 * (j0 + row - bi * w) + (s & 1);
        if ((yy >> 1) < hpa && (xx >> 1) < wpa)
          v = __ldg(reinterpret_cast<const uint4*>(
              skip +
              (((long long)n * hpa + (yy >> 1)) * wpa + (xx >> 1)) * c4 +
              (2 * (yy & 1) + (xx & 1)) * cs + k - s * cs));
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                       base + row * 128 + ((chunk ^ (row & 7)) << 4)),
                   "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
  // the B rows of (K block, tap): 64 rows of w viewed as [4 * 4C, 4O], one
  // box per 64 columns
  __device__ void load_b(int kb, int tap, uint8_t* b, uint64_t* bar) const {
    const bool skip_side = SKIP && kb < kps;
    const CUtensorMap* m = skip_side ? &wsmap : &wmap;
    const int row = tap * c4 + 64 * (SKIP && !skip_side ? kb - kps : kb);
#pragma unroll
    for (int j = 0; j < NB / 64; ++j)
      sm90::tma_load_2d(b + j * sm90::kMnBox, m, bar, 64 * j, row);
  }
};

template <int O4, int SKIP, int EPI>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    packed_conv2x2_fwd_kernel(
        const __grid_constant__ FwdTiles<O4, SKIP, EPI> p) {
  sm90::run(p);
}

// H2's kernel, under its own name: profiles group kernels by name
template <int O4, int SKIP, int EPI>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    packed_conv2x2_dual_fwd_kernel(
        const __grid_constant__ FwdTiles<O4, SKIP, EPI> p) {
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

// The walk and launch of a filled problem: the tiles of the output grid
// [n, ho, wo] and the K blocks of 4C.
template <int O4, int SKIP, int EPI>
int fwd_launch(FwdTiles<O4, SKIP, EPI>& p, int n, int ho, int wo, int c4,
               int th, int tw, cudaStream_t stream) {
  p.c4 = c4;
  p.cs = c4 / 4;
  p.kps = (c4 + 63) / 64;
  const int e = p.plan(n, ho, wo, th, tw);
  if (e != 0) return e;
  if constexpr (SKIP != 0)
    return sm90::launch(packed_conv2x2_dual_fwd_kernel<O4, SKIP, EPI>, p,
                        stream);
  else
    return sm90::launch(packed_conv2x2_fwd_kernel<O4, SKIP, EPI>, p, stream);
}

}  // namespace segk
