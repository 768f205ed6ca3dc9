// H9 packed_tap_grad: the weight gradient of H1's 2x2 VALID conv over a
// packed tensor, and of both halves of H2's dual conv in one launch.
//
//   dw[u, v, c, o] = sum over n, i, j of x[n, i + u, j + v, c] g[n, i, j, o]
//
// x [N, hp, wp, 4C] bf16 is the site's saved input; g [N, hp, wp, 4O] bf16
// the ReLU-masked cotangent in its zero-margined buffer (the real [N, hp -
// 1, wp - 1] and a zero last row and column: train_glue.cu's relu_bias_grad
// with pad), read in place; dw [2, 2, 4C, 4O] bf16, summed in f32 over every
// pixel and rounded once. The dual mode computes dwa of the skip, read in
// place through its crop at the unpacked offset (oh, ow) by H2's address
// rule, and dwb of up, from the same g in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves the weight gradient to
// four XLA dots, one a tap (segmentation_tpu/nn/pallas/conv_flat_bwd.py
// conv2x2_wgrad_flat), which the port ran as four library products.
//
// Bound on the H100: x and g read once. A pixel's four taps do 2 x 4 x 4C x
// 4O operations over (4C + 4O) x 2 bytes: 256 operations a byte at 4C = 4O
// = 128, near the card's ~295, 512 at 256, 1024 at 512. A product a tap
// reads both operands four times and sits at a quarter of that, below the
// ridge at every width.
//
// Design (one algorithm; the wrapper's conv_bwd.tap_grad_plan sizes it):
//  - A tap's GEMM is M = 4C (x's channels) by N = 4O (g's) over K = pixels.
//    Both operands are MN-major as they lie in memory: a K block is 128
//    pixel rows of 64 channels a TMA box, in the 128-byte swizzle, and
//    wgmma reads A (x) and B (g) transposed.
//  - A block holds dw of the taps (u, 0) and (u, 1) over a tile of 128
//    channels of x by 128 of g: consumer warpgroup v the tap (u, v), two
//    m64n128 f32 accumulators, 128 registers a thread. The four taps of a
//    128 x 128 tile would not fit one block's registers.
//  - One read of x serves both taps of a block: its A box holds the K
//    block's 128 rows of x and one more, and tap v's view starts v rows in
//    (a descriptor's start on any 128-byte row of the swizzled box, base
//    offset 0, as sm90_igemm.cuh's K-major A). Taps u = 1 read x wp rows
//    on: the block of u = 0 reads those rows a few K blocks later, so HBM
//    serves each x row once and L2 the second read, and both blocks read
//    the same g boxes together.
//  - Flat K, where x lies on g's grid: K block k is pixel rows [128 k, 128
//    k + 128) of the flattened [N hp wp] grid, tap (u, v) reading x at row
//    p + u wp + v. A real g pixel's taps never leave its image; the
//    margin's g rows are zeros, and so are TMA's rows past the end.
//  - The crop (a dual's skip, in place): x(n, i, j) of 64 channels q is the
//    skip's pixel (n, i + di, j + dj) at channel cc, (di, dj, cc) of each q
//    from the wrapper (conv_bwd.crop_chunks: one offset for an even crop,
//    one a slot for an odd one's slot phase). K blocks are segments of 128
//    columns of one image row of g (4-D boxes, zero past g's row), the
//    row's last segment only as many k-steps as its real columns need and
//    its boxes only as wide (a second map each): the skip's columns past
//    the crop are not read, and no box fills more rows with TMA's zeros
//    than its k-steps round up.
//  - The K split: the grid is S splits x 2 (u) x the 4C and 4O tiles, one
//    wave at the planned sizes (at most one block an SM); the block of
//    split t sums each side's K blocks [t K / S, (t + 1) K / S), a dual's
//    skip side, then its up side (a store of the f32 sums between). So
//    every block does the same work however fast each side runs: the crop
//    runs 1.3-1.45x the time of the flat walk over the same g on the H100
//    (shorter K blocks, the crop's own loads), and a grid that gave each
//    side its own blocks could not balance them at 4C = 512 (32 blocks a
//    split), where whole splits are the unit. g is read once a side: from
//    HBM twice for a dual, but x, the skip and dw once. The blocks of one
//    split walk the same rows at the same time, so L2 serves every tile's
//    read after the first. Each block stores its f32 sums into the partial
//    [sides, S, 4, 4C, 4O]; a second kernel adds a side's S partials in a
//    fixed order and rounds once to bf16. Deterministic (two launches give
//    the same bits), with no atomics or zero fill; the partials are a few
//    MB (4 S 4C 4O floats a side) against the GBs of x and g.
//  - Pipeline: sm90_igemm.cuh's primitives, one producer thread (TMA), two
//    consumer warpgroups (setmaxnreg), three 66-KB stages, one wgmma group
//    in flight while the next stage is waited for. A K block's k-steps
//    are one unrolled chain of wgmma for each count (mma_steps), not one
//    chain with a test before each step: the test made ptxas put a
//    warpgroup.arrive before every wgmma.
#include "sm90_igemm.cuh"

namespace segk {

using sm90::bf16;

constexpr int kTile = 128;              // dw rows (x's channels) and columns
constexpr int kKRows = 128;             // pixel rows of a K block
constexpr int kARows = kKRows + 1;      // x's rows a K block reads: one more
constexpr int kABox = 136 * 128;        // an A box's bytes, in 8-row groups
constexpr int kBBox = kKRows * 128;     // a B box's bytes
constexpr int kStage = 2 * kABox + 2 * kBBox;
constexpr int kStages = 3;
constexpr int kMaxChunks = 8;           // 64-channel chunks of 4C <= 512
constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
static_assert(kSmem <= sm90::kSmemMax, "the stages exceed shared memory");

struct TapGradSide {
  int crop;      // K blocks: 0 rows of the flat grid, 1 row segments
  int k_blocks;
  int wp;        // flat: taps u = 1 read x this many rows on
  int hg, wg;    // crop: g's real rows and columns an image
  int segs;      // crop: segments of kKRows columns a row
  int di[kMaxChunks], dj[kMaxChunks], cc[kMaxChunks];  // crop: see above
};

struct TapGradParams {
  CUtensorMap xmap[2], gmap[2];
  CUtensorMap xtail, gtail;  // the crop's last segment of a row (side 0)
  TapGradSide side[2];
  float* part;
  int sides, row_tiles, col_tiles, splits, c4, o4;
};

// A block's work: its split, u and tiles.
struct Unit {
  int split, u, ct, ot;
};

__device__ __forceinline__ Unit unit_of(const TapGradParams& p) {
  Unit w;
  int b = blockIdx.x;
  w.ot = b % p.col_tiles;
  b /= p.col_tiles;
  w.ct = b % p.row_tiles;
  b /= p.row_tiles;
  w.u = b & 1;
  w.split = b >> 1;
  return w;
}

// The K blocks [k0, k1) of a side that split t sums.
__device__ __forceinline__ void k_range(const TapGradParams& p, int side,
                                        int t, int& k0, int& k1) {
  const long long kb = p.side[side].k_blocks;
  k0 = (int)(t * kb / p.splits);
  k1 = (int)((t + 1) * kb / p.splits);
}

// The k-steps of K block k and, for the crop, its image n, g's row i and
// first column j0.
__device__ __forceinline__ int k_steps(const TapGradSide& s, int k, int& n,
                                       int& i, int& j0) {
  n = i = j0 = 0;
  if (!s.crop) return kKRows / 16;
  const int per_image = s.hg * s.segs;
  n = k / per_image;
  const int r = k - n * per_image;
  i = r / s.segs;
  j0 = (r - i * s.segs) * kKRows;
  const int cols = min(kKRows, s.wg - j0);
  return (cols + 15) / 16;
}

// wgmma descriptor of an MN-major operand with 128-byte swizzle: 64 columns
// (or rows of A) a box, K row k at byte 128 k, 8-row groups 1024 bytes
// apart (SBO), the next 64 columns `lbo` bytes on, layout 1.
__device__ __forceinline__ uint64_t mn_desc(const void* p, int lbo) {
  return (uint64_t)((sm90::smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// S k-steps of both accumulators, unrolled, for steps = S or fewer (then
// the chain of steps - 1 and below).
template <int S>
__device__ __forceinline__ void mma_steps(float (&acc)[2][64], uint64_t da0,
                                          uint64_t da1, uint64_t db,
                                          int steps) {
  if constexpr (S > 1) {
    if (steps < S) {
      mma_steps<S - 1>(acc, da0, da1, db, steps);
      return;
    }
  }
#pragma unroll
  for (int ks = 0; ks < S; ++ks) {
    sm90::wgmma_m64n128k16<1, 1>(acc[0], da0 + 128 * ks, db + 128 * ks, 1);
    sm90::wgmma_m64n128k16<1, 1>(acc[1], da1 + 128 * ks, db + 128 * ks, 1);
  }
}

__device__ __forceinline__ void produce(const TapGradParams& p, const Unit& w,
                                        uint8_t* ring, uint64_t* full,
                                        uint64_t* empty) {
  const int c0 = w.ct * kTile, o0 = w.ot * kTile;
  sm90::Pos<kStages> q;
  for (int side = 0; side < p.sides; ++side) {
    const TapGradSide& s = p.side[side];
    const CUtensorMap* const gm = &p.gmap[side];
    int k0, k1;
    k_range(p, side, w.split, k0, k1);
    for (int k = k0; k < k1; ++k) {
      sm90::mbar_wait(&empty[q.stage], q.phase ^ 1);
      uint8_t* const a = ring + q.stage * kStage;
      uint8_t* const b = a + 2 * kABox;
      uint64_t* const bar = &full[q.stage];
      if (!s.crop) {
        const CUtensorMap* const xm = &p.xmap[side];
        sm90::mbar_expect_tx(bar, 2u * kARows * 128 + 2u * kKRows * 128);
        const int p0 = k * kKRows;
        for (int h = 0; h < 2; ++h) {
          sm90::tma_load_2d(a + h * kABox, xm, bar, c0 + 64 * h,
                            p0 + w.u * s.wp);
          sm90::tma_load_2d(b + h * kBBox, gm, bar, o0 + 64 * h, p0);
        }
      } else {
        int n, i, j0;
        const int steps = k_steps(s, k, n, i, j0);
        // a whole segment's boxes, or the row's last: 16 steps rows of g,
        // one more of x
        const bool whole = steps == kKRows / 16;
        const CUtensorMap* const xm = whole ? &p.xmap[side] : &p.xtail;
        const CUtensorMap* const gt = whole ? gm : &p.gtail;
        sm90::mbar_expect_tx(bar, 2u * (16 * steps + 1) * 128 +
                                      2u * (16 * steps) * 128);
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * w.ct + h;  // x's 64-channel chunk
          sm90::tma_load_4d(a + h * kABox, xm, bar, s.cc[c], j0 + s.dj[c],
                            i + w.u + s.di[c], n);
          sm90::tma_load_4d(b + h * kBBox, gt, bar, o0 + 64 * h, j0, i, n);
        }
      }
      q.next();
    }
  }
}

// The f32 sums of one side into the partial [side, split, tap (u, v), 4C,
// 4O]: d[j] of m64 group mi is row 64 mi + 16 warp + lane / 4 + 8 ((j >> 1)
// & 1), column 8 (j >> 2) + 2 (lane & 3) + (j & 1).
__device__ __forceinline__ void store_part(const TapGradParams& p,
                                           const Unit& w, int side, int v,
                                           const float (&acc)[2][64]) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float* const out =
      p.part +
      ((((long long)side * p.splits + w.split) * 4 + 2 * w.u + v) * p.c4 +
       w.ct * kTile) * p.o4 + w.ot * kTile;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const int row = 64 * mi + 16 * warp + (lane >> 2) + 8 * ((j >> 1) & 1);
      const int col = 8 * (j >> 2) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + (long long)row * p.o4 + col) =
          make_float2(acc[mi][j], acc[mi][j + 1]);
    }
}

__device__ __forceinline__ void consume(const TapGradParams& p, const Unit& w,
                                        uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int v) {
  const bool leader = (threadIdx.x & 31) == 0;
  sm90::Pos<kStages> q;
  for (int side = 0; side < p.sides; ++side) {
    const TapGradSide& s = p.side[side];
    float acc[2][64];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[mi][j] = 0.f;
    int prev = -1;  // the stage of the wgmma group in flight
    int k0, k1;
    k_range(p, side, w.split, k0, k1);
    for (int k = k0; k < k1; ++k) {
      int n, i, j0;
      const int steps = k_steps(s, k, n, i, j0);
      sm90::mbar_wait(&full[q.stage], q.phase);
      const uint8_t* const a = ring + q.stage * kStage;
      // tap v's view of the A boxes starts v rows in; a k-step is 16 K rows
      // (2048 bytes: 128 in the address field)
      const uint64_t da0 = mn_desc(a + v * 128, kABox);
      const uint64_t da1 = mn_desc(a + kABox + v * 128, kABox);
      const uint64_t db = mn_desc(a + 2 * kABox, kBBox);
      sm90::fence_acc(acc[0]);
      sm90::fence_acc(acc[1]);
      sm90::wgmma_fence();
      mma_steps<kKRows / 16>(acc, da0, da1, db, steps);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (leader && prev >= 0) sm90::mbar_arrive(&empty[prev]);
      prev = q.stage;
      q.next();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc[0]);
    sm90::fence_acc(acc[1]);
    if (leader && prev >= 0) sm90::mbar_arrive(&empty[prev]);
    store_part(p, w, side, v, acc);
  }
}

__global__ void __launch_bounds__(sm90::kThreads, 1)
    packed_tap_grad_kernel(const __grid_constant__ TapGradParams p) {
  uint8_t* const ring =  // the dynamic shared memory, 1024-byte aligned
      sm90::dyn_smem +
      ((1024 - (sm90::smem_u32(sm90::dyn_smem) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* const empty = full + kStages;
  const Unit w = unit_of(p);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        sm90::kProducerRegs));
    if (threadIdx.x == 0) produce(p, w, ring, full, empty);
  } else {
    constexpr int regs = sm90::consumer_regs(sm90::kProducerRegs);
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(regs));
    consume(p, w, ring, full, empty, threadIdx.x / 128 - 1);
  }
}

// dw[side][e] = bf16(sum over s of part[side][s][e]), four elements a
// thread, the splits in order; `per` elements a side.
__global__ void tap_grad_sum_kernel(const float* __restrict__ part,
                                    bf16* __restrict__ dw, int per, int sides,
                                    int splits) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= sides * per) return;
  const int side = i / per, e = i - side * per;
  const float* const src = part + (long long)side * splits * per + e;
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float4 r = *reinterpret_cast<const float4*>(src + (long long)s * per);
    t.x += r.x;
    t.y += r.y;
    t.z += r.z;
    t.w += r.w;
  }
  *reinterpret_cast<uint2*>(dw + i) =
      make_uint2(sm90::pack_bf16(t.x, t.y), sm90::pack_bf16(t.z, t.w));
}

// x [n, hp, wp, c4] on g's grid: 2-D maps over the flattened pixel rows
int flat_side(CUtensorMap* xmap, CUtensorMap* gmap, TapGradSide& s,
              const void* x, const void* g, int n, int hp, int wp, int c4,
              int o4) {
  const cuuint64_t rows = (cuuint64_t)n * hp * wp;
  const cuuint64_t xdims[2] = {(cuuint64_t)c4, rows};
  const cuuint64_t gdims[2] = {(cuuint64_t)o4, rows};
  const cuuint32_t xbox[2] = {64, kARows}, gbox[2] = {64, kKRows};
  int e = sm90::make_map(xmap, x, 2, xdims, xbox);
  if (e == 0) e = sm90::make_map(gmap, g, 2, gdims, gbox);
  s.crop = 0;
  s.wp = wp;
  s.k_blocks = (int)((rows + kKRows - 1) / kKRows);
  return e;
}

// the skip [n, hpa, wpa, c4] read through its crop: 4-D maps, row segments
// (xtail, gtail: the boxes of a row's last segment)
int crop_side(CUtensorMap* xmap, CUtensorMap* xtail, CUtensorMap* gmap,
              CUtensorMap* gtail, TapGradSide& s, const void* skip,
              const void* g, int n, int hp, int wp, int hpa, int wpa, int c4,
              int o4, const int* chunks) {
  s.crop = 1;
  s.hg = hp - 1;
  s.wg = wp - 1;
  s.segs = (s.wg + kKRows - 1) / kKRows;
  const int last = s.wg - (s.segs - 1) * kKRows;  // the last one's columns
  const cuuint64_t xdims[4] = {(cuuint64_t)c4, (cuuint64_t)wpa,
                               (cuuint64_t)hpa, (cuuint64_t)n};
  const cuuint64_t gdims[4] = {(cuuint64_t)o4, (cuuint64_t)wp,
                               (cuuint64_t)hp, (cuuint64_t)n};
  const cuuint32_t xbox[4] = {64, kARows, 1, 1}, gbox[4] = {64, kKRows, 1, 1};
  const cuuint32_t rows = 16 * ((last + 15) / 16);
  const cuuint32_t xtbox[4] = {64, rows + 1, 1, 1}, gtbox[4] = {64, rows, 1, 1};
  int e = sm90::make_map(xmap, skip, 4, xdims, xbox);
  if (e == 0) e = sm90::make_map(xtail, skip, 4, xdims, xtbox);
  if (e == 0) e = sm90::make_map(gmap, g, 4, gdims, gbox);
  if (e == 0) e = sm90::make_map(gtail, g, 4, gdims, gtbox);
  s.k_blocks = n * s.hg * s.segs;
  const int q = c4 / 64;
  for (int c = 0; c < q; ++c) {
    s.di[c] = chunks[c];
    s.dj[c] = chunks[q + c];
    s.cc[c] = chunks[2 * q + c];
  }
  return e;
}

}  // namespace segk

// xa [n, hp, wp, c4] bf16 (single, and the dual's skip uncropped), or with
// `chunks` the dual's skip [n, hpa, wpa, c4] read through its crop: chunks
// holds (di, dj, cc) of each of x's c4 / 64 channel chunks as three runs of
// c4 / 64 ints (conv_bwd.crop_chunks); xb the dual's up [n, hp, wp, c4] (null
// for the single mode); g [n, hp, wp, o4] bf16, the zero-margined buffer;
// splits the K splits (tap_grad_plan); part f32 [sides, splits, 4, c4, o4]
// scratch; dw bf16 [sides, 2, 2, c4, o4]. c4, o4 multiples of 128 up to
// 512; every pointer 16-byte aligned.
extern "C" int seg_packed_tap_grad(const void* xa, const void* xb,
                                   const void* g, void* part, void* dw, int n,
                                   int hp, int wp, int c4, int o4, int splits,
                                   int hpa, int wpa, const int* chunks,
                                   void* stream) {
  using namespace segk;
  if (c4 < 128 || c4 > 512 || c4 % 128 || o4 < 128 || o4 > 512 ||
      o4 % 128 || n < 1 || hp < 2 || wp < 2 || splits < 1 ||
      (chunks == nullptr && (hpa != hp || wpa != wp)) || hpa < hp - 1 ||
      wpa < wp - 1)
    return (int)cudaErrorInvalidValue;
  TapGradParams p{};
  p.sides = xb != nullptr ? 2 : 1;
  p.row_tiles = c4 / kTile;
  p.col_tiles = o4 / kTile;
  p.splits = splits;
  p.c4 = c4;
  p.o4 = o4;
  p.part = (float*)part;
  int e = chunks != nullptr
              ? crop_side(&p.xmap[0], &p.xtail, &p.gmap[0], &p.gtail,
                          p.side[0], xa, g, n, hp, wp, hpa, wpa, c4, o4,
                          chunks)
              : flat_side(&p.xmap[0], &p.gmap[0], p.side[0], xa, g, n, hp, wp,
                          c4, o4);
  if (e == 0 && xb != nullptr)
    e = flat_side(&p.xmap[1], &p.gmap[1], p.side[1], xb, g, n, hp, wp, c4,
                  o4);
  if (e != 0) return e;
  for (int s = 0; s < p.sides; ++s)
    if (p.side[s].k_blocks < splits) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t ce = cudaFuncSetAttribute(
      packed_tap_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (ce != cudaSuccess) return (int)ce;
  const int grid = splits * 2 * p.row_tiles * p.col_tiles;
  packed_tap_grad_kernel<<<grid, sm90::kThreads, kSmem, st>>>(p);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  const int per = 4 * c4 * o4;
  tap_grad_sum_kernel<<<(p.sides * per / 4 + 255) / 256, 256, 0, st>>>(
      (const float*)part, (bf16*)dw, per, p.sides, splits);
  return (int)cudaGetLastError();
}
