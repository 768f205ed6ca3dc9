// H5 entry_chain: the whole int8 level 1 in one launch, on the raw bf16
// image [N, H, W, 3]:
//   conv1_1: 3x3 VALID conv + s2d fold as H3's 4x4/2 product in bf16 (f32
//            accumulation), requantized at conv1_2's input scale
//            (relu(acc * mul1 + add1), no channel scale) to s8;
//   conv1_2: the int8 2x2 packed conv over K = 4 * 4O (s32 accumulation),
//            requantized at conv2_1's input scale (mul2, add2);
//   pool:    the 2x2/2 slot-max of conv1_2's codes.
// Outputs: the s8 skip y [N, h1-1, w1-1, 4O] and the s8 pooled tensor
// [N, h1-1, w1-1, O], h1 = (H-2)/2 and w1 = (W-2)/2 (254 at 512^2).
//
// Replaces the TPU kernel segmentation_tpu/nn/pallas/conv_flat.py
// entry_chain_pf2 (:1644). As there, conv1_1's tensor never reaches device
// memory (66 MB of codes written and read back at B = 8).
//
// Design: one persistent block of three warpgroups per SM (the Hopper
// primitives of sm90_igemm.cuh; the output side FwdOut of
// packed_conv2x2_fwd.cuh), two products a tile. A tile is th x tw conv1_2
// outputs (tiles.entry_tile_plan), laid out as th (tw + 1) GEMM rows as in
// H1 (one junk column a row). It reads the (th + 1) x (tw + 1) conv1_1
// pixels of its halo, which it computes itself: the neighbouring tiles
// compute the shared halo pixels again ((th + 1)(tw + 1) / (th tw) - 1
// more conv1_1 rows, the plan's recompute share).
//  - Both weights stay in shared memory for the whole block, loaded once
//    by TMA: w4 [48 K, 128] MN-major (two [64, 64] boxes, K rows past 48
//    zero) and conv1_2's K-major copy wk [128, 4 * 128] (four [128, 128]
//    boxes, one a tap): 80 KiB.
//  - The producer warpgroup (four warps) gathers the tile's halo as
//    conv1_1's im2col rows (im2col.cuh, K = 48 of a 64-value bf16 row: 128
//    bytes) into a slot of A_ROWS rows, A_STAGES slots in a ring.
//  - The consumers take alternate tiles (ping-pong). For its tile a
//    consumer runs conv1_1 over the slot in m64 chunks (three wgmma k16
//    steps, N = 128, B = w4), requantizes each
//    chunk's accumulators and writes the s8 codes back over the chunk's
//    rows of the same slot: a row's 128 channels are 128 bytes, the bf16
//    row's geometry, in the 128-byte swizzle. After fence.proxy.async and
//    the consumer's barrier, conv1_2's four taps read the slot as row
//    shifts, as H1 s8 reads its halo box (s8 wgmma k32, B = the tap's
//    quarter of wk), into two m64n128 s32 accumulators; the slot goes back
//    to the producer and FwdOut's epilogue (requant, the slot-max pool,
//    TMA stores of y and the pool from a staging tile) runs while the
//    other consumer computes. (conv1_1 on the producer warpgroup, after
//    its gather, made the producer the bottleneck: 0.250 against 0.217 ms
//    at B = 8.)
//  - conv1_1's codes are those of H3's requant-only entry on the same
//    image: the same im2col rows, the same wgmma k16 steps in the same
//    order, the same epilogue's codes.
//
// Bound on the H100: bytes. Fused, the device traffic is the 24-byte input
// window, the 128-byte skip and the 32-byte pool per packed pixel; the
// operations (conv1_1 with its recompute in bf16, conv1_2 in s8) take
// about half as long at the tensor peaks.
#include "im2col.cuh"
#include "packed_conv2x2_fwd.cuh"

namespace segk {

constexpr int kEntryEpi = kInt8 | kRequant | kPool;

// The problem: FwdOut's walk and epilogue (conv1_2's outputs, 4O = 128,
// ping-pong) and the two products' operands. WIDE: a bf16 pair of the
// image is one 4-byte load.
template <bool WIDE>
struct EntryTiles : FwdOut<128, kEntryEpi, 1> {
  using Out = FwdOut<128, kEntryEpi, 1>;
  // a slot: the halo's conv1_1 pixels in up to four m64 chunks, which also
  // hold conv1_2's largest tap shift past the tile's BM rows
  static constexpr int A_ROWS = 256;
  static constexpr int A_BYTES = A_ROWS * 128;
  static constexpr int W4_BYTES = 2 * sm90::kMnBox;
  static constexpr int WK_BYTES = 4 * 128 * 128;
  static constexpr int NBAR = 1 + 2 * 4;
  static constexpr int FIXED = 1024 + W4_BYTES + WK_BYTES + STAGE_BYTES +
                               8 * sm90::kScratch + 8 * NBAR;
  static constexpr int A_STAGES = sm90::stages_that_fit(FIXED, A_BYTES, 4);
  static constexpr int SMEM = FIXED + A_STAGES * A_BYTES;
  static_assert(A_STAGES >= 2, "two slots fit");
  static constexpr int PRODUCERS = 128;  // the gathering threads
  static constexpr int GATHER_TASKS = 4;
  static constexpr int PRODUCER_REGS = 96;

  CUtensorMap w4map, wkmap;
  Im2col<bf16, WIDE> img;  // the image; its window grid is conv1_1's
  const float* mul1;       // conv1_1's epilogue [128]
  const float* add1;

  __device__ int a_row(int tap) const {  // (u, v) = (tap >> 1, tap & 1)
    return (tap >> 1) * (tw + 1) + (tap & 1);
  }
};

// The block's shared memory.
template <class P>
struct EntrySmem {
  uint8_t* base;
  __device__ explicit EntrySmem(uint8_t* raw)
      : base(raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023)) {}
  __device__ uint8_t* w4() const { return base; }
  __device__ uint8_t* wk() const { return base + P::W4_BYTES; }
  __device__ uint8_t* a(int s) const {
    return wk() + P::WK_BYTES + s * P::A_BYTES;
  }
  __device__ uint8_t* stage() const { return a(P::A_STAGES); }
  __device__ uint8_t* scratch(int warp) const {
    return stage() + P::STAGE_BYTES + warp * sm90::kScratch;
  }
  __device__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(scratch(8)) + i;
  }
  __device__ uint64_t* w_full() const { return bar(0); }
  __device__ uint64_t* a_full(int s) const { return bar(1 + s); }
  __device__ uint64_t* a_empty(int s) const {
    return bar(1 + P::A_STAGES + s);
  }
};

// Two codes of conv1_1's int8 epilogue, relu(acc * mul + add) rounded half
// to even and clipped to 127 (finish's codes: the ReLU leaves nothing
// below 0), as 16 bits, the lower column first. The clip goes first, then
// adding 1.5 * 2^23 rounds the f32 sum to the nearest integer, ties to
// even, and leaves the code in its low byte (int8_epilogue.cuh code_byte).
__device__ __forceinline__ uint32_t requant_pair(float a0, float a1,
                                                 float2 m, float2 b) {
  const float t0 = fminf(affine_relu(a0, m.x, b.x), 127.0f);
  const float t1 = fminf(affine_relu(a1, m.y, b.y), 127.0f);
  return __byte_perm(__float_as_uint(__fadd_rn(t0, 12582912.0f)),
                     __float_as_uint(__fadd_rn(t1, 12582912.0f)), 0x0040);
}

// conv1_1 over a slot of halo rows, in m64 chunks, each chunk's codes
// written back over its rows (a warp's rows only where they hold halo
// pixels): row r = 64 c + 16 warp + lane / 4 + 8 h of the wgmma fragment,
// column 8 jn + 2 q + e, as a 16-bit pair at the 128-byte swizzle's place
// of its 16-byte chunk jn / 2. (Two chunks in flight need a second
// accumulator, which spills beside conv1_2's.)
template <class P>
__device__ __forceinline__ void entry_conv1_1(const P& p, uint8_t* slot,
                                              uint64_t d_w4) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int warp = (threadIdx.x >> 5) & 3;
  const uint32_t base = sm90::smem_u32(slot);
  const int rows = (p.th + 1) * (p.tw + 1);
  for (int c = 0; 64 * c < rows; ++c) {
    float d[64];
    sm90::fence_acc(d);
    sm90::wgmma_fence();
    const uint64_t da = sm90::sw128_desc(slot + 64 * c * 128);
#pragma unroll
    for (int ks = 0; ks < 3; ++ks)  // K = 48: three k16 steps hold data
      sm90::wgmma_m64n128k16<1>(d, da + 2 * ks, d_w4 + (2048 >> 4) * ks,
                                ks > 0 ? 1 : 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(d);
    if (64 * c + 16 * warp >= rows) continue;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const float2 m2 =
          __ldg(reinterpret_cast<const float2*>(p.mul1) + 4 * jn + q);
      const float2 a2 =
          __ldg(reinterpret_cast<const float2*>(p.add1) + 4 * jn + q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * c + 16 * warp + (lane >> 2) + 8 * h;
        asm volatile("st.shared.u16 [%0], %1;" ::"r"(
                         base + r * 128 + (((jn >> 1) ^ (r & 7)) << 4) +
                         (jn & 1) * 8 + 2 * q),
                     "h"((unsigned short)requant_pair(
                         d[4 * jn + 2 * h], d[4 * jn + 2 * h + 1], m2, a2))
                     : "memory");
      }
    }
  }
}

// The producer warpgroup: thread 0 loads both weights once; then all four
// warps gather each tile's halo rows into the next slot (one arrival per
// warp on its full barrier), asking L2 for the tile after it.
template <class P>
__device__ __forceinline__ void entry_produce(const P& p,
                                              const EntrySmem<P>& s) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::prefetch_map(&p.w4map);
    sm90::prefetch_map(&p.wkmap);
    sm90::mbar_expect_tx(s.w_full(), P::W4_BYTES + P::WK_BYTES);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      sm90::tma_load_2d(s.w4() + j * sm90::kMnBox, &p.w4map, s.w_full(),
                        64 * j, 0);
#pragma unroll
    for (int tap = 0; tap < 4; ++tap)
      sm90::tma_load_2d(s.wk() + tap * 128 * 128, &p.wkmap, s.w_full(),
                        128 * tap, 0);
  }
  sm90::Pos<P::A_STAGES> a;
  const int eh = p.th + 1, ew = p.tw + 1;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    int n, i0, j0;
    sm90::mbar_wait(s.a_empty(a.stage), a.phase ^ 1);
    if (t + gridDim.x < p.n_tiles) {
      p.origin(t + gridDim.x, n, i0, j0);
      p.img.prefetch_rows(n, i0, j0, eh, ew, tid, P::PRODUCERS);
    }
    p.origin(t, n, i0, j0);
    p.img.template gather<P::GATHER_TASKS>(s.a(a.stage), 0, n, i0, j0, eh,
                                           ew, tid, P::PRODUCERS);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if ((tid & 31) == 0) sm90::mbar_arrive(s.a_full(a.stage));
    a.next();
  }
}

// A consumer warpgroup: its tiles (every other one of the block's), each
// conv1_1, the barrier, conv1_2, the slot's release, the epilogue.
template <class P>
__device__ __forceinline__ void entry_consume(const P& p,
                                              const EntrySmem<P>& s, int cg) {
  const int warp = (threadIdx.x >> 5) & 3;
  const bool leader = (threadIdx.x & 31) == 0;
  uint8_t* scratch = s.scratch(cg * 4 + warp);
  uint8_t* stage = s.stage() + cg * (P::STAGE_BYTES / 2);
  const uint64_t d_w4 = sm90::sw128_mn_desc(s.w4());
  const uint64_t d_wk = sm90::sw128_desc(s.wk());
  sm90::mbar_wait(s.w_full(), 0);
  sm90::Pos<P::A_STAGES> a;
  int i = 0;  // the block's tile count: tile i goes to consumer i % 2
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x, ++i, a.next()) {
    if ((i & 1) != cg) continue;
    sm90::mbar_wait(s.a_full(a.stage), a.phase);
    uint8_t* slot = s.a(a.stage);
    entry_conv1_1(p, slot, d_w4);
    // the codes are visible to wgmma (the async proxy) and complete
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    sm90::named_sync(3 + cg, 128);
    int acc[2][64];
    sm90::fence_acc(acc[0]);
    sm90::fence_acc(acc[1]);
    sm90::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const uint64_t da = sm90::sw128_desc(slot + p.a_row(tap) * 128);
      const uint64_t db = d_wk + ((tap * 128 * 128) >> 4);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          sm90::wgmma_m64n128k32_s8(acc[mi], da + 512 * mi + 2 * ks,
                                    db + 2 * ks, tap > 0 || ks > 0 ? 1 : 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc[0]);
    sm90::fence_acc(acc[1]);
    if (leader) sm90::mbar_arrive(s.a_empty(a.stage));
    p.store(t, cg, acc, scratch, stage);
  }
  // a consumer's TMA stores must have read its staging before it exits
  if ((threadIdx.x & 127) == 0) sm90::bulk_wait_read();
}

template <bool WIDE>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    entry_chain_kernel(const __grid_constant__ EntryTiles<WIDE> p) {
  using P = EntryTiles<WIDE>;
  const EntrySmem<P> s(sm90::dyn_smem);
  if (threadIdx.x == 0) {
    sm90::mbar_init(s.w_full(), 1);
    for (int k = 0; k < P::A_STAGES; ++k) {
      sm90::mbar_init(s.a_full(k), P::PRODUCERS / 32);
      sm90::mbar_init(s.a_empty(k), 4);  // the owning consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        P::PRODUCER_REGS));
    entry_produce(p, s);
  } else {
    constexpr int regs = sm90::consumer_regs(P::PRODUCER_REGS);
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(regs));
    entry_consume(p, s, threadIdx.x / 128 - 1);
  }
}

template <bool WIDE>
int run_entry(const void* x, const void* w4, const void* mul1,
              const void* add1, const void* wk, const void* mul2,
              const void* add2, void* y, void* pool, int n, int h, int wdt,
              int th, int tw, cudaStream_t stream) {
  using P = EntryTiles<WIDE>;
  P p{};
  const int h1 = (h - 2) / 2, w1 = (wdt - 2) / 2;
  p.img = {(const bf16*)x, h, wdt, 3, h1, w1};
  p.mul1 = (const float*)mul1;
  p.add1 = (const float*)add1;
  p.mul = (const float*)mul2;
  p.add = (const float*)add2;
  p.y = (s8*)y;
  p.pool = (s8*)pool;
  const cuuint64_t w4dims[2] = {128, 48};
  const cuuint32_t w4box[2] = {64, 64};
  const cuuint64_t wkdims[2] = {512, 128};
  const cuuint32_t wkbox[2] = {128, 128};
  int e = sm90::make_map(&p.w4map, w4, 2, w4dims, w4box);
  if (e == 0)
    e = sm90::make_map(&p.wkmap, wk, 2, wkdims, wkbox, true, sm90::kMapS8);
  if (e == 0) e = p.plan(n, h1 - 1, w1 - 1, th, tw);
  if (e != 0) return e;
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce == cudaSuccess)
    ce = cudaFuncSetAttribute(entry_chain_kernel<WIDE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              P::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  entry_chain_kernel<WIDE><<<grid, sm90::kThreads, P::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace segk

// x [n, h, w, 3] bf16; w4 [48, 128] bf16 (HWIO [4, 4, 3, 128]); mul1, add1
// [128] f32; wk [128, 512] s8, the K-major copy of conv1_2's weight [2, 2,
// 128, 128] (conv_int8.k_major); mul2, add2 [128] f32; y [n, h1-1, w1-1,
// 128] s8; pool [n, h1-1, w1-1, 32] s8; (th, tw) the tile of conv1_2
// outputs from tiles.entry_tile_plan: th (tw + 1) <= 128, (th + 1) (tw + 1)
// <= 256 and tw <= 126 (the largest tap shift stays in the slot). Every
// pointer but x 16-byte aligned.
extern "C" int seg_entry_chain(const void* x, const void* w4,
                               const void* mul1, const void* add1,
                               const void* wk, const void* mul2,
                               const void* add2, void* y, void* pool, int n,
                               int h, int wdt, int th, int tw, void* stream) {
  using namespace segk;
  const int h1 = (h - 2) / 2, w1 = (wdt - 2) / 2;
  constexpr int rows = EntryTiles<true>::A_ROWS;
  if (n <= 0 || h1 < 2 || w1 < 2 || th < 1 || tw < 1 ||
      (th + 1) * (tw + 1) > rows || tw + 2 + 128 > rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide =
      wdt % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  return wide ? run_entry<true>(x, w4, mul1, add1, wk, mul2, add2, y, pool,
                                n, h, wdt, th, tw, s)
              : run_entry<false>(x, w4, mul1, add1, wk, mul2, add2, y, pool,
                                 n, h, wdt, th, tw, s);
}
