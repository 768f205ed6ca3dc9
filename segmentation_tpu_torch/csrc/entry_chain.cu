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
// memory: each block computes a TH x TW tile of conv1_2 outputs and first
// recomputes the (TH+1) x (TW+1) conv1_1 pixels it reads (a one-row and
// one-column halo) into an s8 tile in shared memory.
//
// Bound on the H100: conv1_1 writes 128 channels per packed pixel from 48
// products each, so unfused the level is bound by the 2 x 1 byte x 128
// channels of conv1_1 written and read back per pixel; fused, the device
// traffic is the 24-byte input window, the 128-byte skip and the 32-byte
// pool per pixel, and the K = 512 int8 product bounds the block. The halo
// recompute adds (9 x 17) / (8 x 16) - 1 = 20 % to the small K = 48 product.
// A simple first version: WMMA through igemm.cuh for both products, no
// wgmma/TMA.
#include "loaders.cuh"

namespace segk {

constexpr int kO4 = 128;                   // 4O of conv1_1 and conv1_2
constexpr int kTH = 8, kTW = 16;           // conv1_2 outputs per block
constexpr int kEH = kTH + 1, kEW = kTW + 1;  // conv1_1 pixels per block
constexpr int kEPix = kEH * kEW;
constexpr int kTLD = kO4 + 16;  // tile row stride, bytes (bank spread)
constexpr int kTileBytes = (kEPix * kTLD + 127) / 128 * 128;
static_assert(kTH * kTW == TileCfg<kO4, s8>::BM, "one conv1_2 tile");

// conv1_1's 4x4/2 gather for the tile's conv1_1 pixels (m < kEPix).
struct EntryLoader {
  Strided4x4Loader<bf16, false> g;  // (h, w, c = 3) image, (ho, wo) = h1, w1
  long long n;
  int i0, j0;
  using Row = Strided4x4Loader<bf16, false>::Row;
  __device__ __forceinline__ Row row(long long m, bool ok) const {
    const int i = i0 + (int)m / kEW;
    const int j = j0 + (int)m % kEW;
    return g.at(n, i, j, ok && i < g.ho && j < g.wo);
  }
  __device__ __forceinline__ uint4 load(const Row& r, int k) const {
    return g.load(r, k);
  }
};

// conv1_2's 2x2 taps over the s8 conv1_1 tile in shared memory.
struct TileLoader {
  const s8* t;
  struct Row {
    const s8* p;
    bool ok;
  };
  __device__ __forceinline__ Row row(long long m, bool ok) const {
    return Row{t + ((int)m / kTW * kEW + (int)m % kTW) * kTLD, ok};
  }
  __device__ __forceinline__ uint4 load(const Row& r, int k) const {
    const int tap = k / kO4;  // (u, v) = (tap >> 1, tap & 1)
    return *reinterpret_cast<const uint4*>(
        r.p + ((tap >> 1) * kEW + (tap & 1)) * kTLD + k % kO4);
  }
};

// Output rows of the block's 2-D tile in the [N, ho, wo] grid.
struct TileRows {
  long long n;
  int i0, j0, ho, wo;
  __device__ __forceinline__ long long operator()(int r) const {
    const int i = i0 + r / kTW, j = j0 + r % kTW;
    return (i < ho && j < wo) ? (n * ho + i) * wo + j : -1;
  }
};

__global__ void __launch_bounds__(kThreads)
    entry_chain_kernel(Strided4x4Loader<bf16, false> img,
                       const bf16* __restrict__ w4,
                       const float* __restrict__ mul1,
                       const float* __restrict__ add1,
                       const s8* __restrict__ w2,
                       const float* __restrict__ mul2,
                       const float* __restrict__ add2, s8* __restrict__ y,
                       s8* __restrict__ pool) {
  extern __shared__ __align__(128) unsigned char seg_smem[];
  s8* tile = reinterpret_cast<s8*>(seg_smem);
  unsigned char* core = seg_smem + kTileBytes;
  const long long n = blockIdx.z;
  const int i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;

  // conv1_1 on the (TH+1) x (TW+1) pixels, BM rows at a time, into the tile
  const EntryLoader ld1{img, n, i0, j0};
  for (int m0 = 0; m0 < kEPix; m0 += TileCfg<kO4>::BM) {
    const float* Cs = igemm_tile<kO4, bf16>(ld1, w4, 48, m0, kEPix, core);
    for (int idx = threadIdx.x; idx < TileCfg<kO4>::BM * (kO4 / 8);
         idx += kThreads) {
      const int r = idx / (kO4 / 8);
      const int c = (idx % (kO4 / 8)) * 8;
      if (m0 + r >= kEPix) continue;
      const float* crow = Cs + r * TileCfg<kO4>::LDC + c;
      float v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        v[t] = finish(affine_relu(crow[t], mul1[c + t], add1[c + t]),
                      (s8*)nullptr);
      store8(tile + (m0 + r) * kTLD + c, v);
    }
  }
  __syncthreads();  // the tile is complete (the core prefetches before its
                    // first barrier)

  // conv1_2 on the tile, then the requant epilogue and the slot-max pool
  const int ho = img.ho - 1, wo = img.wo - 1;
  int* Cs = igemm_tile<kO4, s8>(TileLoader{tile}, w2, 4 * kO4, 0,
                                TileCfg<kO4, s8>::BM, core);
  const TileRows rows{n, i0, j0, ho, wo};
  epilogue_affine<kO4, s8>(Cs, mul2, add2, y, true, rows);
  __syncthreads();
  epilogue_pool<kO4>(reinterpret_cast<const float*>(Cs), pool, rows);
}

}  // namespace segk

// x [n, h, w, 3] bf16; w4 [48, 128] bf16 (HWIO [4, 4, 3, 128]); mul1, add1
// [128] f32; w2 [512, 128] s8 (HWIO [2, 2, 128, 128]); mul2, add2 [128]
// f32; y [n, h1-1, w1-1, 128] s8; pool [n, h1-1, w1-1, 32] s8.
extern "C" int seg_entry_chain(const void* x, const void* w4,
                               const void* mul1, const void* add1,
                               const void* w2, const void* mul2,
                               const void* add2, void* y, void* pool, int n,
                               int h, int wdt, void* stream) {
  using namespace segk;
  const int h1 = (h - 2) / 2, w1 = (wdt - 2) / 2;
  if (n <= 0 || h1 < 2 || w1 < 2) return (int)cudaErrorInvalidValue;
  const Strided4x4Loader<bf16, false> img{(const bf16*)x, h, wdt, 3, h1, w1};
  const dim3 grid((w1 - 1 + kTW - 1) / kTW, (h1 - 1 + kTH - 1) / kTH, n);
  const int smem = kTileBytes + TileCfg<kO4>::SMEM;
  static_assert(TileCfg<kO4>::SMEM >= TileCfg<kO4, s8>::SMEM,
                "both products fit the core's buffers");
  return launch_grid(entry_chain_kernel, grid, smem, (cudaStream_t)stream,
                     img, (const bf16*)w4, (const float*)mul1,
                     (const float*)add1, (const s8*)w2, (const float*)mul2,
                     (const float*)add2, (s8*)y, (s8*)pool);
}
