// Shared implicit-GEMM core of the packed U-Net kernels (sm_90a).
//
// Every packed site of the U-Net serving forward is a product
//   C[m, o] = sum_k A[m, k] * W[k, o]
// where m walks the output pixels of an NHWC tensor, o the 4O packed output
// channels, and A is never materialised: a Loader maps (pixel, k) to an
// address in the input activation (the conv taps, the skip crop, the slot
// scatter). The four kernels differ only in their Loader and epilogue.
//
// Design, first version: one 256-thread block computes BM pixels x all BN
// (= 4O, 128 or 256) output channels, so the slot-max pool and the mask
// head see whole pixels inside the block. K advances in BK = 32 chunks;
// each thread prefetches its next A/B chunk into registers (16-byte loads)
// while the warps run bf16 WMMA 16x16x16 products with f32 accumulation
// on the current chunk in shared memory. The f32 tile is then staged in
// shared memory for the epilogue. No wgmma/TMA yet.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace segk {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kBK = 32;
constexpr int kAPad = 8;  // bf16 elements of row padding (bank spread)
constexpr int kBPad = 8;
constexpr int kCPad = 4;  // f32 elements

template <int BN>
struct TileCfg {
  static_assert(BN == 128 || BN == 256, "BN (= 4O) must be 128 or 256");
  static constexpr int BM = BN == 128 ? 128 : 64;
  static constexpr int WARPS_N = BN / 64;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int WARP_M = BM / WARPS_M;  // 32
  static constexpr int FM = WARP_M / 16;       // 2
  static constexpr int FN = 64 / 16;           // 4
  static constexpr int LDA = kBK + kAPad;
  static constexpr int LDB = BN + kBPad;
  static constexpr int LDC = BN + kCPad;
  static constexpr int A_VECS = BM * kBK / 8 / kThreads;
  static constexpr int B_VECS = kBK * BN / 8 / kThreads;
  static constexpr int A_BYTES = BM * LDA * 2;
  static constexpr int B_BYTES = kBK * LDB * 2;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int SMEM =
      (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;
};

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ unsigned pack2bf(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

__device__ __forceinline__ float bf_round(float a) {
  return __bfloat162float(__float2bfloat16(a));
}

// Decode an output pixel index m of an [N, ho, wo] grid.
struct Pix {
  long long n;
  int i, j;
};

__device__ __forceinline__ Pix decode(long long m, int ho, int wo) {
  Pix p;
  const long long hw = (long long)ho * wo;
  p.n = m / hw;
  const int rem = (int)(m - p.n * hw);
  p.i = rem / wo;
  p.j = rem - p.i * wo;
  return p;
}

// C[m0:m0+BM, 0:BN] = A @ W into shared memory (f32, row stride LDC).
// Rows k < ka of W come from wa, rows k >= ka from wb (k - ka). Loader:
//   Row row(long long m, bool ok) const;  // per-pixel context
//   uint4 load(const Row&, int k) const;   // A[m, k..k+7], k % 8 == 0
// load() is only called for ok rows and k < K.
template <int BN, class Loader>
__device__ __forceinline__ float* igemm_tile(
    const Loader& ld, const bf16* __restrict__ wa,
    const bf16* __restrict__ wb, int ka, int K, long long m0, long long M,
    unsigned char* smem) {
  using T = TileCfg<BN>;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + T::A_BYTES);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / T::WARPS_N;
  const int wn = warp % T::WARPS_N;

  typename Loader::Row rows[T::A_VECS];
  int arow[T::A_VECS];
  const int akq = (tid & 3) * 8;
#pragma unroll
  for (int i = 0; i < T::A_VECS; ++i) {
    arow[i] = (tid + i * kThreads) >> 2;
    const long long m = m0 + arow[i];
    rows[i] = ld.row(m, m < M);
  }

  uint4 ra[T::A_VECS];
  uint4 rb[T::B_VECS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < T::A_VECS; ++i) {
      const int k = k0 + akq;
      ra[i] = (rows[i].ok && k < K) ? ld.load(rows[i], k) : zero4();
    }
#pragma unroll
    for (int i = 0; i < T::B_VECS; ++i) {
      const int v = tid + i * kThreads;
      const int k = k0 + v / (BN / 8);
      const int col = (v % (BN / 8)) * 8;
      if (k < K) {
        const bf16* src = k < ka ? wa + (long long)k * BN
                                 : wb + (long long)(k - ka) * BN;
        rb[i] = *reinterpret_cast<const uint4*>(src + col);
      } else {
        rb[i] = zero4();
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int a = 0; a < T::FM; ++a)
#pragma unroll
    for (int b = 0; b < T::FN; ++b) wmma::fill_fragment(acc[a][b], 0.0f);

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous chunk's products are done
#pragma unroll
    for (int i = 0; i < T::A_VECS; ++i)
      *reinterpret_cast<uint4*>(As + arow[i] * T::LDA + akq) = ra[i];
#pragma unroll
    for (int i = 0; i < T::B_VECS; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(Bs + (v / (BN / 8)) * T::LDB +
                                (v % (BN / 8)) * 8) = rb[i];
    }
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[T::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[T::FN];
#pragma unroll
      for (int a = 0; a < T::FM; ++a)
        wmma::load_matrix_sync(
            fa[a], As + (wm * T::WARP_M + a * 16) * T::LDA + kk, T::LDA);
#pragma unroll
      for (int b = 0; b < T::FN; ++b)
        wmma::load_matrix_sync(fb[b], Bs + kk * T::LDB + wn * 64 + b * 16,
                               T::LDB);
#pragma unroll
      for (int a = 0; a < T::FM; ++a)
#pragma unroll
        for (int b = 0; b < T::FN; ++b)
          wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
  }
  __syncthreads();  // the A/B buffers become the C stage
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int a = 0; a < T::FM; ++a)
#pragma unroll
    for (int b = 0; b < T::FN; ++b)
      wmma::store_matrix_sync(
          Cs + (wm * T::WARP_M + a * 16) * T::LDC + wn * 64 + b * 16,
          acc[a][b], T::LDC, wmma::mem_row_major);
  __syncthreads();
  return Cs;
}

// y = bf16(relu(C + bias)). Stores whole pixels to out [M, BN] when out is
// set; with keep, writes the rounded value back into the stage for the
// pool / head passes (they read the STORED value, as the TPU kernel does).
template <int BN>
__device__ __forceinline__ void epilogue_store(
    float* Cs, const float* __restrict__ bias, bf16* __restrict__ out,
    bool keep, long long m0, long long M) {
  using T = TileCfg<BN>;
  for (int idx = threadIdx.x; idx < T::BM * (BN / 8); idx += kThreads) {
    const int r = idx / (BN / 8);
    const int c = (idx % (BN / 8)) * 8;
    const long long m = m0 + r;
    if (m >= M) continue;
    float* crow = Cs + r * T::LDC + c;
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      v[t] = bf_round(fmaxf(crow[t] + bias[c + t], 0.0f));
      if (keep) crow[t] = v[t];
    }
    if (out != nullptr) {
      uint4 u;
      u.x = pack2bf(v[0], v[1]);
      u.y = pack2bf(v[2], v[3]);
      u.z = pack2bf(v[4], v[5]);
      u.w = pack2bf(v[6], v[7]);
      *reinterpret_cast<uint4*>(out + m * BN + c) = u;
    }
  }
}

// 2x2/2 max pool in packed space: the max over the 4 slots of each channel.
template <int BN>
__device__ __forceinline__ void epilogue_pool(const float* Cs,
                                              bf16* __restrict__ pool,
                                              long long m0, long long M) {
  using T = TileCfg<BN>;
  constexpr int O = BN / 4;
  for (int idx = threadIdx.x; idx < T::BM * (O / 8); idx += kThreads) {
    const int r = idx / (O / 8);
    const int c = (idx % (O / 8)) * 8;
    const long long m = m0 + r;
    if (m >= M) continue;
    const float* crow = Cs + r * T::LDC + c;
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t] = fmaxf(fmaxf(crow[t], crow[O + t]),
                   fmaxf(crow[2 * O + t], crow[3 * O + t]));
    uint4 u;
    u.x = pack2bf(v[0], v[1]);
    u.y = pack2bf(v[2], v[3]);
    u.z = pack2bf(v[4], v[5]);
    u.w = pack2bf(v[6], v[7]);
    *reinterpret_cast<uint4*>(pool + m * O + c) = u;
  }
}

// Binary mask head: mask[m, t] = (sum_o y[m, o] * wd[o, t] + bd[t] > 0).
template <int BN>
__device__ __forceinline__ void epilogue_head(const float* Cs,
                                              const bf16* __restrict__ wd,
                                              const float* __restrict__ bd,
                                              uint8_t* __restrict__ mask,
                                              long long m0, long long M) {
  using T = TileCfg<BN>;
  for (int idx = threadIdx.x; idx < T::BM * 4; idx += kThreads) {
    const int r = idx >> 2;
    const int t = idx & 3;
    const long long m = m0 + r;
    if (m >= M) continue;
    const float* crow = Cs + r * T::LDC;
    float s = 0.0f;
    for (int o = 0; o < BN; ++o) s += crow[o] * __bfloat162float(wd[o * 4 + t]);
    mask[m * 4 + t] = (s + bd[t] > 0.0f) ? 1 : 0;
  }
}

// Set the dynamic shared-memory limit and launch; returns the CUDA error.
template <int BN, class Kernel, class... Args>
int launch(Kernel kernel, long long M, cudaStream_t stream, Args... args) {
  using T = TileCfg<BN>;
  if (M <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((M + T::BM - 1) / T::BM);
  kernel<<<grid, kThreads, T::SMEM, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace segk
