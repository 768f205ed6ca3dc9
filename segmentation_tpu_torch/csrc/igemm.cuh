// Shared implicit-GEMM core of the packed U-Net kernels (sm_90a).
//
// Every packed site of the U-Net serving forward is a product
//   C[m, o] = sum_k A[m, k] * W[k, o]
// where m walks the output pixels of an NHWC tensor, o the 4O packed output
// channels, and A is never materialised: a Loader maps (pixel, k) to an
// address in the input activation (the conv taps, the skip crop, the slot
// scatter). The kernels differ only in their Loader and epilogue.
//
// Only H4's int8 modes (s8 x s8 -> s32) still run on this core. Every other
// kernel mode runs on the Hopper mainloop (sm90_igemm.cuh), which takes
// this file's quantize (quant16) and int8 epilogue (affine_relu, finish) as
// they are. K advances in 64-byte chunks of 64 s8 values; a Loader returns
// 16 s8 values of one pixel's row of A (QuantLoader: 16 bf16 quantized).
//
// Design, first version: one 256-thread block computes BM pixels x all BN
// (= 4O, 128 or 256) output channels. Each thread prefetches its next
// A/B chunk into registers (16-byte loads) while the warps run WMMA
// 16x16x16 products on the current chunk in shared memory. The accumulator
// tile is then staged in shared memory for the epilogue. No wgmma/TMA yet.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace segk {

using bf16 = __nv_bfloat16;
using s8 = signed char;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kChunkBytes = 64;

template <int BN>
struct TileCfg {
  static_assert(BN == 128 || BN == 256, "BN (= 4O) must be 128 or 256");
  static constexpr int VEC = 16;  // s8 elements per 16 bytes
  static constexpr int BK = kChunkBytes;
  static constexpr int BM = BN == 128 ? 128 : 64;
  static constexpr int WARPS_N = BN / 64;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int WARP_M = BM / WARPS_M;  // 32
  static constexpr int FM = WARP_M / 16;       // 2
  static constexpr int FN = 64 / 16;           // 4
  // 16-byte column blocks, A [BK/16][BM][16] and B [BN/16][BK][16], so
  // every WMMA fragment pointer is 32-byte aligned as load_matrix_sync
  // requires (a 16-wide s8 k step is only 16 bytes).
  static constexpr int LDA = 16;
  static constexpr int LDB = 16;
  static constexpr int LDC = BN + 4;  // 4-byte accumulator elements
  static constexpr int A_VECS = BM * BK / VEC / kThreads;
  static constexpr int B_VECS = BK * BN / VEC / kThreads;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BK * BN;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int SMEM =
      (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;

  __device__ static __forceinline__ int a_off(int r, int k) {
    return (k >> 4) * (BM * 16) + r * 16 + (k & 15);
  }
  __device__ static __forceinline__ int b_off(int k, int n) {
    return (n >> 4) * (BK * 16) + k * 16 + (n & 15);
  }
  // Row k and first column n of the v-th 16-byte vector of a B chunk: a
  // warp fills one column block, so its shared stores do not collide.
  __device__ static __forceinline__ void b_vec(int v, int& k, int& n) {
    k = v % BK;
    n = (v / BK) * 16;
  }
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

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

// The inline quantize of the int8 path (nn/pallas/conv.py _quant_rows):
// q = clip(round_half_even(f32(x) * inv), -127, 127), inv = f32(1 /
// act_scale) as the host computed it (a multiply, not a division: the two
// differ on some inputs). 16 bf16 values (two 16-byte loads) become the 16
// codes of one s8 column block. The clip goes first (the rounding is
// monotone and +-127 are integers), then the rounding: adding 1.5 * 2^23
// rounds the f32 sum to the nearest integer, ties to even, as
// __float2int_rn does, and leaves the code in its low byte (an add, where
// the conversion runs at a fraction of the add's rate).
__device__ __forceinline__ unsigned quant_byte(bf16 x, float inv) {
  const float t =
      fminf(fmaxf(__fmul_rn(__bfloat162float(x), inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
}

__device__ __forceinline__ unsigned quant4(const bf16* v, float inv) {
  const unsigned lo = __byte_perm(quant_byte(v[0], inv),
                                  quant_byte(v[1], inv), 0x0040);
  const unsigned hi = __byte_perm(quant_byte(v[2], inv),
                                  quant_byte(v[3], inv), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ uint4 quant16(uint4 lo, uint4 hi, float inv) {
  const bf16* a = reinterpret_cast<const bf16*>(&lo);
  const bf16* b = reinterpret_cast<const bf16*>(&hi);
  return make_uint4(quant4(a, inv), quant4(a + 4, inv), quant4(b, inv),
                    quant4(b + 4, inv));
}

// Quantize-on-load: wraps a Loader of a bf16 tensor (8 values per load) so
// that an s8 GEMM core reads s8 codes (16 per load). Every s8 kernel takes
// its Loader as a template parameter, so an inline-quantize mode is one
// more instantiation of the same core.
template <class L>
struct QuantLoader {
  L ld;
  float inv;
  using Row = typename L::Row;
  __device__ __forceinline__ Row row(long long m, bool ok) const {
    return ld.row(m, ok);
  }
  __device__ __forceinline__ uint4 load(const Row& r, int k) const {
    return quant16(ld.load(r, k), ld.load(r, k + 8), inv);
  }
};

template <int BN>
__device__ __forceinline__ void zero_acc(
    AccFrag (&acc)[TileCfg<BN>::FM][TileCfg<BN>::FN]) {
  using C = TileCfg<BN>;
#pragma unroll
  for (int a = 0; a < C::FM; ++a)
#pragma unroll
    for (int b = 0; b < C::FN; ++b)
      wmma::fill_fragment(acc[a][b], 0);
}

// acc += A[m0:m0+BM, kbeg:kend] @ W, where w points at W's row kbeg
// ([kend - kbeg, BN], row-major). Loader:
//   Row row(long long m, bool ok) const;  // per-pixel context
//   uint4 load(const Row&, int k) const;   // A[m, k..k+15], k % 16 == 0
// load() is only called for ok rows and k < kend (k is absolute, so one
// Loader can serve several K ranges). smem holds the A/B chunk buffers.
template <int BN, class Loader>
__device__ __forceinline__ void igemm_accumulate(
    const Loader& ld, const s8* __restrict__ w, int kbeg, int kend,
    long long m0, long long M, unsigned char* smem,
    AccFrag (&acc)[TileCfg<BN>::FM][TileCfg<BN>::FN]) {
  using C = TileCfg<BN>;
  s8* As = reinterpret_cast<s8*>(smem);
  s8* Bs = reinterpret_cast<s8*>(smem + C::A_BYTES);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / C::WARPS_N;
  const int wn = warp % C::WARPS_N;

  typename Loader::Row rows[C::A_VECS];
  int arow[C::A_VECS];
  const int akq = (tid & 3) * C::VEC;
#pragma unroll
  for (int i = 0; i < C::A_VECS; ++i) {
    arow[i] = (tid + i * kThreads) >> 2;
    const long long m = m0 + arow[i];
    rows[i] = ld.row(m, m < M);
  }

  uint4 ra[C::A_VECS];
  uint4 rb[C::B_VECS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < C::A_VECS; ++i) {
      const int k = k0 + akq;
      ra[i] = (rows[i].ok && k < kend) ? ld.load(rows[i], k) : zero4();
    }
#pragma unroll
    for (int i = 0; i < C::B_VECS; ++i) {
      int kr, n;
      C::b_vec(tid + i * kThreads, kr, n);
      const int k = k0 + kr;
      rb[i] = k < kend ? *reinterpret_cast<const uint4*>(
                             w + (long long)(k - kbeg) * BN + n)
                       : zero4();
    }
  };

  fetch(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += C::BK) {
    __syncthreads();  // the previous chunk's products are done
#pragma unroll
    for (int i = 0; i < C::A_VECS; ++i)
      *reinterpret_cast<uint4*>(As + C::a_off(arow[i], akq)) = ra[i];
#pragma unroll
    for (int i = 0; i < C::B_VECS; ++i) {
      int kr, n;
      C::b_vec(tid + i * kThreads, kr, n);
      *reinterpret_cast<uint4*>(Bs + C::b_off(kr, n)) = rb[i];
    }
    __syncthreads();
    if (k0 + C::BK < kend) fetch(k0 + C::BK);  // in flight during products
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, s8, wmma::row_major>
          fa[C::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, s8, wmma::row_major>
          fb[C::FN];
#pragma unroll
      for (int a = 0; a < C::FM; ++a)
        wmma::load_matrix_sync(fa[a],
                               As + C::a_off(wm * C::WARP_M + a * 16, kk),
                               C::LDA);
#pragma unroll
      for (int b = 0; b < C::FN; ++b)
        wmma::load_matrix_sync(fb[b], Bs + C::b_off(kk, wn * 64 + b * 16),
                               C::LDB);
#pragma unroll
      for (int a = 0; a < C::FM; ++a)
#pragma unroll
        for (int b = 0; b < C::FN; ++b)
          wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
  }
}

// Stage the accumulator tile in shared memory ([BM][LDC], over the chunk
// buffers) and return it.
template <int BN>
__device__ __forceinline__ int* stage_acc(
    AccFrag (&acc)[TileCfg<BN>::FM][TileCfg<BN>::FN], unsigned char* smem) {
  using C = TileCfg<BN>;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / C::WARPS_N;
  const int wn = warp % C::WARPS_N;
  __syncthreads();  // the chunk buffers become the stage
  int* Cs = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int a = 0; a < C::FM; ++a)
#pragma unroll
    for (int b = 0; b < C::FN; ++b)
      wmma::store_matrix_sync(
          Cs + (wm * C::WARP_M + a * 16) * C::LDC + wn * 64 + b * 16,
          acc[a][b], C::LDC, wmma::mem_row_major);
  __syncthreads();
  return Cs;
}

// C[m0:m0+BM, 0:BN] = A[:, 0:K] @ W, staged in shared memory.
template <int BN, class Loader>
__device__ __forceinline__ int* igemm_tile(const Loader& ld,
                                           const s8* __restrict__ w, int K,
                                           long long m0, long long M,
                                           unsigned char* smem) {
  AccFrag acc[TileCfg<BN>::FM][TileCfg<BN>::FN];
  zero_acc<BN>(acc);
  igemm_accumulate<BN>(ld, w, 0, K, m0, M, smem, acc);
  return stage_acc<BN>(acc, smem);
}

// Output rows of a tile: pixel index of stage row r, or -1 past the end.
struct Linear {
  long long m0, M;
  __device__ __forceinline__ long long operator()(int r) const {
    const long long m = m0 + r;
    return m < M ? m : -1;
  }
};

// Eight finished s8 values (integers in f32) to memory.
__device__ __forceinline__ unsigned pack4s8(const float* v) {
  return ((unsigned)(int)v[0] & 0xffu) | (((unsigned)(int)v[1] & 0xffu) << 8) |
         (((unsigned)(int)v[2] & 0xffu) << 16) |
         (((unsigned)(int)v[3] & 0xffu) << 24);
}

__device__ __forceinline__ void store8(s8* p, const float v[8]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack4s8(v), pack4s8(v + 4));
}

// The int8 path's epilogue, in f32 and in the reference's order of
// roundings: v = relu(acc * mul[o] + add[o]). mul/add fold the dequant and
// requant scales (chan_scale, 1/out_scale) into two vectors. A requantizing
// site (Out = s8) rounds half to even and clips to +-127; a float site
// (Out = bf16) rounds to bf16.
__device__ __forceinline__ float affine_relu(float acc, float mul, float add) {
  return fmaxf(__fadd_rn(__fmul_rn(acc, mul), add), 0.0f);
}

__device__ __forceinline__ float finish(float v, s8*) {
  return fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

__device__ __forceinline__ float finish(float v, bf16*) { return bf_round(v); }

// Apply the affine epilogue to the stage and store whole pixels to out
// [pixels, BN], requantized.
template <int BN, class Rows>
__device__ __forceinline__ void epilogue_affine(
    const int* Cs, const float* __restrict__ mul,
    const float* __restrict__ add, s8* __restrict__ out, const Rows& rows) {
  constexpr int LDC = BN + 4;
  for (int idx = threadIdx.x; idx < TileCfg<BN>::BM * (BN / 8);
       idx += kThreads) {
    const int r = idx / (BN / 8);
    const int c = (idx % (BN / 8)) * 8;
    const long long m = rows(r);
    if (m < 0) continue;
    const int* crow = Cs + r * LDC + c;
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t] = finish(affine_relu((float)crow[t], mul[c + t], add[c + t]),
                    (s8*)nullptr);
    store8(out + m * BN + c, v);
  }
}

// One block per BM output pixels with the core's shared memory (its
// dynamic limit set first); returns the CUDA error.
template <int BN, class Kernel, class... Args>
int launch(Kernel kernel, long long M, cudaStream_t stream, Args... args) {
  using C = TileCfg<BN>;
  if (M <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((M + C::BM - 1) / C::BM);
  kernel<<<grid, kThreads, C::SMEM, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace segk
