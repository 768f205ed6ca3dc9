// H1 packed_conv2x2: 2x2 VALID conv over a packed (space-to-depth) tensor,
// [N, hp, wp, 4C] -> [N, hp-1, wp-1, 4O].
//   bf16: bf16 x and w, + f32 bias, ReLU, bf16 store, on the Hopper
//         mainloop (packed_conv2x2_fwd.cuh: TMA halo boxes, wgmma,
//         warp-specialised, persistent);
//   s8:   s8 x and w (s32 accumulation), the int8 epilogue
//         relu(acc * mul + add), stored requantized to s8 or as bf16;
//         x is s8 codes, or bf16 quantized as it loads (act_inv, the
//         inline-quantize mode: igemm.cuh QuantLoader), on the WMMA core.
// Options: the fused 2x2/2 max pool (slot-max, [N, hp-1, wp-1, O], in the
// output's type) and the fused binary mask head (u8 [N, hp-1, wp-1, 4],
// on the stored bf16 value) with or without the store.
//
// Replaces the TPU kernels segmentation_tpu/nn/pallas/conv_flat.py
// conv2x2_padflat (:275) and conv2x2_pf2 (:1162), and of the 4-D route
// nn/pallas/conv.py conv2x2_flat (:372) and conv2x2_pool_flat (:467):
// float, int8-resident and inline-quantize modes. Their padded-flat and
// paired-column layouts exist for the TPU's (8, 128) tiles; this kernel
// reads plain NHWC and computes the same function on the real window.
//
// Bound on the H100: bytes. The packed GEMM (K = 4 taps x 4C, 4O columns)
// does 16/9 of the function's operations, about 128..256 MACs per input
// byte at the 512^2 sites, below the card's ~295 operations per byte of
// HBM once the output's bytes are counted (y is as large as x, and the
// pool adds a quarter). The bf16 design keeps the pool and the head in the
// epilogue, so that neither the pre-pool activation nor the last decoder
// activation takes a second pass over device memory, and stores y as rows
// of 128 contiguous bytes.
#include "igemm.cuh"
#include "packed_conv2x2_fwd.cuh"

namespace segk {

template <class T>
struct Conv2x2Loader {
  const T* x;
  int hp, wp, c4, ho, wo;
  struct Row {
    const T* p;
    bool ok;
  };
  __device__ __forceinline__ Row row(long long m, bool ok) const {
    Row r;
    r.ok = ok;
    r.p = x;
    if (ok) {
      const Pix q = decode(m, ho, wo);
      r.p = x + ((q.n * hp + q.i) * (long long)wp + q.j) * c4;
    }
    return r;
  }
  __device__ __forceinline__ uint4 load(const Row& r, int k) const {
    const int tap = k / c4;  // (u, v) = (tap >> 1, tap & 1)
    const int c = k - tap * c4;
    return *reinterpret_cast<const uint4*>(
        r.p + ((long long)(tap >> 1) * wp + (tap & 1)) * c4 + c);
  }
};

// Out = s8: requantizing site; Out = bf16: float site (the mask head's).
// Loader: Conv2x2Loader<s8>, or QuantLoader over Conv2x2Loader<bf16>.
template <int BN, class Out, class Loader>
__global__ void __launch_bounds__(kThreads)
    packed_conv2x2_s8_kernel(Loader ld, int K, const s8* __restrict__ w,
                             const float* __restrict__ mul,
                             const float* __restrict__ add,
                             Out* __restrict__ y, Out* __restrict__ pool,
                             const bf16* __restrict__ wd,
                             const float* __restrict__ bd,
                             uint8_t* __restrict__ mask, long long M) {
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * TileCfg<BN>::BM;
  int* Cs = igemm_tile<BN, s8>(ld, w, K, m0, M, seg_smem);
  const bool keep = pool != nullptr || mask != nullptr;
  const Linear rows{m0, M};
  epilogue_affine<BN, Out>(Cs, mul, add, y, keep, rows);
  if (keep) {
    __syncthreads();
    const float* Cf = reinterpret_cast<const float*>(Cs);
    if (pool != nullptr) epilogue_pool<BN>(Cf, pool, rows);
    if (mask != nullptr) epilogue_head<BN>(Cf, wd, bd, mask, rows);
  }
}

template <int BN, class Out, class Loader>
int run_conv2x2_s8(const Loader& ld, int K, const void* w, const void* mul,
                   const void* add, void* y, void* pool, const void* wd,
                   const void* bd, void* mask, long long M,
                   cudaStream_t stream) {
  return launch<BN, s8>(packed_conv2x2_s8_kernel<BN, Out, Loader>, M, stream,
                        0, ld, K, (const s8*)w, (const float*)mul,
                        (const float*)add, (Out*)y, (Out*)pool,
                        (const bf16*)wd, (const float*)bd, (uint8_t*)mask,
                        M);
}

template <class Loader>
int conv2x2_s8_modes(const Loader& ld, int K, int o4, int requant,
                     const void* w, const void* mul, const void* add,
                     void* y, void* pool, const void* wd, const void* bd,
                     void* mask, long long M, cudaStream_t s) {
  if (o4 == 128)
    return requant ? run_conv2x2_s8<128, s8>(ld, K, w, mul, add, y, pool, wd,
                                             bd, mask, M, s)
                   : run_conv2x2_s8<128, bf16>(ld, K, w, mul, add, y, pool,
                                               wd, bd, mask, M, s);
  if (o4 == 256)
    return requant ? run_conv2x2_s8<256, s8>(ld, K, w, mul, add, y, pool, wd,
                                             bd, mask, M, s)
                   : run_conv2x2_s8<256, bf16>(ld, K, w, mul, add, y, pool,
                                               wd, bd, mask, M, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace segk

// x [n, hp, wp, c4] bf16 (c4 % 8 == 0); w [4*c4, o4] bf16 (HWIO [2, 2, c4,
// o4]); bias [o4] f32; y [n, hp-1, wp-1, o4] bf16 or null; pool [.., o4/4]
// bf16 or null; wd [o4, 4] bf16, bd [4] f32 and mask [.., 4] u8, or all
// null; (th, tw) the output tile from tiles.tile_plan (th (tw + 1) GEMM
// rows). Every pointer 16-byte aligned.
extern "C" int seg_packed_conv2x2(const void* x, const void* w,
                                  const void* bias, void* y, void* pool,
                                  const void* wd, const void* bd, void* mask,
                                  int n, int hp, int wp, int c4, int o4,
                                  int th, int tw, void* stream) {
  using namespace segk;
  if (c4 < 8 || c4 % 8 || n < 1 || hp < 2 || wp < 2 || th < 1 || tw < 1 ||
      th > 255 || tw > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto& p) {
    const int e = fwd_maps(&p.xmap, &p.wmap, x, w, n, hp, wp, c4, o4, th, tw);
    if (e != 0) return e;
    p.bias = (const float*)bias;
    p.y = (bf16*)y;
    p.pool = (bf16*)pool;
    p.wd = (const bf16*)wd;
    p.bd = (const float*)bd;
    p.mask = (uint8_t*)mask;
    return fwd_launch(p, n, hp - 1, wp - 1, c4, th, tw, s);
  };
  const int epi = (pool != nullptr ? kPool : 0) | (mask != nullptr ? kHead : 0);
  if (o4 == 128) {
    switch (epi) {
      case 0: { FwdTiles<128, 0, 0> p{}; return run(p); }
      case kPool: { FwdTiles<128, 0, kPool> p{}; return run(p); }
      case kHead: { FwdTiles<128, 0, kHead> p{}; return run(p); }
      default: { FwdTiles<128, 0, kPool | kHead> p{}; return run(p); }
    }
  }
  if (o4 == 256) {
    switch (epi) {
      case 0: { FwdTiles<256, 0, 0> p{}; return run(p); }
      case kPool: { FwdTiles<256, 0, kPool> p{}; return run(p); }
      case kHead: { FwdTiles<256, 0, kHead> p{}; return run(p); }
      default: { FwdTiles<256, 0, kPool | kHead> p{}; return run(p); }
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: x [n, hp, wp, c4] (c4 % 16 == 0), s8 codes when act_inv
// is 0, else bf16 quantized on load at act_inv = f32(1 / act_scale);
// w [4*c4, o4] s8; mul, add [o4] f32; y and pool s8 (requant != 0) or
// bf16, or null; the head as above (needs requant == 0).
extern "C" int seg_packed_conv2x2_s8(const void* x, const void* w,
                                     const void* mul, const void* add,
                                     void* y, void* pool, const void* wd,
                                     const void* bd, void* mask, int n,
                                     int hp, int wp, int c4, int o4,
                                     int requant, float act_inv,
                                     void* stream) {
  using namespace segk;
  const long long M = (long long)n * (hp - 1) * (wp - 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (c4 % 16 || (requant && mask != nullptr))
    return (int)cudaErrorInvalidValue;
  if (act_inv > 0.0f) {
    const QuantLoader<Conv2x2Loader<bf16>> ld{
        {(const bf16*)x, hp, wp, c4, hp - 1, wp - 1}, act_inv};
    return conv2x2_s8_modes(ld, 4 * c4, o4, requant, w, mul, add, y, pool,
                            wd, bd, mask, M, s);
  }
  const Conv2x2Loader<s8> ld{(const s8*)x, hp, wp, c4, hp - 1, wp - 1};
  return conv2x2_s8_modes(ld, 4 * c4, o4, requant, w, mul, add, y, pool, wd,
                          bd, mask, M, s);
}

extern "C" const char* seg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
