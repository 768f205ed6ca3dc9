// H1 packed_conv2x2: 2x2 VALID conv over a packed (space-to-depth) tensor,
// [N, hp, wp, 4C] -> [N, hp-1, wp-1, 4O], on the Hopper mainloop
// (packed_conv2x2_fwd.cuh: TMA halo boxes, wgmma, warp-specialised,
// persistent):
//   bf16: bf16 x and w, + f32 bias, ReLU, bf16 store;
//   s8:   s8 x and the K-major copy of w (s8 wgmma, s32 accumulation), the
//         int8 epilogue relu(acc * mul + add), stored requantized to s8 or
//         as bf16; x is s8 codes (TMA boxes of 128 channels), or bf16
//         gathered by the producer warpgroup's idle warps and quantized as
//         they store it (act_inv, the inline-quantize mode: the Pallas
//         multiply rule, once per K block).
// 4O = 128, 256 and, bf16 without the head, 512 (n_kernels 64's level 2:
// two column tiles a pixel tile, packed_conv2x2_fwd.cuh).
// The MC head (kMcHead): the decoder-end dropout, the two-class head and
// its sigmoids in the epilogue, f32 probabilities out and no y.
// Options: the fused 2x2/2 max pool (slot-max, [N, hp-1, wp-1, O], in the
// output's type), with the pool's int8 index for training (bf16: the first
// slot that attains the max, pool4_select's rule, so that its backward
// needs no pass over y), and the fused binary mask head (u8 [N, hp-1,
// wp-1, 4], on the stored bf16 value) with or without the store.
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
#include "packed_conv2x2_fwd.cuh"

namespace segk {

// The int8 problem's operands, as the C entry takes them.
struct Conv2x2S8 {
  const void *x, *wk, *mul, *add;
  void *y, *pool;
  const void *wd, *bd;
  void* mask;
  int n, hp, wp, c4, th, tw;
  float act_inv;
  cudaStream_t stream;
};

// One int8 mode: EPI (kPool, kHead, kRequant; kInt8 added here); GATHER:
// x is bf16, gathered and quantized inline.
template <int O4, int EPI, bool GATHER>
int conv2x2_s8(const Conv2x2S8& a) {
  FwdTiles<O4, false, EPI | kInt8, GATHER> p{};
  const int e = fwd_maps_s8(&p.xmap, &p.wmap, GATHER ? nullptr : a.x, a.wk,
                            a.n, a.hp, a.wp, a.c4, O4, a.th, a.tw);
  if (e != 0) return e;
  using OutT = typename FwdTiles<O4, false, EPI | kInt8, GATHER>::OutT;
  p.mul = (const float*)a.mul;
  p.add = (const float*)a.add;
  p.y = (OutT*)a.y;
  p.pool = (OutT*)a.pool;
  p.wd = (const bf16*)a.wd;
  p.bd = (const float*)a.bd;
  p.mask = (uint8_t*)a.mask;
  p.xs = (const uint8_t*)a.x;
  p.gb = GATHER;
  p.inv_b = a.act_inv;
  p.hx = a.hp;
  p.wx = a.wp;
  return fwd_launch(p, a.n, a.hp - 1, a.wp - 1, a.c4, a.th, a.tw, a.stream);
}

template <int O4, int EPI>
int conv2x2_s8_src(const Conv2x2S8& a) {
  return a.act_inv > 0.0f ? conv2x2_s8<O4, EPI, true>(a)
                          : conv2x2_s8<O4, EPI, false>(a);
}

template <int O4>
int conv2x2_s8_modes(const Conv2x2S8& a, bool requant) {
  const int epi =
      (a.pool != nullptr ? kPool : 0) | (a.mask != nullptr ? kHead : 0);
  if (requant)
    return epi == kPool ? conv2x2_s8_src<O4, kRequant | kPool>(a)
                        : conv2x2_s8_src<O4, kRequant>(a);
  switch (epi) {
    case 0: return conv2x2_s8_src<O4, 0>(a);
    case kPool: return conv2x2_s8_src<O4, kPool>(a);
    case kHead: return conv2x2_s8_src<O4, kHead>(a);
    default: return conv2x2_s8_src<O4, kPool | kHead>(a);
  }
}

}  // namespace segk

// x [n, hp, wp, c4] bf16 (c4 % 8 == 0); w [4*c4, o4] bf16 (HWIO [2, 2, c4,
// o4]); bias [o4] f32; y [n, hp-1, wp-1, o4] bf16 or null; pool [.., o4/4]
// bf16 or null; idx [.., o4/4] int8 (with pool and without the head) or
// null; wd [o4, 4] bf16, bd [4] f32 and mask [.., 4] u8, or all null; (th,
// tw) the output tile from tiles.tile_plan (th (tw + 1) GEMM rows); o4 =
// 128 or 256, or 512 without the head. Every pointer 16-byte aligned.
extern "C" int seg_packed_conv2x2(const void* x, const void* w,
                                  const void* bias, void* y, void* pool,
                                  void* idx, const void* wd, const void* bd,
                                  void* mask, int n, int hp, int wp, int c4,
                                  int o4, int th, int tw, void* stream) {
  using namespace segk;
  if (c4 < 8 || c4 % 8 || n < 1 || hp < 2 || wp < 2 || th < 1 || tw < 1 ||
      th > 255 || tw > 255 ||
      (idx != nullptr && (pool == nullptr || mask != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto& p) {
    const int e = fwd_maps(&p.xmap, &p.wmap, x, w, n, hp, wp, c4, o4, th, tw);
    if (e != 0) return e;
    p.bias = (const float*)bias;
    p.y = (bf16*)y;
    p.pool = (bf16*)pool;
    p.pool_idx = (int8_t*)idx;
    p.wd = (const bf16*)wd;
    p.bd = (const float*)bd;
    p.mask = (uint8_t*)mask;
    return fwd_launch(p, n, hp - 1, wp - 1, c4, th, tw, s);
  };
  const int epi = (pool != nullptr ? kPool : 0) | (mask != nullptr ? kHead : 0);
  if (idx != nullptr) {
    if (o4 == 128) {
      FwdTiles<128, false, kPool | kPoolIdx> p{};
      return run(p);
    }
    if (o4 == 256) {
      FwdTiles<256, false, kPool | kPoolIdx> p{};
      return run(p);
    }
    if (o4 == 512) {
      FwdTiles<512, false, kPool | kPoolIdx> p{};
      return run(p);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (o4 == 128) {
    switch (epi) {
      case 0: { FwdTiles<128, false, 0> p{}; return run(p); }
      case kPool: { FwdTiles<128, false, kPool> p{}; return run(p); }
      case kHead: { FwdTiles<128, false, kHead> p{}; return run(p); }
      default: { FwdTiles<128, false, kPool | kHead> p{}; return run(p); }
    }
  }
  if (o4 == 256) {
    switch (epi) {
      case 0: { FwdTiles<256, false, 0> p{}; return run(p); }
      case kPool: { FwdTiles<256, false, kPool> p{}; return run(p); }
      case kHead: { FwdTiles<256, false, kHead> p{}; return run(p); }
      default: { FwdTiles<256, false, kPool | kHead> p{}; return run(p); }
    }
  }
  if (o4 == 512) {
    switch (epi) {
      case 0: { FwdTiles<512, false, 0> p{}; return run(p); }
      case kPool: { FwdTiles<512, false, kPool> p{}; return run(p); }
      default: return (int)cudaErrorInvalidValue;  // no head at 4O = 512
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The MC head (the MC-dropout forward's conv9_2 + dropout + head +
// sigmoid): x, w, bias and (th, tw) as above, o4 = 128 or 256; wh [o4 / 4,
// 2] bf16 and bh [2] f32 the two-class 1x1 head; probs [n, hp-1, wp-1, 8]
// f32, slot-major (class 0, class 1) sigmoid pairs; the decoder's image i
// is sample i / tiles_b of tile i % tiles_b, dropped by the stream (seed,
// head site) at threshold thr with keep scale scale (mc_mask.cuh). Every
// pointer 16-byte aligned.
extern "C" int seg_packed_conv2x2_mc_head(
    const void* x, const void* w, const void* bias, const void* wh,
    const void* bh, void* probs, int n, int hp, int wp, int c4, int o4,
    int th, int tw, unsigned seed_lo, unsigned seed_hi, int tiles_b, int thr,
    float scale, void* stream) {
  using namespace segk;
  if (c4 < 8 || c4 % 8 || n < 1 || hp < 2 || wp < 2 || th < 1 || tw < 1 ||
      th > 255 || tw > 255 || tiles_b < 1 || n % tiles_b || thr < 0 ||
      thr > 255)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto& p) {
    const int e = fwd_maps(&p.xmap, &p.wmap, x, w, n, hp, wp, c4, o4, th, tw);
    if (e != 0) return e;
    p.bias = (const float*)bias;
    p.wh = (const bf16*)wh;
    p.bh = (const float*)bh;
    p.probs = (float*)probs;
    p.seed_lo = seed_lo;
    p.seed_hi = seed_hi;
    p.mc_b = tiles_b;
    p.mc_thr = thr;
    p.mc_scale = scale;
    return fwd_launch(p, n, hp - 1, wp - 1, c4, th, tw, (cudaStream_t)stream);
  };
  if (o4 == 128) {
    FwdTiles<128, false, kMcHead> p{};
    return run(p);
  }
  if (o4 == 256) {
    FwdTiles<256, false, kMcHead> p{};
    return run(p);
  }
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: x [n, hp, wp, c4] (c4 % 16 == 0), s8 codes when act_inv
// is 0, else bf16 quantized as it is gathered, at act_inv = f32(1 /
// act_scale); wk [o4, 4*c4] s8, the K-major copy of the weight [2, 2, c4,
// o4] (conv_int8.k_major); mul, add [o4] f32; y and pool s8 (requant != 0)
// or bf16, or null; the head as above (needs requant == 0); (th, tw) the
// output tile as above. Every pointer 16-byte aligned.
extern "C" int seg_packed_conv2x2_s8(const void* x, const void* wk,
                                     const void* mul, const void* add,
                                     void* y, void* pool, const void* wd,
                                     const void* bd, void* mask, int n,
                                     int hp, int wp, int c4, int o4,
                                     int requant, float act_inv, int th,
                                     int tw, void* stream) {
  using namespace segk;
  if (c4 < 16 || c4 % 16 || n < 1 || hp < 2 || wp < 2 || th < 1 || tw < 1 ||
      th > 255 || tw > 255 || (requant && mask != nullptr))
    return (int)cudaErrorInvalidValue;
  const Conv2x2S8 a{x,  wk, mul, add, y,  pool,    wd,
                    bd, mask, n, hp, wp, c4, th, tw, act_inv,
                    (cudaStream_t)stream};
  if (o4 == 128) return conv2x2_s8_modes<128>(a, requant != 0);
  if (o4 == 256) return conv2x2_s8_modes<256>(a, requant != 0);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* seg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
