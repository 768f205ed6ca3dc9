// The two small kernels of the Bayesian U-Net's MC-dropout forward
// (models/unet_fast.py UNetS2DInference.apply_mc):
//
//   mc_fanout: the bottleneck's dropout and the fan-out of its B images to
//   the decoder's B S: reads conv5_2's output x [B, H, W, C] bf16 once and
//   writes S masked copies, y[s B + n] = x[n] * keep(seed, 1, s, n, y, x,
//   c) (mc_mask.cuh), rounded to bf16 (exact at rate 0.5: a kept value is
//   doubled).
//
//   mc_moments: the moments over the S samples of the MC head's sigmoid
//   probabilities p [S B, hp, wp, 4 slots, 2 classes] f32 (packed,
//   csrc/packed_conv2x2_fwd.cuh kMcHead): per pixel and class the f32 mean
//   and the population variance (jnp.var's), and the argmax of the mean
//   (the first class on a tie), each written unpacked: mean, var [B, 2 hp,
//   2 wp, 2] f32, map [B, 2 hp, 2 wp] u8.
//
// The JAX package runs both as XLA ops (segmentation_tpu/models/
// unet_fast.py _mc_drop, training/bayesian.py mc_sample_fast and the mean,
// var and argmax of models/base.py _fast_mc); there is no Pallas kernel.
//
// Bound on the H100: bytes. The fan-out reads B H W C and writes S B H W C
// bf16 (a thread moves 8 channels with 16-byte loads and stores, and draws
// the mask bytes of its 8 channels by two hashes a sample); the moments
// read S B hp wp 8 f32 and write a fifth of that (a thread takes one slot
// of one packed pixel: S float2 loads, adjacent threads adjacent slots).
// The variance is taken about the first sample (shifted sums, one pass).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mc_mask.cuh"

namespace segk {
namespace {

constexpr int kMcThreads = 256;

__global__ void __launch_bounds__(kMcThreads)
    mc_fanout_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                     long long chunks, long long image_chunks, int b,
                     int samples, uint32_t seed_lo, uint32_t seed_hi,
                     int thr, float scale) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < chunks; i += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(i / image_chunks);
    // the chunk's first element within the image, (y W + x) C + c, c % 8 ==
    // 0: channel groups g and g + 1
    const uint32_t g = (uint32_t)(((i - n * image_chunks) * 8) >> 2);
    const uint4 v = x[i];
    const uint32_t in[4] = {v.x, v.y, v.z, v.w};
    float f[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(in[k] << 16);
      f[2 * k + 1] = __uint_as_float(in[k] & 0xffff0000u);
    }
    for (int s = 0; s < samples; ++s) {
      const uint32_t key = mc_key(seed_lo, seed_hi, kMcSiteBottleneck, s, n);
      const uint32_t bytes[2] = {mc_bytes(key, g), mc_bytes(key, g + 1)};
      uint32_t out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float a = f[2 * k] * mc_keep(bytes[k >> 1], 2 * k, thr, scale);
        const float c =
            f[2 * k + 1] * mc_keep(bytes[k >> 1], 2 * k + 1, thr, scale);
        out[k] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
                 ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(c))
                  << 16);
      }
      y[(long long)s * b * image_chunks + i] =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

__global__ void __launch_bounds__(kMcThreads)
    mc_moments_kernel(const float2* __restrict__ p, float2* __restrict__ mean,
                      float2* __restrict__ var, uint8_t* __restrict__ map,
                      long long items, long long sample_items, int hp, int wp,
                      int samples) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    // item i: slot i % 4 of packed pixel i / 4 = (n hp + pi) wp + pj
    const float2 k = __ldg(p + i);
    float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
    for (int s = 1; s < samples; ++s) {
      const float2 v = __ldg(p + s * sample_items + i);
      const float d0 = v.x - k.x, d1 = v.y - k.y;
      s0 += d0;
      s1 += d1;
      q0 += d0 * d0;
      q1 += d1 * d1;
    }
    const float inv = 1.0f / (float)samples;
    const float m0 = s0 * inv, m1 = s1 * inv;
    const float2 mv = make_float2(k.x + m0, k.y + m1);
    const float2 vv = make_float2(fmaxf(q0 * inv - m0 * m0, 0.0f),
                                  fmaxf(q1 * inv - m1 * m1, 0.0f));
    const int slot = (int)(i & 3);
    const long long pix = i >> 2;
    const long long per = (long long)hp * wp;
    const long long n = pix / per;
    const int r = (int)(pix - n * per);
    const int pi = r / wp, pj = r - pi * wp;
    const long long o = (n * 2 * hp + 2 * pi + (slot >> 1)) * (2LL * wp) +
                        2 * pj + (slot & 1);
    mean[o] = mv;
    var[o] = vv;
    map[o] = mv.y > mv.x ? 1 : 0;
  }
}

int blocks_for(long long work) {
  const long long b = (work + kMcThreads - 1) / kMcThreads;
  return (int)(b < 132 * 16 ? (b > 0 ? b : 1) : 132 * 16);
}

}  // namespace
}  // namespace segk

// x [b, h, w, c] bf16 (c % 8 == 0) -> y [samples b, h, w, c] bf16, image s b
// + n the dropout of x[n] by the stream (seed, bottleneck, s, n); thr = 256
// rate, scale = 256 / (256 - thr). Both pointers 16-byte aligned.
extern "C" int seg_mc_fanout(const void* x, void* y, int b, int h, int w,
                             int c, int samples, unsigned seed_lo,
                             unsigned seed_hi, int thr, float scale,
                             void* stream) {
  using namespace segk;
  if (b < 1 || h < 1 || w < 1 || c < 8 || c % 8 || samples < 1 || thr < 0 ||
      thr > 255)
    return (int)cudaErrorInvalidValue;
  const long long image_chunks = (long long)h * w * c / 8;
  const long long chunks = image_chunks * b;
  mc_fanout_kernel<<<blocks_for(chunks), kMcThreads, 0,
                     (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)y, chunks, image_chunks, b, samples, seed_lo,
      seed_hi, thr, scale);
  return (int)cudaGetLastError();
}

// p [samples b, hp, wp, 8] f32 (slot-major pairs of class probabilities)
// -> mean, var [b, 2 hp, 2 wp, 2] f32, map [b, 2 hp, 2 wp] u8. Pointers 8-byte
// aligned.
extern "C" int seg_mc_moments(const void* p, void* mean, void* var, void* map,
                              int b, int hp, int wp, int samples,
                              void* stream) {
  using namespace segk;
  if (b < 1 || hp < 1 || wp < 1 || samples < 1)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)b * hp * wp * 4;
  mc_moments_kernel<<<blocks_for(items), kMcThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float2*)p, (float2*)mean, (float2*)var, (uint8_t*)map, items,
      items, hp, wp, samples);
  return (int)cudaGetLastError();
}
