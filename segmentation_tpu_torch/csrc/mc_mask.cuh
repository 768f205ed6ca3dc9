// The MC-dropout mask stream of the Bayesian U-Net, on the device: the
// same bits as nn/mc_mask.py draws in plain PyTorch (and the benchmark's
// reference_mc.py in its own copy), so that a mask is never a tensor in
// device memory. Each bit is a pure function of (seed, site, sample s,
// tile n, y, x, c) in the standard, unpacked coordinates of the site's
// activation [H, W, C]:
//
//   mix(v):        v ^= v >> 16; v *= 0x21f0aaad; v ^= v >> 15;
//                  v *= 0x735a2d97; v ^= v >> 15            (mod 2^32)
//   key:           mix(mix(mix(mix(mix(seed_lo ^ 0x9e3779b9) ^ seed_hi)
//                      ^ site) ^ s) ^ n)
//   group g:       ((y W + x) C + c) >> 2                   (mod 2^32)
//   byte of c:     (mix(mix(g) ^ key) >> 8 (c & 3)) & 0xff
//   kept:          byte >= thr, thr = 256 rate (the rate a multiple of
//                  1/256), a kept value scaled by 256 / (256 - thr)
//
// so one hash gives four channels' bytes. The sites: 1 after conv5_2's
// ReLU (the bottleneck), 2 after conv9_2's ReLU (before the 1x1 head).
#pragma once

#include <cstdint>

namespace segk {

constexpr uint32_t kMcSiteBottleneck = 1, kMcSiteHead = 2;

__host__ __device__ __forceinline__ uint32_t mc_mix(uint32_t v) {
  v ^= v >> 16;
  v *= 0x21f0aaadu;
  v ^= v >> 15;
  v *= 0x735a2d97u;
  v ^= v >> 15;
  return v;
}

// the key of one (seed, site, sample, tile) stream
__host__ __device__ __forceinline__ uint32_t mc_key(uint32_t seed_lo,
                                                    uint32_t seed_hi,
                                                    uint32_t site, uint32_t s,
                                                    uint32_t n) {
  uint32_t k = mc_mix(seed_lo ^ 0x9e3779b9u);
  k = mc_mix(k ^ seed_hi);
  k = mc_mix(k ^ site);
  k = mc_mix(k ^ s);
  return mc_mix(k ^ n);
}

// the four bytes of channel group g (channels 4 (g mod C/4) .. + 3)
__host__ __device__ __forceinline__ uint32_t mc_bytes(uint32_t key,
                                                      uint32_t g) {
  return mc_mix(mc_mix(g) ^ key);
}

// channel c's multiplier: 0 where dropped, else the keep scale
__device__ __forceinline__ float mc_keep(uint32_t bytes, int c, int thr,
                                         float scale) {
  return ((bytes >> (8 * (c & 3))) & 0xffu) >= (uint32_t)thr ? scale : 0.0f;
}

}  // namespace segk
