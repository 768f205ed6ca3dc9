// H7 crop_normalize: the per-sample random crop, horizontal flip and
// normalization of a uint8 staging batch, the device tail of the input
// pipeline.
//
//   out[i, r, j, ch] = f(img[i, y_i + r, x_i + (flip_i ? crop-1-j : j), ch])
//
// img [N, H, W, C] u8; ys, xs, flips [N] int32 on the device (each offset is
// clamped into the image, as a dynamic slice clamps it); out [N, crop, crop,
// C] as u8 (masks: a byte copy), or as f32 v * float(1/255), one IEEE f32
// multiply (the Pallas kernel's map; XLA compiles the JAX package's
// device_augment x / 255 to the same product), bf16 rounded to nearest even
// from that f32 value.
//
// Replaces the TPU kernel segmentation_tpu/nn/pallas/augment.py
// pallas_crop_normalize (:65), which fused_augment (:102) calls for the
// image and the mask; the port's data/augment.py device_augment runs it
// too. Like the TPU kernel, it reads the crop windows only, never the whole
// staging image.
//
// Bound on the H100: bytes. Each element is one byte read, 1, 2 or 4 bytes
// written and at most one multiply: at the data path's shape (B = 128,
// 600^2 x 3 staging, crop 512) the bf16 image and the u8 mask move ~369 MB,
// ~0.11 ms at 3.35 TB/s. A block copies one output row of one sample (grid
// crop x N): neighbouring threads read neighbouring bytes of the window row
// (crop*C contiguous bytes, walked column-reversed under a flip) and write
// neighbouring outputs, so loads and stores coalesce. This first version
// moves one element per thread and iteration.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace segk {
namespace {

constexpr int kAugThreads = 256;

template <class T>
struct Normalize;

template <>
struct Normalize<uint8_t> {
  __device__ __forceinline__ static uint8_t apply(uint8_t v) { return v; }
};

template <>
struct Normalize<float> {
  __device__ __forceinline__ static float apply(uint8_t v) {
    return __fmul_rn((float)v, 1.0f / 255.0f);
  }
};

template <>
struct Normalize<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 apply(uint8_t v) {
    return __float2bfloat16_rn(Normalize<float>::apply(v));
  }
};

template <class T>
__global__ void __launch_bounds__(kAugThreads)
    crop_normalize_kernel(const uint8_t* __restrict__ img,
                          const int* __restrict__ ys,
                          const int* __restrict__ xs,
                          const int* __restrict__ flips, T* __restrict__ out,
                          int h, int w, int c, int crop) {
  const int r = blockIdx.x;  // output row
  const int i = blockIdx.y;  // sample
  const int y = min(max(ys[i], 0), h - crop);
  const int x = min(max(xs[i], 0), w - crop);
  const bool flip = flips[i] != 0;
  const uint8_t* src = img + (((long long)i * h + y + r) * w + x) * c;
  T* dst = out + ((long long)i * crop + r) * ((long long)crop * c);
  const int row = crop * c;
  for (int e = threadIdx.x; e < row; e += kAugThreads) {
    int s = e;
    if (flip) {
      const int j = e / c;
      s = (crop - 1 - j) * c + (e - j * c);
    }
    dst[e] = Normalize<T>::apply(__ldg(src + s));
  }
}

template <class T>
int launch_crop_normalize(const void* img, const void* ys, const void* xs,
                          const void* flips, void* out, int n, int h, int w,
                          int c, int crop, cudaStream_t stream) {
  const dim3 grid((unsigned)crop, (unsigned)n);
  crop_normalize_kernel<T><<<grid, kAugThreads, 0, stream>>>(
      (const uint8_t*)img, (const int*)ys, (const int*)xs, (const int*)flips,
      (T*)out, h, w, c, crop);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace segk

// img [n, h, w, c] u8; ys, xs, flips [n] int32; out [n, crop, crop, c] of
// out_kind 0 u8, 1 f32 or 2 bf16.
extern "C" int seg_crop_normalize(const void* img, const void* ys,
                                  const void* xs, const void* flips, void* out,
                                  int n, int h, int w, int c, int crop,
                                  int out_kind, void* stream) {
  using namespace segk;
  if (n < 1 || n > 65535 || c < 1 || crop < 1 || crop > h || crop > w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_kind) {
    case 0:
      return launch_crop_normalize<uint8_t>(img, ys, xs, flips, out, n, h, w,
                                            c, crop, s);
    case 1:
      return launch_crop_normalize<float>(img, ys, xs, flips, out, n, h, w, c,
                                          crop, s);
    case 2:
      return launch_crop_normalize<__nv_bfloat16>(img, ys, xs, flips, out, n,
                                                  h, w, c, crop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
