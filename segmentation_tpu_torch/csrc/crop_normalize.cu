// H7 crop_normalize: the per-sample random crop, horizontal flip and
// normalization of a uint8 staging batch and of its masks, the device tail
// of the input pipeline, in one launch.
//
//   out[i, r, j, ch]  = f(img[i, y_i + r, x_i + (flip_i ? crop-1-j : j), ch])
//   mout[i, r, j, ch] =   msk[i, y_i + r, x_i + (flip_i ? crop-1-j : j), ch]
//
// img [N, H, W, C] u8 and msk [N, H, W, CM] u8 (or none); ys, xs, flips [N]
// int32 on the device (each offset is clamped into the image, as a dynamic
// slice clamps it); out [N, crop, crop, C] as u8 (a byte copy), or as f32 v
// * float(1/255), one IEEE f32 multiply (the Pallas kernel's map; XLA
// compiles the JAX package's device_augment x / 255 to the same product),
// or bf16 rounded to nearest even from that f32 value; mout [N, crop, crop,
// CM] u8, the masks' byte copy at the same offsets and flips.
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
// ~0.11 ms at 3.35 TB/s. Design: a block takes rstep output rows of one
// sample at a time (the blocks stride over the batch's row groups), image
// and mask together. Its threads first copy each window row's
// aligned 16-byte superset into shared memory with cp.async (a window row
// starts anywhere: x is any column, and a staging row of 600 x 3 bytes is
// only 8-byte aligned), then each thread makes 16 bytes of output (8 bf16,
// 4 f32 or 16 u8) from shared memory, the flip and the multiply there, and
// stores them at once; the output rows of a group are contiguous, so every
// store is a full 16 bytes where a row's bytes are a multiple of 16 (else
// each element is stored alone).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace segk {
namespace {

constexpr int kAugThreads = 256;
// output rows a block step (fewer where their stages would pass
// kStageBytes) and blocks at most (the grid strides): the bytes in flight,
// not the arithmetic, set the kernel's rate
constexpr int kRows = 16;
constexpr int kStageBytes = 64 * 1024;
constexpr int kAugBlocks = 16 * 132;

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

// the bytes a staging row of `len` bytes may take: its aligned superset
__host__ __device__ __forceinline__ int stage_stride(int len) {
  return (len + 15 + 15) / 16 * 16;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

// One tensor of a row group: the window rows' supersets into `stage`, the
// first byte of row k at stage + k * stride + lead[k].
struct Rows {
  const uint8_t* src;
  int c, stride;
};

__device__ __forceinline__ void stage_rows(const Rows& t, uint8_t* stage,
                                           int* lead, long long row0, int w,
                                           int x, int len, int rows) {
  // row k of the group starts at byte ((row0 + k) w + x) c of the tensor
  for (int k = threadIdx.x; k < rows; k += kAugThreads) {
    const uintptr_t a =
        (uintptr_t)(t.src + ((row0 + k) * w + x) * (long long)t.c);
    lead[k] = (int)(a & 15);
  }
  __syncthreads();
  const int chunks = (len + 15 + 15) / 16;
  for (int e = threadIdx.x; e < rows * chunks; e += kAugThreads) {
    const int k = e / chunks, q = e - k * chunks;
    const uint8_t* a = t.src + ((row0 + k) * w + x) * (long long)t.c;
    const uint8_t* a0 = a - lead[k];
    if (16 * q < lead[k] + len)
      cp_async16(stage + k * t.stride + 16 * q, a0 + 16 * q);
  }
}

// The outputs of `rows` rows of one tensor from its stage: out is the
// group's first output element; row length crop * c elements. A thread's
// V outputs read the stage at src, which steps by one byte (and, under a
// flip, back two pixels where a pixel ends) and moves to the next stage
// row where an output row ends.
template <class T>
__device__ __forceinline__ void emit_rows(T* __restrict__ out,
                                          const uint8_t* stage,
                                          const int* lead, int stride,
                                          int c, int crop, bool flip,
                                          int rows) {
  constexpr int V = 16 / sizeof(T);
  const int rowlen = crop * c;
  const int total = rows * rowlen;
  const bool vec = (rowlen * (int)sizeof(T)) % 16 == 0 &&
                   ((uintptr_t)out & 15) == 0;
  const int step = vec ? V : 1;
  for (int e0 = step * threadIdx.x; e0 < total; e0 += step * kAugThreads) {
    int rr = e0 / rowlen;
    const int col = e0 - rr * rowlen;
    int j = col / c, ch = col - j * c;
    const uint8_t* row = stage + rr * stride + lead[rr];
    int src = (flip ? crop - 1 - j : j) * c + ch;
    if (!vec) {
      out[e0] = Normalize<T>::apply(row[src]);
      continue;
    }
    union {
      uint4 u;
      T v[V];
    } pack;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      pack.v[k] = Normalize<T>::apply(row[src]);
      ++src;
      if (++ch == c) {
        ch = 0;
        if (flip) src -= 2 * c;
        if (++j == crop) {
          j = 0;
          ++rr;
          if (k + 1 < V) row = stage + rr * stride + lead[rr];
          src = flip ? (crop - 1) * c : 0;
        }
      }
    }
    *reinterpret_cast<uint4*>(out + e0) = pack.u;
  }
}

template <class T>
__global__ void __launch_bounds__(kAugThreads, 8)
    crop_normalize_kernel(const uint8_t* __restrict__ img,
                          const uint8_t* __restrict__ msk,
                          const int* __restrict__ ys,
                          const int* __restrict__ xs,
                          const int* __restrict__ flips, T* __restrict__ out,
                          uint8_t* __restrict__ mout, int n, int h, int w,
                          int c, int cm, int crop, int rstep) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int lead_i[kRows], lead_m[kRows];
  const Rows ti{img, c, stage_stride(crop * c)};
  const Rows tm{msk, cm, stage_stride(crop * cm)};
  uint8_t* const stage_i = smem;
  uint8_t* const stage_m = smem + rstep * ti.stride;
  const int groups = (crop + rstep - 1) / rstep;
  for (long long u = blockIdx.x; u < (long long)n * groups; u += gridDim.x) {
    const int i = (int)(u / groups);
    const int r0 = (int)(u - (long long)i * groups) * rstep;
    const int rows = min(rstep, crop - r0);
    const int y = min(max(ys[i], 0), h - crop);
    const int x = min(max(xs[i], 0), w - crop);
    const bool flip = flips[i] != 0;
    const long long row0 = (long long)i * h + y + r0;
    __syncthreads();  // the previous group's reads of the stages are done
    stage_rows(ti, stage_i, lead_i, row0, w, x, crop * c, rows);
    if (msk != nullptr)
      stage_rows(tm, stage_m, lead_m, row0, w, x, crop * cm, rows);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                     : "memory");
    __syncthreads();
    const long long o0 = ((long long)i * crop + r0) * crop;  // output pixel
    emit_rows<T>(out + o0 * c, stage_i, lead_i, ti.stride, c, crop, flip,
                 rows);
    if (msk != nullptr)
      emit_rows<uint8_t>(mout + o0 * cm, stage_m, lead_m, tm.stride, cm,
                         crop, flip, rows);
  }
}

template <class T>
int launch_crop_normalize(const void* img, const void* msk, const void* ys,
                          const void* xs, const void* flips, void* out,
                          void* mout, int n, int h, int w, int c, int cm,
                          int crop, cudaStream_t stream) {
  const int row_bytes =
      stage_stride(crop * c) + (msk != nullptr ? stage_stride(crop * cm) : 0);
  const int rstep = std::max(1, std::min(kRows, kStageBytes / row_bytes));
  const size_t smem = (size_t)rstep * row_bytes;
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = crop_normalize_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long units = (long long)n * ((crop + rstep - 1) / rstep);
  const int grid = (int)(units < kAugBlocks ? units : kAugBlocks);
  kernel<<<grid, kAugThreads, smem, stream>>>(
      (const uint8_t*)img, (const uint8_t*)msk, (const int*)ys,
      (const int*)xs, (const int*)flips, (T*)out, (uint8_t*)mout, n, h, w, c,
      cm, crop, rstep);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace segk

// img [n, h, w, c] u8; msk [n, h, w, cm] u8 or null; ys, xs, flips [n]
// int32; out [n, crop, crop, c] of out_kind 0 u8, 1 f32 or 2 bf16; mout
// [n, crop, crop, cm] u8 (null with msk).
extern "C" int seg_crop_normalize(const void* img, const void* msk,
                                  const void* ys, const void* xs,
                                  const void* flips, void* out, void* mout,
                                  int n, int h, int w, int c, int cm,
                                  int crop, int out_kind, void* stream) {
  using namespace segk;
  if (n < 1 || c < 1 || crop < 1 || crop > h || crop > w ||
      (msk != nullptr && (cm < 1 || mout == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_kind) {
    case 0:
      return launch_crop_normalize<uint8_t>(img, msk, ys, xs, flips, out,
                                            mout, n, h, w, c, cm, crop, s);
    case 1:
      return launch_crop_normalize<float>(img, msk, ys, xs, flips, out, mout,
                                          n, h, w, c, cm, crop, s);
    case 2:
      return launch_crop_normalize<__nv_bfloat16>(img, msk, ys, xs, flips,
                                                  out, mout, n, h, w, c, cm,
                                                  crop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
