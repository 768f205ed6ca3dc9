// The train step's glue around the packed-site kernels, one pass each:
//
//   relu_bias_grad: the ReLU mask and the bias gradient of a packed train
//   site. From the cotangent g and the saved output y [N, h, w, C4] bf16:
//     gm = g * (y > 0)                      (bf16, the bits of g or +0)
//     db = sum over N, h, w of gm           (f32, [C4])
//   The pool mode (the level sites conv1_2 and conv2_2, whose output feeds
//   both the skip and the 2x2 max pool) first adds the pool's gradient,
//   scattered to the winning slot: with gp and idx [N, h, w, C4 / 4],
//     dy[.., s C + k] = g[.., s C + k] + (idx[.., k] == s ? gp[.., k] : 0)
//   rounded to bf16 (the sum autograd would form; without g, the select
//   alone), then masked as above.
//   gm is written into a zero-margined buffer [N, R, W, C4] (R >= h,
//   W >= w), the margin written as zeros in the same launch: [N, h + 1,
//   w + 1] is the padded cotangent that the weight gradient's four
//   shifted GEMMs read in place (conv_bwd.conv2x2_wgrad) and H6 reads
//   through its row pitch. db is deterministic: each block sums its
//   pixels in a fixed order into a per-block f32 partial, and a second
//   small kernel sums the partials in block order (no float atomics).
//
//   crop_margin_zero: zeros of a dual site's skip gradient [N, hpa, wpa,
//   C4] outside its crop window, the unpacked rows [oh, oh + 2 hp) and
//   columns [ow, ow + 2 wp) (at an odd offset a packed pixel on the edge
//   lies half inside: its slots are tested one by one). H6's dual mode
//   writes the window itself (packed_conv2x2_dgrad.cu), so the skip's
//   gradient is written once and never zero-filled and summed whole.
//
// Replaces, in the port's train route, the JAX wrappers' _mask and _db
// (segmentation_tpu/nn/pallas/train.py:116-123, at every custom-VJP
// wrapper :155, :191, :226, :259, :300), pool4_select's backward
// (segmentation_tpu/models/unet_fast.py:526-571) and the un-crop of the
// skip's gradient with the sum that follows it (the VJP of
// packed_center_crop_flat, unet_fast.py:618-660); XLA fuses those there.
//
// Bound on the H100: bytes. Each element is read from g and y (and a
// quarter element from gp, an eighth from idx) and written once, about
// one f32 add per element: ~0.02 operations a byte. Design: a thread
// moves 8 channels with 16-byte loads and stores, the threads of a pixel
// are adjacent (every access coalesces), and the blocks stride over the
// pixels, 8 blocks of 256 threads an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace segk {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kGlueThreads = 256;
constexpr int kGlueBlocks = 8 * 132;  // fixed: the partials' count and order

// the zero-margined output [N, rows, cols, C4]
struct Pad {
  uint4* p;
  int rows, cols;
};

__device__ __forceinline__ uint32_t bf_bits(float f) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// The element e (0..7) of a 16-byte chunk of bf16.
__device__ __forceinline__ uint32_t elem(const uint4& v, int e) {
  const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return e & 1 ? w >> 16 : w & 0xffffu;
}

template <bool POOL, bool HAS_G>
__global__ void __launch_bounds__(kGlueThreads)
    relu_bias_grad_kernel(const uint4* __restrict__ g,
                          const uint4* __restrict__ y,
                          const uint4* __restrict__ gp,
                          const uint2* __restrict__ idx, Pad o,
                          float* __restrict__ partial, int n, int h, int w,
                          int c4) {
  extern __shared__ float red[];  // [pixels a block step, C4]
  const int ch = c4 / 8;           // 16-byte chunks a pixel
  const int step = kGlueThreads / ch;
  const int c = threadIdx.x % ch, lane = threadIdx.x / ch;
  const bool live = lane < step;
  const int cs = c4 / 4;               // channels a slot
  const int s = 8 * c / cs;            // this chunk's slot
  const int k8 = (8 * c - s * cs) / 8;  // its chunk within the slot
  float acc[8] = {};
  const long long total = (long long)n * h * w;
  for (long long pix = (long long)blockIdx.x * step + lane; live && pix < total;
       pix += (long long)gridDim.x * step) {
    const uint4 yv = __ldg(y + pix * ch + c);
    uint4 gv = HAS_G ? __ldg(g + pix * ch + c) : make_uint4(0, 0, 0, 0);
    uint4 pv = make_uint4(0, 0, 0, 0);
    uint2 iv = make_uint2(0, 0);
    if (POOL) {
      pv = __ldg(gp + pix * (cs / 8) + k8);
      iv = __ldg(idx + pix * (cs / 8) + k8);
    }
    uint32_t out[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      uint32_t r[2];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        uint32_t v = elem(gv, e + d);
        if (POOL) {
          const int id =
              (int)(int8_t)(((e + d) < 4 ? iv.x : iv.y) >> (8 * ((e + d) & 3)));
          const uint32_t sel = id == s ? elem(pv, e + d) : 0u;
          v = HAS_G ? bf_bits(__uint_as_float(v << 16) +
                              __uint_as_float(sel << 16))
                    : sel;
        }
        const bool on = __uint_as_float(elem(yv, e + d) << 16) > 0.0f;
        r[d] = on ? v : 0u;
        acc[e + d] += __uint_as_float(r[d] << 16);
      }
      out[e / 2] = r[0] | (r[1] << 16);
    }
    const uint4 ov = make_uint4(out[0], out[1], out[2], out[3]);
    const long long img = pix / ((long long)h * w);
    const int rem = (int)(pix - img * h * w);
    const int i = rem / w, j = rem - (rem / w) * w;
    o.p[((img * o.rows + i) * o.cols + j) * ch + c] = ov;
  }
  // the margin: (i, j) with i >= h or j >= w, zeros
  const int side = o.cols - w;  // margin columns of a real row
  const long long m = (long long)o.rows * o.cols - (long long)h * w;
  for (long long t = (long long)blockIdx.x * step + lane; live && t < n * m;
       t += (long long)gridDim.x * step) {
    const long long img = t / m;
    const long long r = t - img * m;
    int i, j;
    if (r < (long long)h * side) {
      i = (int)(r / side);
      j = w + (int)(r - (long long)i * side);
    } else {
      const long long r2 = r - (long long)h * side;
      i = h + (int)(r2 / o.cols);
      j = (int)(r2 - (long long)(i - h) * o.cols);
    }
    o.p[((img * o.rows + i) * o.cols + j) * ch + c] = make_uint4(0, 0, 0, 0);
  }
  // the block's partial sums, in a fixed order
  if (live)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[lane * c4 + 8 * c + e] = acc[e];
  __syncthreads();
  for (int k = threadIdx.x; k < c4; k += kGlueThreads) {
    float v = 0.0f;
    for (int l = 0; l < step; ++l) v += red[l * c4 + k];
    partial[(long long)blockIdx.x * c4 + k] = v;
  }
}

// db[k] = the partials' sum in block order
__global__ void bias_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ db, int blocks,
                                   int c4) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= c4) return;
  float v = 0.0f;
  for (int b = 0; b < blocks; ++b) v += partial[(long long)b * c4 + k];
  db[k] = v;
}

// One block a packed row (n, P) of buf [N, hpa, wpa, C4]: zeros at every
// slot outside the window. Where both of the row's slot rows lie inside,
// only the columns at the window's sides are visited.
__global__ void __launch_bounds__(128)
    crop_margin_zero_kernel(uint4* __restrict__ buf, int hpa, int wpa, int c4,
                            int hp, int wp, int oh, int ow) {
  const int row = blockIdx.x;  // n hpa + P
  const int P = row % hpa;
  const int ch = c4 / 8, cs = c4 / 4;
  const bool in0 = oh <= 2 * P && 2 * P < oh + 2 * hp;
  const bool in1 = oh <= 2 * P + 1 && 2 * P + 1 < oh + 2 * hp;
  // columns whose two slot columns both lie inside: [qlo, qhi]
  const int qlo = (ow + 1) / 2, qhi = (ow + 2 * wp) / 2 - 1;
  const bool bands = in0 && in1 && qlo <= qhi;
  const int nq = bands ? qlo + (wpa - 1 - qhi) : wpa;
  uint4* const out = buf + (long long)row * wpa * ch;
  for (int t = threadIdx.x; t < nq * ch; t += blockDim.x) {
    int q = t / ch;
    const int c = t - q * ch;
    if (bands && q >= qlo) q += qhi + 1 - qlo;
    const int s = 8 * c / cs, a = s >> 1, b = s & 1;
    const bool in_row = a ? in1 : in0;
    const int xx = 2 * q + b;
    if (!(in_row && ow <= xx && xx < ow + 2 * wp))
      out[(long long)q * ch + c] = make_uint4(0, 0, 0, 0);
  }
}

template <bool POOL, bool HAS_G>
int launch_relu_bias_grad(const void* g, const void* y, const void* gp,
                          const void* idx, Pad o, void* partial,
                          void* db, int n, int h, int w, int c4,
                          cudaStream_t stream) {
  const int step = kGlueThreads / (c4 / 8);
  relu_bias_grad_kernel<POOL, HAS_G>
      <<<kGlueBlocks, kGlueThreads, step * c4 * sizeof(float), stream>>>(
          (const uint4*)g, (const uint4*)y, (const uint4*)gp,
          (const uint2*)idx, o, (float*)partial, n, h, w, c4);
  bias_reduce_kernel<<<(c4 + 127) / 128, 128, 0, stream>>>(
      (const float*)partial, (float*)db, kGlueBlocks, c4);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace segk

// The number of per-block partials relu_bias_grad writes ([blocks, c4] f32
// scratch).
extern "C" int seg_relu_bias_grad_blocks() { return segk::kGlueBlocks; }

// g (or null in the pool mode: no cotangent of y), y [n, h, w, c4] bf16
// (c4 % 8 == 0, c4 <= 2048; the pool mode c4 % 32 == 0); gp [n,
// h, w, c4 / 4] bf16 and idx [.., c4 / 4] int8, or both null; out [n,
// rows, cols, c4] bf16 (rows >= h, cols >= w); partial [blocks, c4] f32
// scratch; db [c4] f32. Every pointer 16-byte aligned (idx 8-byte).
extern "C" int seg_relu_bias_grad(const void* g, const void* y,
                                  const void* gp, const void* idx,
                                  void* out, int rows, int cols,
                                  void* partial, void* db, int n, int h,
                                  int w, int c4, void* stream) {
  using namespace segk;
  const bool pool = gp != nullptr;
  if (n < 1 || h < 1 || w < 1 || c4 < 8 || c4 % 8 || c4 > 2048 ||
      (pool && (c4 % 32 || idx == nullptr)) || (!pool && g == nullptr) ||
      rows < h || cols < w)
    return (int)cudaErrorInvalidValue;
  const Pad o{(uint4*)out, rows, cols};
  cudaStream_t s = (cudaStream_t)stream;
  if (!pool)
    return launch_relu_bias_grad<false, true>(g, y, gp, idx, o, partial,
                                              db, n, h, w, c4, s);
  if (g == nullptr)
    return launch_relu_bias_grad<true, false>(g, y, gp, idx, o, partial,
                                              db, n, h, w, c4, s);
  return launch_relu_bias_grad<true, true>(g, y, gp, idx, o, partial,
                                           db, n, h, w, c4, s);
}

// buf [n, hpa, wpa, c4] bf16 (c4 % 32 == 0): zeros outside the crop window
// of [n, hp, wp] packed pixels at the unpacked offset (oh, ow), which the
// buffer covers.
extern "C" int seg_crop_margin_zero(void* buf, int n, int hpa, int wpa,
                                    int c4, int hp, int wp, int oh, int ow,
                                    void* stream) {
  using namespace segk;
  if (n < 1 || hp < 1 || wp < 1 || c4 < 32 || c4 % 32 || oh < 0 || ow < 0 ||
      oh + 2 * hp > 2 * hpa || ow + 2 * wp > 2 * wpa)
    return (int)cudaErrorInvalidValue;
  crop_margin_zero_kernel<<<(unsigned)(n * hpa), 128, 0,
                            (cudaStream_t)stream>>>((uint4*)buf, hpa, wpa,
                                                    c4, hp, wp, oh, ow);
  return (int)cudaGetLastError();
}
