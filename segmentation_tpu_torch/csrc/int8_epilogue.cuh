// The int8 path's quantize and epilogue arithmetic, shared by the kernels
// on the Hopper mainloop (sm90_igemm.cuh): H1-H5's int8 modes
// (packed_conv2x2_fwd.cuh, strided_conv4x4s2.cu, rows_matmul.cu,
// entry_chain.cu) and H8 (std_conv3x3_s8.cu). Every function rounds as
// its reference does, named step by step (__fmul_rn, __fadd_rn,
// __fdiv_rn: no contraction into an FMA).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace segk {

using bf16 = __nv_bfloat16;
using s8 = signed char;

__device__ __forceinline__ float bf_round(float a) {
  return __bfloat162float(__float2bfloat16(a));
}

// A code in [-127, 127] (an integer in f32) to its byte: adding 1.5 * 2^23
// rounds the f32 sum to the nearest integer, ties to even, as
// __float2int_rn does, and leaves the code in its low byte (an add, where
// the conversion runs at a fraction of the add's rate).
__device__ __forceinline__ unsigned code_byte(float t) {
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
}

// The inline quantize of the Pallas kernels (nn/pallas/conv.py
// _quant_rows): q = clip(round_half_even(f32(x) * inv), -127, 127), inv =
// f32(1 / act_scale) as the host computed it (a multiply, not a division:
// the two differ on some inputs). The clip goes first (the rounding is
// monotone and +-127 are integers), then the rounding.
__device__ __forceinline__ unsigned quant_byte(bf16 x, float inv) {
  return code_byte(
      fminf(fmaxf(__fmul_rn(__bfloat162float(x), inv), -127.0f), 127.0f));
}

// The XLA-side quantize of the standard levels (models/unet_int8.py
// _quant_act): clip(round_half_even(f32(x) / scale), -127, 127), a true
// division by f32(scale). A zero dividend (half of a post-ReLU tensor)
// would take __fdiv_rn's slow path: its quotient, 0, is selected instead.
__device__ __forceinline__ unsigned quant_byte_div(bf16 x, float scale) {
  const float v = __bfloat162float(x);
  const float q = __fdiv_rn(v == 0.0f ? 1.0f : v, scale);
  return code_byte(fminf(fmaxf(v == 0.0f ? 0.0f : q, -127.0f), 127.0f));
}

// 16 bf16 values (two 16-byte loads) as the 16 codes of one 16-byte chunk,
// by the multiply (DIV false) or the division (DIV true).
template <bool DIV>
__device__ __forceinline__ unsigned quant4(const bf16* v, float s) {
  auto q = [&](bf16 x) {
    return DIV ? quant_byte_div(x, s) : quant_byte(x, s);
  };
  const unsigned lo = __byte_perm(q(v[0]), q(v[1]), 0x0040);
  const unsigned hi = __byte_perm(q(v[2]), q(v[3]), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

template <bool DIV = false>
__device__ __forceinline__ uint4 quant16(uint4 lo, uint4 hi, float s) {
  const bf16* a = reinterpret_cast<const bf16*>(&lo);
  const bf16* b = reinterpret_cast<const bf16*>(&hi);
  return make_uint4(quant4<DIV>(a, s), quant4<DIV>(a + 4, s),
                    quant4<DIV>(b, s), quant4<DIV>(b + 4, s));
}

// The int8 path's epilogue, in f32 and in the reference's order of
// roundings: v = relu(acc * mul[o] + add[o]). mul/add fold the dequant and
// requant scales (chan_scale, 1/out_scale) into two vectors. A requantizing
// site (s8 out) rounds half to even and clips to +-127; a float site (bf16
// out) rounds to bf16.
__device__ __forceinline__ float affine_relu(float acc, float mul, float add) {
  return fmaxf(__fadd_rn(__fmul_rn(acc, mul), add), 0.0f);
}

__device__ __forceinline__ float finish(float v, s8*) {
  return fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

__device__ __forceinline__ float finish(float v, bf16*) { return bf_round(v); }

}  // namespace segk
