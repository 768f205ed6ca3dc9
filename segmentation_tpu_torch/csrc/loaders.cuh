// Address rules shared by more than one kernel: the 4x4 stride-2 window of
// an unpacked NHWC input (H3 strided_conv4x4s2 and H5 entry_chain's first
// conv). A Loader hands igemm.cuh 16 bytes of one output pixel's row of A.
#pragma once

#include <type_traits>

#include "igemm.cuh"

namespace segk {

// Output pixel (n, i, j) of the packed grid reads the 4x4 window at
// unpacked (2i, 2j); k = ((u * 4 + v) * c + ch) for tap (u, v). VEC reads
// 16 bytes of one tap (c a multiple of 16 bytes); otherwise the 16 bytes
// (8 bf16 or 16 s8 values) are gathered one by one (c = 3: a pixel's
// channels are not 16-byte aligned).
template <class T, bool VEC>
struct Strided4x4Loader {
  const T* x;
  int h, w, c, ho, wo;
  struct Row {
    const T* p;
    bool ok;
  };
  __device__ __forceinline__ Row at(long long n, int i, int j, bool ok) const {
    Row r;
    r.ok = ok;
    r.p = ok ? x + ((n * h + 2 * i) * (long long)w + 2 * j) * c : x;
    return r;
  }
  __device__ __forceinline__ Row row(long long m, bool ok) const {
    if (!ok) return at(0, 0, 0, false);
    const Pix q = decode(m, ho, wo);
    return at(q.n, q.i, q.j, true);
  }
  __device__ __forceinline__ uint4 load(const Row& r, int k) const {
    if (VEC) {
      const int tap = k / c;  // (u, v) = (tap >> 2, tap & 3)
      const int cc = k - tap * c;
      return *reinterpret_cast<const uint4*>(
          r.p + ((long long)(tap >> 2) * w + (tap & 3)) * c + cc);
    }
    // the elements' raw bits (bf16 or s8)
    using U = typename std::conditional<sizeof(T) == 2, unsigned short,
                                        unsigned char>::type;
    constexpr int N = 16 / (int)sizeof(T);
    const U* xs = reinterpret_cast<const U*>(r.p);
    union {
      uint4 u;
      U e[N];
    } g;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const int kk = k + t;  // K = 16c is a multiple of N: kk < K
      const int tap = kk / c;
      const int cc = kk - tap * c;
      g.e[t] = xs[((long long)(tap >> 2) * w + (tap & 3)) * c + cc];
    }
    return g.u;
  }
};

}  // namespace segk
