// The im2col gather of the 4x4 stride-2 window of an unpacked NHWC image x
// [N, H, W, C] whose pixels TMA cannot stride (C = 3: 6-byte bf16 or
// 3-byte s8 pixels): H3's gathered modes (strided_conv4x4s2.cu) and H5's
// conv1_1 (entry_chain.cu). The producer warpgroup's warps
// (sm90_igemm.cuh gather, or H5's own producer) store the rows of A into a
// shared-memory slot where TMA's 128-byte swizzle would put them.
//
// Row r of a slot holds window (i0 + r / ew, j0 + r % ew) of the grid [ho,
// wo] = [(H - 2) / 2, (W - 2) / 2]: its K = 16C values k = kh 4C + kw C +
// ch read x[n, 2i + kh, 2j + kw, ch], the element k + kh (W C - 4C) past
// the window's first, (2i W + 2j) C of image n. A K block is the 128 bytes
// of a row: 64 bf16 values, or 64 s8 values in its first 64 bytes (an s8
// window of 16C <= 64 bytes; the problem's wgmma reads no further, its
// KSTEPS). Thread tid takes the 16 values k0 = 64 kb + 16 (tid % 4) .. of
// rows tid / 4, tid / 4 + nthreads / 4, ... (nthreads % 4 == 0) as 8
// pairs; a pair never straddles two kh (4C and k are even). A pair is one
// load where WIDE (W C even and x aligned to a pair), else two. Zero past
// 16C and for windows past the grid; rows past eh ew are left as they are.
#pragma once

#include <type_traits>

#include "sm90_igemm.cuh"

namespace segk {

template <class T, bool WIDE>
struct Im2col {
  // an element's bits
  using U = std::conditional_t<sizeof(T) == 2, unsigned short, unsigned char>;
  const T* x;
  int h, w, c;  // x [n, h, w, c]
  int ho, wo;   // the window grid

  // each pair's offset past the window's first element, or -1 past 16C
  __device__ void word_offsets(int k0, long long (&off)[8]) const {
    const int c4 = 4 * c;
    const long long step = (long long)w * c - c4;
    int kh = k0 / c4, next = (kh + 1) * c4;  // next: the next run's k
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + 2 * e;
      if (k >= next) {  // c4 >= 4: at most one run starts per pair
        ++kh;
        next += c4;
      }
      off[e] = k < 16 * c ? k + kh * step : -1;
    }
  }
  // a pair's bits, the lower element first
  __device__ uint32_t pair(const T* p) const {
    if constexpr (WIDE && sizeof(T) == 2) {
      return __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (WIDE) {
      return __ldg(reinterpret_cast<const unsigned short*>(p));
    } else {
      const U* u = reinterpret_cast<const U*>(p);
      return (uint32_t)__ldg(u) | ((uint32_t)__ldg(u + 1) << (8 * sizeof(T)));
    }
  }
  // Ask L2 for the input rows of the eh x ew windows at (n, i0, j0) (rows
  // 2 i0 .. 2 (i0 + eh) + 1, columns 2 j0 .. 2 (j0 + ew) + 1), one 128-byte
  // line a thread.
  __device__ void prefetch_rows(int n, int i0, int j0, int eh, int ew,
                                int tid, int nthreads) const {
    const int r0 = 2 * i0, r1 = min(2 * (i0 + eh) + 2, h);
    const long long e0 = 2LL * j0 * c;
    const long long e1 = min(2LL * (j0 + ew) + 2, (long long)w) * c;
    const char* row0 = reinterpret_cast<const char*>(
        x + ((long long)n * h + r0) * w * c + e0);
    const int lines = (int)((sizeof(T) * (e1 - e0) + 127) / 128);
    for (int q = tid; q < (r1 - r0) * lines; q += nthreads) {
      const int r = q / lines;
      const char* p =
          row0 + sizeof(T) * r * (long long)w * c + 128LL * (q - r * lines);
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
    }
  }
  // K block kb of the eh x ew windows at (n, i0, j0) into slot a; TASKS
  // rows a pass, their loads in flight together.
  template <int TASKS>
  __device__ void gather(uint8_t* a, int kb, int n, int i0, int j0, int eh,
                         int ew, int tid, int nthreads) const {
    const T* xn = x + (long long)n * h * w * c;
    const uint32_t base = sm90::smem_u32(a);
    const int g = tid & 3, rstep = nthreads >> 2, rows = eh * ew;
    long long off[8];
    word_offsets(64 * kb + 16 * g, off);
    int row = tid >> 2;
    int bi = row / ew, bj = row - bi * ew;  // the row's window in the tile
    while (row < rows) {
      uint32_t v[TASKS][8];
      int at[TASKS];
#pragma unroll
      for (int s = 0; s < TASKS; ++s) {
        at[s] = row;
        const int i = i0 + bi, j = j0 + bj;
        const bool live = row < rows && i < ho && j < wo;
        const T* p = xn + (2LL * i * w + 2 * j) * c;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[s][e] = live && off[e] >= 0 ? pair(p + off[e]) : 0u;
        row += rstep;
        for (bj += rstep; bj >= ew; bj -= ew) ++bi;
      }
#pragma unroll
      for (int s = 0; s < TASKS; ++s) {
        const int r = at[s];
        if (r >= rows) break;
        if constexpr (sizeof(T) == 2) {  // 16 bf16: chunks 2g, 2g + 1
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int chunk = 2 * g + hf;
            asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                             base + r * 128 + ((chunk ^ (r & 7)) << 4)),
                         "r"(v[s][4 * hf]), "r"(v[s][4 * hf + 1]),
                         "r"(v[s][4 * hf + 2]), "r"(v[s][4 * hf + 3])
                         : "memory");
          }
        } else {  // 16 s8: chunk g, two 2-byte pairs a word
          uint32_t wd[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wd[k] = v[s][2 * k] | (v[s][2 * k + 1] << 16);
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                           base + r * 128 + ((g ^ (r & 7)) << 4)),
                       "r"(wd[0]), "r"(wd[1]), "r"(wd[2]), "r"(wd[3])
                       : "memory");
        }
      }
    }
  }
};

}  // namespace segk
