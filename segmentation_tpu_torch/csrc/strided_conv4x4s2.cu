// H3 strided_conv4x4s2: a 3x3 VALID conv whose output lands packed, as a
// 4x4 stride-2 VALID conv from an unpacked [N, H, W, C] input to packed
// [N, (H-2)/2, (W-2)/2, 4O] with the s2d-folded weights w4 [4, 4, C, 4O]
// (models/unet_fast.py pack_conv3_weight_s2).
//   bf16:    x, w4 bf16, + f32 bias, ReLU, bf16 store, on the Hopper
//            mainloop (sm90_igemm.cuh: TMA or producer-gathered A, wgmma,
//            warp-specialised, persistent; the output side of
//            packed_conv2x2_fwd.cuh);
//   s8:      x, w4 s8 (s32 accumulation), the int8 epilogue
//            relu(acc * mul + add) requantized to s8 (igemm.cuh); x is s8
//            codes, or bf16 quantized as it loads (act_inv: the inline-
//            quantize mode). C = 3 s8 codes (the image entry's s8-input
//            mode) take the gather loader;
//   requant: x, w4 bf16 (f32 accumulation, the bf16 product) with the
//            int8 epilogue, s8 out: the image entry's requant-only mode,
//            the same product and epilogue as H5's conv1_1, so the same
//            codes (igemm.cuh).
//
// Replaces the TPU kernels segmentation_tpu/nn/pallas/conv_flat.py
// conv4x4s2_padflat (:667, conv2_1, C = 32 from the paired pooled input:
// bf16, int8-resident and inline-quantize modes), conv3entry_pf2 (:1738,
// the fused C = 3 entry: its bf16, requant-only and s8-input modes) and
// nn/pallas/conv.py conv4x4s2_flat (:844). The pairing and the pair-major
// entry transform are TPU layout devices; here the kernel reads NHWC.
//
// The bf16 design. Kernel tap (kh, kw) = (2u + a, 2v + b): the conv is H1's
// packed 2x2 conv (taps (u, v)) over the space-to-depth view of x, which
// is no copy: x [N, H, W, C] is the 5-D [N, H/2, 2 (a), W/2, 2C (b, c)].
//  - Boxed (every byte stride of that view a multiple of 16, TMA's rule:
//    C % 4 == 0 and W C % 8 == 0, x 16-byte aligned; conv2_1): one K block
//    per row parity a and 64 of the 2C channels, its A the 5-D box [1, th
//    + 1, 1, tw + 1, 64] at (n, i0, a, j0, k0), read by the four taps as
//    row shifts exactly as FwdTiles reads its halo box (HALO 1). The map
//    has explicit strides, so odd H or W need no copy (the VALID conv never
//    reads the last odd row or column). B is w4 viewed as [16C, 4O], read
//    MN-major: the rows of (tap (u, v), block (a, k0)) are the contiguous
//    rows ((2u + a) 4 + 2v) C + k0 .. (kw = 2v, 2v + 1 times C channels).
//    A partial block (2C % 64 != 0) meets TMA's zero fill: its A channels
//    past 2C are zero, whatever B rows (the next kw pair, or zeros past
//    16C) lie against them.
//  - Gathered (any other C: the C = 3 entry, whose 12-byte pixel pairs TMA
//    cannot stride): one tap (HALO 0), A the im2col rows of the output
//    pixels, K = 16C in ceil(16C / 64) blocks (the entry: 48 values and 16
//    zeros, one block, 4 wgmma k16 steps; the four-tap form would pad each
//    of its 6-channel blocks to 64, 8 times the work), gathered by the
//    producer warpgroup's three idle warps (sm90::gather) a bf16 pair at a
//    time (one 4-byte load where W C is even), each thread's pairs' offsets
//    in the window fixed for a K block, 32 loads of a thread in flight: the
//    warpgroup takes 96 registers a thread for it, the consumers keep 200;
//    the threads ask L2 for the next tile's input rows. B the rows 64 kb
//    of the same view of w4.
//  - Output: FwdOut's. 4O = 128 (conv1_1): ping-pong consumers and TMA
//    stores from a staging tile; 4O = 256 (conv2_1): tiles split between
//    the consumers, register stores.
//
// Bound on the H100: bytes. The entry writes 128 channels per packed pixel
// against 48 bytes read (133 MB of y against 12.6 MB of x at B = 8), so
// its store path is what matters; conv2_1 (K = 512) reads the whole w4
// (256 KiB) from L2 once per 128-row tile.
#include "loaders.cuh"
#include "packed_conv2x2_fwd.cuh"

namespace segk {

// How the bf16 problem reads x: kBox, 5-D TMA boxes; else gathered as
// im2col rows, a bf16 pair a 4-byte load (kWords: W C even, x 4-byte
// aligned) or two 2-byte loads (kHalves).
constexpr int kBox = 0, kWords = 1, kHalves = 2;

// The bf16 problem on the Hopper mainloop (see the top of this file).
template <int O4, int MODE>
struct StridedTiles : FwdOut<O4, 0, MODE == kBox ? 1 : 0> {
  static constexpr bool BOX = MODE == kBox;
  using Out = FwdOut<O4, 0, BOX ? 1 : 0>;
  using Out::BM;
  using Out::NB;
  using Out::ho;
  using Out::origin;
  using Out::th;
  using Out::tw;
  using Out::wo;
  static constexpr int TAPS = BOX ? 4 : 1;
  // boxed: the halo box and the largest tap shift, as FwdTiles
  static constexpr int A_ROWS = BOX ? (2 * BM + 1 + 7) / 8 * 8 : BM;
  static constexpr int B_STAGES = Out::b_stages(A_ROWS);
  static constexpr bool B_MN = true, GATHER = !BOX;
  // the gather keeps GATHER_TASKS rows x 8 pairs of each thread in flight
  // (kHalves: two loads a pair, two rows in 96 registers)
  static constexpr int GATHER_TASKS = MODE == kHalves ? 2 : 4;
  static constexpr int PRODUCER_REGS = BOX ? sm90::kProducerRegs : 96;

  CUtensorMap xmap, wmap;  // the 5-D view of x (boxed); w4 as [16C, 4O]
  const bf16* x;           // gathered
  int h, w, c;             // x [n, h, w, c]
  int kps;                 // K blocks: per row parity (boxed), or all

  __device__ int k_blocks() const { return BOX ? 2 * kps : kps; }
  __device__ uint32_t a_tx(int) const {
    return BOX ? (uint32_t)((th + 1) * (tw + 1)) * 128u : 0u;
  }
  __device__ int a_row(int tap) const {  // (u, v) = (tap >> 1, tap & 1)
    return BOX ? (tap >> 1) * (tw + 1) + (tap & 1) : 0;
  }
  __device__ void prefetch() const {
    if (BOX) sm90::prefetch_map(&xmap);
    sm90::prefetch_map(&wmap);
  }
  __device__ void load_a(int t, int kb, uint8_t* a, uint64_t* bar) const {
    if constexpr (BOX) {
      int n, i0, j0;
      origin(t, n, i0, j0);
      const int par = kb / kps;  // row parity a
      sm90::tma_load_5d(a, &xmap, bar, 64 * (kb - par * kps), j0, par, i0,
                        n);
    }
  }
  // The gathered A slot of K block kb holds the im2col rows of the tile's
  // pixels: row m = a tw + b is pixel (i0 + a, j0 + b), k = kh 4C + kw C +
  // ch reads x[n, 2i + kh, 2j + kw, ch], the element k + kh (W C - 4C)
  // past the window's first, (2i W + 2j) C of image n. Thread tid takes
  // the 16 values k0 = 64 kb + 16 (tid % 4) .. of rows tid / 4, tid / 4 +
  // nthreads / 4, ... (nthreads % 4 == 0), as 8 bf16 pairs; a pair never
  // straddles two kh (4C and k are even). word_offsets: each pair's
  // offset past the window's first element, or -1 past 16C.
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
  __device__ uint32_t pair(const bf16* p) const {
    if constexpr (MODE == kWords) {
      return __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
      return (uint32_t)__ldg(u) | ((uint32_t)__ldg(u + 1) << 16);
    }
  }
  // Ask L2 for the input rows of tile t (its windows' rows 2 i0 .. 2 (i0 +
  // th) + 1, columns 2 j0 .. 2 (j0 + tw) + 1), one 128-byte line a thread.
  __device__ void prefetch_rows(int t, int tid, int nthreads) const {
    if (t >= this->n_tiles) return;
    int n, i0, j0;
    origin(t, n, i0, j0);
    const int r0 = 2 * i0, r1 = min(2 * (i0 + th) + 2, h);
    const long long e0 = 2LL * j0 * c;
    const long long e1 = min(2LL * (j0 + tw) + 2, (long long)w) * c;
    const char* row0 = reinterpret_cast<const char*>(
        x + ((long long)n * h + r0) * w * c + e0);
    const int lines = (int)((2 * (e1 - e0) + 127) / 128);
    for (int q = tid; q < (r1 - r0) * lines; q += nthreads) {
      const int r = q / lines;
      const char* p =
          row0 + 2LL * r * w * c + 128LL * (q - r * lines);
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
    }
  }
  // The gathered A slot of K block kb (see word_offsets), stored where
  // TMA's 128-byte swizzle would put it; GATHER_TASKS rows a pass, their
  // loads in flight together; zero for pixels past the output. Rows past
  // th tw are junk rows, left as they are. With the first block the
  // threads ask L2 for the block's next tile's input rows.
  __device__ void gather_a(int t, int kb, uint8_t* a, int tid,
                           int nthreads) const {
    if constexpr (!BOX) {
      if (kb == 0) prefetch_rows(t + gridDim.x, tid, nthreads);
      int n, i0, j0;
      origin(t, n, i0, j0);
      const bf16* xn = x + (long long)n * h * w * c;
      const uint32_t base = sm90::smem_u32(a);
      const int g = tid & 3, rstep = nthreads >> 2, rows = th * tw;
      long long off[8];
      word_offsets(64 * kb + 16 * g, off);
      int row = tid >> 2;
      int bi = row / tw, bj = row - bi * tw;  // the row's pixel in the tile
      while (row < rows) {
        uint32_t v[GATHER_TASKS][8];
        int at[GATHER_TASKS];
#pragma unroll
        for (int s = 0; s < GATHER_TASKS; ++s) {
          at[s] = row;
          const int i = i0 + bi, j = j0 + bj;
          const bool live = row < rows && i < ho && j < wo;
          const bf16* p = xn + (2LL * i * w + 2 * j) * c;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[s][e] = live && off[e] >= 0 ? pair(p + off[e]) : 0u;
          row += rstep;
          for (bj += rstep; bj >= tw; bj -= tw) ++bi;
        }
#pragma unroll
        for (int s = 0; s < GATHER_TASKS; ++s) {
          const int r = at[s];
          if (r >= rows) break;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int chunk = 2 * g + hf;
            asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                             base + r * 128 + ((chunk ^ (r & 7)) << 4)),
                         "r"(v[s][4 * hf]), "r"(v[s][4 * hf + 1]),
                         "r"(v[s][4 * hf + 2]), "r"(v[s][4 * hf + 3])
                         : "memory");
          }
        }
      }
    }
  }
  // the B rows of (K block, tap): 64 rows of w4 viewed as [16C, 4O], one
  // box per 64 columns
  __device__ void load_b(int kb, int tap, uint8_t* b, uint64_t* bar) const {
    int row = 64 * kb;
    if (BOX) {
      const int par = kb / kps;
      row = ((2 * (tap >> 1) + par) * 4 + 2 * (tap & 1)) * c +
            64 * (kb - par * kps);
    }
#pragma unroll
    for (int j = 0; j < NB / 64; ++j)
      sm90::tma_load_2d(b + j * sm90::kMnBox, &wmap, bar, 64 * j, row);
  }
};

template <int O4, int MODE>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    strided_conv4x4s2_fwd_kernel(
        const __grid_constant__ StridedTiles<O4, MODE> p) {
  sm90::run(p);
}

// How the kernel reads x [n, h, w, c]: boxed where TMA can stride its
// space-to-depth view, i.e. the view's byte strides (pixel pair 4C, row
// parity 2WC, packed row 4WC, image 2HWC) are multiples of 16 and x is
// 16-byte aligned (tiles.strided_boxable mirrors this rule); else
// gathered.
inline int strided_mode(const void* x, int h, int w, int c) {
  const long long strides[4] = {4LL * c, 2LL * w * c, 4LL * w * c,
                                2LL * h * w * c};
  bool box = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (long long s : strides) box = box && s % 16 == 0;
  if (box) return kBox;
  return (long long)w * c % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0
             ? kWords
             : kHalves;
}

template <int O4, int MODE>
int run_strided(const void* x, const void* w, const void* bias, void* y,
                int n, int h, int wdt, int c, int th, int tw,
                cudaStream_t s) {
  constexpr bool BOX = MODE == kBox;
  StridedTiles<O4, MODE> p{};
  p.x = (const bf16*)x;
  p.h = h;
  p.w = wdt;
  p.c = c;
  p.kps = BOX ? (2 * c + 63) / 64 : (16 * c + 63) / 64;
  p.bias = (const float*)bias;
  p.y = (bf16*)y;
  int e = 0;
  if (BOX) {
    const cuuint64_t dims[5] = {(cuuint64_t)(2 * c), (cuuint64_t)(wdt / 2), 2,
                                (cuuint64_t)(h / 2), (cuuint64_t)n};
    const cuuint64_t strides[4] = {
        (cuuint64_t)(4LL * c), (cuuint64_t)(2LL * wdt * c),
        (cuuint64_t)(4LL * wdt * c), (cuuint64_t)(2LL * h * wdt * c)};
    const cuuint32_t box[5] = {64, (cuuint32_t)tw + 1, 1, (cuuint32_t)th + 1,
                               1};
    e = sm90::make_map_strided(&p.xmap, x, 5, dims, strides, box);
  }
  const cuuint64_t wdims[2] = {(cuuint64_t)O4, (cuuint64_t)(16 * c)};
  const cuuint32_t wbox[2] = {64, 64};
  if (e == 0) e = sm90::make_map(&p.wmap, w, 2, wdims, wbox);
  if (e == 0) e = p.plan(n, (h - 2) / 2, (wdt - 2) / 2, th, tw);
  if (e != 0) return e;
  return sm90::launch(strided_conv4x4s2_fwd_kernel<O4, MODE>, p, s);
}

template <int O4>
int strided_modes(const void* x, const void* w, const void* bias, void* y,
                  int n, int h, int wdt, int c, int th, int tw,
                  cudaStream_t s) {
  switch (strided_mode(x, h, wdt, c)) {
    case kBox:
      return run_strided<O4, kBox>(x, w, bias, y, n, h, wdt, c, th, tw, s);
    case kWords:
      return run_strided<O4, kWords>(x, w, bias, y, n, h, wdt, c, th, tw, s);
    default:
      return run_strided<O4, kHalves>(x, w, bias, y, n, h, wdt, c, th, tw, s);
  }
}

// The requant-only entry: the bf16 product, the int8 epilogue.
template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
    strided_conv4x4s2_requant_kernel(Strided4x4Loader<bf16, VEC> ld,
                                     const bf16* __restrict__ w,
                                     const float* __restrict__ mul,
                                     const float* __restrict__ add,
                                     s8* __restrict__ y, long long M) {
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * TileCfg<BN>::BM;
  float* Cs = igemm_tile<BN, bf16>(ld, w, 16 * ld.c, m0, M, seg_smem);
  epilogue_affine<BN, s8>(Cs, mul, add, y, false, Linear{m0, M});
}

template <int BN, bool VEC>
int run_requant(const bf16* x, const void* w, const void* mul,
                const void* add, void* y, int n, int h, int wdt, int c,
                cudaStream_t s) {
  const int ho = (h - 2) / 2;
  const int wo = (wdt - 2) / 2;
  const Strided4x4Loader<bf16, VEC> ld{x, h, wdt, c, ho, wo};
  const long long M = (long long)n * ho * wo;
  return launch<BN>(strided_conv4x4s2_requant_kernel<BN, VEC>, M, s, 0, ld,
                    (const bf16*)w, (const float*)mul, (const float*)add,
                    (s8*)y, M);
}

// Loader: Strided4x4Loader<s8, VEC>, or QuantLoader over the bf16 one.
template <int BN, class Loader>
__global__ void __launch_bounds__(kThreads)
    strided_conv4x4s2_s8_kernel(Loader ld, int K, const s8* __restrict__ w,
                                const float* __restrict__ mul,
                                const float* __restrict__ add,
                                s8* __restrict__ y, long long M) {
  extern __shared__ __align__(128) unsigned char seg_smem[];
  const long long m0 = (long long)blockIdx.x * TileCfg<BN>::BM;
  int* Cs = igemm_tile<BN, s8>(ld, w, K, m0, M, seg_smem);
  epilogue_affine<BN, s8>(Cs, mul, add, y, false, Linear{m0, M});
}

template <class Loader>
int run_strided_s8(const Loader& ld, int K, int o4, const void* w,
                   const void* mul, const void* add, void* y, long long M,
                   cudaStream_t s) {
  if (o4 == 128)
    return launch<128, s8>(strided_conv4x4s2_s8_kernel<128, Loader>, M, s, 0,
                           ld, K, (const s8*)w, (const float*)mul,
                           (const float*)add, (s8*)y, M);
  if (o4 == 256)
    return launch<256, s8>(strided_conv4x4s2_s8_kernel<256, Loader>, M, s, 0,
                           ld, K, (const s8*)w, (const float*)mul,
                           (const float*)add, (s8*)y, M);
  return (int)cudaErrorInvalidValue;
}

}  // namespace segk

// x [n, h, w, c] bf16 (h, w >= 4); w [16*c, o4] bf16 (HWIO [4, 4, c, o4]);
// bias [o4] f32; y [n, (h-2)/2, (w-2)/2, o4] bf16; (th, tw) the output tile
// from tiles.tile_plan: th (tw + 1) GEMM rows where x is boxed
// (strided_mode), th tw where it is gathered. w, bias and y 16-byte
// aligned.
extern "C" int seg_strided_conv4x4s2(const void* x, const void* w,
                                     const void* bias, void* y, int n,
                                     int h, int wdt, int c, int o4, int th,
                                     int tw, void* stream) {
  using namespace segk;
  if (n < 1 || h < 4 || wdt < 4 || c < 1 || th > 255 || tw > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (o4 == 128)
    return strided_modes<128>(x, w, bias, y, n, h, wdt, c, th, tw, s);
  if (o4 == 256)
    return strided_modes<256>(x, w, bias, y, n, h, wdt, c, th, tw, s);
  return (int)cudaErrorInvalidValue;
}

// The requant-only mode: x [n, h, w, c] bf16; w [16*c, o4] bf16; mul, add
// [o4] f32; y [n, (h-2)/2, (w-2)/2, o4] s8.
extern "C" int seg_strided_conv4x4s2_requant(const void* x, const void* w,
                                             const void* mul,
                                             const void* add, void* y, int n,
                                             int h, int wdt, int c, int o4,
                                             void* stream) {
  using namespace segk;
  const bf16* xp = (const bf16*)x;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = c % 8 == 0;
  if (o4 == 128)
    return vec ? run_requant<128, true>(xp, w, mul, add, y, n, h, wdt, c, s)
               : run_requant<128, false>(xp, w, mul, add, y, n, h, wdt, c, s);
  if (o4 == 256)
    return vec ? run_requant<256, true>(xp, w, mul, add, y, n, h, wdt, c, s)
               : run_requant<256, false>(xp, w, mul, add, y, n, h, wdt, c, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: x [n, h, w, c]: s8 codes when act_inv is 0 (c % 16 == 0,
// or any c through the gather: the C = 3 s8-input entry), else bf16
// quantized on load at act_inv = f32(1 / act_scale) (c % 16 == 0); w
// [16*c, o4] s8; mul, add [o4] f32; y [n, (h-2)/2, (w-2)/2, o4] s8.
extern "C" int seg_strided_conv4x4s2_s8(const void* x, const void* w,
                                        const void* mul, const void* add,
                                        void* y, int n, int h, int wdt,
                                        int c, int o4, float act_inv,
                                        void* stream) {
  using namespace segk;
  const int ho = (h - 2) / 2;
  const int wo = (wdt - 2) / 2;
  const long long M = (long long)n * ho * wo;
  const int K = 16 * c;
  cudaStream_t s = (cudaStream_t)stream;
  if (act_inv > 0.0f) {
    if (c % 16) return (int)cudaErrorInvalidValue;
    const QuantLoader<Strided4x4Loader<bf16, true>> ld{
        {(const bf16*)x, h, wdt, c, ho, wo}, act_inv};
    return run_strided_s8(ld, K, o4, w, mul, add, y, M, s);
  }
  if (c % 16 == 0)
    return run_strided_s8(Strided4x4Loader<s8, true>{(const s8*)x, h, wdt, c,
                                                     ho, wo},
                          K, o4, w, mul, add, y, M, s);
  return run_strided_s8(Strided4x4Loader<s8, false>{(const s8*)x, h, wdt, c,
                                                    ho, wo},
                        K, o4, w, mul, add, y, M, s);
}
