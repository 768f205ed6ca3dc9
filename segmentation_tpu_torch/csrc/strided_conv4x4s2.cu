// H3 strided_conv4x4s2: a 3x3 VALID conv whose output lands packed, as a
// 4x4 stride-2 VALID conv from an unpacked [N, H, W, C] input to packed
// [N, (H-2)/2, (W-2)/2, 4O] with the s2d-folded weights w4 [4, 4, C, 4O]
// (models/unet_fast.py pack_conv3_weight_s2_t). Every mode runs on the
// Hopper mainloop (sm90_igemm.cuh: TMA or producer-gathered A, wgmma,
// warp-specialised, persistent) with the output side of
// packed_conv2x2_fwd.cuh (FwdOut):
//   bf16:    x, w4 bf16, + f32 bias, ReLU, bf16 store;
//   requant: x, w4 bf16 (f32 accumulation, the bf16 product) with the
//            int8 epilogue relu(acc * mul + add), s8 out: the image entry's
//            requant-only mode (C = 3), the same product and epilogue as
//            H5's conv1_1, so the same codes;
//   s8:      x s8 codes (C % 16 == 0), or bf16 quantized as it loads
//            (act_inv: the inline-quantize mode), or C = 3 s8 image codes
//            (the image entry's s8-input mode); the K-major s8 copy wk4 of
//            w4 (s8 wgmma, s32 accumulation), the int8 epilogue requantized
//            to s8.
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
//    zeros, one block, 4 wgmma k16 steps, 3 in the requant mode; the
//    four-tap form would pad each of its 6-channel blocks to 64, 8 times
//    the work), gathered by the producer warpgroup's three idle warps
//    (im2col.cuh) a bf16 pair at a time (one 4-byte load where W C is
//    even), each thread's pairs' offsets in the window fixed for a K
//    block, 32 loads of a thread in flight: the warpgroup takes 96
//    registers a thread for it, the consumers keep 200; the threads ask L2
//    for the next tile's input rows. B the rows 64 kb of the same view of
//    w4.
//  - Output: FwdOut's. 4O = 128 (conv1_1): ping-pong consumers and TMA
//    stores from a staging tile; 4O = 256 (conv2_1): tiles split between
//    the consumers, register stores; 4O = 512 (conv2_1 at n_kernels 64,
//    boxed only): two column tiles of 256 a pixel tile, each B row's four
//    64-column boxes a channel block of the four slots (FwdOut::col).
//
// The int8 design (StridedS8Tiles). A K block of s8 is 128 channels, the
// bf16 row's 128 bytes, but a row parity's 2C = 64 s8 channels (conv2_1)
// fill only half of one. So the A slot holds one 128-byte row per
// space-to-depth pixel of the tile's halo, both row parities side by side:
// byte 64 a + r of K block kb is channel bc = 64 kb + r of (b, c) at row
// parity a, x[n, 2i + a, 2j + b, c] with bc = b C + c, zero past 2C and
// outside the space-to-depth grid; the four taps read the slot as row
// shifts, one K block a tap: H1 s8's problem, kps = ceil(2C / 64) blocks.
// The producer warpgroup's three idle warps gather the rows 16 channels (a
// 16-byte chunk) at a time, s8 codes or bf16 quantized once per K block by
// the Pallas multiply rule (int8_epilogue.cuh quant16; two 16-byte loads
// a chunk), and
// store them where TMA's 128-byte swizzle would. (A TMA box of a 5-D view
// with the dims reordered, (2C, 2, W/2, H/2, N), box [64, 2, tw + 1, th +
// 1, 1], does not land one 128-byte row per pixel on the H100: its 64-byte
// inner rows under the 128-byte swizzle read wrong and unrepeatable
// codes.) B is the K-major copy wk4 [4O, 4 kps 128] in the same order
// (conv_int8.strided_k_major, made once in UNetS2DInt8.plan): wk4[o, (tap
// kps + kb) 128 + 64 a + r] = w4[2u + a, 2v + b, c, o] for bc = 64 kb + r
// < 2C, else 0; one box [128 K bytes, 4O rows] per K block and tap. The
// s8-input entry (C = 3) gathers im2col rows of s8 codes (im2col.cuh: 48
// bytes of a 128-byte row), one tap, and runs only the two wgmma k32 steps
// that hold data; its wk4 is [4O, 48], the im2col order.
//
// Bound on the H100: bytes. The entry writes 128 channels per packed pixel
// against 48 bytes read (133 MB of y against 12.6 MB of x at B = 8), so
// its store path is what matters; conv2_1 (K = 512) reads the whole w4
// (256 KiB bf16, 128 KiB s8) from L2 once per 128-row tile.
#include "im2col.cuh"
#include "packed_conv2x2_fwd.cuh"

namespace segk {

// How the bf16 problem reads x: kBox, 5-D TMA boxes; else gathered as
// im2col rows, a bf16 pair a 4-byte load (kWords: W C even, x 4-byte
// aligned) or two 2-byte loads (kHalves).
constexpr int kBox = 0, kWords = 1, kHalves = 2;

// The bf16 problem on the Hopper mainloop (see the top of this file);
// EPI: 0, or kRequant (the requant-only entry).
template <int O4, int MODE, int EPI = 0>
struct StridedTiles : FwdOut<O4, EPI, MODE == kBox ? 1 : 0> {
  static constexpr bool BOX = MODE == kBox;
  using Out = FwdOut<O4, EPI, BOX ? 1 : 0>;
  using Out::BM;
  using Out::NB;
  using Out::origin;
  using Out::th;
  using Out::tw;
  static constexpr int TAPS = BOX ? 4 : 1;
  // boxed: the halo box and the largest tap shift, as FwdTiles
  static constexpr int A_ROWS = BOX ? (2 * BM + 1 + 7) / 8 * 8 : BM;
  static constexpr int B_STAGES = Out::b_stages(A_ROWS);
  static constexpr bool B_MN = true, GATHER = !BOX;
  // the requant-only entry (C = 3): 48 values of the one K block, three
  // k16 steps
  static constexpr int KSTEPS = EPI == kRequant ? 3 : 4;
  // the gather keeps GATHER_TASKS rows x 8 pairs of each thread in flight
  // (kHalves: two loads a pair, two rows in 96 registers)
  static constexpr int GATHER_TASKS = MODE == kHalves ? 2 : 4;
  static constexpr int PRODUCER_REGS = BOX ? sm90::kProducerRegs : 96;

  CUtensorMap xmap, wmap;  // the 5-D view of x (boxed); w4 as [16C, 4O]
  Im2col<bf16, MODE == kWords> img;  // gathered
  int c;                   // x [n, h, w, c]
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
  // Ask L2 for the input rows of tile t.
  __device__ void prefetch_rows(int t, int tid, int nthreads) const {
    if (t >= this->n_tiles) return;
    int n, i0, j0;
    origin(t, n, i0, j0);
    img.prefetch_rows(n, i0, j0, th, tw, tid, nthreads);
  }
  // The gathered A slot of K block kb: the im2col rows of the tile's
  // pixels, row m = a tw + b; rows past th tw are junk rows, left as they
  // are. With the first block the threads ask L2 for the block's next
  // tile's input rows.
  __device__ void gather_a(int t, int kb, uint8_t* a, int tid,
                           int nthreads) const {
    if constexpr (!BOX) {
      if (kb == 0) prefetch_rows(t + gridDim.x, tid, nthreads);
      int n, i0, j0;
      origin(t, n, i0, j0);
      img.template gather<GATHER_TASKS>(a, kb, n, i0, j0, th, tw, tid,
                                        nthreads);
    }
  }
  // the B rows of (K block, tap): 64 rows of w4 viewed as [16C, 4O], one
  // box per 64 columns of the column tile
  __device__ void load_b(int t, int kb, int tap, uint8_t* b,
                         uint64_t* bar) const {
    int row = 64 * kb;
    if (BOX) {
      const int par = kb / kps;
      row = ((2 * (tap >> 1) + par) * 4 + 2 * (tap & 1)) * c +
            64 * (kb - par * kps);
    }
#pragma unroll
    for (int j = 0; j < NB / 64; ++j)
      sm90::tma_load_2d(b + j * sm90::kMnBox, &wmap, bar,
                        Out::col(Out::ctile(t), 64 * j), row);
  }
};

template <int O4, int MODE>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    strided_conv4x4s2_fwd_kernel(
        const __grid_constant__ StridedTiles<O4, MODE> p) {
  sm90::run(p);
}

// The requant-only entry, under its own name: profiles group kernels by
// name
template <int O4, int MODE>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    strided_conv4x4s2_requant_kernel(
        const __grid_constant__ StridedTiles<O4, MODE, kRequant> p) {
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

// Fill and launch a bf16 problem (EPI 0: bias; kRequant: mul, add).
template <int O4, int MODE, int EPI>
int run_strided(const void* x, const void* w, const void* bias,
                const void* mul, const void* add, void* y, int n, int h,
                int wdt, int c, int th, int tw, cudaStream_t s) {
  constexpr bool BOX = MODE == kBox;
  StridedTiles<O4, MODE, EPI> p{};
  p.img = {(const bf16*)x, h, wdt, c, (h - 2) / 2, (wdt - 2) / 2};
  p.c = c;
  p.kps = BOX ? (2 * c + 63) / 64 : (16 * c + 63) / 64;
  p.bias = (const float*)bias;
  p.mul = (const float*)mul;
  p.add = (const float*)add;
  p.y = (typename StridedTiles<O4, MODE, EPI>::OutT*)y;
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
  if constexpr (EPI == kRequant)
    return sm90::launch(strided_conv4x4s2_requant_kernel<O4, MODE>, p, s);
  else
    return sm90::launch(strided_conv4x4s2_fwd_kernel<O4, MODE>, p, s);
}

template <int O4, int EPI>
int strided_modes(const void* x, const void* w, const void* bias,
                  const void* mul, const void* add, void* y, int n, int h,
                  int wdt, int c, int th, int tw, cudaStream_t s) {
  switch (strided_mode(x, h, wdt, c)) {
    case kBox:
      if constexpr (EPI == 0)
        return run_strided<O4, kBox, EPI>(x, w, bias, mul, add, y, n, h,
                                          wdt, c, th, tw, s);
      return (int)cudaErrorInvalidValue;  // the requant entry is C = 3
    case kWords:
      return run_strided<O4, kWords, EPI>(x, w, bias, mul, add, y, n, h, wdt,
                                          c, th, tw, s);
    default:
      return run_strided<O4, kHalves, EPI>(x, w, bias, mul, add, y, n, h,
                                           wdt, c, th, tw, s);
  }
}

// How the int8 problem gathers x: kS8Codes, s8 codes (C % 16 == 0);
// kS8Quant, bf16 quantized; kS8Entry / kS8EntryWide, C = 3 s8 codes as
// im2col rows (a byte pair two 1-byte loads, or one 2-byte load where W C
// is even).
constexpr int kS8Codes = 0, kS8Quant = 1, kS8Entry = 2, kS8EntryWide = 3;

// The int8 problem on the Hopper mainloop (see the top of this file).
template <int O4, int MODE>
struct StridedS8Tiles : FwdOut<O4, kInt8 | kRequant, MODE <= kS8Quant> {
  static constexpr bool TAPS4 = MODE <= kS8Quant;  // four taps over a halo
  using Out = FwdOut<O4, kInt8 | kRequant, TAPS4>;
  using Out::BM;
  using Out::origin;
  using Out::th;
  using Out::tw;
  static constexpr int TAPS = TAPS4 ? 4 : 1;
  static constexpr int A_ROWS = TAPS4 ? (2 * BM + 1 + 7) / 8 * 8 : BM;
  static constexpr int B_STAGES = Out::b_stages(A_ROWS);
  static constexpr bool B_MN = false, GATHER = true;
  // the entry's 48 bytes of a row: two k32 steps
  static constexpr int KSTEPS = TAPS4 ? 4 : 2;
  // the pixel gather keeps GATHER_CHUNKS chunks of each thread in flight
  // (two 16-byte loads each where it quantizes)
  static constexpr int GATHER_CHUNKS = 4;
  static constexpr int PRODUCER_REGS = TAPS4 ? 80 : 96;

  CUtensorMap wmap;        // wk4
  const uint8_t* xs;       // TAPS4: x [n, h, w, c], s8 or bf16
  Im2col<s8, MODE == kS8EntryWide> img;  // the entry
  float inv;               // kS8Quant: f32(1 / act_scale)
  int h, w, c;             // x [n, h, w, c]
  int kps;                 // K blocks a tap (TAPS4): ceil(2C / 64)

  __device__ int k_blocks() const { return TAPS4 ? kps : 1; }
  __device__ uint32_t a_tx(int) const { return 0u; }
  __device__ int a_row(int tap) const {  // (u, v) = (tap >> 1, tap & 1)
    return TAPS4 ? (tap >> 1) * (tw + 1) + (tap & 1) : 0;
  }
  __device__ void prefetch() const { sm90::prefetch_map(&wmap); }
  __device__ void load_a(int, int, uint8_t*, uint64_t*) const {}
  // The gathered A slot of K block kb. TAPS4 (sm90::gather_rows): thread
  // tid's chunk tid % 8 (row parity a = chunk / 4, channels bc = 64 kb +
  // 16 (chunk % 4) of (b, c)) of each halo row is the 16 values of x[n, 2i
  // + a, 2j .. 2j + 1, :] from bc on (2C % 16 == 0: one run of the pair),
  // zero past 2C and outside the space-to-depth grid [h / 2, w / 2];
  // quantized where x is bf16 (kS8Quant). The entry: im2col rows (an L2
  // prefetch of the next tile's rows, as the bf16 entry asks, bought
  // nothing here).
  __device__ void gather_a(int t, int kb, uint8_t* a, int tid,
                           int nthreads) const {
    int n, i0, j0;
    origin(t, n, i0, j0);
    if constexpr (TAPS4) {
      constexpr int es = MODE == kS8Quant ? 2 : 1;  // the source's bytes
      const int chunk = tid & 7;
      const int par = chunk >> 2, bc = 64 * kb + 16 * (chunk & 3);
      const bool live = bc < 2 * c;
      const int hs = h / 2, ws = w / 2;
      const uint8_t* xn =
          xs + ((long long)n * h * w * c + (long long)par * w * c + bc) * es;
      sm90::gather_rows<GATHER_CHUNKS>(
          a, tid, nthreads, (th + 1) * (tw + 1), tw + 1, es == 2,
          [&](int bi, int bj) {
            const int i = i0 + bi, j = j0 + bj;
            return reinterpret_cast<const uint4*>(
                xn + (2LL * i * w + 2 * j) * c * es);
          },
          [&](int bi, int bj) {
            return live && i0 + bi < hs && j0 + bj < ws;
          },
          [&](uint4 lo, uint4 hi) { return quant16(lo, hi, inv); });
    } else if constexpr (MODE >= kS8Entry) {
      img.template gather<4>(a, 0, n, i0, j0, th, tw, tid, nthreads);
    }
  }
  // the B rows of (K block, tap): the 128 K bytes (tap kps + kb) 128 .. of
  // every column of wk4 [4O, K]
  __device__ void load_b(int, int kb, int tap, uint8_t* b,
                         uint64_t* bar) const {
    sm90::tma_load_2d(b, &wmap, bar, 128 * (tap * kps + kb), 0);
  }
};

template <int O4, int MODE>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    strided_conv4x4s2_s8_kernel(
        const __grid_constant__ StridedS8Tiles<O4, MODE> p) {
  sm90::run(p);
}

// The int8 problem's operands, as the C entry takes them.
struct StridedS8Args {
  const void *x, *wk, *mul, *add;
  void* y;
  int n, h, w, c, th, tw;
  float act_inv;
  cudaStream_t stream;
};

// The width of wk4, the K of the s8 product: four taps of kps 128-byte
// blocks (C % 16 == 0), or one im2col row of 16C (the entry).
inline int strided_s8_k(int c) {
  return c % 16 == 0 ? 4 * ((2 * c + 63) / 64) * 128 : 16 * c;
}

template <int O4, int MODE>
int run_strided_s8(const StridedS8Args& a) {
  StridedS8Tiles<O4, MODE> p{};
  p.xs = (const uint8_t*)a.x;
  p.img = {(const s8*)a.x, a.h, a.w, a.c, (a.h - 2) / 2, (a.w - 2) / 2};
  p.inv = a.act_inv;
  p.h = a.h;
  p.w = a.w;
  p.c = a.c;
  p.kps = (2 * a.c + 63) / 64;
  p.mul = (const float*)a.mul;
  p.add = (const float*)a.add;
  p.y = (s8*)a.y;
  const cuuint64_t wdims[2] = {(cuuint64_t)strided_s8_k(a.c), (cuuint64_t)O4};
  const cuuint32_t wbox[2] = {128, (cuuint32_t)O4};
  int e = sm90::make_map(&p.wmap, a.wk, 2, wdims, wbox, true, sm90::kMapS8);
  if (e == 0) e = p.plan(a.n, (a.h - 2) / 2, (a.w - 2) / 2, a.th, a.tw);
  if (e != 0) return e;
  return sm90::launch(strided_conv4x4s2_s8_kernel<O4, MODE>, p, a.stream);
}

template <int O4>
int strided_s8_modes(const StridedS8Args& a) {
  if (a.act_inv > 0.0f) return run_strided_s8<O4, kS8Quant>(a);
  if (a.c % 16 == 0) return run_strided_s8<O4, kS8Codes>(a);
  return (long long)a.w * a.c % 2 == 0 &&
                 reinterpret_cast<uintptr_t>(a.x) % 2 == 0
             ? run_strided_s8<O4, kS8EntryWide>(a)
             : run_strided_s8<O4, kS8Entry>(a);
}

}  // namespace segk

// x [n, h, w, c] bf16 (h, w >= 4); w [16*c, o4] bf16 (HWIO [4, 4, c, o4]);
// bias [o4] f32; y [n, (h-2)/2, (w-2)/2, o4] bf16; (th, tw) the output tile
// from tiles.tile_plan: th (tw + 1) GEMM rows where x is boxed
// (strided_mode), th tw where it is gathered. o4 = 128 or 256; 512 where x
// is boxed. w, bias and y 16-byte aligned.
extern "C" int seg_strided_conv4x4s2(const void* x, const void* w,
                                     const void* bias, void* y, int n,
                                     int h, int wdt, int c, int o4, int th,
                                     int tw, void* stream) {
  using namespace segk;
  if (n < 1 || h < 4 || wdt < 4 || c < 1 || th > 255 || tw > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (o4 == 128)
    return strided_modes<128, 0>(x, w, bias, nullptr, nullptr, y, n, h, wdt,
                                 c, th, tw, s);
  if (o4 == 256)
    return strided_modes<256, 0>(x, w, bias, nullptr, nullptr, y, n, h, wdt,
                                 c, th, tw, s);
  if (o4 == 512 && strided_mode(x, h, wdt, c) == kBox)
    return run_strided<512, kBox, 0>(x, w, bias, nullptr, nullptr, y, n, h,
                                     wdt, c, th, tw, s);
  return (int)cudaErrorInvalidValue;
}

// The requant-only mode: x [n, h, w, 3] bf16; w [48, o4] bf16; mul, add
// [o4] f32; y [n, (h-2)/2, (w-2)/2, o4] s8; (th, tw) the output tile (th tw
// GEMM rows: gathered). w, mul, add and y 16-byte aligned.
extern "C" int seg_strided_conv4x4s2_requant(
    const void* x, const void* w, const void* mul, const void* add, void* y,
    int n, int h, int wdt, int c, int o4, int th, int tw, void* stream) {
  using namespace segk;
  if (n < 1 || h < 4 || wdt < 4 || c != 3 || th > 255 || tw > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (o4 == 128)
    return strided_modes<128, kRequant>(x, w, nullptr, mul, add, y, n, h,
                                        wdt, c, th, tw, s);
  if (o4 == 256)
    return strided_modes<256, kRequant>(x, w, nullptr, mul, add, y, n, h,
                                        wdt, c, th, tw, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: x [n, h, w, c]: s8 codes when act_inv is 0 (c % 16 == 0,
// or c == 3: the s8-input entry), else bf16 quantized as it is gathered
// at act_inv = f32(1 / act_scale) (c % 16 == 0); wk4 [o4, K] s8, the
// K-major copy of the weight [4, 4, c, o4] (conv_int8.strided_k_major; K =
// strided_s8_k(c)); mul, add [o4] f32; y [n, (h-2)/2, (w-2)/2, o4] s8; (th,
// tw) the output tile (th (tw + 1) GEMM rows for c % 16 == 0, th tw for
// the entry). x (c % 16 == 0), wk4, mul, add and y 16-byte aligned.
extern "C" int seg_strided_conv4x4s2_s8(const void* x, const void* wk4,
                                        const void* mul, const void* add,
                                        void* y, int n, int h, int wdt,
                                        int c, int o4, float act_inv, int th,
                                        int tw, void* stream) {
  using namespace segk;
  if (n < 1 || h < 4 || wdt < 4 || th < 1 || tw < 1 || th > 255 ||
      tw > 255 || (c % 16 != 0 && (c != 3 || act_inv > 0.0f)))
    return (int)cudaErrorInvalidValue;
  const StridedS8Args a{x, wk4, mul, add, y, n, h, wdt, c, th, tw, act_inv,
                        (cudaStream_t)stream};
  if (o4 == 128) return strided_s8_modes<128>(a);
  if (o4 == 256) return strided_s8_modes<256>(a);
  return (int)cudaErrorInvalidValue;
}
