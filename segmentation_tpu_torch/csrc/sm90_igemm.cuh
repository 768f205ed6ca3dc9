// Hopper (sm_90a) implicit-GEMM mainloop of the packed 2x2 convs: TMA
// halo-box loads, mbarrier rings, wgmma, warp specialisation and a
// persistent grid.
//
// The product is D[m, c] = sum over taps and K of A_tap[m, k] B_tap[k, c]:
// P::TAPS shifted views of one A operand against as many weight slices
// (the packed 2x2 conv's four taps; one for a product without taps). A is
// loaded once per 64-channel K block, as a halo region that holds every
// tap's view; B once per K block and tap.
//
// One block of three warpgroups runs on each SM and walks output tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...:
//   warpgroup 0     the producer. One thread keeps two rings of shared-
//                   memory stages filled by TMA (cp.async.bulk.tensor), each
//                   stage's full barrier counting its bytes: A_STAGES A
//                   slots (the halo of a K block) and B_STAGES B stages (a
//                   K block and tap). It gives its registers to the
//                   consumers (setmaxnreg).
//   warpgroups 1-2  the consumers. For each K block and tap they wait for
//                   the stages, run wgmma on the tap's view of the A slot
//                   and the B stage into the problem's accumulator
//                   registers (P::Acc: f32 of bf16 products, s32 of s8
//                   products; P::SIDES of them, see below), keep one
//                   wgmma group in flight and release the stages of the
//                   group before. After a tile's last group they store
//                   their accumulators (the problem's epilogue) while the
//                   producer already loads the next tile.
//
// Both operands are 128 bytes a row (64 bf16, or 128 s8: a K block) in the
// 128-byte swizzle that TMA writes and wgmma reads
// (CU_TENSOR_MAP_SWIZZLE_128B, descriptor layout 1, 8-row groups 1024
// bytes apart); a wgmma k-step is 32 bytes of K either way (k16 bf16,
// k32 s8), so the slots, the taps' row shifts and the descriptors' steps
// do not depend on the type. A is K-major; a tap's A view may start on any
// row of its slot (see sw128_desc). B is K-major (rows of one K block, one
// per column) or, for bf16 only, MN-major (rows of 64 columns, one per K
// value: sw128_mn_desc), as the weight lies in memory for the product (s8
// wgmma has no transpose). A problem P supplies
//   using Acc (float: bf16 products; int: s8 products),
//   constexpr SIDES (1; 2: two accumulators, the first for K blocks below
//             p.kps, the second for the rest),
//             TAPS (views of an A slot: 4, or 1),
//             NB (columns), NI (wgmma N: 128 or 256), MI (m64 groups a
//             consumer runs), BM (GEMM rows of a tile), SPLIT_N (true:
//             both consumers take all BM = 64 rows and NI columns each;
//             false: each takes 64 MI rows of all NI = NB columns),
//             A_ROWS (rows of an A slot), A_STAGES, B_STAGES, B_MN (B is
//             MN-major), GATHER (some A slots are gathered: see gather),
//             optionally KSTEPS (the k-steps of a K block that hold data,
//             4 without it: a gathered block whose tail is zeros),
//             PINGPONG (the consumers take alternate tiles of BM = 64 MI
//             rows, so that one's epilogue overlaps the other's wgmma),
//             PRODUCER_REGS (the producer warpgroup's registers:
//             kProducerRegs, more where its warps gather);
//   n_tiles, tiles(), k_blocks()        the walk;
//   a_tx(kb), load_a(tile, kb, a, bar)  an A slot's TMA bytes and loads;
//   gather_a(tile, kb, a, thread, nthreads)  (GATHER) its plain loads;
//   load_b(tile, kb, tap, b, bar)       a B stage;
//   a_row(tap)                          the first row of tap's A view;
//   STAGE_BYTES                         staging for TMA stores (or 0);
//   store(tile, consumer, acc, [acc_2,] scratch, stage)  the consumers'
//             epilogue: scratch the warp's 2 KiB, stage the consumer's half
//             of the staging.
//
// Tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint: the library links with nvcc -shared
// alone (no -lcuda).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;       // producer warpgroup + two consumers
constexpr int kScratch = 2048;      // a consumer warp's epilogue scratch
constexpr int kProducerRegs = 40;   // a TMA producer warpgroup's registers
// setmaxnreg moves registers within the block's launch allocation, 168 a
// thread (65,536 / 384, a multiple of 8): the consumers' registers beside
// a producer warpgroup of `producer` (P::PRODUCER_REGS) are those left,
// 128 x producer + 256 x consumer <= 384 x 168 (40: 232). More, and the
// consumers' setmaxnreg.inc waits forever.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
__host__ __device__ constexpr int consumer_regs(int producer) {
  return (kThreads * kLaunchRegs - 128 * producer) / 256 / 8 * 8;
}
constexpr int kSmemMax = 232448;    // dynamic shared memory of one block

// How many stages of `stage` bytes fit beside `fixed` bytes, at most `most`.
constexpr int stages_that_fit(int fixed, int stage, int most) {
  return (kSmemMax - fixed) / stage < most ? (kSmemMax - fixed) / stage
                                           : most;
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// The element types of the tensor maps: bf16, and s8 (TMA's 8-bit type;
// it only moves bytes, and fills zeros either way).
constexpr CUtensorMapDataType kMapBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
constexpr CUtensorMapDataType kMapS8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;

// A tensor map of a bf16 (or `type`) tensor: dims innermost first, the
// byte strides of dims 1.. (each a multiple of 16: TMA's rule), boxes of
// `box` (box[0] = 128 bytes: one 128-byte swizzled row; or unswizzled),
// zero fill outside the tensor, negative coordinates included (a store
// writes only the box's part inside). Returns a cudaError_t.
inline int make_map_strided(CUtensorMap* map, const void* base, int rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box, bool swizzle = true,
                            CUtensorMapDataType type = kMapBf16) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc(map, type,
                         (cuuint32_t)rank, const_cast<void*>(base), dims,
                         strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The same of a dense row-major tensor.
inline int make_map(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dims, const cuuint32_t* box,
                    bool swizzle = true, CUtensorMapDataType type = kMapBf16) {
  cuuint64_t strides[4];
  cuuint64_t s = type == kMapS8 ? 1 : sizeof(bf16);
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  return make_map_strided(map, base, rank, dims, strides, box, swizzle,
                          type);
}

// ----------------------------------------------------------- device PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}"
      ::"r"(smem_u32(bar))
      : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// A TMA store of a box from shared memory, in the thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"((uint64_t)map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Wait until the thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// Barrier `id` (1..15) of the `count` threads that name it.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"((uint64_t)map) : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte swizzle whose rows are
// 128 bytes: start address, LBO 16 B (unused by this layout), SBO 1024 B
// between 8-row groups, layout 1. The swizzle is a function of the shared
// address itself (bits 4-6 XOR bits 7-9), as TMA writes it into a 1024-byte
// aligned region, so a tile may start on any 128-byte row of that region
// with a base offset of 0: a k16 step inside the row adds 32 bytes (2 in
// the address field), a tap's shift whole rows. (Setting the base offset
// to the start row's phase as well reads wrong data, on the H100.)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma descriptor of an MN-major B tile with 128-byte swizzle, as TMA
// writes boxes of [64 K rows, 64 columns] side by side: each box holds 64
// columns of every K row (K row k at byte 128 k of its box), 8-row groups
// of K 1024 bytes apart (SBO) and the next 64 columns 8192 bytes on (LBO),
// layout 1. A k16 step moves down 16 K rows: 2048 bytes (128 in the
// address field).
constexpr int kMnBox = 64 * 128;  // bytes of one [64 K, 64 N] box

__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(kMnBox >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (its operands are read and written behind its back).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N] from shared memory, A K-major (TA =
// 0) or, for N = 128, MN-major (TA = 1, wgmma's tnsp-a), B K-major (TB = 0)
// or MN-major (TB = 1, wgmma's tnsp-b); scale_d = 0 overwrites D.
template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64 x N] (+)= A[64 x 32] B[32 x N] in s8 with s32 accumulators, both
// K-major (s8 wgmma has no transpose).
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
        "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t da,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
        "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
        "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]),
        "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]),
        "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),
        "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]),
        "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
        "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One k-step of D[64 x N] (N = 128 or 256): 32 bytes of K, k16 of bf16 into
// f32 (B K-major, TB = 0, or MN-major, TB = 1) or k32 of s8 into s32.
template <int N, int TB>
__device__ __forceinline__ void wgmma_step(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (N == 256)
    wgmma_m64n256k16<TB>(d, da, db, scale_d);
  else
    wgmma_m64n128k16<TB>(d, da, db, scale_d);
}
template <int N, int TB>
__device__ __forceinline__ void wgmma_step(int (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  static_assert(TB == 0, "s8 wgmma reads B K-major only");
  if constexpr (N == 256)
    wgmma_m64n256k32_s8(d, da, db, scale_d);
  else
    wgmma_m64n128k32_s8(d, da, db, scale_d);
}

// A finished epilogue value kept in an accumulator register: f32 itself,
// or its bits in an s32 accumulator (the int8 epilogues finish in place:
// the wgmma operands keep the accumulators live across the tile loop, so
// a second array of finished values would not fit beside them).
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(int v) { return __int_as_float(v); }
__device__ __forceinline__ void put_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void put_f32(int& d, float v) {
  d = __float_as_int(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// ------------------------------------------------------------- epilogue
// Store one consumer warpgroup's accumulators as bf16 (round to nearest
// even), 64 columns at a time: stmatrix moves the warp's 16 x 64 block of
// the wgmma fragment into its 2 KiB scratch (rows of 128 bytes, their
// 16-byte chunks XOR-swizzled by row so neither side conflicts on banks),
// then each store writes 4 rows x 128 contiguous bytes: lane l stores
// chunk l % 8 of row 4 i + l / 8 (of the warp's 16 rows of m64 group mi)
// at dst(mi, row, col), the address of column col of that row, or nothing
// where dst is null.
template <int NI, int MI, class A, class Dst>
__device__ __forceinline__ void store_acc(A (&acc)[MI][NI / 2],
                                          uint8_t* scratch, Dst dst) {
  const int lane = threadIdx.x & 31;
  const uint32_t base = smem_u32(scratch);
  // stmatrix.x4: lanes 8q..8q+7 give the rows of matrix q, which holds
  // rows 8 (q & 1).. and columns 8 (q >> 1).. of a 16 x 16 block
  const int st_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int ld_row = lane >> 3, ld_chunk = lane & 7;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int pass = 0; pass < NI / 64; ++pass) {
#pragma unroll
      for (int jq = 0; jq < 4; ++jq) {
        const A* d = &acc[mi][8 * (4 * pass + jq)];
        const int chunk = 2 * jq + (lane >> 4);
        asm volatile(
            "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
            ::"r"(base + st_row * 128 + ((chunk ^ (st_row & 7)) << 4)),
            "r"(pack_bf16(as_f32(d[0]), as_f32(d[1]))),
            "r"(pack_bf16(as_f32(d[2]), as_f32(d[3]))),
            "r"(pack_bf16(as_f32(d[4]), as_f32(d[5]))),
            "r"(pack_bf16(as_f32(d[6]), as_f32(d[7])))
            : "memory");
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * i + ld_row;
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(base + row * 128 + ((ld_chunk ^ (row & 7)) << 4))
                     : "memory");
        bf16* out = dst(mi, row, 64 * pass + 8 * ld_chunk);
        if (out != nullptr) *reinterpret_cast<uint4*>(out) = v;
      }
      __syncwarp();
    }
  }
}

// Two finished s8 values (integers in f32, within +-127) as 16 bits, the
// lower column first.
__device__ __forceinline__ uint32_t pack_s8x2(float lo, float hi) {
  return ((uint32_t)(int)lo & 0xffu) | (((uint32_t)(int)hi & 0xffu) << 8);
}

// The same store of finished s8 values (the int8 epilogue's requantized
// codes, as f32), 128 columns at a time: each thread puts its column
// pairs (16 bits) of rows lane / 4 and lane / 4 + 8 into the scratch (rows
// of 128 bytes, 16-byte chunks XOR-swizzled by row: no bank conflicts),
// then each store writes 4 rows x 128 contiguous bytes as above.
template <int NI, int MI, class A, class Dst>
__device__ __forceinline__ void store_acc_s8(A (&acc)[MI][NI / 2],
                                             uint8_t* scratch, Dst dst) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const uint32_t base = smem_u32(scratch);
  const int ld_row = lane >> 3, ld_chunk = lane & 7;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int pass = 0; pass < NI / 128; ++pass) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (lane >> 2) + 8 * h;
#pragma unroll
        for (int jq = 0; jq < 16; ++jq) {
          const A* d = &acc[mi][4 * (16 * pass + jq) + 2 * h];
          asm volatile("st.shared.u16 [%0], %1;" ::"r"(
                           base + row * 128 + (((jq >> 1) ^ (row & 7)) << 4) +
                           (jq & 1) * 8 + 2 * q),
                       "h"((unsigned short)pack_s8x2(as_f32(d[0]),
                                                     as_f32(d[1])))
                       : "memory");
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * i + ld_row;
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(base + row * 128 + ((ld_chunk ^ (row & 7)) << 4))
                     : "memory");
        int8_t* out = dst(mi, row, 128 * pass + 16 * ld_chunk);
        if (out != nullptr) *reinterpret_cast<uint4*>(out) = v;
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------- mainloop
// A ring position: stage index and the parity of its barriers' phase.
template <int N>
struct Pos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == N) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// A problem's k-steps per K block: P::KSTEPS where it has one, else 4.
template <class P, class = void>
struct KSteps {
  static constexpr int value = 4;
};
template <class P>
struct KSteps<P, std::void_t<decltype(P::KSTEPS)>> {
  static constexpr int value = P::KSTEPS;
};

template <class P>
struct Ring {
  static constexpr int A_BYTES = P::A_ROWS * 128;
  static constexpr int B_BYTES = P::NB * 128;
  static constexpr int NBAR = 2 * (P::A_STAGES + P::B_STAGES) + 2;
  uint8_t* base;
  __device__ explicit Ring(uint8_t* raw)
      : base(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023)) {}
  __device__ uint8_t* a(int s) const { return base + s * A_BYTES; }
  __device__ uint8_t* b(int s) const {
    return base + P::A_STAGES * A_BYTES + s * B_BYTES;
  }
  // P::STAGE_BYTES of staging for the consumers' stores (TMA stores)
  __device__ uint8_t* stage() const { return b(P::B_STAGES); }
  __device__ uint8_t* scratch(int warp) const {
    return stage() + P::STAGE_BYTES + warp * kScratch;
  }
  __device__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(scratch(8)) + i;
  }
  __device__ uint64_t* a_full(int s) const { return bar(s); }
  __device__ uint64_t* a_empty(int s) const { return bar(P::A_STAGES + s); }
  __device__ uint64_t* b_full(int s) const { return bar(2 * P::A_STAGES + s); }
  __device__ uint64_t* b_empty(int s) const {
    return bar(2 * P::A_STAGES + P::B_STAGES + s);
  }
  // ping-pong: consumer c has waited for every stage of its tile
  __device__ uint64_t* done(int c) const { return bar(NBAR - 2 + c); }
};

template <class P>
constexpr int smem_bytes() {
  return 1024 + P::A_STAGES * Ring<P>::A_BYTES +
         P::B_STAGES * Ring<P>::B_BYTES + P::STAGE_BYTES + 8 * kScratch +
         8 * Ring<P>::NBAR;
}

template <class P>
__device__ __forceinline__ void produce(const P& p, const Ring<P>& r) {
  Pos<P::A_STAGES> a;
  Pos<P::B_STAGES> b;
  for (int t = blockIdx.x; t < p.tiles(); t += gridDim.x) {
    for (int kb = 0; kb < p.k_blocks(); ++kb) {
      mbar_wait(r.a_empty(a.stage), a.phase ^ 1);
      mbar_expect_tx(r.a_full(a.stage), p.a_tx(kb));
      p.load_a(t, kb, r.a(a.stage), r.a_full(a.stage));
      a.next();
      for (int tap = 0; tap < P::TAPS; ++tap) {
        mbar_wait(r.b_empty(b.stage), b.phase ^ 1);
        mbar_expect_tx(r.b_full(b.stage), Ring<P>::B_BYTES);
        p.load_b(t, kb, tap, r.b(b.stage), r.b_full(b.stage));
        b.next();
      }
    }
  }
}

// Warps 1-3 of the producer warpgroup, where the problem gathers some A
// slots with plain loads (P::GATHER): they walk the same ring positions as
// the producer thread, fill the slots that p.gather_a takes (the others it
// leaves to TMA), make their stores visible to wgmma (the async proxy) and
// arrive, one arrival per warp, on the slot's full barrier.
template <class P>
__device__ __forceinline__ void gather(const P& p, const Ring<P>& r) {
  Pos<P::A_STAGES> a;
  const int tid = threadIdx.x - 32;
  for (int t = blockIdx.x; t < p.tiles(); t += gridDim.x) {
    for (int kb = 0; kb < p.k_blocks(); ++kb) {
      mbar_wait(r.a_empty(a.stage), a.phase ^ 1);
      p.gather_a(t, kb, r.a(a.stage), tid, 96);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(r.a_full(a.stage));
      a.next();
    }
  }
}

// A gathered K block of `rows` A-slot rows, stored where TMA's 128-byte
// swizzle would put it (the problems' gather_a): thread tid takes 16-byte
// chunk tid % 8 of rows tid / 8, tid / 8 + nthreads / 8, ... (nthreads % 8
// == 0), row r = bi w + bj walked pixel by pixel; src(bi, bj) is the
// chunk's source, read where ok(bi, bj) holds (else zeros; the address is
// formed either way, so that the loads stay predicated, not branched).
// With `quantize` the source is 16 bf16 values (two 16-byte loads) that
// quant(lo, hi) turns into 16 s8 codes. U chunks a thread are loaded
// before any is stored.
template <int U, class Src, class Ok, class Quant>
__device__ __forceinline__ void gather_rows(uint8_t* a, int tid, int nthreads,
                                            int rows, int w, bool quantize,
                                            Src src, Ok ok, Quant quant) {
  const int chunk = tid & 7, rstep = nthreads >> 3;
  const uint32_t base = smem_u32(a);
  int row = tid >> 3;
  int bi = row / w, bj = row - bi * w;
  while (row < rows) {
    uint4 lo[U], hi[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      at[u] = row;
      const bool in = row < rows && ok(bi, bj);
      const uint4* p = src(bi, bj);
      lo[u] = in ? __ldg(p) : make_uint4(0, 0, 0, 0);
      hi[u] = in && quantize ? __ldg(p + 1) : make_uint4(0, 0, 0, 0);
      row += rstep;
      for (bj += rstep; bj >= w; bj -= w) ++bi;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = at[u];
      if (r >= rows) break;
      const uint4 v = quantize ? quant(lo[u], hi[u]) : lo[u];
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                       base + r * 128 + ((chunk ^ (r & 7)) << 4)),
                   "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
}

template <class P>
__device__ __forceinline__ void consume(const P& p, const Ring<P>& r,
                                        int cg) {
  const bool leader = (threadIdx.x & 31) == 0;
  const int a_row0 = P::SPLIT_N || P::PINGPONG ? 0 : cg * 64 * P::MI;
  const int b_off = (P::SPLIT_N ? cg * P::NI : 0) * 128;
  uint8_t* scratch = r.scratch(cg * 4 + ((threadIdx.x >> 5) & 3));
  using Acc = typename P::Acc;
  Acc acc[P::SIDES][P::MI][P::NI / 2];
  Pos<P::A_STAGES> a;
  Pos<P::B_STAGES> b;
  // the wgmma group in flight: its B stage, and its A slot when it is the
  // slot's last tap (else -1)
  int prev_b = -1, prev_a = -1;
  auto release = [&]() {
    if (leader && prev_b >= 0) {
      mbar_arrive(r.b_empty(prev_b));
      if (prev_a >= 0) mbar_arrive(r.a_empty(prev_a));
    }
  };
  int i = 0;  // the block's tile count: ping-pong gives tile i to i % 2
  for (int t = blockIdx.x; t < p.tiles(); t += gridDim.x, ++i) {
    if (P::PINGPONG && (i & 1) != cg) {  // the other consumer's tile
      for (int kb = 0; kb < p.k_blocks(); ++kb) {
        a.next();
        for (int tap = 0; tap < P::TAPS; ++tap) b.next();
      }
      continue;
    }
    // ping-pong: wait until the other consumer has waited for every stage
    // of tile i - 1, so that no wait below runs two phases ahead of its
    // barrier (a parity wait would take that phase for completed)
    if (P::PINGPONG && i > 0) mbar_wait(r.done(cg ^ 1), ((i - 1) >> 1) & 1);
    for (int kb = 0; kb < p.k_blocks(); ++kb) {
      mbar_wait(r.a_full(a.stage), a.phase);
      for (int tap = 0; tap < P::TAPS; ++tap) {
        mbar_wait(r.b_full(b.stage), b.phase);
        const uint64_t da =
            sw128_desc(r.a(a.stage) + (p.a_row(tap) + a_row0) * 128);
        const uint64_t db = P::B_MN ? sw128_mn_desc(r.b(b.stage) + b_off)
                                    : sw128_desc(r.b(b.stage) + b_off);
        constexpr int b_step = P::B_MN ? 2048 >> 4 : 2;  // one k-step
        // the K blocks of one side into d; `more`: d already holds a sum
        auto mma = [&](Acc (&d)[P::MI][P::NI / 2], bool more) {
#pragma unroll
          for (int ks = 0; ks < KSteps<P>::value; ++ks)
#pragma unroll
            for (int mi = 0; mi < P::MI; ++mi)
              wgmma_step<P::NI, P::B_MN>(d[mi], da + 512 * mi + 2 * ks,
                                         db + b_step * ks,
                                         (more || ks > 0) ? 1 : 0);
        };
#pragma unroll
        for (int s = 0; s < P::SIDES; ++s)
#pragma unroll
          for (int mi = 0; mi < P::MI; ++mi) fence_acc(acc[s][mi]);
        wgmma_fence();
        if constexpr (P::SIDES == 1) {
          mma(acc[0], kb > 0 || tap > 0);
        } else if (kb < p.kps) {
          mma(acc[0], kb > 0 || tap > 0);
        } else {
          mma(acc[P::SIDES - 1], kb > p.kps || tap > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        release();
        prev_b = b.stage;
        prev_a = tap == P::TAPS - 1 ? a.stage : -1;
        b.next();
      }
      a.next();
    }
    if (P::PINGPONG && leader) mbar_arrive(r.done(cg));
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < P::SIDES; ++s)
#pragma unroll
      for (int mi = 0; mi < P::MI; ++mi) fence_acc(acc[s][mi]);
    release();
    prev_b = -1;
    if constexpr (P::SIDES == 1)
      p.store(t, cg, acc[0], scratch, r.stage() + cg * (P::STAGE_BYTES / 2));
    else
      p.store(t, cg, acc[0], acc[P::SIDES - 1], scratch,
              r.stage() + cg * (P::STAGE_BYTES / 2));
  }
  // a consumer's TMA stores must have read its staging before it exits
  if constexpr (P::STAGE_BYTES > 0)
    if ((threadIdx.x & 127) == 0) bulk_wait_read();
}

// The kernel body: barriers, then the two roles in one if/else that never
// rejoins (setmaxnreg needs it so).
extern __shared__ uint8_t dyn_smem[];

template <class P>
__device__ __forceinline__ void run(const P& p) {
  const Ring<P> r(dyn_smem);
  if (threadIdx.x == 0) {
    // empty barriers count lane 0 of each consumer warp that reads the
    // stage (both consumers', or one's in ping-pong); an A slot's full
    // barrier the producer thread and, where the problem gathers, the
    // three gather warps
    constexpr int consumer_warps = P::PINGPONG ? 4 : 8;
    for (int s = 0; s < P::A_STAGES; ++s) {
      mbar_init(r.a_full(s), P::GATHER ? 4 : 1);
      mbar_init(r.a_empty(s), consumer_warps);
    }
    for (int s = 0; s < P::B_STAGES; ++s) {
      mbar_init(r.b_full(s), 1);
      mbar_init(r.b_empty(s), consumer_warps);
    }
    mbar_init(r.done(0), 4);
    mbar_init(r.done(1), 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        P::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      p.prefetch();
      produce(p, r);
    } else if constexpr (P::GATHER) {
      if (threadIdx.x >= 32) gather(p, r);
    }
  } else {
    constexpr int regs = consumer_regs(P::PRODUCER_REGS);
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(regs));
    consume(p, r, threadIdx.x / 128 - 1);
  }
}

// Launch one persistent block per SM (at most one per tile); returns the
// cudaError_t of the launch.
template <class P>
int launch(void (*kernel)(P), const P& p, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<P>());
  if (e != cudaSuccess) return (int)e;
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  kernel<<<grid, kThreads, smem_bytes<P>(), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace sm90
