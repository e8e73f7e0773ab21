// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA loads and stores, wgmma shared-memory descriptors and the wgmma shapes
// the kernels use, and the host-side tensor-map encoder.  Included by
// gmm.cu and the two splash-attention sources; each builds into its own
// library.  The 16-bit element type T (bf16 or f16) is a template parameter
// of every wrapper that names it: the wgmma kind, the register packs and
// the tensor map's data type.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

template <typename T>
__host__ __device__ constexpr bool is_f16() {
  static_assert(std::is_same<T, bf16>::value || std::is_same<T, f16>::value, "bf16 or f16 operands");
  return std::is_same<T, f16>::value;
}

// ------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// An arrival; it releases this thread's earlier shared-memory writes to the
// threads that wait on the barrier's phase.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// A wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.  Every tile starts on a
// 1024-byte boundary (one swizzle atom: 8 rows of 128 bytes), so the base
// offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor of the 16-deep step k of an operand tile made of 64 x 64
// 16-bit boxes (one 128-byte swizzled line a row, BOX bytes a box).  K-major
// (rows along the contraction, one box a 64-wide slice of it): the slice k /
// 4 is box k / 4, k advances 32 bytes in the swizzled row, 8-row groups 1024
// bytes apart.  MN-major (one row a contraction index, one box a 64-wide
// chunk of the output's rows or columns): chunks BOX apart (LBO), 8-k-row
// groups 1024 bytes apart (SBO), k advances 16 rows of 128 bytes.
constexpr uint32_t BOX = 64 * 64 * 2;  // 8 KB
template <bool MN_MAJOR>
__device__ __forceinline__ uint64_t box_desc(uint32_t tile, int k) {
  return MN_MAJOR ? smem_desc(tile + 2048 * k, BOX, 1024) : smem_desc(tile + (k / 4) * BOX + 32 * (k % 4), 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns (its accumulators, or its A fragments) across the
// wait that ends it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define HOPPER_ACC8(d, i)                                                                                   \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), \
      "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// The wgmma instruction of an (M, N, K) = (64, N, 16) product with fp32
// accumulators, its kind .f32.TY.TY for TY "bf16" or "f16".
#define HOPPER_WGMMA(N, TY) "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "

// d (64 x 64, fp32) += A (64 x 16) @ B (16 x 64), both from shared memory;
// each operand K-major (0) or MN-major (1).  scale_d 0 overwrites d.
#define HOPPER_M64N64K16_SS(TY)                                                  \
  asm volatile(                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" HOPPER_WGMMA(64, TY) "{"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                         \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                   \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                 \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                                 \
      "%32, %33, p, 1, 1, %35, %36;\n}\n"                                        \
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B))
template <int TRANS_A, int TRANS_B, typename T>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (is_f16<T>()) {
    HOPPER_M64N64K16_SS("f16");
  } else {
    HOPPER_M64N64K16_SS("bf16");
  }
}

// d (64 x 32, fp32) += A (64 x 16) @ B (16 x 32), both from shared memory;
// each operand K-major (0) or MN-major (1).  scale_d 0 overwrites d.
#define HOPPER_M64N32K16_SS(TY)                                                  \
  asm volatile(                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" HOPPER_WGMMA(32, TY) "{"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                         \
      "%8, %9, %10, %11, %12, %13, %14, %15}, "                                   \
      "%16, %17, p, 1, 1, %19, %20;\n}\n"                                        \
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8)                                     \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B))
template <int TRANS_A, int TRANS_B, typename T>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (is_f16<T>()) {
    HOPPER_M64N32K16_SS("f16");
  } else {
    HOPPER_M64N32K16_SS("bf16");
  }
}

// d (64 x 64, fp32) += A (64 x 16, 16-bit fragments in registers) @ B (16 x
// 64, shared memory, K-major (0) or MN-major (1)).
#define HOPPER_M64N64K16_RS(TY)                                                  \
  asm volatile(                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" HOPPER_WGMMA(64, TY) "{"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                         \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                   \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                 \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                                 \
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                            \
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B))
template <int TRANS_B, typename T>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                   int scale_d) {
  if constexpr (is_f16<T>()) {
    HOPPER_M64N64K16_RS("f16");
  } else {
    HOPPER_M64N64K16_RS("bf16");
  }
}

// d (64 x 128, fp32) += A (64 x 16, 16-bit fragments in registers) @ B (16 x
// 128, shared memory, K-major (0) or MN-major (1)).
#define HOPPER_M64N128K16_RS(TY)                                                 \
  asm volatile(                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" HOPPER_WGMMA(128, TY) "{"     \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                         \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                   \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                 \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                 \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                 \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                 \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                 \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                                 \
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                            \
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24), HOPPER_ACC8(d, 32), \
        HOPPER_ACC8(d, 40), HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56)               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B))
template <int TRANS_B, typename T>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                    int scale_d) {
  if constexpr (is_f16<T>()) {
    HOPPER_M64N128K16_RS("f16");
  } else {
    HOPPER_M64N128K16_RS("bf16");
  }
}

// d (64 x D) += A (64 x 16, registers) @ B (16 x D, shared memory, MN-major),
// D 64 or 128: the attention kernels' products over a 64-row tile, such as
// O += P V, with P packed from an m64n64 accumulator.
template <int D, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (D == 128) {
    wgmma_m64n128k16_rs<1, T>(d, a, db, scale_d);
  } else {
    wgmma_m64n64k16_rs<1, T>(d, a, db, scale_d);
  }
}

// Four 8 x 8 16-bit matrices to shared memory: this thread holds (row lane / 4,
// columns 2 (lane % 4) + {0, 1}) of each and gives the address of row lane % 8
// of matrix lane / 8.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0), "r"(r1),
               "r"(r2), "r"(r3)
               : "memory");
}

// Four 8 x 8 16-bit matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 and gets (row l / 4, columns 2 (l % 4) + {0, 1})
// of each, as mma and wgmma A fragments take them.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two floats as a T pair (round to nearest even; f16: cvt.rn.f16x2.f32), a
// in the low half: the lower column of an accumulator pair, as wgmma's A
// fragments and stmatrix take it.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (is_f16<T>()) {
    __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// Two floats to T* dst: a T pair (pack2), or for float two floats.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = pack2<T>(a, b);
  }
}

// Two floats as three bf16 pairs, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid), each pair as pack2 lays it out.  The subtractions are
// exact, and the three pieces hold x's 24 significand bits, so hi + mid + lo
// is x wherever the pieces are normal (|x| above about 2^-110): the fp32
// splash kernels' operands of fp32-exact products (splash.cuh, piece_a /
// piece_b).
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = pack2<bf16>(a, b);
  float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  a = __fsub_rn(a, f.x);
  b = __fsub_rn(b, f.y);
  mid = pack2<bf16>(a, b);
  f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&mid));
  lo = pack2<bf16>(__fsub_rn(a, f.x), __fsub_rn(b, f.y));
}

// ---------------------------------------------------------------- host side

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime, so that
// a library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A tensor map of T (bf16 or f16) with 128-byte swizzle over a contiguous
// row-major tensor of rank 2 to 4, dims and box given innermost first.
// Elements out of bounds (a box may be wider than the tensor) read as zero
// and are not written.
template <typename T>
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const cuuint32_t* box) {
  const CUtensorMapDataType type = is_f16<T>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const EncodeTiled fn = encode_tiled();
  cuuint64_t strides[3];
  cuuint64_t stride = 2;
  for (int d = 0; d + 1 < rank; ++d) strides[d] = stride *= dims[d];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn != nullptr && fn(map, type, rank, const_cast<void*>(base), dims, strides,
                             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
