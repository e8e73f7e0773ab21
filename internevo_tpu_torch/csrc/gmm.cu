// Grouped matmul for the dropless MoE on Hopper (sm_90a): the expert products
// over rows sorted by expert, forward (gmm), input grad (gmm with the rhs
// transposed) and weight grad (tgmm).
//
// Replaces: internevo_tpu/ops/pallas/gmm.py::_gmm_kernel (gmm, both
// transpose_rhs settings) and ::_tgmm_kernel (tgmm).
//
//   gmm:   out[i, :] = x[i, :] @ w[g(i)]       w[g] (Kc, F), row-major
//          out[i, :] = x[i, :] @ w[g(i)]^T     transpose_rhs: w[g] (F, Kc)
//   tgmm:  dw[e] = sum_{i in e} x[i]^T dy[i]   fp32 (E, K, N)
//
// g(i) is the group whose rows [start, end) hold row i.  The ends come in as
// the cumulative sum of group_sizes (int32, on the device); rows past the last
// end belong to the last group, as the TPU kernel's padded rows do
// (gmm.py::_metadata).  An empty group's dw is exactly 0.
//
// What bounds it on this card: at the 7B MoE training shapes (8192 routed
// rows, 4096 <-> 11008, 4 experts) each call is 0.74 TFLOP over ~0.6 GB, so
// the tensor cores are the limit (0.75 ms at the bf16 peak against 0.2 ms of
// bytes).
//
// gmm (forward and transpose_rhs) is one Hopper mainloop: a persistent,
// warp-specialised kernel of 384 threads, one block per SM.  A work item is
// (group e, 128-row m-tile, 256-column n-tile) for every m-tile that overlaps
// e's rows; each block derives the item list itself from the device group
// ends (no host metadata, no host sync) and walks items blockIdx.x,
// blockIdx.x + gridDim.x, ... in bands of 8 m-tiles swept across the n-tiles,
// so that a band's x rows and a w panel stay in L2.  Warpgroup 0 is the
// producer: one thread starts TMA loads (128-byte swizzle) of 64-deep
// contraction slices, x as a 128 x 64 box of a 2-D map (n, Kc) and w[e] from
// a 3-D map whose expert is a coordinate, into a ring of 4 stages (48 KB
// each) with a full and an empty mbarrier a stage.  Warpgroups 1 and 2 are
// consumers: each owns 64 of the tile's rows and runs wgmma m64n256k16
// (bf16 in, fp32 accumulate, 128 registers a thread) on both operands in
// shared memory; x is K-major, w[e] is MN-major in the forward (its rows are
// the contraction) and K-major with transpose_rhs.  One wgmma group stays in
// flight while the previous stage is released.  setmaxnreg gives the
// consumers 232 registers and the producer 40.  A consumer whose 64 rows lie
// wholly in the item's group writes them as bf16 with stmatrix into a
// swizzled staging buffer and one thread stores it by TMA, asynchronously,
// so the stores overlap the next item's mainloop; other rows (a tile that
// straddles a group boundary) and fp32 outputs are stored directly.  While
// the consumers store one item, the producer already loads the next.
//
// A tile that straddles a group boundary is computed once for each group it
// overlaps, with that group's weights, and each pass stores only its group's
// rows: each row's fp32 sum holds only its own group's product and is rounded
// once, at the store.  TMA zero-fills rows past n and a contraction tail
// inside the expert (the 3-D map keeps the next expert's rows out).  An empty
// group has no items.  Every output element is written once, by one item: no
// atomics, and the result is deterministic.
//
// A tgmm block (expert, 128 x 128 tile of dw) walks its group's rows in
// 32-row slices with WMMA bf16 tiles (m16n16k16, fp32 accumulate) and a
// two-stage cp.async pipeline.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;   // output rows per block (K in tgmm)
constexpr int BN = 128;   // output columns per block
constexpr int BK = 32;    // contraction slice (rows in tgmm)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WM = 64;    // warp tile: 2 x 4 warps of 64 x 32
constexpr int WN = 32;
constexpr int FM = WM / 16;
constexpr int FN = WN / 16;
constexpr int BAND = 8;   // row tiles per band of the tile order
constexpr int PAD = 8;    // bf16 padding of each shared row (16 bytes)
constexpr int LDB = BN + PAD;    // tgmm dy slice (BK x BN)
constexpr int LDX = BM + PAD;    // tgmm x slice (BK rows x BM features)

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// gmm: the Hopper mainloop's tile, ring and block
constexpr int GMM_BM = 128;                         // x rows an item (two consumer warpgroups of 64)
constexpr int GMM_BN = 256;                         // output columns an item (one wgmma n256)
constexpr int GMM_BK = 64;                          // contraction slice: 128 bytes of bf16, one swizzle row
constexpr int GMM_STAGES = 4;
constexpr int GMM_A_BYTES = GMM_BM * GMM_BK * 2;    // 16 KB: 128 x-rows of 128 bytes
constexpr int GMM_B_BYTES = GMM_BK * GMM_BN * 2;    // 32 KB
constexpr int GMM_B_CHUNK = GMM_BK * 64 * 2;        // 8 KB: forward w box, 64 k-rows x 64 columns
constexpr int GMM_THREADS = 384;                    // producer warpgroup + 2 consumer warpgroups
constexpr int GMM_CONSUMER_WARPS = 8;
constexpr int GMM_OUT_BOX = 64 * 64 * 2;            // 8 KB: a bf16 output box, 64 rows x 64 columns
constexpr int GMM_OUT_BYTES = 2 * GMM_OUT_BOX;      // a consumer's staging: half its 64 x 256 rows at a time
constexpr int GMM_SMEM = GMM_STAGES * (GMM_A_BYTES + GMM_B_BYTES) + 2 * GMM_OUT_BYTES + 2 * GMM_STAGES * 8 +
                         1024;  // ring, staging, barriers, alignment
static_assert(GMM_SMEM <= 232448, "the ring and the staging fit a block's shared memory");

struct GmmParams {
  const int* cum;     // (E,) cumulative group sizes
  void* out;          // (n, F), bf16 or fp32
  int n, Kc, F, E;
};

struct TgmmParams {
  const bf16* x;      // (n, K)
  const bf16* dy;     // (n, N)
  const int* cum;     // (E,)
  float* out;         // (E, K, N)
  int n, K, N, E;
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = pred ? 16 : 0;  // 0: nothing is read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [lo, hi) of group e; the last group also takes every row past the sum.
__device__ __forceinline__ void group_rows(const int* cum, int E, int n, int e, int& lo, int& hi) {
  lo = e == 0 ? 0 : min(cum[e - 1], n);
  hi = e == E - 1 ? n : min(cum[e], n);
}

// Tile (tm, tn) of linear id t in a grid of tiles_m x tiles_n, in bands of
// BAND row tiles swept column by column.
__device__ __forceinline__ void band_order(int t, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int width = BAND * tiles_n;
  const int first = (t / width) * BAND;
  const int rows = min(tiles_m - first, BAND);
  tm = first + (t % width) % rows;
  tn = (t % width) / rows;
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The block's accumulators to out (row stride ld), rows < row_lim and columns
// < col_lim (a multiple of 8), through a 16 x 16 fp32 scratch per warp.
template <typename OutT>
__device__ void store_tile(Acc (&acc)[FM][FN], OutT* out, size_t ld, int r0, int c0, int row_lim, int col_lim,
                           float* scratch, int lane) {
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = r0 + i * 16 + r, col = c0 + j * 16 + c;
      if (row < row_lim && col < col_lim) store8(out + (size_t)row * ld + col, scratch + r * 16 + c);
      __syncwarp();
    }
  }
}

constexpr int TGMM_X_STAGE = BK * LDX;
constexpr int TGMM_Y_STAGE = BK * LDB;
constexpr int TGMM_SMEM = 2 * (TGMM_X_STAGE + TGMM_Y_STAGE) * (int)sizeof(bf16);
static_assert(NWARPS * 256 * sizeof(float) <= TGMM_SMEM, "epilogue scratch reuses the operand stages");

// ---------------------------------------------------------------- gmm (wgmma)

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

// A wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.  Every tile starts on a
// 1024-byte boundary (one swizzle atom: 8 rows of 128 bytes), so the base
// offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Four 8 x 8 bf16 matrices to shared memory: this thread holds (row lane / 4,
// columns 2 (lane % 4) + {0, 1}) of each and gives the address of row lane % 8
// of matrix lane / 8.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0), "r"(r1),
               "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void consumer_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");  // barrier 0 is __syncthreads
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma instructions that own them.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, fp32) += A (64 x 16, K-major) @ B (16 x 256); B is K-major
// (TRANS_B 0) or MN-major (TRANS_B 1).  scale_d 0 overwrites d.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// Group g's rows [lo, hi): the groups cut [0, n) in order at the device ends
// (clamped to [0, n) and never decreasing), and the last group also takes
// every row past the sum.  Returns the number of (group, m-tile) pairs, the
// m-tiles that overlap each non-empty group in group order; fills (e, mt, lo,
// hi) of pair p.  ops/cuda/gmm.py::gmm_work_items is its Python twin.
__device__ __forceinline__ int gmm_pair(const int* cum, int E, int n, int p, int& e, int& mt, int& lo, int& hi) {
  int count = 0, end = 0;
  for (int g = 0; g < E; ++g) {
    const int a = end;
    const int b = g == E - 1 ? n : min(n, max(a, __ldg(cum + g)));
    end = b;
    if (a >= b) continue;
    const int first = a / GMM_BM, tiles = (b - 1) / GMM_BM - first + 1;
    if (p >= count && p < count + tiles) {
      e = g;
      mt = first + p - count;
      lo = a;
      hi = b;
    }
    count += tiles;
  }
  return count;
}

__device__ __forceinline__ void store_pair(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// TRANS: w[e] is (F, Kc) and B K-major (transpose_rhs); else (Kc, F), B MN-major.
template <bool TRANS, typename OutT>
__device__ __forceinline__ void gmm_body(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& tout,
                                         const GmmParams& p) {
  // ring: A stages, then B stages, then the full and empty barriers; every
  // tile on a 1024-byte boundary, as the 128-byte swizzle needs
  extern __shared__ __align__(1024) unsigned char gmm_smem[];
  const uint32_t a_ring = (smem_u32(gmm_smem) + 1023) & ~1023u;
  const uint32_t b_ring = a_ring + GMM_STAGES * GMM_A_BYTES;
  const uint32_t staging = b_ring + GMM_STAGES * GMM_B_BYTES;
  const uint32_t bars = staging + 2 * GMM_OUT_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (GMM_STAGES + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < GMM_STAGES; ++s) {
      mbar_init(full(s), 1);                     // the producer's expect_tx; TMA completes the bytes
      mbar_init(empty(s), GMM_CONSUMER_WARPS);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_n = (p.F + GMM_BN - 1) / GMM_BN;
  const int nk = (p.Kc + GMM_BK - 1) / GMM_BK;
  int e, mt, lo, hi;
  const int pairs = gmm_pair(p.cum, p.E, p.n, -1, e, mt, lo, hi);
  const int items = pairs * tiles_n;

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        int pi, tn;
        band_order(t, pairs, tiles_n, pi, tn);
        gmm_pair(p.cum, p.E, p.n, pi, e, mt, lo, hi);
        const int n0 = tn * GMM_BN;
        // forward: the 64-column boxes that start past F are skipped (their
        // columns are never stored); a partial box is zero-filled
        const int chunks = TRANS ? 1 : min(GMM_BN / 64, (p.F - n0 + 63) / 64);
        const uint32_t bytes = GMM_A_BYTES + (TRANS ? GMM_B_BYTES : chunks * GMM_B_CHUNK);
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), bytes);
          tma_load_2d(a_ring + stage * GMM_A_BYTES, &tx, kb * GMM_BK, mt * GMM_BM, full(stage));
          const uint32_t b = b_ring + stage * GMM_B_BYTES;
          if (TRANS) {
            tma_load_3d(b, &tw, kb * GMM_BK, n0, e, full(stage));
          } else {
            for (int j = 0; j < chunks; ++j)
              tma_load_3d(b + j * GMM_B_CHUNK, &tw, n0 + 64 * j, kb * GMM_BK, e, full(stage));
          }
          if (++stage == GMM_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups: rows [64 * cw, 64 * cw + 64) of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    OutT* out = static_cast<OutT*>(p.out);
    int stage = 0;
    uint32_t phase = 0;
    float acc[128];
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      int pi, tn;
      band_order(t, pairs, tiles_n, pi, tn);
      gmm_pair(p.cum, p.E, p.n, pi, e, mt, lo, hi);
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full(stage), phase);
        const uint32_t a = a_ring + stage * GMM_A_BYTES + cw * (GMM_A_BYTES / 2);
        const uint32_t b = b_ring + stage * GMM_B_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < GMM_BK / 16; ++k) {
          // A: 8-row groups 1024 bytes apart, k advances 32 bytes in the swizzled row.
          // B K-major: the same.  B MN-major: 64-column chunks GMM_B_CHUNK apart (LBO),
          // 8-k-row groups 1024 bytes apart (SBO), k advances 16 rows of 128 bytes
          const uint64_t da = smem_desc(a + 32 * k, 16, 1024);
          const uint64_t db =
              TRANS ? smem_desc(b + 32 * k, 16, 1024) : smem_desc(b + 2048 * k, GMM_B_CHUNK, 1024);
          wgmma_m64n256k16<TRANS ? 0 : 1>(acc, da, db, (kb | k) != 0);
        }
        wgmma_commit();
        fence_acc(acc);
        if (kb > 0) {  // the previous stage's wgmma group is done: release it
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty(prev));
        }
        prev = stage;
        if (++stage == GMM_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty(prev));

      // accumulator (row, col) of register 4i + {0, 1, 2, 3}: rows r and r + 8,
      // columns c + 8i + {0, 1}; only group e's rows are stored
      const int r_first = mt * GMM_BM + 64 * cw;  // this warpgroup's 64 rows
      const int r = r_first + 16 * warp + lane / 4;
      const int c = tn * GMM_BN + 2 * (lane % 4);
      if (sizeof(OutT) == 2 && lo <= r_first && r_first < p.n && min(r_first + 64, p.n) <= hi) {
        // rows wholly in the group: bf16 through shared memory, in two halves
        // of 128 columns, each two 64 x 64 boxes in the 128-byte swizzle that
        // a TMA store reads; rows past n and columns past F are clipped by
        // the tensor map.  Overlaps the next item's mainloop.
        const uint32_t buf = staging + cw * GMM_OUT_BYTES;
        const int m = lane / 8, rr = lane % 8;  // the matrix and row this lane addresses
        const int row = 16 * warp + 8 * (m & 1) + rr;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (threadIdx.x % 128 == 0) bulk_wait_read();  // the last stores from this buffer have read it
          consumer_sync(cw);
#pragma unroll
          for (int j = 0; j < 8; ++j) {  // 8-column blocks 2j, 2j + 1 of this half
            const int i = 16 * half + 2 * j;
            const int block = 2 * j + (m >> 1);  // 0..15 in the half
            const uint32_t addr =
                buf + (block / 8) * GMM_OUT_BOX + row * 128 + (((block % 8) ^ rr) << 4);
            stmatrix_x4(addr, pack_bf16(acc[4 * i], acc[4 * i + 1]), pack_bf16(acc[4 * i + 2], acc[4 * i + 3]),
                        pack_bf16(acc[4 * i + 4], acc[4 * i + 5]), pack_bf16(acc[4 * i + 6], acc[4 * i + 7]));
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA store
          consumer_sync(cw);
          if (threadIdx.x % 128 == 0) {
            for (int b = 0; b < 2; ++b) {
              const int col = tn * GMM_BN + 128 * half + 64 * b;
              if (col < p.F) tma_store_2d(&tout, buf + b * GMM_OUT_BOX, col, r_first);
            }
            bulk_commit();
          }
        }
      } else {
        const bool row0 = r >= lo && r < hi, row1 = r + 8 >= lo && r + 8 < hi;
        OutT* o0 = out + static_cast<size_t>(r) * p.F;
        OutT* o1 = o0 + static_cast<size_t>(8) * p.F;
#pragma unroll
        for (int i = 0; i < GMM_BN / 8; ++i) {
          const int col = c + 8 * i;
          if (col < p.F) {  // F is a multiple of 8, so col + 1 < F too
            if (row0) store_pair(o0 + col, acc[4 * i], acc[4 * i + 1]);
            if (row1) store_pair(o1 + col, acc[4 * i + 2], acc[4 * i + 3]);
          }
        }
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait();  // the block's shared memory outlives its stores
  }
}

template <typename OutT>
__global__ void __launch_bounds__(GMM_THREADS, 1)
    gmm_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tout, GmmParams p) {
  gmm_body<false, OutT>(tx, tw, tout, p);
}

template <typename OutT>
__global__ void __launch_bounds__(GMM_THREADS, 1)
    gmm_dgrad_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tout, GmmParams p) {
  gmm_body<true, OutT>(tx, tw, tout, p);
}

// One stage of tgmm operands: rows [r0, r0 + BK) of the group (< hi) of the
// x feature slice and of the dy column slice.
__device__ __forceinline__ void tgmm_load(const TgmmParams& p, bf16* Xs, bf16* Ys, int k0, int n0, int r0, int hi,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < BK * (BM / 8); i += NTHREADS) {
    const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
    const int row = r0 + r, col = k0 + c;
    const bool ok = row < hi && col < p.K;
    cp_async16(Xs + r * LDX + c, ok ? p.x + (size_t)row * p.K + col : p.x, ok);
  }
#pragma unroll
  for (int i = tid; i < BK * (BN / 8); i += NTHREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int row = r0 + r, col = n0 + c;
    const bool ok = row < hi && col < p.N;
    cp_async16(Ys + r * LDB + c, ok ? p.dy + (size_t)row * p.N + col : p.dy, ok);
  }
}

__device__ __forceinline__ void tgmm_mma(const bf16* Xs, const bf16* Ys, Acc (&acc)[FM][FN], int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    // x^T as a col-major A: element (m, k) = Xs[k * LDX + m]
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[FM];
#pragma unroll
    for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(a[i], Xs + kk * LDX + wm * WM + i * 16, LDX);
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, Ys + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(NTHREADS) tgmm_kernel(TgmmParams p) {
  __shared__ __align__(128) unsigned char smem[TGMM_SMEM];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ys = Xs + 2 * TGMM_X_STAGE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int tiles_k = (p.K + BM - 1) / BM, tiles_n = (p.N + BN - 1) / BN;
  const int per_expert = tiles_k * tiles_n;
  const int e = blockIdx.x / per_expert;
  int tk, tn;
  band_order(blockIdx.x % per_expert, tiles_k, tiles_n, tk, tn);
  const int k0 = tk * BM, n0 = tn * BN;
  int lo, hi;
  group_rows(p.cum, p.E, p.n, e, lo, hi);
  const int nr = hi > lo ? (hi - lo + BK - 1) / BK : 0;  // an empty group runs no slice

  Acc acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (nr > 0) {
    tgmm_load(p, Xs, Ys, k0, n0, lo, hi, tid);
    cp_async_commit();
    for (int t = 0; t < nr; ++t) {
      const int cur = t & 1;
      if (t + 1 < nr) {
        tgmm_load(p, Xs + (cur ^ 1) * TGMM_X_STAGE, Ys + (cur ^ 1) * TGMM_Y_STAGE, k0, n0, lo + (t + 1) * BK, hi,
                  tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      tgmm_mma(Xs + cur * TGMM_X_STAGE, Ys + cur * TGMM_Y_STAGE, acc, wm, wn);
      __syncthreads();
    }
  }

  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  store_tile<float>(acc, p.out + (size_t)e * p.K * p.N, (size_t)p.N, k0 + wm * WM, n0 + wn * WN, p.K, p.N, scratch,
                    lane);
}

// ---------------------------------------------------------------- host side

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime, so that
// the library needs no -lcuda.
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

// A bf16 tensor map with 128-byte swizzle; dims and box innermost first,
// strides in bytes of every dim but the innermost.  Elements out of bounds
// read as zero.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The four gmm instantiations; each gets its dynamic shared memory limit
// raised once a device, before its first launch there.
constexpr int MAX_DEVICES = 64;
const void* gmm_kernels[4] = {(const void*)gmm_kernel<bf16>, (const void*)gmm_kernel<float>,
                              (const void*)gmm_dgrad_kernel<bf16>, (const void*)gmm_dgrad_kernel<float>};
bool gmm_smem_set[4][MAX_DEVICES];

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns a cudaError_t; 0 is
// success.  Shapes are checked by the Python wrapper (ops/cuda/gmm.py): n > 0,
// Kc, F, K and N multiples of 8, contiguous 16-byte aligned operands (what
// TMA's strides and base addresses need).
extern "C" int gmm_bf16(const void* x, const void* w, const int* cum, void* out, int n, int Kc, int F, int E,
                        int transpose_rhs, int out_f32, void* stream) {
  if (n <= 0 || Kc <= 0 || F <= 0 || E <= 0 || Kc % 8 || F % 8) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;

  const size_t b = sizeof(bf16);
  CUtensorMap tx, tw, tout;
  const cuuint64_t x_dims[2] = {(cuuint64_t)Kc, (cuuint64_t)n};
  const cuuint64_t x_strides[1] = {(cuuint64_t)Kc * b};
  const cuuint32_t x_box[2] = {GMM_BK, GMM_BM};
  // w: (E, F, Kc) with transpose_rhs, a 64 (Kc) x 256 (F) box; else (E, Kc,
  // F), four 64 (F) x 64 (Kc) boxes a stage.  The expert is the outer coordinate.
  const cuuint64_t wt_dims[3] = {(cuuint64_t)Kc, (cuuint64_t)F, (cuuint64_t)E};
  const cuuint64_t wt_strides[2] = {(cuuint64_t)Kc * b, (cuuint64_t)Kc * F * b};
  const cuuint32_t wt_box[3] = {GMM_BK, GMM_BN, 1};
  const cuuint64_t w_dims[3] = {(cuuint64_t)F, (cuuint64_t)Kc, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)F * b, (cuuint64_t)Kc * F * b};
  const cuuint32_t w_box[3] = {64, GMM_BK, 1};
  if (!encode(fn, &tx, x, 2, x_dims, x_strides, x_box) ||
      !encode(fn, &tw, w, 3, transpose_rhs ? wt_dims : w_dims, transpose_rhs ? wt_strides : w_strides,
              transpose_rhs ? wt_box : w_box))
    return (int)cudaErrorInvalidValue;
  // out (bf16): 64 x 64 boxes for the TMA store of tiles wholly in one group;
  // an fp32 out is stored directly and passes x's map in its place
  const cuuint64_t out_dims[2] = {(cuuint64_t)F, (cuuint64_t)n};
  const cuuint64_t out_strides[1] = {(cuuint64_t)F * b};
  const cuuint32_t out_box[2] = {64, 64};
  if (out_f32)
    tout = tx;
  else if (!encode(fn, &tout, out, 2, out_dims, out_strides, out_box))
    return (int)cudaErrorInvalidValue;

  GmmParams p;
  p.cum = cum;
  p.out = out;
  p.n = n;
  p.Kc = Kc;
  p.F = F;
  p.E = E;
  const int which = 2 * (transpose_rhs != 0) + (out_f32 != 0);
  if (!gmm_smem_set[which][dev]) {
    err = cudaFuncSetAttribute(gmm_kernels[which], cudaFuncAttributeMaxDynamicSharedMemorySize, GMM_SMEM);
    if (err != cudaSuccess) return (int)err;
    gmm_smem_set[which][dev] = true;
  }
  // at most (m-tiles + E - 1) x n-tiles items: a group boundary inside an
  // m-tile adds one; one persistent block a SM
  const long long tiles_m = (n + GMM_BM - 1) / GMM_BM, tiles_n = (F + GMM_BN - 1) / GMM_BN;
  const long long items = (tiles_m + E - 1) * tiles_n;
  const int grid = (int)(items < sms ? items : sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: gmm_kernel<bf16><<<grid, GMM_THREADS, GMM_SMEM, s>>>(tx, tw, tout, p); break;
    case 1: gmm_kernel<float><<<grid, GMM_THREADS, GMM_SMEM, s>>>(tx, tw, tout, p); break;
    case 2: gmm_dgrad_kernel<bf16><<<grid, GMM_THREADS, GMM_SMEM, s>>>(tx, tw, tout, p); break;
    default: gmm_dgrad_kernel<float><<<grid, GMM_THREADS, GMM_SMEM, s>>>(tx, tw, tout, p); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int tgmm_bf16(const void* x, const void* dy, const int* cum, float* out, int n, int K, int N, int E,
                         void* stream) {
  if (n < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  TgmmParams p;
  p.x = static_cast<const bf16*>(x);
  p.dy = static_cast<const bf16*>(dy);
  p.cum = cum;
  p.out = out;
  p.n = n;
  p.K = K;
  p.N = N;
  p.E = E;
  const dim3 grid(E * ((K + BM - 1) / BM) * ((N + BN - 1) / BN));
  tgmm_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
