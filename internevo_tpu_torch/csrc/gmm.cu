// Grouped matmul for the dropless MoE on Hopper (sm_90a): the expert products
// over rows sorted by expert, forward (gmm), input grad (gmm with the rhs
// transposed) and weight grad (tgmm).
//
// Replaces: internevo_tpu/ops/pallas/gmm.py::_gmm_kernel (gmm, both
// transpose_rhs settings) and ::_tgmm_kernel (tgmm).
//
//   gmm:   out[i, :] = x[i, :] @ w[g(i)]       w[g] (K, F), row-major
//          out[i, :] = x[i, :] @ w[g(i)]^T     transpose_rhs: w[g] (F, K)
//   tgmm:  dw[e] = sum_{i in e} x[i]^T dy[i]   (E, K, F), T or fp32
//
// The operands are of one 16-bit type T, bf16 or f16 (the TPU kernel takes
// x's dtype), and every output is T or fp32: each kind is instantiated for
// both types and both outputs.
//
// g(i) is the group whose rows [start, end) hold row i.  The ends come in as
// the cumulative sum of group_sizes (int32, on the device); rows past the last
// end belong to the last group, as the TPU kernel's padded rows do
// (gmm.py::_metadata).  An empty group's dw is exactly 0.
//
// What bounds it on this card: at the 7B MoE training shapes (8192 routed
// rows, 4096 <-> 11008, 4 experts) each call is 0.74 TFLOP over 0.2-0.6 GB,
// so the tensor cores are the limit (0.75 ms at the bf16 peak against at most
// 0.2 ms of bytes).  The three products are one Hopper mainloop that keeps
// them fed (gmm_body<KIND, OutT>): a persistent, warp-specialised kernel of
// 384 threads, one block per SM.  Warpgroup 0 is the producer: one thread
// starts TMA loads (128-byte swizzle) of 64-deep contraction slices into a
// ring of 4 stages (48 KB each) with a full and an empty mbarrier a stage.
// Warpgroups 1 and 2 are consumers: each owns 64 of the item's 128 output
// rows and runs wgmma m64n256k16 (T in, fp32 accumulate, 128 registers a
// thread) on both operands in shared memory.  One wgmma group stays in flight
// while the previous stage is released.  setmaxnreg gives the consumers 232
// registers and the producer 40.  While the consumers store one item, the
// producer already loads the next.
//
// A work item is a 128 x 256 output tile, and each block derives the item
// list itself from the device group ends (no host metadata, no host sync),
// walking items blockIdx.x, blockIdx.x + gridDim.x, ... in bands of 8 row
// tiles swept across the column tiles, so that a band's operand panels stay
// in L2.  The products differ only in what an item is and how its operands
// lie:
//
//   gmm    item (group e, 128-row m-tile, n-tile) for every m-tile that
//          overlaps e's rows; contraction over K.  A is x, K-major: a 64 x 128
//          box of a 2-D map (K, n).  B is w[e] from a 3-D map whose expert is
//          a coordinate (a contraction tail zero-fills inside the expert):
//          MN-major in the forward (its rows are the contraction), four 64 x 64
//          boxes; K-major with transpose_rhs, one 64 x 256 box.  A tile that
//          straddles a group boundary is computed once for each group it
//          overlaps, and each pass stores only its group's rows.
//   tgmm   item (expert e, 128-row tile of K, n-tile) for every expert; the
//          contraction runs over e's rows [lo, hi) in 64-row slices from lo.
//          Both operands are MN-major: A = x^T is two 64 x 64 boxes of the map
//          (K, n), B = dy four 64 x 64 boxes of the map (F, n).  TMA zero-fills
//          only past n, so in a group's last slice each consumer zeroes the x
//          rows at or past hi in its own box (as the TPU kernel masks x, not
//          dy) before its wgmma reads them.  An empty group's items run no
//          slice and store zeros.
//
// A consumer whose 64 rows all belong to the item's output (its group's rows
// in gmm; any rows inside K in tgmm, where a tile lies wholly in one expert)
// writes them as T with stmatrix into a swizzled staging buffer and one
// thread stores it by TMA, asynchronously, so the stores overlap the next
// item's mainloop.  Other rows (a gmm tile straddling a group boundary) and
// fp32 outputs are stored directly.  Each output element is an fp32 sum over
// its own group's rows only, rounded once at the store, so tgmm's T dw is
// bit for bit the rounding of its fp32 dw.  Every output element is written
// once, by one item: no atomics, and the result is deterministic.

#include "hopper.cuh"

namespace {

enum Kind { GMM = 0, GMM_DGRAD = 1, TGMM = 2 };

constexpr int BAND = 8;                             // row tiles per band of the item order
constexpr int GMM_BM = 128;                         // output rows an item (two consumer warpgroups of 64)
constexpr int GMM_BN = 256;                         // output columns an item (one wgmma n256)
constexpr int GMM_BK = 64;                          // contraction slice: 128 bytes of T, one swizzle row
constexpr int GMM_STAGES = 4;
constexpr int GMM_A_BYTES = GMM_BM * GMM_BK * 2;    // 16 KB
constexpr int GMM_B_BYTES = GMM_BK * GMM_BN * 2;    // 32 KB
constexpr int GMM_BOX = BOX;                        // 8 KB: a 64 x 64 box of T, one 128-byte line a row
constexpr int GMM_THREADS = 384;                    // producer warpgroup + 2 consumer warpgroups
constexpr int GMM_CONSUMER_WARPS = 8;
constexpr int GMM_OUT_BYTES = 2 * GMM_BOX;          // a consumer's staging: half its 64 x 256 rows at a time
constexpr int GMM_SMEM = GMM_STAGES * (GMM_A_BYTES + GMM_B_BYTES) + 2 * GMM_OUT_BYTES + 2 * GMM_STAGES * 8 +
                         1024;  // ring, staging, barriers, alignment
static_assert(GMM_SMEM <= 232448, "the ring and the staging fit a block's shared memory");

// gmm: out (n, F) from x (n, K) and w; tgmm: out (E, K, F) from x (n, K) and
// dy (n, F).
struct GmmParams {
  const int* cum;     // (E,) cumulative group sizes
  void* out;          // T or fp32
  int n, K, F, E;
};

// Tile (tm, tn) of linear id t in a grid of tiles_m x tiles_n, in bands of
// BAND row tiles swept column by column.
__device__ __forceinline__ void band_order(int t, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int width = BAND * tiles_n;
  const int first = (t / width) * BAND;
  const int rows = min(tiles_m - first, BAND);
  tm = first + (t % width) % rows;
  tn = (t % width) / rows;
}

__device__ __forceinline__ void consumer_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");  // barrier 0 is __syncthreads
}

// Zeroes rows [valid, 64) of a consumer's 64 x 64 A box, one whole 128-byte
// line a row (so the swizzle does not matter), and makes the zeros visible to
// the wgmma that reads the box next.  valid is the same in the whole warpgroup.
__device__ __forceinline__ void zero_rows(uint32_t box, int valid, int cw) {
  for (int i = 8 * valid + threadIdx.x % 128; i < 64 * 8; i += 128)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(box + 16 * i), "r"(0), "r"(0), "r"(0), "r"(0)
                 : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync(cw);
}

// d (64 x 256, fp32) += A (64 x 16) @ B (16 x 256), both of T; each operand
// K-major (0) or MN-major (1).  scale_d 0 overwrites d.
#define GMM_M64N256K16(TY)                                                          \
  asm volatile(                                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" HOPPER_WGMMA(256, TY) "{"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, " \
      "%88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, " \
      "%104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127}, " \
      "%128, %129, p, 1, 1, %131, %132;\n}\n" \
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24), HOPPER_ACC8(d, 32), \
        HOPPER_ACC8(d, 40), HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56), HOPPER_ACC8(d, 64), HOPPER_ACC8(d, 72), \
        HOPPER_ACC8(d, 80), HOPPER_ACC8(d, 88), HOPPER_ACC8(d, 96), HOPPER_ACC8(d, 104), HOPPER_ACC8(d, 112), \
        HOPPER_ACC8(d, 120) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B))
template <int TRANS_A, int TRANS_B, typename T>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (is_f16<T>()) {
    GMM_M64N256K16("f16");
  } else {
    GMM_M64N256K16("bf16");
  }
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

// Rows [lo, hi) of group e under gmm_pair's cut.
__device__ __forceinline__ void group_rows(const int* cum, int E, int n, int e, int& lo, int& hi) {
  int end = 0;
  for (int g = 0; g <= e; ++g) {
    lo = end;
    end = g == E - 1 ? n : min(n, max(lo, __ldg(cum + g)));
  }
  hi = end;
}

// The item grid: tiles_m row tiles (gmm: (group, m-tile) pairs; tgmm: tiles of
// K, for each expert) by tiles_n column tiles.
struct Walk {
  int tiles_m, tiles_n, items;
};

// One work item: group e, the output tile at (row0, col0), and its contraction
// (slices of 64 from k0); [lo, hi) are group e's rows.
struct Item {
  int e, row0, col0, k0, slices, lo, hi;
};

template <int KIND>
__device__ __forceinline__ Walk make_walk(const GmmParams& p) {
  Walk w;
  int e, mt, lo, hi;
  w.tiles_n = (p.F + GMM_BN - 1) / GMM_BN;
  w.tiles_m = KIND == TGMM ? (p.K + GMM_BM - 1) / GMM_BM : gmm_pair(p.cum, p.E, p.n, -1, e, mt, lo, hi);
  w.items = (KIND == TGMM ? p.E : 1) * w.tiles_m * w.tiles_n;
  return w;
}

// Item t: gmm walks its pairs in bands; tgmm walks each expert's tiles in
// bands, expert by expert.  ops/cuda/gmm.py::tgmm_work_items is tgmm's twin.
template <int KIND>
__device__ __forceinline__ Item work_item(const GmmParams& p, const Walk& w, int t) {
  Item it;
  const int per = w.tiles_m * w.tiles_n;
  int tm, tn;
  band_order(t % per, w.tiles_m, w.tiles_n, tm, tn);
  it.col0 = tn * GMM_BN;
  if (KIND == TGMM) {
    it.e = t / per;
    group_rows(p.cum, p.E, p.n, it.e, it.lo, it.hi);
    it.row0 = tm * GMM_BM;
    it.k0 = it.lo;
    it.slices = (it.hi - it.lo + GMM_BK - 1) / GMM_BK;  // 0 for an empty group
  } else {
    int mt;
    gmm_pair(p.cum, p.E, p.n, tm, it.e, mt, it.lo, it.hi);
    it.row0 = mt * GMM_BM;
    it.k0 = 0;
    it.slices = (p.K + GMM_BK - 1) / GMM_BK;
  }
  return it;
}

__device__ __forceinline__ void store_pair(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<bf16>(a, b);
}

__device__ __forceinline__ void store_pair(f16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<f16>(a, b);
}

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// ta: x (gmm: 64 x 128 boxes of (K, n); tgmm: 64 x 64 boxes of (K, n)).  tb:
// gmm forward w (F, K, E), 64 x 64 boxes; transpose_rhs w (K, F, E), a 64 x
// 256 box; tgmm dy (F, n, 1), 64 x 64 boxes.  tout: the output of T, 64 x
// 64 boxes of (F, n, 1) (gmm) or (F, K, E) (tgmm).
template <int KIND, typename T, typename OutT>
__device__ __forceinline__ void gmm_body(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tout,
                                         const GmmParams& p) {
  constexpr bool A_MN = KIND == TGMM;       // A = x^T: its rows are the contraction
  constexpr bool B_MN = KIND != GMM_DGRAD;  // w[e] (K, F) or dy: rows are the contraction
  // ring: A stages, then B stages, then the staging buffers, then the full and
  // empty barriers; every tile on a 1024-byte boundary, as the 128-byte
  // swizzle needs
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

  const Walk w = make_walk<KIND>(p);
  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < w.items; t += gridDim.x) {
        const Item it = work_item<KIND>(p, w, t);
        // the 64-wide boxes that start past the output's edge are skipped
        // (their rows or columns are never stored); a partial box is zero-filled
        const int a_boxes = A_MN ? min(2, (p.K - it.row0 + 63) / 64) : 1;
        const int b_boxes = B_MN ? min(GMM_BN / 64, (p.F - it.col0 + 63) / 64) : 1;
        const uint32_t bytes = (A_MN ? a_boxes * GMM_BOX : GMM_A_BYTES) + (B_MN ? b_boxes * GMM_BOX : GMM_B_BYTES);
        for (int s = 0; s < it.slices; ++s) {
          const int k = it.k0 + s * GMM_BK;
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), bytes);
          const uint32_t a = a_ring + stage * GMM_A_BYTES, b = b_ring + stage * GMM_B_BYTES;
          if (A_MN) {
            for (int j = 0; j < a_boxes; ++j) tma_load_2d(a + j * GMM_BOX, &ta, it.row0 + 64 * j, k, full(stage));
          } else {
            tma_load_2d(a, &ta, k, it.row0, full(stage));
          }
          if (B_MN) {
            for (int j = 0; j < b_boxes; ++j)
              tma_load_3d(b + j * GMM_BOX, &tb, it.col0 + 64 * j, k, KIND == TGMM ? 0 : it.e, full(stage));
          } else {
            tma_load_3d(b, &tb, k, it.col0, it.e, full(stage));
          }
          if (++stage == GMM_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups: output rows [64 * cw, 64 * cw + 64) of each item,
    // from the A rows (gmm) or the A box (tgmm) at the same 8 KB offset
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    OutT* out = static_cast<OutT*>(p.out);
    int stage = 0;
    uint32_t phase = 0;
    float acc[128];
    for (int t = blockIdx.x; t < w.items; t += gridDim.x) {
      const Item it = work_item<KIND>(p, w, t);
      int prev = 0;
      for (int s = 0; s < it.slices; ++s) {
        mbar_wait(full(stage), phase);
        const uint32_t a = a_ring + stage * GMM_A_BYTES + cw * (GMM_A_BYTES / 2);
        const uint32_t b = b_ring + stage * GMM_B_BYTES;
        if (KIND == TGMM) {  // the group's last slice: x rows past hi are another group's
          const int valid = it.hi - (it.k0 + s * GMM_BK);
          if (valid < GMM_BK) zero_rows(a, valid, cw);
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < GMM_BK / 16; ++k)
          wgmma_m64n256k16<A_MN, B_MN, T>(acc, box_desc<A_MN>(a, k), box_desc<B_MN>(b, k), (s | k) != 0);
        wgmma_commit();
        fence_regs(acc);
        if (s > 0) {  // the previous stage's wgmma group is done: release it
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty(prev));
        }
        prev = stage;
        if (++stage == GMM_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // unconditional, as every wgmma wait is kept out of divergent paths: a
      // conditional one makes the compiler serialise the mainloop's wgmmas
      wgmma_wait<0>();
      fence_regs(acc);
      if (it.slices > 0 && lane == 0) mbar_arrive(empty(prev));
      const bool live = it.slices > 0;  // else an empty group's dw: zeros
      auto v = [&](int i) { return live ? acc[i] : 0.f; };

      // accumulator (row, col) of register 4i + {0, 1, 2, 3}: rows r and r + 8,
      // columns c + 8i + {0, 1}.  gmm stores only group e's rows of (n, F);
      // tgmm the rows inside K of expert e's (K, F)
      const int r_first = it.row0 + 64 * cw;  // this warpgroup's 64 rows
      const int r = r_first + 16 * warp + lane / 4;
      const int c = it.col0 + 2 * (lane % 4);
      const int rows = KIND == TGMM ? p.K : p.n;
      const int row_lo = KIND == TGMM ? 0 : it.lo, row_hi = KIND == TGMM ? p.K : it.hi;
      if (sizeof(OutT) == 2 && row_lo <= r_first && r_first < row_hi && min(r_first + 64, rows) <= row_hi) {
        // rows wholly in the output: T through shared memory, in two halves
        // of 128 columns, each two 64 x 64 boxes in the 128-byte swizzle that
        // a TMA store reads; rows and columns past the output's edge are
        // clipped by the tensor map.  Overlaps the next item's mainloop.
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
            const uint32_t addr = buf + (block / 8) * GMM_BOX + row * 128 + (((block % 8) ^ rr) << 4);
            stmatrix_x4(addr, pack2<T>(v(4 * i), v(4 * i + 1)), pack2<T>(v(4 * i + 2), v(4 * i + 3)),
                        pack2<T>(v(4 * i + 4), v(4 * i + 5)), pack2<T>(v(4 * i + 6), v(4 * i + 7)));
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA store
          consumer_sync(cw);
          if (threadIdx.x % 128 == 0) {
            for (int b = 0; b < 2; ++b) {
              const int col = it.col0 + 128 * half + 64 * b;
              if (col < p.F) tma_store_3d(&tout, buf + b * GMM_BOX, col, r_first, KIND == TGMM ? it.e : 0);
            }
            bulk_commit();
          }
        }
      } else {
        const bool row0 = r >= row_lo && r < row_hi, row1 = r + 8 >= row_lo && r + 8 < row_hi;
        OutT* o0 = out + (static_cast<size_t>(KIND == TGMM ? it.e : 0) * p.K + r) * p.F;
        OutT* o1 = o0 + static_cast<size_t>(8) * p.F;
#pragma unroll
        for (int i = 0; i < GMM_BN / 8; ++i) {
          const int col = c + 8 * i;
          if (col < p.F) {  // F is a multiple of 8, so col + 1 < F too
            if (row0) store_pair(o0 + col, v(4 * i), v(4 * i + 1));
            if (row1) store_pair(o1 + col, v(4 * i + 2), v(4 * i + 3));
          }
        }
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait();  // the block's shared memory outlives its stores
  }
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(GMM_THREADS, 1)
    gmm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tout, GmmParams p) {
  gmm_body<GMM, T, OutT>(ta, tb, tout, p);
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(GMM_THREADS, 1)
    gmm_dgrad_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tout, GmmParams p) {
  gmm_body<GMM_DGRAD, T, OutT>(ta, tb, tout, p);
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(GMM_THREADS, 1)
    tgmm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tout, GmmParams p) {
  gmm_body<TGMM, T, OutT>(ta, tb, tout, p);
}

// ---------------------------------------------------------------- host side

// The twelve instantiations, 6 * (f16) + 2 * kind + (fp32 out); each gets
// its dynamic shared memory limit raised once a device, before its first
// launch there.
constexpr int MAX_DEVICES = 64;
#define GMM_KERNELS(T)                                                                                       \
  (const void*)gmm_kernel<T, T>, (const void*)gmm_kernel<T, float>, (const void*)gmm_dgrad_kernel<T, T>,     \
      (const void*)gmm_dgrad_kernel<T, float>, (const void*)tgmm_kernel<T, T>, (const void*)tgmm_kernel<T, float>
const void* gmm_kernels[12] = {GMM_KERNELS(bf16), GMM_KERNELS(f16)};
bool gmm_smem_set[12][MAX_DEVICES];

// One persistent block a SM, at most one an item.
int launch(int which, CUtensorMap ta, CUtensorMap tb, CUtensorMap tout, GmmParams p, long long items,
           void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!gmm_smem_set[which][dev]) {
    err = cudaFuncSetAttribute(gmm_kernels[which], cudaFuncAttributeMaxDynamicSharedMemorySize, GMM_SMEM);
    if (err != cudaSuccess) return (int)err;
    gmm_smem_set[which][dev] = true;
  }
  void* args[4] = {&ta, &tb, &tout, &p};
  const int grid = (int)(items < sms ? items : sms);
  err = cudaLaunchKernel(gmm_kernels[which], dim3(grid), dim3(GMM_THREADS), args, GMM_SMEM,
                         static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// out (n, F) from x (n, K) and w; see the entry points.
template <typename T>
int run_gmm(const void* x, const void* w, const int* cum, void* out, int n, int K, int F, int E, int transpose_rhs,
            int out_f32, void* stream) {
  if (n <= 0 || K <= 0 || F <= 0 || E <= 0 || K % 8 || F % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tout;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)n};
  const cuuint32_t x_box[2] = {GMM_BK, GMM_BM};
  // w: (E, F, K) with transpose_rhs, a 64 (K) x 256 (F) box; else (E, K, F),
  // four 64 (F) x 64 (K) boxes a stage.  The expert is the outer coordinate.
  const cuuint64_t wt_dims[3] = {(cuuint64_t)K, (cuuint64_t)F, (cuuint64_t)E};
  const cuuint32_t wt_box[3] = {GMM_BK, GMM_BN, 1};
  const cuuint64_t w_dims[3] = {(cuuint64_t)F, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint32_t w_box[3] = {64, GMM_BK, 1};
  // out (T): 64 x 64 boxes for the TMA store of tiles wholly in one group;
  // an fp32 out is stored directly and passes x's map in its place
  const cuuint64_t out_dims[3] = {(cuuint64_t)F, (cuuint64_t)n, 1};
  const cuuint32_t out_box[3] = {64, 64, 1};
  if (!encode<T>(&ta, x, 2, x_dims, x_box) ||
      !encode<T>(&tb, w, 3, transpose_rhs ? wt_dims : w_dims, transpose_rhs ? wt_box : w_box) ||
      !(out_f32 || encode<T>(&tout, out, 3, out_dims, out_box)))
    return (int)cudaErrorInvalidValue;
  if (out_f32) tout = ta;

  const GmmParams p = {cum, out, n, K, F, E};
  // at most (m-tiles + E - 1) x n-tiles items: a group boundary inside an
  // m-tile adds one
  const long long items = ((n + GMM_BM - 1) / GMM_BM + E - 1) * (long long)((F + GMM_BN - 1) / GMM_BN);
  return launch(6 * is_f16<T>() + 2 * (transpose_rhs != 0) + (out_f32 != 0), ta, tb, tout, p, items, stream);
}

// dw (E, K, N) from x (n, K) and dy (n, N); see the entry points.
template <typename T>
int run_tgmm(const void* x, const void* dy, const int* cum, void* out, int n, int K, int N, int E, int out_f32,
             void* stream) {
  if (n <= 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tout;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)n};
  const cuuint64_t dy_dims[3] = {(cuuint64_t)N, (cuuint64_t)n, 1};
  const cuuint64_t out_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint32_t box[3] = {64, 64, 1};
  if (!encode<T>(&ta, x, 2, x_dims, box) || !encode<T>(&tb, dy, 3, dy_dims, box) ||
      !(out_f32 || encode<T>(&tout, out, 3, out_dims, box)))
    return (int)cudaErrorInvalidValue;
  if (out_f32) tout = ta;

  const GmmParams p = {cum, out, n, K, N, E};
  const long long items = (long long)E * ((K + GMM_BM - 1) / GMM_BM) * ((N + GMM_BN - 1) / GMM_BN);
  return launch(6 * is_f16<T>() + 4 + (out_f32 != 0), ta, tb, tout, p, items, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes), one per operand type, bf16 or
// f16.  Each returns a cudaError_t; 0 is success.  Shapes are checked by the
// Python wrapper (ops/cuda/gmm.py): n > 0, K and F multiples of 8,
// contiguous 16-byte aligned operands (what TMA's strides and base addresses
// need).  out_f32 picks an fp32 output over one of the operands' type.
#define GMM_ARGS                                                                                            \
  const void *x, const void *w, const int *cum, void *out, int n, int K, int F, int E, int transpose_rhs, \
      int out_f32, void *stream
extern "C" int gmm_bf16(GMM_ARGS) { return run_gmm<bf16>(x, w, cum, out, n, K, F, E, transpose_rhs, out_f32, stream); }
extern "C" int gmm_f16(GMM_ARGS) { return run_gmm<f16>(x, w, cum, out, n, K, F, E, transpose_rhs, out_f32, stream); }

// dw (E, K, N) from x (n, K) and dy (n, N); n > 0 (the wrapper gives n = 0
// its zeros without a launch: a tensor map cannot span 0 rows).
#define TGMM_ARGS \
  const void *x, const void *dy, const int *cum, void *out, int n, int K, int N, int E, int out_f32, void *stream
extern "C" int tgmm_bf16(TGMM_ARGS) { return run_tgmm<bf16>(x, dy, cum, out, n, K, N, E, out_f32, stream); }
extern "C" int tgmm_f16(TGMM_ARGS) { return run_tgmm<f16>(x, dy, cum, out, n, K, N, E, out_f32, stream); }
