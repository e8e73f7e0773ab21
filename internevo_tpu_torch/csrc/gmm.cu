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
// bytes).  The design keeps the weights' reuse in L2 and the accumulators in
// registers: one block per 128x128 output tile, 8 warps of 64x32 WMMA bf16
// tiles (m16n16k16, fp32 accumulate), a two-stage cp.async pipeline over
// 32-deep slices of the contraction, and tiles ordered in bands of 8 row tiles
// so that a band's rows and a weight column stay in L2 while it is swept.
// A gmm block loops over the few groups its 128 rows overlap and runs its
// contraction once for each, zero-filling the rows of other groups at load:
// each row's fp32 sum then holds only its own group's product (the disjoint
// masked accumulation of the TPU kernel) and is rounded once, at the store.
// A tgmm block (expert, 128 x 128 tile of dw) walks its group's rows in
// 32-row slices.  No atomics and no host sync: the grid depends on the shapes
// only.  wgmma, TMA and split-K over the rows of a skewed group are left for
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;   // output rows per block (x rows in gmm, K in tgmm)
constexpr int BN = 128;   // output columns per block
constexpr int BK = 32;    // contraction slice (features in gmm, rows in tgmm)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WM = 64;    // warp tile: 2 x 4 warps of 64 x 32
constexpr int WN = 32;
constexpr int FM = WM / 16;
constexpr int FN = WN / 16;
constexpr int BAND = 8;   // row tiles per band of the tile order
constexpr int PAD = 8;    // bf16 padding of each shared row (16 bytes)
constexpr int LDA = BK + PAD;    // gmm x slice (BM x BK), row-major
constexpr int LDB = BN + PAD;    // gmm w slice (BK x BN), row-major; tgmm dy slice (BK x BN)
constexpr int LDBT = BK + PAD;   // gmm w slice for transpose_rhs (BN x BK)
constexpr int LDX = BM + PAD;    // tgmm x slice (BK rows x BM features)

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

struct GmmParams {
  const bf16* x;      // (n, Kc)
  const bf16* w;      // (E, Kc, F), or (E, F, Kc) with transpose_rhs
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

__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  uint4 packed;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = packed;
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

// One stage of gmm operands: the x slice (rows of [lo, hi) only) and the w slice.
template <bool TRANS>
__device__ __forceinline__ void gmm_load(const GmmParams& p, const bf16* wg, bf16* As, bf16* Bs, int m0, int n0,
                                         int k0, int lo, int hi, int tid) {
#pragma unroll
  for (int i = tid; i < BM * (BK / 8); i += NTHREADS) {
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const int row = m0 + r, col = k0 + c;
    const bool ok = row >= lo && row < hi && col < p.Kc;
    cp_async16(As + r * LDA + c, ok ? p.x + (size_t)row * p.Kc + col : p.x, ok);
  }
  if constexpr (TRANS) {
#pragma unroll
    for (int i = tid; i < BN * (BK / 8); i += NTHREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int f = n0 + r, col = k0 + c;
      const bool ok = f < p.F && col < p.Kc;
      cp_async16(Bs + r * LDBT + c, ok ? wg + (size_t)f * p.Kc + col : wg, ok);
    }
  } else {
#pragma unroll
    for (int i = tid; i < BK * (BN / 8); i += NTHREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int k = k0 + r, col = n0 + c;
      const bool ok = k < p.Kc && col < p.F;
      cp_async16(Bs + r * LDB + c, ok ? wg + (size_t)k * p.F + col : wg, ok);
    }
  }
}

template <bool TRANS>
__device__ __forceinline__ void gmm_mma(const bf16* As, const bf16* Bs, Acc (&acc)[FM][FN], int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
#pragma unroll
    for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(a[i], As + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      if constexpr (TRANS) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Bs + (wn * WN + j * 16) * LDBT + kk, LDBT);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  }
}

constexpr int GMM_A_STAGE = BM * LDA;
constexpr int GMM_B_STAGE = (BN * LDBT > BK * LDB) ? BN * LDBT : BK * LDB;
constexpr int GMM_SMEM = 2 * (GMM_A_STAGE + GMM_B_STAGE) * (int)sizeof(bf16);
constexpr int TGMM_X_STAGE = BK * LDX;
constexpr int TGMM_Y_STAGE = BK * LDB;
constexpr int TGMM_SMEM = 2 * (TGMM_X_STAGE + TGMM_Y_STAGE) * (int)sizeof(bf16);
static_assert(NWARPS * 256 * sizeof(float) <= GMM_SMEM, "epilogue scratch reuses the operand stages");
static_assert(NWARPS * 256 * sizeof(float) <= TGMM_SMEM, "epilogue scratch reuses the operand stages");

template <bool TRANS, typename OutT>
__device__ void gmm_body(const GmmParams& p) {
  __shared__ __align__(128) unsigned char smem[GMM_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * GMM_A_STAGE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int tiles_m = (p.n + BM - 1) / BM, tiles_n = (p.F + BN - 1) / BN;
  int tm, tn;
  band_order(blockIdx.x, tiles_m, tiles_n, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int m_end = min(m0 + BM, p.n);
  const int nk = (p.Kc + BK - 1) / BK;

  Acc acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int e = 0; e < p.E; ++e) {
    int lo, hi;
    group_rows(p.cum, p.E, p.n, e, lo, hi);
    lo = max(lo, m0);
    hi = min(hi, m_end);
    if (lo >= hi) continue;  // the same for every thread of the block
    const bf16* wg = p.w + (size_t)e * p.Kc * p.F;
    gmm_load<TRANS>(p, wg, As, Bs, m0, n0, 0, lo, hi, tid);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      if (kt + 1 < nk) {
        gmm_load<TRANS>(p, wg, As + (cur ^ 1) * GMM_A_STAGE, Bs + (cur ^ 1) * GMM_B_STAGE, m0, n0,
                        (kt + 1) * BK, lo, hi, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      gmm_mma<TRANS>(As + cur * GMM_A_STAGE, Bs + cur * GMM_B_STAGE, acc, wm, wn);
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
  }

  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  store_tile<OutT>(acc, static_cast<OutT*>(p.out), (size_t)p.F, m0 + wm * WM, n0 + wn * WN, p.n, p.F, scratch,
                   lane);
}

template <typename OutT>
__global__ void __launch_bounds__(NTHREADS) gmm_kernel(GmmParams p) {
  gmm_body<false, OutT>(p);
}

template <typename OutT>
__global__ void __launch_bounds__(NTHREADS) gmm_dgrad_kernel(GmmParams p) {
  gmm_body<true, OutT>(p);
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

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns a cudaError_t; 0 is
// success.  Shapes are checked by the Python wrapper (ops/cuda/gmm.py): n > 0,
// Kc, F, K and N multiples of 8, contiguous operands.
extern "C" int gmm_bf16(const void* x, const void* w, const int* cum, void* out, int n, int Kc, int F, int E,
                        int transpose_rhs, int out_f32, void* stream) {
  if (n <= 0 || Kc <= 0 || F <= 0 || E <= 0 || Kc % 8 || F % 8) return (int)cudaErrorInvalidValue;
  GmmParams p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.cum = cum;
  p.out = out;
  p.n = n;
  p.Kc = Kc;
  p.F = F;
  p.E = E;
  const dim3 grid(((n + BM - 1) / BM) * ((F + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transpose_rhs) {
    if (out_f32)
      gmm_dgrad_kernel<float><<<grid, NTHREADS, 0, s>>>(p);
    else
      gmm_dgrad_kernel<bf16><<<grid, NTHREADS, 0, s>>>(p);
  } else {
    if (out_f32)
      gmm_kernel<float><<<grid, NTHREADS, 0, s>>>(p);
    else
      gmm_kernel<bf16><<<grid, NTHREADS, 0, s>>>(p);
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
