// Splash-attention backward for Hopper (sm_90a): dQ, dK and dV of causal ∧
// same-segment attention over packed rows, with GQA and the forward's
// counter-hash dropout regenerated bit for bit.
//
// Replaces: internevo_tpu/ops/pallas/splash_attention.py::_bwd_kernel_bsd and
// ::_bwd_kernel (one source covers both: their split is TPU lane alignment).
//
// Why two kernels.  The TPU kernel is one fused pass over kv-major grid steps
// that keeps the whole fp32 dq stripe of its head group, (G, S, D), in VMEM
// and adds into it from every step.  At S = 4096, D = 128 that stripe is 2 MB
// a head; an SM has 227 KB, and CUDA blocks run in no order, so no sum can
// carry from one block to the next.  FlashAttention-2 answers with fp32
// atomicAdd into a dq buffer, which makes dq depend on the order in which
// blocks finish.  This source splits the work instead, and every output
// element is one fixed sequence of fp32 sums, so two runs give the same bits:
//
//  - splash_bwd_dkdv_kernel: one block per (kv tile, kv head, batch).  It
//    walks the q heads of its kv group and, for each, the q tiles from the
//    causal diagonal up to q_hi (the last q tile of the segment run at the kv
//    tile's last token, computed by the wrapper), keeps dK and dV in fp32
//    shared memory, and writes them once.
//  - splash_bwd_dq_kernel: one block per (q tile, q head, batch).  It walks
//    the kv tiles from kv_lo (the segment-run start at the tile's first
//    token) to the diagonal -- the forward's loop -- keeps dQ in fp32 shared
//    memory, and writes it once.
//
// The price is recomputing S and dP in both kernels: 7 tile products for
// each visited (q, kv) tile pair where the fused TPU kernel does 5.
//
// What bounds it on this card: at packed 7B shapes (head_dim 128, segments
// of at most 2048 tokens) each visited pair of 64-row tiles does 7 products
// of 64x64x128 against ~50 KB of tile loads, so the tensor cores are the
// limit.  This first kernel uses WMMA (16x16x16 bf16, fp32 accumulate) and
// stages S, dP, P, dS and the accumulators through shared memory, one block
// of 4 warps per SM; wgmma, TMA and register-resident tiles are later work.
//
// Math, with the forward's natural-log lse and delta = rowsum(dO∘O) − dlse
// computed by the wrapper in plain torch (the JAX package computes it in XLA
// outside its Pallas kernel):
//   P  = exp2(QKᵀ·scale·log2e − lse·log2e) on causal ∧ same-segment ∧
//        in-range pairs; 0 elsewhere and on rows whose lse is −inf (chosen
//        by select, never as exp(+inf)·0);
//   dV = Σ (P∘drop)ᵀ dO;  dP = dO Vᵀ;  dS = P∘(dP∘drop − delta);
//   dQ = scale · dS K;    dK = scale · dSᵀ Q;  dK and dV summed over the
//   q heads of each kv group.  P∘drop and dS are rounded to bf16 before their
//   products, as the TPU kernel rounds them.
//
// Dropout (rate > 0): the forward's keep test, fmix32(row*0x9E3779B1 ^
// col*0x85EBCA77 ^ head*0xC2B2AE3D ^ base) >= thresh over GLOBAL (row, col,
// head), base = seed0 + (b + batch0) * 0x632BE59B; drop = 1/(1-rate) if kept,
// else 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;  // q rows per tile; BLOCK_Q in the wrapper
constexpr int BK = 64;  // kv rows per tile; BLOCK_K in the wrapper
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;     // (B, S, Hq, D)
  const __nv_bfloat16* k;     // (B, Sk, Hkv, D)
  const __nv_bfloat16* v;     // (B, Sk, Hkv, D)
  const __nv_bfloat16* dout;  // (B, S, Hq, D)
  const float* lse;           // (B, Hq, S), natural log, -inf on empty rows
  const float* delta;         // (B, Hq, S)
  const int* q_seg;           // (B, S)   (unused when use_seg == 0)
  const int* kv_seg;          // (B, Sk)
  const int* kv_lo;           // (B, nq)  first kv tile each q tile visits
  const int* q_hi;            // (B, nk)  last q tile each kv tile visits
  __nv_bfloat16* dq;          // (B, S, Hq, D)
  __nv_bfloat16* dk;          // (B, Sk, Hkv, D)
  __nv_bfloat16* dv;          // (B, Sk, Hkv, D)
  int S, Sk, Hq, Hkv, nq, nk;
  float scale;                // softmax_scale
  float scale_log2;           // softmax_scale * log2(e)
  int causal, use_seg, dropout;
  uint32_t keep_thresh;
  float drop_scale;
  uint32_t seed0, row0, col0, head0, batch0;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// keep-and-scale factor of (q row qi, kv col kj, q head hq)
__device__ __forceinline__ float drop_factor(const Params& p, uint32_t base, int qi, int kj, int hq) {
  const uint32_t row = (uint32_t)qi + p.row0, col = (uint32_t)kj + p.col0, head = (uint32_t)hq + p.head0;
  const uint32_t h = fmix32(row * 0x9E3779B1u ^ col * 0x85EBCA77u ^ head * 0xC2B2AE3Du ^ base);
  return h >= p.keep_thresh ? p.drop_scale : 0.f;
}

// 64 rows of one head into a (64, D + 8) shared tile; rows >= n_valid are zero
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, size_t stride,
                                          int n_valid) {
  constexpr int LDH = D + 8, VEC = 8, VPR = D / VEC;
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// One warp: C[16 x 64] (fp32) = A[16 x D] · B[64 x D]ᵀ, A and B row-major bf16
template <int D>
__device__ __forceinline__ void mm_abt(float* C, int ldc, const __nv_bfloat16* A, int lda,
                                       const __nv_bfloat16* B, int ldb) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + kk, lda);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, B + j * 16 * ldb + kk, ldb);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(C + j * 16, acc[j], ldc, wmma::mem_row_major);
}

// One warp: C[16 x D] (fp32, shared) += A[16 x 64] · B[64 x D], A and B row-major bf16
template <int D>
__device__ __forceinline__ void mm_acc_ab(float* C, int ldc, const __nv_bfloat16* A, int lda,
                                          const __nv_bfloat16* B, int ldb) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wmma::load_matrix_sync(a[kk], A + kk * 16, lda);
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    wmma::load_matrix_sync(o, C + j * 16, ldc, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + kk * 16 * ldb + j * 16, ldb);
      wmma::mma_sync(o, a[kk], b, o);
    }
    wmma::store_matrix_sync(C + j * 16, o, ldc, wmma::mem_row_major);
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(__nv_bfloat16) * (4 * 64 * (D + 8) + 2 * BK * (BQ + 8)) +
         sizeof(float) * (2 * BK * (BQ + 4) + 2 * BK * (D + 4) + 2 * BQ) + sizeof(int) * (BQ + BK);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(__nv_bfloat16) * (4 * 64 * (D + 8) + BQ * (BK + 8)) +
         sizeof(float) * (2 * BQ * (BK + 4) + BQ * (D + 4)) + sizeof(int) * BK;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) splash_bwd_dkdv_kernel(Params p) {
  constexpr int LDH = D + 8;   // bf16 q/k/v/dO tiles
  constexpr int LDP = BQ + 8;  // bf16 Pᵀ and dSᵀ (kv rows, q columns)
  constexpr int LDS = BQ + 4;  // fp32 Sᵀ and dPᵀ
  constexpr int LDO = D + 4;   // fp32 dK and dV accumulators

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BK * LDH;
  __nv_bfloat16* Qs = Vs + BK * LDH;
  __nv_bfloat16* dOs = Qs + BQ * LDH;
  __nv_bfloat16* Pt = dOs + BQ * LDH;
  __nv_bfloat16* dSt = Pt + BK * LDP;
  float* St = reinterpret_cast<float*>(dSt + BK * LDP);
  float* dPt = St + BK * LDS;
  float* dKa = dPt + BK * LDS;
  float* dVa = dKa + BK * LDO;
  float* lse_s = dVa + BK * LDO;  // lse * log2(e) of the tile's q rows
  float* dlt_s = lse_s + BQ;      // delta of the tile's q rows
  int* qseg_s = reinterpret_cast<int*>(dlt_s + BQ);
  int* kseg_s = qseg_s + BQ;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int k_start = kt * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const size_t kv_stride = (size_t)p.Hkv * D;
  const size_t kv_off = ((size_t)b * p.Sk + k_start) * kv_stride + (size_t)hk * D;
  load_rows<D>(Ks, p.k + kv_off, kv_stride, p.Sk - k_start);
  load_rows<D>(Vs, p.v + kv_off, kv_stride, p.Sk - k_start);
  for (int i = tid; i < BK; i += NTHREADS) {
    const int kj = k_start + i;
    kseg_s[i] = (p.use_seg && kj < p.Sk) ? p.kv_seg[(size_t)b * p.Sk + kj] : 0;
  }
  for (int i = tid; i < BK * LDO; i += NTHREADS) dKa[i] = dVa[i] = 0.f;
  __syncthreads();

  // in the elementwise phase each lane pair owns one kv row of this warp's 16
  const int r_loc = warp * 16 + lane / 2;
  const int half = lane & 1;
  const int kj = k_start + r_loc;
  const int kseg = kseg_s[r_loc];
  const uint32_t base = p.seed0 + ((uint32_t)b + p.batch0) * 0x632BE59Bu;
  const int qt_lo = p.causal ? k_start / BQ : 0;
  const int qt_hi = p.q_hi[(size_t)b * p.nk + kt];
  const size_t q_stride = (size_t)p.Hq * D;

  for (int g = 0; g < group; ++g) {
    const int hq = hk * group + g;
    const float* lse_h = p.lse + ((size_t)b * p.Hq + hq) * p.S;
    const float* dlt_h = p.delta + ((size_t)b * p.Hq + hq) * p.S;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q_start = qt * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      const size_t q_off = ((size_t)b * p.S + q_start) * q_stride + (size_t)hq * D;
      load_rows<D>(Qs, p.q + q_off, q_stride, p.S - q_start);
      load_rows<D>(dOs, p.dout + q_off, q_stride, p.S - q_start);
      for (int i = tid; i < BQ; i += NTHREADS) {
        const int qi = q_start + i;
        const bool in = qi < p.S;
        lse_s[i] = in ? lse_h[qi] * LOG2E : -INFINITY;
        dlt_s[i] = in ? dlt_h[qi] : 0.f;
        qseg_s[i] = (p.use_seg && in) ? p.q_seg[(size_t)b * p.S + qi] : 0;
      }
      __syncthreads();

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ on this warp's 16 kv rows
      mm_abt<D>(St + warp * 16 * LDS, LDS, Ks + warp * 16 * LDH, LDH, Qs, LDH);
      mm_abt<D>(dPt + warp * 16 * LDS, LDS, Vs + warp * 16 * LDH, LDH, dOs, LDH);
      __syncwarp();

      const float* srow = St + r_loc * LDS;
      const float* dprow = dPt + r_loc * LDS;
      __nv_bfloat16* prow = Pt + r_loc * LDP;
      __nv_bfloat16* dsrow = dSt + r_loc * LDP;
      for (int c = half * (BQ / 2); c < (half + 1) * (BQ / 2); ++c) {
        const int qi = q_start + c;
        const bool ok = kj < p.Sk && qi < p.S && (!p.causal || qi >= kj) &&
                        (!p.use_seg || qseg_s[c] == kseg) && lse_s[c] != -INFINITY;
        const float pv = ok ? exp2f(srow[c] * p.scale_log2 - lse_s[c]) : 0.f;
        float dp = dprow[c], pd = pv;
        if (p.dropout) {
          const float dr = drop_factor(p, base, qi, kj, hq);
          pd = pv * dr;
          dp = dp * dr;
        }
        prow[c] = __float2bfloat16(pd);
        dsrow[c] = __float2bfloat16(pv * (dp - dlt_s[c]));
      }
      __syncwarp();

      // dV += (P∘drop)ᵀ dO and dK += dSᵀ Q on this warp's kv rows
      mm_acc_ab<D>(dVa + warp * 16 * LDO, LDO, Pt + warp * 16 * LDP, LDP, dOs, LDH);
      mm_acc_ab<D>(dKa + warp * 16 * LDO, LDO, dSt + warp * 16 * LDP, LDP, Qs, LDH);
      __syncwarp();
    }
  }

  if (kj < p.Sk) {
    const size_t off = (((size_t)b * p.Sk + kj) * p.Hkv + hk) * D;
    const float* krow = dKa + r_loc * LDO;
    const float* vrow = dVa + r_loc * LDO;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) {
      p.dk[off + c] = __float2bfloat16(krow[c] * p.scale);
      p.dv[off + c] = __float2bfloat16(vrow[c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) splash_bwd_dq_kernel(Params p) {
  constexpr int LDH = D + 8;   // bf16 q/k/v/dO tiles
  constexpr int LDP = BK + 8;  // bf16 dS
  constexpr int LDS = BK + 4;  // fp32 S and dP
  constexpr int LDO = D + 4;   // fp32 dQ accumulator

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + BQ * LDH;
  __nv_bfloat16* Ks = dOs + BQ * LDH;
  __nv_bfloat16* Vs = Ks + BK * LDH;
  __nv_bfloat16* dSs = Vs + BK * LDH;
  float* Ss = reinterpret_cast<float*>(dSs + BQ * LDP);
  float* dPs = Ss + BQ * LDS;
  float* dQa = dPs + BQ * LDS;
  int* kseg_s = reinterpret_cast<int*>(dQa + BQ * LDO);

  const int qt = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hkv);
  const int q_start = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const size_t q_stride = (size_t)p.Hq * D;
  const size_t q_off = ((size_t)b * p.S + q_start) * q_stride + (size_t)hq * D;
  load_rows<D>(Qs, p.q + q_off, q_stride, p.S - q_start);
  load_rows<D>(dOs, p.dout + q_off, q_stride, p.S - q_start);
  for (int i = tid; i < BQ * LDO; i += NTHREADS) dQa[i] = 0.f;
  __syncthreads();

  // in the elementwise phase each lane pair owns one q row of this warp's 16
  const int r_loc = warp * 16 + lane / 2;
  const int half = lane & 1;
  const int qi = q_start + r_loc;
  const bool in = qi < p.S;
  const size_t row_hs = ((size_t)b * p.Hq + hq) * p.S + qi;
  const float lse2 = in ? p.lse[row_hs] * LOG2E : -INFINITY;
  const float dlt = in ? p.delta[row_hs] : 0.f;
  const int qseg = (p.use_seg && in) ? p.q_seg[(size_t)b * p.S + qi] : 0;
  const uint32_t base = p.seed0 + ((uint32_t)b + p.batch0) * 0x632BE59Bu;

  int kt_hi = p.nk - 1;
  if (p.causal) kt_hi = min(kt_hi, (min(q_start + BQ, p.S) - 1) / BK);
  const int kt_lo = p.kv_lo[(size_t)b * p.nq + qt];
  const size_t kv_stride = (size_t)p.Hkv * D;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    const size_t kv_off = ((size_t)b * p.Sk + k_start) * kv_stride + (size_t)hk * D;
    load_rows<D>(Ks, p.k + kv_off, kv_stride, p.Sk - k_start);
    load_rows<D>(Vs, p.v + kv_off, kv_stride, p.Sk - k_start);
    for (int i = tid; i < BK; i += NTHREADS) {
      const int kj = k_start + i;
      kseg_s[i] = (p.use_seg && kj < p.Sk) ? p.kv_seg[(size_t)b * p.Sk + kj] : 0;
    }
    __syncthreads();

    // S = Q Kᵀ and dP = dO Vᵀ on this warp's 16 q rows
    mm_abt<D>(Ss + warp * 16 * LDS, LDS, Qs + warp * 16 * LDH, LDH, Ks, LDH);
    mm_abt<D>(dPs + warp * 16 * LDS, LDS, dOs + warp * 16 * LDH, LDH, Vs, LDH);
    __syncwarp();

    const float* srow = Ss + r_loc * LDS;
    const float* dprow = dPs + r_loc * LDS;
    __nv_bfloat16* dsrow = dSs + r_loc * LDP;
    for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
      const int kj = k_start + c;
      const bool ok = kj < p.Sk && (!p.causal || qi >= kj) && (!p.use_seg || qseg == kseg_s[c]) &&
                      lse2 != -INFINITY;
      const float pv = ok ? exp2f(srow[c] * p.scale_log2 - lse2) : 0.f;
      float dp = dprow[c];
      if (p.dropout) dp = dp * drop_factor(p, base, qi, kj, hq);
      dsrow[c] = __float2bfloat16(pv * (dp - dlt));
    }
    __syncwarp();

    // dQ += dS K on this warp's q rows
    mm_acc_ab<D>(dQa + warp * 16 * LDO, LDO, dSs + warp * 16 * LDP, LDP, Ks, LDH);
    __syncwarp();
  }

  if (in) {
    const float* row = dQa + r_loc * LDO;
    __nv_bfloat16* dst = p.dq + (((size_t)b * p.S + qi) * p.Hq + hq) * D;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) dst[c] = __float2bfloat16(row[c] * p.scale);
  }
}

template <int D>
cudaError_t launch_dkdv(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(splash_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.nk, p.Hkv, B);
  splash_bwd_dkdv_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(splash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.nq, p.Hq, B);
  splash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, const int* q_seg, const int* kv_seg, const int* kv_lo,
                   const int* q_hi, void* dq, void* dk, void* dv, int S, int Sk, int Hq, int Hkv,
                   float scale, float scale_log2, int causal, int use_seg, int dropout,
                   unsigned int keep_thresh, float drop_scale, unsigned int seed0, unsigned int row0,
                   unsigned int col0, unsigned int head0, unsigned int batch0) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.kv_lo = kv_lo;
  p.q_hi = q_hi;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.S = S;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.nq = (S + BQ - 1) / BQ;
  p.nk = (Sk + BK - 1) / BK;
  p.scale = scale;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  p.use_seg = use_seg;
  p.dropout = dropout;
  p.keep_thresh = keep_thresh;
  p.drop_scale = drop_scale;
  p.seed0 = seed0;
  p.row0 = row0;
  p.col0 = col0;
  p.head0 = head0;
  p.batch0 = batch0;
  return p;
}

}  // namespace

// Plain C entry points (loaded with ctypes), one per kernel, with one
// signature.  Each returns a cudaError_t; 0 is success.
#define SPLASH_BWD_ARGS                                                                              \
  const void *q, const void *k, const void *v, const void *dout, const float *lse,                   \
      const float *delta, const int *q_seg, const int *kv_seg, const int *kv_lo, const int *q_hi,    \
      void *dq, void *dk, void *dv, int B, int S, int Sk, int Hq, int Hkv, int D, float scale,       \
      float scale_log2, int causal, int use_seg, int dropout, unsigned int keep_thresh,              \
      float drop_scale, unsigned int seed0, unsigned int row0, unsigned int col0, unsigned int head0, \
      unsigned int batch0, void *stream
#define SPLASH_BWD_PARAMS                                                                         \
  make_params(q, k, v, dout, lse, delta, q_seg, kv_seg, kv_lo, q_hi, dq, dk, dv, S, Sk, Hq, Hkv, \
              scale, scale_log2, causal, use_seg, dropout, keep_thresh, drop_scale, seed0, row0,   \
              col0, head0, batch0)

extern "C" int splash_attention_bwd_dkdv_bf16(SPLASH_BWD_ARGS) {
  const Params p = SPLASH_BWD_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch_dkdv<128>(p, B, s);
  if (D == 64) return (int)launch_dkdv<64>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int splash_attention_bwd_dq_bf16(SPLASH_BWD_ARGS) {
  const Params p = SPLASH_BWD_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return (int)launch_dq<128>(p, B, s);
  if (D == 64) return (int)launch_dq<64>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
