// Splash attention for fp32 q/k/v on Hopper (sm_90a): the forward and the
// two backward kernels, causal ∧ same-segment attention over packed rows,
// with GQA and the bf16/f16 kernels' counter-hash dropout, in fp32 FMAs on
// the CUDA cores.
//
// Replaces, for fp32 inputs: internevo_tpu/ops/pallas/splash_attention.py::
// _fwd_kernel (:457) and _fwd_kernel_bsd (:558), the forward, and
// _bwd_kernel (:787) and _bwd_kernel_bsd (:984), the backward.  The TPU
// kernels take q/k/v of any float type and form their dots with
// preferred_element_type=f32, so on fp32 inputs every product is an fp32
// product.  The wgmma kernels' TF32 kind would round the operands to 10
// mantissa bits; this source keeps full fp32 products instead.
//
// What bounds it on this card: fp32 FMAs outside the tensor cores (67
// TFLOP/s), and before that the shared-memory loads that feed them.  The
// design is the simplest right one, a tiled flash attention:
//
//   One block of 256 threads an item of 64 rows (the forward and dQ: q rows
//   of one q head; dK/dV: kv rows of one kv head), heads fastest in the grid.
//   The item's fixed operands and each streamed 64-row tile sit in shared
//   memory as fp32 rows padded to D + 1 floats (no bank conflicts across the
//   16 threads of a row group).  Thread (ty, tx) = (t / 16, t % 16) owns rows
//   4 ty + {0..3} of the item and columns tx + 16 j of each 64 x 64 score
//   tile, and columns tx + 16 c of each output row; a row's max and sum are
//   reduced over its 16 threads by shuffles.
//
//   forward   walks the kv tiles from kv_lo (the segment-run start at the
//             item's first row, from the wrapper) to the diagonal: S = Q Kᵀ,
//             an online softmax (base 2, as the bf16 kernel), P∘drop through
//             shared memory into O += (P∘drop) V; out = O / l and lse.
//   dK/dV     walks the q heads of the kv group and, for each, the q tiles
//             from the diagonal to q_hi (the last q tile of the segment run
//             at the kv tile's last row): Sᵀ = K Qᵀ, dPᵀ = V dOᵀ, P = exp(S·
//             scale − lse), dS = P∘(dP∘drop − delta); dV += (P∘drop)ᵀ dO, dK
//             += dSᵀ Q through shared memory.
//   dQ        walks the forward's kv tiles: dQ += dS K.
//
// No atomics: every output element is one fixed sequence of fp32 sums, so
// two runs give the same bits, as the bf16 backward.  Masks, empty rows
// (out 0, lse -inf), dropout (drop_keeps in splash.cuh, bit-identical to
// dropout_mask_dense) and delta = rowsum(dO∘O) − dlse (computed by the
// wrapper) are the bf16 kernels'.  Head dims: any d <= 128, on the next of
// the widths 16, 32, 64 and 128; the columns past d are loaded as zeros and
// never stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "splash.cuh"

namespace {

constexpr int ROWS = 64;       // rows of an item and of a streamed tile
constexpr int THREADS = 256;   // 16 row groups of 4 rows x 16 column threads
constexpr int LDP = ROWS + 1;  // padded row stride of a 64 x 64 score tile
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const float *q, *k, *v, *dout;  // (B, S, Hq, d), (B, Sk, Hkv, d) x 2, (B, S, Hq, d)
  const float *lse_in, *delta;    // backward: (B, Hq, S), natural log; rowsum(dO∘O) − dlse
  const int* q_seg;               // (B, S)   (unused when use_seg == 0)
  const int* kv_seg;              // (B, Sk)
  const int* kv_lo;               // (B, cdiv(S, 64))  first kv tile each q item visits
  const int* q_hi;                // (B, cdiv(Sk, 64)) last q tile each kv item visits
  float *out, *lse;               // forward: (B, S, Hq, d), (B, Hq, S)
  float *dq, *dk, *dv;            // backward
  int B, S, Sk, Hq, Hkv, d;
  float scale, scale_log2;        // softmax_scale, and times log2(e)
  int causal, use_seg, dropout;
  uint32_t keep_thresh;
  float drop_scale;
  uint32_t seed0, row0, col0, head0, batch0;
};

template <int D>
constexpr int smem_floats(int tiles, int scores) {
  return tiles * ROWS * (D + 1) + scores * ROWS * LDP + 4 * ROWS;
}

// rows [r0, r0 + 64) of head h of a (B, rows, H, d) tensor into a 64 x (D + 1)
// tile, zeros past `rows` and past d
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b, int r0, int h, int rows, int H,
                                          int d) {
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, c = e % D, row = r0 + r;
    dst[r * (D + 1) + c] = (row < rows && c < d) ? __ldg(src + (((size_t)b * rows + row) * H + h) * d + c) : 0.f;
  }
}

// acc[i][j] = Σ_c a[4 ty + i][c] · b[tx + 16 j][c] over two 64 x (D + 1) tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a, const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(4 * ty + i) * (D + 1) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// o[i][c] += Σ_r w[4 ty + i][r] · m[r][tx + 16 c]: a 64 x 64 score tile (row
// stride LDP) times a 64 x (D + 1) operand tile
template <int D>
__device__ __forceinline__ void tile_acc(float (&o)[4][D / 16], const float* w, const float* m, int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < ROWS; ++r) {
    float mv[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) mv[c] = m[r * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float wv = w[(4 * ty + i) * LDP + r];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) o[i][c] = fmaf(wv, mv[c], o[i][c]);
    }
  }
}

// the sum (or max) of v over the 16 threads of a row group
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// whether (q row qi, kv row kj) is attended: in range, causal, same segment
__device__ __forceinline__ bool attends(const Params& p, int qi, int kj, int seg_q, int seg_kv) {
  return qi < p.S && kj < p.Sk && (!p.causal || qi >= kj) && (!p.use_seg || seg_q == seg_kv);
}

// stores rows 4 ty + i < rows of o (times s) into head h of a (B, rows, H, d) tensor
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&o)[4][D / 16], float s, int b, int r0, int h,
                                           int rows, int H, int d, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d) dst[(((size_t)b * rows + row) * H + h) * d + col] = o[i][c] * s;
    }
  }
}

// ------------------------------------------------------------------ forward

template <int D>
__global__ void __launch_bounds__(THREADS) splash_f32_fwd_kernel(Params p) {
  extern __shared__ float f32_smem[];
  float *qs = f32_smem, *ks = qs + ROWS * (D + 1), *vs = ks + ROWS * (D + 1), *ps = vs + ROWS * (D + 1);
  int* kseg = reinterpret_cast<int*>(ps + ROWS * LDP);
  const int hq = blockIdx.x, item = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = item * ROWS, hk = hq / (p.Hq / p.Hkv);
  const int nq = (p.S + ROWS - 1) / ROWS;
  const int lo = __ldg(p.kv_lo + (size_t)b * nq + item);
  int hi = (p.Sk - 1) / ROWS;
  if (p.causal) hi = min(hi, (min(q0 + ROWS, p.S) - 1) / ROWS);

  int rs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    rs[i] = (p.use_seg && r < p.S) ? __ldg(p.q_seg + (size_t)b * p.S + r) : 0;
  }
  load_tile<D>(qs, p.q, b, q0, hq, p.S, p.Hq, p.d);
  float o[4][D / 16], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;  // running max of s·scale·log2e
    l[i] = 0.f;        // this thread's share of the running sum
#pragma unroll
    for (int c = 0; c < D / 16; ++c) o[i][c] = 0.f;
  }

  for (int tile = lo; tile <= hi; ++tile) {
    const int k0 = tile * ROWS;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, p.k, b, k0, hk, p.Sk, p.Hkv, p.d);
    load_tile<D>(vs, p.v, b, k0, hk, p.Sk, p.Hkv, p.d);
    if (threadIdx.x < ROWS) {
      const int c = k0 + threadIdx.x;
      kseg[threadIdx.x] = (p.use_seg && c < p.Sk) ? __ldg(p.kv_seg + (size_t)b * p.Sk + c) : 0;
    }
    __syncthreads();
    float s[4][4];
    tile_dot<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        s[i][j] = attends(p, r, k0 + cl, rs[i], kseg[cl]) ? s[i][j] * p.scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float mu = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet: p, o and l stay 0
      const float corr = exp2f(m[i] - mu);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const float pv = exp2f(s[i][j] - mu);
        sum += pv;
        float pd = pv;
        if (p.dropout) pd = drop_keeps(p, b, r, k0 + cl, hq) ? __fmul_rn(pv, p.drop_scale) : 0.f;
        ps[(4 * ty + i) * LDP + cl] = pd;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) o[i][c] *= corr;
    }
    __syncthreads();
    tile_acc<D>(o, ps, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = row_sum(l[i]);
    const float inv = lt == 0.f ? 0.f : 1.f / lt;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) o[i][c] *= inv;
    const int r = q0 + 4 * ty + i;
    if (tx == 0 && r < p.S) p.lse[((size_t)b * p.Hq + hq) * p.S + r] = lt == 0.f ? -INFINITY : m[i] * LN2 + logf(lt);
  }
  store_rows<D>(p.out, o, 1.f, b, q0, hq, p.S, p.Hq, p.d, ty, tx);
}

// ----------------------------------------------------------------- backward

// P and dS of one (row, column) pair of a score tile: p = exp(s·scale − lse)
// where attended (0 elsewhere and where lse is -inf), with dropout pd =
// p∘drop and dp∘drop, ds = p (dp∘drop − delta)
__device__ __forceinline__ void p_ds(const Params& p, bool on, float s, float dp, float lse, float delta, bool keep,
                                     float& pd, float& ds) {
  const float pv = (on && lse != -INFINITY) ? expf(fmaf(s, p.scale, -lse)) : 0.f;
  pd = pv;
  if (p.dropout) {
    pd = keep ? __fmul_rn(pv, p.drop_scale) : 0.f;
    dp = keep ? __fmul_rn(dp, p.drop_scale) : 0.f;
  }
  ds = pv * (dp - delta);
}

template <int D>
__global__ void __launch_bounds__(THREADS) splash_f32_bwd_dkdv_kernel(Params p) {
  extern __shared__ float f32_smem[];
  float *ks = f32_smem, *vs = ks + ROWS * (D + 1), *qs = vs + ROWS * (D + 1), *dos = qs + ROWS * (D + 1);
  float *pdt = dos + ROWS * (D + 1), *dst = pdt + ROWS * LDP;  // (P∘drop)ᵀ and dSᵀ: kv rows x q columns
  float *lse_s = dst + ROWS * LDP, *delta_s = lse_s + ROWS;
  int* qseg = reinterpret_cast<int*>(delta_s + ROWS);
  const int hk = blockIdx.x, item = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = item * ROWS, group = p.Hq / p.Hkv;
  const int nk = (p.Sk + ROWS - 1) / ROWS;
  const int lo = p.causal ? item : 0;
  const int hi = min(__ldg(p.q_hi + (size_t)b * nk + item), (p.S - 1) / ROWS);

  int ksg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + 4 * ty + i;
    ksg[i] = (p.use_seg && r < p.Sk) ? __ldg(p.kv_seg + (size_t)b * p.Sk + r) : 0;
  }
  load_tile<D>(ks, p.k, b, k0, hk, p.Sk, p.Hkv, p.d);
  load_tile<D>(vs, p.v, b, k0, hk, p.Sk, p.Hkv, p.d);
  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int hq = hk * group + g;
    for (int tile = lo; tile <= hi; ++tile) {
      const int q0 = tile * ROWS;
      __syncthreads();
      load_tile<D>(qs, p.q, b, q0, hq, p.S, p.Hq, p.d);
      load_tile<D>(dos, p.dout, b, q0, hq, p.S, p.Hq, p.d);
      if (threadIdx.x < ROWS) {
        const int r = q0 + threadIdx.x;
        const size_t at = ((size_t)b * p.Hq + hq) * p.S + r;
        lse_s[threadIdx.x] = r < p.S ? __ldg(p.lse_in + at) : -INFINITY;
        delta_s[threadIdx.x] = r < p.S ? __ldg(p.delta + at) : 0.f;
        qseg[threadIdx.x] = (p.use_seg && r < p.S) ? __ldg(p.q_seg + (size_t)b * p.S + r) : 0;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<D>(s, ks, qs, ty, tx);
      tile_dot<D>(dp, vs, dos, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = tx + 16 * j, qi = q0 + cl;
          const bool keep = p.dropout && drop_keeps(p, b, qi, kj, hq);
          float pd, ds;
          p_ds(p, attends(p, qi, kj, qseg[cl], ksg[i]), s[i][j], dp[i][j], lse_s[cl], delta_s[cl], keep, pd, ds);
          pdt[(4 * ty + i) * LDP + cl] = pd;
          dst[(4 * ty + i) * LDP + cl] = ds;
        }
      }
      __syncthreads();
      tile_acc<D>(dv, pdt, dos, ty, tx);
      tile_acc<D>(dk, dst, qs, ty, tx);
    }
  }
  store_rows<D>(p.dk, dk, p.scale, b, k0, hk, p.Sk, p.Hkv, p.d, ty, tx);
  store_rows<D>(p.dv, dv, 1.f, b, k0, hk, p.Sk, p.Hkv, p.d, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(THREADS) splash_f32_bwd_dq_kernel(Params p) {
  extern __shared__ float f32_smem[];
  float *qs = f32_smem, *dos = qs + ROWS * (D + 1), *ks = dos + ROWS * (D + 1), *vs = ks + ROWS * (D + 1);
  float* dss = vs + ROWS * (D + 1);  // dS: q rows x kv columns
  int* kseg = reinterpret_cast<int*>(dss + ROWS * LDP);
  const int hq = blockIdx.x, item = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = item * ROWS, hk = hq / (p.Hq / p.Hkv);
  const int nq = (p.S + ROWS - 1) / ROWS;
  const int lo = __ldg(p.kv_lo + (size_t)b * nq + item);
  int hi = (p.Sk - 1) / ROWS;
  if (p.causal) hi = min(hi, (min(q0 + ROWS, p.S) - 1) / ROWS);

  int rs[4];
  float rlse[4], rdelta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    const size_t at = ((size_t)b * p.Hq + hq) * p.S + r;
    rs[i] = (p.use_seg && r < p.S) ? __ldg(p.q_seg + (size_t)b * p.S + r) : 0;
    rlse[i] = r < p.S ? __ldg(p.lse_in + at) : -INFINITY;
    rdelta[i] = r < p.S ? __ldg(p.delta + at) : 0.f;
  }
  load_tile<D>(qs, p.q, b, q0, hq, p.S, p.Hq, p.d);
  load_tile<D>(dos, p.dout, b, q0, hq, p.S, p.Hq, p.d);
  float dq[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq[i][c] = 0.f;

  for (int tile = lo; tile <= hi; ++tile) {
    const int k0 = tile * ROWS;
    __syncthreads();
    load_tile<D>(ks, p.k, b, k0, hk, p.Sk, p.Hkv, p.d);
    load_tile<D>(vs, p.v, b, k0, hk, p.Sk, p.Hkv, p.d);
    if (threadIdx.x < ROWS) {
      const int c = k0 + threadIdx.x;
      kseg[threadIdx.x] = (p.use_seg && c < p.Sk) ? __ldg(p.kv_seg + (size_t)b * p.Sk + c) : 0;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, qs, ks, ty, tx);
    tile_dot<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j, kj = k0 + cl;
        const bool keep = p.dropout && drop_keeps(p, b, qi, kj, hq);
        float pd, ds;
        p_ds(p, attends(p, qi, kj, rs[i], kseg[cl]), s[i][j], dp[i][j], rlse[i], rdelta[i], keep, pd, ds);
        dss[(4 * ty + i) * LDP + cl] = ds;
      }
    }
    __syncthreads();
    tile_acc<D>(dq, dss, ks, ty, tx);
  }
  store_rows<D>(p.dq, dq, p.scale, b, q0, hq, p.S, p.Hq, p.d, ty, tx);
}

// ---------------------------------------------------------------- host side

enum Which { FWD = 0, DKDV = 1, DQ = 2 };

template <int D>
cudaError_t launch(int which, const Params& p, cudaStream_t stream) {
  const void* fn = which == FWD    ? (const void*)splash_f32_fwd_kernel<D>
                   : which == DKDV ? (const void*)splash_f32_bwd_dkdv_kernel<D>
                                   : (const void*)splash_f32_bwd_dq_kernel<D>;
  const int bytes = 4 * (which == FWD ? smem_floats<D>(3, 1) : which == DKDV ? smem_floats<D>(4, 2)
                                                                             : smem_floats<D>(4, 1));
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  Params pp = p;
  void* args[1] = {&pp};
  const dim3 grid(which == DKDV ? p.Hkv : p.Hq, ((which == DKDV ? p.Sk : p.S) + ROWS - 1) / ROWS, p.B);
  err = cudaLaunchKernel(fn, grid, dim3(THREADS), args, bytes, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int run(int which, const Params& p, void* stream) {
  if (p.B <= 0 || p.S <= 0 || p.Sk <= 0 || p.d <= 0 || p.d > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = p.d;
  return (int)(d <= 16 ? launch<16>(which, p, s) : d <= 32 ? launch<32>(which, p, s)
               : d <= 64 ? launch<64>(which, p, s) : launch<128>(which, p, s));
}

}  // namespace

// Plain C entry points (loaded with ctypes), with the signatures of the
// bf16 and f16 entries of splash_attention_fwd.cu and splash_attention_bwd.cu
// (the forward ignores next_item).  Each returns a cudaError_t; 0 is success.
// The wrapper (ops/cuda/splash_attention.py) checks shapes: contiguous fp32
// operands, Hq a multiple of Hkv, D <= 128; kv_lo and q_hi at (64, 64)
// blocks.
extern "C" int splash_attention_fwd_f32(const void* q, const void* k, const void* v, const int* q_seg,
                                        const int* kv_seg, const int* kv_lo, void* out, float* lse, int* next_item,
                                        int B, int S, int Sk, int Hq, int Hkv, int D, float scale_log2, int causal,
                                        int use_seg, int dropout, unsigned int keep_thresh, float drop_scale,
                                        unsigned int seed0, unsigned int row0, unsigned int col0,
                                        unsigned int head0, unsigned int batch0, void* stream) {
  (void)next_item;
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.kv_lo = kv_lo;
  p.out = static_cast<float*>(out);
  p.lse = lse;
  p.B = B;
  p.S = S;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.d = D;
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
  return run(FWD, p, stream);
}

#define SPLASH_F32_BWD_ARGS                                                                                       \
  const void *q, const void *k, const void *v, const void *dout, const float *lse, const float *delta,          \
      const int *q_seg, const int *kv_seg, const int *kv_lo, const int *q_hi, void *dq, void *dk, void *dv, int B, \
      int S, int Sk, int Hq, int Hkv, int D, float scale, float scale_log2, int causal, int use_seg, int dropout, \
      unsigned int keep_thresh, float drop_scale, unsigned int seed0, unsigned int row0, unsigned int col0,       \
      unsigned int head0, unsigned int batch0, void *stream

namespace {

int run_bwd(int which, SPLASH_F32_BWD_ARGS) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.lse_in = lse;
  p.delta = delta;
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.kv_lo = kv_lo;
  p.q_hi = q_hi;
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.B = B;
  p.S = S;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.d = D;
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
  return run(which, p, stream);
}

}  // namespace

#define SPLASH_F32_BWD_CALL                                                                                    \
  q, k, v, dout, lse, delta, q_seg, kv_seg, kv_lo, q_hi, dq, dk, dv, B, S, Sk, Hq, Hkv, D, scale, scale_log2, \
      causal, use_seg, dropout, keep_thresh, drop_scale, seed0, row0, col0, head0, batch0, stream

extern "C" int splash_attention_bwd_dkdv_f32(SPLASH_F32_BWD_ARGS) { return run_bwd(DKDV, SPLASH_F32_BWD_CALL); }

extern "C" int splash_attention_bwd_dq_f32(SPLASH_F32_BWD_ARGS) { return run_bwd(DQ, SPLASH_F32_BWD_CALL); }
