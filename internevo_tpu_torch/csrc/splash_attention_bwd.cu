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
// carry from one block to the next.  FlashAttention-2 and -3 answer with fp32
// atomic adds into a dq buffer, which makes dq depend on the order in which
// blocks finish.  This source splits the work instead, and every output
// element is one fixed sequence of fp32 sums, so two runs give the same bits:
//
//  - splash_bwd_dkdv_kernel: one block per (kv head, 128-row kv tile, batch).
//    It walks the q heads of its kv group in order and, for each, the 64-row
//    q tiles from the causal diagonal up to q_hi (the last q tile of the
//    segment run at the kv tile's last token, computed by the wrapper), and
//    keeps dK and dV in registers.
//  - splash_bwd_dq_kernel: one block per (q head, 128-row q tile, batch).  It
//    walks the 64-row kv tiles from kv_lo (the segment-run start at the
//    tile's first token) to the diagonal -- the forward's loop -- and keeps dQ
//    in registers.
//
// The heads vary fastest in the grid, so that the heads of one tile run
// together and the long causal walks start first (dQ walks its tiles in
// reverse); with the tile fastest, the last head's long walks ran last and
// left the card idle behind them.
//
// The price is recomputing S and dP in both kernels: 7 tile products for
// each visited (q, kv) tile pair where the fused TPU kernel does 5.
//
// What bounds it on this card: at packed 7B shapes (head_dim 128, segments
// of 64 to 2048 tokens) each visited pair of 64-row tiles does 7 products of
// 64 x 64 x 128 against 32 KB of streamed tile loads, so the tensor cores
// and the shared memory that feeds them are the limit.  Both kernels are one warp-specialised body (bwd_body<D, DKDV>,
// FlashAttention-3's backward shape without its atomics): 384 threads, 3
// warpgroups.  Warpgroup 0 is the producer.  Its thread 0 loads the item's
// two fixed operands once (K and V of the 128 kv rows, or Q and dO of the 128
// q rows) and streams the two operands of each 64-row tile ((Q, dO) or (K,
// V)) by TMA (4-D maps over (D, H, S, B), 128-byte swizzle; rows past S read
// as zeros) into a ring of 4 stages with full and empty mbarriers.  Its warps
// 1 to 3 write each tile's per-row data beside it (lse·log2e, delta, the
// segment ids) with flags: all lse finite, all rows in range and of one
// segment.  Warpgroups 1 and 2 are consumers, each owning 64 of the item's
// 128 rows:
//
//   S  = A0 B0ᵀ, dP = A1 B1ᵀ    wgmma m64n64k16, B K-major in shared memory;
//                               A K-major in shared memory (dK/dV: Sᵀ = K Qᵀ,
//                               dPᵀ = V dOᵀ) or, for dQ, Q and dO as register
//                               fragments loaded once an item (ldmatrix)
//   P, dS in registers          mask, exp2, dropout, dS = P∘(dP∘drop − delta)
//   dV += (P∘drop)ᵀ dO          wgmma m64n(D)k16 with A = the T P∘drop /
//   dK += dSᵀ Q, dQ += dS K     dS packed from the accumulator (whose layout
//                               is the A-fragment layout), B = the streamed
//                               tile read MN-major
//
// and stores its rows of dK and dV (or dQ) as T at the end.  setmaxnreg
// gives the consumers 240 registers and the producer 24.  A tile pair wholly
// below the diagonal, in range and inside one segment (the producer's and the
// consumer's flags) skips the per-element causal and segment tests: the
// elementwise step is one of four loops specialised on (masked, dropout) and
// chosen once a tile, because with the tests inside one loop the compiler
// branched on them per element and the step took longer than all four
// products.  A kept element is the same expression in every loop, so the
// paths give the same bits.
//
// Math, with the forward's natural-log lse and delta = rowsum(dO∘O) − dlse
// computed by the wrapper in plain torch (the JAX package computes it in XLA
// outside its Pallas kernel):
//   P  = exp2(QKᵀ·scale·log2e − lse·log2e) on causal ∧ same-segment ∧
//        in-range pairs; 0 elsewhere and on rows whose lse is −inf (chosen
//        by select, never as exp(+inf)·0);
//   dV = Σ (P∘drop)ᵀ dO;  dP = dO Vᵀ;  dS = P∘(dP∘drop − delta);
//   dQ = scale · dS K;    dK = scale · dSᵀ Q;  dK and dV summed over the
//   q heads of each kv group.  P∘drop and dS are rounded to T before their
//   products, as the TPU kernel rounds them to q's dtype.
//
// Types and head dims, as the forward's: T is bf16 or f16 (q, k, v, dO and
// the grads), the body is instantiated at D = 64 and 128, and a head dim d
// <= 128 that is a multiple of 8 runs on the next width: the tensor maps
// carry the true d, TMA fills the columns past it with zeros (which add
// nothing to S, dP or delta's products), and only the first d columns of
// each grad are stored.
//
// Dropout (rate > 0): the forward's keep test, fmix32(row*0x9E3779B1 ^
// col*0x85EBCA77 ^ head*0xC2B2AE3D ^ base) >= thresh over GLOBAL (row, col,
// head), base = seed0 + (b + batch0) * 0x632BE59B; drop = 1/(1-rate) if kept,
// else 0.
//
// fp32 q/k/v/dO (PC = 3 pieces), fp32-exact as the forward's: the wrapper
// splits the four operands into three bf16 pieces each ((3, B, S, H, d);
// piece p of batch b at batch coordinate p·B + b), the consumers split P∘drop
// and dS in registers (split3), and every product is the six terms a_i·b_j
// with i + j <= 2 (splash.cuh), summed in fp32.  Three pieces of two
// 128-row fixed operands would fill 192 KB, so the fp32 items are 64 rows
// (the fixed operands 96 KB at D = 128) and both consumers work on the same
// item: consumer c takes rows [32c, 32c + 32) of every streamed tile, S and
// dP as wgmma m64n32k16 (both operands in shared memory) and the
// accumulating products over its two 16-row k steps, so each consumer holds
// a partial dK and dV (or dQ) of all 64 rows.  At the end consumer 1 hands
// its partial through the idle ring to consumer 0, which adds it to its own
// and stores fp32: a fixed order, so two runs still give the same bits.  A
// stage holds the pieces of both streamed tiles: 1 stage at D = 128, 3 at D
// = 64.  Each step's products are formed in fresh wgmma accumulators, 64
// columns at a time, and added to the partial sums in fp32 adds: the
// tensor cores' accumulation does not round to nearest, and a partial sum
// that took every step's wgmmas itself drifted from the exact sum as the
// walk grew.  The control data is at (64, 64) blocks (F32_BWD_BLOCKS).

#include "hopper.cuh"
#include "splash.cuh"

namespace {

constexpr int TILE = 64;      // rows of a streamed tile and of a consumer's share of an item
// rows of an item: kv rows (dK/dV) or q rows (dQ); 128 for one piece, 64 for three
template <int PC>
__host__ __device__ constexpr int item_rows() {
  return PC == 1 ? 128 : 64;
}
// the ring's stages, each with the PC pieces of both streamed tiles
template <int D, int PC>
__host__ __device__ constexpr int stages() {
  return PC == 1 ? 4 : D == 128 ? 1 : 3;
}
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* lse;    // (B, Hq, S), natural log, -inf on empty rows
  const float* delta;  // (B, Hq, S)
  const int* q_seg;    // (B, S)   (unused when use_seg == 0)
  const int* kv_seg;   // (B, Sk)
  const int* kv_lo;    // (B, cdiv(S, 128))  first 64-row kv tile each 128-row q item visits
  const int* q_hi;     // (B, cdiv(Sk, 128)) last 64-row q tile each 128-row kv item visits
  void* dq;            // (B, S, Hq, d) of T (fp32 for three pieces)
  void* dk;            // (B, Sk, Hkv, d)
  void* dv;            // (B, Sk, Hkv, d)
  int B, S, Sk, Hq, Hkv;
  int d;               // the head dim, <= the instantiated D, a multiple of 8
  float scale;         // softmax_scale
  float scale_log2;    // softmax_scale * log2(e)
  int causal, use_seg, dropout;
  uint32_t keep_thresh;
  float drop_scale;
  uint32_t seed0, row0, col0, head0, batch0;
};

// Per-row data of one streamed tile, written by the producer's warps 1 to
// 3: the q rows' lse·log2e (-inf past S) and delta (dK/dV), whether every
// lse is finite (always so for dQ), the tile's segment ids (q rows for dK/dV,
// kv rows for dQ), and whether every row is in range and carries seg[0].
struct Side {
  float lse2[TILE];
  float delta[TILE];
  int seg[TILE];
  int finite, uniform;
  int pad[2];
};

// two fixed operands of an item's rows and the ring's streamed pairs, PC
// pieces each; the Side data; the barriers
template <int D, int PC>
constexpr int smem_bytes() {
  return (2 * PC * item_rows<PC>() / TILE + 2 * PC * stages<D, PC>()) * (D / 64) * BOX +
         stages<D, PC>() * (int)sizeof(Side) + (2 * stages<D, PC>() + 1) * 8 + 1024;
}
static_assert(smem_bytes<128, 1>() <= 232448 && smem_bytes<128, 3>() <= 232448 && smem_bytes<64, 3>() <= 232448,
              "the tiles fit a block's shared memory");

// the consumers' loads of per-column data as volatile asm, like ex2: they stay
// in program order, so the compiler cannot hoist all 16 pairs of loads ahead
// of the first exp2 (32 more live registers beside S, dP, dK and dV)
__device__ __forceinline__ float2 lds_f2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(smem_u32(p)));
  return v;
}

// The item's walk over streamed tiles: `heads` passes (the q heads of a kv
// group for dK/dV, one for dQ) over the 64-row tiles [lo, hi] (none if hi <
// lo).  Producer and consumers walk it alike, so their ring parities agree.
struct Walk {
  int heads, lo, hi;
};

template <bool DKDV, int ITEM>
__device__ __forceinline__ Walk make_walk(const Params& p, int item, int b) {
  Walk w;
  if (DKDV) {
    w.heads = p.Hq / p.Hkv;
    w.lo = p.causal ? item * ITEM / TILE : 0;
    w.hi = min(__ldg(p.q_hi + (size_t)b * ((p.Sk + ITEM - 1) / ITEM) + item), (p.S - 1) / TILE);
  } else {
    w.heads = 1;
    w.lo = __ldg(p.kv_lo + (size_t)b * ((p.S + ITEM - 1) / ITEM) + item);
    w.hi = (p.Sk - 1) / TILE;
    if (p.causal) w.hi = min(w.hi, (min(item * ITEM + ITEM, p.S) - 1) / TILE);
  }
  return w;
}

template <int STAGES>
__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// The consumers of the fp32 instantiation (three pieces, 64-row items; the
// source's header): consumer cw takes rows [32 cw, 32 cw + 32) of each
// streamed tile, and the two partial sums are added at the end.
template <int D, bool DKDV, int STAGES>
__device__ __forceinline__ void consume_pieces(const Params& p, int b, int head, int item, uint32_t fixed0,
                                               uint32_t fixed1, uint32_t ring, float* ring_ptr, const Side* sides,
                                               uint32_t bars) {
  constexpr int PC = 3, NB = D / 64;
  constexpr uint32_t PIECE = NB * BOX;      // one piece of a 64-row tile
  constexpr uint32_t STREAM = PC * PIECE;   // one streamed operand, every piece
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row_base = item * TILE;  // the item's 64 rows, both consumers'
  const int cols = 32 * cw;          // this consumer's rows of each streamed tile
  const int rloc = 16 * warp + lane / 4;
  const int nrows = DKDV ? p.Sk : p.S;
  const int group = p.Hq / p.Hkv;
  const Walk w = make_walk<DKDV, TILE>(p, item, b);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  // the rows' own data, as in the one-piece consumers
  float rlse2[2], rdelta[2];
  const int* seg_src = DKDV ? p.kv_seg + (size_t)b * p.Sk : p.q_seg + (size_t)b * p.S;
  const size_t lse_row = ((size_t)b * p.Hq + head) * p.S;
  const int seg_first = (p.use_seg && row_base < nrows) ? __ldg(seg_src + row_base) : 0;
  bool own_uniform = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_base + rloc + 8 * h;
    const bool in = r < nrows;
    const int rseg = (p.use_seg && in) ? __ldg(seg_src + r) : 0;
    rlse2[h] = (!DKDV && in) ? __ldg(p.lse + lse_row + r) * LOG2E : -INFINITY;
    rdelta[h] = (!DKDV && in) ? __ldg(p.delta + lse_row + r) : 0.f;
    own_uniform = own_uniform && in && rseg == seg_first && (DKDV || rlse2[h] != -INFINITY);
  }
  const bool rows_uniform = warpgroup_all(own_uniform, cw);

  // dK/dV: [0] dV, [1] dK; dQ: [0] dQ; this consumer's share, summed in
  // fp32 adds (see products below), 0 for an item with no steps
  float acc[DKDV ? 2 : 1][D / 2];
#pragma unroll
  for (int a = 0; a < (DKDV ? 2 : 1); ++a)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[a][i] = 0.f;
  mbar_wait(bars + 8 * 2 * STAGES, 0);  // the fixed operands
  int stage = 0;
  uint32_t phase = 0;
  for (int g = 0; g < w.heads; ++g)
    for (int tile = w.lo; tile <= w.hi; ++tile) {
      const int hq = DKDV ? head * group + g : head;
      // the operands' addresses made opaque each step, so that the compiler
      // forms the descriptors in the step rather than keeping loop-invariant
      // ones (all of them, with one stage) in registers across the walk
      uint32_t a0 = fixed0, a1 = fixed1, b0 = ring + stage * 2 * STREAM;  // piece pc at + pc PIECE
      asm volatile("" : "+r"(a0), "+r"(a1), "+r"(b0));
      const uint32_t b1 = b0 + STREAM;
      mbar_wait(full(stage), phase);
      const Side& sd = sides[stage];

      // S = A0 B0ᵀ and dP = A1 B1ᵀ over this consumer's 32 streamed rows, six
      // terms each.  The terms are a loop, not unrolled: unrolled, the 96
      // wgmmas' shared-memory descriptors were formed ahead of them and the
      // dK/dV consumer at D = 128 spilled
      float s[16], dp[16];
      wgmma_fence();
#pragma unroll 1
      for (int t = 0; t < n_terms<PC>(); ++t)
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          const uint32_t a = piece_a<PC>(t) * PIECE, bo = piece_b<PC>(t) * PIECE + 128 * cols;
          wgmma_m64n32k16_ss<0, 0, bf16>(s, box_desc<false>(a0 + a, k), box_desc<false>(b0 + bo, k), t + k);
          wgmma_m64n32k16_ss<0, 0, bf16>(dp, box_desc<false>(a1 + a, k), box_desc<false>(b1 + bo, k), t + k);
        }
      wgmma_commit();

      // While they run: which of this thread's 16 elements are kept and not
      // dropped, as in the one-piece consumers; register i is (row rloc + 8
      // ((i >> 1) & 1), column cols + 8 (i >> 2) + 2 (lane % 4) + (i & 1))
      const bool below = DKDV ? tile * TILE > row_base : row_base > tile * TILE;
      const bool fast = rows_uniform && sd.uniform && sd.finite && (!p.causal || below) &&
                        (!p.use_seg || sd.seg[0] == seg_first);
      uint32_t keep = ~0u, kept = ~0u;
      if (!fast) {
        int rs[2];  // this thread's rows' segment ids, read again: a masked tile is the rarer case
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row_base + rloc + 8 * h;
          rs[h] = p.use_seg && r < nrows ? __ldg(seg_src + r) : 0;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int h = (i >> 1) & 1, col = cols + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
          const int r = row_base + rloc + 8 * h, c = tile * TILE + col;
          const int qi = DKDV ? c : r, kj = DKDV ? r : c;
          const bool finite = (DKDV ? sd.lse2[col] : rlse2[h]) != -INFINITY;
          const bool in = qi < p.S && kj < p.Sk && (!p.causal || qi >= kj) && (!p.use_seg || sd.seg[col] == rs[h]);
          if (!(in && finite)) keep &= ~(1u << i);
        }
      }
      if (p.dropout) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int h = (i >> 1) & 1, col = cols + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
          const int r = row_base + rloc + 8 * h, c = tile * TILE + col;
          if (!drop_keeps(p, b, DKDV ? c : r, DKDV ? r : c, hq)) kept &= ~(1u << i);
        }
      }
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P∘drop and dS = P∘(dP∘drop − delta) as the one-piece consumers form
      // them, in fp32 (dS into dp); P∘drop's pairs split into the three bf16
      // pieces of the k step's A fragments, then, once dV's products have
      // read them, dS's, so that the two sets need not be live together
      // beside dK and dV (128 registers at D = 128)
      uint32_t pf[PC][2][4], df[PC][2][4];  // P∘drop (dK/dV only) and dS
      auto probs = [&](auto masked, auto dropped) {
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int h = (i >> 1) & 1, col = cols + 8 * (i >> 2) + 2 * (lane % 4);
          const float2 lse2 = DKDV ? lds_f2(sd.lse2 + col) : make_float2(rlse2[h], rlse2[h]);
          const float2 delta = DKDV ? lds_f2(sd.delta + col) : make_float2(rdelta[h], rdelta[h]);
          float pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float pv = ex2(fmaf(s[i + e], p.scale_log2, -(e ? lse2.y : lse2.x)));
            float dpe = dp[i + e];
            if constexpr (decltype(masked)::value) pv = (keep >> (i + e)) & 1 ? pv : 0.f;
            pd[e] = pv;
            if constexpr (decltype(dropped)::value) {
              const bool on = (kept >> (i + e)) & 1;
              pd[e] = on ? __fmul_rn(pv, p.drop_scale) : 0.f;  // never contracted into the subtraction below
              dpe = on ? __fmul_rn(dpe, p.drop_scale) : 0.f;
            }
            dp[i + e] = pv * (dpe - (e ? delta.y : delta.x));
          }
          if constexpr (DKDV) put_pieces<bf16, PC>(pf, i / 8, (i % 8) / 2, pd[0], pd[1]);
        }
      };
      if (p.dropout) {
        if (fast) probs(Flag<false>(), Flag<true>());
        else probs(Flag<true>(), Flag<true>());
      } else {
        if (fast) probs(Flag<false>(), Flag<false>());
        else probs(Flag<true>(), Flag<false>());
      }

      // d += A B over this consumer's rows of the streamed tile (its k steps
      // 2 cw and 2 cw + 1), six terms each: A the pieces f, B the streamed
      // tile bt read MN-major.  The step's sum is formed in a fresh wgmma
      // accumulator, a 64-column chunk of d at a time, and added to d in
      // fp32 adds: accumulating every step's twelve wgmmas into d itself
      // left dK and dV 1.2e-5 (relative L2) from the exact sums at 4096
      // tokens, the tensor cores' accumulation not rounding to nearest
      auto products = [&](float(&d)[D / 2], uint32_t(&f)[PC][2][4], uint32_t bt) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          float step[32];
          wgmma_fence();
#pragma unroll
          for (int t = 0; t < n_terms<PC>(); ++t)
#pragma unroll
            for (int k = 0; k < 2; ++k)
              wgmma_m64n64k16_rs<1, bf16>(step, f[piece_a<PC>(t)][k],
                                          box_desc<true>(bt + piece_b<PC>(t) * PIECE + j * BOX, 2 * cw + k), t + k);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(step);
#pragma unroll
          for (int i = 0; i < 32; ++i) d[32 * j + i] += step[i];  // registers 32 j.. are chunk j's columns
        }
#pragma unroll
        for (int pc = 0; pc < PC; ++pc)
#pragma unroll
          for (int k = 0; k < 2; ++k) fence_regs(f[pc][k]);
      };
      if constexpr (DKDV) products(acc[0], pf, b1);  // dV += (P∘drop)ᵀ dO
#pragma unroll
      for (int i = 0; i < 16; i += 2) put_pieces<bf16, PC>(df, i / 8, (i % 8) / 2, dp[i], dp[i + 1]);
      products(acc[DKDV ? 1 : 0], df, b0);  // dK += dSᵀ Q, or dQ += dS K
      if (lane == 0) mbar_arrive(empty(stage));
      advance<STAGES>(stage, phase);
    }

  // consumer 1's partial sums through the ring, idle once both consumers
  // have left the walk (named barrier 3 over their 256 threads), into
  // consumer 0's; each thread's registers hold the same (row, column) pairs
  // in both consumers
  constexpr int N = (DKDV ? 2 : 1) * (D / 2);
  const int t = threadIdx.x % 128;
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
  if (cw == 1) {
#pragma unroll
    for (int a = 0; a < (DKDV ? 2 : 1); ++a)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) ring_ptr[(a * (D / 2) + i) * 128 + t] = acc[a][i];
  }
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
  static_assert(N * 128 * 4 <= STAGES * 2 * STREAM, "the partial sums fit the ring");
  if (cw == 1) return;
#pragma unroll
  for (int a = 0; a < (DKDV ? 2 : 1); ++a)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[a][i] += ring_ptr[(a * (D / 2) + i) * 128 + t];

  // rows rloc and rloc + 8, their first d columns, as fp32
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_base + rloc + 8 * h;
    if (r >= nrows) continue;
    const size_t off =
        DKDV ? (((size_t)b * p.Sk + r) * p.Hkv + head) * p.d : (((size_t)b * p.S + r) * p.Hq + head) * p.d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4), i = 4 * j + 2 * h;
      if (8 * j >= p.d) continue;
      if constexpr (DKDV) {
        store_pair(static_cast<float*>(p.dk) + off + col, acc[1][i] * p.scale, acc[1][i + 1] * p.scale);
        store_pair(static_cast<float*>(p.dv) + off + col, acc[0][i], acc[0][i + 1]);
      } else {
        store_pair(static_cast<float*>(p.dq) + off + col, acc[0][i] * p.scale, acc[0][i + 1] * p.scale);
      }
    }
  }
}

// f0, f1: the item's fixed operands (dK/dV: K, V; dQ: Q, dO); s0, s1: the
// streamed ones (dK/dV: Q, dO; dQ: K, V).  Each a 4-D map over (D, H, rows,
// PC·B) with 64 x 1 x 64 x 1 boxes; piece pc of batch b at batch coordinate
// pc·B + b.
template <int D, bool DKDV, typename T, int PC>
__device__ __forceinline__ void bwd_body(const CUtensorMap& f0, const CUtensorMap& f1, const CUtensorMap& s0,
                                         const CUtensorMap& s1, const Params& p) {
  constexpr int ITEM = item_rows<PC>(), HALVES = ITEM / TILE, STAGES = stages<D, PC>();
  constexpr int NB = D / 64;                          // 64-column boxes a row
  constexpr uint32_t FIXED = PC * HALVES * NB * BOX;  // one fixed operand: the item's rows, every piece
  constexpr uint32_t STREAM = PC * NB * BOX;          // one streamed operand: 64 rows, every piece
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  __shared__ int rows_seg[4];  // per consumer: see below
  const uint32_t pad = (1024 - (smem_u32(bwd_smem) & 1023)) & 1023;
  const uint32_t base = smem_u32(bwd_smem) + pad;
  const uint32_t fixed0 = base, fixed1 = base + FIXED, ring = base + 2 * FIXED;
  Side* sides = reinterpret_cast<Side*>(bwd_smem + pad + 2 * FIXED + STAGES * 2 * STREAM);
  const uint32_t bars = smem_u32(sides + STAGES);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t fixed_bar = bars + 8 * 2 * STAGES;

  const int b = blockIdx.z, head = blockIdx.x;  // kv head (dK/dV) or q head (dQ)
  // the heads of one item launch together; dQ: the longest causal walks (the
  // last q tiles) first
  const int item = (!DKDV && p.causal) ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int group = p.Hq / p.Hkv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1 + 96);           // the expect_tx, and each lane of warps 1 to 3
      mbar_init(empty(s), CONSUMER_WARPS);  // one arrival from each consumer warp
    }
    mbar_init(fixed_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: thread 0 loads the tiles; warps 1 to 3 write the
    // tile's per-row data, each lane rows lane and lane + 32, loaded before
    // the wait for the stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const Walk w = make_walk<DKDV, ITEM>(p, item, b);  // each role derives it after setmaxnreg
    int stage = 0;
    uint32_t phase = 0;
    if (threadIdx.x == 0) {
      mbar_expect_tx(fixed_bar, 2 * FIXED);
      for (int pc = 0; pc < PC; ++pc)
        for (int c = 0; c < HALVES; ++c)  // 64-row halves of NB boxes each
          for (int j = 0; j < NB; ++j) {
            const uint32_t off = ((pc * HALVES + c) * NB + j) * BOX;
            const int row = item * ITEM + TILE * c, bb = pc * p.B + b;
            tma_load_4d(fixed0 + off, &f0, 64 * j, head, row, bb, fixed_bar);
            tma_load_4d(fixed1 + off, &f1, 64 * j, head, row, bb, fixed_bar);
          }
      for (int g = 0; g < w.heads; ++g)
        for (int tile = w.lo; tile <= w.hi; ++tile) {
          const int sh = DKDV ? head * group + g : head / group;  // the streamed operands' head
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), 2 * STREAM);
          for (int pc = 0; pc < PC; ++pc)
            for (int j = 0; j < NB; ++j) {
              const uint32_t dst = ring + stage * 2 * STREAM + (pc * NB + j) * BOX;
              tma_load_4d(dst, &s0, 64 * j, sh, tile * TILE, pc * p.B + b, full(stage));
              tma_load_4d(dst + STREAM, &s1, 64 * j, sh, tile * TILE, pc * p.B + b, full(stage));
            }
          advance<STAGES>(stage, phase);
        }
    } else if (warp == 1 || warp == 2) {  // dK/dV: the q rows' lse·log2e (warp 1) or delta (warp 2)
      for (int g = 0; g < w.heads; ++g) {
        const int row = (b * p.Hq + head * group + g) * p.S;  // B·Hq·S < 2^31 (the wrapper checks)
        for (int tile = w.lo; tile <= w.hi; ++tile) {
          float v[2];
          bool finite = true;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = tile * TILE + lane + 32 * h;
            const bool in = DKDV && r < p.S;
            if (warp == 1) v[h] = in ? __ldg(p.lse + row + r) * LOG2E : -INFINITY;
            else v[h] = in ? __ldg(p.delta + row + r) : 0.f;
            finite = finite && v[h] != -INFINITY;
          }
          finite = !DKDV || __all_sync(0xffffffffu, finite);
          mbar_wait(empty(stage), phase ^ 1);
          float* dst = warp == 1 ? sides[stage].lse2 : sides[stage].delta;
          dst[lane] = v[0];
          dst[lane + 32] = v[1];
          if (warp == 1 && lane == 0) sides[stage].finite = finite;
          mbar_arrive(full(stage));  // each lane releases its own writes
          advance<STAGES>(stage, phase);
        }
      }
    } else if (warp == 3) {  // the tile's segment ids
      const int* seg_src = DKDV ? p.q_seg + (size_t)b * p.S : p.kv_seg + (size_t)b * p.Sk;
      const int rows = DKDV ? p.S : p.Sk;
      for (int g = 0; g < w.heads; ++g)
        for (int tile = w.lo; tile <= w.hi; ++tile) {
          int seg[2];
          bool in = true;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = tile * TILE + lane + 32 * h;
            seg[h] = (p.use_seg && r < rows) ? __ldg(seg_src + r) : 0;
            in = in && r < rows;
          }
          const int seg0 = __shfl_sync(0xffffffffu, seg[0], 0);
          const bool uniform = __all_sync(0xffffffffu, in && seg[0] == seg0 && seg[1] == seg0);
          mbar_wait(empty(stage), phase ^ 1);
          Side& sd = sides[stage];
          sd.seg[lane] = seg[0];
          sd.seg[lane + 32] = seg[1];
          if (lane == 0) sd.uniform = uniform;
          mbar_arrive(full(stage));
          advance<STAGES>(stage, phase);
        }
    }
    return;
  }

  if constexpr (PC > 1) {
    consume_pieces<D, DKDV, STAGES>(p, b, head, item, fixed0, fixed1, ring,
                                    reinterpret_cast<float*>(bwd_smem + pad + 2 * FIXED), sides, bars);
    return;
  }
  // consumers: rows [64 cw, 64 cw + 64) of the item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row_base = item * ITEM + TILE * cw;  // first row of this consumer
  const int rloc = 16 * warp + lane / 4;         // accumulator rows rloc, rloc + 8
  const int nrows = DKDV ? p.Sk : p.S;
  const Walk w = make_walk<DKDV, ITEM>(p, item, b);

  // the rows' own data: dQ's lse·log2e and delta.  rows_uniform: every row of
  // the 64 in range, of one segment, with a finite lse (the warpgroup's
  // threads hold two rows each, all 64 together)
  float rlse2[2], rdelta[2];
  const int* seg_src = DKDV ? p.kv_seg + (size_t)b * p.Sk : p.q_seg + (size_t)b * p.S;
  const size_t lse_row = ((size_t)b * p.Hq + head) * p.S;  // dQ: this q head's rows
  const int seg_first = (p.use_seg && row_base < nrows) ? __ldg(seg_src + row_base) : 0;
  bool own_uniform = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_base + rloc + 8 * h;
    const bool in = r < nrows;
    const int rseg = (p.use_seg && in) ? __ldg(seg_src + r) : 0;
    rlse2[h] = (!DKDV && in) ? __ldg(p.lse + lse_row + r) * LOG2E : -INFINITY;
    rdelta[h] = (!DKDV && in) ? __ldg(p.delta + lse_row + r) : 0.f;
    own_uniform = own_uniform && in && rseg == seg_first && (DKDV || rlse2[h] != -INFINITY);
  }
  // kept in shared memory, read once a step, to spare two registers:
  // rows_seg[cw] the first row's segment id, rows_seg[2 + cw] rows_uniform
  const bool rows_uniform = warpgroup_all(own_uniform, cw);
  if (threadIdx.x % 128 == 0) {
    rows_seg[cw] = seg_first;
    rows_seg[2 + cw] = rows_uniform;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

  float acc[DKDV ? 2 : 1][D / 2];  // dK/dV: [0] dV, [1] dK; dQ: [0] dQ
  mbar_wait(fixed_bar, 0);
  const uint32_t a0 = fixed0 + cw * NB * BOX, a1 = fixed1 + cw * NB * BOX;
  // dQ: this consumer's Q and dO rows as A fragments, loaded once, so
  // that S and dP read only their B operand from shared memory (shared-memory
  // bandwidth bounds these products; dK/dV has no registers to spare for K
  // and V).  Fragment k: rows 16 warp + {0..15}, columns 16 k + {0..15};
  // lane l addresses row l % 8 + 8 ((l / 8) & 1), 16-byte chunk 2 k + l / 16,
  // in the 128-byte swizzle
  uint32_t qf[DKDV ? 1 : D / 16][4], of[DKDV ? 1 : D / 16][4];
  if constexpr (!DKDV) {
    const int row = 16 * warp + lane % 8 + 8 * ((lane / 8) & 1);
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      const int chunk = 2 * k + lane / 16;
      const uint32_t off = (chunk / 8) * BOX + row * 128 + (((chunk % 8) ^ (row % 8)) << 4);
      ldmatrix_x4(a0 + off, qf[k]);
      ldmatrix_x4(a1 + off, of[k]);
    }
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int g = 0; g < w.heads; ++g)
    for (int tile = w.lo; tile <= w.hi; ++tile) {
      const int hq = DKDV ? head * group + g : head;
      const bool first = g == 0 && tile == w.lo;  // its products overwrite acc
      const uint32_t b0 = ring + stage * 2 * STREAM, b1 = b0 + STREAM;
      mbar_wait(full(stage), phase);
      const Side& sd = sides[stage];

      // S = A0 B0ᵀ and dP = A1 B1ᵀ, their k steps interleaved
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        if constexpr (DKDV) {
          wgmma_m64n64k16_ss<0, 0, T>(s, box_desc<false>(a0, k), box_desc<false>(b0, k), k);
          wgmma_m64n64k16_ss<0, 0, T>(dp, box_desc<false>(a1, k), box_desc<false>(b1, k), k);
        } else {
          wgmma_m64n64k16_rs<0, T>(s, qf[k], box_desc<false>(b0, k), k);
          wgmma_m64n64k16_rs<0, T>(dp, of[k], box_desc<false>(b1, k), k);
        }
      }
      wgmma_commit();

      // While they run: which of this thread's 32 elements are kept (bit i of
      // keep) and, with dropout, not dropped (bit i of kept).  Accumulator
      // (row, col) of register i: row rloc + 8 ((i >> 1) & 1), col 8 (i >> 2)
      // + 2 (lane % 4) + (i & 1); rows are this consumer's (kv rows for dK/dV,
      // q rows for dQ), columns the streamed tile's.  A tile pair wholly below
      // the diagonal, in range and in one segment keeps every element.
      const bool below = DKDV ? tile * TILE > row_base : row_base > tile * TILE;
      const bool fast = rows_seg[2 + cw] && sd.uniform && sd.finite && (!p.causal || below) &&
                        (!p.use_seg || sd.seg[0] == rows_seg[cw]);
      uint32_t keep = ~0u, kept = ~0u;
      if (!fast) {
        int rs[2];  // this thread's rows' segment ids, read again: a masked tile is the rarer case
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row_base + rloc + 8 * h;
          rs[h] = p.use_seg && r < nrows ? __ldg(seg_src + r) : 0;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
          const int r = row_base + rloc + 8 * h, c = tile * TILE + col;
          const int qi = DKDV ? c : r, kj = DKDV ? r : c;
          const bool finite = (DKDV ? sd.lse2[col] : rlse2[h]) != -INFINITY;
          const bool in = qi < p.S && kj < p.Sk && (!p.causal || qi >= kj) && (!p.use_seg || sd.seg[col] == rs[h]);
          if (!(in && finite)) keep &= ~(1u << i);
        }
      }
      if (p.dropout) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
          const int r = row_base + rloc + 8 * h, c = tile * TILE + col;
          if (!drop_keeps(p, b, DKDV ? c : r, DKDV ? r : c, hq)) kept &= ~(1u << i);
        }
      }
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P = exp2(S·scale·log2e − lse·log2e) where kept, dS = P∘(dP∘drop −
      // delta), each pair packed into the T A fragments of the k step
      // that covers its columns; one loop per (masked, dropout) case, so that
      // neither is tested per element where it does not apply
      uint32_t pf[4][4], df[4][4];  // P∘drop (dK/dV only) and dS
      auto fragments = [&](auto masked, auto dropped) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int h = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * (lane % 4);  // columns col, col + 1
          const float2 lse2 = DKDV ? lds_f2(sd.lse2 + col) : make_float2(rlse2[h], rlse2[h]);
          const float2 delta = DKDV ? lds_f2(sd.delta + col) : make_float2(rdelta[h], rdelta[h]);
          float ds[2], pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float pv = ex2(fmaf(s[i + e], p.scale_log2, -(e ? lse2.y : lse2.x)));
            float dpe = dp[i + e];
            if constexpr (decltype(masked)::value) pv = (keep >> (i + e)) & 1 ? pv : 0.f;
            pd[e] = pv;
            if constexpr (decltype(dropped)::value) {
              const bool on = (kept >> (i + e)) & 1;
              pd[e] = on ? __fmul_rn(pv, p.drop_scale) : 0.f;  // never contracted into the subtraction below
              dpe = on ? __fmul_rn(dpe, p.drop_scale) : 0.f;
            }
            ds[e] = pv * (dpe - (e ? delta.y : delta.x));
          }
          df[i / 8][(i % 8) / 2] = pack2<T>(ds[0], ds[1]);
          if constexpr (DKDV) pf[i / 8][(i % 8) / 2] = pack2<T>(pd[0], pd[1]);
        }
      };
      if (p.dropout) {
        if (fast) fragments(Flag<false>(), Flag<true>());
        else fragments(Flag<true>(), Flag<true>());
      } else {
        if (fast) fragments(Flag<false>(), Flag<false>());
        else fragments(Flag<true>(), Flag<false>());
      }

      // dV += (P∘drop)ᵀ dO and dK += dSᵀ Q, or dQ += dS K: A from registers, B
      // the streamed tile read MN-major
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (DKDV) {
          wgmma_rs<D, T>(acc[0], pf[k], box_desc<true>(b1, k), first ? k : 1);
          wgmma_rs<D, T>(acc[1], df[k], box_desc<true>(b0, k), first ? k : 1);
        } else {
          wgmma_rs<D, T>(acc[0], df[k], box_desc<true>(b0, k), first ? k : 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < (DKDV ? 2 : 1); ++a) fence_regs(acc[a]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        fence_regs(df[k]);
        if constexpr (DKDV) fence_regs(pf[k]);
      }
      if (lane == 0) mbar_arrive(empty(stage));
      advance<STAGES>(stage, phase);
    }

  // rows rloc and rloc + 8 of this consumer, their first d columns; an item
  // with no steps stores 0
  const bool live = w.hi >= w.lo;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_base + rloc + 8 * h;
    if (r >= nrows) continue;
    const size_t off =
        DKDV ? (((size_t)b * p.Sk + r) * p.Hkv + head) * p.d : (((size_t)b * p.S + r) * p.Hq + head) * p.d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4), i = 4 * j + 2 * h;
      if (8 * j >= p.d) continue;
      if constexpr (DKDV) {
        *reinterpret_cast<uint32_t*>(static_cast<T*>(p.dk) + off + col) =
            pack2<T>(live ? acc[1][i] * p.scale : 0.f, live ? acc[1][i + 1] * p.scale : 0.f);
        *reinterpret_cast<uint32_t*>(static_cast<T*>(p.dv) + off + col) =
            pack2<T>(live ? acc[0][i] : 0.f, live ? acc[0][i + 1] : 0.f);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<T*>(p.dq) + off + col) =
            pack2<T>(live ? acc[0][i] * p.scale : 0.f, live ? acc[0][i + 1] * p.scale : 0.f);
      }
    }
  }
}

template <int D, typename T, int PC>
__global__ void __launch_bounds__(THREADS, 1)
    splash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap k, const __grid_constant__ CUtensorMap v,
                           const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap dout, Params p) {
  bwd_body<D, true, T, PC>(k, v, q, dout, p);
}

template <int D, typename T, int PC>
__global__ void __launch_bounds__(THREADS, 1)
    splash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap dout,
                         const __grid_constant__ CUtensorMap k, const __grid_constant__ CUtensorMap v, Params p) {
  bwd_body<D, false, T, PC>(q, dout, k, v, p);
}

// ---------------------------------------------------------------- host side

template <int D, typename T, int PC>
cudaError_t launch(bool dkdv, const CUtensorMap (&maps)[4], const Params& p, int B, cudaStream_t stream) {
  constexpr int ITEM = item_rows<PC>();
  const void* fn =
      dkdv ? (const void*)splash_bwd_dkdv_kernel<D, T, PC> : (const void*)splash_bwd_dq_kernel<D, T, PC>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D, PC>());
  if (err != cudaSuccess) return err;
  // dK/dV: k, v fixed, q, dO streamed; dQ: q, dO fixed, k, v streamed
  CUtensorMap m0 = maps[dkdv ? 1 : 0], m1 = maps[dkdv ? 2 : 3], m2 = maps[dkdv ? 0 : 1], m3 = maps[dkdv ? 3 : 2];
  Params pp = p;
  void* args[5] = {&m0, &m1, &m2, &m3, &pp};
  const dim3 grid(dkdv ? p.Hkv : p.Hq, dkdv ? (p.Sk + ITEM - 1) / ITEM : (p.S + ITEM - 1) / ITEM, B);
  err = cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem_bytes<D, PC>(), stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// maps: q, k, v, dout, each 4-D over (d, H, rows, PC·B) with 64 x 1 x 64 x 1
// boxes: T, or for PC = 3 the bf16 pieces (3, B, S, H, D) of fp32 tensors
template <typename T, int PC>
int run(bool dkdv, const void* q, const void* k, const void* v, const void* dout, const Params& p, int B, int D,
        void* stream) {
  if (B <= 0 || p.S <= 0 || p.Sk <= 0 || D <= 0 || D > 128 || D % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const cuuint64_t q_dims[4] = {(cuuint64_t)D, (cuuint64_t)p.Hq, (cuuint64_t)p.S, (cuuint64_t)(PC * B)};
  const cuuint64_t kv_dims[4] = {(cuuint64_t)D, (cuuint64_t)p.Hkv, (cuuint64_t)p.Sk, (cuuint64_t)(PC * B)};
  const cuuint32_t box[4] = {64, 1, TILE, 1};
  if (!encode<T>(&maps[0], q, 4, q_dims, box) || !encode<T>(&maps[1], k, 4, kv_dims, box) ||
      !encode<T>(&maps[2], v, 4, kv_dims, box) || !encode<T>(&maps[3], dout, 4, q_dims, box))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params pd = p;
  pd.d = D;
  pd.B = B;
  return (int)(D > 64 ? launch<128, T, PC>(dkdv, maps, pd, B, s) : launch<64, T, PC>(dkdv, maps, pd, B, s));
}

Params make_params(const float* lse, const float* delta, const int* q_seg, const int* kv_seg, const int* kv_lo,
                   const int* q_hi, void* dq, void* dk, void* dv, int S, int Sk, int Hq, int Hkv, float scale,
                   float scale_log2, int causal, int use_seg, int dropout, unsigned int keep_thresh, float drop_scale,
                   unsigned int seed0, unsigned int row0, unsigned int col0, unsigned int head0, unsigned int batch0) {
  Params p;
  p.lse = lse;
  p.delta = delta;
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.kv_lo = kv_lo;
  p.q_hi = q_hi;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.S = S;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
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

// Plain C entry points (loaded with ctypes), one per kernel and element
// type, with one signature.  Each returns a cudaError_t; 0 is success.  The
// wrapper (ops/cuda/splash_attention.py) checks shapes: contiguous 16-byte
// aligned operands of the entry's type, Hq a multiple of Hkv, D <= 128 a
// multiple of 8.  The fp32 entries take q, k, v and dO as their bf16
// pieces (3, B, S, H, D) and write fp32 grads.
#define SPLASH_BWD_ARGS                                                                              \
  const void *q, const void *k, const void *v, const void *dout, const float *lse,                   \
      const float *delta, const int *q_seg, const int *kv_seg, const int *kv_lo, const int *q_hi,    \
      void *dq, void *dk, void *dv, int B, int S, int Sk, int Hq, int Hkv, int D, float scale,       \
      float scale_log2, int causal, int use_seg, int dropout, unsigned int keep_thresh,              \
      float drop_scale, unsigned int seed0, unsigned int row0, unsigned int col0, unsigned int head0, \
      unsigned int batch0, void *stream
#define SPLASH_BWD_PARAMS                                                                                     \
  make_params(lse, delta, q_seg, kv_seg, kv_lo, q_hi, dq, dk, dv, S, Sk, Hq, Hkv, scale, scale_log2, causal, \
              use_seg, dropout, keep_thresh, drop_scale, seed0, row0, col0, head0, batch0)

extern "C" int splash_attention_bwd_dkdv_bf16(SPLASH_BWD_ARGS) {
  return run<bf16, 1>(true, q, k, v, dout, SPLASH_BWD_PARAMS, B, D, stream);
}

extern "C" int splash_attention_bwd_dq_bf16(SPLASH_BWD_ARGS) {
  return run<bf16, 1>(false, q, k, v, dout, SPLASH_BWD_PARAMS, B, D, stream);
}

extern "C" int splash_attention_bwd_dkdv_f16(SPLASH_BWD_ARGS) {
  return run<f16, 1>(true, q, k, v, dout, SPLASH_BWD_PARAMS, B, D, stream);
}

extern "C" int splash_attention_bwd_dq_f16(SPLASH_BWD_ARGS) {
  return run<f16, 1>(false, q, k, v, dout, SPLASH_BWD_PARAMS, B, D, stream);
}

extern "C" int splash_attention_bwd_dkdv_f32(SPLASH_BWD_ARGS) {
  return run<bf16, 3>(true, q, k, v, dout, SPLASH_BWD_PARAMS, B, D, stream);
}

extern "C" int splash_attention_bwd_dq_f32(SPLASH_BWD_ARGS) {
  return run<bf16, 3>(false, q, k, v, dout, SPLASH_BWD_PARAMS, B, D, stream);
}
