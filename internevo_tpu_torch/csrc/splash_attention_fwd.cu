// Splash-attention forward for Hopper (sm_90a): causal ∧ same-segment flash
// attention over packed rows, with GQA and optional counter-hash dropout.
//
// Replaces: internevo_tpu/ops/pallas/splash_attention.py::_fwd_kernel_bsd and
// ::_fwd_kernel (one kernel covers both: their split is TPU lane alignment).
//
// What bounds it on this card: at packed 7B shapes (head_dim 128, segments of
// at most 2048 tokens) each visited pair of 64-row tiles does two products of
// 64 x 64 x 128 against 32 KB of streamed K and V, so the tensor cores, and
// the softmax between the two products, are the limit; the (B, Hq, S, Sk)
// score tensor, which the plain version writes to device memory, never leaves
// the registers.  The design is FlashAttention-3's forward, built from the
// splash backward's parts (splash_attention_bwd.cu, hopper.cuh):
//
//   Items: (q head, 128-row q tile, batch), heads fastest (the heads of a
//   tile run together), the q tiles with the longest causal walks first.
//   One persistent block an SM, 384 threads in 3 warpgroups, takes items
//   from a counter in device memory until none are left, so that the next
//   item's Q and first tiles load while the current one computes.
//
//   Warpgroup 0, the producer.  Its warp 1 takes the next item (atomicAdd)
//   and hands it to every role through a ring of two slots, then writes
//   each of its tiles' segment data beside the tile: the tile's distinct
//   segment ids, each with the 64-bit mask of the columns that carry it, and
//   a flag (every column in range and of one segment).  Its thread 0 loads
//   the item's Q by TMA once the consumers have taken the previous one into
//   registers, then streams the (K, V) pairs of 64-row kv tiles from kv_lo
//   (the segment-run start at the item's first row, from the wrapper) to the
//   diagonal tile of the item's last row (to the last tile when not causal)
//   by TMA (4-D maps over (D, H, S, B), 128-byte swizzle; rows past S read as
//   zeros) into a ring of STAGES stages with full and empty mbarriers.
//
//   Warpgroups 1 and 2, the consumers, each own 64 of the item's q rows:
//     Q as registers        A fragments, loaded once an item (ldmatrix)
//     S = Q Kᵀ              wgmma m64n64k16, K K-major in shared memory
//     softmax in registers  an online base-2 softmax: each thread holds two
//                           rows of the m64n64 accumulator, their max and sum
//                           reduced over the 4 threads of a quad by shuffles;
//                           m, l and O's rescaling by exp2(m_old - m_new)
//     O += (P∘drop) V       wgmma m64n(D)k16, A = P packed to T register
//                           fragments straight from the accumulator (its
//                           layout is the A-fragment layout), B = the V tile
//                           read MN-major
//   O (64 fp32 a thread at D = 128) stays in registers for the whole item and
//   is stored as rows of T at the end, with lse.  setmaxnreg gives the
//   consumers 232 registers and the producer 40.
//
// Types and head dims: T is bf16 or f16 (q, k, v and out; P rounds to T
// before the PV product, as the TPU kernel casts p to v's dtype), and the
// kernel is instantiated at D = 64 and 128.  A head dim d <= 128 that is a
// multiple of 8 runs on the next instantiated width: the tensor maps carry
// the true d as their inner extent, so TMA fills the columns past d with
// zeros, which add nothing to QKᵀ; O's columns past d are computed on zeros
// and never stored.
//
// A tile wholly below the consumer's diagonal, in range and inside the rows'
// segment (the producer's flag and the consumer's own) skips the per-element
// masks: the softmax is one of four loops specialised on (masked, dropout)
// and chosen once a tile.  Elsewhere each row's valid columns are one 64-bit
// mask, its segment's in the tile's table cut at the diagonal, taken while S
// runs: per-element compares against the tile's segment ids took ~30% of the
// kernel's time on an H100.  A kept element is the same expression in every loop, so the paths
// give the same bits.  The first consumer's rows end a tile before the
// second's: it waits on and releases the item's last tile without computing
// on it, so that every stage is released by both and the producer's walk
// stays the consumers'.
//
// Masking: causal (row >= col) ∧ seg_q == seg_kv ∧ col < Sk.  A row with no
// valid key gives out 0 and lse -inf, chosen by select (its max stays -inf,
// its probabilities are exp2(-inf) = 0, never exp2(-inf - -inf)).
//
// Dropout (rate > 0): keep iff fmix32(row*0x9E3779B1 ^ col*0x85EBCA77 ^
// head*0xC2B2AE3D ^ base) >= thresh over GLOBAL (row, col, head) coordinates,
// base = seed0 + (b + batch0) * 0x632BE59B, all uint32 -- bit-identical to
// dropout_mask_dense (splash.cuh).  Kept probabilities are scaled by
// 1/(1-rate) in the PV product only; l and lse sum the undropped
// probabilities.  lse = m·ln2 + ln l, natural log, as the backward reads it.
//
// fp32 q/k/v (PC = 3 pieces).  The TPU kernel forms its dots with
// preferred_element_type=f32, so on fp32 inputs every product is an fp32
// product; wgmma's TF32 kind would round q and k to 10 bits.  Instead the
// wrapper splits q, k and v into three bf16 pieces each (x = hi + mid + lo,
// exact for normal values; split_pieces, in (3, B, S, H, d) tensors whose
// maps index piece p of batch b as batch p·B + b), the consumers split P∘drop
// in registers the same way (split3), and each product is the six bf16
// terms a_i·b_j with i + j <= 2 (splash.cuh), summed in the fp32
// accumulators: fp32-exact products at a sixth of the bf16 rate.  The body
// is the bf16 kernel's with three changes.  Q's three pieces (96 KB for 128
// rows at D = 128) cannot sit in registers beside O and S, so S = Q Kᵀ
// reads them from shared memory (wgmma SS), and Q's buffer is released when
// the item ends rather than once it is in registers.  A stage holds the six
// pieces of a (K, V) tile pair, so the ring has 1 stage at D = 128 and 3 at
// D = 64 (Q and the ring fill 192 KB).  A tile's P V is formed in a fresh
// accumulator and added to O in fp32 adds: the tensor cores' accumulation
// does not round to nearest, and O summed in place drifted from the exact
// sums as the walk grew.  out is stored as fp32.

#include "hopper.cuh"
#include "splash.cuh"

namespace {

constexpr int TILE = 64;      // kv rows of a streamed tile, q rows of a consumer; BLOCK_K in the wrapper
constexpr int ITEM = 128;     // q rows of an item; BLOCK_Q in the wrapper
// the ring's stages of (K, V) tiles, each with PC pieces of both
template <int D, int PC>
__host__ __device__ constexpr int stages() {
  return PC == 1 ? 4 : D == 128 ? 1 : 3;
}
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  int* next_item;     // the persistent blocks' item counter, zeroed before each launch
  const int* q_seg;   // (B, S)   (unused when use_seg == 0)
  const int* kv_seg;  // (B, Sk)
  const int* kv_lo;   // (B, cdiv(S, 128))  first 64-row kv tile each 128-row q item visits
  void* out;          // (B, S, Hq, d) of T (fp32 for three pieces)
  float* lse;         // (B, Hq, S)
  int B, S, Sk, Hq, Hkv;
  int d;              // the head dim, <= the instantiated D, a multiple of 8
  float scale_log2;   // softmax_scale * log2(e)
  int causal, use_seg, dropout;
  uint32_t keep_thresh;
  float drop_scale;
  uint32_t seed0, row0, col0, head0, batch0;
};

// A streamed tile's segment data, written by the producer's warp 1: its
// distinct segment ids, each with the 64-bit mask of the tile's in-range
// columns that carry it (n of them, in the order of first appearance);
// whether every column is in range and of one segment, and that segment.
struct Side {
  uint64_t mask[TILE];
  int id[TILE];
  int n, uniform, seg0, pad;
};

// shared memory: Q (128 rows, PC pieces), the ring of (K, V) tiles, their
// Side data, the barriers (the ring's full and empty, Q's full and empty,
// the item slots' full and empty) and the two item slots, after up to 1 KB
// of alignment
template <int D, int PC>
__host__ __device__ constexpr int barriers() {
  return 2 * stages<D, PC>() + 6;
}
template <int D, int PC>
constexpr int smem_bytes() {
  return (2 * PC + 2 * PC * stages<D, PC>()) * (D / 64) * BOX + stages<D, PC>() * (int)sizeof(Side) +
         barriers<D, PC>() * 8 + 2 * 4 + 1024;
}
static_assert(smem_bytes<128, 1>() <= 232448 && smem_bytes<128, 3>() <= 232448 && smem_bytes<64, 3>() <= 232448,
              "the tiles fit a block's shared memory");

// an item: (q head, 128-row q tile, batch) of linear index L, heads fastest,
// the q tiles with the longest causal walks first; its walk [lo, hi]
struct Item {
  int hq, item, b, lo, hi;
};

__device__ __forceinline__ Item decode(const Params& p, int L, int nq) {
  Item it;
  it.hq = L % p.Hq;
  const int t = (L / p.Hq) % nq;
  it.b = L / (p.Hq * nq);
  it.item = p.causal ? nq - 1 - t : t;
  it.lo = __ldg(p.kv_lo + (size_t)it.b * nq + it.item);
  it.hi = (p.Sk - 1) / TILE;
  if (p.causal) it.hi = min(it.hi, (min(it.item * ITEM + ITEM, p.S) - 1) / TILE);
  return it;
}

template <int STAGES>
__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// q, k, v: 4-D maps over (D, H, rows, PC·B) with 64 x 1 x 64 x 1 boxes; piece
// pc of batch b at batch coordinate pc·B + b
template <int D, typename T, int PC>
__global__ void __launch_bounds__(THREADS, 1)
    splash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, Params p) {
  using OutT = typename std::conditional<PC == 1, T, float>::type;
  constexpr int STAGES = stages<D, PC>(), BARRIERS = barriers<D, PC>();
  constexpr int NB = D / 64;                      // 64-column boxes a row
  constexpr uint32_t QBYTES = PC * 2 * NB * BOX;  // the item's 128 q rows, every piece
  constexpr uint32_t TBYTES = NB * BOX;           // one piece of a 64-row K or V tile
  constexpr uint32_t SBYTES = 2 * PC * TBYTES;    // a stage: the pieces of K, then of V
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  const uint32_t pad = (1024 - (smem_u32(fwd_smem) & 1023)) & 1023;
  const uint32_t qtile = smem_u32(fwd_smem) + pad, ring = qtile + QBYTES;
  Side* sides = reinterpret_cast<Side*>(fwd_smem + pad + QBYTES + STAGES * SBYTES);
  const uint32_t bars = smem_u32(sides + STAGES);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t q_full = bars + 8 * 2 * STAGES, q_empty = q_full + 8;
  auto sched_full = [&](int s) { return q_full + 16 + 8 * s; };
  auto sched_empty = [&](int s) { return q_full + 32 + 8 * s; };
  int* slots = reinterpret_cast<int*>(sides + STAGES) + 2 * BARRIERS;
  const int nq = (p.S + ITEM - 1) / ITEM, n_items = p.Hq * nq * p.B;
  const int group = p.Hq / p.Hkv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 2);                // the expect_tx, and lane 0 of warp 1
      mbar_init(empty(s), CONSUMER_WARPS);  // one arrival from each consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
    for (int s = 0; s < 2; ++s) {
      mbar_init(sched_full(s), 1);                    // warp 1's lane 0
      mbar_init(sched_empty(s), 1 + CONSUMER_WARPS);  // thread 0 and each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: warp 1 takes the items and writes each tile's
    // segment data (each lane columns lane and lane + 32, loaded before the
    // wait for the stage); thread 0 loads Q and the tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    int stage = 0, ss = 0;
    uint32_t phase = 0, sph = 0, qph = 0;
    if (threadIdx.x == 0) {
      for (;;) {
        mbar_wait(sched_full(ss), sph);
        const int L = slots[ss];
        mbar_arrive(sched_empty(ss));
        if (++ss == 2) ss = 0, sph ^= 1;
        if (L >= n_items) break;
        const Item it = decode(p, L, nq);
        const int hk = it.hq / group;
        mbar_wait(q_empty, qph ^ 1);
        mbar_expect_tx(q_full, QBYTES);
        qph ^= 1;
        for (int pc = 0; pc < PC; ++pc)
          for (int c = 0; c < 2; ++c)  // two 64-row halves of NB boxes each
            for (int j = 0; j < NB; ++j)
              tma_load_4d(qtile + ((pc * 2 + c) * NB + j) * BOX, &qmap, 64 * j, it.hq, it.item * ITEM + TILE * c,
                          pc * p.B + it.b, q_full);
        for (int tile = it.lo; tile <= it.hi; ++tile) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), SBYTES);
          const uint32_t kt = ring + stage * SBYTES;
          for (int pc = 0; pc < PC; ++pc)
            for (int j = 0; j < NB; ++j) {
              tma_load_4d(kt + (pc * NB + j) * BOX, &kmap, 64 * j, hk, tile * TILE, pc * p.B + it.b, full(stage));
              tma_load_4d(kt + PC * TBYTES + (pc * NB + j) * BOX, &vmap, 64 * j, hk, tile * TILE, pc * p.B + it.b,
                          full(stage));
            }
          advance<STAGES>(stage, phase);
        }
      }
    } else if (warp == 1) {
      for (;;) {
        int L = 0;
        if (lane == 0) {  // the next item, for every role
          L = atomicAdd(p.next_item, 1);
          mbar_wait(sched_empty(ss), sph ^ 1);
          slots[ss] = L;
          mbar_arrive(sched_full(ss));
        }
        L = __shfl_sync(0xffffffffu, L, 0);
        if (++ss == 2) ss = 0, sph ^= 1;
        if (L >= n_items) break;
        const Item it = decode(p, L, nq);
        const int* seg_src = p.kv_seg + (size_t)it.b * p.Sk;
        for (int tile = it.lo; tile <= it.hi; ++tile) {
          int seg[2];
          bool in[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = tile * TILE + lane + 32 * h;
            in[h] = c < p.Sk;
            seg[h] = (p.use_seg && in[h]) ? __ldg(seg_src + c) : 0;
          }
          const int seg0 = __shfl_sync(0xffffffffu, seg[0], 0);
          const bool uniform = __all_sync(0xffffffffu, in[0] && in[1] && seg[0] == seg0 && seg[1] == seg0);
          mbar_wait(empty(stage), phase ^ 1);
          Side& sd = sides[stage];
          // the table of distinct ids: the id of the first column not yet
          // covered, and the ballot of the columns that carry it
          uint64_t left = __ballot_sync(0xffffffffu, in[0]) | (uint64_t)__ballot_sync(0xffffffffu, in[1]) << 32;
          int n = 0;
          while (left) {
            const int c = __ffsll((long long)left) - 1;
            const int id = __shfl_sync(0xffffffffu, c < 32 ? seg[0] : seg[1], c & 31);
            const uint64_t mask = __ballot_sync(0xffffffffu, in[0] && seg[0] == id) |
                                  (uint64_t)__ballot_sync(0xffffffffu, in[1] && seg[1] == id) << 32;
            if (lane == 0) {
              sd.mask[n] = mask;
              sd.id[n] = id;
            }
            ++n;
            left &= ~mask;
          }
          if (lane == 0) {
            sd.n = n;
            sd.uniform = uniform;
            sd.seg0 = seg0;
            mbar_arrive(full(stage));  // releases lane 0's writes
          }
          advance<STAGES>(stage, phase);
        }
      }
    }
    return;
  }

  // consumers: q rows [64 cw, 64 cw + 64) of the item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int rloc = 16 * warp + lane / 4;  // accumulator rows rloc, rloc + 8
  int stage = 0, ss = 0;
  uint32_t phase = 0, sph = 0, qph = 0;
  for (;;) {
    mbar_wait(sched_full(ss), sph);
    const int L = slots[ss];
    __syncwarp();
    if (lane == 0) mbar_arrive(sched_empty(ss));
    if (++ss == 2) ss = 0, sph ^= 1;
    if (L >= n_items) break;
    const Item it = decode(p, L, nq);
    const int hq = it.hq, item = it.item, b = it.b, lo = it.lo, hi = it.hi;
    const int row_base = item * ITEM + TILE * cw;  // first row of this consumer
    // the last tile this consumer computes on: its own rows' diagonal; none if
    // every row lies past S.  It only releases the item's tiles after it
    const int my_hi = row_base >= p.S ? lo - 1 : p.causal ? min(hi, (min(row_base + TILE, p.S) - 1) / TILE) : hi;

    // this thread's rows' segment ids; rows_uniform: every row of the 64 in
    // range and of one segment (the warpgroup's threads hold two rows each)
    const int* qseg = p.q_seg + (size_t)b * p.S;
    const int seg_first = (p.use_seg && row_base < p.S) ? __ldg(qseg + row_base) : 0;
    int rs[2];
    bool own_uniform = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_base + rloc + 8 * h;
      rs[h] = (p.use_seg && r < p.S) ? __ldg(qseg + r) : 0;
      own_uniform = own_uniform && r < p.S && rs[h] == seg_first;
    }
    const bool rows_uniform = warpgroup_all(own_uniform, cw);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of s·scale·log2e, per row
    float l[2] = {0.f, 0.f};              // this thread's share of the running sum, per row
    const uint32_t qa = qtile + cw * NB * BOX;  // piece pc at qa + pc · 2 NB BOX
    mbar_wait(q_full, qph);
    qph ^= 1;
    // one piece: this consumer's Q rows as A fragments, loaded once
    // (ldmatrix), as the backward's dQ kernel loads Q and dO.  Three pieces
    // stay in shared memory until the item ends
    uint32_t qf[PC == 1 ? D / 16 : 1][4];
    if constexpr (PC == 1) {
      const int row = 16 * warp + lane % 8 + 8 * ((lane / 8) & 1);
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int chunk = 2 * k + lane / 16;
        ldmatrix_x4(qa + (chunk / 8) * BOX + row * 128 + (((chunk % 8) ^ (row % 8)) << 4), qf[k]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);  // Q is in registers: the next item's may load
    }

    for (int tile = lo; tile <= my_hi; ++tile) {
      const uint32_t kt = ring + stage * SBYTES, vt = kt + PC * TBYTES;  // piece pc at + pc TBYTES
      mbar_wait(full(stage), phase);
      const Side& sd = sides[stage];

      // S = Q Kᵀ: from Q's register fragments, or the six terms of the pieces
      float s[32];
      wgmma_fence();
      if constexpr (PC == 1) {
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_m64n64k16_rs<0, T>(s, qf[k], box_desc<false>(kt, k), k);
      } else {
#pragma unroll
        for (int t = 0; t < n_terms<PC>(); ++t)
#pragma unroll
          for (int k = 0; k < D / 16; ++k)
            wgmma_m64n64k16_ss<0, 0, T>(s, box_desc<false>(qa + piece_a<PC>(t) * 2 * NB * BOX, k),
                                        box_desc<false>(kt + piece_b<PC>(t) * TBYTES, k), t + k);
      }
      wgmma_commit();

      // While it runs: which of this thread's 32 elements are valid and, with
      // dropout, not dropped (bit i of kept).  Accumulator (row, col) of
      // register i: row rloc + 8 h, h = (i >> 1) & 1, col 8 (i >> 2) + 2 (lane %
      // 4) + (i & 1).  A tile wholly below the diagonal, in range and in the
      // rows' one segment keeps every element; elsewhere row h's valid columns
      // are the table's mask of its segment, cut at the diagonal, shifted so
      // that element i is bit 8 (i >> 2) + (i & 1) of keep[h].
      const bool fast = rows_uniform && sd.uniform && (!p.causal || row_base > tile * TILE) &&
                        (!p.use_seg || sd.seg0 == seg_first);
      uint64_t keep[2] = {~0ull, ~0ull};
      uint32_t kept = ~0u;
      if (!fast) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row_base + rloc + 8 * h;
          uint64_t mk = 0;
          for (int e = 0; e < sd.n; ++e) mk = sd.id[e] == rs[h] ? sd.mask[e] : mk;
          if (p.causal) {
            const int d = r - tile * TILE;  // the last valid column
            mk = d >= TILE - 1 ? mk : d < 0 ? 0 : mk & ((2ull << d) - 1);
          }
          keep[h] = r < p.S ? mk >> (2 * (lane % 4)) : 0;
        }
      }
      if (p.dropout) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
          if (!drop_keeps(p, b, row_base + rloc + 8 * ((i >> 1) & 1), tile * TILE + col, hq)) kept &= ~(1u << i);
        }
      }
      wgmma_wait<0>();
      fence_regs(s);

      // the online softmax on this thread's two rows, P∘drop packed into the
      // A fragments of the k step that covers its columns (each piece's), O
      // rescaled; one loop per (masked, dropout) case
      uint32_t pf[PC][4][4];
      auto softmax = [&](auto masked, auto dropped) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          if constexpr (decltype(masked)::value) s[i] = (keep[h] >> (8 * (i >> 2) + (i & 1))) & 1 ? s[i] : -INFINITY;
          mx[h] = fmaxf(mx[h], s[i]);
        }
        float mu[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h] * p.scale_log2);
          mu[h] = m_new == -INFINITY ? 0.f : m_new;  // a row with no valid key yet: p, o and l stay 0
          corr[h] = ex2(m[h] - mu[h]);
          m[h] = m_new;
        }
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int h = (i >> 1) & 1;
          float pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = ex2(fmaf(s[i + e], p.scale_log2, -mu[h]));
            sum[h] += pv;
            pd[e] = pv;
            if constexpr (decltype(dropped)::value) pd[e] = (kept >> (i + e)) & 1 ? __fmul_rn(pv, p.drop_scale) : 0.f;
          }
          put_pieces<T, PC>(pf, i / 8, (i % 8) / 2, pd[0], pd[1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      };
      if (p.dropout) {
        if (fast) softmax(Flag<false>(), Flag<true>());
        else softmax(Flag<true>(), Flag<true>());
      } else {
        if (fast) softmax(Flag<false>(), Flag<false>());
        else softmax(Flag<true>(), Flag<false>());
      }

      // O += (P∘drop) V.  Three pieces: the tile's six terms in a fresh wgmma
      // accumulator, a 64-column chunk of O at a time, added to O in fp32
      // adds (the tensor cores' accumulation does not round to nearest: 24
      // wgmmas a tile into O itself left out 1.9e-6 from the exact sums)
      if constexpr (PC == 1) {
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) wgmma_rs<D, T>(o, pf[0][k], box_desc<true>(vt, k), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          float step[32];
          wgmma_fence();
#pragma unroll
          for (int t = 0; t < n_terms<PC>(); ++t)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              wgmma_m64n64k16_rs<1, T>(step, pf[piece_a<PC>(t)][k],
                                       box_desc<true>(vt + piece_b<PC>(t) * TBYTES + j * BOX, k), t + k);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(step);
#pragma unroll
          for (int i = 0; i < 32; ++i) o[32 * j + i] += step[i];  // registers 32 j.. are chunk j's columns
        }
      }
#pragma unroll
      for (int pc = 0; pc < PC; ++pc)
#pragma unroll
        for (int k = 0; k < 4; ++k) fence_regs(pf[pc][k]);
      if (lane == 0) mbar_arrive(empty(stage));
      advance<STAGES>(stage, phase);
    }
    // the item's tiles past this consumer's rows: released unread
    for (int tile = max(lo, my_hi + 1); tile <= hi; ++tile) {
      mbar_wait(full(stage), phase);
      if (lane == 0) mbar_arrive(empty(stage));
      advance<STAGES>(stage, phase);
    }
    if constexpr (PC > 1) {  // Q's pieces are read: the next item's may load
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);
    }

    // rows rloc and rloc + 8 of this consumer: out = O / l (0 where l = 0),
    // its first d columns; lse = m·ln2 + ln l (-inf where l = 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int r = row_base + rloc + 8 * h;
      if (r >= p.S) continue;
      const float inv = l[h] == 0.f ? 0.f : 1.f / l[h];
      OutT* dst = static_cast<OutT*>(p.out) + (((size_t)b * p.S + r) * p.Hq + hq) * p.d;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4), i = 4 * j + 2 * h;
        if (8 * j < p.d) store_pair(dst + col, o[i] * inv, o[i + 1] * inv);
      }
      if (lane % 4 == 0)
        p.lse[((size_t)b * p.Hq + hq) * p.S + r] = l[h] == 0.f ? -INFINITY : m[h] * LN2 + logf(l[h]);
    }
  }
}

// ---------------------------------------------------------------- host side

template <int D, typename T, int PC>
cudaError_t launch(const CUtensorMap (&maps)[3], const Params& p, int B, cudaStream_t stream) {
  const void* fn = (const void*)splash_fwd_kernel<D, T, PC>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D, PC>());
  if (err != cudaSuccess) return err;
  CUtensorMap q = maps[0], k = maps[1], v = maps[2];
  Params pp = p;
  void* args[4] = {&q, &k, &v, &pp};
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaMemsetAsync(p.next_item, 0, sizeof(int), stream)) != cudaSuccess)
    return err;
  const int n_items = p.Hq * ((p.S + ITEM - 1) / ITEM) * B;
  const dim3 grid(min(n_items, sms));
  err = cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem_bytes<D, PC>(), stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// q, k, v: T, or for PC = 3 the bf16 pieces (3, B, S, H, D) of fp32 tensors
template <typename T, int PC>
int run(const void* q, const void* k, const void* v, const int* q_seg, const int* kv_seg, const int* kv_lo,
        void* out, float* lse, int* next_item, int B, int S, int Sk, int Hq, int Hkv, int D, float scale_log2,
        int causal, int use_seg, int dropout, unsigned int keep_thresh, float drop_scale, unsigned int seed0,
        unsigned int row0, unsigned int col0, unsigned int head0, unsigned int batch0, void* stream) {
  if (B <= 0 || S <= 0 || Sk <= 0 || D <= 0 || D > 128 || D % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const cuuint64_t q_dims[4] = {(cuuint64_t)D, (cuuint64_t)Hq, (cuuint64_t)S, (cuuint64_t)(PC * B)};
  const cuuint64_t kv_dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)Sk, (cuuint64_t)(PC * B)};
  const cuuint32_t box[4] = {64, 1, TILE, 1};
  if (!encode<T>(&maps[0], q, 4, q_dims, box) || !encode<T>(&maps[1], k, 4, kv_dims, box) ||
      !encode<T>(&maps[2], v, 4, kv_dims, box))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.next_item = next_item;
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.kv_lo = kv_lo;
  p.out = out;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D > 64 ? launch<128, T, PC>(maps, p, B, s) : launch<64, T, PC>(maps, p, B, s));
}

}  // namespace

// Plain C entry points (loaded with ctypes), one per element type, with one
// signature.  Each returns a cudaError_t; 0 is success.  The wrapper
// (ops/cuda/splash_attention.py) checks shapes: contiguous 16-byte aligned
// operands of the entry's type, Hq a multiple of Hkv, D <= 128 a multiple
// of 8.  The fp32 entry takes q, k and v as their bf16 pieces (3, B, S, H,
// D) and writes an fp32 out.
#define SPLASH_FWD_ARGS                                                                                      \
  const void *q, const void *k, const void *v, const int *q_seg, const int *kv_seg, const int *kv_lo,        \
      void *out, float *lse, int *next_item, int B, int S, int Sk, int Hq, int Hkv, int D, float scale_log2, \
      int causal, int use_seg, int dropout, unsigned int keep_thresh, float drop_scale, unsigned int seed0,  \
      unsigned int row0, unsigned int col0, unsigned int head0, unsigned int batch0, void *stream
#define SPLASH_FWD_CALL                                                                                       \
  q, k, v, q_seg, kv_seg, kv_lo, out, lse, next_item, B, S, Sk, Hq, Hkv, D, scale_log2, causal, use_seg, dropout, \
      keep_thresh, drop_scale, seed0, row0, col0, head0, batch0, stream

extern "C" int splash_attention_fwd_bf16(SPLASH_FWD_ARGS) { return run<bf16, 1>(SPLASH_FWD_CALL); }

extern "C" int splash_attention_fwd_f16(SPLASH_FWD_ARGS) { return run<f16, 1>(SPLASH_FWD_CALL); }

extern "C" int splash_attention_fwd_f32(SPLASH_FWD_ARGS) { return run<bf16, 3>(SPLASH_FWD_CALL); }
