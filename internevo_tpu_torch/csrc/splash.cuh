// What the splash-attention forward and backward share on the device: the
// counter-hash dropout keep test (the two must draw the same bits), the
// softmax's exp2, the per-tile loop flags, the warpgroup vote, and the
// products of fp32 operands split in three bf16 pieces.  Included by
// splash_attention_fwd.cu and splash_attention_bwd.cu after hopper.cuh.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Whether dropout keeps (batch b, q row qi, kv col kj, q head hq): keep iff
// fmix32(row*0x9E3779B1 ^ col*0x85EBCA77 ^ head*0xC2B2AE3D ^ base) >= thresh
// over GLOBAL (row, col, head), base = seed0 + (b + batch0) * 0x632BE59B, all
// uint32 -- bit-identical to dropout_mask_dense.  P is either kernel's Params.
template <class P>
__device__ __forceinline__ bool drop_keeps(const P& p, int b, int qi, int kj, int hq) {
  const uint32_t base = p.seed0 + ((uint32_t)b + p.batch0) * 0x632BE59Bu;
  const uint32_t row = (uint32_t)qi + p.row0, col = (uint32_t)kj + p.col0, head = (uint32_t)hq + p.head0;
  return fmix32(row * 0x9E3779B1u ^ col * 0x85EBCA77u ^ head * 0xC2B2AE3Du ^ base) >= p.keep_thresh;
}

// A compile-time bool, to pick one of a tile's specialised elementwise loops.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// exp2 as volatile asm: it stays in program order, so the compiler cannot
// hoist a tile's loads of per-column data ahead of the first exp2 (more live
// registers beside the accumulators).  ex2(-inf) is +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// True if v is true in every thread of consumer warpgroup cw (named barrier
// 1 + cw; barrier 0 is __syncthreads).
__device__ __forceinline__ bool warpgroup_all(bool v, int cw) {
  uint32_t all;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.and.pred p, %2, 128, q;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(all)
      : "r"((uint32_t)v), "r"(1 + cw)
      : "memory");
  return all != 0;
}

// fp32 operands as three bf16 pieces, x = x0 + x1 + x2 (split3, and the
// wrapper's split_pieces for q, k, v and dO): a product a·b of fp32-exact
// accuracy is the six terms a_i·b_j with i + j <= 2, whose bf16 products are
// exact and whose sums are the wgmma's fp32 accumulation; the terms left
// out (a1·b2, a2·b1, a2·b2) are below 2^-24 of a·b.  Term t of PC-piece
// operands is (piece_a(t), piece_b(t)), smallest first: (2, 0), (1, 1),
// (0, 2), (1, 0), (0, 1), (0, 0); one term (0, 0) for one piece.
template <int PC>
__host__ __device__ constexpr int n_terms() {
  static_assert(PC == 1 || PC == 3, "one piece (bf16, f16) or three (fp32)");
  return PC == 1 ? 1 : 6;
}
template <int PC>
__host__ __device__ constexpr int piece_a(int t) {
  return PC == 1 ? 0 : t < 3 ? 2 - t : t < 5 ? 4 - t : 0;
}
template <int PC>
__host__ __device__ constexpr int piece_b(int t) {
  return PC == 1 ? 0 : t < 3 ? t : t < 5 ? t - 3 : 0;
}

// The pair (a, b) into register fragment f[.][k][r]: packed to T for one
// piece, split in three bf16 pieces for three.
template <typename T, int PC, int K>
__device__ __forceinline__ void put_pieces(uint32_t (&f)[PC][K][4], int k, int r, float a, float b) {
  if constexpr (PC == 1) {
    f[0][k][r] = pack2<T>(a, b);
  } else {
    split3(a, b, f[0][k][r], f[1][k][r], f[2][k][r]);
  }
}

}  // namespace
