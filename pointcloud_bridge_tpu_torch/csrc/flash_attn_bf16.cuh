// What the bfloat16 flash-attention forward (flash_attn_bf16.cu) and
// backward (flash_attn_bwd_bf16.cu) share: the asynchronous staging of a
// tile of bf16 rows into shared memory and the two tensor-core products
// over staged tiles, in bf16 with float32 accumulators.
//
// Arithmetic. Every product is mma.sync.aligned.m16n8k16 with bf16 operands
// and float32 accumulators: a product of two bf16 numbers is exact in
// float32, so what a product adds to the float32 rounding of its sum is
// nothing. No operand is split. Where an operand is computed in float32 (the
// probabilities P, the gradient dS), it is rounded to bf16, to nearest even,
// as it enters the second product.
//
// Fragments (PTX ISA, m16n8k16 .bf16; g = lane / 4, t = lane % 4; a 32-bit
// register holds two bf16, the lower k in the lower half):
//   A 16 x 16 row-major: a0 = A[g][2t, 2t+1],   a1 = A[g+8][2t, 2t+1],
//                        a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]
//   B 16 x 8 "col":      b0 = B[2t, 2t+1][g],   b1 = B[2t+8, 2t+9][g]
//   C 16 x 8 float32:    c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//                        c3 = C[g+8][2t+1]
// A warp owns 16 rows. In a product of rows by rows (q . k^T), A is a
// staged tile of 16 rows and B[k][n] row n of the other staged tile at
// channel k: both fragments are 32-bit loads from the rows as they lie. In
// the second product (p . v) the C fragments of the first are the A
// fragment without leaving the registers: the 16 keys of a k-step are the
// C fragments j = 2s and 2s + 1, so a0 = (c0, c1) of 2s, a1 = (c2, c3) of 2s,
// a2 = (c0, c1) of 2s + 1, a3 = (c2, c3) of 2s + 1. Its B fragment, B[k][n]
// = row k of a staged tile at channel n, is the transpose of what lies in
// shared memory: ldmatrix .trans reads it, four 8 x 8 matrices a call (two
// channel tiles of 8). A staged row has D + 8 bf16, 4 words more than a
// multiple of 16 words: the 32-bit loads of a fragment and the eight rows
// of an ldmatrix matrix then touch 32 different banks.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "flash_attn.cuh"

namespace flash_bf16 {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 added to a staged row (16 bytes)

// 16 bytes from device to shared memory without passing through registers;
// zeros where !valid (src must be readable all the same).
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// Ask for ROWS rows of D bf16 from row0 on, rows past n as zeros, into dst
// with row stride D + kPad, by the THREADS threads of the block. src rows
// are ld elements apart and 16-byte aligned. The caller commits and waits.
// A thread keeps one column of 8 bf16 and walks down the rows, THREADS /
// (D / 8) rows a pass.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile_async(bf16* __restrict__ dst,
                                                 const bf16* __restrict__ src,
                                                 int row0, int n,
                                                 long long ld) {
  constexpr int V8 = D / 8;
  constexpr int LD = D + kPad;
  constexpr int RP = THREADS / V8;  // rows a pass
  static_assert(RP >= 1, "a row a pass at least");
  const int r = threadIdx.x / V8;
  const int c = (threadIdx.x % V8) * 8;
  if (r >= RP) return;
  const bf16* from = src + (size_t)(row0 + r) * ld + c;
  bf16* to = dst + r * LD + c;
#pragma unroll
  for (int k = 0; k < (ROWS + RP - 1) / RP; ++k) {
    if (r + k * RP < ROWS) {
      const bool valid = row0 + r + k * RP < n;
      // src itself stands in for a row past n: nothing is read from it
      cp_async16(to + k * RP * LD, valid ? from + (size_t)(k * RP) * ld : src, valid);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two float32 -> two bf16 in one register, lo in the lower half (nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed: lane l names row l % 8 of matrix
// l / 8 by its address (16-byte aligned); r[m] is then, for every lane,
// (M_m[2t][g], M_m[2t + 1][g]), a B fragment half of m16n8k16.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// acc[j] = rows 0..15 of sa times rows 8j..8j+7 of sb, transposed, over the
// channels [0, KD): the 16 x 8 tile C[r][c] = sum_d sa[r][d] * sb[8j + c][d].
// sa and sb point at the first row and channel to use; LD is the row stride.
template <int LD, int NT, int KD>
__device__ __forceinline__ void dot_rows(const bf16* __restrict__ sa,
                                         const bf16* __restrict__ sb, int g,
                                         int t, float (&acc)[NT][4]) {
  static_assert(KD % 16 == 0, "channels in steps of 16");
  const bf16* pa = sa + g * LD + 2 * t;
  const bf16* pb = sb + g * LD + 2 * t;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < KD; k += 16) {
    const uint32_t a[4] = {ld32(pa + k), ld32(pa + 8 * LD + k), ld32(pa + k + 8),
                           ld32(pa + 8 * LD + k + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* b = pb + 8 * j * LD + k;
      mma_bf16(acc[j], a, ld32(b), ld32(b + 8));
    }
  }
}

// acc[c] += w . x: w is 16 rows by 8 * NT weights as the C fragments of
// dot_rows hold them (w[j] covers the staged rows 8j..8j+7 of sx), rounded
// here to bf16; sx the staged tile of those rows, from its first channel
// to use; acc[c] the 16 x 8 tile of channels 8c..8c+7, NCH tiles (even).
template <int LD, int NT, int NCH>
__device__ __forceinline__ void weighted_rows(const float (&w)[NT][4],
                                              const bf16* __restrict__ sx,
                                              int lane, float (&acc)[NCH][4]) {
  static_assert(NT % 2 == 0 && NCH % 2 == 0, "k-steps of 16 rows, pairs of tiles");
  // lane l addresses row l % 16 of a k-step, channel tile 2c + l / 16
  const bf16* px = sx + (lane & 15) * LD + 8 * (lane >> 4);
#pragma unroll
  for (int s = 0; s < NT / 2; ++s) {
    const uint32_t a[4] = {pack_bf16(w[2 * s][0], w[2 * s][1]),
                           pack_bf16(w[2 * s][2], w[2 * s][3]),
                           pack_bf16(w[2 * s + 1][0], w[2 * s + 1][1]),
                           pack_bf16(w[2 * s + 1][2], w[2 * s + 1][3])};
#pragma unroll
    for (int c = 0; c < NCH; c += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, px + 16 * s * LD + 8 * c);
      mma_bf16(acc[c], a, b[0], b[1]);
      mma_bf16(acc[c + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace flash_bf16
