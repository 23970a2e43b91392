// What the flash-attention forward (flash_attn.cu) and backward
// (flash_attn_bwd.cu) share: the head widths, the block shape, the staging of
// a tile of rows into shared memory, and the two register-tiled products over
// such tiles.
#pragma once

#include "common.cuh"

// err = CALL(D) for the head width d the kernels are instantiated for (a
// multiple of 32 up to 256), cudaErrorInvalidValue for any other.
#define PCB_FOR_HEAD_DIMS(CALL)           \
  switch (d) {                            \
    case 32: err = CALL(32); break;       \
    case 64: err = CALL(64); break;       \
    case 96: err = CALL(96); break;       \
    case 128: err = CALL(128); break;     \
    case 160: err = CALL(160); break;     \
    case 192: err = CALL(192); break;     \
    case 224: err = CALL(224); break;     \
    case 256: err = CALL(256); break;     \
    default: err = cudaErrorInvalidValue; \
  }

namespace flash {

constexpr int kThreads = 256;  // 16 x 16: ty = threadIdx.x >> 4, tx = threadIdx.x & 15
constexpr int kPad = 4;        // floats added to a staged row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ROWS rows of D floats from row0 on, rows past n as zeros, into dst with
// row stride D + kPad. src rows are ld floats apart and 16-byte aligned.
template <int D, int ROWS>
__device__ __forceinline__ void stage_tile(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int row0, int n, long long ld) {
  constexpr int V4 = D / 4;
  for (int t = threadIdx.x; t < ROWS * V4; t += kThreads) {
    const int r = t / V4;
    const int c = (t % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) {
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * ld + c);
    }
    *reinterpret_cast<float4*>(dst + r * (D + kPad) + c) = val;
  }
}

// s[i][j] = sum_d sa[ra + 16 i][d] * sb[rb + 16 j][d] over two staged tiles:
// 4 x NJ dot products a thread, two float4 reads for 16 FMAs a channel step.
template <int D, int NJ>
__device__ __forceinline__ void dot_tile(const float* __restrict__ sa, int ra,
                                         const float* __restrict__ sb, int rb,
                                         float (&s)[4][NJ]) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], c[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(sa + (ra + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      c[j] = *reinterpret_cast<const float4*>(sb + (rb + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, c[j].x, t);
        t = fmaf(a[i].y, c[j].y, t);
        t = fmaf(a[i].z, c[j].z, t);
        t = fmaf(a[i].w, c[j].w, t);
        s[i][j] = t;
      }
    }
  }
}

// acc[i][c] += sum_jj sw[ry + 16 i][jj] * sx[jj][2 tx + 32 (c / 2) + c % 2]
// for jj < ROWS: rows ry + 16 i of (weights . values), D / 16 channels a
// thread. sw is a tile of weights with row stride ws (a multiple of 4), sx a
// staged tile of ROWS value rows.
template <int D, int ROWS>
__device__ __forceinline__ void accumulate_tile(const float* __restrict__ sw,
                                                int ws, int ry,
                                                const float* __restrict__ sx,
                                                int tx,
                                                float (&acc)[4][D / 16]) {
  constexpr int LD = D + kPad;
#pragma unroll 1
  for (int jj = 0; jj < ROWS; jj += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(sw + (ry + 16 * i) * ws + jj);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int mm = 0; mm < D / 32; ++mm) {
        const float2 xv = *reinterpret_cast<const float2*>(
            sx + (jj + e) * LD + 2 * tx + 32 * mm);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = e == 0 ? p[i].x : e == 1 ? p[i].y
                         : e == 2 ? p[i].z : p[i].w;
          acc[i][2 * mm] = fmaf(pe, xv.x, acc[i][2 * mm]);
          acc[i][2 * mm + 1] = fmaf(pe, xv.y, acc[i][2 * mm + 1]);
        }
      }
    }
  }
}

}  // namespace flash
