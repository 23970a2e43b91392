// K6: multi-head attention forward without the score matrix in device
// memory (flash attention).
//
// Replaces: pointcloud_bridge_tpu/models/ptv3.py:74, _attention, which on
// the TPU hands q, k, v to the library Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention (the call at :136-161,
// BlockSizes q 512 / k_major 1024 / k 512), after a transpose to
// [B, H, N, D] and a zero pad of D = 192 to 256. Neither is needed here.
//
// Semantics: for every batch row b and head h,
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :] / sqrt(D))
//                   * v[b, j, h, :]
// float32 in, float32 sums, float32 out. q, k and v are [B, N, H, D] with
// the head and channel axes contiguous and a row stride each (ldq, ldk,
// ldv, in elements), so the three slices of one packed [B, N, 3, H, D]
// projection are read in place; the batch stride is N rows. o is written
// contiguous as [B, N, H, D]. Where lse is not null, each row's natural-log
// sum of its exponentiated scaled scores, log sum_j exp(q . k_j / sqrt(D)),
// is written to lse[b, h, i] ([B, H, N] float32) for the backward
// (flash_attn_bwd.cu); a caller that needs no gradient passes null.
//
// What bounds it on the H100: operations. 4*B*H*N*N*D float32 operations
// against 16*B*N*H*D bytes is N/4 operations a byte, and the card's
// float32 rate outside the tensor cores (67 TFLOP/s) over its memory rate
// (3.35 TB/s) is 20: from N = 80 up the arithmetic is the floor, whatever D
// is. Below the arithmetic floor sits shared-memory traffic, which the
// register tiles are there to cut.
//
// Design (not the TPU kernel's block plan): a block of 256 threads takes
// one (batch, head) and one tile of 64 query rows and loops over the keys
// itself, 64 at a time, so that the grid is B*H*ceil(N/64) independent
// blocks (512 at [16, 1024, 2, 32], 128 at [4, 256, 8, 32]). The q tile is
// staged in shared memory once, each k and v tile once a step, all row-major
// with the rows padded by 4 floats: threads that read different rows at the
// same channel then hit different banks, and a row stays 16-byte aligned
// for float4 reads along D. The threads form a 16 x 16 grid. Thread
// (ty, tx) computes the 4 x 4 scores of rows ty + 16 i and keys tx + 16 j
// in registers (two float4 reads for 16 FMAs a channel step), scales them
// into base-2 logits, masks keys past N with -inf, and joins the 16 threads
// of a row by shuffles for the running maximum and sum (online softmax).
// The probabilities go to a 64 x 64 tile in shared memory, never to device
// memory, and the same thread accumulates rows ty + 16 i of p . v for the
// channels 2 tx + 32 m, D/16 accumulators a row, so D = 192 costs 48
// registers and not a spilled row of 192. Rows past N are computed on zeros
// and not stored. The running maximum starts at -inf; a tile always holds a
// key below N, and exp2(-inf - finite) is 0, so no inf - inf arises; should
// every score of a row be -inf, the exponent's offset is taken as 0.
//
// The FMAs are written as fmaf(): the library is built with -fmad=false,
// which keeps the other kernels' distances rounding as their plain versions
// do, and would otherwise halve this kernel's arithmetic rate.
#include <cmath>

#include "flash_attn.cuh"

namespace {

using flash::kPad;
using flash::kThreads;

constexpr int kBM = 64;  // query rows a block
constexpr int kBN = 64;  // keys a step
constexpr int kPS = kBN + kPad;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(3 * kBM * (D + kPad) + kBM * kPS) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int n, int heads, int tiles,
                  long long ldq, long long ldk, long long ldv,
                  float scale_log2e) {
  constexpr int LD = D + kPad;
  constexpr int CPT = D / 16;  // output channels a thread and row
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = sq + kBM * LD;
  float* sv = sk + kBN * LD;
  float* sp = sv + kBN * LD;

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int i0 = tile * kBM;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const float* qb = q + (size_t)b * n * ldq + (size_t)h * D;
  const float* kb = k + (size_t)b * n * ldk + (size_t)h * D;
  const float* vb = v + (size_t)b * n * ldv + (size_t)h * D;

  flash::stage_tile<D, kBM>(sq, qb, i0, n, ldq);

  const float ninf = -INFINITY;
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ninf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = 0; j0 < n; j0 += kBN) {
    __syncthreads();  // the previous step's k, v and p are no longer read
    flash::stage_tile<D, kBN>(sk, kb, j0, n, ldk);
    flash::stage_tile<D, kBN>(sv, vb, j0, n, ldv);
    __syncthreads();  // and the q tile is there the first time

    // scores of rows ty + 16 i, keys tx + 16 j
    float s[4][4];
    flash::dot_tile<D, 4>(sq, ty, sk, tx, s);

    // online softmax in base 2; the 16 threads of a row are 16 neighbouring
    // lanes, so xor-shuffles by 8, 4, 2, 1 stay inside the row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = ninf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = j0 + tx + 16 * j < n;
        s[i][j] = valid ? s[i][j] * scale_log2e : ninf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      }
      const float m_new = fmaxf(m[i], mx);
      const float base = m_new == ninf ? 0.f : m_new;
      const float alpha = exp2f(m[i] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - base);
        rs += p;
        sp[(ty + 16 * i) * kPS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      }
      l[i] = fmaf(l[i], alpha, rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the p tile is whole

    // rows ty + 16 i of p . v, channels 2 tx + 32 mm (+1)
    flash::accumulate_tile<D, kBN>(sp, kPS, ty, sv, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= n) continue;
    if (lse != nullptr && tx == 0) {
      // m and l are in base 2: ln sum_j e^(s_j) = (m + log2 l) ln 2
      lse[((size_t)b * heads + h) * n + row] =
          (m[i] + log2f(l[i])) * flash::kLn2;
    }
    float* dst = o + (((size_t)b * n + row) * heads + h) * D;
#pragma unroll
    for (int mm = 0; mm < CPT / 2; ++mm) {
      float2 out;
      out.x = acc[i][2 * mm] / l[i];
      out.y = acc[i][2 * mm + 1] / l[i];
      *reinterpret_cast<float2*>(dst + 2 * tx + 32 * mm) = out;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int b, int n, int heads, long long ldq,
                   long long ldk, long long ldv, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (n + kBM - 1) / kBM;
  // softmax(s / sqrt(D)) = 2^((s - max) * log2(e) / sqrt(D))
  const float scale_log2e = (float)(1.4426950408889634 / std::sqrt((double)D));
  flash_attn_kernel<D><<<(unsigned)((size_t)b * heads * tiles), kThreads, bytes,
                         st>>>(q, k, v, o, lse, n, heads, tiles, ldq, ldk, ldv,
                               scale_log2e);
  return cudaGetLastError();
}

}  // namespace

// d a multiple of 32 up to 256; b * heads * ceil(n / 64) < 2^31; the three
// pointers 16-byte aligned and the row strides multiples of 4: checked by
// the wrapper. lse may be null.
PCB_API int pcb_flash_attn(const float* q, const float* k, const float* v,
                           float* o, float* lse, int b, int n, int heads, int d,
                           long long ldq, long long ldk, long long ldv,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || n < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PCB_FWD(DD) launch<DD>(q, k, v, o, lse, b, n, heads, ldq, ldk, ldv, st)
  PCB_FOR_HEAD_DIMS(PCB_FWD)
#undef PCB_FWD
  return (int)err;
}
