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
// What bounds it on the H100: operations. 4*B*H*N*N*D operations against
// 16*B*N*H*D bytes is N/4 operations a byte. At float32 accuracy the fastest
// route is the tensor cores in 3xTF32, three passes at 495 TFLOP/s, so 165
// TFLOP/s of float32-grade work against 67 TFLOP/s of FMAs; over the memory
// rate (3.35 TB/s) that is 49 operations a byte: from N = 200 up the
// arithmetic is the floor, whatever D is.
//
// Design (not the TPU kernel's block plan). A block takes one (batch, head)
// and one tile of BM query rows and loops over the keys itself, BN at a
// time, so the grid is B*H*ceil(N/BM) independent blocks. A warp owns 16
// query rows. The q tile is staged once; the k and v tiles arrive in a ring
// of STAGES buffers filled by cp.async (16 bytes a thread and copy), so the
// copy of a later step runs under the arithmetic of this one, and one
// __syncthreads() a step is all the ring needs. Rows past N are zero-filled
// by the copy itself. Both products run on the tensor cores in 3xTF32 (see
// flash_attn.cuh): s = q . k^T into BN/8 accumulator fragments a warp, the
// online softmax on those registers (a row's 2 * BN/8 scores in a thread,
// joined over the 4 threads of a quad by two shuffles), and p . v straight
// from the same registers: the probabilities never pass through shared
// memory, let alone device memory. Tile sizes by D keep the block inside the
// 232,448 bytes of shared memory: at D <= 64 a block is 4 warps on 64 rows
// and two or three blocks share an SM; from D = 96 to 192 it is 8 warps on
// 128 rows, and 4 warps on 64 rows beyond. The running maximum starts at
// -inf; a tile always holds a key below N, and exp2(-inf - finite) is 0, so
// no inf - inf arises; should every score of a row be -inf, the exponent's
// offset is taken as 0. A warp whose 16 rows all lie past N copies and waits
// with the others and computes nothing.
//
// The library is built with -fmad=false, which keeps the other kernels'
// distances rounding as their plain versions do; a fused operation here is
// written as fmaf().
#include <cmath>

#include "flash_attn.cuh"

namespace {

using flash::kPad;

// query rows a block, keys a step, buffers in the ring
constexpr int fwd_bm(int d) { return d <= 64 || d > 192 ? 64 : 128; }
constexpr int fwd_bn(int d) { return d <= 96 ? 64 : 32; }
constexpr int fwd_stages(int d) { return d == 32 ? 3 : 2; }

template <int D, int BM, int BN, int STAGES>
constexpr size_t smem_bytes() {
  return (size_t)(BM + 2 * STAGES * BN) * (D + kPad) * sizeof(float);
}

template <int D, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(2 * BM)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int n, int heads, int tiles,
                  long long ldq, long long ldk, long long ldv,
                  float scale_log2e) {
  constexpr int LD = D + kPad;
  constexpr int THREADS = 2 * BM;  // a warp a 16 rows
  constexpr int NT = BN / 8;       // score fragments a warp and step
  constexpr int NCH = D / 8;       // output fragments a warp
  constexpr int TILE = BN * LD;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* ring = sq + BM * LD;  // STAGES x (k tile, v tile)

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int i0 = tile * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;          // the warp's first row in the tile
  const bool active = i0 + r0 < n;   // else every row of the warp is past N

  const float* qb = q + (size_t)b * n * ldq + (size_t)h * D;
  const float* kb = k + (size_t)b * n * ldk + (size_t)h * D;
  const float* vb = v + (size_t)b * n * ldv + (size_t)h * D;
  const int steps = (n + BN - 1) / BN;

  // the q tile travels with the first k and v tiles
  flash::stage_tile_async<D, BM, THREADS>(sq, qb, i0, n, ldq);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) {
      flash::stage_tile_async<D, BN, THREADS>(ring + 2 * s * TILE, kb, s * BN, n, ldk);
      flash::stage_tile_async<D, BN, THREADS>(ring + (2 * s + 1) * TILE, vb, s * BN, n, ldv);
    }
    flash::cp_async_commit();
  }

  const float ninf = -INFINITY;
  float m[2], l[2], acc[NCH][4];  // rows g and g + 8 of the warp's 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = ninf;
    l[r] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  }

  for (int step = 0; step < steps; ++step) {
    // this step's tiles have landed, and every warp is done with the
    // buffer of the step before, which the next copy overwrites
    flash::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int ahead = step + STAGES - 1;
    if (ahead < steps) {
      float* dst = ring + 2 * (ahead % STAGES) * TILE;
      flash::stage_tile_async<D, BN, THREADS>(dst, kb, ahead * BN, n, ldk);
      flash::stage_tile_async<D, BN, THREADS>(dst + TILE, vb, ahead * BN, n, ldv);
    }
    flash::cp_async_commit();
    if (!active) continue;

    const float* sk = ring + 2 * (step % STAGES) * TILE;
    const float* sv = sk + TILE;
    const int j0 = step * BN;

    // s[j]: rows g, g + 8 against keys j0 + 8 j + 2 t, + 1
    float sc[1][NT][4];
    flash::dot_rows<LD, NT, D / 8, 1>({sq + r0 * LD}, {sk}, g, t, sc);
    float (&s)[NT][4] = sc[0];

    // online softmax in base 2
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = ninf;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = j0 + 8 * j + 2 * t + e < n;
          const float val = valid ? s[j][2 * r + e] * scale_log2e : ninf;
          s[j][2 * r + e] = val;
          mx = fmaxf(mx, val);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float base = m_new == ninf ? 0.f : m_new;
      const float alpha = exp2f(m[r] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * r + e] - base);
          s[j][2 * r + e] = p;
          rs += p;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = fmaf(l[r], alpha, rs);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        acc[c][2 * r] *= alpha;
        acc[c][2 * r + 1] *= alpha;
      }
    }

    // acc += p . v from the score registers
    flash::weighted_rows<LD, NT, NCH>(s, sv, g, t, acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + r0 + g + 8 * r;
    if (row >= n) continue;
    if (lse != nullptr && t == 0) {
      // m and l are in base 2: ln sum_j e^(s_j) = (m + log2 l) ln 2
      lse[((size_t)b * heads + h) * n + row] =
          (m[r] + log2f(l[r])) * flash::kLn2;
    }
    float* dst = o + (((size_t)b * n + row) * heads + h) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float2 out;
      out.x = acc[c][2 * r] / l[r];
      out.y = acc[c][2 * r + 1] / l[r];
      *reinterpret_cast<float2*>(dst + 8 * c) = out;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int b, int n, int heads, long long ldq,
                   long long ldk, long long ldv, int device, cudaStream_t st) {
  constexpr int BM = fwd_bm(D), BN = fwd_bn(D), STAGES = fwd_stages(D);
  constexpr size_t bytes = smem_bytes<D, BM, BN, STAGES>();
  static_assert(bytes <= flash::kMaxShared, "shared memory");
  auto kernel = flash_attn_kernel<D, BM, BN, STAGES>;
  static bool allowed[flash::kDevices] = {};
  cudaError_t err = flash::allow_shared(
      kernel, bytes, device < flash::kDevices ? &allowed[device] : nullptr);
  if (err != cudaSuccess) return err;
  const int tiles = (n + BM - 1) / BM;
  // softmax(s / sqrt(D)) = 2^((s - max) * log2(e) / sqrt(D))
  const float scale_log2e = (float)(1.4426950408889634 / std::sqrt((double)D));
  kernel<<<(unsigned)((size_t)b * heads * tiles), 2 * BM, bytes, st>>>(
      q, k, v, o, lse, n, heads, tiles, ldq, ldk, ldv, scale_log2e);
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
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || n < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PCB_FWD(DD) \
  launch<DD>(q, k, v, o, lse, b, n, heads, ldq, ldk, ldv, device, st)
  PCB_FOR_HEAD_DIMS(PCB_FWD)
#undef PCB_FWD
  return (int)err;
}
