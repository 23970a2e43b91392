// K6, bfloat16: multi-head attention forward without the score matrix in
// device memory (flash attention), bf16 in and out.
//
// Replaces: the bf16 path of pointcloud_bridge_tpu/models/ptv3.py:74,
// _attention, which the blocks take when the model computes or streams in
// bfloat16 (ptv3.py:253-268: the block's compute dtype feeds
// PointAttention's Dense, so q, k and v are bf16): on the TPU the library
// Pallas kernel jax.experimental.pallas.ops.tpu.flash_attention in bf16
// (:136-161, after a zero pad of D = 192 to 256, a TPU lane constraint not
// carried over); elsewhere jax.nn.dot_product_attention.
//
// Semantics, those of jax.nn.dot_product_attention in bf16: for every batch
// row b and head h, the scores s_j = q . k_j from bf16 operands summed in
// float32, times 1/sqrt(D); the softmax in float32; the probabilities
// rounded to bf16 before they multiply v; the sum in float32; the output
// rounded to bf16. q, k and v are [B, N, H, D] bf16 with the head and
// channel axes contiguous and a row stride each (ldq, ldk, ldv, in
// elements), so the three slices of one packed [B, N, 3, H, D] projection
// are read in place; the batch stride is N rows. o is written contiguous as
// [B, N, H, D] bf16. Where lse is not null, each row's natural-log sum of its
// exponentiated scaled scores is written to lse[b, h, i] ([B, H, N] float32)
// for the backward (flash_attn_bwd_bf16.cu).
//
// What bounds it on the H100: operations. 4*B*H*N*N*D operations against
// 8*B*N*H*D bytes is N/2 operations a byte; at the dense bf16 tensor rate
// (989 TFLOP/s) over the memory rate (3.35 TB/s) that is 295 operations a
// byte: from N = 590 up the arithmetic is the floor. The exponentials
// (N*N a head, on the SFU at 16 a cycle an SM) are the next floor, a tenth
// of it at D = 64.
//
// Design: the float32 kernel's (flash_attn.cu) with bf16 tiles and one
// tensor-core pass a product. A block takes one (batch, head) and 64 query
// rows, 4 warps of 16 rows, and loops over the keys BN at a time; the q tile
// is staged once, the k and v tiles arrive in a ring of two buffers filled
// by cp.async under the arithmetic of the step before, one __syncthreads()
// a step. s = q . k^T into BN/8 float32 fragments a warp, the online softmax
// in base 2 on those registers (row maxima and sums over the 4 threads of a
// quad by two shuffles; the sum l takes the probabilities before they are
// rounded, as the float32 softmax does), then p . v with p rounded to bf16
// straight from the same registers and v read by ldmatrix .trans. BN is 64
// keys to D = 128 and 32 beyond, so that the accumulators (D/2 a thread)
// and the scores (BN/2) fit the registers. Ragged N: rows past N are staged
// as zeros, keys past N get p = 0, rows past N are not stored; the running
// maximum starts at -inf and a step always holds a key below N.
//
// The library is built with -fmad=false; a fused operation here is written
// as fmaf().
#include <cmath>

#include "flash_attn_bf16.cuh"

namespace {

using flash_bf16::bf16;
using flash_bf16::kPad;

constexpr int kBM = 64;       // query rows a block
constexpr int kThreads = 128;  // a warp a 16 rows
constexpr int kStages = 2;    // buffers in the ring
constexpr int fwd_bn(int d) { return d <= 128 ? 64 : 32; }  // keys a step

template <int D, int BN>
constexpr size_t smem_bytes() {
  return (size_t)(kBM + 2 * kStages * BN) * (D + kPad) * sizeof(bf16);
}

template <int D, int BN>
__global__ void __launch_bounds__(kThreads)
flash_attn_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int n, int heads, int tiles,
                       long long ldq, long long ldk, long long ldv,
                       float scale_log2e) {
  constexpr int LD = D + kPad;
  constexpr int NT = BN / 8;   // score fragments a warp and step
  constexpr int NCH = D / 8;   // output fragments a warp
  constexpr int TILE = BN * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = sq + kBM * LD;  // kStages x (k tile, v tile)

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int i0 = tile * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;         // the warp's first row in the tile
  const bool active = i0 + r0 < n;  // else every row of the warp is past N

  const bf16* qb = q + (size_t)b * n * ldq + (size_t)h * D;
  const bf16* kb = k + (size_t)b * n * ldk + (size_t)h * D;
  const bf16* vb = v + (size_t)b * n * ldv + (size_t)h * D;
  const int steps = (n + BN - 1) / BN;

  // the q tile travels with the first k and v tiles
  flash_bf16::stage_tile_async<D, kBM, kThreads>(sq, qb, i0, n, ldq);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      flash_bf16::stage_tile_async<D, BN, kThreads>(ring + 2 * s * TILE, kb, s * BN, n, ldk);
      flash_bf16::stage_tile_async<D, BN, kThreads>(ring + (2 * s + 1) * TILE, vb, s * BN, n,
                                                    ldv);
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
    flash::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ahead = step + kStages - 1;
    if (ahead < steps) {
      bf16* dst = ring + 2 * (ahead % kStages) * TILE;
      flash_bf16::stage_tile_async<D, BN, kThreads>(dst, kb, ahead * BN, n, ldk);
      flash_bf16::stage_tile_async<D, BN, kThreads>(dst + TILE, vb, ahead * BN, n, ldv);
    }
    flash::cp_async_commit();
    if (!active) continue;

    const bf16* sk = ring + 2 * (step % kStages) * TILE;
    const bf16* sv = sk + TILE;
    const int j0 = step * BN;

    // s[j]: rows g, g + 8 against keys j0 + 8 j + 2 t, + 1
    float s[NT][4];
    flash_bf16::dot_rows<LD, NT, D>(sq + r0 * LD, sk, g, t, s);

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

    // acc += p . v, p rounded to bf16 from the score registers
    flash_bf16::weighted_rows<LD, NT, NCH>(s, sv, lane, acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + r0 + g + 8 * r;
    if (row >= n) continue;
    if (lse != nullptr && t == 0) {
      // m and l are in base 2: ln sum_j e^(s_j) = (m + log2 l) ln 2
      lse[((size_t)b * heads + h) * n + row] = (m[r] + log2f(l[r])) * flash::kLn2;
    }
    bf16* dst = o + (((size_t)b * n + row) * heads + h) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
          __floats2bfloat162_rn(acc[c][2 * r] / l[r], acc[c][2 * r + 1] / l[r]);
    }
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   float* lse, int b, int n, int heads, long long ldq,
                   long long ldk, long long ldv, int device, cudaStream_t st) {
  constexpr int BN = fwd_bn(D);
  constexpr size_t bytes = smem_bytes<D, BN>();
  static_assert(bytes <= flash::kMaxShared, "shared memory");
  auto kernel = flash_attn_bf16_kernel<D, BN>;
  static bool allowed[flash::kDevices] = {};
  cudaError_t err = flash::allow_shared(
      kernel, bytes, device < flash::kDevices ? &allowed[device] : nullptr);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kBM - 1) / kBM;
  // softmax(s / sqrt(D)) = 2^((s - max) * log2(e) / sqrt(D))
  const float scale_log2e = (float)(1.4426950408889634 / std::sqrt((double)D));
  kernel<<<(unsigned)((size_t)b * heads * tiles), kThreads, bytes, st>>>(
      q, k, v, o, lse, n, heads, tiles, ldq, ldk, ldv, scale_log2e);
  return cudaGetLastError();
}

}  // namespace

// d a multiple of 32 up to 256; b * heads * ceil(n / 64) < 2^31; the three
// pointers 16-byte aligned and the row strides multiples of 8: checked by
// the wrapper. lse may be null.
PCB_API int pcb_flash_attn_bf16(const void* q, const void* k, const void* v,
                                void* o, float* lse, int b, int n, int heads,
                                int d, long long ldq, long long ldk,
                                long long ldv, int device, void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || n < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* qh = static_cast<const bf16*>(q);
  const bf16* kh = static_cast<const bf16*>(k);
  const bf16* vh = static_cast<const bf16*>(v);
  bf16* oh = static_cast<bf16*>(o);
#define PCB_FWD(DD) \
  launch<DD>(qh, kh, vh, oh, lse, b, n, heads, ldq, ldk, ldv, device, st)
  PCB_FOR_HEAD_DIMS(PCB_FWD)
#undef PCB_FWD
  return (int)err;
}
