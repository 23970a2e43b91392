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
// Design (flash_attn_bf16.cuh): a block takes one (batch, head) and 128
// query rows, two consumer warpgroups of 64 (64 rows, one warpgroup, where
// the grid of 128-row tiles would not fill the SMs), and a producer
// warpgroup whose one thread asks the TMA for the q tiles once and for the
// k and v tiles, BN keys a step, into a ring of stages under a full and an
// empty mbarrier a stage. A consumer step j: S_j = q . k_j^T as wgmma
// m64nBNk16 from shared memory (q and k K-major); O += P_{j-1} . v_{j-1}
// with P rounded to bf16 in registers as the A operand and v from shared
// memory MN-major; meanwhile the online softmax of S_j in base 2 on the
// accumulator registers (row maxima and sums over the 4 threads of a quad by
// two shuffles; the sum l takes the probabilities before they are rounded,
// as the float32 softmax does; 2^x on the SFU, ex2.approx.ftz); O takes the
// factor of S_j's new maxima once P_{j-1} . v_{j-1} is done. A step without
// keys past N runs the softmax without masks. The two warpgroups' steps
// interleave on the SM besides. Ragged N: the TMA reads rows past N as
// zeros, keys past N get p = 0, rows past N are not stored; the running
// maximum starts at -inf and a step always holds a key below N.
//
// The library is built with -fmad=false; a fused operation here is written
// as fmaf().
#include <cmath>

#include "flash_attn_bf16.cuh"

namespace {

using flash_bf16::bf16;
using flash_bf16::kGroup;
using flash_bf16::kRows;
using flash_bf16::Plan;
using flash_bf16::tile_bytes;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return flash_bf16::smem_bytes(D, 2, Plan<D>::fwd_bn, Plan<D>::fwd_stages, 0);
}

template <int D>
__global__ void __launch_bounds__(flash_bf16::kMaxThreads, 1)
flash_attn_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                       float* __restrict__ lse, int n, int heads, int tiles,
                       float scale_log2e) {
  constexpr int BN = Plan<D>::fwd_bn;
  constexpr int STAGES = Plan<D>::fwd_stages;
  constexpr uint32_t kQ = tile_bytes(kRows, D);  // a warpgroup's q tile
  constexpr uint32_t kKV = tile_bytes(BN, D);    // a k or a v tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = flash_bf16::aligned_base(smem_raw);  // 2 q tiles
  const uint32_t ring = sq + 2 * kQ;                         // STAGES x (k, v)
  const uint32_t bars = ring + STAGES * 2 * kKV;             // full, empty, q
  const uint32_t qbar = bars + 2 * STAGES * 8;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int groups = blockDim.x / kGroup - 1;  // consumer warpgroups
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int i0 = tile * kRows * groups;
  const int steps = (n + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      flash_bf16::mbar_init(full(s), 1);
      flash_bf16::mbar_init(empty(s), 4 * groups);  // a warp of each consumer
    }
    flash_bf16::mbar_init(qbar, 1);
    flash_bf16::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= groups * kGroup) {
    // the producer warpgroup: one thread asks for every tile
    flash_bf16::producer_registers();
    if (threadIdx.x == groups * kGroup) {
      flash_bf16::mbar_expect(qbar, groups * kQ);
      for (int w = 0; w < groups; ++w) {
        flash_bf16::load_tile<D, kRows>(sq + w * kQ, &tq, qbar, h * D, i0 + w * kRows, b);
      }
      for (int step = 0; step < steps; ++step) {
        const int s = step % STAGES;
        flash_bf16::mbar_wait(empty(s), ((step / STAGES) & 1) ^ 1);
        flash_bf16::mbar_expect(full(s), 2 * kKV);
        const uint32_t dst = ring + s * 2 * kKV;
        flash_bf16::load_tile<D, BN>(dst, &tk, full(s), h * D, step * BN, b);
        flash_bf16::load_tile<D, BN>(dst + kKV, &tv, full(s), h * D, step * BN, b);
      }
    }
    return;
  }
  flash_bf16::consumer_registers();

  // consumer warpgroup wg: rows i0 + 64 wg .. + 63
  const int wg = threadIdx.x / kGroup;
  const int warp = threadIdx.x % kGroup / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t my_q = sq + wg * kQ;

  const float ninf = -INFINITY;
  float m[2] = {ninf, ninf}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the warp's 16
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;

  // S = q . k^T of a step (s[4 j + 2 r + e]: row g + 8 r against key j0 +
  // 8 j + 2 t + e), asked for once the step's tiles are in, not waited
  auto scores = [&](int step, float (&s)[BN / 2]) {
    const int stage = step % STAGES;
    flash_bf16::mbar_wait(full(stage), (step / STAGES) & 1);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    flash_bf16::wgmma_fence();
    flash_bf16::dot_rows<D, BN>(s, my_q, ring + stage * 2 * kKV);
    flash_bf16::wgmma_commit();
  };
  // The online softmax in base 2 of a step's scores s into x, the
  // probabilities (the accumulator s is only read: ptxas serializes the
  // products where ordinary instructions write an accumulator while a
  // product is in flight); alpha[r] is what O's row takes before the step.
  auto softmax = [&](int step, const float (&s)[BN / 2], float (&x)[BN / 2], float (&alpha)[2],
                     bool ragged) {  // keys past N in the step (a constant where it is called)
    const int j0 = step * BN;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the row maximum of the scaled scores: the maximum of the scores,
      // scaled (a product by a positive number rounds monotonically)
      float mx = ninf;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = !ragged || j0 + 8 * j + 2 * t + e < n;
          mx = fmaxf(mx, valid ? s[4 * j + 2 * r + e] : ninf);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2e);
      const float base = m_new == ninf ? 0.f : m_new;
      alpha[r] = flash_bf16::exp2_ftz(m[r] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = !ragged || j0 + 8 * j + 2 * t + e < n;
          const float pe =
              valid ? flash_bf16::exp2_ftz(fmaf(s[4 * j + 2 * r + e], scale_log2e, -base)) : 0.f;
          x[4 * j + 2 * r + e] = pe;
          rs += pe;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = fmaf(l[r], alpha[r], rs);
      m[r] = m_new;
    }
  };

  // The loop runs a step behind on p . v: step j asks for S_j, then for
  // O += P_{j-1} . v_{j-1}, and runs the softmax of S_j while that second
  // product is on the tensor cores; O takes S_j's factor once it is done,
  // and the stage of step j - 1 goes back to the producer then. Step 0 is
  // peeled off, so that every wait in the loop is unconditional.
  uint32_t p[BN / 16][4];  // P of the step before, bf16, the A operand
  flash_bf16::mbar_wait(qbar, 0);
  {
    float s[BN / 2], x[BN / 2], alpha[2];
    scores(0, s);
    flash_bf16::wgmma_wait<0>();
    flash_bf16::fence_regs(s);
    // acc is 0: no factor to take
    if (BN > n) {
      softmax(0, s, x, alpha, true);
    } else {
      softmax(0, s, x, alpha, false);
    }
    flash_bf16::to_operand<BN>(x, p);
  }
  for (int step = 1; step < steps; ++step) {
    const int prev = (step - 1) % STAGES;
    const uint32_t sv_prev = ring + prev * 2 * kKV + kKV;
    float s[BN / 2], x[BN / 2], alpha[2];
    scores(step, s);
    // acc += p . v of the step before, p rounded to bf16 from its scores
    flash_bf16::weighted_rows<D, BN>(acc, p, sv_prev, BN);
    flash_bf16::wgmma_commit();
    flash_bf16::wgmma_wait<1>();
    flash_bf16::fence_regs(s);
    if ((step + 1) * BN > n) {
      softmax(step, s, x, alpha, true);
    } else {
      softmax(step, s, x, alpha, false);
    }
    flash_bf16::wgmma_wait<0>();
    flash_bf16::fence_regs(acc);
    if (lane == 0) flash_bf16::mbar_arrive(empty(prev));
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * c + 2 * r] *= alpha[r];
        acc[4 * c + 2 * r + 1] *= alpha[r];
      }
    }
    flash_bf16::to_operand<BN>(x, p);
  }
  // the last step's p . v
  const uint32_t sv_last = ring + ((steps - 1) % STAGES) * 2 * kKV + kKV;
  flash_bf16::weighted_rows<D, BN>(acc, p, sv_last, BN);
  flash_bf16::wgmma_commit();
  flash_bf16::wgmma_wait<0>();
  flash_bf16::fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + wg * kRows + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    if (lse != nullptr && t == 0) {
      // m and l are in base 2: ln sum_j e^(s_j) = (m + log2 l) ln 2
      lse[((size_t)b * heads + h) * n + row] = (m[r] + log2f(l[r])) * flash::kLn2;
    }
    bf16* dst = o + (((size_t)b * n + row) * heads + h) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * r] / l[r], acc[4 * c + 2 * r + 1] / l[r]);
    }
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int b,
                   int n, int heads, long long ldq, long long ldk, long long ldv, int device,
                   cudaStream_t st) {
  constexpr size_t bytes = fwd_smem_bytes<D>();
  static_assert(bytes <= flash::kMaxShared, "shared memory");
  auto kernel = flash_attn_bf16_kernel<D>;
  static bool allowed[flash::kDevices] = {};
  cudaError_t err = flash::allow_shared(
      kernel, bytes, device < flash::kDevices ? &allowed[device] : nullptr);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  const int hd = heads * D;
  if ((err = flash_bf16::rows_map(&tq, q, b, n, hd, ldq, kRows)) != cudaSuccess) return err;
  if ((err = flash_bf16::rows_map(&tk, k, b, n, hd, ldk, Plan<D>::fwd_bn)) != cudaSuccess)
    return err;
  if ((err = flash_bf16::rows_map(&tv, v, b, n, hd, ldv, Plan<D>::fwd_bn)) != cudaSuccess)
    return err;
  const int groups = flash_bf16::consumer_groups(b, heads, n, device);
  const int tiles = (n + kRows * groups - 1) / (kRows * groups);
  // softmax(s / sqrt(D)) = 2^((s - max) * log2(e) / sqrt(D))
  const float scale_log2e = (float)(1.4426950408889634 / std::sqrt((double)D));
  kernel<<<(unsigned)((size_t)b * heads * tiles), kGroup * (groups + 1), bytes, st>>>(
      tq, tk, tv, o, lse, n, heads, tiles, scale_log2e);
  return cudaGetLastError();
}

}  // namespace

// d a multiple of 32 up to 256; b * heads * ceil(n / 64) < 2^31; the three
// pointers 16-byte aligned and the row strides multiples of 8 (the TMA's
// rules for a global address and stride): checked by the wrapper. lse may
// be null.
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
